"""Model API used by ``launch/`` (port of ``repro.models.api``, decoder-only)."""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels._util import resolve_device
from repro_torch.models import transformer
from repro_torch.models.transformer import decode_step, forward, init, prefill  # noqa: F401


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, dtype=None, *, device=None):
    return transformer.init_cache(cfg, batch, seq_len, dtype, device=device)


def merge_prefill_cache(cfg: ArchConfig, full_cache: list, pf_cache: list) -> list:
    """Write prefill caches (prompt length) into the full-length cache, in
    place: positions [0, prompt) of every layer's K/V."""
    for full, pf in zip(full_cache, pf_cache):
        for name in full:
            full[name][..., : pf[name].shape[-2], :] = pf[name].to(full[name].dtype)
    return full_cache


def make_batch(
    cfg: ArchConfig, batch: int, seq_len: int, *, seed: int = 0, device=None
) -> dict[str, Any]:
    """Random token batch from ``seed`` (smoke runs / examples), on CUDA
    unless ``device="cpu"``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq_len), generator=gen, device=device)
    return {"tokens": tokens}
