"""Model API used by ``launch/`` (port of ``repro.models.api``, decoder-only),
with the paged-KV half the continuous-batching engine serves through."""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import prng
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels._util import resolve_device
from repro_torch.models import transformer
from repro_torch.models.transformer import (  # noqa: F401
    chunk_on_views,
    decode_step,
    decode_step_paged,
    forward,
    init,
    paged_view,
    paged_writeback,
    prefill,
    prefill_chunk,
    supports_paged,
)


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, dtype=None, *, device=None,
               shards: int = 0):
    return transformer.init_cache(cfg, batch, seq_len, dtype, device=device, shards=shards)


def init_paged_pools(cfg: ArchConfig, num_tokens: int, dtype=None, *, device=None,
                     shards: int = 0) -> list:
    """Token-major physical KV pools (``num_tokens`` = num_blocks * page)."""
    return transformer.init_paged_pools(cfg, num_tokens, dtype, device=device, shards=shards)


def merge_prefill_cache(cfg: ArchConfig, full_cache: list, pf_cache: list) -> list:
    """Write prefill caches (prompt length) into the full-length cache, in
    place: positions [0, prompt) of every layer's K/V."""
    for full, pf in zip(full_cache, pf_cache):
        for name in full:
            full[name][..., : pf[name].shape[-2], :] = pf[name].to(full[name].dtype)
    return full_cache


def make_batch(cfg: ArchConfig, key: torch.Tensor, batch: int, seq_len: int, *,
               device=None) -> dict[str, Any]:
    """Random int32 token batch (smoke runs / examples), on CUDA unless
    ``device="cpu"``: the reference's draw bit for bit, ``prng.randint``
    from the first half of ``prng.split(key)``."""
    device = resolve_device(device)
    kt, _ = prng.split(key.to(device)).unbind(-2)
    return {"tokens": prng.randint(kt, (batch, seq_len), 0, cfg.vocab_size)}
