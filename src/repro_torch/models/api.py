"""Model API used by ``launch/`` (port of ``repro.models.api``): the
decoder-only families (``models.transformer``) and the encoder-decoder
(``models.encdec``, ``cfg.encdec``), with the paged-KV half the
continuous-batching engine serves through (decoder-only)."""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import prng, tree
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels._util import resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.models.transformer import (  # noqa: F401
    chunk_on_views,
    decode_step_paged,
    paged_view,
    paged_writeback,
    prefill_chunk,
    supports_paged,
)


def init(key: torch.Tensor, cfg: ArchConfig, *, device=None):
    return (encdec.init(key, cfg, device=device) if cfg.encdec
            else transformer.init(key, cfg, device=device))


def forward(params, cfg: ArchConfig, batch: dict, *, remat: str = "none", train: bool = False):
    model = encdec if cfg.encdec else transformer
    return model.forward(params, cfg, batch, remat=remat, train=train)


def prefill(params, cfg: ArchConfig, batch: dict):
    return (encdec if cfg.encdec else transformer).prefill(params, cfg, batch)


def decode_step(params, cfg: ArchConfig, cache, token: torch.Tensor, pos):
    return (encdec if cfg.encdec else transformer).decode_step(params, cfg, cache, token, pos)


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, dtype=None, *, device=None,
               shards: int = 0, src_len: int | None = None):
    """Zero decode cache for ``seq_len`` positions; meta tokens occupy cache
    slots before them, as in the reference.  An encoder-decoder's cross
    cache holds ``src_len`` source frames (``seq_len`` if not given)."""
    if cfg.encdec:
        return encdec.init_cache(cfg, batch, seq_len, src_len or seq_len, dtype, device=device)
    return transformer.init_cache(cfg, batch, seq_len + cfg.n_meta_tokens, dtype,
                                  device=device, shards=shards)


def init_paged_pools(cfg: ArchConfig, num_tokens: int, dtype=None, *, device=None,
                     shards: int = 0) -> list:
    """Token-major physical KV pools (``num_tokens`` = num_blocks * page)."""
    if cfg.encdec:
        raise NotImplementedError("paged KV serving: decoder-only models")
    return transformer.init_paged_pools(cfg, num_tokens, dtype, device=device, shards=shards)


def merge_prefill_cache(cfg: ArchConfig, full_cache, pf_cache):
    """Write prefill caches into the full-length cache, in place (a decode
    graph holds its buffers by address), walking lists (the decoder-only
    segments) and nested dicts (an encoder-decoder's {"self", "cross_k",
    "cross_v"}): a leaf of the same shape (a ring cache, the SSM state, the
    conv tail, the cross K/V) is copied whole; a KV leaf differs only in its
    sequence axis, and the prompt's positions [0, prompt) are written
    there.  Returns ``full_cache``."""
    def merge(full, pf):
        if isinstance(full, dict):
            for name in full:
                merge(full[name], pf[name])
        elif isinstance(full, list):
            for f, p in zip(full, pf, strict=True):
                merge(f, p)
        elif full.shape == pf.shape:
            full.copy_(pf)
        else:
            axes = [i for i, (a, b) in enumerate(zip(full.shape, pf.shape)) if a != b]
            if len(axes) != 1:
                raise ValueError(f"prefill cache {tuple(pf.shape)} does not fit "
                                 f"{tuple(full.shape)}")
            full.narrow(axes[0], 0, pf.shape[axes[0]]).copy_(pf)

    merge(full_cache, pf_cache)
    return full_cache


def make_batch(cfg: ArchConfig, key: torch.Tensor, batch: int, seq_len: int, *,
               device=None) -> dict[str, Any]:
    """Random int32 token batch (smoke runs / examples), on CUDA unless
    ``device="cpu"``: the reference's draws bit for bit, ``prng.randint``
    from the first half of ``prng.split(key)`` and the modality inputs,
    ``src_embeds`` (B, seq_len, d) of an encoder-decoder or
    ``prefix_embeds`` (B, stub_prefix_len, d), ``prng.normal`` from the
    second half."""
    transformer.check_prompt(cfg, seq_len)
    device = resolve_device(device)
    kt, kp = prng.split(key.to(device)).unbind(-2)
    out = {"tokens": prng.randint(kt, (batch, seq_len), 0, cfg.vocab_size)}
    if cfg.encdec:
        out["src_embeds"] = prng.normal(kp, (batch, seq_len, cfg.d_model))
    elif cfg.stub_prefix_len:
        out["prefix_embeds"] = prng.normal(kp, (batch, cfg.stub_prefix_len, cfg.d_model))
    return out


def param_count(params) -> int:
    return sum(int(x.numel()) for x in tree.leaves(params))


def active_param_count(params, cfg: ArchConfig) -> int:
    """Active params per token (MoE: shared + top_k of the n_alloc routed
    experts).  The routed weights are the expert stacks, the wi_gate /
    wi_up / wo leaves of a ``moe`` sublayer, whatever their rank: the
    reference takes every rank-3 wi_gate / wi_up / wo leaf instead, which on
    its layer-stacked tree counts the stacked attention ``wo`` and shared
    GLU as routed and misses the [L, E, ...] expert stacks (ROADMAP C.10);
    on an unstacked tree both counts agree."""
    total = param_count(params)
    if cfg.moe is None:
        return total
    routed = sum(int(leaf.numel()) for path, leaf in tree.leaves_with_path(params)
                 if len(path) >= 2 and path[-2] == "moe" and path[-1] in ("wi_gate", "wi_up", "wo"))
    active_frac = cfg.moe.top_k / cfg.moe.n_alloc
    return total - routed + int(routed * active_frac)
