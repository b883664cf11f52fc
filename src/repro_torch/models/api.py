"""Model API used by ``launch/`` (port of ``repro.models.api``, decoder-only),
with the paged-KV half the continuous-batching engine serves through."""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import prng, tree
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
    """Zero decode cache for ``seq_len`` positions; meta tokens occupy cache
    slots before them, as in the reference."""
    return transformer.init_cache(cfg, batch, seq_len + cfg.n_meta_tokens, dtype,
                                  device=device, shards=shards)


def init_paged_pools(cfg: ArchConfig, num_tokens: int, dtype=None, *, device=None,
                     shards: int = 0) -> list:
    """Token-major physical KV pools (``num_tokens`` = num_blocks * page)."""
    return transformer.init_paged_pools(cfg, num_tokens, dtype, device=device, shards=shards)


def merge_prefill_cache(cfg: ArchConfig, full_cache: list, pf_cache: list) -> list:
    """Write prefill caches into the full-length cache, in place (a decode
    graph holds its buffers by address), walking nested dicts: a leaf of
    the same shape (a ring cache, the SSM state, the conv tail) is copied
    whole; a KV leaf differs only in its sequence axis, and the prompt's
    positions [0, prompt) are written there."""
    def merge(full, pf):
        if isinstance(full, dict):
            for name in full:
                merge(full[name], pf[name])
        elif full.shape == pf.shape:
            full.copy_(pf)
        else:
            axes = [i for i, (a, b) in enumerate(zip(full.shape, pf.shape)) if a != b]
            if len(axes) != 1:
                raise ValueError(f"prefill cache {tuple(pf.shape)} does not fit "
                                 f"{tuple(full.shape)}")
            full.narrow(axes[0], 0, pf.shape[axes[0]]).copy_(pf)

    for full, pf in zip(full_cache, pf_cache):
        merge(full, pf)
    return full_cache


def make_batch(cfg: ArchConfig, key: torch.Tensor, batch: int, seq_len: int, *,
               device=None) -> dict[str, Any]:
    """Random int32 token batch (smoke runs / examples), on CUDA unless
    ``device="cpu"``: the reference's draw bit for bit, ``prng.randint``
    from the first half of ``prng.split(key)``."""
    device = resolve_device(device)
    kt, _ = prng.split(key.to(device)).unbind(-2)
    return {"tokens": prng.randint(kt, (batch, seq_len), 0, cfg.vocab_size)}


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
