"""Decoder-only LM over the attention block (port of ``repro.models.transformer``).

``cfg.layer_kinds()`` groups consecutive identical kinds into segments; each
segment's params are stacked on a leading layer axis (the reference scans
over it), and the port walks that axis in a Python loop, handing each layer
its slice — dense tensors and packed operand dicts alike.  The port has
the ``attn`` kind only (the dense decoders).

Interface:
  init(key, cfg, device=)                          -> params (device: cuda default)
  forward(params, cfg, batch, remat=, train=)      -> (logits, aux)
  prefill(params, cfg, batch)                      -> (logits, cache)
  decode_step(params, cfg, cache, token, pos)      -> (logits, cache); pos int, 0-d or (B,) tensor
  init_cache(cfg, batch, seq_len, dtype=, device=) -> cache

Paged KV (the continuous-batching engine): ``init_paged_pools``,
``paged_view`` / ``paged_writeback``, ``decode_step_paged``,
``chunk_on_views`` and ``prefill_chunk`` (the reference's paged half).
"""
from __future__ import annotations

import functools
from typing import Any

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch import prng
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels._util import resolve_device
from repro_torch.models import blocks, layers
from repro_torch.models.layers import Params

KINDS = ("attn",)


def segments_of(cfg: ArchConfig) -> list[tuple[str, int]]:
    """Group layer kinds into maximal homogeneous runs."""
    runs: list[tuple[str, int]] = []
    for kind in cfg.layer_kinds():
        if kind not in KINDS:
            raise NotImplementedError(
                f"block kind {kind!r} is ported with the other model families (ROADMAP A.16)"
            )
        if runs and runs[-1][0] == kind:
            runs[-1] = (kind, runs[-1][1] + 1)
        else:
            runs.append((kind, 1))
    return runs


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def layer_slice(tree: Any, i: int) -> Any:
    """Layer ``i`` of a segment stack: index the leading axis of every leaf."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def init(key: torch.Tensor, cfg: ArchConfig, *, device=None) -> Params:
    """f32 master params from a ``prng`` key, the reference's ``init(key,
    cfg)`` bit for bit (same key splits and draws), on CUDA unless
    ``device="cpu"`` is asked for."""
    key = key.to(resolve_device(device))
    segs = segments_of(cfg)
    keys = prng.split(key, len(segs) + 3)
    params: Params = {"embed": layers.init_embedding(keys[0], cfg.vocab_size, cfg.d_model)}
    params["segments"] = [
        blocks.init_attn_block(prng.split(keys[i + 1], count), cfg)
        for i, (_, count) in enumerate(segs)
    ]
    params["final_norm"] = layers.init_norm(cfg.d_model, key.device)
    if not cfg.tie_embeddings:
        params["head"] = {"w": layers._dense_init(keys[-1], cfg.d_model, cfg.vocab_size)}
    return params


@functools.cache
def _embed_scale(d_model: int, dtype: torch.dtype) -> float:
    """sqrt(d_model) rounded to the compute dtype, as the reference rounds
    it before the multiply (the rounded value, exact as a Python float)."""
    return float(torch.tensor(d_model**0.5, dtype=dtype))


def _embed_inputs(params: Params, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    dtype = compute_dtype(cfg)
    x = layers.embed(params["embed"], tokens, dtype)
    if cfg.embed_scale:
        # filled on the device: no host-to-device copy in a captured step
        x = x * torch.full((), _embed_scale(cfg.d_model, dtype), dtype=dtype, device=x.device)
    return x


def _logits(params: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = layers.rmsnorm(params["final_norm"], x)
    if cfg.tie_embeddings:
        return layers.unembed(params["embed"], x)
    return layers.linear(params["head"]["w"], x.to(torch.float32), torch.float32)


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective checkpointing of ``remat="dots"``: keep the matmuls with no
    batch dims (the weight products, ``aten.mm``), recompute the rest — the
    reference's ``dots_with_no_batch_dims_saveable``."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


REMATS = ("none", "full", "dots")


def _remat_layer(fn, remat: str):
    """Per-layer rematerialization (the reference's ``jax.checkpoint`` of the
    scan body): "full" saves only the layer's inputs, "dots" also its weight
    matmuls' outputs."""
    if remat == "none":
        return fn
    kw = {"use_reentrant": False}
    if remat == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
    return lambda *args: checkpoint(fn, *args, **kw)


def _run_segments(params: Params, cfg: ArchConfig, x: torch.Tensor, *, return_cache: bool,
                  remat: str = "none", train: bool = False):
    caches = []
    for (_, count), p_stack in zip(segments_of(cfg), params["segments"]):
        layer_caches = []

        def layer(p_layer, xc):
            return blocks.attn_block_fwd(p_layer, cfg, xc, return_cache=return_cache, train=train)

        layer = _remat_layer(layer, remat)
        for i in range(count):
            x, cache = layer(layer_slice(p_stack, i), x)
            layer_caches.append(cache)
        if return_cache:
            caches.append({k: torch.stack([c[k] for c in layer_caches]) for k in ("k", "v")})
    return x, caches if return_cache else None


def forward(params: Params, cfg: ArchConfig, batch: dict, *, remat: str = "none",
            train: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """batch: {"tokens": (B, S) int}.  Returns (logits (B, S, V) f32, aux 0).

    ``train=True`` is the differentiable forward of ``launch.steps.loss_fn``:
    its attention is ``blockwise_attention`` on every device (the function
    the reference differentiates; B3 has no backward).  ``remat`` is the
    per-layer rematerialization policy ("none" | "full" | "dots").
    """
    if remat not in REMATS:
        raise ValueError(f"unknown remat policy {remat!r}")
    x = _embed_inputs(params, cfg, batch["tokens"])
    x, _ = _run_segments(params, cfg, x, return_cache=False, remat=remat, train=train)
    return _logits(params, cfg, x), torch.zeros((), device=x.device)


def prefill(params: Params, cfg: ArchConfig, batch: dict) -> tuple[torch.Tensor, list]:
    """Returns (last-position logits (B, 1, V), per-segment prompt caches
    {"k", "v": (count, B, Hkv, S, hd)})."""
    x = _embed_inputs(params, cfg, batch["tokens"])
    x, caches = _run_segments(params, cfg, x, return_cache=True)
    return _logits(params, cfg, x[:, -1:]), caches


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, dtype=None, *, device=None,
               shards: int = 0) -> list:
    """Zero decode cache, one stacked {"k", "v"} per segment (CUDA unless
    ``device="cpu"``); ``shards`` > 0 adds a shard axis after the layer axis
    (a TP plan's sharded attention: one cache per shard)."""
    device = resolve_device(device)
    dtype = compute_dtype(cfg) if dtype is None else dtype
    extra = (shards,) if shards else ()
    return [
        blocks.init_attn_cache(cfg, batch, seq_len, dtype, device, lead=(count, *extra))
        for _, count in segments_of(cfg)
    ]


def decode_step(
    params: Params, cfg: ArchConfig, caches: list, token: torch.Tensor, pos: int | torch.Tensor
) -> tuple[torch.Tensor, list]:
    """token: (B, 1) int; pos: absolute position, a Python int or a 0-d int
    tensor on the device (no host sync: a CUDA graph can capture the step),
    or a (B,) int tensor of per-row positions (the engine's ragged decode).
    Writes the caches in place and returns (logits (B, 1, V), caches)."""
    x = _embed_inputs(params, cfg, token)
    for (_, count), p_stack, c_stack in zip(segments_of(cfg), params["segments"], caches):
        for i in range(count):
            x = blocks.attn_block_step(
                layer_slice(p_stack, i), cfg, x, layer_slice(c_stack, i), pos
            )
    return _logits(params, cfg, x), caches


# ---------------------------------------------------------------------------
# Paged decode / chunked prefill (continuous-batching engine)
# ---------------------------------------------------------------------------

def supports_paged(cfg: ArchConfig) -> bool:
    """Paged KV serving covers pure-attention decoder stacks (every dense
    config the port has; another block kind raises in ``segments_of``)."""
    return {k for k, _ in segments_of(cfg)} <= {"attn"}


def init_paged_pools(cfg: ArchConfig, num_tokens: int, dtype=None, *, device=None,
                     shards: int = 0) -> list:
    """Token-major physical KV pools, one stacked pool per segment: k/v
    (count, T, Hkv, hd) with T = num_blocks * page_size (CUDA unless
    ``device="cpu"``); ``shards`` > 0 gives (count, shards, T, Hkv, hd), one
    pool per shard of a TP plan's sharded attention, all behind one block
    table."""
    device = resolve_device(device)
    dtype = compute_dtype(cfg) if dtype is None else dtype
    extra = (shards,) if shards else ()
    return [blocks.init_attn_pool(cfg, num_tokens, dtype, device, lead=(count, *extra))
            for _, count in segments_of(cfg)]


def paged_view(cfg: ArchConfig, pools: list, table: torch.Tensor, page_size: int) -> list:
    """Gather each slot's pages into contiguous per-slot caches — the same
    (count, B, Hkv, L, hd) layout ``init_cache`` builds, so the ordinary
    ``decode_step`` runs against it unchanged."""
    return [{k: blocks.gather_pool_view(a, table, page_size) for k, a in pool.items()}
            for pool in pools]


def paged_writeback(cfg: ArchConfig, pools: list, caches: list, table: torch.Tensor,
                    pos0: torch.Tensor, n_tokens: int, page_size: int) -> list:
    """Scatter the cells a dispatch wrote — view positions [pos0_r, pos0_r +
    n_tokens) per row — back into the physical pools, in place."""
    for pool, cache in zip(pools, caches):
        for k in pool:
            blocks.scatter_pool_view(pool[k], cache[k], table, pos0, n_tokens, page_size)
    return pools


def decode_step_paged(params: Params, cfg: ArchConfig, pools: list, table: torch.Tensor,
                      token: torch.Tensor, pos: torch.Tensor, page_size: int):
    """token: (B, 1) int; pos: (B,) per-slot absolute positions; table
    (B, P) block-table rows.  Gather view -> ordinary ``decode_step``
    (vector positions) -> write the one new cell per row back.  Returns
    (logits (B, 1, V), pools)."""
    caches = paged_view(cfg, pools, table, page_size)
    logits, caches = decode_step(params, cfg, caches, token, pos)
    return logits, paged_writeback(cfg, pools, caches, table, pos, 1, page_size)


def chunk_on_views(params: Params, cfg: ArchConfig, caches: list, tokens: torch.Tensor,
                   start, kv_len, last_idx) -> tuple[torch.Tensor, list]:
    """Chunk continuation against contiguous cache views (written in place).

    tokens: (B, C) int — row r holds chunk positions [start_r, start_r + C)
    of its own request; columns past a row's true extent are padding.
    start / kv_len / last_idx: (B,) int tensors (0-d or Python ints also
    accepted) — chunk start, valid cache length after the writes, and the
    chunk column whose logits each row emits.  Returns (logits (B, 1, V) —
    row r's column ``last_idx_r`` — and the views).
    """
    x = _embed_inputs(params, cfg, tokens)
    start = torch.as_tensor(start, device=x.device)
    kv_len = torch.as_tensor(kv_len, device=x.device)
    for (_, count), p_stack, c_stack in zip(segments_of(cfg), params["segments"], caches):
        for i in range(count):
            x = blocks.attn_block_chunk_step(layer_slice(p_stack, i), cfg, x,
                                             layer_slice(c_stack, i), start, kv_len)
    last = torch.as_tensor(last_idx, device=x.device).to(torch.int64).reshape(-1, 1, 1)
    x_last = torch.gather(x, 1, last.expand(x.shape[0], 1, x.shape[-1]))
    return _logits(params, cfg, x_last), caches


def prefill_chunk(params: Params, cfg: ArchConfig, pools: list, table: torch.Tensor,
                  tokens: torch.Tensor, start, kv_len, last_idx, page_size: int):
    """One prompt-chunk dispatch, B requests wide, through the paged pools
    (see :func:`chunk_on_views`); start/kv_len/last_idx also accept scalars.
    Returns (logits (B, 1, V), pools)."""
    b, c = tokens.shape
    start_b = torch.as_tensor(start, device=tokens.device).reshape(-1).expand(b)
    caches = paged_view(cfg, pools, table, page_size)
    logits, caches = chunk_on_views(params, cfg, caches, tokens, start, kv_len, last_idx)
    return logits, paged_writeback(cfg, pools, caches, table, start_b, c, page_size)
