"""Dense transformer block: pre-norm attention + pre-norm gated MLP.

Port of the attention block of ``repro.models.blocks``.  Layer params are
one layer's slice of the segment stack.  The mask kind and window thread
through every attention call: "causal" for the ``attn`` kind, "swa" with
``cfg.attn_window`` for the ``swa`` kind, in prefill, chunk and decode.
The decode step writes its K/V into the cache in place (the counterpart of
the reference's donated, functionally updated cache), at one position for
the batch or, for the engine's ragged decode, at a (B,) position per row.

Paged KV (the continuous-batching engine): the physical cache is a
token-major pool shared by every slot, k/v (T, Hkv, hd) with T = num_blocks
* page_size.  A dispatch gathers each slot's pages once into a contiguous
(B, Hkv, L, hd) view (:func:`gather_pool_view`), runs the ordinary steps
against it (``attention_step`` with per-row positions,
:func:`attention_chunk_step`), and scatters only the newly written cells
back (:func:`scatter_pool_view`).  View positions past a row's valid length
hold stale pool bytes; the attention masks them.

Tensor parallelism (``parallel/tp.py``): under a TP plan ``cfg`` is the
local config (shard-local head and d_ff counts, ``tp_attn`` / ``tp_mlp``
set) and a sharded sublayer's leaves, and the attention's cache or pool,
carry a shard axis in front of their own dims.  The reduction points are
the reference's ``_tp_reduce`` call sites: after attention's ``wo`` in
:func:`attention_fwd`, :func:`attention_step` and
:func:`attention_chunk_step`, and after the MLP in the three block
functions.  There :func:`_tp_reduce` runs the sublayer once per local shard
at its local shapes (the replicated prefix, the norm, is computed once by
the block) and the active gate (``parallel.collective``) sums the partial
outputs: in process over every shard, or across ranks.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import prng
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers
from repro_torch.models.attention import attention, decode_attention
from repro_torch.models.layers import Params
from repro_torch.parallel import collective


# ---------------------------------------------------------------------------
# Tensor parallelism: cross-shard reduction points
# ---------------------------------------------------------------------------

def _shard(tree: Any, s: int) -> Any:
    """Shard ``s`` of a tree whose leaves lead with the shard axis."""
    if isinstance(tree, dict):
        return {k: _shard(v, s) for k, v in tree.items()}
    return tree[s]


def _n_shards(tree: Any) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def _tp_reduce(cfg: ArchConfig, enabled: bool, fn, p: Params, cache=None):
    """``fn(p, cache)``, untagged; under a TP plan with this component
    sharded, ``fn`` once per shard of ``p`` (and ``cache``) and the partial
    outputs summed by the active gate — the reference's psum of the
    row-parallel output.  A tuple output's first element is summed and its
    second (a per-shard prompt cache, or None) stacked on the shard axis."""
    if not (enabled and cfg.tp_axis is not None):
        return fn(p, cache)
    outs = [fn(_shard(p, s), None if cache is None else _shard(cache, s))
            for s in range(_n_shards(p))]
    gate = collective.current()
    if not isinstance(outs[0], tuple):
        return gate.reduce(outs)
    extra = outs[0][1]
    if extra is not None:
        extra = {k: torch.stack([o[1][k] for o in outs]) for k in extra}
    return gate.reduce([o[0] for o in outs]), extra


def _mlp(p: Params, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """The gated MLP on the normed ``h``, reduced over its shards."""
    return _tp_reduce(cfg, cfg.tp_mlp,
                      lambda ps, _: layers.glu_mlp(ps, h, cfg.act, h.dtype), p)


def init_attention(key: torch.Tensor, cfg: ArchConfig) -> Params:
    hd = cfg.resolved_head_dim
    d = cfg.d_model
    k1, k2, k3, k4 = prng.split(key, 4).unbind(-2)
    return {
        "wq": layers._dense_init(k1, d, cfg.n_heads * hd),
        "wk": layers._dense_init(k2, d, cfg.n_kv_heads * hd),
        "wv": layers._dense_init(k3, d, cfg.n_kv_heads * hd),
        "wo": layers._dense_init(k4, cfg.n_heads * hd, d),
    }


def init_attn_block(key: torch.Tensor, cfg: ArchConfig) -> Params:
    """One block's params from ``key``; keys ``[L, 2]`` give the segment's
    ``[L, ...]`` stack, as the reference's vmap over per-layer keys does."""
    k1, k2 = prng.split(key).unbind(-2)
    lead = tuple(key.shape[:-1])
    return {
        "ln1": layers.init_norm(cfg.d_model, key.device, lead),
        "attn": init_attention(k1, cfg),
        "ln2": layers.init_norm(cfg.d_model, key.device, lead),
        "mlp": layers.init_glu_mlp(k2, cfg.d_model, cfg.d_ff),
    }


def _qkv(p: Params, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = layers.linear(p["wq"], x, x.dtype).reshape(b, s, cfg.n_heads, hd)
    k = layers.linear(p["wk"], x, x.dtype).reshape(b, s, cfg.n_kv_heads, hd)
    v = layers.linear(p["wv"], x, x.dtype).reshape(b, s, cfg.n_kv_heads, hd)
    # positions: (S,) shared by the batch, or (B, S) per row (ragged slots)
    pos = positions[None, None, :] if positions.ndim == 1 else positions[:, None, :]
    q = layers.apply_rope(q.transpose(1, 2), pos, cfg.rope_theta)
    k = layers.apply_rope(k.transpose(1, 2), pos, cfg.rope_theta)
    return q, k, v.transpose(1, 2)  # (B, H, S, hd)


def attention_fwd(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,
    *,
    kind: str = "causal",
    window: int | None = None,
    return_cache: bool = False,
    train: bool = False,
):
    """Self-attention of mask ``kind`` ("causal", or "swa" with ``window``)
    over the whole of ``x`` (positions from 0): kernel B3 on the card,
    ``blockwise_attention`` on the CPU and, with ``train=True``, on every
    device (the differentiable path)."""
    return _tp_reduce(cfg, cfg.tp_attn, lambda ps, _: _attention_fwd(
        ps, cfg, x, kind=kind, window=window, return_cache=return_cache, train=train), p)


def _attention_fwd(p: Params, cfg: ArchConfig, x: torch.Tensor, *, kind: str,
                   window: int | None, return_cache: bool, train: bool):
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x, torch.arange(s, device=x.device))
    out = attention(q, k, v, kind=kind, window=window, train=train)
    out = out.transpose(1, 2).reshape(b, s, -1)
    y = layers.linear(p["wo"], out, x.dtype)
    return y, ({"k": k, "v": v} if return_cache else None)


def _position_index(pos: int | torch.Tensor, device) -> torch.Tensor:
    """A decode position as a (1,) int64 tensor on ``device``: a 0-d device
    tensor is reshaped (no host sync, no copy: what a CUDA graph captures);
    a Python int is copied over."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int64).reshape(1)
    return torch.tensor([pos], device=device)


def _write_rows(cache: torch.Tensor, new: torch.Tensor, start: torch.Tensor) -> None:
    """cache (B, Hkv, L, hd)[r, :, start_r + j] = new (B, Hkv, n, hd)[r, :, j],
    in place: the reference's vmapped ``dynamic_update_slice`` (the engine
    keeps every slice inside the view, so nothing is clamped)."""
    b, _, n, _ = new.shape
    rows = torch.arange(b, device=cache.device)[:, None]
    cols = start.to(torch.int64)[:, None] + torch.arange(n, device=cache.device)
    cache[rows, :, cols] = new.permute(0, 2, 1, 3).to(cache.dtype)


def attention_step(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,
    cache: dict[str, torch.Tensor],
    pos: int | torch.Tensor,
    *,
    window: int | None = None,
) -> torch.Tensor:
    """x: (B, 1, d); cache k/v: (B, Hkv, S, hd), written in place at ``pos``
    by a device-indexed copy, the counterpart of the reference's
    ``dynamic_update_slice``.  ``pos``: a Python int or a 0-d int tensor
    (one position for the batch), or a (B,) int tensor of per-row positions
    (ragged continuous-batching decode), masked through ``decode_attention``'s
    (B,) valid length.  ``window`` keeps the last ``window`` positions (the
    plain ``swa`` kind; the reference drops it here, ROADMAP C.11)."""
    return _tp_reduce(cfg, cfg.tp_attn,
                      lambda ps, cs: _attention_step(ps, cfg, x, cs, pos, window), p, cache)


def _attention_step(p: Params, cfg: ArchConfig, x: torch.Tensor,
                    cache: dict[str, torch.Tensor], pos: int | torch.Tensor,
                    window: int | None) -> torch.Tensor:
    b = x.shape[0]
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        pos = pos.to(device=x.device, dtype=torch.int64)
        q, k, v = _qkv(p, cfg, x, pos[:, None])
        _write_rows(cache["k"], k, pos)
        _write_rows(cache["v"], v, pos)
        valid = pos + 1
    else:
        idx = _position_index(pos, x.device)
        q, k, v = _qkv(p, cfg, x, idx)
        cache["k"].index_copy_(2, idx, k.to(cache["k"].dtype))
        cache["v"].index_copy_(2, idx, v.to(cache["v"].dtype))
        valid = idx + 1
    out = decode_attention(q, cache["k"], cache["v"], valid, window=window)
    return layers.linear(p["wo"], out.transpose(1, 2).reshape(b, 1, -1), x.dtype)


def init_attn_cache(
    cfg: ArchConfig, batch: int, seq_len: int, dtype, device, lead: tuple[int, ...] = ()
) -> dict[str, Any]:
    """Zero k/v (*lead, B, Hkv, S, hd); a TP cache's ``lead`` ends with the
    shard count."""
    shape = lead + (batch, cfg.n_kv_heads, seq_len, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Paged KV attention (continuous-batching engine)
# ---------------------------------------------------------------------------

def init_attn_pool(cfg: ArchConfig, num_tokens: int, dtype, device,
                   lead: tuple[int, ...] = ()) -> dict[str, Any]:
    """Token-major physical KV pool: k/v (*lead, T, Hkv, hd)."""
    shape = lead + (num_tokens, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gather_pool_view(pool_arr: torch.Tensor, table: torch.Tensor, page_size: int) -> torch.Tensor:
    """(..., T, Hkv, hd) pool + (B, P) block table -> (..., B, Hkv, L, hd)
    contiguous per-slot cache view, L = P * page_size (a new tensor)."""
    *lead, t, hkv, hd = pool_arr.shape
    b, p = table.shape
    paged = pool_arr.reshape(*lead, t // page_size, page_size, hkv, hd)
    view = paged.index_select(len(lead), table.reshape(-1).to(torch.int64))
    view = view.reshape(*lead, b, p * page_size, hkv, hd)
    return view.movedim(-2, -3).contiguous()


def scatter_pool_view(
    pool_arr: torch.Tensor,
    view: torch.Tensor,
    table: torch.Tensor,
    pos0: torch.Tensor,
    n_tokens: int,
    page_size: int,
) -> torch.Tensor:
    """Write back the cells a dispatch filled, in place: view positions
    [pos0_r, pos0_r + n_tokens) of each row r land in their physical pool
    cells (dummy-page rows absorb padded writes).  view: (..., B, Hkv, L,
    hd); returns the updated (..., T, Hkv, hd) pool (the same tensor)."""
    *lead, b, hkv, _, hd = view.shape
    dev = pool_arr.device
    idx = pos0.to(torch.int64)[:, None] + torch.arange(n_tokens, device=dev)  # (B, n)
    blk = torch.gather(table.to(torch.int64), 1, idx // page_size)
    flat = (blk * page_size + idx % page_size).reshape(-1)  # (B*n,) pool cells
    sel = idx.reshape((1,) * len(lead) + (b, 1, n_tokens, 1)).expand(*lead, b, hkv, n_tokens, hd)
    got = torch.gather(view, -2, sel).movedim(-3, -2).reshape(*lead, b * n_tokens, hkv, hd)
    pool_arr.index_copy_(len(lead), flat, got.to(pool_arr.dtype))
    return pool_arr


def attention_chunk_step(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,
    cache: dict[str, torch.Tensor],
    start: torch.Tensor,
    kv_len: torch.Tensor,
    *,
    kind: str = "causal",
    window: int | None = None,
) -> torch.Tensor:
    """Multi-token continuation against a contiguous cache view, B rows wide.

    x: (B, C, d) — row r holds chunk positions [start_r, start_r + C) of its
    own request (tail columns past a row's true chunk length are padding —
    causality plus ``kv_len`` masking keep them invisible, and the caller's
    write-back routes them to cells no read sees first); cache k/v:
    (B, Hkv, L, hd), written in place; start / kv_len: 0-d or (B,) int
    tensors, ``kv_len`` the valid cache length after this chunk.  The
    attention is ``attention(..., kind, window, q_offset=start,
    kv_valid_len=kv_len)``:
    kernel B3 with per-row offsets on the card, ``blockwise_attention`` on
    the CPU (the reference calls ``blockwise_attention`` here on every
    backend).  Returns the block's attention output (B, C, d).
    """
    return _tp_reduce(cfg, cfg.tp_attn,
                      lambda ps, cs: _attention_chunk_step(ps, cfg, x, cs, start, kv_len,
                                                           kind, window),
                      p, cache)


def _attention_chunk_step(p: Params, cfg: ArchConfig, x: torch.Tensor,
                          cache: dict[str, torch.Tensor], start, kv_len, kind: str,
                          window: int | None) -> torch.Tensor:
    b, c, _ = x.shape
    start = torch.as_tensor(start, device=x.device)
    positions = (start[:, None] if start.ndim else start) + torch.arange(c, device=x.device)
    q, k, v = _qkv(p, cfg, x, positions)  # (B, H, C, hd)
    start_b = start.reshape(-1).expand(b)
    _write_rows(cache["k"], k, start_b)
    _write_rows(cache["v"], v, start_b)
    out = attention(q, cache["k"], cache["v"], kind=kind, window=window, q_offset=start,
                    kv_valid_len=kv_len)
    return layers.linear(p["wo"], out.transpose(1, 2).reshape(b, c, -1), x.dtype)


def attn_block_chunk_step(p: Params, cfg: ArchConfig, x, cache, start, kv_len, *,
                          kind: str = "causal", window: int | None = None):
    x = x + attention_chunk_step(p["attn"], cfg, layers.rmsnorm(p["ln1"], x), cache, start,
                                 kv_len, kind=kind, window=window)
    return x + _mlp(p["mlp"], cfg, layers.rmsnorm(p["ln2"], x))


def attn_block_fwd(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,
    *,
    kind: str = "causal",
    window: int | None = None,
    return_cache: bool = False,
    train: bool = False,
):
    a, cache = attention_fwd(p["attn"], cfg, layers.rmsnorm(p["ln1"], x), kind=kind,
                             window=window, return_cache=return_cache, train=train)
    x = x + a
    return x + _mlp(p["mlp"], cfg, layers.rmsnorm(p["ln2"], x)), cache


def attn_block_step(p: Params, cfg: ArchConfig, x, cache, pos: int | torch.Tensor, *,
                    window: int | None = None):
    """One token; with a ``window`` (the ``swa`` kind) it keeps the last
    ``window`` positions."""
    x = x + attention_step(p["attn"], cfg, layers.rmsnorm(p["ln1"], x), cache, pos,
                           window=window)
    return x + _mlp(p["mlp"], cfg, layers.rmsnorm(p["ln2"], x))
