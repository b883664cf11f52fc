"""Dense transformer block: pre-norm attention + pre-norm gated MLP.

Port of the attention block of ``repro.models.blocks`` (no tensor
parallelism, no paged KV).  Layer params are one layer's slice of the
segment stack.  The decode step writes its K/V into the cache in place (the
counterpart of the reference's donated, functionally updated cache).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import prng
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers
from repro_torch.models.attention import attention, decode_attention
from repro_torch.models.layers import Params


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
    pos = positions[None, None, :]
    q = layers.apply_rope(q.transpose(1, 2), pos, cfg.rope_theta)
    k = layers.apply_rope(k.transpose(1, 2), pos, cfg.rope_theta)
    return q, k, v.transpose(1, 2)  # (B, H, S, hd)


def attention_fwd(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,
    *,
    return_cache: bool = False,
    train: bool = False,
):
    """Causal self-attention over the whole of ``x`` (positions from 0):
    kernel B3 on the card, ``blockwise_attention`` on the CPU and, with
    ``train=True``, on every device (the differentiable path)."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x, torch.arange(s, device=x.device))
    out = attention(q, k, v, kind="causal", train=train)
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


def attention_step(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,
    cache: dict[str, torch.Tensor],
    pos: int | torch.Tensor,
) -> torch.Tensor:
    """x: (B, 1, d); cache k/v: (B, Hkv, S, hd), written in place at ``pos``
    (a Python int or a 0-d int tensor) by a device-indexed copy, the
    counterpart of the reference's ``dynamic_update_slice``."""
    b = x.shape[0]
    idx = _position_index(pos, x.device)
    q, k, v = _qkv(p, cfg, x, idx)
    cache["k"].index_copy_(2, idx, k.to(cache["k"].dtype))
    cache["v"].index_copy_(2, idx, v.to(cache["v"].dtype))
    out = decode_attention(q, cache["k"], cache["v"], idx + 1)
    return layers.linear(p["wo"], out.transpose(1, 2).reshape(b, 1, -1), x.dtype)


def init_attn_cache(
    cfg: ArchConfig, batch: int, seq_len: int, dtype, device, lead: tuple[int, ...] = ()
) -> dict[str, Any]:
    shape = lead + (batch, cfg.n_kv_heads, seq_len, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_block_fwd(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,
    *,
    return_cache: bool = False,
    train: bool = False,
):
    a, cache = attention_fwd(p["attn"], cfg, layers.rmsnorm(p["ln1"], x),
                             return_cache=return_cache, train=train)
    x = x + a
    x = x + layers.glu_mlp(p["mlp"], layers.rmsnorm(p["ln2"], x), cfg.act, x.dtype)
    return x, cache


def attn_block_step(p: Params, cfg: ArchConfig, x, cache, pos: int | torch.Tensor):
    x = x + attention_step(p["attn"], cfg, layers.rmsnorm(p["ln1"], x), cache, pos)
    return x + layers.glu_mlp(p["mlp"], layers.rmsnorm(p["ln2"], x), cfg.act, x.dtype)
