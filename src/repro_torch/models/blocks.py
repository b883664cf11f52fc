"""Dense transformer block: pre-norm attention + pre-norm gated MLP.

Port of the attention block of ``repro.models.blocks`` (no tensor
parallelism, no paged KV).  Layer params are one layer's slice of the
segment stack.  The decode step writes its K/V into the cache in place (the
counterpart of the reference's donated, functionally updated cache).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers
from repro_torch.models.attention import attention, decode_attention
from repro_torch.models.layers import Params


def init_attention(gen, cfg: ArchConfig, device, lead: tuple[int, ...] = ()) -> Params:
    hd = cfg.resolved_head_dim
    d = cfg.d_model
    return {
        "wq": layers._dense_init(gen, lead + (d, cfg.n_heads * hd), device),
        "wk": layers._dense_init(gen, lead + (d, cfg.n_kv_heads * hd), device),
        "wv": layers._dense_init(gen, lead + (d, cfg.n_kv_heads * hd), device),
        "wo": layers._dense_init(gen, lead + (cfg.n_heads * hd, d), device),
    }


def init_attn_block(gen, cfg: ArchConfig, device, lead: tuple[int, ...] = ()) -> Params:
    return {
        "ln1": layers.init_norm(cfg.d_model, device, lead),
        "attn": init_attention(gen, cfg, device, lead),
        "ln2": layers.init_norm(cfg.d_model, device, lead),
        "mlp": layers.init_glu_mlp(gen, cfg.d_model, cfg.d_ff, device, lead),
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
):
    """Causal self-attention over the whole of ``x`` (positions from 0):
    kernel B3 on the card, ``blockwise_attention`` on the CPU."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x, torch.arange(s, device=x.device))
    out = attention(q, k, v, kind="causal")
    out = out.transpose(1, 2).reshape(b, s, -1)
    y = layers.linear(p["wo"], out, x.dtype)
    return y, ({"k": k, "v": v} if return_cache else None)


def attention_step(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,
    cache: dict[str, torch.Tensor],
    pos: int,
) -> torch.Tensor:
    """x: (B, 1, d); cache k/v: (B, Hkv, S, hd), written in place at ``pos``."""
    b = x.shape[0]
    q, k, v = _qkv(p, cfg, x, torch.tensor([pos], device=x.device))
    cache["k"][:, :, pos:pos + 1] = k
    cache["v"][:, :, pos:pos + 1] = v
    out = decode_attention(q, cache["k"], cache["v"], pos + 1)
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
):
    a, cache = attention_fwd(p["attn"], cfg, layers.rmsnorm(p["ln1"], x), return_cache=return_cache)
    x = x + a
    x = x + layers.glu_mlp(p["mlp"], layers.rmsnorm(p["ln2"], x), cfg.act, x.dtype)
    return x, cache


def attn_block_step(p: Params, cfg: ArchConfig, x, cache, pos: int):
    x = x + attention_step(p["attn"], cfg, layers.rmsnorm(p["ln1"], x), cache, pos)
    return x + layers.glu_mlp(p["mlp"], layers.rmsnorm(p["ln2"], x), cfg.act, x.dtype)
