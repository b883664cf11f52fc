"""Multi-head Latent Attention (DeepSeek-V2) with absorbed-matmul decode.

Port of ``repro.models.mla``.  Prefill and training use the expanded form
(per-head K/V up-projections ``wk_b`` / ``wv_b``) through
``blockwise_attention`` on every device, as the reference's prefill does
(q/k head dim ``qk_nope + qk_rope``, v head dim ``v_head_dim``; B3 is not
on this path).  The decode step uses the *absorbed* form: ``wk_b`` is
folded into the query and ``wv_b`` into the output, so the cache holds only
the normed latent ``c_kv`` (kv_lora_rank) and the shared RoPE key
``k_rope`` (qk_rope_head_dim) a token.

``wk_b`` and ``wv_b`` are reshaped per head in the decode step, so they stay
dense under every materialization (``planner.MATERIALIZE_DENSE_ONLY``);
``wq_a``, ``wq_b``, ``wkv_a`` and ``wo`` go through ``layers.linear`` (the
CIM kernels for operand dicts).  The decode step writes position ``pos``
into the cache in place at a device index and reads nothing on the host,
so a CUDA graph captures a whole decode.
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers, moe
from repro_torch.models.attention import NEG_INF, blockwise_attention
from repro_torch.models.blocks import _position_index
from repro_torch.models.layers import Params


def init_mla(key: torch.Tensor, cfg: ArchConfig) -> Params:
    """The MLA projections from ``key`` (keys ``[L, 2]`` give ``[L, ...]``
    stacks), the reference's draws bit for bit."""
    m = cfg.mla
    if m is None:
        raise ValueError(f"{cfg.name} has no MLA config")
    ks = prng.split(key, 6).unbind(-2)
    lead = tuple(key.shape[:-1])
    h = cfg.n_heads
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": layers._dense_init(ks[0], cfg.d_model, m.q_lora_rank),
        "q_norm": layers.init_norm(m.q_lora_rank, key.device, lead),
        "wq_b": layers._dense_init(ks[1], m.q_lora_rank, h * qk_dim),
        "wkv_a": layers._dense_init(ks[2], cfg.d_model, m.kv_lora_rank + m.qk_rope_head_dim),
        "kv_norm": layers.init_norm(m.kv_lora_rank, key.device, lead),
        "wk_b": layers._dense_init(ks[3], m.kv_lora_rank, h * m.qk_nope_head_dim),
        "wv_b": layers._dense_init(ks[4], m.kv_lora_rank, h * m.v_head_dim),
        "wo": layers._dense_init(ks[5], h * m.v_head_dim, cfg.d_model),
    }


def _project_q(p: Params, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor):
    """-> q_nope (B, H, S, dn), q_rope (B, H, S, dr)."""
    m = cfg.mla
    b, s, _ = x.shape
    dtype = x.dtype
    ql = layers.rmsnorm(p["q_norm"], layers.linear(p["wq_a"], x, dtype))
    q = layers.linear(p["wq_b"], ql, dtype).reshape(b, s, cfg.n_heads, -1).transpose(1, 2)
    q_nope, q_rope = q[..., : m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    q_rope = layers.apply_rope(q_rope, positions[None, None, :], cfg.rope_theta)
    return q_nope, q_rope


def _project_kv_latent(p: Params, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor):
    """-> c_kv (B, S, r), k_rope (B, S, dr): what the decode cache holds."""
    m = cfg.mla
    kv = layers.linear(p["wkv_a"], x, x.dtype)
    c_kv, k_rope = kv[..., : m.kv_lora_rank], kv[..., m.kv_lora_rank:]
    c_kv = layers.rmsnorm(p["kv_norm"], c_kv)
    k_rope = layers.apply_rope(k_rope[:, None], positions[None, None, :], cfg.rope_theta)[:, 0]
    return c_kv, k_rope


def mla_attention_fwd(p: Params, cfg: ArchConfig, x: torch.Tensor, *,
                      return_cache: bool = False):
    """Expanded-form MLA over the whole of ``x`` (positions from 0); the
    cache holds the latent.  -> (y (B, S, d), {"c_kv", "k_rope"} or None)."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    dtype = x.dtype
    positions = torch.arange(s, device=x.device)

    q_nope, q_rope = _project_q(p, cfg, x, positions)
    c_kv, k_rope = _project_kv_latent(p, cfg, x, positions)

    k_nope = (c_kv @ p["wk_b"].to(dtype)).reshape(b, s, h, m.qk_nope_head_dim).transpose(1, 2)
    v = (c_kv @ p["wv_b"].to(dtype)).reshape(b, s, h, m.v_head_dim).transpose(1, 2)
    k_rope_h = k_rope[:, None].expand(b, h, s, m.qk_rope_head_dim)

    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_h], dim=-1)
    out = blockwise_attention(q, k, v, kind="causal")
    out = out.transpose(1, 2).reshape(b, s, h * m.v_head_dim)
    y = layers.linear(p["wo"], out, dtype)
    return y, ({"c_kv": c_kv, "k_rope": k_rope} if return_cache else None)


def mla_attention_step(p: Params, cfg: ArchConfig, x: torch.Tensor,
                       cache: dict[str, torch.Tensor], pos: int | torch.Tensor) -> torch.Tensor:
    """Absorbed-form one-token decode against the latent cache.

    x: (B, 1, d); cache c_kv (B, S, r) and k_rope (B, S, dr), written in
    place at ``pos`` (a Python int or a 0-d int tensor: one position for the
    batch, as in the reference).  Scores, softmax and the context are f32;
    the context is cast to the compute dtype before ``wv_b``.
    """
    if isinstance(pos, torch.Tensor) and pos.ndim:
        raise ValueError("MLA decodes one position for the batch; per-row positions are "
                         "the paged engine's, which refuses MLA as the reference's does")
    m = cfg.mla
    b = x.shape[0]
    h = cfg.n_heads
    dtype = x.dtype
    idx = _position_index(pos, x.device)

    q_nope, q_rope = _project_q(p, cfg, x, idx)  # (B, H, 1, dn) / (B, H, 1, dr)
    c_new, kr_new = _project_kv_latent(p, cfg, x, idx)  # (B, 1, r) / (B, 1, dr)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    c_kv.index_copy_(1, idx, c_new.to(c_kv.dtype))
    k_rope.index_copy_(1, idx, kr_new.to(k_rope.dtype))

    wk_b = p["wk_b"].to(dtype).reshape(m.kv_lora_rank, h, m.qk_nope_head_dim)
    q_eff = torch.einsum("bhqd,rhd->bhqr", q_nope, wk_b)  # W_UK absorbed into q
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    c32 = c_kv.to(torch.float32)
    scores = (
        torch.einsum("bhqr,bsr->bhqs", q_eff.to(torch.float32), c32)
        + torch.einsum("bhqd,bsd->bhqs", q_rope.to(torch.float32), k_rope.to(torch.float32))
    ) * scale
    valid = torch.arange(c_kv.shape[1], device=x.device) <= idx
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)

    ctx = torch.einsum("bhqs,bsr->bhqr", probs, c32)  # (B, H, 1, r)
    wv_b = p["wv_b"].to(dtype).reshape(m.kv_lora_rank, h, m.v_head_dim)
    out = torch.einsum("bhqr,rhd->bhqd", ctx.to(dtype), wv_b)
    out = out.transpose(1, 2).reshape(b, 1, h * m.v_head_dim)
    return layers.linear(p["wo"], out, dtype)


def init_mla_cache(cfg: ArchConfig, batch: int, seq_len: int, dtype, device,
                   lead: tuple[int, ...] = ()) -> dict[str, torch.Tensor]:
    """Zero latent cache: c_kv (*lead, B, S, r), k_rope (*lead, B, S, dr)."""
    m = cfg.mla
    return {
        "c_kv": torch.zeros(lead + (batch, seq_len, m.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros(lead + (batch, seq_len, m.qk_rope_head_dim), dtype=dtype,
                              device=device),
    }


# ---------------------------------------------------------------------------
# MLA + MoE block (the DeepSeek-V2 layer)
# ---------------------------------------------------------------------------

def init_mla_moe_block(key: torch.Tensor, cfg: ArchConfig) -> Params:
    """One block's params from ``key``; keys ``[L, 2]`` give the segment's
    ``[L, ...]`` stack, as the reference's vmap over per-layer keys does."""
    k1, k2 = prng.split(key).unbind(-2)
    lead = tuple(key.shape[:-1])
    return {
        "ln1": layers.init_norm(cfg.d_model, key.device, lead),
        "mla": init_mla(k1, cfg),
        "ln2": layers.init_norm(cfg.d_model, key.device, lead),
        "moe": moe.init_moe_mlp(k2, cfg),
    }


def mla_moe_block_fwd(p: Params, cfg: ArchConfig, x: torch.Tensor, *,
                      return_cache: bool = False, train: bool = False):
    """-> (x, latent prompt cache or None, aux).  Attention is
    ``blockwise_attention`` whatever ``train`` says."""
    a, cache = mla_attention_fwd(p["mla"], cfg, layers.rmsnorm(p["ln1"], x),
                                 return_cache=return_cache)
    x = x + a
    y, aux = moe.moe_mlp(p["moe"], cfg, layers.rmsnorm(p["ln2"], x))
    return x + y, cache, aux


def mla_moe_block_step(p: Params, cfg: ArchConfig, x, cache, pos: int | torch.Tensor):
    x = x + mla_attention_step(p["mla"], cfg, layers.rmsnorm(p["ln1"], x), cache, pos)
    y, _ = moe.moe_mlp(p["moe"], cfg, layers.rmsnorm(p["ln2"], x))
    return x + y
