"""Mixture-of-Experts blocks (port of ``repro.models.moe``, Qwen2-MoE style).

Shared experts (always active) are one dense GLU of width ``n_shared *
d_expert``.  Routed experts use the reference's drop-on-overflow capacity
dispatch through a sorted scatter: assignments are ranked within their
expert in arrival order (stable argsort + searchsorted), the first ``cap``
of each expert get a slot of an ``(n_alloc, cap, d)`` buffer, the rest are
dropped, and the expert FFNs run as batched matmuls over the leading expert
axis — for crossbar operand dicts ONE grouped launch of B2 / B4 / B5 per
expert stack (``layers.linear``).  Nothing in the dispatch reads a value on
the host (no ``.item()``, ``nonzero`` or boolean-mask indexing, and every
shape follows from the batch's), so a CUDA graph captures a whole decode.

Top-k is a stable descending sort, so equal probabilities keep the lower
expert first, as ``jax.lax.top_k`` does.  The load-balance aux loss is the
reference's switch-style loss; ``transformer.forward`` sums it over layers.

The reference's sharded ``shard_map`` dispatch (``set_moe_distribution``
with a mesh) is not ported: asking for it raises (ROADMAP A.16).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks, layers
from repro_torch.models.layers import Params


def set_moe_distribution(mesh=None, **_) -> None:
    """The reference registers a mesh here for its sharded dispatch, which
    the port does not have: ``None`` (the unsharded dispatch) is accepted,
    a mesh raises."""
    if mesh is not None:
        raise NotImplementedError(
            "the sharded MoE dispatch (shard_map over a mesh) is not ported (ROADMAP A.16)"
        )


def init_moe_mlp(key: torch.Tensor, cfg: ArchConfig) -> Params:
    """Router, routed expert stacks and the shared GLU from ``key`` (keys
    ``[L, 2]`` give ``[L, ...]`` stacks), the reference's draws bit for bit."""
    m = cfg.moe
    if m is None:
        raise ValueError(f"{cfg.name} has no MoE config")
    k1, k2, k3, k4, k5 = prng.split(key, 5).unbind(-2)
    e, d, de, ea = m.n_routed, cfg.d_model, m.d_expert, m.n_alloc
    std = layers._f32(1.0 / (d**0.5), key.device)
    std_o = layers._f32(1.0 / de**0.5, key.device)
    p: Params = {
        "router": layers._dense_init(k1, d, e),
        "wi_gate": prng.truncated_normal(k2, -3.0, 3.0, (ea, d, de)) * std,
        "wi_up": prng.truncated_normal(k3, -3.0, 3.0, (ea, d, de)) * std,
        "wo": prng.truncated_normal(k4, -3.0, 3.0, (ea, de, d)) * std_o,
    }
    if m.n_shared > 0:
        p["shared"] = layers.init_glu_mlp(k5, d, m.n_shared * de)
    return p


def _route(p: Params, m, xf: torch.Tensor, e: int):
    """Router: -> (topw (T, k) f32, topi (T, k) int64, aux 0-d f32)."""
    logits = layers.linear(p["router"], xf.to(torch.float32), torch.float32)  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # stable descending sort: on equal values the lower index comes first,
    # as in jax.lax.top_k (torch.topk promises no order)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = vals[:, : m.top_k], idx[:, : m.top_k]
    topw = topw / torch.clamp(torch.sum(topw, dim=-1, keepdim=True), min=1e-9)
    # load-balance aux (Switch-style); the one-hot by comparison, not
    # F.one_hot, whose range check reads the indices on the host
    me = torch.mean(probs, dim=0)  # (E,)
    one_hot = (topi[:, :1] == torch.arange(e, device=topi.device)).to(torch.float32)
    ce = torch.mean(one_hot, dim=0)
    aux = e * torch.sum(me * ce) * m.router_aux_weight
    return topw, topi, aux


def _assignment_ranks(flat_e: torch.Tensor, e: int) -> torch.Tensor:
    """Rank of each assignment within its expert (stable arrival order)."""
    n = flat_e.shape[0]
    dev = flat_e.device
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    first = torch.searchsorted(sorted_e, torch.arange(e, dtype=sorted_e.dtype, device=dev),
                               side="left")
    pos_sorted = torch.arange(n, dtype=torch.int64, device=dev) - first[sorted_e]
    return torch.zeros(n, dtype=torch.int64, device=dev).scatter_(0, sort_idx, pos_sorted)


def _ffn_combine(p: Params, cfg: ArchConfig, xf: torch.Tensor, topw: torch.Tensor,
                 slot: torch.Tensor, keep: torch.Tensor, *, n_buf: int, cap: int) -> torch.Tensor:
    """Gather -> grouped expert GLUs -> gather-combine.  slot in [0, n_buf * cap]
    (n_buf * cap is the trash slot of a dropped assignment)."""
    dtype = xf.dtype
    t, d = xf.shape
    k = cfg.moe.top_k
    n_assign = t * k
    dev = xf.device
    # invert slot -> source assignment (the lowest one a slot receives;
    # every kept slot receives one), then gather the token rows
    src = torch.full((n_buf * cap + 1,), n_assign, dtype=torch.int64, device=dev)
    src.scatter_reduce_(0, slot, torch.arange(n_assign, dtype=torch.int64, device=dev), "amin",
                        include_self=True)
    src = src[: n_buf * cap]
    valid = src < n_assign
    tok = torch.clamp(src // k, max=t - 1)
    buf = (xf[tok] * valid[:, None].to(dtype)).reshape(n_buf, cap, d)

    # batched per-expert matmuls: dense stacks by the batched @, operand
    # dicts by one grouped kernel launch over the expert axis
    gate = layers.linear(p["wi_gate"], buf, dtype)
    up = layers.linear(p["wi_up"], buf, dtype)
    h = F.silu(gate) * up
    out = layers.linear(p["wo"], h, dtype)

    flat_o = torch.cat([out.reshape(n_buf * cap, d), torch.zeros((1, d), dtype=dtype, device=dev)])
    y_tk = flat_o[slot] * (keep.to(dtype) * topw.reshape(-1).to(dtype))[:, None]
    return torch.sum(y_tk.reshape(t, k, d), dim=1)


def moe_mlp(p: Params, cfg: ArchConfig, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d), aux 0-d f32)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e = m.n_routed
    xf = x.reshape(t, d)

    topw, topi, aux = _route(p, m, xf, e)

    cap = max(8, int(m.capacity_factor * t * m.top_k / e + 0.999))
    flat_e = topi.reshape(-1)  # (T*k,)
    pos = _assignment_ranks(flat_e, e)
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos, m.n_alloc * cap)  # overflow -> trash

    y = _ffn_combine(p, cfg, xf, topw, slot, keep, n_buf=m.n_alloc, cap=cap)
    if "shared" in p:
        y = y + layers.glu_mlp(p["shared"], xf, cfg.act, x.dtype)
    return y.reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# MoE block: attention + MoE MLP
# ---------------------------------------------------------------------------

def init_moe_block(key: torch.Tensor, cfg: ArchConfig) -> Params:
    """One block's params from ``key``; keys ``[L, 2]`` give the segment's
    ``[L, ...]`` stack, as the reference's vmap over per-layer keys does."""
    k1, k2 = prng.split(key).unbind(-2)
    lead = tuple(key.shape[:-1])
    return {
        "ln1": layers.init_norm(cfg.d_model, key.device, lead),
        "attn": blocks.init_attention(k1, cfg),
        "ln2": layers.init_norm(cfg.d_model, key.device, lead),
        "moe": init_moe_mlp(k2, cfg),
    }


def moe_block_fwd(p: Params, cfg: ArchConfig, x: torch.Tensor, *, return_cache: bool = False,
                  train: bool = False):
    """-> (x, prompt cache or None, aux)."""
    a, cache = blocks.attention_fwd(p["attn"], cfg, layers.rmsnorm(p["ln1"], x),
                                    return_cache=return_cache, train=train)
    x = x + a
    y, aux = moe_mlp(p["moe"], cfg, layers.rmsnorm(p["ln2"], x))
    return x + y, cache, aux


def moe_block_step(p: Params, cfg: ArchConfig, x, cache, pos: int | torch.Tensor):
    x = x + blocks.attention_step(p["attn"], cfg, layers.rmsnorm(p["ln1"], x), cache, pos)
    y, _ = moe_mlp(p["moe"], cfg, layers.rmsnorm(p["ln2"], x))
    return x + y
