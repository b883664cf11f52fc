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

The sharded dispatch (``set_moe_distribution(mesh)``, the reference's
``shard_map`` switch): tokens split over the mesh's data axes ("pod",
"data": contiguous batch rows in row-major order), experts over its
"model" axis — expert-parallel (EP) when ``n_alloc`` divides it, each
model shard owning ``n_alloc / n_model`` experts and keeping only the
assignments to them; expert-TP otherwise, each shard owning a
``d_expert / n_model`` column slice of ``wi_gate`` / ``wi_up`` and row
slice of ``wo``.  The shared GLU is column/row-sliced over "model", the
router replicated.  Each data shard routes its own tokens with its own
capacity (``t_local``), so when the capacity binds the answer differs
from the unsharded one, as the reference's does.  The model shards'
partials are summed by the active gate (``parallel.collective``): every
shard in turn in process (``ShardLoop``) or one a rank
(``ProcessGroupGate``, the rank's shard); the aux loss is the mean over
the data shards.  The unsharded dispatch is the same body at one data and
one model shard.  The shards are views of the full stacks, sliced per
call.  Operand dicts (packed / planes_int8 / const_rle deployments) raise
under a mesh, as the reference's ``shard_map`` does (ROADMAP C.15).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks, layers
from repro_torch.models.layers import Params
from repro_torch.parallel import collective
from repro_torch.parallel.sharding import axis_sizes_of

# The registered distribution: None, or the mesh's axis sizes, the model
# axis and the data axes present.
_DIST: dict = {"mesh": None, "sizes": {}, "data_axes": (), "model_axis": "model"}


def set_moe_distribution(mesh=None, *, model_axis: str = "model") -> None:
    """Register (or clear, with ``mesh=None``) the mesh of the sharded
    dispatch.  ``mesh``: a ``launch.mesh.Mesh`` or any object with
    ``axis_names`` and a ``shape``.  The model shards this process computes
    follow from the active gate: all of them in turn (``ShardLoop``), or
    its rank's one (``ProcessGroupGate``)."""
    if mesh is None:
        _DIST.update(mesh=None, sizes={}, data_axes=())
        return
    sizes = axis_sizes_of(mesh)
    if model_axis not in sizes:
        raise ValueError(f"mesh axes {tuple(sizes)} have no model axis {model_axis!r}")
    data_axes = tuple(a for a in ("pod", "data") if a in sizes)
    _DIST.update(mesh=mesh, sizes=sizes, data_axes=data_axes, model_axis=model_axis)


def distribution() -> tuple | None:
    """The registered distribution as a hashable value (None when the
    dispatch is unsharded): the mesh's axis sizes and the model axis.  What
    a captured decode graph was built under."""
    if _DIST["mesh"] is None:
        return None
    return tuple(_DIST["sizes"].items()), _DIST["model_axis"]


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


def _check_sharded(p: Params, cfg: ArchConfig, b: int, n_data: int, n_model: int) -> bool:
    """Refuse what the reference's ``shard_map`` refuses; -> EP or not."""
    m = cfg.moe
    leaves = {k: p[k] for k in ("router", "wi_gate", "wi_up", "wo")}
    leaves.update({f"shared/{k}": v for k, v in p.get("shared", {}).items()})
    dicts = [k for k, v in leaves.items() if isinstance(v, dict)]
    if dicts:
        raise ValueError(
            f"the sharded MoE dispatch takes dense weights; {', '.join(dicts)} are crossbar "
            f"operand dicts (packed / planes_int8 / const_rle deployments are served "
            f"unsharded; ROADMAP C.15)")
    if b % n_data:
        raise ValueError(f"batch {b} does not split over the {n_data} data shards")
    ep = m.n_alloc % n_model == 0
    if not ep and m.d_expert % n_model:
        raise ValueError(f"neither n_alloc {m.n_alloc} (expert-parallel) nor d_expert "
                         f"{m.d_expert} (expert-TP) divides over the {n_model}-way model axis")
    if "shared" in p and p["shared"]["wi_gate"].shape[-1] % n_model:
        raise ValueError(f"the shared width {p['shared']['wi_gate'].shape[-1]} does not divide "
                         f"over the {n_model}-way model axis")
    return ep


def _model_shard(p: Params, cfg: ArchConfig, xf, topw, flat_e, pos, keep, cap: int, j: int,
                 n_model: int, ep: bool) -> torch.Tensor:
    """Model shard ``j``'s partial output (T, d): its experts (EP) or its
    d_expert slice (expert-TP), plus its slice of the shared GLU; with one
    shard, the whole layer on ``p`` as it stands (operand dicts included)."""
    m = cfg.moe
    n_buf, slot_e, w, sp = m.n_alloc, flat_e, p, p.get("shared")
    if n_model > 1:
        if ep:
            n_buf = m.n_alloc // n_model
            lo = j * n_buf
            keep = keep & (flat_e >= lo) & (flat_e < lo + n_buf)
            slot_e = flat_e - lo
            w = {k: p[k][lo:lo + n_buf] for k in ("wi_gate", "wi_up", "wo")}
        else:
            cols = slice(j * m.d_expert // n_model, (j + 1) * m.d_expert // n_model)
            w = {"wi_gate": p["wi_gate"][..., cols], "wi_up": p["wi_up"][..., cols],
                 "wo": p["wo"][:, cols]}
        if sp is not None:
            width = sp["wi_gate"].shape[-1] // n_model
            c = slice(j * width, (j + 1) * width)
            sp = {"wi_gate": sp["wi_gate"][:, c], "wi_up": sp["wi_up"][:, c], "wo": sp["wo"][c]}
    slot = torch.where(keep, slot_e * cap + pos, n_buf * cap)  # overflow -> trash
    y = _ffn_combine(w, cfg, xf, topw, slot, keep, n_buf=n_buf, cap=cap)
    if sp is not None:
        y = y + layers.glu_mlp(sp, xf, cfg.act, xf.dtype)
    return y


def moe_mlp(p: Params, cfg: ArchConfig, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d), aux 0-d f32).  Unsharded, one data and
    one model shard; under the registered mesh, for each data shard, local
    routing and capacity, then this process's model shards' partials summed
    by the active gate (the reference's psum over "model"), and the aux loss
    the mean over the data shards (its pmean).  With one shard of either
    kind, its gate, concatenation or mean is left out."""
    m = cfg.moe
    b, s, d = x.shape
    n_data, n_model, ep = 1, 1, True
    if _DIST["mesh"] is not None:
        sizes = _DIST["sizes"]
        n_model = sizes[_DIST["model_axis"]]
        n_data = math.prod(sizes[a] for a in _DIST["data_axes"])
        ep = _check_sharded(p, cfg, b, n_data, n_model)
    gate = collective.current()
    shards = gate.local_shards(n_model) if n_model > 1 else (0,)
    bl = b // n_data
    t = bl * s
    cap = max(8, int(m.capacity_factor * t * m.top_k / m.n_routed + 0.999))
    ys, auxes = [], []
    for i in range(n_data):
        xf = x[i * bl:(i + 1) * bl].reshape(t, d)
        topw, topi, aux = _route(p, m, xf, m.n_routed)
        flat_e = topi.reshape(-1)  # (T*k,)
        pos = _assignment_ranks(flat_e, m.n_routed)
        keep = pos < cap
        parts = [_model_shard(p, cfg, xf, topw, flat_e, pos, keep, cap, j, n_model, ep)
                 for j in shards]
        ys.append(gate.reduce(parts) if n_model > 1 else parts[0])
        auxes.append(aux)
    y = torch.cat(ys) if n_data > 1 else ys[0]
    aux = torch.stack(auxes).mean() if n_data > 1 else auxes[0]
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
