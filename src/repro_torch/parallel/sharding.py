"""Name-rule param sharding with divisibility fallback (MaxText-style).

Port of ``repro.parallel.sharding``.  ``param_specs(params, axis_sizes)``
walks a params tree and assigns each leaf a spec from an ordered rule table
keyed on the parameter's path.  Rules encode the Megatron-canonical
tensor-parallel layout (column-parallel up-projections, row-parallel
down-projections, expert-parallel MoE); every rule is checked for
divisibility against the axis size and degrades through a fallback chain
(alternate axis -> replicate), which is how e.g. gemma-2b's 8 query heads
survive a 16-way model axis.

A spec is a plain tuple of axis names (``None`` = replicated on that dim),
taken over ``axis_sizes``: a dict ``{axis: size}``, or an object with
``axis_names`` and a ``shape`` (or ``devices.shape``) of the same length.
The rules of the families the port does not serve yet (MLA, MoE, SSM,
xLSTM) are kept, so that the table is the reference's whole.

Stacked layer parameters (under segments/encoder/decoder) get a leading
``None`` for the layer axis.  ``fsdp=True`` additionally shards the largest
still-unsharded axis of big params over the "data" axis (ZeRO-3 style).
"""
from __future__ import annotations

import math
import re
from typing import Any, Optional

from repro_torch import tree

Spec = tuple[Optional[Any], ...]

# Ordered (regex, spec) rule table.  Spec entries name the *intended* axis
# per tensor dim (ignoring the stacked-layer dim, handled separately); None
# means replicated.  Divisibility is enforced at resolution time.
_RULES: list[tuple[str, tuple[Optional[str], ...]]] = [
    # embeddings / unembeddings: shard the vocab axis
    (r"embed/table$", ("model", None)),
    (r"head/w$", (None, "model")),
    (r"meta$", (None, None)),
    # attention: column-parallel QKV, row-parallel output
    (r"(attn|self|cross)/wq$", (None, "model")),
    (r"(attn|self|cross)/wk$", (None, "model")),
    (r"(attn|self|cross)/wv$", (None, "model")),
    (r"(attn|self|cross)/wo$", ("model", None)),
    # MLA: low-rank down-projections row-parallel
    (r"mla/wq_a$", ("model", None)),
    (r"mla/wq_b$", (None, "model")),
    (r"mla/wkv_a$", ("model", None)),
    (r"mla/wk_b$", (None, "model")),
    (r"mla/wv_b$", (None, "model")),
    (r"mla/wo$", ("model", None)),
    # dense MLP / shared experts
    (r"(mlp|shared)/wi_gate$", (None, "model")),
    (r"(mlp|shared)/wi_up$", (None, "model")),
    (r"(mlp|shared)/wo$", ("model", None)),
    # routed experts: expert-parallel, fallback chain handles E % axis != 0
    (r"moe/wi_gate$", ("model", None, None)),
    (r"moe/wi_up$", ("model", None, None)),
    (r"moe/wo$", ("model", None, None)),
    (r"moe/router$", ("model", None)),
    # xLSTM / Mamba projections
    (r"w_up$", (None, "model")),
    (r"w_down$", ("model", None)),
    (r"(wq|wk|wv)$", (None, "model")),
    (r"in_proj$", (None, "model")),
    (r"out_proj$", ("model", None)),
    (r"x_proj$", ("model", None)),
    (r"dt_proj$", (None, "model")),
    (r"a_log$", ("model", None)),
    (r"d_skip$", ("model",)),
    (r"conv/w$", (None, "model")),
    (r"w_if$", (None, None)),
    (r"src_proj/w$", (None, "model")),
    (r"/w$", (None, "model")),  # generic dense (sLSTM fused gates, ...)
    (r"/r$", (None, None, "model")),
    (r"w_out$", ("model", None)),
    (r"dt_bias$", ("model",)),
]

_STACKED = re.compile(r"(^|/)(segments/\d+|encoder|decoder)(/|$)")

# MoE expert-parallel fallback: if E doesn't divide the model axis, shard
# the expert-ffn dim instead (TP within each expert).
_MOE_FALLBACKS = {
    "moe/wi_gate": (None, None, "model"),
    "moe/wi_up": (None, None, "model"),
    "moe/wo": (None, "model", None),
}


def _path_name(path) -> str:
    """'/'-joined name of a tree path (dict keys and list indices)."""
    return tree.path_name(tuple(path))


def _fits(shape: tuple[int, ...], spec: Spec, axis_sizes) -> bool:
    for dim, ax in zip(shape, spec):
        if ax is not None and dim % axis_sizes[ax] != 0:
            return False
    return True


def _resolve(
    name: str, shape: tuple[int, ...], axis_sizes: dict[str, int], *, fsdp: bool, fsdp_min: int
) -> Spec:
    """The spec of one leaf: the first matching rule whose rank fits, then
    its fallbacks (MoE, axis swap, replicate) until one divides."""
    stacked = bool(_STACKED.search(name))
    core_shape = shape[1:] if stacked else shape
    spec: Spec = tuple(None for _ in core_shape)
    for pat, rule in _RULES:
        if re.search(pat, name) and len(rule) == len(core_shape):
            candidates = [rule]
            for key, fb in _MOE_FALLBACKS.items():
                if name.endswith(key.split("/")[-1]) and key.split("/")[0] in name:
                    candidates.append(fb)
            # axis-swap fallback: if the intended dim is indivisible, move
            # the axis to another dim before giving up and replicating
            used = [a for a in rule if a is not None]
            if len(used) == 1:
                ax = used[0]
                j = rule.index(ax)
                for i in range(len(core_shape)):
                    if i != j and rule[i] is None:
                        cand = list(rule)
                        cand[i], cand[j] = ax, None
                        candidates.append(tuple(cand))
            candidates.append(tuple(None for _ in core_shape))
            for cand in candidates:
                if _fits(core_shape, cand, axis_sizes):
                    spec = cand
                    break
            break
    spec = list(spec)
    if fsdp and "data" in axis_sizes and math.prod(core_shape) >= fsdp_min:
        # ZeRO-3: shard the largest unsharded dim over "data"
        order = sorted(range(len(core_shape)), key=lambda i: -core_shape[i])
        for i in order:
            if spec[i] is None and core_shape[i] % axis_sizes["data"] == 0:
                spec[i] = "data"
                break
    if stacked:
        spec = [None, *spec]
    return tuple(spec)


def axis_sizes_of(mesh) -> dict[str, int]:
    """``{axis: size}`` of a dict, or of an object with ``axis_names`` and
    ``shape`` (or ``devices.shape``)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    shape = getattr(mesh, "shape", None)
    if shape is None or isinstance(shape, dict):
        shape = mesh.devices.shape
    return dict(zip(mesh.axis_names, tuple(shape)))


def param_specs(params: Any, mesh, *, fsdp: bool = False, fsdp_min: int = 2**16) -> Any:
    """Spec tree matching ``params`` (every tensor leaf, operand dict fields
    included, by its '/'-joined path)."""
    sizes = axis_sizes_of(mesh)
    return tree.map_with_path(
        lambda path, leaf: _resolve(_path_name(path), tuple(leaf.shape), sizes,
                                    fsdp=fsdp, fsdp_min=fsdp_min),
        params)


# ---------------------------------------------------------------------------
# Activation / batch specs
# ---------------------------------------------------------------------------

def batch_axes(mesh) -> tuple[str, ...]:
    """Axes used for data parallelism (pod folds into data)."""
    names = tuple(axis_sizes_of(mesh))
    return tuple(a for a in ("pod", "data") if a in names)


def data_spec(mesh, batch: int, ndim: int) -> Spec:
    """Spec for a (B, ...) input: batch over pod+data when divisible."""
    sizes = axis_sizes_of(mesh)
    axes = batch_axes(sizes)
    size = math.prod(sizes[a] for a in axes)
    if batch % size == 0:
        return (axes, *(None,) * (ndim - 1))
    return (None,) * ndim


def cache_pspec(mesh, shape: tuple[int, ...], axis_sizes: dict[str, int]) -> Spec:
    """Heuristic KV/state-cache spec.

    Preference order: batch dim over pod+data; a heads-like dim over model;
    for unsharded-batch long-context caches, the sequence dim over data.
    """
    axes = batch_axes(mesh)
    dp = math.prod(axis_sizes[a] for a in axes)
    spec: list = [None] * len(shape)
    bdim = 1 if len(shape) >= 3 else 0
    sharded_batch = False
    if shape[bdim] % dp == 0:
        spec[bdim] = axes if len(axes) > 1 else axes[0]
        sharded_batch = True
    m = axis_sizes.get("model", 1)
    order = sorted(range(bdim + 1, len(shape)), key=lambda i: -shape[i])
    for i in order:
        if spec[i] is None and shape[i] % m == 0:
            spec[i] = "model"
            break
    if not sharded_batch:
        d = axis_sizes.get("data", 1)
        for i in order:
            if spec[i] is None and shape[i] % d == 0:
                spec[i] = "data"
                break
    return tuple(spec)
