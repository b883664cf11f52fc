"""Deployment planner: DNN params -> crossbar programming plan + cost report.

Port of the packed path of ``repro.core.planner``.  ``build_deployment``
quantizes and bit-slices every eligible weight, sorts it with Sorted Weight
Sectioning, schedules the sections into chains on ``crossbars`` parallel
crossbars, prices the reprogramming against the unsorted baseline, applies
bit stucking, and returns both the metrics and the achieved (error-injected)
weights ``w_hat``.  Every tensor is programmed through a
``core.pool.CrossbarPool``: with ``pool=`` one persistent pool for the whole
model (cross-tensor seams, per-cell wear), otherwise an ephemeral pristine
pool per tensor, which reproduces the reference's stateless accounting
exactly.  A non-raw plane codec (``core.planes``) changes the bits the
crossbars hold, and the pool prices and wears those.

Per tensor the work is plain tensor code on the tensor's device; pair
pricing goes through ``kernels.hamming.ops.price_pairs`` (the Hamming kernel
on CUDA, its plain version on the CPU).  A tensor is handled as a padded
flat vector of ``S * rows`` slots plus the slot -> source permutation; the
achieved weights come back through its inverse, so index matching is exact.
A stacked segment tensor (leading layer axis) is planned as ONE tensor,
exactly as the reference does.

Parts of the reference that later slices port raise ``NotImplementedError``:
the ``impl="bool"`` oracle and the ``section_order="tsp"`` reorder.  A pool
prices physical seam programs, so ``include_initial=False`` (which only the
reference's stateless path reads) is a ``ValueError``.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Iterator

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.core import bitslice, planes, schedule, sws
from repro_torch.core.pool import CrossbarPool
from repro_torch.kernels._util import resolve_device


@dataclasses.dataclass(frozen=True)
class CrossbarSpec:
    """Geometry + encoding of the physical crossbars (paper default 128x10)."""

    rows: int = 128
    cols: int = 10
    encoding: str = "sign_magnitude"


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    sws: bool = True
    schedule: str = "stride1"  # "stride1" | "strideL"
    crossbars: int = 16  # L physical crossbars programmed in parallel
    threads: int = 64  # T lockstep programming engines (Fig. 7)
    p_stuck: float = 1.0  # 1.0 = full reprogramming (no stucking)
    stuck_cols: int = 1
    include_initial: bool = True
    min_size: int = 4096
    min_ndim: int = 2
    exclude: tuple[str, ...] = ("embed", "embedding", "lm_head", "pos_emb")
    seed: int = 0
    impl: str = "packed"  # "bool" (the reference's eager oracle) is not ported
    # stored-plane codec (core/planes.py): "raw" | "const_rle" | "col_perm" |
    # "col_perm_rle"; non-raw codecs change the physical bits (and priced
    # transitions), while the deployed w_hat decodes back byte-identically
    codec: str = "raw"


@dataclasses.dataclass
class TensorReport:
    name: str
    shape: tuple[int, ...]
    n_weights: int
    n_sections: int
    transitions_baseline: int  # unsorted order, full reprogramming
    transitions_sws: int  # SWS order, full reprogramming
    transitions_final: int  # SWS order + bit stucking at p
    lockstep_time_unsorted: int
    lockstep_time_greedy: int
    lockstep_time_ideal: float
    quant_mse: float  # ||w - w_hat||^2 / n  (quantization + stucking error)
    scale: float = 0.0
    offset: float = 0.0

    @property
    def sws_speedup(self) -> float:
        return self.transitions_baseline / max(self.transitions_sws, 1)

    @property
    def total_speedup(self) -> float:
        return self.transitions_baseline / max(self.transitions_final, 1)


@dataclasses.dataclass
class DeploymentPlan:
    spec: CrossbarSpec
    config: PlannerConfig
    reports: dict[str, TensorReport]
    deployed: dict[str, torch.Tensor]  # name -> achieved weights (w_hat)
    pool_stats: dict | None = None  # wear summary when built against a CrossbarPool

    def totals(self) -> dict[str, float]:
        base = sum(r.transitions_baseline for r in self.reports.values())
        sws_t = sum(r.transitions_sws for r in self.reports.values())
        fin = sum(r.transitions_final for r in self.reports.values())
        lk_u = sum(r.lockstep_time_unsorted for r in self.reports.values())
        lk_g = sum(r.lockstep_time_greedy for r in self.reports.values())
        lk_i = sum(r.lockstep_time_ideal for r in self.reports.values())
        return {
            "transitions_baseline": base,
            "transitions_sws": sws_t,
            "transitions_final": fin,
            "sws_speedup": base / max(sws_t, 1),
            "total_speedup": base / max(fin, 1),
            "lockstep_speedup_unsorted": base / lk_u if lk_u else float("nan"),
            "lockstep_speedup_greedy": sws_t / lk_g if lk_g else float("nan"),
            "lockstep_time_ideal": lk_i,
        }


def _check_supported(config: PlannerConfig) -> None:
    if config.codec not in planes.CODECS:
        raise ValueError(f"unknown plane codec {config.codec!r}; choose from {planes.CODECS}")
    if config.impl == "bool":
        raise NotImplementedError(
            "impl='bool' is the JAX reference's parity oracle and is not ported; use 'packed'"
        )
    if config.impl != "packed":
        raise ValueError(f"unknown planner impl: {config.impl!r}")
    if not config.include_initial:
        raise ValueError(
            "every plan programs a crossbar pool, which prices physical seam "
            "programs; include_initial=False has no pool interpretation"
        )


def _dequant_slots(
    achieved_packed: torch.Tensor,
    sign_slots: torch.Tensor,
    scale: torch.Tensor,
    offset: torch.Tensor,
    rows: int,
) -> torch.Tensor:
    """Achieved packed planes uint8[S, W, cols] -> slot weights f32[S, rows].

    The magnitude is rebuilt one plane at a time (an exact integer), then
    ``q * scale * sign + offset`` as separate multiplies and one add — the
    reference's operation order; a fused multiply-add would change the last
    bit of ``w_hat``.
    """
    q = torch.zeros(sign_slots.shape, dtype=torch.int32, device=achieved_packed.device)
    for b in range(achieved_packed.shape[-1]):
        q |= bitslice.unpackbits(achieved_packed[..., b], 1, rows).to(torch.int32) << b
    return q.to(torch.float32) * scale * sign_slots.to(torch.float32) + offset


@dataclasses.dataclass
class _Prep:
    """Per-tensor prep: logical weights, chains, baseline and SWS planes."""

    flat: torch.Tensor  # f32[n] logical weights
    chains: list[np.ndarray]
    jobs_u: np.ndarray  # baseline job costs (unsorted, full reprogramming)
    packed_s: torch.Tensor  # SWS-ordered packed planes uint8[S, W, cols]
    sign_slots: torch.Tensor  # int8[S, rows]
    scale: torch.Tensor
    offset: torch.Tensor
    inv_perm: torch.Tensor


def _prep(w: torch.Tensor, spec: CrossbarSpec, config: PlannerConfig) -> _Prep:
    """Quantize, price the unsorted baseline, sort (SWS) and pack."""
    rows, cols = spec.rows, spec.cols
    flat = w.reshape(-1).to(torch.float32)
    n = flat.shape[0]
    pad = (-n) % rows
    flat_padded = F.pad(flat, (0, pad))
    s = (n + pad) // rows
    l = max(1, min(config.crossbars, s))
    chains = schedule.make_chains(s, l, config.schedule)

    qt = bitslice.quantize(flat, cols, spec.encoding)
    q_padded = F.pad(qt.q, (0, pad))
    sign_padded = F.pad(qt.sign, (0, pad), value=1)

    # baseline: unsorted natural order, full reprogramming
    jobs_u = schedule.schedule_job_costs(
        bitslice.section_planes_packed(q_padded, rows, cols), chains
    )

    # SWS order (|w| of the padded vector: padding sorts with the zeros)
    if config.sws:
        perm, inv_perm = sws.stable_argsort(flat_padded.abs(), with_inverse=True)
    else:
        perm = inv_perm = torch.arange(n + pad, device=flat.device)
    return _Prep(
        flat=flat,
        chains=chains,
        jobs_u=jobs_u.cpu().numpy(),
        packed_s=bitslice.section_planes_packed(q_padded[perm], rows, cols),
        sign_slots=sign_padded[perm].reshape(s, rows),
        scale=qt.scale,
        offset=qt.offset,
        inv_perm=inv_perm,
    )


def _report(
    name: str, w: torch.Tensor, spec: CrossbarSpec, config: PlannerConfig, prep: _Prep,
    jobs_s: np.ndarray, trans_final: int, w_hat_flat: torch.Tensor,
) -> TensorReport:
    """TensorReport from host job costs (int64 aggregation: whole-tensor
    totals can exceed int32)."""
    n = prep.flat.shape[0]
    trans_sws = int(np.sum(jobs_s, dtype=np.int64))
    return TensorReport(
        name=name,
        shape=tuple(w.shape),
        n_weights=int(n),
        n_sections=-(-int(n) // spec.rows),
        transitions_baseline=int(np.sum(prep.jobs_u, dtype=np.int64)),
        transitions_sws=trans_sws,
        transitions_final=trans_final,
        lockstep_time_unsorted=int(
            schedule.lockstep_time_host(prep.jobs_u, config.threads, sort_jobs=False)
        ),
        lockstep_time_greedy=int(
            schedule.lockstep_time_host(jobs_s, config.threads, sort_jobs=True)
        ),
        lockstep_time_ideal=float(trans_sws) / config.threads,
        quant_mse=float(torch.mean((prep.flat - w_hat_flat) ** 2)),
        scale=float(prep.scale),
        offset=float(prep.offset),
    )


def _w_hat(achieved: torch.Tensor, prep: _Prep, w: torch.Tensor, rows: int):
    """Achieved packed planes -> (w_hat_flat f32[n], w_hat in w's layout)."""
    w_hat_slots = _dequant_slots(achieved, prep.sign_slots, prep.scale, prep.offset, rows)
    w_hat_flat = w_hat_slots.reshape(-1)[prep.inv_perm][: prep.flat.shape[0]]
    return w_hat_flat, w_hat_flat.reshape(w.shape).to(w.dtype)


def analyze_tensor(
    w: torch.Tensor,
    spec: CrossbarSpec,
    config: PlannerConfig,
    key: torch.Tensor,
    name: str = "w",
    *,
    pool: CrossbarPool | None = None,
) -> tuple[TensorReport, torch.Tensor]:
    """Full paper pipeline for one weight tensor, on ``w``'s device.

    Returns (report, w_hat): w_hat carries the achieved (quantized +
    stuck-bit) values in the tensor's logical layout and dtype.

    The tensor is programmed through ``pool`` (persistent crossbar state:
    the first job of every chain is a cross-tensor seam, and the pool's
    leveling and wear counters apply), or through an ephemeral pristine pool
    when none is given, whose seams are the reference's stateless initial
    programs.  Under a codec the pool programs, prices and wears the stored
    bits (``PlaneSet.physical``) and logical planes are recovered after the
    read.
    """
    _check_supported(config)
    if pool is None:
        pool = CrossbarPool(spec, max(1, config.crossbars), device=w.device)
    if (spec.rows, spec.cols) != (pool.spec.rows, pool.spec.cols):
        raise ValueError(f"planner spec {spec} != pool spec {pool.spec}")
    prep = _prep(w, spec, config)
    pset = None
    if config.codec != "raw":
        # bit stucking under-programs the stored lowest-order columns: pin
        # them so the bounded LSB error stays an LSB error
        pin = config.stuck_cols if config.p_stuck < 1.0 else 0
        pset = planes.encode(prep.packed_s, config.codec, chains=prep.chains, pin_cols=pin)
    res = pool.program(
        pset if pset is not None else prep.packed_s,
        prep.chains,
        p_stuck=config.p_stuck,
        key=key,
        stuck_cols=config.stuck_cols,
        impl=config.impl,
        name=name,
    )
    achieved = res.achieved_read
    if pset is not None:
        achieved = planes.logical_from_physical(achieved, pset.col_order)
    w_hat_flat, w_hat = _w_hat(achieved, prep, w, spec.rows)
    report = _report(name, w, spec, config, prep, res.job_costs,
                     res.transitions_programmed, w_hat_flat)
    return report, w_hat


def _walk_leaves(tree: Any, prefix: tuple = ()) -> Iterator[tuple[str, Any]]:
    """(path name, leaf) in the reference's pytree order: dict keys sorted,
    lists in order; names join the path with '/' (e.g. segments/0/mlp/wo)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk_leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk_leaves(v, prefix + (str(i),))
    elif tree is not None:
        yield "/".join(prefix), tree


def _map_leaves(tree: Any, fn: Callable[[str, Any], Any], prefix: tuple = ()) -> Any:
    """Rebuild ``tree`` with ``fn(name, leaf)`` at every leaf."""
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, prefix + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn, prefix + (str(i),)) for i, v in enumerate(tree))
    return fn("/".join(prefix), tree)


def iter_weights(params: Any, config: PlannerConfig):
    """Yield (name, tensor) for every crossbar-eligible weight in a params tree."""
    pat = (
        re.compile("|".join(re.escape(p) for p in config.exclude)) if config.exclude else None
    )
    for name, leaf in _walk_leaves(params):
        if not isinstance(leaf, torch.Tensor):
            continue
        if leaf.ndim < config.min_ndim or leaf.numel() < config.min_size:
            continue
        if pat is not None and pat.search(name.lower()):
            continue
        yield name, leaf


def tensor_keys(params: Any, config: PlannerConfig) -> dict[str, torch.Tensor]:
    """The per-tensor PRNG key of every eligible weight: split the seed's key
    once per tensor in iteration order, as ``build_deployment`` does."""
    key = prng.PRNGKey(config.seed)
    keys = {}
    for name, _ in iter_weights(params, config):
        key, keys[name] = prng.split(key, 2)
    return keys


def build_deployment(
    params: Any,
    spec: CrossbarSpec = CrossbarSpec(),
    config: PlannerConfig = PlannerConfig(),
    *,
    progress: Callable[[str], None] | None = None,
    pool: CrossbarPool | None = None,
    device: str | torch.device | None = None,
) -> DeploymentPlan:
    """Plan crossbar deployment for every eligible weight in ``params``.

    Each tensor is planned on ``device`` (CUDA unless the caller asks for the
    CPU); the deployed ``w_hat`` stays there.  With ``pool`` (on the same
    device) the model's tensors stream through ONE persistent crossbar pool
    in iteration order: every tensor's chains reprogram whatever the
    previous tensor left on its crossbars, and the pool's wear counters
    accumulate the whole deployment.  Without one, each tensor is programmed
    through its own pristine pool.  The per-tensor PRNG split is the same
    with and without a pool.
    """
    _check_supported(config)
    dev = resolve_device(device)
    weights = dict(iter_weights(params, config))
    reports: dict[str, TensorReport] = {}
    deployed: dict[str, torch.Tensor] = {}
    for name, key in tensor_keys(params, config).items():
        if progress:
            progress(name)
        reports[name], deployed[name] = analyze_tensor(
            weights[name].to(dev), spec, config, key, name=name, pool=pool
        )
    return DeploymentPlan(
        spec=spec, config=config, reports=reports, deployed=deployed,
        pool_stats=pool.stats().to_dict() if pool is not None else None,
    )


MATERIALIZATIONS = ("dense", "packed", "planes_int8")

# Deployed tensors whose consumers are not plain [K, N] matmuls stay dense
# under "packed" (still the achieved crossbar weights).  Matched against
# '/'-separated name components.  On the ported decoder that is the norm
# gains "g": at full width min_size admits the stacked gains, which rmsnorm
# multiplies elementwise (ROADMAP C.4).  Other families' non-matmul
# parameters join this list with their blocks.
MATERIALIZE_DENSE_ONLY = ("g",)


def _dense_only(name: str) -> bool:
    parts = name.split("/")
    return any(p in parts for p in MATERIALIZE_DENSE_ONLY)


def deploy_params(
    params: Any,
    plan: DeploymentPlan,
    *,
    materialize: str = "dense",
    codec: str | None = None,
) -> Any:
    """Return a params tree with deployed tensors replaced by achieved state.

    ``"dense"`` serves the achieved f32 weights ``w_hat``; ``"packed"`` the
    bit-packed crossbar operand dicts and ``"planes_int8"`` the signed int8
    plane operand dicts (``simulator.operands_from_dense``), which
    ``models.layers.linear`` runs through ``simulator.cim_linear``.
    ``codec`` (default: the plan's) applies the serving-side plane codec to
    packed operands (``planes.encode_operands``); it is an exact
    re-encoding, so served tokens do not change.
    """
    if materialize not in MATERIALIZATIONS:
        raise ValueError(f"unknown materialize {materialize!r}; choose from {MATERIALIZATIONS}")
    codec = plan.config.codec if codec is None else codec
    if codec not in planes.CODECS:
        raise ValueError(f"unknown plane codec {codec!r}; choose from {planes.CODECS}")
    from repro_torch.core import simulator

    def swap(name, leaf):
        if name not in plan.deployed:
            return leaf
        w_hat = plan.deployed[name]
        if materialize == "dense" or _dense_only(name):
            return w_hat
        r = plan.reports[name]
        return simulator.operands_from_dense(
            w_hat, r.scale, r.offset, plan.spec.encoding, plan.spec.cols,
            materialize=materialize, codec=codec,
        )

    return _map_leaves(params, swap)
