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
flat vector of ``S * rows`` slots plus the int32 slot -> source permutation
(the SWS argsort, ``kernels.sws_sort``: CUB's radix sort on CUDA); the
achieved weights are scattered back through it, so index matching is
exact.  Quantizing, packing and dequantizing run over chunks of slots, so a
tensor costs ~16 bytes a weight in flight beyond its ``w_hat`` (the sort's
buffers) whatever its size.
A stacked segment tensor (leading layer axis) is planned as ONE tensor,
exactly as the reference does.

``section_order="tsp"`` reorders the magnitude-sorted sections by the
nearest-neighbour walk of ``sws.tsp_greedy_order`` (the reference's
beyond-paper option).  ``include_initial=False`` leaves each chain's first
program from the pristine crossbar out of every transition count and
lockstep time, as the reference's stateless path does; ``w_hat`` does not
depend on it.  A pool prices physical seam programs, so with ``pool=`` (or a
non-raw codec, which the reference also routes through a pool) it is a
``ValueError``, as in the reference.

``impl="bool"`` is the reference's eager parity oracle: bool planes
``[S, rows, cols]``, the SWS permutation from ``torch.argsort(stable=True)``,
per-chain loops of XOR sums (``schedule.schedule_job_costs_looped``), the
step-by-step stucking walk (``stucking.walk_bool``, the packed walk's
masks) and ``bitslice.dequantize_from_planes``: plain torch on the tensor's
device, no kernel, no chunking.  Like the packed path it is programmed
through a pool, with ``program(impl="bool")``: an ephemeral pristine one
without ``pool=`` gives the reference's stateless ``_analyze_tensor_bool``
accounting.  Its reports and ``w_hat`` bytes equal the packed path's.  A non-raw codec needs ``impl="packed"`` (``ValueError``,
as in the reference: the codecs encode packed words).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import prng, tree
from repro_torch.core import bitslice, planes, schedule, sws
from repro_torch.core.pool import CrossbarPool
from repro_torch.kernels._util import resolve_device
from repro_torch.kernels.sws_sort import ops as sort_ops
from repro_torch.kernels.sws_sort import ref as sort_ref


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
    section_order: str = "magnitude"  # "magnitude" | "tsp" (beyond-paper)
    min_size: int = 4096
    min_ndim: int = 2
    exclude: tuple[str, ...] = ("embed", "embedding", "lm_head", "pos_emb")
    seed: int = 0
    impl: str = "packed"  # "packed" (the fast path) | "bool" (the eager parity oracle)
    # chain -> crossbar leveling when streaming through a CrossbarPool:
    # "none" | "rotate" | "lpt" | "fault"; None defers to the pool's own setting
    pool_leveling: str | None = None
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


SECTION_ORDERS = ("magnitude", "tsp")
IMPLS = ("packed", "bool")


def _check_supported(config: PlannerConfig, pool: CrossbarPool | None = None) -> None:
    if config.codec not in planes.CODECS:
        raise ValueError(f"unknown plane codec {config.codec!r}; choose from {planes.CODECS}")
    if config.impl not in IMPLS:
        raise ValueError(f"unknown planner impl: {config.impl!r}")
    if config.section_order not in SECTION_ORDERS:
        raise ValueError(
            f"unknown section_order {config.section_order!r}; choose from {SECTION_ORDERS}"
        )
    if not config.include_initial and (pool is not None or config.codec != "raw"):
        raise ValueError(
            "pool streaming (and a non-raw codec, which is priced through a "
            "pool) prices physical seam programs; include_initial=False has "
            "no pool interpretation"
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
    """Per-tensor prep: chains, baseline job costs, SWS planes and signs,
    and the slot -> source permutation (slots past ``n`` hold the zero
    padding of the last section)."""

    n: int  # logical weights
    chains: list[np.ndarray]
    jobs_u: np.ndarray  # baseline job costs (unsorted, full reprogramming)
    packed_s: torch.Tensor  # SWS-ordered packed planes uint8[S, W, cols]
    sign_slots: torch.Tensor  # int8[S, rows]
    scale: torch.Tensor
    offset: torch.Tensor
    perm: torch.Tensor  # int32[S * rows]


# Weights a chunked pass of the planner handles at once: bounds the f32,
# int32 and int64 temporaries of quantizing, packing and dequantizing, so a
# tensor's bytes in flight are its permutation, planes and signs plus the
# sort's buffers (``kernels/sws_sort``), whatever its size.
_CHUNK = 1 << 24


def _slot_chunks(n_total: int, rows: int):
    """[a, b) slot ranges of whole sections, about ``_CHUNK`` slots each."""
    step = max(rows, _CHUNK // rows * rows)
    for a in range(0, n_total, step):
        yield a, min(a + step, n_total)


def _sort_key(flat_padded: torch.Tensor, encoding: str) -> torch.Tensor:
    """The SWS sort key: sign_magnitude stores |w|, so it sorts by |w|;
    offset_binary stores w - min, so it sorts by value.  ``+ 0.0`` turns
    -0.0 into +0.0 (and changes no other value), so the two zeros tie on
    every sort route, as they do in the reference's float sort."""
    return sort_ref.sort_key(flat_padded, encoding)


def _perm_full_with_inverse(
    flat_padded: torch.Tensor, spec: CrossbarSpec, config: PlannerConfig, q_padded: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Slot -> source permutation of the padded vector (SWS order by
    :func:`_sort_key`, the zero padding sorting with the zeros; then the TSP
    section walk if asked), int64, and its inverse; the identity without
    SWS.  ``core/redeploy.py``'s pricing; :func:`_prep` keeps the same
    permutation in int32 with no inverse."""
    rows, cols = spec.rows, spec.cols
    if not config.sws:
        ar = torch.arange(flat_padded.shape[0], device=flat_padded.device)
        return ar, ar
    n_total = flat_padded.shape[0]
    perm = sort_ops.sws_argsort(flat_padded, n_total, spec.encoding).to(torch.int64)
    inv_perm = sws.inverse_permutation(perm)
    if config.section_order == "tsp":
        order = sws.tsp_greedy_order(bitslice.section_planes_packed(q_padded[perm], rows, cols))
        slot = order[:, None] * rows + torch.arange(rows, device=order.device)
        perm = perm[slot.reshape(-1)]
        inv_perm = sws.inverse_permutation(perm)
    return perm, inv_perm


def _section_slots(flat: torch.Tensor, src: torch.Tensor, spec: CrossbarSpec,
                   scale: torch.Tensor, offset: torch.Tensor):
    """Packed planes uint8[s, W, cols] and signs int8[s, rows] of the slots
    whose sources are ``src`` (int64, whole sections; a source >= n is zero
    padding: q 0, sign +1)."""
    n = flat.shape[0]
    pad = src >= n
    q, sign = bitslice.quantize_values(flat[src.clamp(max=n - 1)], scale, offset, spec.cols,
                                       spec.encoding)
    q, sign = q.masked_fill(pad, 0), sign.masked_fill(pad, 1)
    return bitslice.section_planes_packed(q, spec.rows, spec.cols), sign.reshape(-1, spec.rows)


def _prep(w: torch.Tensor, spec: CrossbarSpec, config: PlannerConfig) -> _Prep:
    """Quantize, price the unsorted baseline, sort (SWS) and pack.

    Works through the slots in chunks of whole sections, so no full-size
    copy of ``w``, of its magnitudes, signs or keys, and no int64
    permutation or inverse is ever held: in flight are the int32
    permutation, the packed planes and signs, and the sort's own buffers.
    """
    rows, cols = spec.rows, spec.cols
    flat = w.reshape(-1).to(torch.float32)  # a view of a float32 ``w``
    n = flat.shape[0]
    n_total = n + (-n) % rows
    s = n_total // rows
    l = max(1, min(config.crossbars, s))
    chains = schedule.make_chains(s, l, config.schedule)
    scale, offset = bitslice.quant_params(flat, cols, spec.encoding)
    dev = flat.device
    words = -(-rows // 8)

    # baseline: unsorted natural order, full reprogramming
    packed_u = torch.empty((s, words, cols), dtype=torch.uint8, device=dev)
    for a, b in _slot_chunks(n_total, rows):
        src = torch.arange(a, b, device=dev)
        packed_u[a // rows:b // rows] = _section_slots(flat, src, spec, scale, offset)[0]
    jobs_u = schedule.schedule_job_costs(packed_u, chains, include_initial=config.include_initial)
    del packed_u

    if config.sws:
        perm = sort_ops.sws_argsort(flat, n_total, spec.encoding)
    else:
        perm = torch.arange(n_total, dtype=torch.int32, device=dev)
    packed_s = torch.empty((s, words, cols), dtype=torch.uint8, device=dev)
    sign_slots = torch.empty((s, rows), dtype=torch.int8, device=dev)
    for a, b in _slot_chunks(n_total, rows):
        packed_s[a // rows:b // rows], sign_slots[a // rows:b // rows] = _section_slots(
            flat, perm[a:b].to(torch.int64), spec, scale, offset)
    if config.sws and config.section_order == "tsp":
        order = sws.tsp_greedy_order(packed_s)
        slot = order[:, None] * rows + torch.arange(rows, device=dev)
        perm, packed_s, sign_slots = perm[slot.reshape(-1)], packed_s[order], sign_slots[order]
    return _Prep(n=n, chains=chains, jobs_u=jobs_u.cpu().numpy(), packed_s=packed_s,
                 sign_slots=sign_slots, scale=scale, offset=offset, perm=perm)


def _quant_mse(w: torch.Tensor, w_hat: torch.Tensor) -> float:
    """||w - w_hat||^2 / n, summed in chunks in float64 (no full-size
    temporary); the reference's float32 mean differs in the last bits."""
    a, b = w.reshape(-1), w_hat.reshape(-1)
    n = a.shape[0]
    total = torch.zeros((), dtype=torch.float64, device=a.device)
    for i in range(0, n, _CHUNK):
        d = a[i:i + _CHUNK].to(torch.float32) - b[i:i + _CHUNK].to(torch.float32)
        total += torch.sum((d * d).to(torch.float64))
    return float(total) / n if n else float("nan")


def _report(
    name: str, w: torch.Tensor, spec: CrossbarSpec, config: PlannerConfig, prep: _Prep,
    jobs_s: np.ndarray, trans_final: int, w_hat_flat: torch.Tensor,
) -> TensorReport:
    """TensorReport from host job costs (int64 aggregation: whole-tensor
    totals can exceed int32)."""
    n = prep.n
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
        quant_mse=_quant_mse(w, w_hat_flat),
        scale=float(prep.scale),
        offset=float(prep.offset),
    )


def w_hat_from_slots(achieved: torch.Tensor, sign_slots: torch.Tensor, scale: torch.Tensor,
                     offset: torch.Tensor, perm: torch.Tensor, n: int, rows: int) -> torch.Tensor:
    """Achieved packed planes uint8[S, W, cols] -> the achieved weights
    f32[n] in logical order: each chunk of slots dequantized
    (:func:`_dequant_slots`) and scattered to its sources through ``perm``
    (slot -> source), the inverse permutation's gather without its
    full-size int64 array.  The padding slots land past ``n``."""
    out = torch.empty((perm.shape[0],), dtype=torch.float32, device=achieved.device)
    for a, b in _slot_chunks(perm.shape[0], rows):
        sa, sb = a // rows, b // rows
        vals = _dequant_slots(achieved[sa:sb], sign_slots[sa:sb], scale, offset, rows)
        out[perm[a:b].to(torch.int64)] = vals.reshape(-1)
    return out[:n]


def _w_hat(achieved: torch.Tensor, prep: _Prep, w: torch.Tensor, rows: int):
    """Achieved packed planes -> (w_hat_flat f32[n], w_hat in w's layout and
    dtype: the same storage for a float32 ``w``)."""
    flat = w_hat_from_slots(achieved, prep.sign_slots, prep.scale, prep.offset, prep.perm,
                            prep.n, rows)
    return flat, flat.reshape(w.shape).to(w.dtype)


def _perm_full_bool(flat_padded: torch.Tensor, spec: CrossbarSpec, config: PlannerConfig,
                    q_padded: torch.Tensor) -> torch.Tensor:
    """The bool oracle's slot -> source permutation (int64): a stable
    ``torch.argsort`` of the SWS keys, then the TSP section walk if asked;
    the identity without SWS.  Stable, so it is the permutation of the
    packed path's sort."""
    if not config.sws:
        return torch.arange(flat_padded.shape[0], device=flat_padded.device)
    perm = torch.argsort(_sort_key(flat_padded, spec.encoding), stable=True)
    if config.section_order == "tsp":
        order = sws.tsp_greedy_order(
            bitslice.section_planes_packed(q_padded[perm], spec.rows, spec.cols))
        slot = order[:, None] * spec.rows + torch.arange(spec.rows, device=order.device)
        perm = perm[slot.reshape(-1)]
    return perm


def _prep_bool(w: torch.Tensor, spec: CrossbarSpec, config: PlannerConfig) -> _Prep:
    """The bool oracle's prep (the reference's ``_prep_bool``): quantize
    the whole tensor, pad, price the unsorted baseline on bool planes by the
    per-chain loop, sort, and pack the sorted bool planes."""
    rows, cols = spec.rows, spec.cols
    flat = w.reshape(-1).to(torch.float32)
    n = flat.shape[0]
    pad = (-n) % rows
    s = (n + pad) // rows
    chains = schedule.make_chains(s, max(1, min(config.crossbars, s)), config.schedule)
    qt = bitslice.quantize(flat, cols, spec.encoding)
    q_padded = F.pad(qt.q, (0, pad))
    sign_padded = F.pad(qt.sign, (0, pad), value=1)
    planes_u = bitslice.bitplanes(q_padded.reshape(s, rows), cols)
    jobs_u = schedule.schedule_job_costs_looped(planes_u, chains,
                                                include_initial=config.include_initial)
    perm = _perm_full_bool(F.pad(flat, (0, pad)), spec, config, q_padded)
    planes_s = bitslice.bitplanes(q_padded[perm].reshape(s, rows), cols)
    return _Prep(n=n, chains=chains, jobs_u=jobs_u.cpu().numpy(),
                 packed_s=bitslice.pack_rows(planes_s),
                 sign_slots=sign_padded[perm].reshape(s, rows), scale=qt.scale,
                 offset=qt.offset, perm=perm.to(torch.int32))


def _w_hat_bool(achieved: torch.Tensor, prep: _Prep, w: torch.Tensor):
    """Achieved bool planes [S, rows, cols] -> (w_hat_flat f32[n], w_hat in
    w's layout and dtype): ``bitslice.dequantize_from_planes``, then one
    scatter through the permutation."""
    slots = bitslice.dequantize_from_planes(achieved, prep.sign_slots, prep.scale, prep.offset)
    logical = torch.zeros((prep.perm.shape[0],), dtype=torch.float32, device=achieved.device)
    logical[prep.perm.to(torch.int64)] = slots.reshape(-1)
    flat = logical[:prep.n]
    return flat, flat.reshape(w.shape).to(w.dtype)


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

    ``config.impl="bool"`` runs the reference's eager oracle instead (see
    the module docstring); raw codec only.
    """
    _check_supported(config, pool)
    bool_impl = config.impl == "bool"
    if bool_impl and config.codec != "raw":
        raise ValueError("plane codecs require impl='packed' (bool is the raw parity oracle)")
    if pool is None:
        pool = CrossbarPool(spec, max(1, config.crossbars), device=w.device)
    if (spec.rows, spec.cols) != (pool.spec.rows, pool.spec.cols):
        raise ValueError(f"planner spec {spec} != pool spec {pool.spec}")
    prep = _prep_bool(w, spec, config) if bool_impl else _prep(w, spec, config)
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
        leveling=config.pool_leveling,
        impl=config.impl,
        name=name,
    )
    achieved = res.achieved_read
    if pset is not None:
        achieved = planes.logical_from_physical(achieved, pset.col_order)
    if bool_impl:
        w_hat_flat, w_hat = _w_hat_bool(bitslice.unpack_rows(achieved, spec.rows), prep, w)
    else:
        w_hat_flat, w_hat = _w_hat(achieved, prep, w, spec.rows)
    if pool.integrity is not None:
        # the reconstruction closure integrity.rebuild dequantizes repaired
        # planes with, into the same w_hat bytes
        pool.integrity.attach_aux(name, {
            "sign_slots": prep.sign_slots, "scale": prep.scale, "offset": prep.offset,
            "perm": prep.perm, "n": prep.n, "shape": tuple(w.shape), "dtype": w.dtype,
        })
    jobs_s, trans_final = res.job_costs, res.transitions_programmed
    if not config.include_initial:
        # the pristine pool's seams are the initial programs: drop them
        seams = np.cumsum([0] + [len(c) for c in prep.chains[:-1]])
        jobs_s = np.delete(jobs_s, seams)
        trans_final -= int(res.programmed_job_costs[seams].sum())
    report = _report(name, w, spec, config, prep, jobs_s, trans_final, w_hat_flat)
    return report, w_hat


def iter_weights(params: Any, config: PlannerConfig):
    """Yield (name, tensor) for every crossbar-eligible weight in a params tree."""
    pat = (
        re.compile("|".join(re.escape(p) for p in config.exclude)) if config.exclude else None
    )
    for path, leaf in tree.leaves_with_path(params):
        name = tree.path_name(path)
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
# under "packed" and "planes_int8" (still the achieved crossbar weights).
# Matched against '/'-separated name components.  The norm gains "g": at
# full width min_size admits the stacked gains, which rmsnorm multiplies
# elementwise (ROADMAP C.4); MLA's "wk_b" / "wv_b", which the absorbed
# decode reshapes per head (models/mla.py); Mamba's "conv" taps (a
# depthwise conv), "a_log" (elementwise exp) and hymba's "meta" tokens
# (concatenated), as in the reference; and Mamba's "dt_bias" and "d_skip",
# 1-D a layer but [count, d_inner] once a segment is stacked, so min_size
# admits them too, and the reference then serves them as operand dicts
# (ROADMAP C.12); and the sLSTM's recurrent kernel "r" [H, dh, 4 dh]
# (a per-head einsum), as in the reference.  Other families' non-matmul
# parameters join this list with their blocks.
MATERIALIZE_DENSE_ONLY = ("g", "wk_b", "wv_b", "conv", "a_log", "meta", "dt_bias", "d_skip",
                          "r")


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

    return tree.map_with_path(lambda path, leaf: swap(tree.path_name(path), leaf), params)
