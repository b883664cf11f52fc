"""Dry run of the port: count one device's step of every (arch x shape x mesh) cell.

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
cell's step function under a 256- or 512-chip TPU mesh and reads XLA's
memory and cost analyses and the partitioned HLO.  The port has neither a
TPU mesh nor a compiler, so it runs one device's share of the step eagerly
on the host, on ``FakeTensorMode`` tensors (no data, no allocation, no
card), and counts it (``launch.step_cost``):

* the inputs are fake CPU tensors made by the port's own ``api.init`` /
  ``init_cache`` / ``adamw_init`` (a fake key draws nothing: ``prng``);
* one device holds the tensor-parallel shard the port's TP path gives it
  (``parallel.tp.plan_tp`` / ``local_config`` / ``shard_stack`` at n = the
  mesh's "model" size) and one data shard's rows (``global_batch / dp``
  where the rule table's ``data_spec`` splits the batch, else all of it);
  a component ``plan_tp`` replicates (every block kind but ``attn`` /
  ``swa``: moe, mla, the hybrid, the xLSTM and the encoder-decoder blocks)
  runs whole on every device, with the plan's reasons in the cell; where
  this layout and the rule table's ``param_specs`` differ, the cell lists
  the leaves and both per-device byte counts;
* the step's all-reduces meet a ``step_cost.CountingGate``; a train step
  adds the data-parallel gradient all-reduce over pod x data (the port's
  single-process ``make_train_step`` has none); ``--moe-sharded``
  registers the MoE mesh with a data axis of 1 over the local rows
  (``models.moe.set_moe_distribution``), so the capacity is one data
  shard's and the rows are not split twice;
* the roofline terms are the H100's (``launch.roofline``).

The counted program is the plain one (``counted_path: "plain"`` in every
cell): fake CPU tensors send ``kernels._util.use_kernel`` down every plain
version, so prefill attention is ``blockwise_attention`` (its float32 score
blocks materialised), every CIM matmul is its plain version, and f32 weights
are cast at each ``layers.linear`` call with no ``prepare_serving_params``.
The bounds therefore do not apply to a step that runs B2-B6 on the card.

The cells run side by side, one spawned process a core, each on one torch
thread.

One JSON a cell goes to ``experiments/dryrun_torch/``, with the reference's
keys where a counterpart exists; ``no_counterpart`` names the rest.
``lower_s`` is the seconds of the counted fake run of the step (the
counterpart of tracing it once); there is no compile.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import multiprocessing
import os
import time
import traceback
from pathlib import Path
from typing import Callable

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import prng, tree
from repro_torch.configs import SHAPES, get_arch, list_archs
from repro_torch.configs.base import ArchConfig, ShapeSpec, shape_applicable
from repro_torch.launch import step_cost
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.launch.roofline import Roofline, all_reduce_wire
from repro_torch.launch.steps import make_prefill_step, make_serve_step, make_train_step
from repro_torch.models import api, moe
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel import collective, tp
from repro_torch.parallel import sharding as shard_lib

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

# the reference's production meshes (``repro.launch.mesh.make_production_mesh``)
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}

COUNTED_PATH = "plain"  # the path every cell counts (module docstring)

NO_COUNTERPART = {
    "compile_s": "no compiler: the eager step runs op by op as traced",
    "cost_analysis_raw": "no XLA cost analysis; the counts are step_cost's",
    "hlo_structure": "no HLO (n_while, max_trip): every loop iteration runs eagerly and "
                     "is counted",
    "collectives.static_count": "no HLO text; collectives.count is the gates' calls",
}


def production_mesh(kind: str) -> Mesh:
    """The logical (16, 16) or (2, 16, 16) mesh of a mesh kind."""
    return make_mesh(*MESHES[kind])


# ---------------------------------------------------------------------------
# Input specs (fake tensors; no allocation)
# ---------------------------------------------------------------------------

def param_specs(cfg: ArchConfig, mode: FakeTensorMode):
    with mode:
        return api.init(prng.PRNGKey(0), cfg, device="cpu")


def batch_specs(cfg: ArchConfig, shape: ShapeSpec, mode: FakeTensorMode, rows: int | None = None):
    b, s = rows or shape.global_batch, shape.seq_len
    with mode:
        out = {"tokens": torch.empty((b, s), dtype=torch.int32)}
        if cfg.encdec:
            out["src_embeds"] = torch.empty((b, s, cfg.d_model), dtype=torch.float32)
        elif cfg.stub_prefix_len:
            out["prefix_embeds"] = torch.empty((b, cfg.stub_prefix_len, cfg.d_model),
                                               dtype=torch.float32)
    return out


def cache_specs(cfg: ArchConfig, shape: ShapeSpec, mode: FakeTensorMode, rows: int | None = None,
                shards: int = 0):
    with mode:
        return api.init_cache(cfg, rows or shape.global_batch, shape.seq_len, device="cpu",
                              shards=shards, src_len=shape.seq_len)


def _step_inputs(cfg, shape, mode, params, rows, cache_shards=0) -> dict:
    if shape.kind == "train":
        with mode:
            opt = adamw_init(params)
        return {"params": params, "opt_state": opt,
                "batch": batch_specs(cfg, shape, mode, rows)}
    if shape.kind == "prefill":
        return {"params": params, "batch": batch_specs(cfg, shape, mode, rows)}
    with mode:
        token = torch.empty((rows, 1), dtype=torch.int32)
        pos = torch.empty((), dtype=torch.int32)
    return {"params": params, "cache": cache_specs(cfg, shape, mode, rows, cache_shards),
            "token": token, "pos": pos}


def input_specs(cfg: ArchConfig, shape: ShapeSpec, mode: FakeTensorMode | None = None) -> dict:
    """All inputs of the cell's step function at global shapes, as fakes."""
    mode = mode or FakeTensorMode()
    return _step_inputs(cfg, shape, mode, param_specs(cfg, mode), shape.global_batch)


# ---------------------------------------------------------------------------
# One device's share
# ---------------------------------------------------------------------------

def device_rows(shape: ShapeSpec, mesh) -> int:
    """The rows one device runs: a data shard's where the rule table's
    ``data_spec`` splits the batch over pod x data, else all of them."""
    sizes = shard_lib.axis_sizes_of(mesh)
    dp = math.prod(sizes[a] for a in shard_lib.batch_axes(mesh))
    split = shard_lib.data_spec(mesh, shape.global_batch, 2)[0] is not None
    return shape.global_batch // dp if split else shape.global_batch


def layout_report(params, plan: tp.TPPlan, mesh, *, fsdp: bool = False) -> dict:
    """The TP plan's per-device parameter bytes beside the rule table's
    (``parallel.sharding.param_specs``), and every leaf they lay out
    differently: the count follows the TP plan."""
    specs = shard_lib.param_specs(params, mesh, fsdp=fsdp)
    tp_b = 0
    differ = []
    for path, leaf in tree.leaves_with_path(params):
        name, spec = tree.path_name(path), _at(specs, path)
        ax = tp._leaf_rule(name, plan) if (plan.attn or plan.mlp) else None
        tp_b += leaf.nbytes // (plan.n if ax is not None else 1)
        rule_ax = [i - len(spec) for i, a in enumerate(spec) if a is not None]
        tp_ax = [ax] if ax is not None else []
        if rule_ax != tp_ax or any(a not in (None, plan.axis) for a in spec):
            differ.append(f"{name}: rules {tuple(spec)}, tp "
                          f"{'axis ' + str(ax) if ax is not None else 'replicated'}")
    return {"param_bytes_tp": tp_b,
            "param_bytes_rules": per_device_param_bytes(params, mesh, fsdp=fsdp),
            "n_leaves": len(tree.leaves(params)), "differ": differ}


def _at(specs, path: tuple):
    """The entry of a ``param_specs`` tree at a leaf's path."""
    for k in path:
        specs = specs[k]
    return specs


def per_device_param_bytes(params, mesh, *, fsdp: bool = False) -> int:
    """One device's bytes of ``params`` under the rule table over ``mesh``."""
    sizes = shard_lib.axis_sizes_of(mesh)
    specs = shard_lib.param_specs(params, mesh, fsdp=fsdp)
    return sum(leaf.nbytes // math.prod(sizes[a] for a in _at(specs, path) if a is not None)
               for path, leaf in tree.leaves_with_path(params))


def cache_bytes_rules(cache, mesh) -> int:
    """One device's cache bytes under the rule table's ``cache_pspec``."""
    sizes = shard_lib.axis_sizes_of(mesh)

    def div(entry):
        axes = entry if isinstance(entry, tuple) else (entry,)
        return math.prod(sizes[a] for a in axes if a is not None)

    return sum(t.nbytes // math.prod(div(e) for e in shard_lib.cache_pspec(
        mesh, tuple(t.shape), sizes)) for t in tree.leaves(cache))


def device_inputs(cfg: ArchConfig, shape: ShapeSpec, mesh, mode: FakeTensorMode, *,
                  fsdp: bool = False, params=None) -> tuple[ArchConfig, tp.TPPlan, dict, dict]:
    """One device's step inputs: the TP plan's shard (shard 0) of ``params``
    (default: ``param_specs(cfg, mode)``) and one data shard's rows.
    Returns (local config, plan, inputs, layout report)."""
    n = shard_lib.axis_sizes_of(mesh)["model"]
    plan = tp.plan_tp(cfg, n)
    cfg_l = tp.local_config(cfg, plan)
    full = param_specs(cfg, mode) if params is None else params
    layout = layout_report(full, plan, mesh, fsdp=fsdp)
    with mode:
        params = tp.shard_stack(full, plan, [0])
    del full
    rows = device_rows(shape, mesh)
    inputs = _step_inputs(cfg_l, shape, mode, params, rows, tp.local_shards(plan, [0]))
    if shape.kind == "decode":
        glob = cache_specs(cfg, shape, mode)
        layout["cache_bytes_tp"] = step_cost.storage_bytes(tree.leaves(inputs["cache"]))
        layout["cache_bytes_rules"] = cache_bytes_rules(glob, mesh)
    return cfg_l, plan, inputs, layout


def step_args(cfg_l: ArchConfig, shape: ShapeSpec, inputs: dict, *, remat: str = "full"):
    """The cell's step function on the local config and its arguments."""
    if shape.kind == "train":
        return (make_train_step(cfg_l, AdamWConfig(), remat=remat),
                (inputs["params"], inputs["opt_state"], inputs["batch"]))
    if shape.kind == "prefill":
        return make_prefill_step(cfg_l), (inputs["params"], inputs["batch"])
    return (make_serve_step(cfg_l),
            (inputs["params"], inputs["cache"], inputs["token"], inputs["pos"]))


# ---------------------------------------------------------------------------
# Analytic model FLOPs (roofline denominator)
# ---------------------------------------------------------------------------

def model_flops(cfg: ArchConfig, shape: ShapeSpec, n_active: int, chips: int) -> float:
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    per_token = 6 * n_active if shape.kind == "train" else 2 * n_active
    return per_token * tokens / chips  # per-chip share


def active_params(cfg: ArchConfig, params=None) -> int:
    """Active params a token: every parameter but the rank-4 expert stacks'
    ``top_k / n_alloc`` share (padded experts are dead weights).  ``params``:
    ``cfg``'s fake params (default: made here)."""
    specs = param_specs(cfg, FakeTensorMode()) if params is None else params
    total = sum(leaf.numel() for leaf in tree.leaves(specs))
    if cfg.moe is None:
        return total
    routed = 0
    for path, leaf in tree.leaves_with_path(specs):
        names = [str(k) for k in path]
        if any(n in ("wi_gate", "wi_up") for n in names) and leaf.ndim == 4:
            routed += leaf.numel()
        if "wo" in names and leaf.ndim == 4:
            routed += leaf.numel()
    return total - routed + int(routed * cfg.moe.top_k / cfg.moe.n_alloc)


# ---------------------------------------------------------------------------
# Per-cell dry run
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DeviceStep:
    """One device's counted step of a cell."""

    cfg: ArchConfig  # the local config the device runs
    plan: tp.TPPlan
    inputs: dict  # fake tensors, keyed as input_specs
    fn: Callable  # the step function
    args: tuple  # its fake arguments
    layout: dict  # layout_report, and the cache's bytes for a decode step
    n_active: int
    init_s: float  # seconds to make the fake inputs
    cost: step_cost.StepCost
    gate: step_cost.CountingGate


def count_cell(cfg: ArchConfig, shape: ShapeSpec, mesh, *, remat: str = "full",
               fsdp: bool = False, moe_sharded: bool = False) -> DeviceStep:
    """Make one device's fake inputs of (``cfg``, ``shape``, ``mesh``) and
    count its step."""
    n = shard_lib.axis_sizes_of(mesh)["model"]
    gate = step_cost.CountingGate(n)
    mode = FakeTensorMode()
    t0 = time.perf_counter()
    full = param_specs(cfg, mode)
    n_active = active_params(cfg, full)
    cfg_l, plan, inputs, layout = device_inputs(cfg, shape, mesh, mode, fsdp=fsdp, params=full)
    del full
    init_s = time.perf_counter() - t0
    fn, args = step_args(cfg_l, shape, inputs, remat=remat)
    moe.set_moe_distribution(make_mesh((1, n), ("data", "model")) if moe_sharded else None)
    try:
        with mode, collective.active(gate):
            _, cost = step_cost.count_step(fn, *args)
    finally:
        moe.set_moe_distribution(None)
    return DeviceStep(cfg_l, plan, inputs, fn, args, layout, n_active, init_s, cost, gate)


def cell_fields(step: DeviceStep, cfg: ArchConfig, shape: ShapeSpec, mesh) -> dict:
    """A counted cell's record fields: the reference's keys where a
    counterpart exists, the device's share and the roofline terms."""
    sizes = shard_lib.axis_sizes_of(mesh)
    chips = math.prod(sizes.values())
    dp = math.prod(sizes[a] for a in shard_lib.batch_axes(mesh))
    cost, gate = step.cost, step.gate
    count = {"all-reduce": gate.count}
    wire = {"all-reduce": gate.wire}
    by_axis = {"model": gate.wire}
    if shape.kind == "train":  # the data-parallel gradient sum over pod x data
        grad_bytes = step_cost.storage_bytes(tree.leaves(step.inputs["params"]))
        dp_wire = all_reduce_wire(grad_bytes, dp)
        count["all-reduce"] += 1 if dp > 1 else 0
        wire["all-reduce"] += dp_wire
        by_axis["x".join(shard_lib.batch_axes(mesh))] = dp_wire
    roof = Roofline(flops=cost.flops, hbm_bytes=cost.bytes_accessed,
                    wire_bytes=sum(wire.values()),
                    model_flops=model_flops(cfg, shape, step.n_active, chips))
    if cost.peak_bytes is None:
        mem = {}
    else:
        mem = {"argument_bytes": cost.argument_bytes, "output_bytes": cost.output_bytes,
               "temp_bytes": max(cost.peak_bytes - cost.argument_bytes - cost.output_bytes, 0),
               "peak_bytes": cost.peak_bytes}
    kinds = sorted(set(cfg.layer_kinds()) | ({"encdec"} if cfg.encdec else set()))
    inputs, plan = step.inputs, step.plan
    out = dict(
        status="ok",
        counted_path=COUNTED_PATH,
        chips=chips,
        lower_s=round(cost.trace_s, 1),
        init_s=round(step.init_s, 1),
        n_active_params=step.n_active,
        memory_analysis=mem,
        collectives={"count": count, "wire_bytes": wire, "wire_by_axis": by_axis},
        device={"rows": inputs["batch"]["tokens"].shape[0] if "batch" in inputs
                else inputs["token"].shape[0],
                "data_shards": dp, "model_shards": sizes["model"],
                "tp": {"attn": plan.attn, "mlp": plan.mlp, "reasons": dict(plan.reasons),
                       "block_kinds": kinds},
                "layout": step.layout},
        no_counterpart=NO_COUNTERPART,
        roofline=roof.to_dict(),
    )
    if cost.memory_error:
        out["memory_error"] = cost.memory_error
    return out


def run_cell(
    arch: str,
    shape_name: str,
    mesh_kind: str,
    *,
    remat: str = "full",
    fsdp: bool = False,
    swa_banded: bool = False,
    moe_sharded: bool = False,
    out_dir: Path | None = None,
    variant: str = "",
    cfg: ArchConfig | None = None,
) -> dict:
    """Count one cell; ``cfg`` (default ``get_arch(arch)``) lets a caller
    cut the depth.  Returns the cell's record (written to ``out_dir``)."""
    if swa_banded:
        raise ValueError("--swa-banded has no counterpart: the port does not have "
                         "set_attention_impl (ROADMAP A.16.2, recorded departure)")
    cfg = cfg or get_arch(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    result: dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "remat": remat, "fsdp": fsdp, "variant": variant,
        "swa_banded": swa_banded, "moe_sharded": moe_sharded,
    }
    if not ok:
        result.update(status="skipped", reason=why)
        return _write(result, out_dir)
    mesh = production_mesh(mesh_kind)
    try:
        step = count_cell(cfg, shape, mesh, remat=remat, fsdp=fsdp, moe_sharded=moe_sharded)
    except Exception as e:  # noqa: BLE001  (a failing cell is a fault to list; keep sweeping)
        result.update(status="error", error=f"{type(e).__name__}: {e}",
                      trace=traceback.format_exc()[-4000:])
        return _write(result, out_dir)
    result.update(cell_fields(step, cfg, shape, mesh))
    return _write(result, out_dir)


def _write(result: dict, out_dir: Path | None) -> dict:
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        tag = f"{result['arch']}_{result['shape']}_{result['mesh']}" + (
            f"_{result['variant']}" if result["variant"] else "")
        (out_dir / f"{tag}.json").write_text(json.dumps(result, indent=1))
    return result


def iter_cells(mesh_kinds: list[str]):
    for arch in list_archs():
        for shape_name in SHAPES:
            for mk in mesh_kinds:
                yield arch, shape_name, mk


def _run_one(job: tuple) -> dict:
    """A worker's cell (one torch thread: the cells run side by side)."""
    torch.set_num_threads(1)
    (arch, shape_name, mk), kw = job
    return run_cell(arch, shape_name, mk, **kw)


def _line(r: dict) -> str:
    tag = f"{r['arch']:24s} {r['shape']:12s} {r['mesh']:6s}"
    if r["status"] == "ok":
        roof = r["roofline"]
        return (f"OK    {tag} trace={r['lower_s']:.0f}s flops={roof['flops']:.3g} "
                f"bytes={roof['hbm_bytes']:.3g} wire={roof['wire_bytes']:.3g} "
                f"bottleneck={roof['bottleneck']}")
    if r["status"] == "skipped":
        return f"SKIP  {tag} {r['reason']}"
    return f"ERROR {tag} {r['error']}"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--remat", default="full", choices=["none", "full", "dots"])
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--swa-banded", action="store_true")
    ap.add_argument("--moe-sharded", action="store_true")
    ap.add_argument("--variant", default="")
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args()

    out_dir = Path(args.out)
    mesh_kinds = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = list(iter_cells(mesh_kinds))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        cells = [(args.arch, args.shape, mk) for mk in mesh_kinds]
    kw = dict(remat=args.remat, fsdp=args.fsdp, swa_banded=args.swa_banded,
              moe_sharded=args.moe_sharded, out_dir=out_dir, variant=args.variant)

    t0 = time.perf_counter()
    # a recurrence (cfg.ssm) runs a Python loop over time or chunks: its cells
    # take longest, so they start first
    cells.sort(key=lambda c: get_arch(c[0]).ssm is None)
    ctx = multiprocessing.get_context("spawn")
    results = []
    with ctx.Pool(min(len(cells), os.cpu_count() or 1), maxtasksperchild=1) as pool:
        for r in pool.imap_unordered(_run_one, [(c, kw) for c in cells]):
            print(_line(r), flush=True)
            results.append(r)
    n = {s: sum(r["status"] == s for r in results) for s in ("ok", "skipped", "error")}
    print(f"sweep: {time.perf_counter() - t0:.1f} s on the host")
    print(f"done: {n['ok']} ok, {n['skipped']} skipped, {n['error']} errors")


if __name__ == "__main__":
    main()
