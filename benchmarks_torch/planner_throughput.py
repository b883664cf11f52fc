"""Planner throughput on the port: the packed planner on the card vs the CPU.

Prices a gemma-2b-scale weight pytree end-to-end with ``build_deployment``
twice — on ``device`` (CUDA by default: B1 prices every schedule) and on the
CPU (B1's plain version) — requires the two plans to be identical (every
``TensorReport`` integer and the bytes of every deployed ``w_hat``) and
reports both walls, the plan's totals, its report integers and a digest
of each ``w_hat``.  The reference's copy compares its seed bool impl with
its packed impl; the port has only the packed planner, so its comparison is
card against CPU.

The weights are the reference's (``prng.normal`` draws what
``jax.random.normal`` draws), so the plan's integers equal the reference's
packed plan.  Tensor shapes are gemma-2b's per-layer matmuls, rows cut to
``max_elems`` weights per tensor.

  PYTHONPATH=src python -m benchmarks_torch.planner_throughput [--full] [--layers N] [--device cpu]

Writes experiments/bench_torch/BENCH_planner.json.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib

from benchmarks_torch.common import Timer, _lm_layer_shapes, banner, save_json, scaled_normal
from repro_torch import prng
from repro_torch.core.planner import CrossbarSpec, PlannerConfig, build_deployment
from repro_torch.kernels._util import resolve_device

ARCH = "gemma-2b"
SPEC = CrossbarSpec(rows=128, cols=10)
REPORT_FIELDS = (  # every integer of a TensorReport, and the float made from one
    "n_weights", "n_sections", "transitions_baseline", "transitions_sws",
    "transitions_final", "lockstep_time_unsorted", "lockstep_time_greedy",
    "lockstep_time_ideal",
)


def gemma_scale_params(
    *, max_elems: int = 750_000, layers: int | None = None, seed: int = 0, device=None
) -> dict:
    """Weight pytree with gemma-2b layer shapes (rows truncated to the cap)."""
    from repro_torch.configs import get_arch

    shapes = _lm_layer_shapes(ARCH)
    n_layers = layers if layers is not None else get_arch(ARCH).n_layers
    key = prng.PRNGKey(seed, device=resolve_device(device))
    params: dict = {}
    for i in range(n_layers):
        layer = {}
        for j, (d_out, d_in) in enumerate(shapes):
            rows = d_out if not max_elems else max(1, min(d_out, max_elems // d_in))
            key, sub = prng.split(key)
            layer[f"w{j}_{d_out}x{d_in}"] = scaled_normal(sub, (rows, d_in), d_in)
        params[f"layer_{i:02d}"] = layer
    return params


def report_ints(report) -> dict:
    """The fields of a TensorReport that two identical plans share exactly."""
    r = dataclasses.asdict(report)
    return {f: r[f] for f in REPORT_FIELDS}


def w_hat_digest(w) -> str:
    """sha256 of a deployed tensor's float32 bytes (row-major)."""
    return hashlib.sha256(w.cpu().numpy().tobytes()).hexdigest()


def same_plans(a, b) -> bool:
    """Equal tensor names, report integers and deployed w_hat bytes."""
    return set(a.reports) == set(b.reports) and all(
        report_ints(a.reports[k]) == report_ints(b.reports[k])
        and a.deployed[k].cpu().numpy().tobytes() == b.deployed[k].cpu().numpy().tobytes()
        for k in a.reports
    )


def plan(params: dict, p_stuck: float = 0.5, device=None):
    """The packed plan of ``params`` on ``device`` -> (plan, wall seconds)."""
    dev = resolve_device(device)
    cfg = PlannerConfig(p_stuck=p_stuck, min_size=1024)
    with Timer(dev) as t:
        out = build_deployment(params, SPEC, cfg, device=dev)
    return out, t.seconds


def plan_record(p) -> dict:
    """What the golden file holds of a plan: totals, report integers, w_hat digests."""
    return {
        "totals": p.totals(),
        "reports": {k: report_ints(r) for k, r in p.reports.items()},
        "w_hat_sha256": {k: w_hat_digest(w) for k, w in p.deployed.items()},
    }


def run(max_elems: int = 750_000, layers: int | None = 6, p_stuck: float = 0.5,
        device=None) -> dict:
    dev = resolve_device(device)
    params = gemma_scale_params(max_elems=max_elems, layers=layers, device=dev)
    n_elems = sum(int(w.numel()) for l in params.values() for w in l.values())
    plan_dev, t_dev = plan(params, p_stuck, dev)
    params_cpu = {n: {k: w.cpu() for k, w in l.items()} for n, l in params.items()}
    plan_cpu, t_cpu = plan(params_cpu, p_stuck, "cpu")
    return {
        "arch": ARCH,
        "device": str(dev),
        "layers": len(params),
        "n_tensors": len(plan_dev.reports),
        "n_elements": n_elems,
        "max_elems": max_elems,
        "p_stuck": p_stuck,
        "time_device_s": t_dev,
        "time_cpu_s": t_cpu,
        "speedup": t_cpu / max(t_dev, 1e-9),
        "bit_exact": same_plans(plan_dev, plan_cpu),
        **plan_record(plan_dev),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="all layers, 2M-element cap")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    layers = args.layers if args.layers is not None else (None if args.full else 6)
    max_elems = 2_000_000 if args.full else 750_000

    banner("Planner throughput — packed planner, card vs CPU")
    r = run(max_elems=max_elems, layers=layers, device=args.device)
    print(
        f"  {r['arch']} x{r['layers']} layers ({r['n_tensors']} tensors, "
        f"{r['n_elements']/1e6:.1f}M weights) on {r['device']}"
    )
    print(
        f"  {r['device']} {r['time_device_s']:.2f}s  cpu {r['time_cpu_s']:.2f}s  "
        f"-> {r['speedup']:.2f}x  bit_exact={r['bit_exact']}"
    )
    save_json("BENCH_planner", r)


if __name__ == "__main__":
    main()
