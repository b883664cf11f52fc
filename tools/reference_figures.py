#!/usr/bin/env python
"""Write the JAX reference's planner-figure integers for the port to match.

Runs the reference's own ``run`` functions (``benchmarks/fig5_sws_single.py``
through ``fig8_stucking.py``, the ``transitions_sweep`` halves of
``fig9_p_sweep.py`` and ``fig10_columns.py``) and its packed planner on
``benchmarks/planner_throughput.py``'s gemma-2b-scale weights, on the CPU,
and writes their integers and speedups, the caps, the seed and the jax
version to ``benchmarks_torch/golden/reference.json``.  The planner entry
also holds every tensor's report integers and a sha256 of each deployed
``w_hat``'s float32 bytes.

This tool imports ``jax``, ``repro`` and ``benchmarks`` on purpose: it is
not part of the port.  The port and ``chip_smoke.py`` only read the file.
It takes the record's layout (the planner's report fields, the sweep cap)
from ``benchmarks_torch``, which reads it.

  PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference_figures.py \\
      [--max-elems 2000000] [--planner-max-elems 750000] [--planner-layers 6]

The weights come from ``jax.random.normal`` on XLA:CPU; the port's
``prng.normal`` reproduces those draws bit for bit on an x86-64 host with
FMA (XLA's machine code there fuses the multiply-adds of ``log1p`` and
``erf_inv``).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

OUT = ROOT / "benchmarks_torch" / "golden" / "reference.json"


def planner_plan(max_elems: int, layers: int, p_stuck: float = 0.5) -> dict:
    """The reference's packed plan of planner_throughput's weights."""
    import numpy as np

    from benchmarks.planner_throughput import gemma_scale_params
    from benchmarks_torch.planner_throughput import REPORT_FIELDS
    from repro.core.planner import CrossbarSpec, PlannerConfig, build_deployment

    params = gemma_scale_params(max_elems=max_elems, layers=layers)
    plan = build_deployment(params, CrossbarSpec(rows=128, cols=10),
                            PlannerConfig(p_stuck=p_stuck, min_size=1024, impl="packed"))
    return {
        "max_elems": max_elems,
        "layers": layers,
        "p_stuck": p_stuck,
        "totals": plan.totals(),
        "reports": {k: {f: getattr(r, f) for f in REPORT_FIELDS}
                    for k, r in plan.reports.items()},
        "w_hat_sha256": {k: hashlib.sha256(np.asarray(w).tobytes()).hexdigest()
                         for k, w in plan.deployed.items()},
    }


def collect(max_elems: int, planner_max_elems: int, planner_layers: int, seed: int = 0) -> dict:
    import jax

    from benchmarks import (fig5_sws_single, fig6_strides, fig7_greedy, fig8_stucking,
                            fig9_p_sweep, fig10_columns)
    from benchmarks_torch.common import SWEEP_CAP

    out = {
        "jax_version": jax.__version__,
        "backend": jax.default_backend(),
        "seed": seed,
        "max_elems": max_elems,
        "sweep_max_elems": min(max_elems, SWEEP_CAP) if max_elems else 0,
        "seconds": {},
    }
    parts = {
        "fig5": lambda: fig5_sws_single.run(max_elems=max_elems, seed=seed),
        "fig6": lambda: fig6_strides.run(max_elems=max_elems, seed=seed),
        "fig7": lambda: fig7_greedy.run(max_elems=max_elems, seed=seed),
        "fig8": lambda: fig8_stucking.run(max_elems=max_elems, seed=seed),
        "fig9": lambda: fig9_p_sweep.transitions_sweep(max_elems=max_elems, seed=seed),
        "fig10": lambda: fig10_columns.transitions_sweep(max_elems=max_elems, seed=seed),
        "planner": lambda: planner_plan(planner_max_elems, planner_layers),
    }
    for name, fn in parts.items():
        t0 = time.perf_counter()
        out[name] = fn()
        out["seconds"][name] = time.perf_counter() - t0
        print(f"{name}: {out['seconds'][name]:.1f} s", flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-elems", type=int, default=2_000_000)
    ap.add_argument("--planner-max-elems", type=int, default=750_000)
    ap.add_argument("--planner-layers", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args()
    res = collect(args.max_elems, args.planner_max_elems, args.planner_layers, args.seed)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(res, indent=1) + "\n")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
