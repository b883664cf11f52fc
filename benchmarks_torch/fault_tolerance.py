"""Fault tolerance on the port: accuracy against the stuck-cell rate, with
and without fault-aware remapping, and the endurance horizon.

The port's copy of the engine-free parts of ``benchmarks/fault_tolerance.py``,
at its settings (reduced gemma-2b, p_stuck 0.5, min_size 1024, 128x10
crossbars):

  * **Fault curve** — deploy one checkpoint through a pool with twice the
    crossbars the plan needs and increasing per-cell stuck-at rates (a 25%
    hotspot population at 8x the rate, one fault map per rate from
    ``PRNGKey(42)``), and measure the shadow-batch logit KL against the fp
    model, once with ``leveling="none"`` and once with ``"fault"`` (chains
    steered to the crossbars whose stuck cells flip the fewest, lowest-order
    bits).  ``recovery_fraction`` is the share of the fault-induced KL that
    remapping removes at the reference rate.
  * **Endurance horizon** — successive checkpoints through one lpt-leveled
    pool, the exhaustion horizon after each.

The hot redeploy under load (an engine swapping checkpoints mid-trace) waits
for the engine (ROADMAP A.14).  Every integer here (stuck cells, hotspots,
each deployment's pool wear and deployed bytes, horizons, max writes)
equals the reference's, and the KLs taken in float64 agree within 5%
(``tests/test_torch_bench_faults.py`` and ``chip_smoke.py`` hold them to
``golden/reference.json``; ``common.logit_kl_f64`` says why float64).

  PYTHONPATH=src python -m benchmarks_torch.fault_tolerance [--quick] [--check] [--device cpu]

Writes experiments/bench_torch/BENCH_fault.json.  ``--check`` exits non-zero
when remapping recovers less than half the KL degradation at the reference
rate (the reference's gate).
"""
from __future__ import annotations

import argparse
import hashlib
import sys

import torch

from benchmarks_torch.common import Timer, banner, logit_kl_f64, save_json
from repro_torch import prng, tree
from repro_torch.configs import get_arch
from repro_torch.core import nonideal, simulator
from repro_torch.core.planner import CrossbarSpec, PlannerConfig, build_deployment, deploy_params
from repro_torch.core.pool import CrossbarPool
from repro_torch.kernels._util import resolve_device
from repro_torch.models import api

SPEC = CrossbarSpec(rows=128, cols=10)
FAULT_SEED = 42  # one fault map per rate, shared by the levelings
RATES = (0.0, 5e-4, 2e-3, 8e-3)
REF_RATE = 2e-3


def fault_model(rate: float) -> nonideal.FaultModel:
    """Stuck-at model at ``rate`` stuck cells a cell (half stuck at 0, half
    at 1), a 25% hotspot population at 8x the rate."""
    return nonideal.FaultModel(stuck0=rate / 2, stuck1=rate / 2, hotspot_fraction=0.25,
                               hotspot_mult=8.0)


def leaf_sha256(params) -> dict[str, str]:
    """sha256 of every leaf's float32 bytes, by '/'-joined name."""
    return {tree.path_name(p): hashlib.sha256(v.to(torch.float32).cpu().numpy().tobytes())
            .hexdigest() for p, v in tree.leaves_with_path(params)}


def deploy_through(params, pcfg: PlannerConfig, *, leveling: str, rate: float, device):
    """Deploy ``params`` through a fresh pool of twice the plan's crossbars
    with the rate's fault map injected -> (dense params_hat, pool)."""
    pool = CrossbarPool(SPEC, 2 * pcfg.crossbars, leveling=leveling, device=device)
    if rate > 0.0:
        pool.inject_faults(fault_model(rate), prng.PRNGKey(FAULT_SEED))
    plan = build_deployment(params, SPEC, pcfg, pool=pool, device=device)
    return deploy_params(params, plan, materialize="dense"), pool


def run_fault_curve(cfg, params, *, rates, pcfg, batch_size=2, shadow_len=16, seed=0,
                    device=None, deploys: list | None = None) -> list[dict]:
    """Shadow-batch logit KL (against the fp params, also in float64) per
    fault rate, for the naive and the fault-aware assignment; ``deploys`` collects each
    deployment's pool stats, wear per crossbar and deployed leaves' sha256."""
    dev = resolve_device(device)
    batch = api.make_batch(cfg, prng.PRNGKey(seed), batch_size, shadow_len, device=dev)
    f = lambda p, b: api.forward(p, cfg, b)[0]  # noqa: E731
    curve = []
    for rate in rates:
        row = {"rate": rate}
        for leveling in ("none", "fault"):
            params_hat, pool = deploy_through(params, pcfg, leveling=leveling, rate=rate,
                                              device=dev)
            row[f"kl_{leveling}"] = float(simulator.logit_kl(f, params, params_hat, batch))
            row[f"kl_{leveling}_f64"] = logit_kl_f64(f, params, params_hat, batch)
            if pool.faults is not None:
                row["stuck_cells"] = int(pool.faults.fault_cells().sum())
                row["hotspots"] = int(pool.faults.hot.sum())
            if deploys is not None:
                deploys.append({"rate": rate, "leveling": leveling, **pool.stats().to_dict(),
                                "wear_totals": pool.wear_totals().tolist(),
                                "leaf_sha256": leaf_sha256(params_hat)})
        curve.append(row)
        print(f"  rate {rate:7.4f}   kl none {row['kl_none']:.5f}   "
              f"kl fault-aware {row['kl_fault']:.5f}"
              + (f"   ({row.get('stuck_cells', 0)} stuck cells)" if rate else ""))
    return curve


def recovery_fraction(curve: list[dict], ref_rate: float) -> float:
    """Share of the fault-induced KL degradation (above the zero-fault
    quantization floor) that fault-aware remapping removes at ``ref_rate``."""
    floor = next(r["kl_none"] for r in curve if r["rate"] == 0.0)
    ref = next(r for r in curve if r["rate"] == ref_rate)
    degradation = ref["kl_none"] - floor
    if degradation <= 0:
        return 1.0  # nothing to recover
    return (ref["kl_none"] - ref["kl_fault"]) / degradation


def run_endurance(cfg, *, pcfg, n_deploys=3, endurance=1e4, seed=0, device=None) -> dict:
    """Successive checkpoints through one lpt pool: the exhaustion horizon
    after each."""
    dev = resolve_device(device)
    pool = CrossbarPool(SPEC, pcfg.crossbars, leveling="lpt", device=dev)
    horizons, max_writes = [], []
    for i in range(n_deploys):
        params_i = api.init(prng.PRNGKey(seed + i), cfg, device=dev)
        build_deployment(params_i, SPEC, pcfg, pool=pool, device=dev)
        stats = pool.stats()
        horizons.append(stats.exhaustion_horizon(endurance))
        max_writes.append(stats.max_cell_writes)
    return {"n_deploys": n_deploys, "endurance": endurance, "horizons": horizons,
            "max_cell_writes": max_writes}


def run(arch: str = "gemma-2b", *, reduced: bool = True, rates=RATES, ref_rate: float = REF_RATE,
        n_deploys: int = 3, seed: int = 0, device=None) -> dict:
    """Both experiments on ``device`` (CUDA unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    cfg = get_arch(arch, reduced=reduced)
    params = api.init(prng.PRNGKey(seed), cfg, device=dev)
    pcfg = PlannerConfig(p_stuck=0.5, min_size=1024)
    deploys: list = []
    with Timer(dev) as t_curve:
        curve = run_fault_curve(cfg, params, rates=rates, pcfg=pcfg, seed=seed, device=dev,
                                deploys=deploys)
    with Timer(dev) as t_end:
        endurance = run_endurance(cfg, pcfg=pcfg, n_deploys=n_deploys, seed=seed, device=dev)
    return {
        "arch": arch, "reduced": reduced, "seed": seed,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "spec": {"rows": SPEC.rows, "cols": SPEC.cols},
        "planner": {"p_stuck": pcfg.p_stuck, "min_size": pcfg.min_size,
                    "crossbars": pcfg.crossbars, "spare_factor": 2},
        "rates": list(rates), "ref_rate": ref_rate, "fault_curve": curve,
        "recovery_at_ref": recovery_fraction(curve, ref_rate), "deploys": deploys,
        "endurance": endurance,
        "seconds": {"fault_curve": t_curve.seconds, "endurance": t_end.seconds},
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--full-size", action="store_true", help="no --reduced config")
    ap.add_argument("--quick", action="store_true", help="rates 0 and 2e-3, 2 deployments")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero if remapping recovers < half the KL degradation")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    kw = dict(rates=(0.0, REF_RATE), n_deploys=2) if args.quick else {}

    banner("Fault curve — logit KL vs stuck-cell rate, naive vs fault-aware")
    res = run(args.arch, reduced=not args.full_size, device=args.device, **kw)
    print(f"  remapping recovers {100 * res['recovery_at_ref']:.1f}% of the KL degradation "
          f"at rate {res['ref_rate']} (2x spare capacity)")
    print("  horizon after each deploy: "
          + ", ".join(f"{h:.3g}" for h in res["endurance"]["horizons"])
          + f"  (@ {res['endurance']['endurance']:.0e} writes/cell)")
    save_json("BENCH_fault", res)
    if args.check and res["recovery_at_ref"] < 0.5:
        print(f"  CHECK FAILED: remapping recovered {100 * res['recovery_at_ref']:.1f}% "
              f"(gate: >= 50%)", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
