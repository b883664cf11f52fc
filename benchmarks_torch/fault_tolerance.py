"""Fault tolerance on the port: accuracy against the stuck-cell rate, with
and without fault-aware remapping, hot redeploy under load, and the
endurance horizon.

The port's copy of ``benchmarks/fault_tolerance.py``, at its settings
(reduced gemma-2b, p_stuck 0.5, min_size 1024, 128x10 crossbars):

  * **Fault curve** — deploy one checkpoint through a pool with twice the
    crossbars the plan needs and increasing per-cell stuck-at rates (a 25%
    hotspot population at 8x the rate, one fault map per rate from
    ``PRNGKey(42)``), and measure the shadow-batch logit KL against the fp
    model, once with ``leveling="none"`` and once with ``"fault"`` (chains
    steered to the crossbars whose stuck cells flip the fewest, lowest-order
    bits).  ``recovery_fraction`` is the share of the fault-induced KL that
    remapping removes at the reference rate.
  * **Hot redeploy under load** — an engine serves a trace from checkpoint
    A (crossbar-deployed); mid-trace checkpoint B is programmed into the
    same lpt pool's spare capacity and ``Engine.hot_swap``-ped in.
    Reported: the programming pause, that every request completed, and
    that every stream equals solo generation on its admission epoch's
    params.
  * **Endurance horizon** — successive checkpoints through one lpt-leveled
    pool, the exhaustion horizon after each.

Every integer here (stuck cells, hotspots, each deployment's pool wear and
deployed bytes, the redeploy's counters and horizons, max writes) equals
the reference's, and the KLs taken in float64 agree within 5%
(``tests/test_torch_bench_faults.py`` and ``chip_smoke.py`` hold them to
``golden/reference.json``; ``common.logit_kl_f64`` says why float64).

  PYTHONPATH=src python -m benchmarks_torch.fault_tolerance [--quick] [--check] [--device cpu]

Writes experiments/bench_torch/BENCH_fault.json.  ``--check`` exits non-zero
when remapping recovers less than half the KL degradation at the reference
rate, or the redeploy trace drops a request or breaks stream parity (the
reference's gates).
"""
from __future__ import annotations

import argparse
import hashlib
import sys
import time

import numpy as np
import torch

from benchmarks_torch.common import Timer, banner, logit_kl_f64, save_json
from repro_torch import prng, tree
from repro_torch.configs import get_arch
from repro_torch.core import nonideal, simulator
from repro_torch.core.planner import CrossbarSpec, PlannerConfig, build_deployment, deploy_params
from repro_torch.core.pool import CrossbarPool
from repro_torch.kernels._util import resolve_device
from repro_torch.launch.engine import Engine, EngineConfig, Request
from repro_torch.launch.serve import generate
from repro_torch.models import api
from repro_torch.runtime.fault import FaultPolicy

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


def solo(cfg, params, req: Request) -> list[int]:
    """One request generated alone (batch 1, its seed)."""
    tokens = torch.from_numpy(req.prompt.astype(np.int64))[None].to(params["embed"]["table"].device)
    toks, _ = generate(cfg, params, {"tokens": tokens}, gen_len=req.max_new_tokens,
                       greedy=req.greedy, seed=req.seed)
    return [int(t) for t in toks[0].cpu()]


REDEPLOY_ECFG = EngineConfig(max_slots=2, page_size=8, max_seq_len=64, prefill_chunk=8,
                             decode_quantum=4)


def run_hot_redeploy(cfg, params_a, params_b, *, pcfg, n_requests=6, seed=0,
                     device=None) -> dict:
    """Serve a trace from checkpoint A (crossbar-deployed); mid-trace,
    program checkpoint B into the same pool's spare capacity and hot-swap.
    Every request must complete with the stream of solo generation on its
    admission epoch's params: A for those admitted before the swap, B for
    the rest (``stream_parity``; the reference holds every request
    submitted before the swap to A and reports False, ROADMAP C.8)."""
    dev = resolve_device(device)
    pool = CrossbarPool(SPEC, 2 * pcfg.crossbars, leveling="lpt", device=dev)
    plan_a = build_deployment(params_a, SPEC, pcfg, pool=pool, device=dev)
    served_a = deploy_params(params_a, plan_a, materialize="dense")

    eng = Engine(cfg, served_a, REDEPLOY_ECFG)
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size, int(rng.integers(6, 14))).astype(np.int32),
                    max_new_tokens=int(rng.integers(4, 9)), greedy=True, seed=i)
            for i in range(n_requests)]
    pre, post = reqs[: n_requests // 2], reqs[n_requests // 2:]
    for r in pre:
        eng.submit(r)

    now, step_walls = 0.0, []
    while not any(s is not None and s.generated for s in eng.slots):
        t0 = time.perf_counter()
        eng.step(now)
        step_walls.append(time.perf_counter() - t0)
        now += 1e-3

    def prepare_b():
        """Program checkpoint B through the pool (spare capacity)."""
        plan_b = build_deployment(params_b, SPEC, pcfg, pool=pool, device=dev)
        return deploy_params(params_b, plan_b, materialize="dense")

    # requests admitted so far stay pinned to epoch A; the rest of ``pre``
    # is still queued and is admitted on epoch B (the reference checks every
    # request of ``pre`` against A: ROADMAP C.8)
    on_a = set(eng.results) | {s.req.rid for s in eng.slots if s is not None}
    horizon_before = pool.stats().exhaustion_horizon()
    t0 = time.perf_counter()
    swapped = eng.hot_swap(prepare_b, policy=FaultPolicy(max_retries=1))
    swap_pause = time.perf_counter() - t0
    horizon_after = pool.stats().exhaustion_horizon()
    served_b = eng.params  # the prepared tree the swap installed

    for r in post:
        eng.submit(r)
    while eng.waiting or any(s is not None for s in eng.slots):
        t0 = time.perf_counter()
        eng.step(now)
        step_walls.append(time.perf_counter() - t0)
        now += 1e-3

    parity = all(eng.results[r.rid].tokens == solo(cfg, served_a if r.rid in on_a else served_b, r)
                 for r in reqs)
    return {
        "n_requests": n_requests,
        "completed": len(eng.results),
        "swapped": bool(swapped),
        "admitted_before_swap": len(on_a),
        "stream_parity": bool(parity),
        "swap_pause_s": swap_pause,
        "median_step_s": float(np.median(step_walls)),
        "pause_vs_step": swap_pause / max(float(np.median(step_walls)), 1e-9),
        "hot_swaps": eng.stats["hot_swaps"],
        "epochs_retired": eng.stats["epochs_retired"],
        "horizon_before": horizon_before,
        "horizon_after": horizon_after,
    }


# the redeploy's numbers the golden file holds; ``stream_parity`` departs (C.8)
REDEPLOY_KEYS = ("n_requests", "completed", "swapped", "hot_swaps", "epochs_retired",
                 "horizon_before", "horizon_after")


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
        n_requests: int = 6, n_deploys: int = 3, seed: int = 0, device=None) -> dict:
    """The three experiments on ``device`` (CUDA unless the caller asks for
    the CPU)."""
    dev = resolve_device(device)
    cfg = get_arch(arch, reduced=reduced)
    params = api.init(prng.PRNGKey(seed), cfg, device=dev)
    pcfg = PlannerConfig(p_stuck=0.5, min_size=1024)
    deploys: list = []
    with Timer(dev) as t_curve:
        curve = run_fault_curve(cfg, params, rates=rates, pcfg=pcfg, seed=seed, device=dev,
                                deploys=deploys)
    with Timer(dev) as t_redeploy:
        redeploy = run_hot_redeploy(cfg, params, api.init(prng.PRNGKey(seed + 1), cfg, device=dev),
                                    pcfg=pcfg, n_requests=n_requests, seed=seed, device=dev)
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
        "redeploy": redeploy, "endurance": endurance,
        "seconds": {"fault_curve": t_curve.seconds, "redeploy": t_redeploy.seconds,
                    "endurance": t_end.seconds},
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--full-size", action="store_true", help="no --reduced config")
    ap.add_argument("--quick", action="store_true",
                    help="rates 0 and 2e-3, 4 requests, 2 deployments")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero if remapping recovers < half the KL degradation, or "
                         "the redeploy trace drops a request or breaks stream parity")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    kw = dict(rates=(0.0, REF_RATE), n_requests=4, n_deploys=2) if args.quick else {}

    banner("Fault curve — logit KL vs stuck-cell rate, naive vs fault-aware")
    res = run(args.arch, reduced=not args.full_size, device=args.device, **kw)
    print(f"  remapping recovers {100 * res['recovery_at_ref']:.1f}% of the KL degradation "
          f"at rate {res['ref_rate']} (2x spare capacity)")
    rd = res["redeploy"]
    print(f"  hot redeploy: {rd['completed']}/{rd['n_requests']} completed, stream parity "
          f"{rd['stream_parity']}, swap pause {rd['swap_pause_s'] * 1e3:.0f} ms "
          f"({rd['pause_vs_step']:.1f}x a median serve step)")
    print("  horizon after each deploy: "
          + ", ".join(f"{h:.3g}" for h in res["endurance"]["horizons"])
          + f"  (@ {res['endurance']['endurance']:.0e} writes/cell)")
    save_json("BENCH_fault", res)
    failures = []
    if args.check and res["recovery_at_ref"] < 0.5:
        failures.append(f"remapping recovered {100 * res['recovery_at_ref']:.1f}% "
                        f"(gate: >= 50%)")
    if args.check and (rd["completed"] < rd["n_requests"] or not rd["swapped"]):
        failures.append(f"redeploy dropped requests: {rd['completed']}/{rd['n_requests']} "
                        f"completed (swapped={rd['swapped']})")
    if args.check and not rd["stream_parity"]:
        failures.append("token streams diverged from per-epoch solo generation")
    for f in failures:
        print(f"  CHECK FAILED: {f}", file=sys.stderr)
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
