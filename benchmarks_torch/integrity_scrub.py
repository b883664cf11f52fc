"""Online integrity on the port: storm, scrub, repair, the scrub under a
live engine and its overhead, and the accuracy of tolerated faults.

The port's copy of ``benchmarks/integrity_scrub.py``, at its settings
(reduced gemma-2b, p_stuck 0.5, min_size 1024, 128x10 crossbars, a
2x-spare lpt pool, storms from ``PRNGKey(1729)``):

  * **Storm and repair** — deploy a checkpoint through an integrity-enabled
    pool, corrupt stored bits and add hard stuck cells, scrub to
    convergence.  Reported: what the storm did to the served streams, that
    the scrubber detected it, the priced repair cost (rewrites, spare-column
    remaps, migrations, through ``price_pairs``) against a full reprogram
    of the affected tensors, and that the rebuilt deployment serves the
    pre-storm token streams.
  * **Engine-integrated scrub** — an engine serves a trace while its
    between-dispatch scrub hook finds a storm, repairs it and hot-swaps the
    repaired planes in; requests admitted after the refresh are the solo
    streams of the clean deployment.
  * **Scrub overhead** — serving tok/s with the scrubber scanning its tile
    budget every ``every`` engine steps on a clean pool, against scrubbing
    off, interleaved best of N.  Its trace is ``OVERHEAD_REQUESTS`` (32)
    requests and N ``OVERHEAD_TRIALS`` (5) where the reference's are 4 and
    3: at 4 a trial is ~6 engine steps, fewer than the 8 between two
    rounds, so the ratio timed trials with no round and was mostly noise
    (ROADMAP's departures).
  * **Tolerated-fault accuracy** — with ``tolerate_cols=1`` the lowest-order
    faulty columns stay unrepaired; the shadow-batch logit KL against the
    fp model prices that, per storm rate.

Every counter equals the reference's (``tests/test_torch_bench_faults.py``
and ``chip_smoke.py`` hold them to ``golden/reference.json``).

  PYTHONPATH=src python -m benchmarks_torch.integrity_scrub [--quick] [--check] [--device cpu]

Writes experiments/bench_torch/BENCH_integrity.json.  ``--check`` exits
non-zero if the storm goes undetected, post-repair token parity or the
pool's reads break, repair costs more than half a full reprogram, the
engine's scrub hook fails to refresh with post-refresh parity, or
scrubbing costs more than 5% of serving tok/s.
"""
from __future__ import annotations

import argparse
import gc
import sys
import time

import numpy as np
import torch

from benchmarks_torch.common import Timer, banner, logit_kl_f64, save_json
from repro_torch import prng
from repro_torch.configs import get_arch
from repro_torch.core import simulator
from repro_torch.core.integrity import IntegrityConfig
from repro_torch.core.planner import CrossbarSpec, PlannerConfig, build_deployment, deploy_params
from repro_torch.core.pool import CrossbarPool
from repro_torch.kernels._util import resolve_device
from repro_torch.launch.engine import Engine, EngineConfig, Request
from repro_torch.launch.serve import generate
from repro_torch.models import api

SPEC = CrossbarSpec(rows=128, cols=10)
STORM_SEED = 1729
KL_RATES = (0.0, 1e-3, 4e-3)
ECFG = EngineConfig(max_slots=2, page_size=8, max_seq_len=64, prefill_chunk=8, decode_quantum=4)
# the scrub overhead's trace: long enough that every trial holds several
# scrub rounds (the reference's 4 requests give ~6 steps a trial, fewer
# than one round's 8, so best-of-3 may time a trial with no round); and
# its trials, whose walls spread by ~6% on the card's shared host
OVERHEAD_REQUESTS = 32
OVERHEAD_TRIALS = 5

def integrity_deploy(params, pcfg: PlannerConfig, icfg: IntegrityConfig, device):
    """Deploy ``params`` through a fresh integrity-enabled lpt pool of twice
    the plan's crossbars -> (pool, manager, plan, dense served params)."""
    pool = CrossbarPool(SPEC, 2 * pcfg.crossbars, leveling="lpt", device=device)
    mgr = pool.enable_integrity(icfg)
    plan = build_deployment(params, SPEC, pcfg, pool=pool, device=device)
    return pool, mgr, plan, deploy_params(params, plan, materialize="dense")


def make_requests(cfg, n: int, *, seed: int = 0, rid0: int = 0) -> list[Request]:
    """The reference's requests: prompts of 6-13 tokens and 4-8 new tokens
    from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return [Request(rid=rid0 + i,
                    prompt=rng.integers(0, cfg.vocab_size, int(rng.integers(6, 14))).astype(np.int32),
                    max_new_tokens=int(rng.integers(4, 9)), greedy=True, seed=rid0 + i)
            for i in range(n)]


def solo(cfg, params, req: Request, device) -> list[int]:
    """One request generated alone."""
    tokens = torch.from_numpy(req.prompt.astype(np.int64))[None].to(device)
    toks, _ = generate(cfg, params, {"tokens": tokens}, gen_len=req.max_new_tokens,
                       greedy=req.greedy, seed=req.seed)
    return [int(t) for t in toks[0].cpu()]


def run_storm_repair(cfg, params, *, pcfg, corrupt=2e-3, stuck=2e-4, n_requests=4, seed=0,
                     device=None) -> dict:
    """Storm -> scrub to convergence -> the rebuilt deployment must serve the
    pre-storm token streams."""
    dev = resolve_device(device)
    pool, mgr, plan, served = integrity_deploy(params, pcfg, IntegrityConfig(spare_cols=2),
                                               dev)
    reqs = make_requests(cfg, n_requests, seed=seed)
    clean_streams = [solo(cfg, served, r, dev) for r in reqs]

    st = mgr.storm(prng.PRNGKey(STORM_SEED), corrupt_rate=corrupt, stuck_rate=stuck)
    corrupted = deploy_params(params, mgr.rebuild_plan(plan), materialize="dense")
    storm_streams = [solo(cfg, corrupted, r, dev) for r in reqs]
    degraded = sum(a != b for a, b in zip(storm_streams, clean_streams))

    rep = mgr.scrub_until_clean()
    full = mgr.transitions_full_affected()
    repaired = deploy_params(params, mgr.rebuild_plan(plan), materialize="dense")
    parity = [solo(cfg, repaired, r, dev) for r in reqs] == clean_streams
    return {
        "corrupt_rate": corrupt, "stuck_rate": stuck,
        "corrupted_bits": st["corrupted_bits"],
        "new_stuck_cells": st["new_stuck_cells"],
        "streams_degraded_by_storm": degraded,
        "detections": rep.detections,
        "transients": rep.transients,
        "rewrites": rep.rewrites,
        "remaps": rep.remaps,
        "migrations": rep.migrations,
        "tolerated": rep.tolerated,
        "repair_transitions": rep.repair_transitions,
        "transitions_full_reprogram": full,
        "repair_cost_ratio": rep.repair_transitions / max(full, 1),
        "post_repair_parity": bool(parity),
        "pool_verified": bool(mgr.verify_all()),
        "spare_writes": mgr.spare_writes,
    }


def run_engine_scrub(cfg, params, *, pcfg, corrupt=2e-3, stuck=2e-4, n_requests=4, seed=0,
                     device=None) -> dict:
    """Mid-trace storm under a live engine: the between-dispatch scrub hook
    detects, repairs and hot-swaps the repaired planes; post-refresh
    admissions are the solo streams of the clean params."""
    dev = resolve_device(device)
    icfg = IntegrityConfig(spare_cols=2, scrub_tiles=1_000_000)
    pool, mgr, plan, served = integrity_deploy(params, pcfg, icfg, dev)
    eng = Engine(cfg, served, ECFG)
    eng.attach_scrub(
        mgr, refresh=lambda: deploy_params(params, mgr.rebuild_plan(plan), materialize="dense"))
    mgr.storm(prng.PRNGKey(STORM_SEED), corrupt_rate=corrupt, stuck_rate=stuck)
    # what an un-refreshed engine would keep serving
    eng.hot_swap(deploy_params(params, mgr.rebuild_plan(plan), materialize="dense"))
    eng.run(make_requests(cfg, n_requests, seed=seed))
    post = make_requests(cfg, 2, seed=seed + 1, rid0=100)
    results = eng.run(post)
    parity = all(res.tokens == solo(cfg, served, req, dev) for req, res in zip(post, results))
    return {
        "scrub_rounds": eng.stats["scrub_rounds"],
        "scrub_tiles": eng.stats["scrub_tiles"],
        "scrub_detections": eng.stats["scrub_detections"],
        "scrub_repairs": eng.stats["scrub_repairs"],
        "scrub_refreshes": eng.stats["scrub_refreshes"],
        "pool_verified": bool(mgr.verify_all()),
        "post_refresh_parity": bool(parity),
    }


def run_scrub_overhead(cfg, params, *, pcfg, n_requests=OVERHEAD_REQUESTS,
                       trials=OVERHEAD_TRIALS, scrub_tiles=64, every=8, seed=0, round_reps=16,
                       device=None) -> dict:
    """Steady-state serving tok/s with and without the scrubber scanning its
    tile budget every ``every`` engine steps (clean pool: the detection
    overhead alone), interleaved best of ``trials``.

    A trial is a few tens of milliseconds on the card, so the garbage
    collector is run before it and kept off during it (as ``timeit`` does),
    and the card is idle when its clock starts.  Each trial's wall time and
    scrub rounds are returned, and ``round_s``, the median of
    ``round_reps`` scrub rounds timed alone on the warm manager afterwards:
    with ``every`` this prices a round against the steps between two."""
    dev = resolve_device(device)
    icfg = IntegrityConfig(spare_cols=2, scrub_tiles=scrub_tiles)
    pool, mgr, plan, served = integrity_deploy(params, pcfg, icfg, dev)
    eng_off = Engine(cfg, served, ECFG)
    eng_on = Engine(cfg, served, ECFG)
    eng_on.attach_scrub(mgr, every=every)

    def idle():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(eng, rid0):
        reqs = make_requests(cfg, n_requests, seed=seed, rid0=rid0)
        rounds = eng.stats["scrub_rounds"]
        gc.collect()
        gc.disable()
        try:
            idle()
            t0 = time.perf_counter()
            results = eng.run(reqs)
            wall = time.perf_counter() - t0
        finally:
            gc.enable()
        return sum(len(r.tokens) for r in results), wall, eng.stats["scrub_rounds"] - rounds

    timed(eng_off, 10_000), timed(eng_on, 20_000)  # warm-up both paths
    walls = {"off": [], "on": []}
    per_trial, tokens = [], 0
    for t in range(trials):
        tokens, w_off, _ = timed(eng_off, 30_000 + 100 * t)
        _, w_on, r_on = timed(eng_on, 60_000 + 100 * t)
        walls["off"].append(w_off)
        walls["on"].append(w_on)
        per_trial.append(r_on)
    tps_off, tps_on = tokens / min(walls["off"]), tokens / min(walls["on"])
    scrub_rounds = eng_on.stats["scrub_rounds"]
    round_s = []
    for _ in range(round_reps):
        idle()
        t0 = time.perf_counter()
        mgr.scrub_round()
        idle()
        round_s.append(time.perf_counter() - t0)
    return {
        "trials": trials,
        "scrub_every_steps": every,
        "scrub_tiles_per_round": scrub_tiles,
        "total_tiles": mgr.total_tiles,
        "tokens_per_trial": tokens,
        "tok_s_off": tps_off,
        "tok_s_on": tps_on,
        "throughput_ratio": tps_on / tps_off,
        "scrub_rounds": scrub_rounds,
        "false_detections": eng_on.stats["scrub_detections"],
        "walls_off_s": walls["off"],
        "walls_on_s": walls["on"],
        "rounds_per_trial": per_trial,
        "round_s": float(np.median(round_s)) if round_s else None,
    }


ENGINE_SCRUB_KEYS = ("scrub_rounds", "scrub_tiles", "scrub_detections", "scrub_repairs",
                     "scrub_refreshes", "pool_verified", "post_refresh_parity")
OVERHEAD_KEYS = ("trials", "scrub_every_steps", "scrub_tiles_per_round", "total_tiles",
                 "tokens_per_trial", "scrub_rounds", "false_detections")


def run_tolerated_kl(cfg, params, *, pcfg, rates=KL_RATES, batch_size=2, shadow_len=16, seed=0,
                     device=None) -> list[dict]:
    """Shadow-batch logit KL (against fp, also in float64) after storm +
    repair with ``tolerate_cols=1``: low-order faulty columns stay
    unrepaired."""
    dev = resolve_device(device)
    batch = api.make_batch(cfg, prng.PRNGKey(seed), batch_size, shadow_len, device=dev)
    f = lambda p, b: api.forward(p, cfg, b)[0]  # noqa: E731
    out = []
    for rate in rates:
        _, mgr, plan, _ = integrity_deploy(params, pcfg,
                                           IntegrityConfig(spare_cols=2, tolerate_cols=1), dev)
        row = {"stuck_rate": rate, "tolerated": 0, "remaps": 0}
        if rate > 0.0:
            mgr.storm(prng.PRNGKey(STORM_SEED), stuck_rate=rate)
            rep = mgr.scrub_until_clean()
            row.update(tolerated=rep.tolerated, remaps=rep.remaps)
        params_hat = deploy_params(params, mgr.rebuild_plan(plan), materialize="dense")
        row["kl"] = float(simulator.logit_kl(f, params, params_hat, batch))
        row["kl_f64"] = logit_kl_f64(f, params, params_hat, batch)
        out.append(row)
        print(f"  stuck rate {rate:7.5f}   kl {row['kl']:.5f}   "
              f"({row['tolerated']} tolerated, {row['remaps']} remapped)")
    return out


def check(res: dict, *, timing: bool = True) -> list[str]:
    """The reference's gates; ``timing=False`` leaves out the one on tok/s
    (a CPU run's tok/s says nothing of the device's)."""
    sr, failures = res["storm_repair"], []
    if sr["detections"] < 1:
        failures.append("fault storm went undetected by the scrubber")
    if not (sr["post_repair_parity"] and sr["pool_verified"]):
        failures.append("post-repair token streams or pool reads differ from the clean deployment")
    if sr["repair_cost_ratio"] > 0.5:
        failures.append(f"repair cost {100 * sr['repair_cost_ratio']:.1f}% of a full reprogram "
                        f"(gate: <= 50%)")
    esc = res["engine_scrub"]
    if not (esc["scrub_refreshes"] >= 1 and esc["post_refresh_parity"]):
        failures.append("engine scrub hook failed to refresh repaired planes with "
                        "post-refresh stream parity")
    if timing and res["overhead"]["throughput_ratio"] < 0.95:
        ovh = res["overhead"]
        failures.append(f"scrubbing costs {100 * (1 - ovh['throughput_ratio']):.1f}% of serving "
                        f"throughput (gate: <= 5%; trial walls off {ovh.get('walls_off_s')} s, "
                        f"on {ovh.get('walls_on_s')} s, rounds {ovh.get('rounds_per_trial')})")
    return failures


def run(arch: str = "gemma-2b", *, reduced: bool = True, corrupt: float = 2e-3,
        stuck: float = 2e-4, n_requests: int = 4, overhead_requests: int = OVERHEAD_REQUESTS,
        trials: int = OVERHEAD_TRIALS, kl_rates=KL_RATES, seed: int = 0, device=None) -> dict:
    """The four experiments on ``device`` (CUDA unless the caller asks for
    the CPU)."""
    dev = resolve_device(device)
    cfg = get_arch(arch, reduced=reduced)
    params = api.init(prng.PRNGKey(seed), cfg, device=dev)
    pcfg = PlannerConfig(p_stuck=0.5, min_size=1024)
    with Timer(dev) as t_storm:
        storm = run_storm_repair(cfg, params, pcfg=pcfg, corrupt=corrupt, stuck=stuck,
                                 n_requests=n_requests, seed=seed, device=dev)
    with Timer(dev) as t_esc:
        esc = run_engine_scrub(cfg, params, pcfg=pcfg, corrupt=corrupt, stuck=stuck,
                               n_requests=n_requests, seed=seed, device=dev)
    with Timer(dev) as t_ovh:
        ovh = run_scrub_overhead(cfg, params, pcfg=pcfg, n_requests=overhead_requests,
                                 trials=trials, seed=seed, device=dev)
    with Timer(dev) as t_kl:
        kl = run_tolerated_kl(cfg, params, pcfg=pcfg, rates=kl_rates, seed=seed, device=dev)
    return {
        "arch": arch, "reduced": reduced, "seed": seed,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "spec": {"rows": SPEC.rows, "cols": SPEC.cols},
        "planner": {"p_stuck": pcfg.p_stuck, "min_size": pcfg.min_size,
                    "crossbars": pcfg.crossbars, "spare_factor": 2},
        "n_requests": n_requests, "kl_rates": list(kl_rates),
        "storm_repair": storm, "engine_scrub": esc, "overhead": ovh, "tolerated_kl": kl,
        "seconds": {"storm_repair": t_storm.seconds, "engine_scrub": t_esc.seconds,
                    "overhead": t_ovh.seconds, "tolerated_kl": t_kl.seconds},
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--full-size", action="store_true", help="no --reduced config")
    ap.add_argument("--quick", action="store_true",
                    help="3 requests (8 for the overhead), 2 trials, one KL rate")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero if the storm goes undetected, post-repair parity "
                         "breaks, or repair costs more than half a full reprogram")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    kw = dict(n_requests=3, overhead_requests=8, trials=2, kl_rates=(1e-3,)) if args.quick else {}

    banner("Storm and repair — detect, localize, price, restore parity")
    res = run(args.arch, reduced=not args.full_size, device=args.device, **kw)
    sr = res["storm_repair"]
    print(f"  {sr['corrupted_bits']} corrupted bits + {sr['new_stuck_cells']} stuck cells -> "
          f"{sr['detections']} tiles detected, {sr['rewrites']} rewrites / {sr['remaps']} "
          f"remaps / {sr['migrations']} migrations")
    print(f"  repair cost {sr['repair_transitions']} transitions = "
          f"{100 * sr['repair_cost_ratio']:.1f}% of a full reprogram "
          f"({sr['transitions_full_reprogram']}), token parity {sr['post_repair_parity']}")
    esc, ovh = res["engine_scrub"], res["overhead"]
    print(f"  engine scrub: {esc['scrub_rounds']} rounds between dispatches, "
          f"{esc['scrub_detections']} detections, {esc['scrub_repairs']} repairs, "
          f"{esc['scrub_refreshes']} refreshes; post-refresh parity {esc['post_refresh_parity']}")
    print(f"  scrub overhead: {ovh['tok_s_off']:.1f} tok/s off vs {ovh['tok_s_on']:.1f} on "
          f"({100 * ovh['throughput_ratio']:.1f}%, {ovh['scrub_tiles_per_round']}/"
          f"{ovh['total_tiles']} tiles a round; a round alone {1e3 * ovh['round_s']:.3f} ms)")
    save_json("BENCH_integrity", res)
    failures = check(res) if args.check else []
    for f in failures:
        print(f"  CHECK FAILED: {f}", file=sys.stderr)
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
