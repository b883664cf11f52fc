"""Online integrity on the port: storm, scrub, repair, and the accuracy of
tolerated faults.

The port's copy of the engine-free parts of ``benchmarks/integrity_scrub.py``,
at its settings (reduced gemma-2b, p_stuck 0.5, min_size 1024, 128x10
crossbars, a 2x-spare lpt pool, storms from ``PRNGKey(1729)``):

  * **Storm and repair** — deploy a checkpoint through an integrity-enabled
    pool, corrupt stored bits and add hard stuck cells, scrub to
    convergence.  Reported: what the storm did to the served streams, that
    the scrubber detected it, the priced repair cost (rewrites, spare-column
    remaps, migrations, through ``price_pairs``) against a full reprogram
    of the affected tensors, and that the rebuilt deployment serves the
    pre-storm token streams.
  * **Tolerated-fault accuracy** — with ``tolerate_cols=1`` the lowest-order
    faulty columns stay unrepaired; the shadow-batch logit KL against the
    fp model prices that, per storm rate.

The engine-integrated scrub and the scrub overhead on serving throughput
wait for the engine (ROADMAP A.14).  Every counter equals the reference's
(``tests/test_torch_bench_faults.py`` and ``chip_smoke.py`` hold them to
``golden/reference.json``).

  PYTHONPATH=src python -m benchmarks_torch.integrity_scrub [--quick] [--check] [--device cpu]

Writes experiments/bench_torch/BENCH_integrity.json.  ``--check`` exits
non-zero if the storm goes undetected, post-repair token parity or the
pool's reads break, or repair costs more than half a full reprogram.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

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
from repro_torch.launch.serve import generate
from repro_torch.models import api

SPEC = CrossbarSpec(rows=128, cols=10)
STORM_SEED = 1729
KL_RATES = (0.0, 1e-3, 4e-3)


@dataclasses.dataclass
class Request:
    """One served request: a prompt and its greedy / sampled generation."""

    rid: int
    prompt: np.ndarray  # int32[L]
    max_new_tokens: int
    greedy: bool = True
    seed: int = 0


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


def check(res: dict) -> list[str]:
    """The reference's storm gates that need no engine."""
    sr, failures = res["storm_repair"], []
    if sr["detections"] < 1:
        failures.append("fault storm went undetected by the scrubber")
    if not (sr["post_repair_parity"] and sr["pool_verified"]):
        failures.append("post-repair token streams or pool reads differ from the clean deployment")
    if sr["repair_cost_ratio"] > 0.5:
        failures.append(f"repair cost {100 * sr['repair_cost_ratio']:.1f}% of a full reprogram "
                        f"(gate: <= 50%)")
    return failures


def run(arch: str = "gemma-2b", *, reduced: bool = True, corrupt: float = 2e-3,
        stuck: float = 2e-4, n_requests: int = 4, kl_rates=KL_RATES, seed: int = 0,
        device=None) -> dict:
    """Both experiments on ``device`` (CUDA unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    cfg = get_arch(arch, reduced=reduced)
    params = api.init(prng.PRNGKey(seed), cfg, device=dev)
    pcfg = PlannerConfig(p_stuck=0.5, min_size=1024)
    with Timer(dev) as t_storm:
        storm = run_storm_repair(cfg, params, pcfg=pcfg, corrupt=corrupt, stuck=stuck,
                                 n_requests=n_requests, seed=seed, device=dev)
    with Timer(dev) as t_kl:
        kl = run_tolerated_kl(cfg, params, pcfg=pcfg, rates=kl_rates, seed=seed, device=dev)
    return {
        "arch": arch, "reduced": reduced, "seed": seed,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "spec": {"rows": SPEC.rows, "cols": SPEC.cols},
        "planner": {"p_stuck": pcfg.p_stuck, "min_size": pcfg.min_size,
                    "crossbars": pcfg.crossbars, "spare_factor": 2},
        "n_requests": n_requests, "kl_rates": list(kl_rates),
        "storm_repair": storm, "tolerated_kl": kl,
        "seconds": {"storm_repair": t_storm.seconds, "tolerated_kl": t_kl.seconds},
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--full-size", action="store_true", help="no --reduced config")
    ap.add_argument("--quick", action="store_true", help="3 requests, one KL rate")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero if the storm goes undetected, post-repair parity "
                         "breaks, or repair costs more than half a full reprogram")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    kw = dict(n_requests=3, kl_rates=(1e-3,)) if args.quick else {}

    banner("Storm and repair — detect, localize, price, restore parity")
    res = run(args.arch, reduced=not args.full_size, device=args.device, **kw)
    sr = res["storm_repair"]
    print(f"  {sr['corrupted_bits']} corrupted bits + {sr['new_stuck_cells']} stuck cells -> "
          f"{sr['detections']} tiles detected, {sr['rewrites']} rewrites / {sr['remaps']} "
          f"remaps / {sr['migrations']} migrations")
    print(f"  repair cost {sr['repair_transitions']} transitions = "
          f"{100 * sr['repair_cost_ratio']:.1f}% of a full reprogram "
          f"({sr['transitions_full_reprogram']}), token parity {sr['post_repair_parity']}")
    save_json("BENCH_integrity", res)
    failures = check(res) if args.check else []
    for f in failures:
        print(f"  CHECK FAILED: {f}", file=sys.stderr)
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
