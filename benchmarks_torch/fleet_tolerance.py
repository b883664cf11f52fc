"""Fleet fault tolerance on the port: throughput scaling, chaos survival, admission.

The port's copy of ``benchmarks/fleet_tolerance.py``, at its settings
(``ECFG``, ``_trace``'s ``numpy.default_rng`` draws, the reduced gemma-2b):

  * **Scaling** — one trace served by 1/2/4-replica fleets (hedging off).
    On one card (or the CPU) the replicas share the device: the rows
    measure routing overhead, not speedup.
  * **TP scaling** — one replica's pipeline sharded {1, 2, 4}-way
    (``parallel.tp.tp_generate``), each shard count's tokens checked against
    solo generation.  The shards run in turn on one device
    (``native_mesh: False``): the rows measure the TP overhead, not speedup.
  * **Kill-one-of-4** — a ``FaultInjector`` crash (host state lost) takes
    replica 0 down at its 2nd cycle; the survivors must complete every
    admitted request with every stream equal to solo ``serve.generate``.
  * **Stall trace** — replica 0 freezes for 2 s; hedged re-dispatch must
    finish its work on the others, again complete and exact.
  * **Admission** — a burst past the bounded queue: shed / completed /
    degraded counts, the degraded streams still exact.

Fields that do not depend on the wall clock, which the port's CPU test and
``chip_smoke.py`` hold equal to the reference's
(``benchmarks_torch/golden/reference.json``, ``tools/reference_figures.py``),
are listed in ``WALL_FREE`` for each section, with every request's status
and tokens (``results``) and the TP rows' tokens: placements before the
first straggler mark (warm-up: 2 cycles), the crash at a replica-local
cycle, admission at arrival 0 and retries with zero backoff are all
deterministic.  Which replica served a request, latencies, tok/s, walls,
and the stall trace's hedges, cancels, retries and failovers depend on the
clock and are not compared.

  PYTHONPATH=src python -m benchmarks_torch.fleet_tolerance [--quick] [--check] [--device cpu]

Writes experiments/bench_torch/BENCH_fleet.json.  ``--check`` exits
non-zero under the reference's gates (``_gate_trace``).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from benchmarks_torch.common import banner, save_json
from repro_torch import prng, tree
from repro_torch.configs import get_arch
from repro_torch.kernels._util import resolve_device
from repro_torch.launch.engine import EngineConfig, Request
from repro_torch.launch.fleet import FaultInjector, Fleet, FleetConfig
from repro_torch.launch.serve import generate
from repro_torch.models import api

ECFG = EngineConfig(
    max_slots=2, page_size=8, max_seq_len=64, prefill_chunk=16, decode_quantum=4
)

_TRACE_FREE = ("n_requests", "admitted", "completed", "timeouts", "shed", "degraded",
               "stream_parity", "surviving_replicas", "results")
WALL_FREE = {
    "scaling": ("n_replicas",) + _TRACE_FREE,
    "tp_scaling": ("n_shards", "native_mesh", "attn_sharded", "mlp_sharded", "token_parity",
                   "tokens"),
    "kill_trace": ("n_replicas", "retries", "failovers", "restarts", "crashes")
    + _TRACE_FREE,
    "stall_trace": ("n_replicas", "stall_s") + _TRACE_FREE,
    "admission": _TRACE_FREE + ("retries", "failovers", "restarts", "hedges"),
}


def _trace(cfg, n, *, seed=0, gen_lo=6, gen_hi=12):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        prompt = rng.integers(
            0, cfg.vocab_size, int(rng.integers(4, 11))
        ).astype(np.int32)
        reqs.append(Request(
            rid=i, prompt=prompt,
            max_new_tokens=int(rng.integers(gen_lo, gen_hi + 1)),
            greedy=bool(i % 2), seed=i,
        ))
    return reqs


def _solo(cfg, params, req) -> list[int]:
    dev = tree.leaves(params)[0].device
    toks, _ = generate(
        cfg, params, {"tokens": torch.from_numpy(req.prompt)[None].to(dev)},
        gen_len=req.max_new_tokens, greedy=req.greedy, seed=req.seed,
    )
    return [int(t) for t in toks[0].cpu()]


def _summarize(cfg, params, fleet, reqs, results, wall_s) -> dict:
    """Completion / parity / latency / shed accounting for one trace."""
    ok = [r for r in results if r.status == "ok"]
    parity = all(
        r.tokens == _solo(cfg, params, fleet.requests[r.rid]) for r in ok
    )
    lat = sorted(r.latency for r in ok)
    pct = lambda p: float(lat[min(int(p * len(lat)), len(lat) - 1)]) if lat else 0.0  # noqa: E731
    toks = sum(len(r.tokens) for r in ok)
    return {
        "n_requests": len(reqs),
        "admitted": fleet.stats["admitted"],
        "completed": len(ok),
        "timeouts": sum(r.status == "timeout" for r in results),
        "shed": sum(r.status == "shed" for r in results),
        "degraded": fleet.stats["degraded"],
        "stream_parity": bool(parity),
        "surviving_replicas": sum(r.state == "live" for r in fleet.replicas),
        "tok_s": toks / max(wall_s, 1e-9),
        "p50_latency_s": pct(0.50),
        "p99_latency_s": pct(0.99),
        "retries": fleet.stats["retries"],
        "failovers": fleet.stats["failovers"],
        "restarts": fleet.stats["restarts"],
        "hedges": fleet.stats["hedges"],
        "wall_s": wall_s,
        "results": {str(r.rid): [r.status, [int(t) for t in r.tokens]] for r in results},
    }


def _run_fleet(cfg, params, fcfg, reqs, injector=None):
    fleet = Fleet(cfg, params, fcfg, ECFG, injector=injector)
    t0 = time.perf_counter()
    results = fleet.run(reqs)
    wall = time.perf_counter() - t0
    return fleet, results, wall


def run_scaling(cfg, params, *, counts=(1, 2, 4), n_requests=12, seed=0) -> list[dict]:
    """One trace through fleets of increasing replica count (hedging off)."""
    rows = []
    for n in counts:
        reqs = _trace(cfg, n_requests, seed=seed)
        fcfg = FleetConfig(n_replicas=n, max_queue=4 * n_requests, hedge=False)
        fleet, results, wall = _run_fleet(cfg, params, fcfg, reqs)
        row = _summarize(cfg, params, fleet, reqs, results, wall)
        row["n_replicas"] = n
        rows.append(row)
        print(f"  {n} replica(s): {row['tok_s']:8.1f} tok/s   "
              f"{row['completed']}/{row['n_requests']} completed   "
              f"p50 {row['p50_latency_s'] * 1e3:.0f} ms")
    return rows


def run_tp_scaling(cfg, params, *, counts=(1, 2, 4), gen_len=16, seed=0) -> list[dict]:
    """Per-replica tok/s against the shard count, parity-checked against
    solo generation; every row emulated on one device (overhead only)."""
    from repro_torch.parallel.tp import plan_tp, tp_generate

    dev = tree.leaves(params)[0].device
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)).to(dev)}
    ref, _ = generate(cfg, params, batch, gen_len=gen_len)
    ref = ref.cpu().numpy()
    rows = []
    for n in counts:
        plan = plan_tp(cfg, n)
        toks, tok_s = tp_generate(cfg, params, batch, n=n, gen_len=gen_len, plan=plan,
                                  repeats=2)
        toks = toks.cpu().numpy()
        row = {
            "n_shards": n,
            "native_mesh": False,
            "attn_sharded": plan.attn,
            "mlp_sharded": plan.mlp,
            "tok_s_per_replica": float(tok_s),
            "token_parity": bool(np.array_equal(toks, ref)),
            "tokens": toks.tolist(),
        }
        rows.append(row)
        print(f"  {n} shard(s) [emulated]: {row['tok_s_per_replica']:8.1f} tok/s   "
              f"attn={'TP' if plan.attn else 'rep'} "
              f"mlp={'TP' if plan.mlp else 'rep'}   "
              f"parity {row['token_parity']}")
    return rows


def run_kill_trace(cfg, params, *, n_replicas=4, n_requests=16, seed=1) -> dict:
    """Crash one replica mid-trace (host state lost on odd seeds): the
    survivors must complete everything admitted, streams exact."""
    reqs = _trace(cfg, n_requests, seed=seed, gen_lo=8, gen_hi=16)
    inj = FaultInjector()
    inj.crash(0, at_step=2, lose_state=bool(seed % 2))
    fcfg = FleetConfig(n_replicas=n_replicas, max_queue=4 * n_requests, hedge=False)
    fleet, results, wall = _run_fleet(cfg, params, fcfg, reqs, injector=inj)
    row = _summarize(cfg, params, fleet, reqs, results, wall)
    row.update(n_replicas=n_replicas, chaos=inj.log,
               crashes=fleet.stats["crashes"])
    print(f"  kill 1/{n_replicas}: {row['completed']}/{row['admitted']} "
          f"completed, parity {row['stream_parity']}, "
          f"{row['surviving_replicas']} survivors, "
          f"{row['failovers']} failovers + {row['restarts']} restarts")
    return row


def run_stall_trace(cfg, params, *, n_replicas=4, n_requests=16,
                    stall_s=2.0, seed=2) -> dict:
    """Freeze one replica mid-trace: hedged re-dispatch finishes its work
    on the others without waiting out the stall."""
    reqs = _trace(cfg, n_requests, seed=seed, gen_lo=8, gen_hi=16)
    inj = FaultInjector()
    inj.stall(0, at_step=2, duration_s=stall_s)
    fcfg = FleetConfig(n_replicas=n_replicas, max_queue=4 * n_requests,
                       hedge=True, hedge_stall_s=0.15)
    fleet, results, wall = _run_fleet(cfg, params, fcfg, reqs, injector=inj)
    row = _summarize(cfg, params, fleet, reqs, results, wall)
    row.update(n_replicas=n_replicas, stall_s=stall_s, chaos=inj.log,
               cancels=fleet.stats["cancels"])
    print(f"  stall {stall_s}s on 1/{n_replicas}: {row['completed']}/"
          f"{row['admitted']} completed, parity {row['stream_parity']}, "
          f"{row['hedges']} hedges, wall {row['wall_s']:.1f}s")
    return row


def run_admission(cfg, params, *, n_requests=10, seed=3) -> dict:
    """Burst a single replica past its bounded queue: shed vs completed vs
    degraded counts."""
    reqs = _trace(cfg, n_requests, seed=seed)
    fcfg = FleetConfig(n_replicas=1, max_queue=max(4, n_requests // 2),
                       degrade_cap=4, hedge=False)
    fleet, results, wall = _run_fleet(cfg, params, fcfg, reqs)
    row = _summarize(cfg, params, fleet, reqs, results, wall)
    print(f"  burst {n_requests} -> queue {fcfg.max_queue}: "
          f"{row['completed']} completed / {row['shed']} shed / "
          f"{row['degraded']} degraded, parity {row['stream_parity']}")
    return row


def run(arch: str = "gemma-2b", *, reduced: bool = True, counts=(1, 2, 4),
        n_requests: int = 16, seed: int = 0, device=None) -> dict:
    dev = resolve_device(device)
    cfg = get_arch(arch, reduced=reduced)
    params = api.init(prng.PRNGKey(seed), cfg, device=dev)

    banner("Fleet scaling — tok/s vs replica count")
    scaling = run_scaling(cfg, params, counts=counts,
                          n_requests=max(8, n_requests // 2), seed=seed)

    banner("TP scaling — per-replica tok/s vs shard count")
    tp_scaling = run_tp_scaling(cfg, params, counts=counts, seed=seed)

    banner("Chaos: kill one replica mid-trace")
    kill = run_kill_trace(cfg, params, n_replicas=max(counts),
                          n_requests=n_requests, seed=seed + 1)

    banner("Chaos: stall one replica mid-trace (hedged re-dispatch)")
    stall = run_stall_trace(cfg, params, n_replicas=max(counts),
                            n_requests=n_requests, seed=seed + 2)

    banner("Admission: bounded queue, shed + degraded mode")
    admission = run_admission(cfg, params, n_requests=max(8, n_requests // 2),
                              seed=seed + 3)

    return {
        "arch": arch,
        "reduced": reduced,
        "backend": dev.type,
        "devices": torch.cuda.device_count() if dev.type == "cuda" else 1,
        "engine": {"max_slots": ECFG.max_slots, "page_size": ECFG.page_size,
                   "max_seq_len": ECFG.max_seq_len, "fused": ECFG.fused},
        "scaling": scaling,
        "tp_scaling": tp_scaling,
        "kill_trace": kill,
        "stall_trace": stall,
        "admission": admission,
    }


def wall_free(res: dict) -> dict:
    """The fields of a ``run`` result that do not depend on the wall clock
    (``WALL_FREE``), with the chaos logs' times dropped."""
    out = {}
    for sec, keys in WALL_FREE.items():
        rows = res[sec] if isinstance(res[sec], list) else [res[sec]]
        picked = [{k: row[k] for k in keys} for row in rows]
        out[sec] = picked if isinstance(res[sec], list) else picked[0]
    for sec in ("kill_trace", "stall_trace"):
        out[sec]["chaos"] = [{k: v for k, v in ev.items() if k != "t"}
                             for ev in res[sec]["chaos"]]
    return out


def _gate_trace(name: str, row: dict, failures: list) -> None:
    """The fleet survival contract for one chaos trace."""
    if row["completed"] < row["admitted"]:
        failures.append(
            f"{name}: {row['completed']}/{row['admitted']} admitted "
            f"requests completed (gate: 100%)"
        )
    if not row["stream_parity"]:
        failures.append(f"{name}: token streams diverged from solo generation")
    if row["surviving_replicas"] < 1:
        failures.append(f"{name}: no surviving replicas")
    if row["timeouts"]:
        failures.append(
            f"{name}: {row['timeouts']} deadline timeouts in a trace with "
            f"no deadlines set"
        )


def check(res: dict) -> list[str]:
    """The reference's ``--check`` gates on a ``run`` result."""
    failures: list = []
    _gate_trace("kill trace", res["kill_trace"], failures)
    _gate_trace("stall trace", res["stall_trace"], failures)
    adm = res["admission"]
    if not adm["stream_parity"]:
        failures.append("admission: degraded streams diverged from solo")
    if adm["completed"] + adm["shed"] + adm["timeouts"] < adm["n_requests"]:
        failures.append(
            f"admission: {adm['completed']} completed + {adm['shed']} "
            f"shed + {adm['timeouts']} timeouts < {adm['n_requests']} "
            f"submitted (requests lost)"
        )
    if any(r["tok_s"] <= 0 for r in res["scaling"]):
        failures.append("scaling: non-positive tok/s recorded")
    for r in res["tp_scaling"]:
        if not r["token_parity"]:
            failures.append(
                f"tp_scaling: {r['n_shards']}-shard token stream "
                f"diverged from solo generation"
            )
        if r["tok_s_per_replica"] <= 0:
            failures.append(f"tp_scaling: non-positive tok/s at {r['n_shards']} shards")
    return failures


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--full-size", action="store_true", help="no --reduced config")
    ap.add_argument("--quick", action="store_true", help="smoke shapes")
    ap.add_argument("--device", default=None, help="cpu to run on the CPU")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero unless both chaos traces complete 100% of "
                         "admitted requests with >= 1 surviving replica and "
                         "per-request token parity")
    args = ap.parse_args()
    kw = dict(n_requests=8, counts=(1, 2)) if args.quick else {}
    res = run(args.arch, reduced=not args.full_size, device=args.device, **kw)
    save_json("BENCH_fleet", res)
    if args.check:
        failures = check(res)
        for f in failures:
            print(f"  CHECK FAILED: {f}", file=sys.stderr)
        if failures:
            sys.exit(1)


if __name__ == "__main__":
    main()
