"""Continuous batching vs static lockstep — and fused vs split dispatch — on the port.

The port's copy of ``benchmarks/engine_throughput.py``.  Serves one
heterogeneous request trace (prompt lengths, generation lengths and Poisson
arrival times drawn per request) three ways:

  * ``static``       — the lockstep server: requests grouped into
    fixed-size batches in arrival order, prompts padded to one static
    shape, and decode run until the longest request of the batch finishes
    (one decode graph per generation bucket on the card, ``launch.steps``);
  * ``engine_split`` — ``launch.engine.Engine(fused=False)``: paged KV,
    chunked prefill, mid-flight admission, prefill and decode dispatched
    separately each cycle;
  * ``engine``       — the fused engine: prefill chunks and decode quanta in
    one bucketed dispatch per cycle.

All three are warmed (the engines by two untimed trace passes, which on the
card capture the CUDA graphs of the buckets the trace reaches; the static
server one batch per generation bucket), then the timed passes interleave.
Reported: useful tok/s (each request's own tokens), p50/p95 request latency
and, beyond the reference, p50/p95 time to first token, and on the card the
device-busy share of one traced fused pass and one traced static pass.

A second, over-committed scenario shrinks the pool to one request's true
footprint (``run_overcommit``): lazy allocation + preemption complete it.

``make_trace(..., sample_every=k)`` samples every k-th request (``greedy =
False``, seed = rid), which the reference's trace does not (it serves greedy
only); ``parity_requests`` is that trace with every arrival at 0.0, the
deterministic schedule the card's parity gates and the golden file use.

  PYTHONPATH=src python -m benchmarks_torch.engine_throughput [--quick] [--check] [--device cpu]
  PYTHONPATH=src python -m benchmarks_torch.engine_throughput --full-size --layers 4

Writes experiments/bench_torch/BENCH_engine.json.  ``--check`` exits
non-zero under the reference's gates: fused tok/s below the static
baseline or the split engine (by ``--check-threshold``), or the
over-committed trace incomplete or without preemptions.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from benchmarks_torch.common import banner, save_json
from benchmarks_torch.serving_throughput import busy_share
from repro_torch import prng
from repro_torch.configs import get_arch
from repro_torch.kernels._util import resolve_device
from repro_torch.launch import steps
from repro_torch.launch.engine import Engine, EngineConfig, Request, _bucket
from repro_torch.models import api
from repro_torch.models.transformer import compute_dtype


# the reduced-config parity cell that golden/reference.json records (the
# reference's streams, stats and near ties; tools/reference_figures.py) and
# chip_smoke.py replays on the card: every fourth request sampled, arrivals 0
PARITY_TRACE = dict(n_requests=16, min_prompt=4, max_prompt=40, min_gen=2, max_gen=24,
                    seed=0, sample_every=4)
PARITY_ENGINE = dict(max_slots=4, page_size=8, max_seq_len=64, prefill_chunk=16,
                     decode_quantum=8)
PARITY_PLAN = dict(p_stuck=0.5, min_size=1024)
PARITY_VARIANTS = tuple((mat, fused) for mat in ("dense", "packed") for fused in (True, False))


def make_trace(
    cfg, n_requests: int, *, min_prompt=4, max_prompt=48, min_gen=2, max_gen=32,
    rate: float = 500.0, seed: int = 0, sample_every: int = 0,
) -> list[Request]:
    """Heterogeneous Poisson trace, the reference's draws: iid prompt
    lengths, a short/long generation mixture (75% short around ``min_gen``,
    25% near ``max_gen``), exponential inter-arrival gaps at ``rate``
    requests/second.  ``sample_every`` > 0 samples every ``sample_every``-th
    request (rid % k == k - 1) with seed = rid; 0 keeps the reference's
    all-greedy trace."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, n_requests))
    reqs = []
    for i in range(n_requests):
        plen = int(rng.integers(min_prompt, max_prompt + 1))
        if rng.random() < 0.75:
            gen = int(rng.integers(min_gen, min(min_gen + 7, max_gen) + 1))
        else:
            gen = int(rng.integers(max(max_gen // 2, min_gen), max_gen + 1))
        prompt = rng.integers(0, cfg.vocab_size, plen).astype(np.int32)
        greedy = not (sample_every and i % sample_every == sample_every - 1)
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=gen, greedy=greedy, seed=i,
                            arrival_time=float(arrivals[i])))
    return reqs


def parity_requests(trace, request_cls=Request) -> list:
    """``trace`` with every arrival at 0.0 (a deterministic schedule), as
    ``request_cls`` objects (the reference's ``Request`` for the golden
    file)."""
    return [request_cls(rid=r.rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                        greedy=r.greedy, seed=r.seed) for r in trace]


def serve_parity(eng: Engine, reqs: list, dt: float = 1.0) -> dict:
    """Serve ``reqs`` with ``submit`` + ``step(now)`` on a synthetic clock
    (``dt`` a cycle); {rid: tokens}."""
    for r in reqs:
        eng.submit(r)
    now = 0.0
    while eng.waiting or any(s is not None for s in eng.slots):
        eng.step(now)
        now += dt
    return {r.rid: [int(t) for t in eng.results[r.rid].tokens] for r in reqs}


def _pct(xs, p):
    return float(np.percentile(np.asarray(xs), p)) if xs else 0.0


class StaticServer:
    """Fixed-shape lockstep batching baseline.

    One decode loop per generation-length bucket (on the card one CUDA graph
    of all its steps over a static cache, as ``serve.make_generator``);
    prompts are padded to ``max_prompt`` and decode always runs the
    bucketed batch-max generation length, greedy.
    """

    def __init__(self, cfg, params, batch_size: int, max_prompt: int, max_gen: int):
        self.cfg = cfg
        self.params = steps.prepare_serving_params(params, compute_dtype(cfg))
        dev = steps._params_device(self.params)
        self.device = resolve_device(None) if dev is None else dev
        self.batch_size = batch_size
        self.max_prompt = max_prompt
        self.max_gen = max_gen
        self.prefill = steps.make_prefill_step(cfg)
        self._loops: dict = {}

    def _loop(self, gen_bucket: int):
        if gen_bucket not in self._loops:
            dev = self.device
            cache = api.init_cache(self.cfg, self.batch_size, self.max_prompt + gen_bucket,
                                   device=dev)
            key = prng.PRNGKey(0, device=dev)
            pos = torch.full((), self.max_prompt, dtype=torch.int64, device=dev)
            decode = steps.make_decode_loop(self.cfg, gen_bucket - 1)
            if dev.type == "cuda":
                with torch.inference_mode():
                    decode = steps.CudaGraphCall(
                        decode, self.params, cache,
                        torch.zeros((self.batch_size, 1), dtype=torch.int64, device=dev),
                        key, pos)
            self._loops[gen_bucket] = (decode, cache, key, pos)
        return self._loops[gen_bucket]

    @torch.inference_mode()
    def serve_batch(self, reqs: list[Request]) -> np.ndarray:
        """(B, gen_bucket) tokens; rows beyond each request's own gen are
        drained lockstep waste."""
        b = len(reqs)
        gen_bucket = _bucket(max(r.max_new_tokens for r in reqs), self.max_gen)
        tokens = np.zeros((self.batch_size, self.max_prompt), np.int64)
        for i, r in enumerate(reqs):
            tokens[i, : r.prompt.size] = r.prompt  # right-padded static shape
        batch = {"tokens": torch.from_numpy(tokens).to(self.device)}
        logits, pf_cache = self.prefill(self.params, batch)
        decode, cache, key, pos = self._loop(gen_bucket)
        api.merge_prefill_cache(self.cfg, cache, pf_cache)
        tok = steps.greedy_pick(logits)
        toks, _ = decode(self.params, cache, tok, key, pos)
        return torch.cat([tok, toks], dim=1).cpu().numpy()[:b]

    def warmup(self, gen_buckets: set[int]) -> None:
        for g in sorted(gen_buckets):
            self.serve_batch([Request(rid=-1, prompt=np.zeros(4, np.int32), max_new_tokens=g)])

    def run(self, reqs: list[Request]) -> dict:
        t0 = time.perf_counter()
        latencies, useful = [], 0
        for lo in range(0, len(reqs), self.batch_size):
            group = reqs[lo : lo + self.batch_size]
            now = time.perf_counter() - t0
            last = max(r.arrival_time for r in group)
            if last > now:  # lockstep: the batch waits for its last member
                time.sleep(last - now)
            self.serve_batch(group)
            done = time.perf_counter() - t0
            for r in group:
                latencies.append(done - r.arrival_time)
                useful += r.max_new_tokens
        wall = time.perf_counter() - t0
        return {
            "tok_s": useful / wall,
            "wall_s": wall,
            "p50_latency_ms": 1e3 * _pct(latencies, 50),
            "p95_latency_ms": 1e3 * _pct(latencies, 95),
            # lockstep: a request's first token comes with its batch's end
            "p50_ttft_ms": 1e3 * _pct(latencies, 50),
            "p95_ttft_ms": 1e3 * _pct(latencies, 95),
            "n_batches": -(-len(reqs) // self.batch_size),
        }


def _retrace(trace: list[Request], tag: int) -> list[Request]:
    """Fresh Request objects (distinct rids) for a repeat pass."""
    return [dataclasses.replace(r, rid=tag * 10_000 + r.rid) for r in trace]


STAT_DELTAS = ("decode_dispatches", "prefill_dispatches", "fused_dispatches", "tokens_overrun",
               "preemptions")


def _engine_pass(eng: Engine, trace: list[Request], tag: int) -> dict:
    """One timed trace through an engine; per-pass stat deltas."""
    stats0 = dict(eng.stats)
    t0 = time.perf_counter()
    results = eng.run(_retrace(trace, tag))
    wall = time.perf_counter() - t0
    useful = sum(len(r.tokens) for r in results)
    lat = [r.latency for r in results]
    ttft = [r.ttft for r in results]
    return {
        "tok_s": useful / wall,
        "wall_s": wall,
        "p50_latency_ms": 1e3 * _pct(lat, 50),
        "p95_latency_ms": 1e3 * _pct(lat, 95),
        "p50_ttft_ms": 1e3 * _pct(ttft, 50),
        "p95_ttft_ms": 1e3 * _pct(ttft, 95),
        **{k: eng.stats[k] - stats0[k] for k in STAT_DELTAS},
    }


def overcommit_requests(cfg, n_requests: int = 6, prompt_len: int = 25, max_new: int = 56,
                        seed: int = 0) -> list[Request]:
    """``run_overcommit``'s burst: greedy requests arriving at 0.0."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, prompt_len).astype(np.int32),
                    max_new_tokens=max_new, greedy=True, seed=i, arrival_time=0.0)
            for i in range(n_requests)]


def run_overcommit(
    cfg, params, *, n_requests: int = 6, max_slots: int = 4, page_size: int = 16,
    prompt_len: int = 25, max_new: int = 56, prefill_chunk: int = 16,
    decode_quantum: int = 16, preempt: str = "swap", seed: int = 0,
) -> dict:
    """Burst trace against a pool of exactly one request's true footprint,
    ceil((prompt + max_new - 1) / page) blocks, which a reserve-up-front
    admission (prompt + max_new + quantum) could not even admit.  Also
    returns the streams (``tokens``: {rid: list})."""
    reqs = overcommit_requests(cfg, n_requests, prompt_len, max_new, seed)
    true_pages = -(-(prompt_len + max_new - 1) // page_size)
    reserve_pages = -(-(prompt_len + max_new + decode_quantum) // page_size)
    ecfg = EngineConfig(
        max_slots=max_slots, page_size=page_size,
        max_seq_len=prompt_len + max_new, prefill_chunk=prefill_chunk,
        decode_quantum=decode_quantum, num_blocks=1 + true_pages,
        fused=True, preempt=preempt,
    )
    eng = Engine(cfg, params, ecfg)
    t0 = time.perf_counter()
    results = eng.run(reqs)
    wall = time.perf_counter() - t0
    return {
        "n_requests": n_requests,
        "max_slots": max_slots,
        "usable_blocks": eng.pcfg.usable_blocks,
        "blocks_per_request_true": true_pages,
        "blocks_per_request_reserve_policy": reserve_pages,
        "reserve_policy_admissible": reserve_pages <= eng.pcfg.usable_blocks,
        "completed": sum(len(r.tokens) == max_new for r in results),
        "tok_s": sum(len(r.tokens) for r in results) / wall,
        "wall_s": wall,
        "preempt_mode": preempt,
        "preemptions": eng.stats["preemptions"],
        "swap_ins": eng.stats["swap_ins"],
        "readmissions": eng.stats["readmissions"],
        "tokens": {r.rid: [int(t) for t in r.tokens] for r in results},
    }


OVERCOMMIT_INTS = ("n_requests", "max_slots", "usable_blocks", "blocks_per_request_true",
                   "blocks_per_request_reserve_policy", "reserve_policy_admissible",
                   "completed", "preemptions", "swap_ins", "readmissions")


def run(
    arch: str = "gemma-2b",
    *,
    reduced: bool = True,
    layers: int | None = None,
    params=None,
    n_requests: int = 64,
    max_slots: int = 8,
    min_prompt: int = 4,
    max_prompt: int = 16,
    min_gen: int = 2,
    max_gen: int = 128,
    rate: float = 500.0,
    sample_every: int = 0,
    page_size: int = 16,
    prefill_chunk: int = 16,
    decode_quantum: int = 16,
    passes: int = 5,
    seed: int = 0,
    overcommit: bool = True,
    device=None,
) -> dict:
    """The reference's benchmark: the chat-shaped trace served static, split
    and fused, best of ``passes`` interleaved, then the over-committed
    burst.  ``params`` (e.g. a deployment) replaces the fp init of
    ``arch``; ``layers`` cuts the depth.  On the card each engine reports
    the graphs it captured and the memory they reserve, and one pass of
    the fused engine and of the static server is traced."""
    dev = resolve_device(device)
    cfg = get_arch(arch, reduced=reduced)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if params is None:
        params = api.init(prng.PRNGKey(seed), cfg, device=dev)
    trace = make_trace(
        cfg, n_requests, min_prompt=min_prompt, max_prompt=max_prompt,
        min_gen=min_gen, max_gen=max_gen, rate=rate, seed=seed, sample_every=sample_every,
    )

    static = StaticServer(cfg, params, max_slots, max_prompt, max_gen)
    buckets = set()
    for lo in range(0, len(trace), max_slots):
        group = trace[lo : lo + max_slots]
        buckets.add(_bucket(max(r.max_new_tokens for r in group), max_gen))
    static.warmup(buckets)
    ekw = dict(
        max_slots=max_slots, page_size=page_size,
        max_seq_len=max_prompt + max_gen, prefill_chunk=prefill_chunk,
        decode_quantum=decode_quantum,
    )
    eng_split = Engine(cfg, params, EngineConfig(fused=False, **ekw))
    eng_fused = Engine(cfg, params, EngineConfig(fused=True, **ekw))
    for w in range(2):  # warm: the buckets this trace reaches (graphs on the card)
        eng_split.run(_retrace(trace, 900 + w))
        eng_fused.run(_retrace(trace, 910 + w))

    rs, rsp, re = None, None, None
    for p in range(passes):
        cand = static.run(_retrace(trace, 100 + p))
        if rs is None or cand["wall_s"] < rs["wall_s"]:
            rs = cand
        cand = _engine_pass(eng_split, trace, 200 + p)
        if rsp is None or cand["wall_s"] < rsp["wall_s"]:
            rsp = cand
        cand = _engine_pass(eng_fused, trace, p)
        if re is None or cand["wall_s"] < re["wall_s"]:
            re = cand
    for r, eng in ((re, eng_fused), (rsp, eng_split)):
        r["compiled_variants"] = len(eng._shapes_seen)
        r["graphs"] = dict(eng.graph_stats)
    busy = {}
    if dev.type == "cuda":
        busy = {"engine": busy_share(lambda: _engine_pass(eng_fused, trace, 50)),
                "static": busy_share(lambda: static.run(_retrace(trace, 60)))}

    res = {
        "arch": arch,
        "reduced": reduced,
        "layers": cfg.n_layers,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "trace": {
            "n_requests": n_requests, "rate_req_s": rate,
            "prompt_len": [min_prompt, max_prompt], "gen_len": [min_gen, max_gen],
            "sample_every": sample_every,
            "total_tokens": sum(r.max_new_tokens for r in trace),
        },
        "max_slots": max_slots,
        "engine_config": {
            "page_size": page_size, "prefill_chunk": prefill_chunk,
            "decode_quantum": decode_quantum,
        },
        "static": rs,
        "engine_split": rsp,
        "engine": re,
        "speedup_tok_s": re["tok_s"] / max(rs["tok_s"], 1e-9),
        "fused_vs_split_tok_s": re["tok_s"] / max(rsp["tok_s"], 1e-9),
        "p50_latency_ratio": rs["p50_latency_ms"] / max(re["p50_latency_ms"], 1e-9),
        "device_busy": busy,
    }
    if overcommit:
        res["overcommit"] = run_overcommit(
            cfg, params, max_slots=min(max_slots, 4), page_size=page_size,
            prefill_chunk=prefill_chunk, decode_quantum=decode_quantum,
        )
        res["overcommit"].pop("tokens")
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--full-size", action="store_true", help="no --reduced config")
    ap.add_argument("--layers", type=int, default=None, help="cut the depth to N layers")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--rate", type=float, default=500.0)
    ap.add_argument("--quick", action="store_true", help="CI smoke shapes")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero if the fused engine falls below the static baseline "
                         "or the split engine, or the over-committed trace fails to complete")
    ap.add_argument("--check-threshold", type=float, default=0.9,
                    help="minimum engine/static and fused/split tok/s ratios for --check")
    args = ap.parse_args()

    kw = dict(n_requests=args.requests, max_slots=args.slots, rate=args.rate)
    if args.quick:
        kw = dict(n_requests=48, max_slots=4, rate=1000.0, max_prompt=12, max_gen=64,
                  prefill_chunk=16, decode_quantum=8, passes=4)

    banner("Engine throughput — fused vs split vs static lockstep")
    res = run(args.arch, reduced=not args.full_size, layers=args.layers, device=args.device,
              **kw)
    for name in ("static", "engine_split", "engine"):
        r = res[name]
        print(f"  {name:12s} {r['tok_s']:9.1f} tok/s   p50 {r['p50_latency_ms']:8.1f} ms   "
              f"p95 {r['p95_latency_ms']:8.1f} ms   ttft p50 {r['p50_ttft_ms']:8.1f} ms")
    print(f"  fused vs static: {res['speedup_tok_s']:.2f}x tok/s, "
          f"{res['p50_latency_ratio']:.2f}x lower p50 latency; "
          f"fused vs split: {res['fused_vs_split_tok_s']:.2f}x "
          f"({res['engine']['compiled_variants']} fused-engine variants, "
          f"{res['engine']['graphs']['captured']} graphs)")
    oc = res.get("overcommit")
    if oc:
        print(f"  overcommit: {oc['completed']}/{oc['n_requests']} completed on "
              f"{oc['usable_blocks']} blocks ({oc['blocks_per_request_true']}/request true, "
              f"{oc['blocks_per_request_reserve_policy']}/request reserve policy), "
              f"{oc['preemptions']} preemptions, {oc['swap_ins']} swap-ins")
    save_json("BENCH_engine", res)
    if args.check:
        failures = []
        if res["speedup_tok_s"] < args.check_threshold:
            failures.append(f"engine/static tok/s {res['speedup_tok_s']:.2f} "
                            f"< {args.check_threshold}")
        if res["fused_vs_split_tok_s"] < args.check_threshold:
            failures.append(f"fused/split tok/s {res['fused_vs_split_tok_s']:.2f} "
                            f"< {args.check_threshold}")
        if oc and (oc["completed"] < oc["n_requests"] or oc["preemptions"] < 1):
            failures.append(f"overcommit incomplete: {oc['completed']}/{oc['n_requests']} "
                            f"with {oc['preemptions']} preemptions")
        for f in failures:
            print(f"  CHECK FAILED: {f}", file=sys.stderr)
        if failures:
            sys.exit(1)


if __name__ == "__main__":
    main()
