"""The port's continuous-batching engine against the JAX package's, on the CPU.

Both engines are driven with ``submit`` + ``step(now)`` on one synthetic
clock through the same scenarios; every request's tokens and status, every
``stats`` counter and the set of bucketed dispatch shapes must be
identical: fused and split, swap and recompute under block pressure, EOS
mid-stream, deadlines in a slot and in the queue, cancellation, the
priority-class victim key, ``export_state`` / ``evict`` -> ``resume`` on a
second engine, ``hot_swap`` with epoch pinning and its rollback, and the
dense / packed / const_rle / planes_int8 deployments.  Reduced gemma-2b
(f32), params converted from the reference's ``api.init``.  Buckets are
kept few (4 slots, page 8, chunk 8, quantum 4) and each configuration's
engines share their dispatches (``dispatch_from``), so the reference
compiles each bucket once.
"""
from __future__ import annotations

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from benchmarks_torch import engine_throughput as et
from repro.configs import get_arch as jax_get_arch
from repro.core import planner as jplanner
from repro.launch import engine as jeng
from repro.models import api as japi
from repro_torch import prng
from repro_torch.configs import get_arch
from repro_torch.convert import from_numpy_tree
from repro_torch.core import planner
from repro_torch.launch import engine as teng
from repro_torch.launch import serve
from repro_torch.models import api

# one pool of 12 usable blocks of 8 cells for every engine (a new pool shape
# is a new compile for each of the reference's buckets): three requests
# near max_seq_len already ask for them all
SHAPES = dict(max_slots=4, page_size=8, max_seq_len=32, prefill_chunk=8, decode_quantum=4,
              num_blocks=13)
PLAN = dict(p_stuck=0.5, min_size=1024)
LOGIT_TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's engine on the CPU runs thousands of tiny ops: one intra-op
    thread each (the suite's workers share the cores), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Side:
    """One package's engine module, config, params and deployments, with one
    shared-dispatch base engine per (fused, num_blocks, page_size)."""

    def __init__(self, mod, cfg, params, plan_fn, params_b=None):
        self.mod, self.cfg, self.params, self.params_b = mod, cfg, params, params_b
        self._plan_fn, self._plan, self._deployed, self._base = plan_fn, None, {}, {}

    def deployed(self, materialize: str):
        if materialize == "fp":
            return self.params
        if materialize not in self._deployed:
            if self._plan is None:
                self._plan = self._plan_fn(self.params)
            mat, _, codec = materialize.partition(":")
            self._deployed[materialize] = self.deploy(mat, codec or "raw")
        return self._deployed[materialize]

    def deploy(self, mat, codec):
        planner_mod = jplanner if self.mod is jeng else planner
        return planner_mod.deploy_params(self.params, self._plan, materialize=mat, codec=codec)

    def engine(self, params=None, **kw):
        ecfg = self.mod.EngineConfig(**{**SHAPES, **kw})
        key = (ecfg.fused, ecfg.num_blocks, ecfg.page_size)
        base = self._base.get(key)
        eng = self.mod.Engine(self.cfg, self.params if params is None else params, ecfg,
                              dispatch_from=base)
        self._base.setdefault(key, eng)
        return eng


@pytest.fixture(scope="module")
def sides():
    jcfg = jax_get_arch("gemma-2b", reduced=True)
    jparams, jparams_b = (japi.init(jax.random.PRNGKey(k), jcfg) for k in (0, 1))
    tparams, tparams_b = (from_numpy_tree(jax.tree.map(np.asarray, p), device="cpu")
                          for p in (jparams, jparams_b))
    spec = dict(p_stuck=PLAN["p_stuck"], min_size=PLAN["min_size"])
    ref = Side(jeng, jcfg, jparams, lambda p: jplanner.build_deployment(
        p, jplanner.CrossbarSpec(), jplanner.PlannerConfig(**spec)), jparams_b)
    port = Side(teng, get_arch("gemma-2b", reduced=True), tparams,
                lambda p: planner.build_deployment(p, planner.CrossbarSpec(),
                                                   planner.PlannerConfig(**spec), device="cpu"),
                tparams_b)
    return {"ref": ref, "port": port}


def _requests(mod, specs, vocab):
    """specs: (prompt_len, max_new, greedy, seed[, extra Request fields])."""
    out = []
    for rid, (plen, gen, greedy, seed, *extra) in enumerate(specs):
        prompt = np.random.default_rng(100 + rid).integers(0, vocab, plen).astype(np.int32)
        out.append(mod.Request(rid=rid, prompt=prompt, max_new_tokens=gen, greedy=greedy,
                               seed=seed, **(extra[0] if extra else {})))
    return out


def _drain(eng, now=0.0, dt=1.0, limit=500):
    while eng.waiting or any(s is not None for s in eng.slots):
        eng.step(now)
        now += dt
        limit -= 1
        assert limit, "engine did not drain"
    return now


def _record(*engines):
    """Everything observable of the engines: results, stats, shapes."""
    out = []
    for eng in engines:
        res = {rid: (list(map(int, r.tokens)), r.status, r.t_admitted, r.t_first_token, r.t_done)
               for rid, r in sorted(eng.results.items())}
        stats = {k: v for k, v in eng.stats.items() if k != "compiled_variants"}
        out.append((res, stats, sorted(eng._shapes_seen)))
    return out


MIXED = [(11, 5, True, 0), (7, 8, False, 3), (19, 3, True, 1), (4, 1, True, 0),
         (9, 9, False, 5), (14, 6, True, 2)]


def scenario_mixed(side, fused=True, materialize="fp"):
    """More requests than slots, prompts over one chunk, greedy and sampled."""
    eng = side.engine(side.deployed(materialize), fused=fused)
    for r in _requests(side.mod, MIXED, side.cfg.vocab_size):
        eng.submit(r)
    _drain(eng)
    return _record(eng)


PRESSURE = [(9, 20, True, 0), (11, 18, False, 3), (8, 22, True, 1), (6, 24, False, 4),
            (5, 12, True, 7)]


def scenario_pressure(side, fused, preempt, victim_key=None):
    """12 usable blocks against 16 blocks of concurrent demand."""
    kw = {} if victim_key is None else {"victim_key": getattr(side.mod, victim_key)}
    eng = side.engine(fused=fused, preempt=preempt, **kw)
    reqs = _requests(side.mod, PRESSURE, side.cfg.vocab_size)
    if victim_key is not None:
        reqs[0].priority_class = 2  # the earliest arrival is the batch tier
    for r in reqs:
        eng.submit(r)
    _drain(eng)
    return _record(eng)


def scenario_eos(side, eos):
    """EOS ids taken from the mixed streams: retire at that token."""
    specs = [s + ({"eos_id": e},) for s, e in zip(MIXED, eos)]
    eng = side.engine()
    for r in _requests(side.mod, specs, side.cfg.vocab_size):
        eng.submit(r)
    _drain(eng)
    return _record(eng)


def scenario_deadlines(side):
    """Four long requests fill the slots; the first times out mid-decode,
    a queued one times out before admission, the rest finish."""
    specs = [(5, 20, True, 0, {"deadline_s": 2.5}), (6, 20, False, 1), (7, 18, True, 2),
             (4, 16, True, 3), (6, 4, True, 4, {"deadline_s": 1.5}), (5, 3, False, 5)]
    eng = side.engine()
    for r in _requests(side.mod, specs, side.cfg.vocab_size):
        eng.submit(r)
    _drain(eng, dt=0.5)
    return _record(eng)


def scenario_cancel(side):
    eng = side.engine()
    for r in _requests(side.mod, MIXED, side.cfg.vocab_size):
        eng.submit(r)
    eng.step(0.0)
    eng.step(1.0)
    flags = [eng.cancel(1, now=1.5), eng.cancel(1, now=1.5), eng.cancel(99, now=1.5),
             eng.cancel(5, now=1.5)]
    _drain(eng, now=2.0)
    return _record(eng) + [flags, eng.kv.allocator.free_blocks]


def _resume_view(rec):
    """A ResumeState's fields, the KV copy by its shapes (its values are
    compared within a tolerance: :func:`_snapshots`)."""
    snap = None if rec.snapshot is None else [
        np.shape(a) for a in jax.tree.leaves(rec.snapshot)]
    return (rec.req.rid, rec.n_live, list(map(int, rec.generated)), int(rec.tok_next),
            np.asarray(rec.key).astype(np.int64).tolist(), snap, rec.epoch)


def _snapshots(recs):
    return [np.asarray(a) for r in recs if r is not None and r.snapshot is not None
            for a in jax.tree.leaves(r.snapshot)]


RESUME = [(11, 14, True, 0), (7, 16, False, 3), (19, 10, True, 1), (4, 12, True, 6),
          (9, 9, False, 5), (14, 10, True, 2)]


def scenario_resume(side, fused=True):
    """Hedging (``export_state`` of a decoding and a queued request) and
    draining (``evict`` with and without the KV copy, and of a queued
    request) onto a second engine."""
    a, b = side.engine(fused=fused), side.engine(fused=fused)
    for r in _requests(side.mod, RESUME, side.cfg.vocab_size):
        a.submit(r)
    now = 0.0
    for _ in range(2):
        a.step(now)
        now += 1.0
    recs = [a.export_state(1), a.export_state(5), a.export_state(42)]
    moved = [a.evict(3, snapshot=True), a.evict(2, snapshot=True), a.evict(0), a.evict(4)]
    views = [None if r is None else _resume_view(r) for r in recs + moved]
    snaps = _snapshots(moved)
    for r in recs[:2] + moved:
        b.resume(r)
    _drain(a, now)
    _drain(b, now)
    return _record(a, b) + [views], snaps


def scenario_hot_swap(side):
    """Epoch pinning across a swap to another checkpoint, a failed swap
    rolled back, and the old epoch retired once its requests drain."""
    eng = side.engine()
    reqs = _requests(side.mod, MIXED, side.cfg.vocab_size)
    for r in reqs[:3]:
        eng.submit(r)
    now = 0.0
    while not any(s is not None and s.generated for s in eng.slots):
        eng.step(now)
        now += 1.0

    def fail():
        raise RuntimeError("programming failed")

    ok = [eng.hot_swap(fail), eng.hot_swap(lambda: side.params_b)]
    for r in reqs[3:]:
        eng.submit(r)
    _drain(eng, now)
    return _record(eng) + [ok, eng.params_epoch, sorted(eng._params)]


SCENARIOS = {
    "fused": lambda s: scenario_mixed(s, fused=True),
    "split": lambda s: scenario_mixed(s, fused=False),
    "swap-fused": lambda s: scenario_pressure(s, True, "swap"),
    "recompute-fused": lambda s: scenario_pressure(s, True, "recompute"),
    "swap-split": lambda s: scenario_pressure(s, False, "swap"),
    "recompute-split": lambda s: scenario_pressure(s, False, "recompute"),
    "priority-class": lambda s: scenario_pressure(s, True, "swap", "priority_class_victim_key"),
    "deadlines": scenario_deadlines,
    "cancel": scenario_cancel,
    "resume-fused": lambda s: scenario_resume(s, fused=True),
    "resume-split": lambda s: scenario_resume(s, fused=False),
    "hot-swap": scenario_hot_swap,
    "dense": lambda s: scenario_mixed(s, materialize="dense"),
    "packed": lambda s: scenario_mixed(s, materialize="packed"),
    "const_rle": lambda s: scenario_mixed(s, materialize="packed:const_rle"),
    "planes_int8": lambda s: scenario_mixed(s, materialize="planes_int8"),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_engine_scenario_matches_reference(sides, name):
    got, want = (SCENARIOS[name](sides[k]) for k in ("port", "ref"))
    if name.startswith("resume"):  # the swapped-out KV cells: computed values
        (got, snaps), (want, want_snaps) = got, want
        assert len(snaps) == len(want_snaps) == 4  # two copies, k and v each
        for a, b in zip(snaps, want_snaps):
            np.testing.assert_allclose(a, b, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert got == want
    stats = got[0][1]
    if name.startswith(("swap", "recompute", "priority")):
        assert stats["preemptions"] >= 1
        assert stats["readmissions"] == stats["preemptions"]
        assert (stats["swap_ins"] >= 1) == name.startswith(("swap", "priority"))
    if name == "split":
        assert stats["fused_dispatches"] == 0 and stats["prefill_dispatches"] >= 2
    if name == "fused":
        assert stats["fused_dispatches"] >= 1
    if name == "deadlines":
        assert stats["timeouts"] == 2
    if name == "hot-swap":
        assert stats["hot_swaps"] == 1 and stats["swap_rollbacks"] == 1
        assert stats["epochs_retired"] == 1


def test_engine_eos_matches_reference(sides):
    """EOS at the third token of four requests, never for two."""
    streams = scenario_mixed(sides["ref"])[0][0]
    eos = [streams[0][0][2], streams[1][0][2], -1, streams[3][0][0], streams[4][0][2], -1]
    got, want = scenario_eos(sides["port"], eos), scenario_eos(sides["ref"], eos)
    assert got == want
    assert len(got[0][0][1][0]) <= 3 < len(streams[1][0])


def test_engine_streams_equal_solo_generate(sides):
    """The engine's streams are those of the port's solo ``serve.generate``
    (batch 1, the request's seed, greedy or sampled)."""
    side = sides["port"]
    streams = scenario_mixed(side, fused=True)[0][0]
    for r in _requests(teng, MIXED, side.cfg.vocab_size):
        toks, _ = serve.generate(side.cfg, side.params,
                                 {"tokens": torch.from_numpy(r.prompt.astype(np.int64))[None]},
                                 gen_len=r.max_new_tokens, greedy=r.greedy, seed=r.seed)
        assert streams[r.rid][0] == toks[0].tolist(), f"rid {r.rid}"


def test_engine_prewarm_and_run(sides):
    """``prewarm`` builds the reference's variant grid (the reference's own
    prewarm walked with its dispatches stubbed out: it would compile every
    bucket); ``run`` serves on the wall clock with the streams of the
    synthetic-clock run."""
    side = sides["port"]
    eng = side.engine(fused=True)
    ref = sides["ref"].engine(fused=True)
    ref._decode_loops = {q: (lambda p, pools, *a: (None, pools, None)) for q in ref._decode_loops}
    ref._prefill_step = lambda p, pools, *a: (None, None, pools)
    ref._fused_steps = {q: (lambda p, pools, *a: (None, None, None, pools))
                        for q in ref._fused_steps}
    n = eng.prewarm()
    assert n == ref.prewarm() and eng._shapes_seen == ref._shapes_seen
    assert eng.graph_stats["captured"] == 0  # the CPU runs each dispatch eagerly
    results = eng.run(_requests(teng, MIXED, side.cfg.vocab_size))
    want = scenario_mixed(side)[0][0]
    assert [list(map(int, r.tokens)) for r in results] == [want[i][0] for i in range(len(MIXED))]
    assert eng.stats["compiled_variants"] == len(eng._shapes_seen)


def test_engine_validation(sides):
    side = sides["port"]
    cfg, params = side.cfg, side.params
    # tensor parallelism (A.15): tp = 2 shards the MLP (gemma's one KV head
    # keeps attention whole)
    tp_eng = teng.Engine(cfg, params, teng.EngineConfig(), tp=2)
    assert tp_eng._tp.mlp and not tp_eng._tp.attn and tp_eng.cfg_local.d_ff == cfg.d_ff // 2
    eng = side.engine(num_blocks=3)
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.submit(teng.Request(rid=0, prompt=np.arange(20), max_new_tokens=20))
    with pytest.raises(ValueError, match="usable blocks"):
        eng.submit(teng.Request(rid=0, prompt=np.arange(14), max_new_tokens=4))
    for bad in (dict(victim_key=42), dict(preempt="drop"), dict(num_blocks=1),
                dict(max_slots=0)):
        with pytest.raises(ValueError):
            teng.EngineConfig(**bad)
    with pytest.raises(ValueError, match="dispatch_from"):
        teng.Engine(cfg, params, teng.EngineConfig(**{**SHAPES, "page_size": 4}),
                    dispatch_from=side.engine())
    with pytest.raises(ValueError, match="scrub interval"):
        side.engine().attach_scrub(object(), every=0)
    assert eng.device.type == "cpu" and eng.pools[0]["k"].device.type == "cpu"


def test_health_monitor_matches_reference(sides):
    """Shadow-batch KL of a deployment against fp, and the breach run."""
    recs = {}
    for name, side in sides.items():
        if name == "ref":
            batch = japi.make_batch(side.cfg, jax.random.PRNGKey(0), 2, 8)
        else:
            batch = api.make_batch(side.cfg, prng.PRNGKey(0), 2, 8, device="cpu")
        mon = side.mod.HealthMonitor(side.cfg, side.params, batch,
                                     side.mod.HealthConfig(kl_threshold=1e-9,
                                                           consecutive_breaches=2))
        recs[name] = [mon.check(side.deployed("dense")), mon.check(side.params),
                      mon.check(side.deployed("dense")), mon.check(side.deployed("dense"))]
    for (t, rt), (w, rw) in zip(recs["port"], recs["ref"]):
        assert t == w and rt["breaches"] == rw["breaches"]
        np.testing.assert_allclose(rt["kl"], rw["kl"], rtol=0.05, atol=1e-9)
    assert [t for t, _ in recs["port"]] == [False, False, False, True]


# ---------------------------------------------------------------------------
# The engine benchmark and the golden file's parity cell
# ---------------------------------------------------------------------------

GOLDEN = json.loads((Path(__file__).resolve().parents[1] / "benchmarks_torch" / "golden"
                     / "reference.json").read_text())["engine"]


def test_make_trace_matches_reference(sides):
    """The port's trace draws the reference's prompts, lengths and arrival
    times; ``sample_every`` only flips every k-th request to sampled."""
    from benchmarks import engine_throughput as jet

    cfg = sides["port"].cfg
    want = jet.make_trace(sides["ref"].cfg, 12, max_prompt=30, seed=3)
    for k in (0, 4):
        got = et.make_trace(cfg, 12, max_prompt=30, seed=3, sample_every=k)
        for g, w in zip(got, want, strict=True):
            assert (g.rid, g.prompt.tolist(), g.max_new_tokens, g.arrival_time, g.seed) == \
                (w.rid, w.prompt.tolist(), w.max_new_tokens, w.arrival_time, w.seed)
            assert g.greedy == (not k or g.rid % k != k - 1)
    assert all(r.arrival_time == 0.0 for r in et.parity_requests(got))


@pytest.mark.parametrize("variant", [f"{m}/{'fused' if f else 'split'}"
                                     for m, f in et.PARITY_VARIANTS])
def test_parity_cell_matches_golden(sides, variant):
    """The golden file's reduced parity cell on the CPU: the reference's
    streams (a departure only at a recorded near tie), stats and shapes."""
    side = sides["port"]
    mat, mode = variant.split("/")
    want = GOLDEN["variants"][variant]
    eng = teng.Engine(side.cfg, side.deployed(mat),
                      teng.EngineConfig(fused=mode == "fused", **et.PARITY_ENGINE))
    streams = et.serve_parity(eng, et.parity_requests(et.make_trace(side.cfg, **et.PARITY_TRACE)))
    for rid, toks in streams.items():
        w = want["tokens"][str(rid)]
        d = next((i for i, (a, b) in enumerate(zip(toks, w)) if a != b), None)
        assert d is None or d in want["near_ties"][str(rid)], (rid, toks, w)
        assert len(toks) == len(w)
    assert {k: v for k, v in eng.stats.items()} == want["stats"]
    assert sorted(map(list, eng._shapes_seen)) == want["shapes"]
    assert GOLDEN["plan"] == et.PARITY_PLAN and GOLDEN["trace"] == et.PARITY_TRACE


@pytest.mark.parametrize("mode", ["swap", "recompute"])
def test_overcommit_matches_golden(sides, mode):
    side = sides["port"]
    got = et.run_overcommit(side.cfg, side.params, preempt=mode)
    assert {k: got[k] for k in et.OVERCOMMIT_INTS} == GOLDEN["overcommit"][mode]
    assert got["completed"] == got["n_requests"] and len(got["tokens"]) == got["n_requests"]


def test_engine_benchmark_quick_on_cpu(monkeypatch, sides):
    monkeypatch.setattr(et, "save_json", lambda name, res: None)
    res = et.run(n_requests=8, max_slots=4, max_prompt=10, max_gen=12, prefill_chunk=8,
                 decode_quantum=4, passes=1, sample_every=4, device="cpu")
    for name in ("static", "engine_split", "engine"):
        assert res[name]["tok_s"] > 0 and res[name]["p95_ttft_ms"] >= res[name]["p50_ttft_ms"]
    assert res["engine"]["fused_dispatches"] >= 1 and res["engine_split"]["fused_dispatches"] == 0
    assert res["engine"]["graphs"]["captured"] == 0 and res["device_busy"] == {}
    oc = res["overcommit"]
    assert oc["completed"] == oc["n_requests"] and oc["preemptions"] >= 1
