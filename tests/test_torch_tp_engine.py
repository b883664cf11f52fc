"""The port's tensor-parallel engine (``Engine(tp=n)``) against the JAX
package's, on the CPU.

Reduced yi-6b (4 heads, 2 KV heads, d_ff 160: at tp = 2 attention and MLP
shard, at tp = 4 the MLP alone, attention replicated with its reason), f32,
params converted from the reference's ``api.init``, packed deployments
from the same plan.  Both engines are driven with ``submit`` +
``step(now)`` on one clock; every request's tokens and status and every
``stats`` counter must be equal: fused under block pressure with swap and
with recompute preemption (tp = 2, packed), and split (tp = 4, fp).  The
reference engines of one (fused, num_blocks, tp, tree) share their
compiled dispatches (``dispatch_from``).  Port-only checks:
the TP pools' shard axis, ``export_state`` / ``resume`` and ``hot_swap``
under TP, and ``dispatch_from`` refusing another plan.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget
from repro.core import planner as jplanner
from repro.launch import engine as jeng
from repro.models import api as japi
from repro_torch.configs import get_arch
from repro_torch.convert import from_numpy_tree
from repro_torch.core import planner
from repro_torch.launch import engine as teng
from repro_torch.launch import serve

SHAPES = dict(max_slots=4, page_size=8, max_seq_len=32, prefill_chunk=8, decode_quantum=4)
PLAN = dict(p_stuck=0.5, min_size=1024)
MIXED = [(11, 5, True, 0), (7, 8, False, 3), (19, 3, True, 1), (4, 1, True, 0),
         (9, 9, False, 5), (14, 6, True, 2)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sides():
    jcfg, cfg = jget("yi-6b", reduced=True), get_arch("yi-6b", reduced=True)
    jp = japi.init(jax.random.PRNGKey(0), jcfg)
    p = from_numpy_tree(jax.tree.map(np.asarray, jp), device="cpu")
    jplan = jplanner.build_deployment(jp, jplanner.CrossbarSpec(), jplanner.PlannerConfig(**PLAN))
    tplan = planner.build_deployment(p, planner.CrossbarSpec(), planner.PlannerConfig(**PLAN),
                                     device="cpu")
    return {"ref": (jeng, jcfg, {"fp": jp, "packed": jplanner.deploy_params(
                jp, jplan, materialize="packed")}, {}),
            "port": (teng, cfg, {"fp": p, "packed": planner.deploy_params(
                p, tplan, materialize="packed")}, {})}


def _requests(mod, specs):
    out = []
    for rid, (plen, gen, greedy, seed) in enumerate(specs):
        prompt = np.random.default_rng(100 + rid).integers(0, 256, plen).astype(np.int32)
        out.append(mod.Request(rid=rid, prompt=prompt, max_new_tokens=gen, greedy=greedy,
                               seed=seed))
    return out


def _run(side, tp, mat, specs=MIXED, **kw):
    mod, cfg, trees, bases = side
    ecfg = mod.EngineConfig(**{**SHAPES, **kw})
    key = (ecfg.fused, ecfg.num_blocks, tp, mat)
    eng = mod.Engine(cfg, trees[mat], ecfg, tp=tp, dispatch_from=bases.get(key))
    bases.setdefault(key, eng)
    for r in _requests(mod, specs):
        eng.submit(r)
    now = 0.0
    while eng.waiting or any(s is not None for s in eng.slots):
        eng.step(now)
        now += 1.0
    res = {rid: (list(map(int, r.tokens)), r.status) for rid, r in sorted(eng.results.items())}
    stats = {k: v for k, v in eng.stats.items() if k != "compiled_variants"}
    return res, stats, eng


@pytest.mark.parametrize("tp,mat,kw", [
    (2, "packed", dict(fused=True, num_blocks=6, preempt="swap")),
    (2, "packed", dict(fused=True, num_blocks=6, preempt="recompute")),
    (4, "fp", dict(fused=False)),
])
def test_tp_engine_matches_reference(sides, tp, mat, kw):
    want = _run(sides["ref"], tp, mat, **kw)
    got = _run(sides["port"], tp, mat, **kw)
    assert got[1] == want[1]
    assert got[0] == want[0]
    if "num_blocks" in kw:  # five blocks of eight cells: the trace preempts
        assert got[1]["preemptions"] > 0
        assert got[1]["swap_ins" if kw["preempt"] == "swap" else "readmissions"] > 0


def test_tp_engine_layout_resume_and_hot_swap(sides):
    """Pools carry the shard axis only where attention is sharded; a request
    exported from a TP engine resumes on another to its solo stream; a hot
    swap serves the new epoch; ``dispatch_from`` refuses another plan."""
    mod, cfg, trees, _ = sides["port"]
    ecfg = mod.EngineConfig(**SHAPES)
    e2 = mod.Engine(cfg, trees["packed"], ecfg, tp=2)
    e4 = mod.Engine(cfg, trees["packed"], ecfg, tp=4)
    assert e2.pools[0]["k"].shape[:2] == (cfg.n_layers, 2) and e2._tp.attn
    assert e4.pools[0]["k"].ndim == 4 and not e4._tp.attn and e4._tp.mlp
    assert "n_kv_heads 2 % 4" in e4._tp.reasons["attn"]
    with pytest.raises(ValueError, match="tensor-parallel layout"):
        mod.Engine(cfg, trees["packed"], ecfg, tp=4, dispatch_from=e2)

    req = _requests(mod, [(9, 8, False, 7)])[0]
    solo, _ = serve.generate(cfg, trees["packed"], {"tokens": torch.from_numpy(req.prompt)[None]},
                             gen_len=8, greedy=False, seed=7)
    e2.submit(req)
    e2.step(0.0)
    rec = e2.evict(req.rid, snapshot=True)
    assert rec is not None and rec.snapshot is not None
    other = mod.Engine(cfg, trees["packed"], ecfg, tp=2, dispatch_from=e2)
    other.resume(rec)
    res = other.run([])  # drain the resumed request
    assert res == []
    assert other.results[req.rid].tokens == solo[0].tolist()

    assert e2.hot_swap(trees["fp"])
    req2 = _requests(mod, [(6, 5, True, 0)])[0]
    out = e2.run([req2])[0]
    fp_solo, _ = serve.generate(cfg, trees["fp"], {"tokens": torch.from_numpy(req2.prompt)[None]},
                                gen_len=5)
    assert out.tokens == fp_solo[0].tolist()
