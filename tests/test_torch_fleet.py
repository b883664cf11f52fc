"""The port's serving fleet against the JAX package's, on the CPU.

The reference's ``repro.launch.fleet`` does not import on Python 3.11+
(ROADMAP C.1: its frozen ``FleetConfig`` has a mutable ``FaultPolicy``
class default).  A module-scoped fixture imports it with
``FaultPolicy.__hash__`` set for the import alone, then restores the class
and drops the module again.

Both fleets are driven with ``submit`` + ``step(now)`` on one synthetic
clock through scenarios where nothing depends on the wall clock (no
deadlines, a huge ``straggler_tolerance``, chaos keyed on replica steps,
stalls and hedging measured on the synthetic clock): every ``FleetResult``
(status, tokens, replica, attempts, hedged, completion time) and every
``fleet.stats`` counter must be equal — failover by resume and by restart,
hedge and cancel, drain / kill / restore, shed and degraded admission, and
a fleet of 2-shard tensor-parallel replicas.  Reduced gemma-2b (f32).
Also: ``FleetConfig`` validation and its C.1 repair, ``FaultInjector``
firing once per event.
"""
from __future__ import annotations

import dataclasses
import importlib
import sys
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget
from repro.models import api as japi
from repro_torch.configs import get_arch
from repro_torch.convert import from_numpy_tree
from repro_torch.launch import engine as teng
from repro_torch.launch import fleet as tfleet
from repro_torch.runtime.fault import FaultPolicy

ECFG = dict(max_slots=2, page_size=8, max_seq_len=64, prefill_chunk=16, decode_quantum=4)
CALM = dict(straggler_tolerance=1e9)  # no straggler marks from host walls


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jfleet():
    """The reference's fleet module, imported under the scoped hash shim."""
    from repro.runtime import fault

    fault.FaultPolicy.__hash__ = object.__hash__
    try:
        mod = importlib.import_module("repro.launch.fleet")
    finally:
        fault.FaultPolicy.__hash__ = None
    yield mod
    sys.modules.pop("repro.launch.fleet", None)
    launch = sys.modules.get("repro.launch")
    if launch is not None and hasattr(launch, "fleet"):
        delattr(launch, "fleet")


@pytest.fixture(scope="module")
def models():
    jcfg = jget("gemma-2b", reduced=True)
    jp = japi.init(jax.random.PRNGKey(0), jcfg)
    p = from_numpy_tree(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, get_arch("gemma-2b", reduced=True), p


def _trace(mod, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        prompt = rng.integers(0, 256, int(rng.integers(4, 11))).astype(np.int32)
        out.append(mod.Request(rid=i, prompt=prompt, max_new_tokens=int(rng.integers(6, 13)),
                               greedy=bool(i % 2), seed=i))
    return out


def _drive(fmod, emod, cfg, params, fcfg, chaos=(), ops=None, n_req=10, seed=1):
    """Submit a trace at t = 0, step on a synthetic clock (1 s a cycle)
    until every request has a result; ``ops[cycle]`` runs before that
    cycle's step (drain / kill / restore)."""
    inj = fmod.FaultInjector()
    for kind, args, kw in chaos:
        getattr(inj, kind)(*args, **kw)
    fleet = fmod.Fleet(cfg, params, fmod.FleetConfig(**fcfg), emod.EngineConfig(**ECFG),
                       injector=inj)
    reqs = _trace(emod, n_req, seed)
    for r in reqs:
        fleet.submit(r, 0.0)
    now = 0.0
    for cycle in range(300):
        for op, args in (ops or {}).get(cycle, []):
            getattr(fleet, op)(*args, now=now)
        fleet.step(now)
        now += 1.0
        if all(r.rid in fleet.results for r in reqs):
            break
    res = {rid: (list(map(int, r.tokens)), r.status, r.replica, r.attempts, r.hedged, r.t_done)
           for rid, r in sorted(fleet.results.items())}
    return res, dict(fleet.stats), [(e["replica"], e["step"], e["kind"]) for e in inj.log]


SCENARIOS = {
    # a crash with host state (resume failover) and a hedged stall
    "crash_resume_and_stall": dict(
        fcfg=dict(n_replicas=4, max_queue=64, hedge=True, hedge_stall_s=1.5, **CALM),
        chaos=[("crash", (0, 2), {}), ("stall", (1, 3, 3.0), {})]),
    # host state lost, restart failover, bounded queue (shed + degraded),
    # and a drain, a kill and a restore by hand
    "lost_state_admission_lifecycle": dict(
        fcfg=dict(n_replicas=3, max_queue=8, degrade_cap=4, hedge=False, failover="restart",
                  **CALM),
        chaos=[("crash", (0, 3), {"lose_state": True})],
        ops={2: [("drain", (1,))], 4: [("kill", (2,))], 6: [("restore", (2,)),
                                                             ("restore", (0,))]}),
    # two replicas of two tensor-parallel shards each
    "tp_replicas": dict(
        fcfg=dict(n_replicas=2, shards_per_replica=2, max_queue=64, hedge=False, **CALM),
        chaos=[("crash", (1, 3), {})]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_fleet_results_and_stats_match_reference(jfleet, models, name):
    jcfg, jp, cfg, p = models
    sc = SCENARIOS[name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the one-device TP emulation warning
        want = _drive(jfleet, jfleet, jcfg, jp, sc["fcfg"], sc["chaos"], sc.get("ops"))
        got = _drive(tfleet, teng, cfg, p, sc["fcfg"], sc["chaos"], sc.get("ops"))
    assert got[2] == want[2]
    assert got[1] == want[1]
    assert got[0] == want[0]
    assert want[1]["completed"] > 0


def test_fleet_config_validation_and_c1_repair():
    """The port's FleetConfig constructs on this Python (the reference's
    class does not import: C.1); each config owns its retry policy."""
    a, b = tfleet.FleetConfig(), tfleet.FleetConfig()
    assert a.retry == FaultPolicy(max_retries=3, backoff_s=0.0, jitter=0.5)
    assert a.retry is not b.retry
    assert dataclasses.fields(tfleet.FleetConfig)[
        [f.name for f in dataclasses.fields(tfleet.FleetConfig)].index("retry")
    ].default_factory is not dataclasses.MISSING
    assert a.degrade_at == 32 and tfleet.FleetConfig(degrade_backlog=5).degrade_at == 5
    for bad in (dict(n_replicas=0), dict(shards_per_replica=0), dict(max_queue=0),
                dict(failover="retry"), dict(hedge_stall_s=0), dict(hedge_after_marks=0)):
        with pytest.raises(ValueError):
            tfleet.FleetConfig(**bad)


def test_fault_injector_fires_each_event_once():
    inj = tfleet.FaultInjector()
    inj.crash(0, 2, lose_state=True)
    inj.stall(1, 1, 0.5)
    inj.slow(0, 1, 4.0, steps=2)
    inj.corrupt_probe(2, 0)
    inj.storm(1, 3, corrupt=1e-3, stuck=1e-4)
    assert [e.kind for e in inj.fire(0, 1, 0.0)] == ["slow"]
    assert inj.fire(0, 1, 0.1) == []
    assert [e.kind for e in inj.fire(0, 5, 0.2)] == ["crash"]
    assert [e.kind for e in inj.fire(1, 9, 0.3)] == ["stall", "storm"]
    assert [e.kind for e in inj.fire(2, 0, 0.4)] == ["corrupt_probe"]
    assert all(e.fired for e in inj.events)
    assert [(e["replica"], e["step"], e["kind"]) for e in inj.log] == [
        (0, 1, "slow"), (0, 5, "crash"), (1, 9, "stall"), (1, 9, "storm"),
        (2, 0, "corrupt_probe")]
    ev = inj.events[0]
    assert ev.lose_state and ev.at_step == 2


def test_fleet_replicas_share_one_prepared_tree(models):
    """Every replica (and a restored one) serves the one prepared tree and
    the template's step functions; each engine has its own KV pools."""
    _, _, cfg, p = models
    fleet = tfleet.Fleet(cfg, p, tfleet.FleetConfig(n_replicas=3),
                         teng.EngineConfig(**ECFG))
    engines = [r.engine for r in fleet.replicas]
    assert all(e.params is engines[0].params for e in engines)
    assert all(e._decode_loops is engines[0]._decode_loops for e in engines)
    assert engines[0].pools[0]["k"] is not engines[1].pools[0]["k"]
    fleet.kill(1)
    fleet.restore(1)
    assert fleet.replicas[1].engine.params is engines[0].params
    assert fleet.replicas[1].engine is not engines[1]
    with pytest.raises(ValueError):
        tfleet.Fleet(cfg, p, tfleet.FleetConfig(n_replicas=2), pools=[None])


def test_fleet_tp_replicas_on_device_groups(models, monkeypatch):
    """``shards_per_replica = 2`` over a host of four devices: the fleet
    carves contiguous groups with ``replica_submeshes``, warns that each
    replica runs its shards in turn on its group's first device, and serves
    the streams and counters of the one-device fleet; a group that would
    wrap non-contiguously is refused."""
    from repro_torch.launch import mesh

    _, _, cfg, p = models
    sc = SCENARIOS["tp_replicas"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = _drive(tfleet, teng, cfg, p, sc["fcfg"], sc["chaos"], n_req=4)
    cpu, other = torch.device("cpu"), torch.device("meta")
    monkeypatch.setattr(mesh, "_devices", lambda device: [cpu, other, cpu, other])
    with pytest.warns(UserWarning, match="first device of its group"):
        got = _drive(tfleet, teng, cfg, p, sc["fcfg"], sc["chaos"], n_req=4)
    assert got == want and want[1]["completed"] == 4
    with pytest.warns(UserWarning, match="first device of its group"):
        fleet = tfleet.Fleet(cfg, p, tfleet.FleetConfig(n_replicas=2, shards_per_replica=2),
                             teng.EngineConfig(**ECFG))
    assert [r.devices for r in fleet.replicas] == [[cpu, other]] * 2
    assert all(r.engine.device == cpu and r.engine._tp.n == 2 for r in fleet.replicas)
    monkeypatch.setattr(mesh, "_devices", lambda device: [cpu, other, cpu])
    with pytest.raises(ValueError, match="non-contiguously"):
        tfleet.Fleet(cfg, p, tfleet.FleetConfig(n_replicas=2, shards_per_replica=2),
                     teng.EngineConfig(**ECFG))
