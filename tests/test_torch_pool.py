"""The port's CrossbarPool against the JAX package, on the CPU.

Same packed planes (numpy, seeded) stream through the reference pool and
its port: assignments, seams, job costs, wear counters, crossbar state and
achieved planes must be identical, for every leveling, with and without bit
stucking.  The walk's ``state0``/wear extension is held against the
reference's scan, and the pool's own parity invariants (a) reset equals
stateless and (b) wear conservation are pinned on the port.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import planner as jplanner
from repro.core import pool as jpool
from repro.core import schedule as jsched
from repro.core import stucking as jstuck
from repro.core.planner import CrossbarSpec as JSpec
from repro_torch import prng
from repro_torch.core import planner, pool, schedule, stucking

SPECS = {"128x10": (128, 10), "64x8": (64, 8)}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _packed(s, seed, rows=128, cols=10) -> np.ndarray:
    """Packed planes with the structure SWS leaves: high planes mostly zero."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal(s * rows) * 40).astype(np.int64)
    q = np.clip(np.abs(q), 0, 2**cols - 1).reshape(s, rows)
    planes = (q[:, :, None] >> np.arange(cols)) & 1
    return np.packbits(planes.astype(np.uint8), axis=1)


def _assert_reports_equal(jr, tr):
    for f in ("assignment", "seam_costs", "chain_totals", "job_costs", "programmed_job_costs"):
        np.testing.assert_array_equal(np.asarray(getattr(jr, f)), getattr(tr, f), err_msg=f)
    for f in ("transitions_full", "transitions_programmed", "wear_increment_total",
              "wear_increment_max"):
        assert getattr(jr, f) == getattr(tr, f), f
    np.testing.assert_array_equal(np.asarray(jr.achieved), tr.achieved.numpy())
    np.testing.assert_array_equal(np.asarray(jr.achieved_read), tr.achieved_read.numpy())


# (sections, chains, schedule) of the three streamed tensors: fewer chains
# than crossbars, as many, and stride-L, so seams land on worn, fresh and
# rotated crossbars
STREAM = [(37, 4, "stride1"), (50, 6, "stride1"), (23, 5, "strideL")]


@pytest.mark.parametrize("p", [1.0, 0.5])
@pytest.mark.parametrize("leveling", ["none", "rotate", "lpt", "fault"])
def test_program_sequence_matches_reference(leveling, p):
    rows, cols = SPECS["128x10"]
    jp = jpool.CrossbarPool(JSpec(rows, cols), 6, leveling=leveling)
    tp = pool.CrossbarPool(planner.CrossbarSpec(rows, cols), 6, leveling=leveling, device="cpu")
    for i, (s, l, kind) in enumerate(STREAM):
        packed = _packed(s, seed=i)
        jr = jp.program(jnp.asarray(packed), jsched.make_chains(s, l, kind), p_stuck=p,
                        key=jax.random.PRNGKey(i), name=f"t{i}")
        tr = tp.program(_t(packed), schedule.make_chains(s, l, kind), p_stuck=p,
                        key=prng.PRNGKey(i), name=f"t{i}")
        _assert_reports_equal(jr, tr)
        np.testing.assert_array_equal(jp.wear, tp.wear)
        assert jp.state.tobytes() == tp.state.tobytes()
        np.testing.assert_array_equal(jp.wear_totals(), tp.wear_totals())
    assert jp.stats().to_dict(5e7) == tp.stats().to_dict(5e7)


@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("stuck_cols", [0, 1, 2])
def test_walk_with_state0_and_wear_matches_scan(spec, stuck_cols):
    rows, cols = SPECS[spec]
    packed = _packed(19, seed=20, rows=rows, cols=cols)
    state0 = _packed(1, seed=21, rows=rows, cols=cols)[0]
    order = np.random.default_rng(22).permutation(19)[:12].astype(np.int32)
    valid = np.arange(12) < 9
    jt, js, jc, jw = jstuck._walk_packed(
        jnp.asarray(packed), jnp.asarray(order), 0.5, jax.random.PRNGKey(7), rows=rows,
        stuck_cols=stuck_cols, include_initial=True, valid=jnp.asarray(valid),
        state0=jnp.asarray(state0), with_wear=True)
    tt, ts, tc, tw = stucking.walk_packed(
        _t(packed), _t(order).long()[None], 0.5, prng.PRNGKey(7)[None], rows=rows,
        stuck_cols=stuck_cols, include_initial=True, valid=_t(valid)[None],
        state0=_t(state0)[None], with_wear=True)
    assert int(jt) == int(tt[0])
    np.testing.assert_array_equal(np.asarray(js), ts[0].numpy())
    np.testing.assert_array_equal(np.asarray(jc), tc[0].numpy())
    np.testing.assert_array_equal(np.asarray(jw), tw[0].numpy())


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "a": {"w": _t(rng.standard_normal((96, 64)).astype(np.float32) * 0.02)},
        # row-padded: 64 * 100 = 6400 -> 100 sections of 64
        "b": {"w": _t(rng.standard_normal((64, 100)).astype(np.float32) * 0.02)},
    }


@pytest.mark.parametrize("p", [1.0, 0.5])
def test_pool_reset_parity(p):
    """(a) resetting the pool between tensors == stateless per-tensor plans.

    The port's stateless plan is itself a pristine pool's, so the reset pool
    is also held against the reference's stateless path."""
    spec = planner.CrossbarSpec(*SPECS["64x8"])
    cfg = planner.PlannerConfig(p_stuck=p, min_size=1024, crossbars=8)
    params = _params()
    plan = planner.build_deployment(params, spec, cfg, device="cpu")
    jplan = jplanner.build_deployment(
        {k: {"w": jnp.asarray(v["w"].numpy())} for k, v in params.items()},
        JSpec(*SPECS["64x8"]), jplanner.PlannerConfig(p_stuck=p, min_size=1024, crossbars=8))
    tpool = pool.CrossbarPool(spec, 8, device="cpu")
    keys = planner.tensor_keys(params, cfg)
    for name, w in planner.iter_weights(params, cfg):
        tpool.reset()
        rep, w_hat = planner.analyze_tensor(w, spec, cfg, keys[name], name=name, pool=tpool)
        assert rep == plan.reports[name]
        assert w_hat.numpy().tobytes() == plan.deployed[name].numpy().tobytes()
        a, b = dataclasses.asdict(jplan.reports[name]), dataclasses.asdict(rep)
        np.testing.assert_allclose(b.pop("quant_mse"), a.pop("quant_mse"), rtol=1e-6)
        assert a == b
        assert np.asarray(jplan.deployed[name]).tobytes() == w_hat.numpy().tobytes()


@pytest.mark.parametrize("p", [1.0, 0.5])
def test_pool_wear_conservation(p):
    """(b) the wear increments sum to the programmed transitions, seams included."""
    spec = planner.CrossbarSpec(*SPECS["64x8"])
    cfg = planner.PlannerConfig(p_stuck=p, min_size=1024, crossbars=8)
    tpool = pool.CrossbarPool(spec, 8, device="cpu")
    plan = planner.build_deployment(_params(), spec, cfg, pool=tpool, device="cpu")
    fin = sum(r.transitions_final for r in plan.reports.values())
    assert tpool.total_writes == fin == int(tpool.wear.sum())
    assert plan.pool_stats["total_writes"] == fin
    assert plan.pool_stats["max_cell_writes"] == int(tpool.wear.max())


def test_pool_reset_keeps_wear_by_default():
    tpool = pool.CrossbarPool(planner.CrossbarSpec(), 3, device="cpu")
    tpool.program(_t(_packed(6, seed=1)), schedule.make_chains(6, 3, "stride1"))
    assert tpool.total_writes > 0
    tpool.reset()
    assert np.all(tpool.state == 0) and tpool.total_writes > 0
    tpool.reset(wear=True)
    assert tpool.total_writes == 0 and int(tpool.wear.sum()) == 0
    assert tpool.stats().exhaustion_horizon() == float("inf")


def test_pool_validation_and_unported_parts():
    spec = planner.CrossbarSpec()
    tpool = pool.CrossbarPool(spec, 2, device="cpu")
    packed = _t(_packed(6, seed=0))
    with pytest.raises(ValueError):  # more chains than crossbars
        tpool.program(packed, schedule.make_chains(6, 3, "stride1"))
    with pytest.raises(ValueError):  # wrong geometry
        pool.CrossbarPool(planner.CrossbarSpec(64, 8), 2, device="cpu").program(
            packed, schedule.make_chains(6, 2, "stride1"))
    with pytest.raises(ValueError):
        pool.CrossbarPool(spec, 2, leveling="wearless", device="cpu")
    # pools price physical seams: include_initial=False raises with a pool,
    # and with a codec, whose stateless plan runs through one (the reference's rule)
    for kw, codec in (({"pool": tpool}, "raw"), ({}, "const_rle")):
        with pytest.raises(ValueError, match="no pool interpretation"):
            planner.analyze_tensor(_t(np.zeros((64, 64), np.float32)), spec,
                                   planner.PlannerConfig(include_initial=False, codec=codec),
                                   prng.PRNGKey(0), **kw)
    with pytest.raises(ValueError, match="unknown pool impl"):
        tpool.program(packed, schedule.make_chains(6, 2, "stride1"), impl="eager")
    # the bool oracle is ported: a twin pool's bool walk equals the packed one
    twin = pool.CrossbarPool(spec, 2, device="cpu")
    for p in (1.0, 0.5):
        want = twin.program(packed, schedule.make_chains(6, 2, "stride1"), p_stuck=p)
        got = tpool.program(packed, schedule.make_chains(6, 2, "stride1"), p_stuck=p,
                            impl="bool")
        np.testing.assert_array_equal(got.programmed_job_costs, want.programmed_job_costs)
        assert torch.equal(got.achieved, want.achieved)
        np.testing.assert_array_equal(tpool.wear, twin.wear)
        np.testing.assert_array_equal(tpool.state, twin.state)
    # faults and integrity are ported: a drawn fault state and a manager that
    # registers the next program
    from repro_torch.core import integrity, nonideal

    state = tpool.inject_faults(nonideal.FaultModel(stuck0=0.01, stuck1=0.01))
    assert tpool.faults is state and state.stuck0.device == tpool.device
    assert state.stuck0.shape == tpool.state.shape and int(state.fault_cells().sum()) > 0
    mgr = tpool.enable_integrity()
    assert tpool.integrity is mgr and isinstance(mgr.cfg, integrity.IntegrityConfig)
    rep = tpool.program(packed, schedule.make_chains(6, 2, "stride1"), name="t")
    assert list(mgr.tensors) == ["t"] and mgr.verify_all()
    assert torch.equal(mgr.tensors["t"].expected, rep.achieved_read)


def test_pool_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pool.CrossbarPool(planner.CrossbarSpec(), 2)
