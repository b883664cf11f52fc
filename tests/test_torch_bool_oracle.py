"""The port's ``impl="bool"`` oracle against the reference's, on the CPU.

The reference keeps an eager bool-plane twin of its packed planner and pool
(``planner._analyze_tensor_bool``, ``_prep_bool``, the pool's bool walk) as
its parity oracle.  The port's twin (``schedule.schedule_job_costs_looped``,
``stucking.walk_bool`` / ``stuck_chain``, ``bitslice.dequantize_from_planes``
and the bool branches of ``planner.analyze_tensor`` and
``pool.CrossbarPool.program``) is held here to the reference's bool
functions and to the port's own packed path: every integer, plane and
``w_hat`` byte identical, ``quant_mse`` within a relative 1e-6 of the
reference's float32 mean (the port sums in float64, on both of its paths).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitslice as jbits
from repro.core import planner as jplanner
from repro.core import pool as jpool
from repro.core import schedule as jsched
from repro.core import stucking as jstuck
from repro_torch import prng
from repro_torch.core import bitslice, planner, pool, schedule, stucking

QUANT_MSE_RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _weights(shape, seed=0, std=0.02) -> np.ndarray:
    w = (np.random.default_rng(seed).standard_normal(shape) * std).astype(np.float32)
    flat = w.reshape(-1)
    flat[:3] = [0.0, -0.0, flat[3]]  # +-0 and a duplicate magnitude: sort ties
    flat[4] = -flat[3]
    return w


def _planes(s, rows, cols, seed) -> np.ndarray:
    q = np.abs(np.random.default_rng(seed).standard_normal((s, rows)) * 40).astype(np.int64)
    q = np.clip(q, 0, 2**cols - 1)
    return ((q[:, :, None] >> np.arange(cols)) & 1).astype(bool)


def _same_report(jr, tr, what=""):
    for f in ("name", "shape", "n_weights", "n_sections", "transitions_baseline",
              "transitions_sws", "transitions_final", "lockstep_time_unsorted",
              "lockstep_time_greedy", "lockstep_time_ideal", "scale", "offset"):
        assert getattr(jr, f) == getattr(tr, f), (what, f)
    assert tr.quant_mse == pytest.approx(jr.quant_mse, rel=QUANT_MSE_RTOL), what


def _identical_reports(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


# ---------------------------------------------------------------------------
# the bool core functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,include_initial", [("stride1", True), ("strideL", True),
                                                  ("stride1", False)])
def test_schedule_job_costs_looped_matches_reference_and_packed(kind, include_initial):
    planes = _planes(37, 64, 10, seed=1)
    chains = schedule.make_chains(37, 6, kind)
    want = jsched.schedule_job_costs_looped(jnp.asarray(planes), chains,
                                            include_initial=include_initial)
    got = schedule.schedule_job_costs_looped(_t(planes), chains, include_initial=include_initial)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    packed = schedule.schedule_job_costs(_t(planes), chains, include_initial=include_initial)
    assert torch.equal(got, packed)


@pytest.mark.parametrize("p,stuck_cols", [(0.5, 1), (0.3, 2), (1.0, 1)])
def test_stuck_chain_matches_reference_and_the_packed_walk(p, stuck_cols):
    planes = _planes(29, 40, 8, seed=2)
    order = np.array([3, 7, 7, 1, 20, 28, 0, 5, 11], np.int32)
    valid = np.array([True] * 7 + [False] * 2)
    key = jax.random.PRNGKey(11)
    for include_initial in (True, False):
        jt, ja = jstuck.stuck_chain(jnp.asarray(planes), jnp.asarray(order), p, key,
                                    stuck_cols=stuck_cols, include_initial=include_initial,
                                    valid=jnp.asarray(valid))
        tt, ta = stucking.stuck_chain(_t(planes), order, p, prng.PRNGKey(11),
                                      stuck_cols=stuck_cols, include_initial=include_initial,
                                      valid=_t(valid))
        assert int(jt) == int(tt)
        np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
        pt, pa = stucking.stuck_chain_packed(bitslice.pack_rows(_t(planes)), order, p,
                                             prng.PRNGKey(11), rows=40, stuck_cols=stuck_cols,
                                             include_initial=include_initial, valid=_t(valid))
        jpt, jpa = jstuck.stuck_chain_packed(jbits.pack_rows(jnp.asarray(planes)),
                                             jnp.asarray(order), p, key, rows=40,
                                             stuck_cols=stuck_cols,
                                             include_initial=include_initial,
                                             valid=jnp.asarray(valid))
        assert int(pt) == int(tt) == int(jpt)
        np.testing.assert_array_equal(np.asarray(jpa), pa.numpy())
        assert torch.equal(bitslice.unpack_rows(pa, 40), ta)


def test_section_planes_and_dequantize_from_planes_match_reference():
    w = _weights((5, 61), seed=3)
    for encoding in ("sign_magnitude", "offset_binary"):
        jq, tq = jbits.quantize(jnp.asarray(w), 10, encoding), bitslice.quantize(_t(w), 10,
                                                                                  encoding)
        jp, jn = jbits.section_planes(jq.q, 32, 10)
        tp, tn = bitslice.section_planes(tq.q, 32, 10)
        assert jn == tn == w.size and tp.dtype == torch.bool
        np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
        sign = bitslice.section(tq.sign, 32)[0]
        want = jbits.dequantize_from_planes(jp, jbits.section(jq.sign, 32)[0], jq.scale,
                                            jq.offset)
        got = bitslice.dequantize_from_planes(tp, sign, tq.scale, tq.offset)
        assert np.asarray(want).tobytes() == got.numpy().tobytes()
        # the flat dequantization of the unpadded weights, as dequantize gives it
        flat = bitslice.unsection(got, tn)
        assert flat.numpy().tobytes() == bitslice.dequantize(tq).numpy().tobytes()


@pytest.mark.parametrize("codec", ["raw", "const_rle", "col_perm", "col_perm_rle"])
def test_encode_decode_planes_round_trip(codec):
    planes = _planes(40, 64, 10, seed=4)
    planes[5:9, :, 6:] = False  # constant tiles for the rle codecs
    packed = bitslice.pack_rows(_t(planes))
    chains = schedule.make_chains(40, 4, "stride1")
    pset = bitslice.encode_planes(packed, codec, chains=chains)
    assert torch.equal(bitslice.decode_planes(pset), packed)
    jset = jbits.encode_planes(jbits.pack_rows(jnp.asarray(planes)), codec, chains=chains)
    np.testing.assert_array_equal(np.asarray(jset.physical()), pset.physical().numpy())
    np.testing.assert_array_equal(np.asarray(jbits.decode_planes(jset)), packed.numpy())


# ---------------------------------------------------------------------------
# the planner's bool oracle
# ---------------------------------------------------------------------------

PLANS = {
    "stucked": dict(p_stuck=0.5, crossbars=4),
    "full": dict(crossbars=4),
    "strideL-2cols": dict(p_stuck=0.3, stuck_cols=2, schedule="strideL", crossbars=5),
    "no-initial": dict(p_stuck=0.5, include_initial=False, crossbars=4),
    "tsp": dict(p_stuck=0.5, section_order="tsp", crossbars=4),
    "no-sws": dict(p_stuck=0.7, sws=False, crossbars=4),
}


@pytest.mark.parametrize("encoding", ["sign_magnitude", "offset_binary"])
@pytest.mark.parametrize("plan", list(PLANS))
def test_analyze_tensor_bool_matches_reference_bool_and_packed(plan, encoding):
    w = _weights((24, 50), seed=5)
    spec_kw = dict(rows=64, cols=8, encoding=encoding)
    cfg_kw = PLANS[plan]
    key = jax.random.PRNGKey(7)
    jr, jw = jplanner.analyze_tensor(jnp.asarray(w), jplanner.CrossbarSpec(**spec_kw),
                                     jplanner.PlannerConfig(impl="bool", **cfg_kw), key, name="t")
    spec = planner.CrossbarSpec(**spec_kw)
    tr, tw = planner.analyze_tensor(_t(w), spec, planner.PlannerConfig(impl="bool", **cfg_kw),
                                    prng.PRNGKey(7), name="t")
    _same_report(jr, tr, plan)
    assert np.asarray(jw).tobytes() == tw.numpy().tobytes()
    pr, pw = planner.analyze_tensor(_t(w), spec, planner.PlannerConfig(**cfg_kw),
                                    prng.PRNGKey(7), name="t")
    _identical_reports(tr, pr)
    assert tw.numpy().tobytes() == pw.numpy().tobytes()


def test_bool_plan_through_a_pool_matches_reference_bool_and_packed():
    """Three tensors streamed through one persistent pool with each impl:
    reports, w_hat bytes, pool state and wear identical."""
    ws = [_weights((20, 48), seed=s) for s in (6, 7, 8)]
    spec_kw, cfg_kw = dict(rows=64, cols=8), dict(p_stuck=0.5, crossbars=6, pool_leveling="lpt")
    jp = jpool.CrossbarPool(jplanner.CrossbarSpec(**spec_kw), 6)
    spec = planner.CrossbarSpec(**spec_kw)
    tb = pool.CrossbarPool(spec, 6, device="cpu")
    tp = pool.CrossbarPool(spec, 6, device="cpu")
    jkey, tkey = jax.random.PRNGKey(3), prng.PRNGKey(3)
    for i, w in enumerate(ws):
        jkey, jsub = jax.random.split(jkey)
        tkey, tsub = prng.split(tkey)
        jr, jw = jplanner.analyze_tensor(jnp.asarray(w), jplanner.CrossbarSpec(**spec_kw),
                                         jplanner.PlannerConfig(impl="bool", **cfg_kw), jsub,
                                         name=f"t{i}", pool=jp)
        br, bw = planner.analyze_tensor(_t(w), spec, planner.PlannerConfig(impl="bool", **cfg_kw),
                                        tsub, name=f"t{i}", pool=tb)
        pr, pw = planner.analyze_tensor(_t(w), spec, planner.PlannerConfig(**cfg_kw), tsub,
                                        name=f"t{i}", pool=tp)
        _same_report(jr, br, f"t{i}")
        _identical_reports(br, pr)
        assert np.asarray(jw).tobytes() == bw.numpy().tobytes() == pw.numpy().tobytes()
    for x in (tb, tp):
        np.testing.assert_array_equal(jp.state, x.state)
        np.testing.assert_array_equal(jp.wear, x.wear)
        assert dataclasses.asdict(jp.stats()) == dataclasses.asdict(x.stats())


def test_bool_refuses_codecs_as_the_reference_does():
    w = _weights((32, 64), seed=9)
    for codec in ("const_rle", "col_perm"):
        with pytest.raises(ValueError, match="require impl='packed'"):
            jplanner.analyze_tensor(jnp.asarray(w), jplanner.CrossbarSpec(),
                                    jplanner.PlannerConfig(impl="bool", codec=codec),
                                    jax.random.PRNGKey(0))
        with pytest.raises(ValueError, match="require impl='packed'"):
            planner.analyze_tensor(_t(w), planner.CrossbarSpec(),
                                   planner.PlannerConfig(impl="bool", codec=codec),
                                   prng.PRNGKey(0))
        xbars = pool.CrossbarPool(planner.CrossbarSpec(), 16, device="cpu")
        with pytest.raises(ValueError, match="require impl='packed'"):
            planner.analyze_tensor(_t(w), planner.CrossbarSpec(),
                                   planner.PlannerConfig(impl="bool", codec=codec),
                                   prng.PRNGKey(0), pool=xbars)
    with pytest.raises(ValueError, match="unknown planner impl"):
        planner.analyze_tensor(_t(w), planner.CrossbarSpec(), planner.PlannerConfig(impl="jit"),
                               prng.PRNGKey(0))


# ---------------------------------------------------------------------------
# the pool's bool walk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p,leveling", [(0.5, "none"), (0.5, "lpt"), (1.0, "rotate")])
def test_pool_bool_walk_matches_reference_and_packed(p, leveling):
    """Three program calls on one pool per impl (the second with a codec's
    PlaneSet): every report field, the state and the wear identical."""
    spec_kw = dict(rows=40, cols=8)
    jp = jpool.CrossbarPool(jplanner.CrossbarSpec(**spec_kw), 6, leveling=leveling)
    tb = pool.CrossbarPool(planner.CrossbarSpec(**spec_kw), 6, leveling=leveling, device="cpu")
    tp = pool.CrossbarPool(planner.CrossbarSpec(**spec_kw), 6, leveling=leveling, device="cpu")
    for i, (s, lc, kind) in enumerate([(13, 4, "stride1"), (11, 5, "stride1"),
                                       (9, 3, "strideL")]):
        packed = bitslice.pack_rows(_t(_planes(s, 40, 8, seed=10 + i)))
        chains = schedule.make_chains(s, lc, kind)
        sections = bitslice.encode_planes(packed, "const_rle") if i == 1 else packed
        jsec = (jbits.encode_planes(jnp.asarray(packed.numpy()), "const_rle") if i == 1
                else jnp.asarray(packed.numpy()))
        jr = jp.program(jsec, chains, p_stuck=p, key=jax.random.PRNGKey(i), impl="bool")
        br = tb.program(sections, chains, p_stuck=p, key=prng.PRNGKey(i), impl="bool")
        pr = tp.program(sections, chains, p_stuck=p, key=prng.PRNGKey(i))
        for f in ("assignment", "seam_costs", "chain_totals", "job_costs",
                  "programmed_job_costs"):
            np.testing.assert_array_equal(np.asarray(getattr(jr, f)), getattr(br, f), err_msg=f)
            np.testing.assert_array_equal(getattr(pr, f), getattr(br, f), err_msg=f)
        for f in ("transitions_full", "transitions_programmed", "wear_increment_total",
                  "wear_increment_max"):
            assert getattr(jr, f) == getattr(br, f) == getattr(pr, f), f
        np.testing.assert_array_equal(np.asarray(jr.achieved), br.achieved.numpy())
        assert torch.equal(br.achieved, pr.achieved)
        assert torch.equal(br.achieved_read, pr.achieved_read)
        np.testing.assert_array_equal(jp.state, tb.state)
        np.testing.assert_array_equal(tp.state, tb.state)
        np.testing.assert_array_equal(jp.wear, tb.wear)
        np.testing.assert_array_equal(tp.wear, tb.wear)


def test_walk_bool_wear_and_counts_equal_the_packed_walk():
    """The bool walk's per-step counts, states and per-cell wear from a
    non-zero start equal ``walk_packed``'s, padding included."""
    planes = _t(_planes(23, 24, 6, seed=20))
    packed = bitslice.pack_rows(planes)
    chains = schedule.make_chains(23, 4, "stride1")
    padded, valid, keys = stucking._pad_chains(chains, prng.PRNGKey(5))
    start = _t(_planes(4, 24, 6, seed=21))
    counts, states, wear = stucking.walk_bool(planes, padded, 0.4, keys, stuck_cols=2,
                                              valid=valid, state0=start)
    totals, pstates, pcounts, pwear = stucking.walk_packed(
        packed, padded, 0.4, keys, rows=24, stuck_cols=2, include_initial=True, valid=valid,
        state0=bitslice.pack_rows(start), with_wear=True)
    assert torch.equal(counts.to(torch.int64), pcounts)
    assert torch.equal(counts.sum(1, dtype=torch.int64), totals)
    assert torch.equal(bitslice.pack_rows(states.reshape(-1, 24, 6)),
                       pstates.reshape(-1, *pstates.shape[2:]))
    assert torch.equal(wear, pwear)
