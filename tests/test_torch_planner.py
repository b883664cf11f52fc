"""The port's planner chain against the JAX package, on the CPU.

Same inputs (numpy, seeded) through the reference function and its port:
bit and integer outputs must be identical, and so must every deployed
``w_hat`` byte.  ``quant_mse`` is a float mean whose summation order differs
between XLA and torch; it is held to a relative 1e-6 (float32 sums of <1e5
terms).  The JAX side runs its plain (non-Pallas) route, as on any CPU.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core import bitslice as jbits
from repro.core import cost as jcost
from repro.core import planner as jplanner
from repro.core import pool as jpool
from repro.core import schedule as jsched
from repro.core import stucking as jstuck
from repro.core import sws as jsws
from repro.kernels.hamming import ref as jham
from repro.models import api as japi
from repro_torch import prng
from repro_torch.convert import from_numpy_tree
from repro_torch.core import bitslice, cost, planner, schedule, stucking, sws
from repro_torch.kernels.hamming import ops as ham_ops
from repro_torch.kernels.hamming import ref as ham_ref

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


def _packed(s, seed=0, w=16, c=10) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (s, w, c), dtype=np.uint8)


# ---------------------------------------------------------------------------
# bitslice
# ---------------------------------------------------------------------------

def test_quantize_dequantize_bytes():
    w = _weights((3, 37, 20))
    jq, tq = jbits.quantize(jnp.asarray(w), 10), bitslice.quantize(_t(w), 10)
    np.testing.assert_array_equal(np.asarray(jq.q), tq.q.numpy())
    np.testing.assert_array_equal(np.asarray(jq.sign), tq.sign.numpy())
    assert np.asarray(jq.scale).tobytes() == tq.scale.numpy().tobytes()
    assert np.asarray(jbits.dequantize(jq)).tobytes() == bitslice.dequantize(tq).numpy().tobytes()


@pytest.mark.parametrize("k", [37, 64])
def test_linear_planes_and_signs_bytes(k):
    w = _weights((2, k, 24), seed=1)
    tq = bitslice.quantize(_t(w), 10)
    q, s = tq.q.reshape(w.shape), tq.sign.reshape(w.shape)
    np.testing.assert_array_equal(
        np.asarray(jbits.pack_linear_planes(jnp.asarray(q.numpy()), 10)),
        bitslice.pack_linear_planes(q, 10).numpy(),
    )
    np.testing.assert_array_equal(
        np.asarray(jbits.pack_linear_sign(jnp.asarray(s.numpy()))),
        bitslice.pack_linear_sign(s).numpy(),
    )


@pytest.mark.parametrize("rows", [128, 100])
def test_section_planes_rows_and_axis0_bytes(rows):
    q = np.random.default_rng(2).integers(0, 1024, (7 * rows,), dtype=np.int32)
    jp = np.asarray(jbits.section_planes_packed(jnp.asarray(q), rows, 10))
    tp = bitslice.section_planes_packed(_t(q), rows, 10).numpy()
    np.testing.assert_array_equal(jp, tp)
    np.testing.assert_array_equal(
        np.asarray(jbits.bitplanes(jnp.asarray(q).reshape(-1, rows), 10)),
        bitslice.bitplanes(_t(q).reshape(-1, rows), 10).numpy(),
    )
    np.testing.assert_array_equal(
        np.asarray(jbits.unpack_rows(jnp.asarray(jp), rows)),
        bitslice.unpack_rows(_t(tp), rows).numpy(),
    )
    mask = np.random.default_rng(3).random((rows, 2)) < 0.5
    np.testing.assert_array_equal(
        np.asarray(jbits.pack_axis0(jnp.asarray(mask))), bitslice.pack_axis0(_t(mask)).numpy()
    )
    sec, n = bitslice.section(_t(q[:-5].astype(np.float32)), rows)
    jsec, jn = jbits.section(jnp.asarray(q[:-5].astype(np.float32)), rows)
    assert n == jn
    np.testing.assert_array_equal(np.asarray(jsec), sec.numpy())
    np.testing.assert_array_equal(bitslice.unsection(sec, n).numpy(), q[:-5])


# ---------------------------------------------------------------------------
# Hamming pricing (plain version) and packed cost
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [0, 1, 37, 300])
def test_hamming_pairs_plain_matches_reference(t):
    a, b = _packed(t, seed=4), _packed(t, seed=5)
    want = np.asarray(jham.hamming_pairs(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(ham_ref.hamming_pairs(_t(a), _t(b)).numpy(), want)
    got = ham_ops.price_pairs(_t(a), _t(b))  # CPU tensors: the plain version
    assert got.dtype == torch.int32 and got.shape == (t,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_price_pairs_rejects_bad_operands():
    a = _t(_packed(4))
    with pytest.raises(ValueError):
        ham_ops.price_pairs(a, a[:3])
    with pytest.raises(TypeError):
        ham_ops.price_pairs(a.to(torch.int32), a.to(torch.int32))


def test_packed_chain_costs_match_reference():
    p = _packed(23, seed=6)
    order = np.random.default_rng(7).permutation(23).astype(np.int32)
    for inc in (True, False):
        for per_col in (True, False):
            np.testing.assert_array_equal(
                np.asarray(jcost.chain_transitions_packed(
                    jnp.asarray(p), jnp.asarray(order), include_initial=inc, per_column=per_col)),
                cost.chain_transitions_packed(
                    _t(p), _t(order).long(), include_initial=inc, per_column=per_col).numpy(),
            )
        np.testing.assert_array_equal(
            np.asarray(jcost.consecutive_costs_packed(jnp.asarray(p), jnp.asarray(order), include_initial=inc)),
            cost.consecutive_costs_packed(_t(p), _t(order).long(), include_initial=inc).numpy(),
        )
    np.testing.assert_array_equal(
        np.asarray(jcost.pair_transitions_packed(jnp.asarray(p[:-1]), jnp.asarray(p[1:]))),
        cost.pair_transitions_packed(_t(p[:-1]), _t(p[1:])).numpy(),
    )


# ---------------------------------------------------------------------------
# SWS and schedules
# ---------------------------------------------------------------------------

def test_sws_permutation_ties_and_signed_zero():
    w = _weights((4000,), seed=8)
    w[10:20] = w[30]  # runs of equal magnitudes
    w[40:50] = -w[30]
    perm = sws.sws_permutation(_t(w))
    np.testing.assert_array_equal(np.asarray(jsws.sws_permutation(jnp.asarray(w))), perm.numpy())
    np.testing.assert_array_equal(
        np.asarray(jsws.inverse_permutation(jnp.asarray(perm.numpy().astype(np.int32)))),
        sws.inverse_permutation(perm).numpy(),
    )
    secs, perm2, n = sws.sorted_sections(_t(w), 128)
    jsecs, _, jn = jsws.sorted_sections(jnp.asarray(w), 128)
    assert n == jn
    np.testing.assert_array_equal(np.asarray(jsecs), secs.numpy())
    np.testing.assert_array_equal(sws.restore_flat(secs, perm2, n).numpy(), w)


@pytest.mark.parametrize("kind", ["stride1", "strideL"])
@pytest.mark.parametrize("s,l", [(37, 5), (5, 16)])
def test_chains_and_job_costs(kind, s, l):
    jch, tch = jsched.make_chains(s, l, kind), schedule.make_chains(s, l, kind)
    assert len(jch) == len(tch)
    for a, b in zip(jch, tch):
        np.testing.assert_array_equal(a, b)
    p = _packed(s, seed=9)
    for inc in (True, False):
        jj = np.asarray(jsched.schedule_job_costs(jnp.asarray(p), jch, include_initial=inc))
        tj = schedule.schedule_job_costs(_t(p), tch, include_initial=inc).numpy()
        np.testing.assert_array_equal(jj, tj)
        for threads in (3, 64):
            for srt in (True, False):
                assert int(schedule.lockstep_time_host(tj, threads, sort_jobs=srt)) == int(
                    jsched.lockstep_time_host(jj, threads, sort_jobs=srt))
                assert int(schedule.lockstep_time(_t(tj), threads, sort_jobs=srt)) == int(
                    jsched.lockstep_time(jnp.asarray(jj), threads, sort_jobs=srt))
        tids, loads = schedule.lpt_assignment(tj, 4)
        jtids, jloads = jsched.lpt_assignment(jj, 4)
        np.testing.assert_array_equal(tids, jtids)
        np.testing.assert_array_equal(loads, jloads)
        assert schedule.lpt_makespan(tj, 4) == jsched.lpt_makespan(jj, 4)


# ---------------------------------------------------------------------------
# Bit stucking: the closed-form walk against the reference's scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [1.0, 0.5, 0.0])
@pytest.mark.parametrize("stuck_cols", [1, 2])
def test_walk_packed_matches_scan(p, stuck_cols):
    packed = _packed(19, seed=10)
    order = np.random.default_rng(11).permutation(19)[:12].astype(np.int32)
    valid = np.arange(12) < 9  # a padded tail programs nothing
    for inc in (True, False):
        jt, js = jstuck._walk_packed(
            jnp.asarray(packed), jnp.asarray(order), p, jax.random.PRNGKey(5), rows=128,
            stuck_cols=stuck_cols, include_initial=inc, valid=jnp.asarray(valid))
        tt, ts = stucking.walk_packed(
            _t(packed), _t(order).long()[None], p, prng.PRNGKey(5)[None], rows=128,
            stuck_cols=stuck_cols, include_initial=inc, valid=_t(valid)[None])
        assert int(jt) == int(tt[0])
        np.testing.assert_array_equal(np.asarray(js), ts[0].numpy())


@pytest.mark.parametrize("kind", ["stride1", "strideL"])
@pytest.mark.parametrize("p", [1.0, 0.5])
def test_stuck_schedule_packed_matches_reference(kind, p):
    s = 45
    packed = _packed(s, seed=12)
    for inc in (True, False):
        jt, ja = jstuck.stuck_schedule_packed(
            jnp.asarray(packed), [jnp.asarray(c) for c in jsched.make_chains(s, 6, kind)], p,
            jax.random.PRNGKey(3), rows=128, include_initial=inc)
        tt, ta = stucking.stuck_schedule_packed(
            _t(packed), schedule.make_chains(s, 6, kind), p, prng.PRNGKey(3), rows=128,
            include_initial=inc)
        np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
        np.testing.assert_array_equal(np.asarray(ja), ta.numpy())


# ---------------------------------------------------------------------------
# Planner
# ---------------------------------------------------------------------------

def assert_reports_equal(jr, tr):
    a, b = dataclasses.asdict(jr), dataclasses.asdict(tr)
    assert a.keys() == b.keys()
    for field in a:
        if field == "quant_mse":
            np.testing.assert_allclose(b[field], a[field], rtol=QUANT_MSE_RTOL)
        else:
            assert a[field] == b[field], (jr.name, field, a[field], b[field])
    assert jr.sws_speedup == tr.sws_speedup and jr.total_speedup == tr.total_speedup


@pytest.mark.parametrize("p", [1.0, 0.5])
@pytest.mark.parametrize("kind", ["stride1", "strideL"])
def test_analyze_tensor_stacked(p, kind):
    w = _weights((2, 96, 80), seed=13)
    jcfg = jplanner.PlannerConfig(p_stuck=p, schedule=kind)
    tcfg = planner.PlannerConfig(p_stuck=p, schedule=kind)
    jr, jw = jplanner.analyze_tensor(
        jnp.asarray(w), jplanner.CrossbarSpec(), jcfg, jax.random.PRNGKey(4), name="w")
    tr, tw = planner.analyze_tensor(_t(w), planner.CrossbarSpec(), tcfg, prng.PRNGKey(4), name="w")
    assert_reports_equal(jr, tr)
    assert tw.shape == w.shape and tw.dtype == torch.float32
    assert np.asarray(jw).tobytes() == tw.numpy().tobytes()


@pytest.mark.parametrize("order", ["magnitude", "tsp"])
@pytest.mark.parametrize("p", [1.0, 0.5])
@pytest.mark.parametrize("inc", [False, True])
def test_analyze_tensor_initial_and_section_order(inc, p, order):
    """include_initial=False (stateless) and the TSP section reorder price
    the reference's integers and deploy its w_hat bytes."""
    w = _weights((2, 96, 80), seed=14)
    kw = dict(p_stuck=p, include_initial=inc, section_order=order, crossbars=5)
    jr, jw = jplanner.analyze_tensor(jnp.asarray(w), jplanner.CrossbarSpec(),
                                     jplanner.PlannerConfig(**kw), jax.random.PRNGKey(6))
    tr, tw = planner.analyze_tensor(_t(w), planner.CrossbarSpec(), planner.PlannerConfig(**kw),
                                    prng.PRNGKey(6))
    assert_reports_equal(jr, tr)
    assert np.asarray(jw).tobytes() == tw.numpy().tobytes()
    if not inc:  # the flag changes the counts, never the deployed weights
        _, tw_inc = planner.analyze_tensor(
            _t(w), planner.CrossbarSpec(),
            planner.PlannerConfig(**{**kw, "include_initial": True}), prng.PRNGKey(6))
        assert tw_inc.numpy().tobytes() == tw.numpy().tobytes()


def _tie_packed(s, seed):
    """Packed planes with repeated sections and few distinct bytes, so that
    the nearest-neighbour walk meets equal distances."""
    rng = np.random.default_rng(seed)
    p = (rng.integers(0, 2, (s, 2, 3)) * 255).astype(np.uint8)
    p[rng.integers(0, s, s // 3)] = p[rng.integers(0, s, s // 3)]
    return p


@pytest.mark.parametrize("planes_of", [lambda: _packed(50, seed=15), lambda: _tie_packed(40, 16)],
                         ids=["random", "ties"])
@pytest.mark.parametrize("start", [0, 7])
def test_tsp_greedy_order_matches_reference(planes_of, start):
    p = planes_of()
    jo = np.asarray(jsws.tsp_greedy_order(jnp.asarray(p), start=start))
    to = sws.tsp_greedy_order(_t(p), start=start)
    assert to.dtype == torch.int64
    np.testing.assert_array_equal(jo, to.numpy())


@pytest.mark.parametrize("case", ["pool_without_initial", "codec_without_initial",
                                  "unknown_section_order"])
def test_planner_settings_the_reference_refuses(case):
    """include_initial=False has no pool interpretation (with pool= or a
    codec, which is planned through one), as in the reference; an unknown
    section_order is refused."""
    from repro_torch.core import pool as tpool

    spec = planner.CrossbarSpec()
    w = _weights((64, 80))
    cfg, kw = {
        "pool_without_initial": (dict(include_initial=False),
                                 {"pool": tpool.CrossbarPool(spec, 16, device="cpu")}),
        "codec_without_initial": (dict(include_initial=False, codec="col_perm"), {}),
        "unknown_section_order": (dict(section_order="norm"), {}),
    }[case]
    with pytest.raises(ValueError) as terr:
        planner.analyze_tensor(_t(w), spec, planner.PlannerConfig(**cfg), prng.PRNGKey(0), **kw)
    if case == "unknown_section_order":
        # the reference plans any other value as "magnitude"; the port names the choices
        assert "magnitude" in str(terr.value) and "tsp" in str(terr.value)
        return
    assert "no pool interpretation" in str(terr.value)
    if "pool" in kw:
        kw = {"pool": jpool.CrossbarPool(jplanner.CrossbarSpec(), 16)}
    with pytest.raises(ValueError, match="no pool interpretation"):
        jplanner.analyze_tensor(jnp.asarray(w), jplanner.CrossbarSpec(),
                                jplanner.PlannerConfig(**cfg), jax.random.PRNGKey(0), **kw)


@pytest.fixture(scope="module")
def reduced_gemma():
    jcfg = jax_get_arch("gemma-2b", reduced=True)
    jparams = japi.init(jax.random.PRNGKey(0), jcfg)
    return jparams, from_numpy_tree(jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.mark.parametrize("p,kw", [
    pytest.param(1.0, {}, id="1.0"),
    pytest.param(0.5, {}, id="0.5"),
    pytest.param(0.5, {"include_initial": False, "section_order": "tsp"}, id="0.5-tsp-no_initial"),
])
def test_build_deployment_reduced_gemma(reduced_gemma, p, kw):
    jparams, tparams = reduced_gemma
    jplan = jplanner.build_deployment(
        jparams, jplanner.CrossbarSpec(), jplanner.PlannerConfig(p_stuck=p, min_size=1024, **kw))
    tplan = planner.build_deployment(
        tparams, planner.CrossbarSpec(), planner.PlannerConfig(p_stuck=p, min_size=1024, **kw),
        device="cpu")
    assert list(jplan.reports) == list(tplan.reports)
    assert "segments/0/mlp/wi_gate" in tplan.reports
    for name in jplan.reports:
        assert_reports_equal(jplan.reports[name], tplan.reports[name])
        assert np.asarray(jplan.deployed[name]).tobytes() == tplan.deployed[name].numpy().tobytes()
    jt, tt = jplan.totals(), tplan.totals()
    for k in ("transitions_baseline", "transitions_sws", "transitions_final",
              "sws_speedup", "total_speedup"):
        assert jt[k] == tt[k]


def test_iter_weights_names_and_order(reduced_gemma):
    jparams, tparams = reduced_gemma
    for cfg_kw in ({}, {"min_size": 1024}, {"min_size": 1}):
        jn = [n for n, _ in jplanner.iter_weights(jparams, jplanner.PlannerConfig(**cfg_kw))]
        tn = [n for n, _ in planner.iter_weights(tparams, planner.PlannerConfig(**cfg_kw))]
        assert jn == tn


def test_unported_options_raise():
    """What the port refuses: a codec with int8 planes (no stored-plane
    layout to encode: a ValueError, as in the reference).  The bool oracle
    is ported: stateless and through a pool it gives the packed plan's
    report and w_hat bytes.  Fault injection and the integrity layer are
    ported: a plan through a faulty pool with integrity registers its
    tensor, and ``rebuild`` gives the deployed bytes."""
    from repro_torch.core import pool as tpool

    w = _t(_weights((64, 80)))
    key = prng.PRNGKey(0)
    spec = planner.CrossbarSpec()
    want = planner.analyze_tensor(w, spec, planner.PlannerConfig(p_stuck=0.5), key)
    got = planner.analyze_tensor(w, spec, planner.PlannerConfig(impl="bool", p_stuck=0.5), key)
    assert dataclasses.asdict(got[0]) == dataclasses.asdict(want[0])
    assert got[1].numpy().tobytes() == want[1].numpy().tobytes()
    xbars = tpool.CrossbarPool(spec, 16, device="cpu")
    got = planner.analyze_tensor(w, spec, planner.PlannerConfig(impl="bool", p_stuck=0.5), key,
                                 pool=xbars)
    assert dataclasses.asdict(got[0]) == dataclasses.asdict(want[0])
    assert got[1].numpy().tobytes() == want[1].numpy().tobytes()
    from repro_torch.core import nonideal

    xbars.inject_faults(nonideal.FaultModel(stuck0=0.01, stuck1=0.01), prng.PRNGKey(3))
    mgr = xbars.enable_integrity()
    _, w_hat = planner.analyze_tensor(w, spec, planner.PlannerConfig(), key, name="w", pool=xbars)
    assert mgr.verify_all() and mgr.rebuild("w").numpy().tobytes() == w_hat.numpy().tobytes()
    plan = planner.build_deployment({"w": w}, spec, planner.PlannerConfig(), device="cpu")
    with pytest.raises(ValueError):
        planner.deploy_params({"w": w}, plan, materialize="planes_int8", codec="const_rle")
    with pytest.raises(ValueError):
        planner.deploy_params({"w": w}, plan, materialize="packed", codec="zstd")


def test_build_deployment_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        planner.build_deployment({"w": _t(_weights((64, 80)))})
