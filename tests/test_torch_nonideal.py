"""The port's fault layer (``core/nonideal.py``) against the JAX package, on
the CPU.

The same keys and numpy inputs (made from seeds) go through both packages:
fault masks, hotspots, damage matrices, fault-aware assignments, the pool's
``achieved_read`` / wear / assignment under every leveling, and the planned
``w_hat`` bytes must be identical; so must ``perturb_operands``' masks, IR
attenuation and drift gains (``prng.xla_exp`` is XLA:CPU's float32 ``exp``
operation for operation, so the gains are bit-identical, not merely within
an ulp).  Perturbed ``cim_linear`` is held to the reference's within B2's
float32 bound, 2 * eps * K * (|x| @ |w|) (both sum the same products in
another order).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitslice as jbits
from repro.core import nonideal as jni
from repro.core import planner as jplanner
from repro.core import pool as jpool
from repro.core import schedule as jsched
from repro.core import simulator as jsim
from repro_torch import prng
from repro_torch.core import bitslice, nonideal, planner, pool, schedule, simulator
from repro_torch.kernels.cim_matmul import ref as cim_ref

SPEC = (64, 8)
F32_EPS = float(np.finfo(np.float32).eps)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _specs(rows, cols):
    return jplanner.CrossbarSpec(rows=rows, cols=cols), planner.CrossbarSpec(rows=rows, cols=cols)


def _random_packed(seed: int, s: int, rows=SPEC[0], cols=SPEC[1]) -> np.ndarray:
    q = np.random.default_rng(seed).integers(0, 2**cols, s * rows)
    planes = (q.reshape(s, rows)[:, :, None] >> np.arange(cols)) & 1
    return np.packbits(planes.astype(np.uint8), axis=1)


def _states(model_kw, n, seed, rows=SPEC[0], cols=SPEC[1]):
    js, ts = _specs(rows, cols)
    a = jni.inject(js, n, jni.FaultModel(**model_kw), jax.random.PRNGKey(seed))
    b = nonideal.inject(ts, n, nonideal.FaultModel(**model_kw), prng.PRNGKey(seed), device="cpu")
    return a, b


def _assert_state_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a.stuck0), b.stuck0.numpy())
    np.testing.assert_array_equal(np.asarray(a.stuck1), b.stuck1.numpy())
    np.testing.assert_array_equal(np.asarray(a.hot), b.hot)
    np.testing.assert_array_equal(a.fault_cells(), b.fault_cells())


# ---------------------------------------------------------------------------
# FaultModel, inject, read_packed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kwargs, field", [
    (dict(stuck0=-0.1), "stuck0"), (dict(stuck0=1.5), "stuck0"), (dict(stuck1=2.0), "stuck1"),
    (dict(hotspot_fraction=-0.01), "hotspot_fraction"),
    (dict(hotspot_fraction=1.01), "hotspot_fraction"), (dict(drift_sigma=-0.5), "drift_sigma"),
    (dict(ir_alpha=-1.0), "ir_alpha"), (dict(hotspot_mult=-2.0), "hotspot_mult"),
])
def test_fault_model_validation(kwargs, field):
    with pytest.raises(ValueError, match=field):
        nonideal.FaultModel(**kwargs)
    with pytest.raises(ValueError, match=field):
        jni.FaultModel(**kwargs)


def test_fault_model_boundaries_and_ideal():
    kw = dict(stuck0=0.0, stuck1=1.0, hotspot_fraction=1.0, drift_sigma=0.0, ir_alpha=0.0,
              hotspot_mult=0.0)
    assert nonideal.FaultModel(**kw).ideal == jni.FaultModel(**kw).ideal is False
    assert nonideal.FaultModel().ideal and jni.FaultModel().ideal


@pytest.mark.parametrize("rows,cols,n", [(64, 8, 8), (12, 4, 4), (128, 10, 32), (100, 10, 5)])
@pytest.mark.parametrize("model_kw", [
    dict(stuck0=0.05, stuck1=0.05, hotspot_fraction=0.25),
    dict(stuck0=1e-3, stuck1=1e-3, hotspot_fraction=0.25, hotspot_mult=8.0),
    dict(stuck0=0.5, stuck1=0.5),
    dict(stuck0=0.005, stuck1=0.02, hotspot_fraction=0.5, hotspot_mult=16.0),
    dict(stuck0=0.3, stuck1=0.3, hotspot_fraction=0.5, hotspot_mult=5.0),  # clipped rates
])
@pytest.mark.parametrize("seed", [0, 42])
def test_inject_matches_reference(rows, cols, n, model_kw, seed):
    a, b = _states(model_kw, n, seed, rows, cols)
    _assert_state_equal(a, b)
    assert int((b.stuck0 & b.stuck1).sum()) == 0
    bits = bitslice.unpackbits(b.stuck0 | b.stuck1, 1, b.stuck0.shape[1] * 8)
    assert int(bits[:, rows:].sum()) == 0  # padding rows are fault-free


def test_zero_rate_masks_and_read_identity():
    a, b = _states({}, 4, 0)
    _assert_state_equal(a, b)
    assert int(b.stuck0.sum()) == 0 and int(b.stuck1.sum()) == 0
    planes = _t(_random_packed(1, 4))
    assert torch.equal(nonideal.read_packed(planes, b.stuck0, b.stuck1), planes)


def test_read_packed_matches_reference():
    planes = _random_packed(3, 6)
    _, b = _states(dict(stuck0=0.1, stuck1=0.1), 6, 5)
    want = jni.read_packed(jnp.asarray(planes), jnp.asarray(b.stuck0.numpy()),
                           jnp.asarray(b.stuck1.numpy()))
    got = nonideal.read_packed(_t(planes), b.stuck0, b.stuck1)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    hand = nonideal.read_packed(torch.tensor([[[0b10110000], [0b01010000]]], dtype=torch.uint8),
                                torch.tensor([[[0b10000000], [0]]], dtype=torch.uint8),
                                torch.tensor([[[0b00000001], [0b00010000]]], dtype=torch.uint8))
    assert hand.tolist() == [[[0b00110001], [0b01010000]]]


# ---------------------------------------------------------------------------
# fault-aware remapping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk_bytes", [None, 1])
@pytest.mark.parametrize("seed", [2, 5])
def test_damage_and_assignment_match_reference(monkeypatch, chunk_bytes, seed):
    """Damage and the greedy assignment equal the reference's, also with
    one section a chunk (the chunking changes no integer)."""
    if chunk_bytes is not None:
        monkeypatch.setattr(nonideal, "DAMAGE_CHUNK_BYTES", chunk_bytes)
    packed = _random_packed(seed, 16)
    chains_j = jsched.make_chains(16, 4, "stride1")
    chains_t = schedule.make_chains(16, 4, "stride1")
    model = dict(stuck0=0.02, stuck1=0.02, hotspot_fraction=0.4, hotspot_mult=16.0)
    a, b = _states(model, 8, 11 + seed)
    want = jni.damage_matrix(jnp.asarray(packed), chains_j, a)
    got = nonideal.damage_matrix(_t(packed), chains_t, b)
    np.testing.assert_array_equal(want, got)
    wear = np.random.default_rng(seed).integers(0, 5, 8)
    for w in (None, wear):
        np.testing.assert_array_equal(jni.fault_aware_assignment(want, w),
                                      nonideal.fault_aware_assignment(got, w))


def test_assignment_identity_and_concentrated_faults():
    np.testing.assert_array_equal(nonideal.fault_aware_assignment(np.zeros((4, 8), np.int64)),
                                  np.arange(4, dtype=np.int32))
    with pytest.raises(ValueError):
        nonideal.fault_aware_assignment(np.zeros((5, 4), np.int64))
    words = -(-SPEC[0] // 8)
    s0 = torch.zeros((6, words, SPEC[1]), dtype=torch.uint8)
    s1 = torch.zeros_like(s0)
    s0[1], s1[4] = 0xFF, 0xFF
    st = nonideal.FaultState(nonideal.FaultModel(stuck0=1.0), s0, s1, np.zeros(6, bool))
    damage = nonideal.damage_matrix(_t(_random_packed(2, 12)),
                                    schedule.make_chains(12, 3, "stride1"), st)
    assign = nonideal.fault_aware_assignment(damage)
    assert len(set(assign.tolist())) == 3 and 1 not in assign and 4 not in assign


STREAM = [(37, 4, "stride1"), (50, 6, "stride1"), (23, 5, "strideL")]


@pytest.mark.parametrize("p", [1.0, 0.5])
@pytest.mark.parametrize("leveling", ["none", "lpt", "fault"])
def test_faulty_pool_matches_reference(leveling, p):
    """Three tensors through a faulty pool: assignment, seams, job costs,
    achieved and achieved_read planes, wear and state identical."""
    rows, cols = 128, 10
    js, ts = _specs(rows, cols)
    model = dict(stuck0=0.01, stuck1=0.01, hotspot_fraction=0.25, hotspot_mult=8.0)
    jp = jpool.CrossbarPool(js, 12, leveling=leveling)
    tp = pool.CrossbarPool(ts, 12, leveling=leveling, device="cpu")
    jp.inject_faults(jni.FaultModel(**model), jax.random.PRNGKey(9))
    tp.inject_faults(nonideal.FaultModel(**model), prng.PRNGKey(9))
    _assert_state_equal(jp.faults, tp.faults)
    for i, (s, l, kind) in enumerate(STREAM):
        packed = _random_packed(i, s, rows, cols)
        jr = jp.program(jnp.asarray(packed), jsched.make_chains(s, l, kind), p_stuck=p,
                        key=jax.random.PRNGKey(i))
        tr = tp.program(_t(packed), schedule.make_chains(s, l, kind), p_stuck=p,
                        key=prng.PRNGKey(i))
        np.testing.assert_array_equal(np.asarray(jr.assignment), tr.assignment)
        for f in ("seam_costs", "job_costs", "programmed_job_costs"):
            np.testing.assert_array_equal(np.asarray(getattr(jr, f)), getattr(tr, f), err_msg=f)
        np.testing.assert_array_equal(np.asarray(jr.achieved), tr.achieved.numpy())
        np.testing.assert_array_equal(np.asarray(jr.achieved_read), tr.achieved_read.numpy())
        np.testing.assert_array_equal(jp.wear, tp.wear)
        np.testing.assert_array_equal(jp.read_state(), tp.read_state())
    assert jp.stats().to_dict() == tp.stats().to_dict()


def test_fault_leveling_reduces_read_damage_and_falls_back_to_lpt():
    model = nonideal.FaultModel(stuck0=0.02, stuck1=0.02, hotspot_fraction=0.4, hotspot_mult=16.0)
    packed = _t(_random_packed(5, 16))
    chains = schedule.make_chains(16, 4, "stride1")
    flips = {}
    for leveling in ("none", "fault"):
        tp = pool.CrossbarPool(planner.CrossbarSpec(*SPEC), 8, leveling=leveling, device="cpu")
        tp.inject_faults(model, prng.PRNGKey(11))
        rep = tp.program(packed, chains)
        flips[leveling] = int(bitslice.unpackbits(rep.achieved ^ rep.achieved_read, 1, 64).sum())
    assert flips["fault"] < flips["none"]
    rep_f = pool.CrossbarPool(planner.CrossbarSpec(*SPEC), 4, leveling="fault",
                              device="cpu").program(packed[:8], chains[:2])
    rep_l = pool.CrossbarPool(planner.CrossbarSpec(*SPEC), 4, leveling="lpt",
                              device="cpu").program(packed[:8], chains[:2])
    np.testing.assert_array_equal(rep_f.assignment, rep_l.assignment)


@pytest.mark.parametrize("leveling,codec", [("fault", "raw"), ("none", "raw"),
                                            ("fault", "col_perm"), ("fault", "const_rle")])
def test_faulty_pool_plan_w_hat_matches_reference(leveling, codec):
    """A tensor planned through a faulty pool: report, wear and the w_hat
    bytes read through the masks identical."""
    js, ts = _specs(128, 10)
    w = np.random.default_rng(3).standard_normal((96, 100)).astype(np.float32) * 0.05
    kw = dict(p_stuck=0.5, crossbars=6, codec=codec, pool_leveling=leveling)
    model = dict(stuck0=0.01, stuck1=0.01, hotspot_fraction=0.25, hotspot_mult=8.0)
    jp = jpool.CrossbarPool(js, 12)
    tp = pool.CrossbarPool(ts, 12, device="cpu")
    jp.inject_faults(jni.FaultModel(**model), jax.random.PRNGKey(4))
    tp.inject_faults(nonideal.FaultModel(**model), prng.PRNGKey(4))
    jr, jw = jplanner._analyze_tensor_pool(jnp.asarray(w), js, jplanner.PlannerConfig(**kw),
                                           jax.random.PRNGKey(1), jp, name="t")
    tr, tw = planner.analyze_tensor(_t(w), ts, planner.PlannerConfig(**kw), prng.PRNGKey(1),
                                    name="t", pool=tp)
    assert np.asarray(jw).tobytes() == tw.numpy().tobytes()
    assert jr.transitions_final == tr.transitions_final
    assert jr.transitions_sws == tr.transitions_sws
    np.testing.assert_array_equal(jp.wear, tp.wear)


def test_zero_fault_deployment_is_byte_identical():
    ts = planner.CrossbarSpec(128, 10)
    w = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 80)).astype(np.float32))
    cfg = planner.PlannerConfig(p_stuck=0.5, crossbars=4)
    outs = []
    for faulted in (False, True):
        tp = pool.CrossbarPool(ts, 4, device="cpu")
        if faulted:
            tp.inject_faults(nonideal.FaultModel(), prng.PRNGKey(5))
        outs.append(planner.analyze_tensor(w, ts, cfg, prng.PRNGKey(1), pool=tp)[1])
    assert outs[0].numpy().tobytes() == outs[1].numpy().tobytes()


# ---------------------------------------------------------------------------
# serving-side perturbation
# ---------------------------------------------------------------------------

MODELS = [
    dict(stuck0=0.03, stuck1=0.03),
    dict(drift_sigma=0.08),
    dict(ir_alpha=0.2),
    dict(stuck0=0.02, stuck1=0.02, drift_sigma=0.05, ir_alpha=0.1),
]


def _prepared(shape, rows=16, cols=8, codec="raw", seed=0):
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape)) * np.float32(0.05)
    jop = jsim.prepare_linear(jnp.asarray(w), jplanner.CrossbarSpec(rows=rows, cols=cols),
                              materialize="packed", codec=codec)
    top = simulator.prepare_linear(_t(w), planner.CrossbarSpec(rows=rows, cols=cols),
                                   materialize="packed", codec=codec)
    return jop, top


@pytest.mark.parametrize("model_kw", MODELS)
@pytest.mark.parametrize("seed", [0, 7])
def test_perturb_operands_matches_reference(model_kw, seed):
    """Masks, drift gains and the IR attenuation identical bit for bit."""
    jop, top = _prepared((48, 20))
    jp = jni.perturb_operands(jop, jni.FaultModel(**model_kw), jax.random.PRNGKey(seed))
    tp = nonideal.perturb_operands(top, nonideal.FaultModel(**model_kw), prng.PRNGKey(seed))
    assert set(jp) == set(tp)
    for k in tp:
        assert np.asarray(jp[k]).tobytes() == tp[k].numpy().tobytes(), k
        assert tuple(jp[k].shape) == tuple(tp[k].shape), k


def test_perturb_operands_stacked_and_ideal():
    w = np.random.default_rng(1).standard_normal((3, 40, 24)).astype(np.float32) * 0.05
    qt = jbits.quantize(jnp.asarray(w), 10)
    w_hat = np.asarray(jbits.dequantize(qt)).reshape(w.shape)
    jop = jsim.operands_from_dense(jnp.asarray(w_hat), qt.scale, qt.offset, "sign_magnitude", 10)
    top = simulator.operands_from_dense(_t(w_hat), float(qt.scale), 0.0, "sign_magnitude", 10)
    m = MODELS[-1]
    jp = jni.perturb_operands(jop, jni.FaultModel(**m), jax.random.PRNGKey(3))
    tp = nonideal.perturb_operands(top, nonideal.FaultModel(**m), prng.PRNGKey(3))
    for k in ("stuck0_packed", "stuck1_packed", "plane_gain", "row_atten"):
        assert np.asarray(jp[k]).tobytes() == tp[k].numpy().tobytes(), k
    dense = simulator.densify_operands(tp)
    want = jsim.densify_operands(jp)
    np.testing.assert_allclose(dense.numpy(), np.asarray(want), rtol=1e-6, atol=1e-9)
    assert nonideal.perturb_operands(top, nonideal.FaultModel(), prng.PRNGKey(0)) is top
    int8 = simulator.prepare_linear(torch.zeros(32, 12), planner.CrossbarSpec(16, 8))
    with pytest.raises(ValueError):
        nonideal.perturb_operands(int8, nonideal.FaultModel(stuck0=0.1), prng.PRNGKey(0))


@pytest.mark.parametrize("chunk", [None, 7])
def test_bernoulli_with_tensor_p_matches_jax(monkeypatch, chunk):
    """``prng.bernoulli`` with a float32 probability tensor broadcast to the
    shape, as ``nonideal.inject`` draws, also hashed a few elements at a time."""
    if chunk is not None:
        monkeypatch.setattr(prng, "CHUNK", chunk)
    p = np.array([0.0, 1e-3, 0.3, 1.0, 2e-8], np.float32)[:, None, None]
    shape = (5, 16, 3)
    want = jax.random.bernoulli(jax.random.PRNGKey(9), shape=shape,
                                p=jnp.broadcast_to(jnp.asarray(p), shape))
    got = prng.bernoulli(prng.PRNGKey(9), torch.from_numpy(p), shape)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    with pytest.raises(TypeError):
        prng.bernoulli(prng.PRNGKey(9), torch.zeros(5, 1, 1, dtype=torch.float64), shape)


def test_xla_exp_matches_jax():
    x = np.concatenate([np.random.default_rng(0).standard_normal(200_000) * 0.3,
                        np.random.default_rng(1).uniform(-95, 95, 50_000),
                        [0.0, -0.0, 88.7, 88.8, 100.0, -87.5, -87.9, -120.0]]).astype(np.float32)
    want = np.asarray(jnp.exp(jnp.asarray(x)))
    assert prng.xla_exp(_t(x)).numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("model_kw", MODELS)
@pytest.mark.parametrize("codec", ["raw", "col_perm"])
def test_perturbed_cim_linear_matches_reference(model_kw, codec):
    """Perturbed cim_linear against the reference's within B2's float32
    bound, and against the port's own densified weights; the perturbation
    changes the result."""
    jop, top = _prepared((48, 20), codec=codec)
    jp = jni.perturb_operands(jop, jni.FaultModel(**model_kw), jax.random.PRNGKey(7))
    tp = nonideal.perturb_operands(top, nonideal.FaultModel(**model_kw), prng.PRNGKey(7))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (4, 48)))
    want = np.asarray(jsim.cim_linear(jnp.asarray(x), jp))
    got = simulator.cim_linear(_t(x), tp).numpy()
    dense = simulator.densify_operands(tp)
    w_abs = (cim_ref.unpack_weights(simulator.read_planes(tp), tp["sign_packed"], 48,
                                    tp.get("plane_ids"), tp.get("plane_gain")).abs()
             * tp["scale"]).numpy()
    if "row_atten" in tp:
        w_abs = w_abs * tp["row_atten"].numpy()[:, None]
    bound = 2 * F32_EPS * 48 * (np.abs(x) @ w_abs) + 1e-12
    assert (np.abs(got - want) <= bound).all()
    assert (np.abs(got - (_t(x) @ dense).numpy()) <= bound).all()
    np.testing.assert_allclose(dense.numpy(), np.asarray(jsim.densify_operands(jp)),
                               rtol=1e-6, atol=1e-9)
    clean = simulator.cim_linear(_t(x), top).numpy()
    assert np.abs(got - clean).max() > 0


def test_perturbed_operands_skip_the_zero_tile_flags():
    """Stuck masks change the stored planes, so const_rle's flags no longer
    apply: the masked read goes to the plain packed matmul whole."""
    jop, top = _prepared((256, 24), codec="const_rle")
    tp = nonideal.perturb_operands(top, nonideal.FaultModel(stuck0=0.02, stuck1=0.2),
                                   prng.PRNGKey(2))
    jp = jni.perturb_operands(jop, jni.FaultModel(stuck0=0.02, stuck1=0.2), jax.random.PRNGKey(2))
    x = np.random.default_rng(0).standard_normal((3, 256)).astype(np.float32)
    got = simulator.cim_linear(_t(x), tp).numpy()
    want = np.asarray(jsim.cim_linear(jnp.asarray(x), jp))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
