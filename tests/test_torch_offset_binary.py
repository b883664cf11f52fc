"""The offset_binary encoding on the port against the JAX package, and the
seeded prompt draw (``api.make_batch``).

CPU cases feed the same numpy inputs (made from a seed) through the
reference and the port (``device="cpu"``): quantization, plans (stateless,
through a ``CrossbarPool``, with the TSP section order), ``w_hat`` bytes,
crossbar operands, ``prepare_linear`` and served greedy tokens must be
identical; ``quant_mse`` is a float mean held to a relative 1e-6, and float
matmuls (``cim_linear``, the probes) to 1e-5.  The reference's own
offset_binary cases are copied at the end, on the port.

Cases marked ``cuda`` hold kernels B2/B4, B5 and B6 on offset_binary
operands against their plain versions and skip without a card; the
reference is imported only when it is installed, so on a machine with the
port alone ``PYTHONPATH=src python -m pytest --noconftest -m cuda
tests/test_torch_offset_binary.py`` runs them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.configs import get_arch
from repro_torch.convert import from_numpy_tree
from repro_torch.core import bitslice, planner, pool, simulator
from repro_torch.kernels.bitslice import ops as bs_ops
from repro_torch.kernels.bitslice import ref as bs_ref
from repro_torch.kernels.cim_matmul import ops as cim_ops
from repro_torch.kernels.cim_matmul import ref as cim_ref
from repro_torch.launch import serve
from repro_torch.models import api

try:  # the reference: on the CPU test machine, not beside the card
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch as jax_get_arch
    from repro.core import bitslice as jbits
    from repro.core import planner as jplanner
    from repro.core import pool as jpool
    from repro.core import simulator as jsim
    from repro.launch import serve as jserve
    from repro.models import api as japi
except ImportError:
    jax = None

OB = "offset_binary"
QUANT_MSE_RTOL = 1e-6
FLOAT_TOL = 1e-5
F32_EPS = torch.finfo(torch.float32).eps


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _weights(shape, seed=0, std=0.02, shift=0.01) -> np.ndarray:
    """Shifted gaussian weights with +-0, a duplicated value and its negation
    (sort ties under a signed key), so min != -max."""
    w = (np.random.default_rng(seed).standard_normal(shape) * std + shift).astype(np.float32)
    flat = w.reshape(-1)
    flat[:3] = [0.0, -0.0, flat[3]]
    flat[4] = -flat[3]
    return w


def _same_bytes(a, b) -> bool:
    return np.asarray(a).tobytes() == np.asarray(b).tobytes()


def assert_reports_equal(jr, tr):
    a, b = dataclasses.asdict(jr), dataclasses.asdict(tr)
    assert a.keys() == b.keys()
    for field in a:
        if field == "quant_mse":
            np.testing.assert_allclose(b[field], a[field], rtol=QUANT_MSE_RTOL)
        else:
            assert a[field] == b[field], (jr.name, field, a[field], b[field])


# ---------------------------------------------------------------------------
# C.7: the prompt draw
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("arch", ["gemma-2b", "yi-6b"])
def test_make_batch_matches_reference(arch, seed):
    """``make_batch(cfg, key, b, s)`` draws the reference's int32 tokens."""
    want = japi.make_batch(jax_get_arch(arch, reduced=True), jax.random.PRNGKey(seed), 3, 17)
    got = api.make_batch(get_arch(arch, reduced=True), prng.PRNGKey(seed), 3, 17, device="cpu")
    assert got["tokens"].dtype == torch.int32 and got.keys() == {"tokens"}
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))


# ---------------------------------------------------------------------------
# Quantization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["shifted", "negative", "positive", "constant", "signed_zero"])
@pytest.mark.parametrize("cols", [4, 10, 16])
def test_quantize_dequantize_bytes(case, cols):
    w = _weights((3, 37, 20), seed=cols)
    if case == "negative":
        w = -np.abs(w)
    elif case == "positive":
        w = np.abs(w) + 0.5
    elif case == "constant":
        w = np.full((40, 3), 0.25, np.float32)  # hi == lo: the tiny range
    elif case == "signed_zero":
        w = np.where(np.arange(w.size).reshape(w.shape) % 3 == 0, -0.0, w).astype(np.float32)
    jq, tq = jbits.quantize(jnp.asarray(w), cols, OB), bitslice.quantize(_t(w), cols, OB)
    np.testing.assert_array_equal(np.asarray(jq.q), tq.q.numpy())
    np.testing.assert_array_equal(tq.sign.numpy(), np.ones(w.size, np.int8))
    for field in ("scale", "offset"):
        assert _same_bytes(getattr(jq, field), getattr(tq, field).numpy()), field
    assert _same_bytes(jbits.dequantize(jq), bitslice.dequantize(tq).numpy())


def test_encodings_and_unknown_encoding():
    assert bitslice.ENCODINGS == ("sign_magnitude", OB)
    with pytest.raises(ValueError, match="unknown encoding"):
        bitslice.quantize(torch.ones(8), 10, "two_complement")
    with pytest.raises(ValueError, match="unknown encoding"):
        simulator.operands_from_dense(torch.ones(8, 8), 0.1, 0.0, "two_complement", 10)


# ---------------------------------------------------------------------------
# Planner: stateless, through a pool, with the TSP section order
# ---------------------------------------------------------------------------

SPEC_J = None if jax is None else jplanner.CrossbarSpec(encoding=OB)
SPEC_T = planner.CrossbarSpec(encoding=OB)


@pytest.mark.parametrize("order", ["magnitude", "tsp"])
@pytest.mark.parametrize("p", [0.0, 0.5, 1.0])
def test_analyze_tensor_stateless(p, order):
    w = _weights((2, 96, 80), seed=21)
    kw = dict(p_stuck=p, section_order=order, crossbars=5)
    jr, jw = jplanner.analyze_tensor(jnp.asarray(w), SPEC_J, jplanner.PlannerConfig(**kw),
                                     jax.random.PRNGKey(3))
    tr, tw = planner.analyze_tensor(_t(w), SPEC_T, planner.PlannerConfig(**kw), prng.PRNGKey(3))
    assert_reports_equal(jr, tr)
    assert tr.offset == float(w.min()) and tw.dtype == torch.float32
    assert _same_bytes(jw, tw.numpy())


def test_sort_key_ties_signed_zero_and_padding():
    """The signed key sorts -0.0, +0.0 and the zero padding as ties in
    source order, as the reference's float sort does, with or without a
    -0.0 key reaching the sort."""
    w = np.array([0.3, -0.0, -0.2, 0.0, -0.0, 0.1, -0.2, 0.0], np.float32)
    padded = np.pad(w, (0, 8))
    key = planner._sort_key(_t(padded), OB)
    assert not torch.signbit(key).logical_and(key == 0).any()
    perm, inv = planner._perm_full_with_inverse(
        _t(padded), planner.CrossbarSpec(rows=8, encoding=OB), planner.PlannerConfig(),
        _t(np.zeros(16, np.int32)))
    jperm = jplanner._perm_full(jnp.asarray(padded), jplanner.CrossbarSpec(rows=8, encoding=OB),
                                jplanner.PlannerConfig(), jnp.zeros(16, jnp.int32))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(perm.numpy(), np.argsort(padded, kind="stable"))
    np.testing.assert_array_equal(perm[inv].numpy(), np.arange(16))


@pytest.mark.parametrize("p", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("leveling", ["none", "lpt"])
def test_analyze_tensors_through_pool(p, leveling):
    """Two tensors in turn through one pool: reports, w_hat bytes, pool
    state and per-cell wear equal the reference's."""
    jp = jpool.CrossbarPool(SPEC_J, 8, leveling=leveling)
    tp = pool.CrossbarPool(SPEC_T, 8, leveling=leveling, device="cpu")
    for i, shape in enumerate([(64, 80), (3, 40, 50)]):
        w = _weights(shape, seed=30 + i, shift=-0.02 * i)
        jr, jw = jplanner.analyze_tensor(jnp.asarray(w), SPEC_J,
                                         jplanner.PlannerConfig(p_stuck=p, crossbars=8),
                                         jax.random.PRNGKey(i), name=f"w{i}", pool=jp)
        tr, tw = planner.analyze_tensor(_t(w), SPEC_T,
                                        planner.PlannerConfig(p_stuck=p, crossbars=8),
                                        prng.PRNGKey(i), name=f"w{i}", pool=tp)
        assert_reports_equal(jr, tr)
        assert _same_bytes(jw, tw.numpy())
    assert np.asarray(jp.state).tobytes() == tp.state.tobytes()
    np.testing.assert_array_equal(np.asarray(jp.wear), tp.wear)


@pytest.fixture(scope="module")
def gemma_ob():
    """Reduced gemma-2b (float32) in both packages and its offset_binary
    plans at p_stuck 0.5: stateless, and through a pool."""
    jcfg = jax_get_arch("gemma-2b", reduced=True)
    jparams = japi.init(jax.random.PRNGKey(0), jcfg)
    tparams = from_numpy_tree(jax.tree.map(np.asarray, jparams), device="cpu")
    kw = dict(p_stuck=0.5, min_size=1024)
    plans = {"stateless": (
        jplanner.build_deployment(jparams, SPEC_J, jplanner.PlannerConfig(**kw)),
        planner.build_deployment(tparams, SPEC_T, planner.PlannerConfig(**kw), device="cpu"))}
    plans["pool"] = (
        jplanner.build_deployment(jparams, SPEC_J, jplanner.PlannerConfig(**kw),
                                  pool=jpool.CrossbarPool(SPEC_J, 16)),
        planner.build_deployment(tparams, SPEC_T, planner.PlannerConfig(**kw),
                                 pool=pool.CrossbarPool(SPEC_T, 16, device="cpu"), device="cpu"))
    tokens = np.asarray(japi.make_batch(jcfg, jax.random.PRNGKey(0), 2, 12)["tokens"])
    return jcfg, jparams, get_arch("gemma-2b", reduced=True), tparams, plans, tokens


@pytest.mark.parametrize("which", ["stateless", "pool"])
def test_build_deployment_reduced_gemma(gemma_ob, which):
    *_, plans, _ = gemma_ob
    jplan, tplan = plans[which]
    assert list(jplan.reports) == list(tplan.reports) and len(tplan.reports) >= 5
    for name in jplan.reports:
        assert_reports_equal(jplan.reports[name], tplan.reports[name])
        assert _same_bytes(jplan.deployed[name], tplan.deployed[name].numpy())
    assert jplan.totals() == tplan.totals()
    assert jplan.pool_stats == tplan.pool_stats


# ---------------------------------------------------------------------------
# Serving operands
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", ["raw", "const_rle", "col_perm_rle"])
def test_operands_from_dense_packed(gemma_ob, codec):
    """Packed operands of every planned tensor equal the reference's; the
    sign bits are all 0 (positive)."""
    _, _, _, _, plans, _ = gemma_ob
    jplan, tplan = plans["pool"]
    for name, w_hat in tplan.deployed.items():
        r = tplan.reports[name]
        jop = jsim.operands_from_dense(jplan.deployed[name], jplan.reports[name].scale,
                                       jplan.reports[name].offset, OB, 10, codec=codec)
        top = simulator.operands_from_dense(w_hat, r.scale, r.offset, OB, 10, codec=codec)
        assert top.keys() == jop.keys()
        for k in top:
            assert _same_bytes(jop[k], top[k].numpy()), (name, k)
        assert not top["sign_packed"].any()


def test_operands_from_dense_int8_planes(gemma_ob):
    """planes_int8 (B6's plain version on ``w_hat - offset``) equals the
    reference's planes, and its integers are ``round((w_hat - offset) /
    scale)`` on every planned tensor: no negative plane entry."""
    _, _, _, _, plans, _ = gemma_ob
    jplan, tplan = plans["stateless"]
    for name, w_hat in tplan.deployed.items():
        r = tplan.reports[name]
        jop = jsim.operands_from_dense(jplan.deployed[name], r.scale, r.offset, OB, 10,
                                       materialize="planes_int8")
        top = simulator.operands_from_dense(w_hat, r.scale, r.offset, OB, 10,
                                            materialize="planes_int8")
        np.testing.assert_array_equal(top["splanes"].numpy(), np.asarray(jop["splanes"]))
        for k in ("scale", "offset"):
            assert _same_bytes(jop[k], top[k].numpy())
        q = torch.round((w_hat - torch.tensor(r.offset)) / torch.tensor(r.scale)).to(torch.int32)
        weights = (2 ** torch.arange(10, dtype=torch.int32)).view(10, 1, 1)
        got = (top["splanes"].to(torch.int32) * weights).sum(dim=-3)
        assert torch.equal(got, q) and int(top["splanes"].min()) >= 0, name


def test_int8_planes_of_negative_zero_and_ulp():
    """A q = 0 cell whose ``w_hat - offset`` is -0.0 or a negative ulp
    slices to all-zero planes (B6's plain version, as the kernel)."""
    scale = torch.tensor(0.01)
    offset = torch.tensor(-0.3)
    d = torch.tensor([[-0.0, -1e-9, -1.4e-45, 0.0], [0.01, 0.02, 10.23, -0.0]])
    w_hat = d + offset
    w_hat[0] = torch.tensor([-0.3, -0.3, -0.3, -0.3])  # w_hat - offset == +0.0 exactly
    for x in (d, w_hat - offset):
        planes_ = bs_ops.bitslice_planes(x.contiguous(), 1.0 / scale, 10)
        assert int(planes_[:, 0].abs().sum()) == 0 and int(planes_.min()) >= 0
    op = simulator.operands_from_dense(w_hat, scale, offset, OB, 10, materialize="planes_int8")
    q = (op["splanes"].to(torch.int32) * (2 ** torch.arange(10)).view(-1, 1, 1)).sum(0)
    assert q.tolist() == [[0, 0, 0, 0], [1, 2, 1023, 0]]


@pytest.mark.parametrize("materialize,codec", [
    ("int8", "raw"), ("packed", "raw"), ("packed", "const_rle"), ("packed", "col_perm_rle")])
@pytest.mark.parametrize("encoding", ["sign_magnitude", OB])
def test_prepare_linear_matches_reference(encoding, materialize, codec):
    w = _weights((96, 40), seed=40, std=0.1, shift=0.05)
    jop = jsim.prepare_linear(jnp.asarray(w), jplanner.CrossbarSpec(encoding=encoding),
                              materialize=materialize, codec=codec)
    top = simulator.prepare_linear(_t(w), planner.CrossbarSpec(encoding=encoding),
                                   materialize=materialize, codec=codec)
    assert top.keys() == jop.keys()
    for k, v in top.items():
        if k == "encoding":
            assert v == jop[k] == encoding
        else:
            assert _same_bytes(jop[k], v.numpy()), k
    with pytest.raises(ValueError):
        simulator.prepare_linear(_t(w)[None], planner.CrossbarSpec(encoding=encoding))


@pytest.mark.parametrize("materialize,codec", [
    ("int8", "raw"), ("packed", "raw"), ("packed", "const_rle"), ("packed", "col_perm")])
@pytest.mark.parametrize("encoding", ["sign_magnitude", OB])
def test_cim_linear_matches_reference(encoding, materialize, codec):
    """``cim_linear`` within 1e-5 of the reference's, and of ``x @ w_hat``
    with the offset term added once, on every operand kind."""
    w = _weights((64, 32), seed=41, std=0.1, shift=0.05)
    x = np.random.default_rng(42).standard_normal((4, 64)).astype(np.float32)
    jop = jsim.prepare_linear(jnp.asarray(w), jplanner.CrossbarSpec(encoding=encoding),
                              materialize=materialize, codec=codec)
    top = simulator.prepare_linear(_t(w), planner.CrossbarSpec(encoding=encoding),
                                   materialize=materialize, codec=codec)
    jy = np.asarray(jsim.cim_linear(jnp.asarray(x), jop))
    ty = simulator.cim_linear(_t(x), top).numpy()
    np.testing.assert_allclose(ty, jy, rtol=FLOAT_TOL, atol=FLOAT_TOL)
    w_hat = bitslice.dequantize(bitslice.quantize(_t(w), 10, encoding)).reshape(w.shape)
    np.testing.assert_allclose(ty, x @ w_hat.numpy(), rtol=FLOAT_TOL, atol=FLOAT_TOL)


def test_deploy_and_probe_matches_reference(gemma_ob):
    jcfg, jparams, cfg, tparams, _, tokens = gemma_ob
    kw = dict(p_stuck=0.5, min_size=1024)
    jplan, jprobes = jsim.deploy_and_probe(
        lambda p, b: japi.forward(p, jcfg, b)[0], jparams, {"tokens": jnp.asarray(tokens)},
        SPEC_J, jplanner.PlannerConfig(**kw))
    tplan, tprobes = simulator.deploy_and_probe(
        lambda p, b: api.forward(p, cfg, b)[0], tparams, {"tokens": _t(tokens)},
        SPEC_T, planner.PlannerConfig(**kw), device="cpu")
    assert jplan.totals() == tplan.totals()
    assert tprobes.keys() == jprobes.keys()
    for k in jprobes:
        assert abs(tprobes[k] - jprobes[k]) <= FLOAT_TOL, (k, tprobes[k], jprobes[k])
    assert tprobes["top1_agreement"] > 0.5


@pytest.mark.parametrize("materialize", ["dense", "packed", "planes_int8"])
def test_generate_tokens_match_reference(gemma_ob, materialize):
    """Greedy tokens of the offset_binary deployment, served dense, packed
    and planes_int8, identical to the reference's."""
    jcfg, jparams, cfg, tparams, plans, tokens = gemma_ob
    jplan, tplan = plans["stateless"]
    jt, _ = jserve.generate(jcfg, jplanner.deploy_params(jparams, jplan, materialize=materialize),
                            {"tokens": jnp.asarray(tokens)}, gen_len=6)
    tt, _ = serve.generate(cfg, planner.deploy_params(tparams, tplan, materialize=materialize),
                           {"tokens": _t(tokens)}, gen_len=6)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


# ---------------------------------------------------------------------------
# The reference's offset_binary cases, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cols", [4, 8, 10, 16])
def test_quantize_roundtrip_error_bound(cols):
    """tests/test_bitslice.py: the error is at most half a step."""
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (512,)) * 0.05)
    qt = bitslice.quantize(_t(w), cols, OB)
    w_hat = bitslice.dequantize(qt)
    assert float((_t(w) - w_hat).abs().max()) <= float(qt.scale) * 0.5 + 1e-7


def test_offset_binary_encoding_roundtrip():
    """tests/test_planner.py: the plan's w_hat within half a step, SWS pays."""
    key = jax.random.PRNGKey(0)
    w = np.asarray(jax.random.normal(key, (128, 64)) * 0.02 + 0.01)
    rep, w_hat = planner.analyze_tensor(_t(w), SPEC_T, planner.PlannerConfig(p_stuck=1.0),
                                        prng.PRNGKey(0))
    step = float(w.max() - w.min()) / (2**10 - 1)
    assert float((_t(w) - w_hat).abs().max()) <= 0.5 * step + 1e-7
    assert rep.sws_speedup > 1.0
    jrep, jw = jplanner.analyze_tensor(jnp.asarray(w), SPEC_J, jplanner.PlannerConfig(p_stuck=1.0),
                                       key)
    assert_reports_equal(jrep, rep)
    assert _same_bytes(jw, w_hat.numpy())


def test_packed_bit_exact_across_encodings():
    """tests/test_planner_throughput.py (offset_binary): the packed plan's
    integers and w_hat, here against the reference's packed plan."""
    key = jax.random.PRNGKey(0)
    w = np.asarray(jax.random.normal(key, (128, 72)) * 0.03 + 0.01)
    jr, jw = jplanner.analyze_tensor(jnp.asarray(w), SPEC_J, jplanner.PlannerConfig(p_stuck=0.5),
                                     key)
    tr, tw = planner.analyze_tensor(_t(w), SPEC_T, planner.PlannerConfig(p_stuck=0.5),
                                    prng.PRNGKey(0))
    assert (tr.transitions_baseline, tr.transitions_sws, tr.transitions_final) == (
        jr.transitions_baseline, jr.transitions_sws, jr.transitions_final)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def test_cim_linear_offset_binary_correction():
    """tests/test_simulator.py: int8 operands with the rank-1 correction."""
    kx, kw = jax.random.split(jax.random.PRNGKey(0))
    x = _t(np.asarray(jax.random.normal(kx, (4, 64))))
    w = _t(np.asarray(jax.random.normal(kw, (64, 32)) * 0.1 + 0.05))
    y = simulator.cim_linear(x, simulator.prepare_linear(w, SPEC_T))
    w_hat = bitslice.dequantize(bitslice.quantize(w, 10, OB)).reshape(w.shape)
    torch.testing.assert_close(y, x @ w_hat, rtol=1e-4, atol=1e-4)


def test_cim_linear_packed_both_encodings():
    """tests/test_cim_packed.py: packed operands (offset term included)
    agree with x @ w_hat and with the int8 materialization."""
    kx, kw = jax.random.split(jax.random.PRNGKey(0))
    x = _t(np.asarray(jax.random.normal(kx, (4, 64))))
    w = _t(np.asarray(jax.random.normal(kw, (64, 32)) * 0.1 + 0.05))
    y = simulator.cim_linear(x, simulator.prepare_linear(w, SPEC_T, materialize="packed"))
    w_hat = bitslice.dequantize(bitslice.quantize(w, 10, OB)).reshape(w.shape)
    torch.testing.assert_close(y, x @ w_hat, rtol=1e-4, atol=1e-4)
    y8 = simulator.cim_linear(x, simulator.prepare_linear(w, SPEC_T))
    torch.testing.assert_close(y, y8, rtol=1e-5, atol=1e-5)


def test_operands_from_dense_bit_exact_planes():
    """tests/test_cim_packed.py: operands recovered from w_hat equal the
    quantizer's own planes and (all-positive) signs."""
    w = _t(np.asarray(jax.random.normal(jax.random.PRNGKey(0), (96, 40)) * 0.1))
    qt = bitslice.quantize(w, 10, OB)
    w_hat = bitslice.dequantize(qt).reshape(w.shape)
    got = simulator.operands_from_dense(w_hat, qt.scale, qt.offset, OB, 10)
    q, sign = qt.q.reshape(w.shape), qt.sign.reshape(w.shape)
    assert torch.equal(got["planes_packed"], bitslice.pack_linear_planes(q, 10))
    assert torch.equal(got["sign_packed"], bitslice.pack_linear_sign(sign))


# ---------------------------------------------------------------------------
# Kernels on offset_binary operands (need the card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _ob_weight(k, n, seed, dev):
    """A (k, n) weight quantized offset_binary on the card, its w_hat,
    scale and offset."""
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(k, n, device=dev, generator=g) * 0.05 + 0.02
    qt = bitslice.quantize(w, 10, OB)
    return bitslice.dequantize(qt).reshape(k, n), qt


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(64, 48), (2048, 256), (37, 1001)])
def test_bitslice_kernel_on_offset_difference(cuda_device, k, n):
    """B6 on ``w_hat - offset`` with -0.0 and negative-ulp cells at q = 0
    equals its plain version, and its integers are round((w_hat - offset) /
    scale) with no negative entry."""
    w_hat, qt = _ob_weight(k, n, k + n, cuda_device)
    d = (w_hat - qt.offset).contiguous()
    d.view(-1)[:4] = torch.tensor([-0.0, -1.4e-45, -1e-9, 0.0], device=cuda_device)
    inv = 1.0 / qt.scale
    bs_ops.reset_launches()
    got = bs_ops.bitslice_planes(d, inv, 10)
    assert bs_ops.LAUNCHES["B6"] == 1
    assert torch.equal(got, bs_ref.bitslice_planes(d, inv, 10))
    q = (got.to(torch.int32) * (2 ** torch.arange(10, device=cuda_device)).view(-1, 1, 1)).sum(0)
    want = torch.round(d / qt.scale).clamp(0, 1023).to(torch.int32)
    assert torch.equal(q, want) and int(got.min()) >= 0


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 2048, 256), (4, 2048, 2048), (128, 1001, 333)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("codec", ["raw", "const_rle"])
def test_packed_kernels_on_positive_signs(cuda_device, m, k, n, dtype, codec):
    """B2 (raw) and B4 (const_rle) on offset_binary operands, whose sign
    bits are all positive: tensor-core kernel for bf16 x, FMA kernel for f32
    x, within 2 * eps * K * (|x| @ |w|) of the plain version; B4 == B2."""
    w_hat, qt = _ob_weight(k, n, m + k + n, cuda_device)
    op = simulator.operands_from_dense(w_hat, qt.scale, qt.offset, OB, 10, codec=codec)
    assert not op["sign_packed"].any()
    x = torch.randn(m, k, device=cuda_device,
                    generator=torch.Generator(device=cuda_device).manual_seed(m)).to(dtype)
    args = (x, op["planes_packed"], op["sign_packed"], op["scale"])
    cim_ops.reset_launches()
    got = cim_ops.cim_matmul_packed(*args, tile_nz=op.get("plane_tile_nz"))
    kernel = "B4" if codec == "const_rle" else "B2"
    tc = {f"{kernel}_tc": 1} if dtype == torch.bfloat16 else {}
    assert {kk: v for kk, v in cim_ops.LAUNCHES.items() if v} == {kernel: 1, **tc}
    want = cim_ref.cim_matmul_packed(*args)
    w_abs = cim_ref.unpack_weights(op["planes_packed"], op["sign_packed"], k).abs() * op["scale"]
    assert bool(((got - want).abs() <= 2 * F32_EPS * k * (x.float().abs() @ w_abs)).all())
    if codec == "const_rle":
        assert torch.equal(got, cim_ops.cim_matmul_packed(*args))
    y = simulator.cim_linear(x, op)
    torch.testing.assert_close(y, want + x.float().sum(-1, keepdim=True) * qt.offset,
                               rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(4, 2048, 2048), (128, 2048, 256), (5, 1001, 333)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["fused_dequant", "planes"])
def test_int8_plane_kernel_on_offset_binary_planes(cuda_device, m, k, n, dtype, mode):
    """B5 on offset_binary int8 planes (built by B6 on ``w_hat - offset``)
    within 2 * eps * K * (|x| @ |w|) of its plain version."""
    w_hat, qt = _ob_weight(k, n, 7 * m + k + n, cuda_device)
    op = simulator.operands_from_dense(w_hat, qt.scale, qt.offset, OB, 10,
                                       materialize="planes_int8")
    x = torch.randn(m, k, device=cuda_device,
                    generator=torch.Generator(device=cuda_device).manual_seed(m)).to(dtype)
    cim_ops.reset_launches()
    got = cim_ops.cim_matmul(x, op["splanes"], op["scale"], mode=mode)
    assert cim_ops.LAUNCHES["B5"] == 1
    want = cim_ref.cim_matmul(x, op["splanes"], op["scale"], mode)
    w_abs = (w_hat - qt.offset).abs()
    assert bool(((got - want).abs() <= 2 * F32_EPS * k * (x.float().abs() @ w_abs)).all())
