"""The port's plane codecs and pool-backed plans against the JAX package, on the CPU.

Same inputs (numpy, seeded) through the reference and the port: encoded
payloads, physical and decoded planes, column orders, serving-operand
re-encodings and payload byte counts must be identical for every codec, and
so must a reduced gemma-2b plan streamed through a pool (integers,
``pool_stats`` and ``w_hat`` bytes; ``quant_mse`` within a relative 1e-6,
a float mean summed in another order).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core import planes as jplanes
from repro.core import planner as jplanner
from repro.core import pool as jpool
from repro.core import schedule as jsched
from repro.core import simulator as jsim
from repro.models import api as japi
from repro_torch import prng
from repro_torch.convert import from_numpy_tree
from repro_torch.core import planes, planner, pool, schedule, simulator

QUANT_MSE_RTOL = 1e-6


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _sws_like_packed(s, seed, rows=128, cols=10) -> np.ndarray:
    """Sorted magnitudes, so high planes are constant-zero in most sections
    (what SWS leaves) and neighbouring sections are similar."""
    rng = np.random.default_rng(seed)
    q = np.sort(np.clip(np.abs(rng.standard_normal(s * rows) * 60), 0, 2**cols - 1).astype(np.int64))
    planes_ = (q.reshape(s, rows)[:, :, None] >> np.arange(cols)) & 1
    packed = np.packbits(planes_.astype(np.uint8), axis=1)
    packed[s // 2, :, 2] = 0xFF  # an all-ones constant tile
    return packed


@pytest.mark.parametrize("pin", [0, 1, 2])
@pytest.mark.parametrize("kind", ["stride1", "strideL"])
@pytest.mark.parametrize("codec", ["raw", "const_rle", "col_perm", "col_perm_rle"])
def test_encode_physical_decode_bytes(codec, kind, pin):
    s = 41
    packed = _sws_like_packed(s, seed=1)
    jset = jplanes.encode(jnp.asarray(packed), codec, chains=jsched.make_chains(s, 5, kind),
                          pin_cols=pin)
    tset = planes.encode(_t(packed), codec, chains=schedule.make_chains(s, 5, kind), pin_cols=pin)
    assert tset.codec == jset.codec
    for f in ("payload", "col_order", "const_mask", "const_val"):
        a, b = getattr(jset, f), getattr(tset, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f)
    np.testing.assert_array_equal(np.asarray(jset.physical()), tset.physical().numpy())
    np.testing.assert_array_equal(tset.decode().numpy(), packed)
    assert jset.compression_stats() == tset.compression_stats()


@pytest.mark.parametrize("pin", [0, 1])
@pytest.mark.parametrize("s,l", [(60, 4), (7, 16), (1, 3)])
def test_plan_col_order(s, l, pin):
    packed = _sws_like_packed(s, seed=s)
    jo = jplanes.plan_col_order(jnp.asarray(packed), jsched.make_chains(s, l, "stride1"),
                                pin_cols=pin)
    to = planes.plan_col_order(_t(packed), schedule.make_chains(s, l, "stride1"), pin_cols=pin)
    assert to.dtype == np.int32
    np.testing.assert_array_equal(jo, to)


def test_greedy_assign_ties_and_batches():
    """Small integer costs make many ties: the first minimum must win, per
    matrix and in a batch."""
    m = np.random.default_rng(3).integers(0, 4, (50, 10, 10))
    for pin in (0, 1, 3, 10):
        want = np.stack([jplanes._greedy_assign(mm, pin) for mm in m])
        np.testing.assert_array_equal(planes._greedy_assign(m, pin), want)
        np.testing.assert_array_equal(planes._greedy_assign(m[7], pin), want[7])


def _operands(shape, seed=0):
    w = (np.random.default_rng(seed).standard_normal(shape) * 0.05).astype(np.float32)
    w[..., :128, :] *= 1e-2  # the first 128-row K block: high planes all zero
    scale = np.float32(0.05 * 3 / 1023)
    jop = jsim.operands_from_dense(jnp.asarray(w), scale, 0.0, "sign_magnitude", 10)
    top = simulator.operands_from_dense(_t(w), float(scale), 0.0, "sign_magnitude", 10)
    return jop, top


@pytest.mark.parametrize("shape", [(300, 24), (2, 256, 40)])
@pytest.mark.parametrize("codec", ["raw", "const_rle", "col_perm", "col_perm_rle"])
def test_encode_operands_and_payload_bytes(codec, shape):
    jop, top = _operands(shape, seed=len(shape))
    jenc = jplanes.encode_operands(jop, codec)
    tenc = planes.encode_operands(top, codec)
    assert sorted(jenc) == sorted(tenc)
    for k in ("planes_packed", "sign_packed", "plane_ids", "plane_tile_nz"):
        if k in jenc:
            np.testing.assert_array_equal(np.asarray(jenc[k]), tenc[k].numpy(), err_msg=k)
    if "plane_ids" in tenc:
        assert tenc["plane_ids"].dtype == torch.int32
    if "plane_tile_nz" in tenc:
        assert int(tenc["plane_tile_nz"].min()) == 0  # some tiles are skippable
    assert jplanes.operand_payload_bytes(jenc) == planes.operand_payload_bytes(tenc)
    assert np.asarray(jsim.densify_operands(jenc)).tobytes() == \
        simulator.densify_operands(tenc).numpy().tobytes()


def test_encode_operands_popcount_ties_keep_plane_order():
    q = np.zeros((16, 8), np.int32)
    q[:, :2] = 0b0000000101  # planes 0 and 2 hold equal bit counts
    q[:, 3] = 0b1000000000
    sign = np.ones_like(q, np.int8)
    jop = jsim.packed_operands(jnp.asarray(q), jnp.asarray(sign), 1.0, 0.0, 10)
    top = simulator.packed_operands(_t(q), _t(sign), 1.0, 0.0, 10)
    jids = np.asarray(jplanes.encode_operands(jop, "col_perm")["plane_ids"])
    np.testing.assert_array_equal(planes.encode_operands(top, "col_perm")["plane_ids"].numpy(), jids)
    assert list(jids[:3]) == [0, 2, 9]


# ---------------------------------------------------------------------------
# Plans through a pool on the reduced gemma-2b
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reduced_gemma():
    jcfg = jax_get_arch("gemma-2b", reduced=True)
    jparams = japi.init(jax.random.PRNGKey(0), jcfg)
    return jparams, from_numpy_tree(jax.tree.map(np.asarray, jparams), device="cpu")


def assert_plans_equal(jplan, tplan):
    assert list(jplan.reports) == list(tplan.reports)
    for name in jplan.reports:
        a, b = dataclasses.asdict(jplan.reports[name]), dataclasses.asdict(tplan.reports[name])
        for field in a:
            if field == "quant_mse":
                np.testing.assert_allclose(b[field], a[field], rtol=QUANT_MSE_RTOL)
            else:
                assert a[field] == b[field], (name, field)
        assert np.asarray(jplan.deployed[name]).tobytes() == tplan.deployed[name].numpy().tobytes()
    assert jplan.pool_stats == tplan.pool_stats


@pytest.mark.parametrize("codec,p,leveling", [
    ("raw", 0.5, "none"), ("const_rle", 0.5, "none"), ("col_perm", 0.5, "lpt"),
    ("col_perm_rle", 0.5, "rotate"), ("col_perm", 1.0, "none"),
])
def test_build_deployment_through_pool(reduced_gemma, codec, p, leveling):
    jparams, tparams = reduced_gemma
    kw = dict(p_stuck=p, min_size=1024, codec=codec)
    jspec, tspec = jplanner.CrossbarSpec(), planner.CrossbarSpec()
    jp = jpool.CrossbarPool(jspec, 16, leveling=leveling)
    tp = pool.CrossbarPool(tspec, 16, leveling=leveling, device="cpu")
    # the reference's config repeats the pool's leveling; the port's pool alone holds it
    jplan = jplanner.build_deployment(
        jparams, jspec, jplanner.PlannerConfig(**kw, pool_leveling=leveling), pool=jp)
    tplan = planner.build_deployment(tparams, tspec, planner.PlannerConfig(**kw), pool=tp,
                                     device="cpu")
    assert_plans_equal(jplan, tplan)
    np.testing.assert_array_equal(jp.wear, tp.wear)
    assert jp.state.tobytes() == tp.state.tobytes()


@pytest.mark.parametrize("codec", ["const_rle", "col_perm_rle"])
def test_stateless_codec_plan_routes_through_a_pristine_pool(codec):
    w = (np.random.default_rng(9).standard_normal((3, 96, 80)) * 0.02).astype(np.float32)
    jr, jw = jplanner.analyze_tensor(
        jnp.asarray(w), jplanner.CrossbarSpec(), jplanner.PlannerConfig(p_stuck=0.5, codec=codec),
        jax.random.PRNGKey(2))
    tr, tw = planner.analyze_tensor(
        _t(w), planner.CrossbarSpec(), planner.PlannerConfig(p_stuck=0.5, codec=codec),
        prng.PRNGKey(2))
    a, b = dataclasses.asdict(jr), dataclasses.asdict(tr)
    np.testing.assert_allclose(b.pop("quant_mse"), a.pop("quant_mse"), rtol=QUANT_MSE_RTOL)
    assert a == b
    assert np.asarray(jw).tobytes() == tw.numpy().tobytes()
