"""The port's bool-plane cost functions against the JAX package, on the CPU.

``pair_transitions`` (Eq. 1 on bool planes), ``active_fraction_per_column``
and ``transition_fraction_per_column`` (the paper's §IV observation) take
the same planes, made from a seed with numpy, in both packages.  The
integer counts must be identical.  The two float32 fractions must agree
within ``FRAC_RTOL`` relative: XLA:CPU's reduction order is its own per
shape, while the port counts integers and divides once (exact while a
column holds fewer than 2^24 cells, so it is identical here in fact).  The
properties of ``tests/test_cost.py`` are held on the port's own functions.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, strategies as st

from repro.core import bitslice as rbitslice
from repro.core import cost as rcost
from repro_torch import prng
from repro_torch.core import bitslice, cost

FRAC_RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _planes(seed: int, *shape: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 2, shape).astype(bool)


@pytest.mark.parametrize("shape", [(4, 16, 8), (6, 40, 10), (3, 5, 13, 7), (16, 1)])
def test_pair_transitions_equal_reference(shape):
    a, b = _planes(1, *shape), _planes(2, *shape)
    got = cost.pair_transitions(torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(rcost.pair_transitions(jnp.asarray(a), jnp.asarray(b)))
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(8, 16, 10), (5, 37, 16), (2, 3, 9, 4)])
def test_active_fraction_equals_reference(shape):
    p = _planes(3, *shape)
    got = cost.active_fraction_per_column(torch.from_numpy(p))
    want = np.asarray(rcost.active_fraction_per_column(jnp.asarray(p)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=FRAC_RTOL, atol=0)


@pytest.mark.parametrize("ordered", [False, True])
@pytest.mark.parametrize("shape", [(10, 16, 8), (7, 130, 10), (1, 8, 4)])
def test_transition_fraction_equals_reference(shape, ordered):
    p = _planes(4, *shape)
    order = np.random.default_rng(5).permutation(shape[0]).astype(np.int32) if ordered else None
    got = cost.transition_fraction_per_column(
        torch.from_numpy(p), None if order is None else torch.from_numpy(order).long())
    want = np.asarray(rcost.transition_fraction_per_column(
        jnp.asarray(p), None if order is None else jnp.asarray(order)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=FRAC_RTOL, atol=0)


def test_pair_transitions_identity_and_symmetry():
    a, b = (torch.from_numpy(_planes(s, 4, 16, 8)) for s in (0, 1))
    assert int(cost.pair_transitions(a, a).sum()) == 0
    torch.testing.assert_close(cost.pair_transitions(a, b), cost.pair_transitions(b, a))


@given(seed=st.integers(0, 100))
def test_hamming_triangle_inequality(seed):
    a, b, c = (torch.from_numpy(_planes(seed + i, 3, 8, 6)) for i in range(3))
    ab, bc, ac = (cost.pair_transitions(x, y) for x, y in ((a, b), (b, c), (a, c)))
    assert bool((ac <= ab + bc).all())


def test_packed_matches_bool_path():
    a, b = (torch.from_numpy(_planes(s, 6, 40, 10)) for s in (2, 3))
    torch.testing.assert_close(
        cost.pair_transitions_packed(bitslice.pack_rows(a), bitslice.pack_rows(b)),
        cost.pair_transitions(a, b))


def test_transition_fraction_sums_to_one_and_zero_chain():
    p = torch.from_numpy(_planes(6, 9, 16, 8))
    assert abs(float(cost.transition_fraction_per_column(p).sum()) - 1.0) < 1e-6
    still = p[:1].expand(4, -1, -1).contiguous()  # no transition along the chain
    assert torch.equal(cost.transition_fraction_per_column(still), torch.zeros(8))


def test_low_order_columns_carry_transition_mass():
    """§IV: under a sorted order the transition mass of bell-shaped weights
    sits in the low-order columns, and the LSB is active ~half the time;
    the port's numbers equal the reference's on the same weights."""
    w = prng.normal(prng.PRNGKey(0), (128 * 64,)) * 0.02
    qt = bitslice.quantize(w, 10)
    order = torch.argsort(w.abs(), stable=True)
    planes = bitslice.bitplanes(qt.q[order].reshape(64, 128), 10)
    frac = cost.transition_fraction_per_column(planes)
    assert float(frac[:5].sum()) > 0.75
    assert bool((frac[5:-1] >= frac[6:]).all())
    active = cost.active_fraction_per_column(planes)
    assert 0.4 <= float(active[0]) <= 0.6

    rw = jax.random.normal(jax.random.PRNGKey(0), (128 * 64,)) * 0.02
    rq = rbitslice.quantize(rw, 10)
    rplanes = rbitslice.bitplanes(rq.q[jnp.argsort(jnp.abs(rw), stable=True)].reshape(64, 128), 10)
    np.testing.assert_array_equal(planes.numpy(), np.asarray(rplanes))
    np.testing.assert_allclose(frac.numpy(), np.asarray(rcost.transition_fraction_per_column(
        rplanes)), rtol=FRAC_RTOL, atol=0)
    np.testing.assert_allclose(active.numpy(), np.asarray(rcost.active_fraction_per_column(
        rplanes)), rtol=FRAC_RTOL, atol=0)
