"""The port's threefry generator against ``jax.random`` (bit identity).

The planner's stuck-bit masks come from these draws, so any difference
would change every stucked plan.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import prng

SEEDS = (0, 1, 12345, 2**31 - 1)
SHAPES = ((128, 1), (7, 3), (1,), (5, 2, 3))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy()


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_and_split(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(jk).astype(np.int64), _np(tk))
    for num in (2, 3, 16):
        np.testing.assert_array_equal(
            np.asarray(jax.random.split(jk, num)).astype(np.int64), _np(prng.split(tk, num))
        )


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_uniform_bernoulli(seed, shape):
    jk = jax.random.split(jax.random.PRNGKey(seed), 3)[2]
    tk = prng.split(prng.PRNGKey(seed), 3)[2]
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64),
        _np(prng.random_bits(tk, shape)),
    )
    ju = np.asarray(jax.random.uniform(jk, shape))
    np.testing.assert_array_equal(ju.view(np.int32), _np(prng.uniform(tk, shape)).view(np.int32))
    for p in (0.0, 0.25, 0.5, 1.0):
        np.testing.assert_array_equal(
            np.asarray(jax.random.bernoulli(jk, jnp.float32(p), shape)),
            _np(prng.bernoulli(tk, p, shape)),
        )


def test_batched_keys_match_per_key_draws():
    """A batch of keys [L, T, 2] draws what each key draws alone — the form
    the stucking walk uses for every chain and step at once."""
    jkeys = jax.random.split(jax.random.PRNGKey(7), 4)
    tkeys = prng.split(prng.PRNGKey(7), 4)
    tsteps = prng.split(tkeys, 5)  # [4, 5, 2]
    masks = prng.bernoulli(tsteps, 0.5, (128, 1))
    for i in range(4):
        jsteps = jax.random.split(jkeys[i], 5)
        np.testing.assert_array_equal(np.asarray(jsteps).astype(np.int64), _np(tsteps[i]))
        for t in range(5):
            np.testing.assert_array_equal(
                np.asarray(jax.random.bernoulli(jsteps[t], jnp.float32(0.5), (128, 1))),
                _np(masks[i, t]),
            )
