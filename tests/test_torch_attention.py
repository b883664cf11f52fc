"""The port's attention against the JAX package, on the CPU.

``models.attention.blockwise_attention`` (the model's plain path) against
the reference's ``blockwise_attention``; ``kernels/flash_attention/ref``
(kernel B3's plain version) against the reference's Pallas kernel in
interpret mode and its jnp oracle; ``decode_attention`` with a window
against the reference's.  Inputs are made with numpy from a seed.
Tolerance 2e-5 absolute + relative (that of the reference's own kernel
test): both sides sum float32 products in different orders.  Every query
row sees at least one key (a row that sees none is NaN in the oracles).
The kernel itself is held against its plain version on the card
(``tests/test_torch_kernels_cuda.py``).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa_ops
from repro.kernels.flash_attention import ref as jfa_ref
from repro.models import attention as jattn
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import attention

TOL = 2e-5
WINDOW = 8


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _inputs(b, hq, hkv, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))


def _rows(b, sq, sk, per_row, seed):
    """(q_offset, kv_valid_len) as numpy: each row's queries are the last sq
    positions of its live extent, so every row sees at least one key."""
    if not per_row:
        return np.int32(sk - sq), None
    kvl = np.random.default_rng(seed).integers(sq, sk + 1, b).astype(np.int32)
    return kvl - sq, kvl


def _torch_rows(off, kvl):
    return (int(off) if np.ndim(off) == 0 else _t(off)), (None if kvl is None else _t(kvl))


CASES = [  # b, hq, hkv, sq, sk, d  (G = 1, 2, 4)
    (2, 2, 2, 12, 20, 8), (3, 4, 2, 9, 30, 16), (2, 4, 1, 16, 16, 8),
]


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d", CASES)
@pytest.mark.parametrize("kind", ["causal", "bidir", "swa"])
@pytest.mark.parametrize("per_row", [False, True])
def test_blockwise_attention_matches_reference(b, hq, hkv, sq, sk, d, kind, per_row):
    q, k, v = _inputs(b, hq, hkv, sq, sk, d, seed=sq + sk)
    off, kvl = _rows(b, sq, sk, per_row, seed=b)
    window = WINDOW if kind == "swa" else None
    want = jattn.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kind=kind, window=window,
        q_offset=jnp.asarray(off), block_k=8, kv_valid_len=None if kvl is None else jnp.asarray(kvl))
    toff, tkvl = _torch_rows(off, kvl)
    got = attention.blockwise_attention(_t(q), _t(k), _t(v), kind=kind, window=window,
                                        q_offset=toff, block_k=8, kv_valid_len=tkvl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d", CASES)
@pytest.mark.parametrize("kind", ["causal", "bidir", "swa"])
@pytest.mark.parametrize("per_row", [False, True])
def test_flash_attention_plain_matches_reference_kernel(b, hq, hkv, sq, sk, d, kind, per_row):
    """B3's plain version against the Pallas kernel (interpret mode) and its
    oracle; on CPU tensors the wrapper runs exactly the plain version."""
    q, k, v = _inputs(b, hq, hkv, sq, sk, d, seed=sq * sk)
    off, kvl = _rows(b, sq, sk, per_row, seed=b + 1)
    window = WINDOW if kind == "swa" else None
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None if kvl is None else jnp.asarray(kvl))
    jkw = dict(kind=kind, window=window, q_offset=jnp.asarray(off))
    toff, tkvl = _torch_rows(off, kvl)
    got = fa_ref.flash_attention(_t(q), _t(k), _t(v), tkvl, kind=kind, window=window, q_offset=toff)
    for want in (jfa_ops.flash_attention(*jargs, **jkw, bq=8, bk=8, interpret=True),
                 jfa_ref.flash_attention(*jargs, **jkw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    wrapped = fa_ops.flash_attention(_t(q), _t(k), _t(v), tkvl, kind=kind, window=window,
                                     q_offset=toff)
    assert torch.equal(wrapped, got)


def test_attention_dispatch_on_cpu_is_blockwise():
    """On CPU tensors the blocks' entry point is the plain blockwise path."""
    q, k, v = (_t(a) for a in _inputs(2, 4, 2, 10, 10, 8, seed=3))
    calls = attention.blockwise_attention.calls
    got = attention.attention(q, k, v, kind="causal")
    assert attention.blockwise_attention.calls == calls + 1
    assert torch.equal(got, attention.blockwise_attention(q, k, v, kind="causal"))


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("per_row", [False, True])
def test_decode_attention_matches_reference(window, per_row):
    b, hq, hkv, s, d = 3, 4, 2, 12, 8
    rng = np.random.default_rng(s)
    q = rng.standard_normal((b, hq, 1, d)).astype(np.float32)
    kc = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    vc = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    vl = np.array([5, 12, 9], np.int32) if per_row else 7
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                  jnp.asarray(vl), window=window)
    got = attention.decode_attention(_t(q), _t(kc), _t(vc), _t(vl) if per_row else vl,
                                     window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_attention_rejects_bad_arguments():
    q, k, v = (_t(a) for a in _inputs(1, 2, 1, 4, 4, 8, seed=0))
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, k, v, kind="local")
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, k, v, kind="swa")
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, k[..., :4], v, kind="causal")
    with pytest.raises(ValueError):
        attention.blockwise_attention(q, k, v, kind="swa")
