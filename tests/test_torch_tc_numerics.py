"""The arithmetic of the tensor-core paths of kernels B3 and B5, on the CPU.

The kernels run only on the card; these tests hold the argument that lets
them use bf16 tensor cores without loosening a tolerance, with plain-torch
emulations of what the kernels compute:

* B5 (int8-plane matmul, bf16 x): the integer weight w = sum_b 2^b P_b
  splits exactly as w = 256 * hi + lo with hi, lo exact in bf16, so
  scale * (256 * (x @ hi) + x @ lo), with f32 sums, stays within the
  kernel's bound 2 * eps_f32 * K * (|x| @ |w|) of the plain version (and of
  the reference's jnp oracle);
* B3 (flash attention, bf16 q/k/v): unscaled q . k^T on exact bf16
  products with f32 sums, the D^-0.5 scale after it, and P entering P . V
  as P_hi + P_lo (two bf16 values), tile by tile with the online softmax,
  stays within B3's unchanged ``attention_bound`` of the plain version; a
  single bf16 P does not.

Inputs come from numpy with fixed seeds.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cim_matmul import ref as jcim_ref
from repro_torch.core import simulator
from repro_torch.kernels.cim_matmul import ref as cim_ref
from repro_torch.kernels.flash_attention import ref as fa_ref

F32_EPS = torch.finfo(torch.float32).eps
SCALE = 0.02 / 1023
BK = 64  # keys per tile of B3's tensor-core kernel
WINDOW = 16


def _planes(rng, k, n, cols):
    q = torch.from_numpy(rng.integers(0, 2**cols, (k, n)).astype(np.int32))
    sign = torch.from_numpy(rng.choice(np.array([-1, 1], np.int8), (k, n)))
    return q, sign, simulator.int8_plane_operands(q, sign, SCALE, 0.0, cols)


@pytest.mark.parametrize("cols", [10, 16])
def test_weight_split_is_exact_in_bf16(cols):
    """Every integer |w| < 2**cols rebuilds exactly from its bf16 halves."""
    w = torch.arange(-(2**cols - 1), 2**cols, dtype=torch.int32)[None, :]
    op = simulator.int8_plane_operands(w.abs(), torch.where(w < 0, -1, 1).to(torch.int8),
                                       1.0, 0.0, cols)
    hi, lo = cim_ref.hi_lo(op["splanes"])
    for half in (hi, lo):
        assert int(half.abs().max()) <= 255
        assert torch.equal(half.to(torch.bfloat16).to(torch.int32), half)
    rebuilt = 256.0 * hi.to(torch.bfloat16).float() + lo.to(torch.bfloat16).float()
    assert torch.equal(rebuilt, w.float())


@pytest.mark.parametrize("m", [4, 128])
@pytest.mark.parametrize("n", [256, 1000, 2048])
@pytest.mark.parametrize("cols", [10, 16])
def test_split_matmul_within_b5_bound(m, n, cols):
    k = 2048
    rng = np.random.default_rng(m + n + cols)
    q, _, op = _planes(rng, k, n, cols)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(torch.bfloat16)
    hi, lo = cim_ref.hi_lo(op["splanes"])
    xf = x.float()
    got = (256.0 * (xf @ hi.to(torch.bfloat16).float())
           + xf @ lo.to(torch.bfloat16).float()) * op["scale"]
    bound = 2 * F32_EPS * k * (xf.abs() @ (q.float() * SCALE))
    want = cim_ref.cim_matmul(x, op["splanes"], op["scale"])
    assert bool(((got - want).abs() <= bound).all())
    want_jax = torch.from_numpy(np.array(jcim_ref.cim_matmul(
        jnp.asarray(xf.numpy()), jnp.asarray(op["splanes"].numpy()), jnp.float32(SCALE))))
    assert bool(((got - want_jax).abs() <= bound).all())


def _emulate_b3(q, k, v, kind, window, split):
    """B3's tensor-core arithmetic in f32: the GQA group packed into rows,
    64-key tiles, unscaled q . k^T then the scale, the -1e30 fill, the
    online softmax, and P . V with P as P_hi + P_lo (``split``) or as one
    bf16 value."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    g = hq // hkv
    qf = q.float().reshape(b, hkv, g * sq, d)
    kf, vf = k.float(), v.float()
    pos = torch.arange(g * sq) % sq
    m = torch.full((b, hkv, g * sq), -1e30)
    l = torch.zeros(b, hkv, g * sq)
    acc = torch.zeros(b, hkv, g * sq, d)
    for k0 in range(0, sk, BK):
        kp = torch.arange(k0, min(k0 + BK, sk))
        s = (qf @ kf[:, :, k0:k0 + BK].transpose(-1, -2)) * d**-0.5
        mask = torch.ones(g * sq, kp.numel(), dtype=torch.bool)
        if kind != "bidir":
            mask = kp[None, :] <= pos[:, None]
            if kind == "swa":
                mask = mask & (kp[None, :] > pos[:, None] - window)
        s = torch.where(mask, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        p_hi = p.to(torch.bfloat16).float()
        pv = p_hi @ vf[:, :, k0:k0 + BK]
        if split:
            pv = pv + (p - p_hi).to(torch.bfloat16).float() @ vf[:, :, k0:k0 + BK]
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, hq, sq, d).to(q.dtype)


def _attention_inputs(layout, s, seed):
    b, hq, hkv, d = layout
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
                 for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))


@pytest.mark.parametrize("layout,s", [
    ((1, 32, 4, 128), 32), ((1, 8, 1, 256), 32),  # yi-6b / gemma-2b groups of 8, Sq 32
])
@pytest.mark.parametrize("kind", ["causal", "bidir", "swa"])
def test_split_attention_within_b3_bound(layout, s, kind):
    q, k, v = _attention_inputs(layout, s, seed=sum(layout) + s)
    window = WINDOW if kind == "swa" else None
    got = _emulate_b3(q, k, v, kind, window, split=True)
    want = fa_ref.flash_attention(q, k, v, kind=kind, window=window)
    assert bool(((got.float() - want.float()).abs() <= fa_ref.attention_bound(want)).all())


@pytest.mark.parametrize("split", [True, False])
def test_long_prefill_needs_the_split(split):
    """1024 causal tokens: P_hi + P_lo holds the bound; a single bf16 P
    misses it where the output nearly cancels (an error of about 2^-9 of the
    weights against 2e-5 plus one output ulp)."""
    q, k, v = _attention_inputs((1, 8, 1, 128), 1024, seed=7)
    got = _emulate_b3(q, k, v, "causal", None, split=split)
    want = fa_ref.flash_attention(q, k, v, kind="causal")
    within = (got.float() - want.float()).abs() <= fa_ref.attention_bound(want)
    assert bool(within.all()) == split


@pytest.mark.parametrize("m,k,n,cols", [
    (1, 2048, 16384, 10), (4, 16384, 2048, 10), (4, 4096, 512, 10), (128, 2048, 16384, 10),
    (300, 1001, 333, 16), (17, 11008, 4096, 10),
])
def test_tensor_core_launch_plan_covers_k(m, k, n, cols):
    """B5's tensor-core plan: 64-row K stages, every K row in exactly one
    split, no split without work, and no slower (in waves x stages) than
    no split at all."""
    from repro_torch.kernels.cim_matmul import ops as cim_ops

    sms = 132
    nwg, splits, k_per_split = cim_ops.tc_launch_plan(m, k, n, cols, sms)
    assert nwg == (1 if m <= 64 else 2)
    assert k_per_split % 64 == 0 and (splits - 1) * k_per_split < k <= splits * k_per_split
    blocks = -(-n // (128 if cols <= 10 else 64)) * -(-m // (64 * nwg))
    tiles, fill = -(-k // 64), cim_ops.TC_FILL
    assert (-(-blocks * splits // sms) * (-(-tiles // splits) + fill)
            <= -(-blocks // sms) * (tiles + fill))
