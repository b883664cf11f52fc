"""The arithmetic of the tensor-core paths of kernels B2/B4, B3 and B5, on the CPU.

The kernels run only on the card; these tests hold the argument that lets
them use bf16 tensor cores without loosening a tolerance, with plain-torch
emulations of what the kernels compute:

* B5 (int8-plane matmul, bf16 x): the integer weight w = sum_b 2^b P_b
  splits exactly as w = 256 * hi + lo with hi, lo exact in bf16, so
  scale * (256 * (x @ hi) + x @ lo), with f32 sums, stays within the
  kernel's bound 2 * eps_f32 * K * (|x| @ |w|) of the plain version (and of
  the reference's jnp oracle);
* B2/B4 (bit-packed matmul, bf16 x): the kernel's dequantisation (an 8 x 8
  bit transpose of the plane words into lo = |w| mod 2^b and hi = |w| >> b,
  b = 7 for cols <= 10 and 8 above; 7-bit values to bf16 as s (128 + v) -
  s 128 in bf16, 8-bit ones through the f32 0x4B000000 trick with the sign
  XORed in) rebuilds ``unpack_weights`` exactly, and the split matmul
  stays within the same bound of the plain version and of the reference's
  jnp oracle;
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
from repro_torch.kernels.cim_matmul import ops as cim_ops
from repro_torch.core import bitslice, simulator
from repro_torch.kernels.cim_matmul import ref as cim_ref
from repro_torch.kernels.flash_attention import ref as fa_ref

F32_EPS = torch.finfo(torch.float32).eps
SCALE = 0.02 / 1023
BK = 64  # keys per tile of B3's tensor-core kernel
WINDOW = 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    sms = 132
    nwg, splits, k_per_split = cim_ops.tc_launch_plan(m, k, n, cols, sms)
    assert nwg == (1 if m <= 64 else 2)
    assert k_per_split % 64 == 0 and (splits - 1) * k_per_split < k <= splits * k_per_split
    blocks = -(-n // (128 if cols <= 10 else 64)) * -(-m // (64 * nwg))
    tiles, fill = -(-k // 64), cim_ops.TC_FILL
    assert (-(-blocks * splits // sms) * (-(-tiles // splits) + fill)
            <= -(-blocks // sms) * (tiles + fill))


# ---------------------------------------------------------------------------
# B2/B4: the bit-transpose dequantisation of the tensor-core kernel
# ---------------------------------------------------------------------------

_U32 = 0xFFFFFFFF


def _swap_bits(w, a, b, sh, mask):
    t = ((w[a] >> sh) ^ w[b]) & mask
    w[b] = w[b] ^ t
    w[a] = (w[a] ^ (t << sh)) & _U32


def _transpose8(w):
    """In each byte lane of 8 uint32 words: bit q of word p -> bit p of word q."""
    for sh, mask, pairs in ((4, 0x0F0F0F0F, ((0, 4), (1, 5), (2, 6), (3, 7))),
                            (2, 0x33333333, ((0, 2), (1, 3), (4, 6), (5, 7))),
                            (1, 0x55555555, ((0, 1), (2, 3), (4, 5), (6, 7)))):
        for a, b in pairs:
            _swap_bits(w, a, b, sh, mask)


def _bytes_to_bf16(byte, neg, lo_bits):
    """Exact signed bf16 of integer bytes, as the kernel builds them.

    lo_bits 7 (bytes < 128): the bf16 0x4300 | v | sign (s (128 + v)) minus
    the bf16 s 128, in bf16 (a zero comes out +0); lo_bits 8: f32
    0x4B000000 | v minus 2**23, rounded to bf16, with the sign bit set where
    ``neg``."""
    sign_bit = torch.where(neg, torch.tensor(-32768, dtype=torch.int16),
                           torch.tensor(0, dtype=torch.int16))
    if lo_bits == 7:
        assert int(byte.max()) < 128
        magic = ((byte | 0x4300).to(torch.int16) | sign_bit).view(torch.bfloat16)
        return magic - torch.where(neg, -128.0, 128.0).to(torch.bfloat16)
    f = ((byte | 0x4B000000).to(torch.int32).view(torch.float32) - 8388608.0).to(torch.bfloat16)
    return (f.view(torch.int16) | sign_bit).view(torch.bfloat16)


def lo_bits_of(cols):
    """Bits of lo in the kernel's split (its cols <= 10 template: 7)."""
    return 7 if cols <= 10 else 8


def emulate_packed_dequant(planes_packed, sign_packed, k, plane_ids=None):
    """The tensor-core kernel's hi, lo bf16[K, N] (w = 2**b * hi + lo,
    b = ``lo_bits_of(cols)``).

    Per byte row and group of 4 columns the kernel holds one little-endian
    word per plane (logical plane p read from stored plane inv[p]);
    transposing planes 0 .. b-1 leaves lo of K value 7 - q in word q,
    planes b .. cols-1 give hi; the sign byte's bits go into the bf16 sign
    bits.
    """
    cols, kb, n = planes_packed.shape
    n4 = -(-n // 4) * 4
    pp = torch.nn.functional.pad(planes_packed, (0, n4 - n)).to(torch.int64)
    sp = torch.nn.functional.pad(sign_packed, (0, n4 - n)).to(torch.int64)

    def words(t):  # [..., KB, N4] bytes -> [..., KB, N4 / 4] words, byte c = column 4 g + c
        t = t.reshape(*t.shape[:-1], n4 // 4, 4)
        return t[..., 0] | t[..., 1] << 8 | t[..., 2] << 16 | t[..., 3] << 24

    pw = words(pp)
    inv = (list(range(cols)) if plane_ids is None
           else torch.argsort(plane_ids.to(torch.int64)).tolist())
    zero = torch.zeros_like(pw[0])
    lb = lo_bits_of(cols)
    lo = [pw[inv[b]] if b < min(cols, lb) else zero for b in range(8)]
    hi = [pw[inv[b]] if b < cols else zero for b in range(lb, lb + 8)]
    _transpose8(lo)
    _transpose8(hi)
    sw = words(sp)
    out_hi = torch.empty(kb, 8, n4 // 4, 4, dtype=torch.bfloat16)  # [byte row, j, group, c]
    out_lo = torch.empty_like(out_hi)
    for c in range(4):
        for j in range(8):
            neg = ((sw >> (8 * c + 7 - j)) & 1).bool()
            out_hi[:, j, :, c] = _bytes_to_bf16((hi[7 - j] >> (8 * c)) & 255, neg, lb)
            out_lo[:, j, :, c] = _bytes_to_bf16((lo[7 - j] >> (8 * c)) & 255, neg, lb)
    return tuple(t.reshape(kb * 8, n4)[:k, :n] for t in (out_hi, out_lo))


def _packed(rng, k, n, cols):
    q = torch.from_numpy(rng.integers(0, 2**cols, (k, n)).astype(np.int32))
    sign = torch.from_numpy(rng.choice(np.array([-1, 1], np.int8), (k, n)))
    return q, bitslice.pack_linear_planes(q, cols), bitslice.pack_linear_sign(sign)


def _ids(rng, cols, permuted):
    return torch.from_numpy(rng.permutation(cols).astype(np.int32)) if permuted else None


@pytest.mark.parametrize("cols", [10, 16])
@pytest.mark.parametrize("permuted", [False, True])
@pytest.mark.parametrize("k,n", [(64, 128), (1001, 333)])
def test_packed_dequant_rebuilds_unpack_weights(cols, permuted, k, n):
    rng = np.random.default_rng(cols + k + n + permuted)
    q, planes_, signs = _packed(rng, k, n, cols)
    ids = _ids(rng, cols, permuted)
    if ids is not None:  # stored plane p holds logical plane ids[p]
        planes_ = planes_[ids.to(torch.int64)]
    hi, lo = emulate_packed_dequant(planes_, signs, k, ids)
    lb = lo_bits_of(cols)
    assert torch.equal(lo.float().abs(), (q % 2**lb).float())
    assert torch.equal(hi.float().abs(), (q >> lb).float())
    got = 2.0**lb * hi.float() + lo.float()
    want = cim_ref.unpack_weights(planes_, signs, k, ids)
    assert torch.equal(got, want)
    assert torch.equal(got.abs(), q.float())
    # the sign sits in both halves (a zero may come out +0)
    neg = torch.from_numpy(np.unpackbits(signs.numpy(), axis=0, count=k).astype(bool))
    for half in (hi, lo):
        assert half.dtype == torch.bfloat16
        nz = half != 0
        assert torch.equal(torch.signbit(half)[nz], neg[nz])


@pytest.mark.parametrize("m", [4, 128])
@pytest.mark.parametrize("cols", [10, 16])
@pytest.mark.parametrize("permuted", [False, True])
def test_packed_split_matmul_within_b2_bound(m, cols, permuted):
    k, n = 2048, 520
    rng = np.random.default_rng(m + cols + permuted)
    q, planes_, signs = _packed(rng, k, n, cols)
    ids = _ids(rng, cols, permuted)
    if ids is not None:
        planes_ = planes_[ids.to(torch.int64)]
    scale = torch.tensor(SCALE, dtype=torch.float32)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(torch.bfloat16)
    xf = x.float()
    hi, lo = emulate_packed_dequant(planes_, signs, k, ids)
    got = (2.0**lo_bits_of(cols) * (xf @ hi.float()) + xf @ lo.float()) * scale
    bound = 2 * F32_EPS * k * (xf.abs() @ (q.float() * SCALE))
    want = cim_ref.cim_matmul_packed(x, planes_, signs, scale, ids)
    assert bool(((got - want).abs() <= bound).all())
    want_jax = torch.from_numpy(np.array(jcim_ref.cim_matmul_packed(
        jnp.asarray(xf.numpy()), jnp.asarray(planes_.numpy()), jnp.asarray(signs.numpy()),
        jnp.float32(SCALE), plane_ids=None if ids is None else jnp.asarray(ids.numpy()))))
    assert bool(((got - want_jax).abs() <= bound).all())


@pytest.mark.parametrize("m,k,n", [
    (m, k, n) for k, n in ((2048, 2048), (2048, 256), (2048, 16384), (16384, 2048))
    for m in (1, 4, 128)] + [(5, 1001, 333), (4, 4096, 64000), (300, 11008, 4096)])
def test_packed_tensor_core_launch_plan_covers_k(m, k, n):
    """B2/B4's tensor-core plan at the shapes chip_smoke.py checks: 64-row K
    stages (so none straddles one of B4's 128-row flag tiles), every K row
    in exactly one split, no split without work, and no slower (in waves x
    stages) than no split at all."""
    sms = 132
    nwg, splits, k_per_split = cim_ops.tc_packed_launch_plan(m, k, n, sms)
    assert nwg == (1 if m <= 64 else 2)
    assert k_per_split % 64 == 0 and (splits - 1) * k_per_split < k <= splits * k_per_split
    blocks = -(-n // 128) * -(-m // (64 * nwg))
    tiles, fill = -(-k // 64), cim_ops.TC_FILL
    assert (-(-blocks * splits // sms) * (-(-tiles // splits) + fill)
            <= -(-blocks // sms) * (tiles + fill))
