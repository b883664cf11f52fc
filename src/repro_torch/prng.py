"""Key-based threefry2x32 generator, bit-identical with ``jax.random``.

The planner's stuck-bit masks are ``jax.random.bernoulli`` draws under keys
split from ``PRNGKey(seed)`` (``core/planner.py`` per tensor,
``core/stucking.py`` per chain and per step).  A plan can only match the
reference bit for bit if the port draws the same bits, so this module is
the counterpart of the calls the planner makes, under jax's default
``threefry2x32`` with ``jax_threefry_partitionable=True``:

* ``PRNGKey(seed)`` -> ``[seed >> 32, seed & 0xFFFFFFFF]``;
* ``split(key, n)`` -> key ``i`` is ``threefry(key, (0, i))``;
* ``random_bits(key, shape)`` -> ``y0 ^ y1`` of ``threefry(key, (hi, lo))`` of
  each element's flat index;
* ``uniform`` puts the top 23 bits in the mantissa of ``[1, 2)`` and
  subtracts 1, then scales to ``[minval, maxval)``; ``bernoulli(key, p)`` is
  ``uniform < p`` in float32;
* ``normal`` is ``sqrt(2) * erf_inv(uniform(key, shape, nextafter(-1, 0),
  1))`` with XLA:CPU's float32 ``log1p`` and ``erf_inv`` transcribed step
  for step, fused multiply-adds included, so the paper figures' weights
  (``benchmarks_torch.common``) are the reference's bit for bit;
* ``truncated_normal(key, lo, hi)`` is ``sqrt(2) * erf_inv(uniform(key,
  minval=erf(lo / sqrt2), maxval=erf(hi / sqrt2)))`` clipped to the open
  interval, with XLA's float32 ``erf`` (a clamped rational, fused), so
  ``models.transformer.init`` draws the reference's initial weights;
* ``gumbel`` is ``-log(-log(uniform(key, minval=tiny, maxval=1)))`` with
  XLA:CPU's float32 ``log`` (the ``log`` inside ``log1p``), and
  ``categorical(key, logits)`` the argmax of ``gumbel + logits``, so
  sampled decode (``launch.steps``) picks the reference's tokens;
* ``fold_in(key, data)`` is ``threefry(key, (0, data))``; ``randint`` draws
  two 32-bit words per element (keys ``split(key)``) and reduces them with
  the ``2**16 % span`` multiplier identity in uint32, as jax does; the data
  pipeline (``data.pipeline``) keys its batches with both.

Draws of more than ``CHUNK`` elements are hashed and transformed one chunk
of flat indices at a time, so a 500M-weight embedding never needs more than
a few chunk-sized int64 and float64 temporaries.

A key is an int64 tensor ``[..., 2]`` holding two uint32 words: torch has no
full uint32 arithmetic, so every sum is taken in int64 and masked with
``0xFFFFFFFF``.  Every function takes a batch of keys (leading dims) and
broadcasts it against the drawn shape, so a whole schedule's per-step masks
come from one call.  The generator is explicit: no global state.
"""
from __future__ import annotations

import math

import torch

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def PRNGKey(seed: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """Raw key of an integer seed (the 64-bit seed cast to two uint32 words)."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([seed >> 32, seed & _M], dtype=torch.int64, device=device)


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) & _M) | (v >> (32 - r))


def threefry2x32(
    k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash (20 rounds), elementwise on broadcast int64 words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M
    x1 = (x1 + ks[1]) & _M
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M
    return x0, x1


CHUNK = 1 << 24  # flat elements hashed and transformed per pass (see _draw)


def _hash_range(key: torch.Tensor, start: int, stop: int) -> tuple[torch.Tensor, torch.Tensor]:
    """threefry(key, flat index as (hi, lo)) for the flat indices [start,
    stop); keys ``[..., 2]`` broadcast over them -> two ``[..., stop - start]``
    word tensors."""
    idx = torch.arange(start, stop, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1] + (1,)
    return threefry2x32(key[..., 0].reshape(lead), key[..., 1].reshape(lead), idx >> 32, idx & _M)


def _hash_iota(key: torch.Tensor, shape: tuple[int, ...]) -> tuple[torch.Tensor, torch.Tensor]:
    """threefry(key, flat index) for every element of ``shape`` -> two
    ``[..., *shape]`` word tensors."""
    y0, y1 = _hash_range(key, 0, math.prod(shape))
    out = key.shape[:-1] + tuple(shape)
    return y0.reshape(out), y1.reshape(out)


def _draw(key: torch.Tensor, shape: tuple[int, ...], transform, dtype=torch.float32) -> torch.Tensor:
    """``transform(bits)`` of the 32 random bits of every element of
    ``shape`` (keys ``[..., 2]`` broadcast), one chunk of at most ``CHUNK``
    elements (over all keys) at a time; ``transform`` is elementwise."""
    shape = tuple(shape)
    lead = key.shape[:-1]
    n = math.prod(shape)
    step = max(1, CHUNK // max(math.prod(lead), 1))
    if n <= step:
        y0, y1 = _hash_range(key, 0, n)
        return transform(y0 ^ y1).reshape(lead + shape)
    out = torch.empty(lead + (n,), dtype=dtype, device=key.device)
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        y0, y1 = _hash_range(key, lo, hi)
        out[..., lo:hi] = transform(y0 ^ y1)
    return out.reshape(lead + shape)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: keys ``[..., 2]`` -> ``[..., num, 2]``."""
    y0, y1 = _hash_iota(key, (num,))
    return torch.stack([y0, y1], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: keys ``[..., 2]`` -> ``[..., 2]``, the hash
    of the count pair ``(0, data)`` (``data`` taken as uint32)."""
    zero = torch.zeros((), dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], zero, zero + (int(data) & _M))
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """32 random bits per element (uint32 values in int64): ``[..., *shape]``."""
    return _draw(key, shape, lambda bits: bits, dtype=torch.int64)


def randint(key: torch.Tensor, shape: tuple[int, ...], minval: int, maxval: int) -> torch.Tensor:
    """int32 integers in [minval, maxval), same values as
    ``jax.random.randint(key, shape, minval, maxval, jnp.int32)``.

    Two words per element (``split(key)``: the high from the first key, the
    low from the second), reduced mod ``span`` with ``(hi % span) * (2**32
    % span) + lo % span``, where ``2**32 % span`` is ``(2**16 % span)**2 %
    span``; every product and sum wraps at 32 bits, as jax's uint32 does.
    """
    if not (-(1 << 31) <= minval and maxval <= (1 << 31) - 1):
        raise ValueError(f"randint bounds [{minval}, {maxval}) outside int32")
    k1, k2 = split(key).unbind(-2)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = (maxval - minval) & _M if maxval > minval else 1
    mult = (1 << 16) % span
    mult = ((mult * mult) & _M) % span
    offset = ((((higher % span) * mult) & _M) + lower % span) & _M
    return (minval + offset % span).to(torch.int32)


def _f32(bits: int, device) -> torch.Tensor:
    """A float32 scalar from its IEEE bit pattern (exact, no decimal rounding),
    filled on ``device`` (no host-to-device copy: a CUDA graph can capture it)."""
    signed = bits - (1 << 32) if bits >= 1 << 31 else bits
    return torch.full((), signed, dtype=torch.int32, device=device).view(torch.float32)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add rounds it.

    The product of two float32 values is exact in float64.  The float64 sum
    is made round-to-odd (TwoSum gives its exact error; an inexact sum with
    an even last bit steps one ulp toward the exact value), and a
    round-to-odd float64 rounds to the correctly rounded float32.  Every
    step is a separate IEEE operation, so the result is the same on every
    device.
    """
    p = a.to(torch.float64) * b.to(torch.float64)
    cd = c.to(torch.float64)
    s = p + cd
    bv = s - p
    err = (p - (s - bv)) + (cd - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, math.inf, -math.inf).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _f64_exact(op, *args: torch.Tensor) -> torch.Tensor:
    """float32 ``op`` (``torch.div`` or ``torch.sqrt``), correctly rounded.

    torch's float32 ``sqrt`` on the CPU is not correctly rounded.  In
    float64 the result rounds once more to float32, which for a quotient or
    a square root gives the correctly rounded float32 (53 >= 2 * 24 + 2).
    """
    return op(*(a.to(torch.float64) for a in args)).to(torch.float32)


def _uniform_from_bits(bits: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    dev = bits.device
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - _f32(0x3F800000, dev)
    if minval == 0.0 and maxval == 1.0:
        return floats  # floats * 1 + 0 and max(0, .) change no bit
    lo = torch.full((), minval, dtype=torch.float32, device=dev)
    hi = torch.full((), maxval, dtype=torch.float32, device=dev)
    return torch.maximum(lo, _fma(floats, hi - lo, lo))


def uniform(
    key: torch.Tensor, shape: tuple[int, ...], minval: float = 0.0, maxval: float = 1.0
) -> torch.Tensor:
    """float32 uniform on [minval, maxval), same bits as ``jax.random.uniform``.

    jax puts the top 23 bits in the mantissa of ``[1, 2)``, subtracts 1,
    then takes ``max(minval, floats * (maxval - minval) + minval)`` with the
    bounds and their difference rounded to float32; XLA:CPU fuses the
    multiply-add.
    """
    return _draw(key, shape, lambda bits: _uniform_from_bits(bits, minval, maxval))


# XLA:CPU's float32 ``log1p`` (Eigen's ``plog`` of 1 + x; a rational for
# small |x|) and ``ErfInv32`` constants, as IEEE bit patterns.
_LOG_P = (0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A, 0xBDFE5D4F, 0x3E11E9BF, 0xBE2AAE50,
          0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA)
_LOG_Q1, _LOG_Q2 = 0xB95E8083, 0x3F318000
_LOG1P_NUM = (0x383DE04B, 0x3EFF40C5, 0x40D284FA, 0x41EF4B9C, 0x4273CC76, 0x426473AD,
              0x41A05101)
_LOG1P_DEN = (0x3F800000, 0x417101AD, 0x42A6185B, 0x435DC32D, 0x439A8CA3, 0x43586D8A,
              0x42707982)
_ERFINV_LT5 = (0x32F16588, 0x34B84B36, 0xB66C7357, 0xB6935AC1, 0x396532DB, 0xBAA45408,
               0xBB88E4EF, 0x3E7C8F63, 0x3FC02E2F)
_ERFINV_GE5 = (0xB951F09B, 0x38D3B56B, 0x3AB0DC72, 0xBB70BDE7, 0x3BBC127B, 0xBBF9C5D7,
               0x3C1AA57E, 0x3F8036DB, 0x40354F7E)
_INF, _HALF, _ONE, _TINY = 0x7F800000, 0x3F000000, 0x3F800000, 0x00800000


def _log(a: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 ``log``, operation for operation.

    frexp (mantissa in [0.5, 1)) and the Cephes polynomial, with the
    special values at 0, +inf and below 0; subnormal inputs count as zero,
    as XLA:CPU's flush-to-zero mode reads them.  ``_fma`` stands where
    XLA:CPU's machine code fuses a multiply into the add that uses it
    (x86-64 with FMA); every other step is one rounded operation.
    """
    dev = a.device
    c = lambda b: _f32(b, dev)  # noqa: E731
    one, zero, inf = c(_ONE), c(0), c(_INF)
    tiny = c(_TINY)
    a = torch.where(a.abs() < tiny, zero, a)
    bits = torch.where(a > tiny, a, tiny).view(torch.int32)
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    e = ((bits >> 23) - 127).to(torch.float32) + one
    small_m = m < c(0x3F3504F3)
    e = e - torch.where(small_m, one, zero)
    t = (m - one) + torch.where(small_m, m, zero)
    t2 = t * t
    t3 = t2 * t
    y0 = _fma(t, c(_LOG_P[0]), c(_LOG_P[1]))
    y1 = _fma(t, c(_LOG_P[3]), c(_LOG_P[4]))
    y2 = _fma(t, c(_LOG_P[6]), c(_LOG_P[7]))
    y0 = _fma(t, y0, c(_LOG_P[2]))
    y1 = _fma(t, y1, c(_LOG_P[5]))
    y2 = _fma(t, y2, c(_LOG_P[8]))
    y = _fma(t3, _fma(t3, _fma(t3, y0, y1), y2), e * c(_LOG_Q1))
    log_a = _fma(e, c(_LOG_Q2), y + _fma(t2, -c(_HALF), t))
    bad = torch.where(a != zero, torch.where(a != inf, 0, _INF), _INF | 1 << 31)
    ok = torch.where(~(a > zero), -1, log_a.view(torch.int32))
    ok = torch.where((a != zero) & (a != inf), ok, 0)
    return (bad.to(torch.int32) | ok).view(torch.float32)


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 ``log1p``, operation for operation: for ``|x| <
    sqrt(2) - 1`` a rational in ``x`` (its Horner steps fused), otherwise
    :func:`_log` of ``1 + x``."""
    dev = x.device
    c = lambda b: _f32(b, dev)  # noqa: E731
    zero = c(0)
    log_a = _log(x + c(_ONE))
    # the rational for small |x|
    x2 = x * x
    z = x * zero
    den = z + c(_LOG1P_DEN[0])
    for b in _LOG1P_DEN[1:]:
        den = _fma(x, den, c(b))
    num = z + c(_LOG1P_NUM[0])
    for b in _LOG1P_NUM[1:]:
        num = _fma(x, num, c(b))
    small = x + _fma(x2, -c(_HALF), (x * x2) * _f64_exact(torch.div, num, den))
    return torch.where(x.abs() < c(0x3ED413CD), small, log_a)


def _erf_inv(u: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``ErfInv32``: a 9-term Horner chain (fused) in
    ``w - 2.5`` or ``sqrt(w) - 3``, ``w = -log1p(-u * u)``; ``+-inf`` at
    ``|u| == 1``."""
    dev = u.device
    c = lambda b: _f32(b, dev)  # noqa: E731
    lg = _log1p(u * -u)
    lt5 = lg > c(0xC0A00000)  # w < 5
    v = torch.where(lt5, c(0xC0200000) - lg, _f64_exact(torch.sqrt, -lg) + c(0xC0400000))
    sel = lambda i: torch.where(lt5, c(_ERFINV_LT5[i]), c(_ERFINV_GE5[i]))  # noqa: E731
    p = sel(0)
    for i in range(1, 9):
        p = _fma(v, p, sel(i))
    p = torch.where(u.abs() == c(_ONE), c(_INF), p)
    return u * p


# XLA's float32 ``erf`` (``EmitErfF32``): x clamped to +-3.7439211627767994,
# then x * alpha(x^2) / beta(x^2), each polynomial a fused Horner chain
_ERF_CLAMP = 3.7439211627767994
_ERF_ALPHA = (0.00022905065861350646, 0.0034082910107109506, 0.050955695062380861,
              0.18520832239976145, 1.128379143519084)
_ERF_BETA = (-1.1791602954361697e-7, 0.000023547966471313185, 0.0010179625278914885,
             0.014070470171167667, 0.11098505178285362, 0.49746925110067538, 1.0)


def erf(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 ``erf``, operation for operation (fused Horner
    steps, a correctly rounded division)."""
    c = lambda v: torch.tensor(v, dtype=torch.float32, device=x.device)  # noqa: E731
    xc = torch.clamp(x, -c(_ERF_CLAMP), c(_ERF_CLAMP))
    x2 = xc * xc

    def poly(coeffs):
        p = c(coeffs[0]).expand_as(x2)
        for k in coeffs[1:]:
            p = _fma(p, x2, c(k))
        return p

    return _f64_exact(torch.div, xc * poly(_ERF_ALPHA), poly(_ERF_BETA))


_SQRT2 = 0x3FB504F3  # float32(sqrt(2))


def normal(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """float32 standard normal, same bits as ``jax.random.normal`` on XLA:CPU.

    ``sqrt(2) * erf_inv(uniform(key, shape, nextafter(-1, 0), 1))`` with
    jax's float32 constants and XLA:CPU's ``log1p`` and ``ErfInv32`` (see
    :func:`_log1p`).
    """
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    sqrt2 = _f32(_SQRT2, key.device)
    return _draw(key, shape, lambda bits: _erf_inv(_uniform_from_bits(bits, lo, 1.0)) * sqrt2)


def truncated_normal(
    key: torch.Tensor, lower: float, upper: float, shape: tuple[int, ...]
) -> torch.Tensor:
    """float32 normal truncated to (lower, upper), same bits as
    ``jax.random.truncated_normal(key, lower, upper, shape)`` on XLA:CPU.

    ``sqrt2 * erf_inv(uniform(key, minval=erf(lower / sqrt2), maxval=
    erf(upper / sqrt2)))``, clipped to ``[nextafter(lower, +inf),
    nextafter(upper, -inf)]``; every bound in float32.
    """
    dev = key.device
    sqrt2 = _f32(_SQRT2, dev)
    lo_hi = torch.tensor([lower, upper], dtype=torch.float32, device=dev)
    a, b = (float(v) for v in erf(_f64_exact(torch.div, lo_hi, sqrt2)).cpu())
    inf = torch.tensor([math.inf, -math.inf], dtype=torch.float32, device=dev)
    clip_lo, clip_hi = torch.nextafter(lo_hi, inf).unbind()

    def transform(bits):
        out = _erf_inv(_uniform_from_bits(bits, a, b)) * sqrt2
        return torch.clamp(out, clip_lo, clip_hi)

    return _draw(key, shape, transform)


def bernoulli(key: torch.Tensor, p: float, shape: tuple[int, ...]) -> torch.Tensor:
    """bool ``[..., *shape]``: ``uniform < p`` with ``p`` cast to float32."""
    pf = torch.tensor(p, dtype=torch.float32, device=key.device)
    return _draw(key, shape, lambda bits: _uniform_from_bits(bits, 0.0, 1.0) < pf,
                 dtype=torch.bool)


_TINY_F = 1.1754943508222875e-38  # float32 tiny, the smallest normal


def gumbel(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """float32 Gumbel noise, same bits as ``jax.random.gumbel(key, shape)``
    on XLA:CPU (its default ``mode="low"``).

    ``-log(-log(uniform(key, shape, minval=tiny, maxval=1)))`` with
    XLA:CPU's float32 ``log`` (:func:`_log`): ``torch.log`` rounds other
    bits.  Every step is an IEEE operation, so the card draws the CPU's
    bits.
    """
    return _draw(key, shape, lambda bits: -_log(-_log(_uniform_from_bits(bits, _TINY_F, 1.0))))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis, with
    replacement: ``argmax(gumbel(key, logits.shape) + logits)``, the first
    maximum on ties.  float32 logits only (jax draws the noise in the
    logits' dtype); returns int64 indices of shape ``logits.shape[:-1]``."""
    if logits.dtype != torch.float32:
        raise TypeError(f"categorical takes float32 logits, got {logits.dtype}")
    return torch.argmax(gumbel(key, tuple(logits.shape)) + logits, dim=-1)
