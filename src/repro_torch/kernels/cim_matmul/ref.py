"""Plain PyTorch versions of the CIM matmul kernels.

Contracts (shared with ``ops.py``, ``csrc/cim_matmul.cu`` and
``csrc/cim_planes.cu``):

int8 planes (B5):
  x:       f32/bf16 [M, K] activations
  splanes: int8[cols, K, N] signed bit planes in {-1, 0, 1}, plane 0 = LSB
  scale:   f32 scalar
  y = scale * sum_b 2**b * (x @ splanes[b])                    -> f32[M, N]

bit-packed planes (B2, B4):
  planes_packed: uint8[cols, ceil(K/8), N], K packed MSB-first
  sign_packed:   uint8[ceil(K/8), N], bit 1 = negative weight
  plane_ids:     optional int32[cols]; stored plane p weighs 2**plane_ids[p]
                 (plane 0 = LSB when absent)
  plane_gain:    optional f32[cols, N] (B2 only): stored plane p at column n
                 weighs gain[p, n] * 2**plane_ids[p] (drifted conductances)
  y = scale * (x @ (sign * sum_p gain_p * 2**plane_ids[p] * bits_p)) -> f32[M, N]

grouped (both): x [G, M, K], every operand with a leading [G], scale f32[G]
  -> f32[G, M, N], computed one group at a time with the single-group
  arithmetic, so it equals G single calls bit for bit.

Each function counts its calls in ``.calls``, so a run can show that its
kernels, not these, served it.
"""
from __future__ import annotations

import torch

from repro_torch.core.bitslice import unpackbits

MODES = ("fused_dequant", "planes")
_N_CHUNK = 2048  # int8-plane columns dequantized at once (bounds the f32 temporary)


def _count(fn):
    fn.calls = 0
    return fn


@_count
def cim_matmul(
    x: torch.Tensor, splanes: torch.Tensor, scale: torch.Tensor, mode: str = "fused_dequant"
) -> torch.Tensor:
    """y = scale * sum_b 2**b * (x @ splanes[b]) -> f32[M, N].

    ``fused_dequant`` rebuilds the integer weight (exact in f32) and does
    one matmul; ``planes`` does one matmul per plane and weights the
    partial sums.  Columns go in chunks of 2048, so no f32 copy of all the
    planes is made.
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; choose from {MODES}")
    if x.ndim == 3:
        return torch.stack([cim_matmul(x[g], splanes[g], scale[g], mode)
                            for g in range(x.shape[0])])
    cim_matmul.calls += 1
    xf = x.to(torch.float32)
    cols, _, n = splanes.shape
    out = []
    for n0 in range(0, n, _N_CHUNK):
        chunk = splanes[:, :, n0:n0 + _N_CHUNK]
        if mode == "fused_dequant":
            w = None
            for b in range(cols):
                plane = chunk[b].to(torch.float32) * float(2**b)
                w = plane if w is None else w + plane
            out.append(xf @ w)
        else:
            y = None
            for b in range(cols):
                part = (xf @ chunk[b].to(torch.float32)) * float(2**b)
                y = part if y is None else y + part
            out.append(y)
    return torch.cat(out, dim=-1) * scale


def hi_lo(splanes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact split of B5's tensor-core kernel: w = 256 * hi + lo.

    ``splanes`` int8[cols <= 16, K, N] -> int32 (hi, lo), each in
    [-255, 255] (exact in bf16): lo = sum_{b<8} 2**b P_b and
    hi = sum_{b>=8} 2**(b-8) P_b.
    """
    hi = torch.zeros(splanes.shape[1:], dtype=torch.int32, device=splanes.device)
    lo = torch.zeros_like(hi)
    for b in range(splanes.shape[0]):
        plane = splanes[b].to(torch.int32)
        if b < 8:
            lo += plane * (1 << b)
        else:
            hi += plane * (1 << (b - 8))
    return hi, lo


@_count
def unpack_weights(
    planes_packed: torch.Tensor,
    sign_packed: torch.Tensor,
    k: int,
    plane_ids: torch.Tensor | None = None,
    plane_gain: torch.Tensor | None = None,
) -> torch.Tensor:
    """Packed serving operands -> dense unscaled weights f32[..., K, N]
    (sign * magnitude, i.e. ``w_hat / scale``; integers, exact in f32).

    ``plane_ids`` int32[..., cols] (the ``col_perm`` serving codec): stored
    plane ``p`` weighs ``2**plane_ids[..., p]``; powers of two are exact, so
    the permuted sum equals the raw-layout one.  ``plane_gain`` f32[...,
    cols, N] (drift) multiplies plane ``p``'s weight at column ``n`` (an
    exact product: a power of two scales it); the magnitudes are then
    float sums, in plane order.
    """
    unpack_weights.calls += 1
    cols = planes_packed.shape[-3]
    if plane_ids is None:
        pow2 = [float(2**b) for b in range(cols)]
    else:
        p2 = torch.exp2(plane_ids.to(torch.float32))[..., None, None]  # [..., cols, 1, 1]
        pow2 = [p2[..., b, :, :] for b in range(cols)]
    if plane_gain is not None:
        pow2 = [pow2[b] * plane_gain[..., b : b + 1, :] for b in range(cols)]  # [..., 1, N]
    mag = None
    for b in range(cols):
        plane = unpackbits(planes_packed[..., b, :, :], -2, k).to(torch.float32) * pow2[b]
        mag = plane if mag is None else mag + plane
    sgn = 1.0 - 2.0 * unpackbits(sign_packed, -2, k).to(torch.float32)
    return mag * sgn


@_count
def cim_matmul_packed(
    x: torch.Tensor,
    planes_packed: torch.Tensor,
    sign_packed: torch.Tensor,
    scale: torch.Tensor,
    plane_ids: torch.Tensor | None = None,
    plane_gain: torch.Tensor | None = None,
) -> torch.Tensor:
    """y = scale * (x.float() @ unpack(planes, signs)) -> f32[M, N]."""
    if x.ndim == 3:
        return torch.stack([
            cim_matmul_packed(x[g], planes_packed[g], sign_packed[g], scale[g],
                              None if plane_ids is None else plane_ids[g],
                              None if plane_gain is None else plane_gain[g])
            for g in range(x.shape[0])])
    cim_matmul_packed.calls += 1
    w = unpack_weights(planes_packed, sign_packed, x.shape[-1], plane_ids, plane_gain)
    return (x.to(torch.float32) @ w) * scale
