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
  y = scale * (x @ (sign * sum_p 2**plane_ids[p] * bits_p))    -> f32[M, N]

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


@_count
def unpack_weights(
    planes_packed: torch.Tensor,
    sign_packed: torch.Tensor,
    k: int,
    plane_ids: torch.Tensor | None = None,
) -> torch.Tensor:
    """Packed serving operands -> dense unscaled weights f32[..., K, N]
    (sign * magnitude, i.e. ``w_hat / scale``; integers, exact in f32).

    ``plane_ids`` int32[..., cols] (the ``col_perm`` serving codec): stored
    plane ``p`` weighs ``2**plane_ids[..., p]``; powers of two are exact, so
    the permuted sum equals the raw-layout one.
    """
    unpack_weights.calls += 1
    cols = planes_packed.shape[-3]
    if plane_ids is None:
        pow2 = [float(2**b) for b in range(cols)]
    else:
        p2 = torch.exp2(plane_ids.to(torch.float32))[..., None, None]  # [..., cols, 1, 1]
        pow2 = [p2[..., b, :, :] for b in range(cols)]
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
) -> torch.Tensor:
    """y = scale * (x.float() @ unpack(planes, signs)) -> f32[M, N]."""
    cim_matmul_packed.calls += 1
    w = unpack_weights(planes_packed, sign_packed, x.shape[-1], plane_ids)
    return (x.to(torch.float32) @ w) * scale
