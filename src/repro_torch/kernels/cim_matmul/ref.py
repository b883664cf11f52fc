"""Plain PyTorch version of the bit-packed CIM matmul.

Contract (shared with ``ops.py`` and ``csrc/cim_matmul.cu``):
  x:             f32/bf16 [M, K] activations
  planes_packed: uint8[cols, ceil(K/8), N], plane 0 = LSB, K packed MSB-first
  sign_packed:   uint8[ceil(K/8), N], bit 1 = negative weight
  scale:         f32 scalar

  y = scale * (x @ (sign * sum_b 2**b * bits_b))   -> f32[M, N]
"""
from __future__ import annotations

import torch

from repro_torch.core.bitslice import unpackbits


def unpack_weights(planes_packed: torch.Tensor, sign_packed: torch.Tensor, k: int) -> torch.Tensor:
    """Packed serving operands -> dense unscaled weights f32[..., K, N]
    (sign * magnitude, i.e. ``w_hat / scale``; integers, exact in f32)."""
    cols = planes_packed.shape[-3]
    mag = None
    for b in range(cols):
        plane = unpackbits(planes_packed[..., b, :, :], -2, k).to(torch.float32) * float(2**b)
        mag = plane if mag is None else mag + plane
    sgn = 1.0 - 2.0 * unpackbits(sign_packed, -2, k).to(torch.float32)
    return mag * sgn


def cim_matmul_packed(
    x: torch.Tensor, planes_packed: torch.Tensor, sign_packed: torch.Tensor, scale: torch.Tensor
) -> torch.Tensor:
    """y = scale * (x.float() @ unpack(planes, signs)) -> f32[M, N]."""
    w = unpack_weights(planes_packed, sign_packed, x.shape[-1])
    return (x.to(torch.float32) @ w) * scale
