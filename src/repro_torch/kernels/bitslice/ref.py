"""Plain PyTorch version of the bitslice kernel (B6).

Contract (shared with ``ops.py`` and ``csrc/bitslice.cu``; the port of
``repro.kernels.bitslice.ref``):
  w:         f32 [..., K, N] weights (leading dims: stacked layers)
  inv_scale: f32 scalar, 1 / quantization scale
  cols:      bitwidth

  q      = clip(round(|w| * inv_scale), 0, 2**cols - 1)   (half to even)
  out[b] = ((q >> b) & 1) * sign(w)     (int8 [..., cols, K, N]; plane 0 = LSB;
                                          sign from w < 0)

This is the ``splanes`` operand of the int8-plane CIM matmul (B5) for the
sign_magnitude encoding.  ``bitslice_planes.calls`` counts calls, so a run
can show that its kernel, not this, built the planes.
"""
from __future__ import annotations

import torch


def bitslice_planes(w: torch.Tensor, inv_scale, cols: int) -> torch.Tensor:
    bitslice_planes.calls += 1
    w32 = w.to(torch.float32)
    inv = torch.as_tensor(inv_scale, dtype=torch.float32, device=w.device)
    q = torch.clamp(torch.round(w32.abs() * inv), 0, 2**cols - 1).to(torch.int32)
    sign = torch.where(w32 < 0, -1, 1).to(torch.int8)
    return torch.stack([((q >> b) & 1).to(torch.int8) * sign for b in range(cols)], dim=-3)


bitslice_planes.calls = 0
