"""Plain PyTorch version of packed Hamming transition counting.

Contract (shared with ``ops.py`` and ``csrc/hamming.cu``):
  a, b: uint8[T, W, C] packed bit planes (W = ceil(rows/8) byte words,
        C = bit columns); see ``repro_torch.core.bitslice.pack_rows``.
  out:  int32[T] — per-pair transition counts: popcount(a[t] XOR b[t]).

``hamming_pairs.calls`` counts calls, so a run can show that its CUDA path
never fell back to this version.
"""
from __future__ import annotations

import torch


def popcount_bytes(x: torch.Tensor) -> torch.Tensor:
    """Elementwise popcount of uint8 words -> uint8 (sum it with a wider
    ``dtype``).  Bit-parallel in the words' own byte, so no wider index or
    count is ever built: a table lookup would cost 12 bytes a byte."""
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return (x + (x >> 4)) & 0x0F


def hamming_pairs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    hamming_pairs.calls += 1
    return popcount_bytes(torch.bitwise_xor(a, b)).sum(dim=(1, 2), dtype=torch.int32)


hamming_pairs.calls = 0
