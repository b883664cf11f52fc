"""Plain PyTorch version of packed Hamming transition counting.

Contract (shared with ``ops.py`` and ``csrc/hamming.cu``):
  a, b: uint8[T, W, C] packed bit planes (W = ceil(rows/8) byte words,
        C = bit columns); see ``repro_torch.core.bitslice.pack_rows``.
  out:  int32[T] — per-pair transition counts: popcount(a[t] XOR b[t]).
"""
from __future__ import annotations

import torch


def _byte_popcount(device) -> torch.Tensor:
    v = torch.arange(256, dtype=torch.int32, device=device)
    return sum(((v >> i) & 1) for i in range(8)).to(torch.int32)


def hamming_pairs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    table = _byte_popcount(a.device)
    x = table[torch.bitwise_xor(a, b).to(torch.int64)]
    return x.sum(dim=(1, 2), dtype=torch.int32)
