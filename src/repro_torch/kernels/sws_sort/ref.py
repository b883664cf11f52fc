"""Plain PyTorch version of the planner's SWS argsort.

Contract (shared with ``ops.py`` and ``csrc/sws_sort.cu``):
  w:   float32[n] weights, flat;
  out: int32[n_total] — the stable ascending argsort of the SWS keys of
       ``w`` zero-padded to ``n_total`` slots: |w| + 0.0 under
       sign_magnitude, w + 0.0 under offset_binary (``+ 0.0`` turns -0.0
       into +0.0, so the two zeros and the padding tie in source order).

``sws_argsort.calls`` counts calls, so a run can show that its CUDA path
never fell back to this version.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def sort_key(w: torch.Tensor, encoding: str) -> torch.Tensor:
    """The SWS sort key: sign_magnitude stores |w|, so it sorts by |w|;
    offset_binary stores w - min, so it sorts by value."""
    return w.abs() if encoding == "sign_magnitude" else w + 0.0


def sws_argsort(w: torch.Tensor, n_total: int, encoding: str) -> torch.Tensor:
    sws_argsort.calls += 1
    key = sort_key(F.pad(w, (0, n_total - w.shape[0])), encoding)
    return torch.sort(key, stable=True).indices.to(torch.int32)


sws_argsort.calls = 0
