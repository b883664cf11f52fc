"""Wrapper of the bitslice kernel B6 (``csrc/bitslice.cu``).

``bitslice_planes`` is the counterpart of
``repro.kernels.bitslice.ops.bitslice_planes``: CUDA tensors launch B6,
CPU tensors run the plain version ``ref.bitslice_planes``.  Stacked weights
``[..., K, N]`` share one scale (the planner's per-tensor scale) and go to
the kernel as one ``[L * K, N]`` launch that writes ``[..., cols, K, N]``.
``LAUNCHES["B6"]`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels._util import (
    check_cuda_operand,
    check_launch,
    current_stream,
    load_kernel_lib,
    use_kernel,
)
from repro_torch.kernels.bitslice import ref as bs_ref

MAX_COLS = 16

LAUNCHES = {"B6": 0}


def reset_launches() -> None:
    LAUNCHES["B6"] = 0


@functools.cache
def _lib():
    """The C launcher, its argument types set once per process."""
    fn = load_kernel_lib("bitslice").bitslice_launch
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    fn.argtypes = [p, p, p, ll, ll, ll, ctypes.c_int, p]
    fn.restype = ctypes.c_int
    return fn


def bitslice_planes(w: torch.Tensor, inv_scale: torch.Tensor, cols: int) -> torch.Tensor:
    """Fused quantize + slice: f32 [..., K, N] -> int8 [..., cols, K, N] signed planes.

    ``inv_scale``: one f32 value on ``w``'s device (a tensor: no host sync).
    """
    if w.ndim < 2:
        raise ValueError(f"bitslice_planes expects [..., K, N], got shape {tuple(w.shape)}")
    if not 1 <= cols <= MAX_COLS:
        raise ValueError(f"cols={cols} outside [1, {MAX_COLS}]")
    if not use_kernel(w):
        return bs_ref.bitslice_planes(w, inv_scale, cols)
    check_cuda_operand(w, "w", torch.float32, w.ndim)
    if (not isinstance(inv_scale, torch.Tensor) or inv_scale.device != w.device
            or inv_scale.dtype != torch.float32 or inv_scale.numel() != 1):
        raise ValueError("inv_scale must be one float32 value on w's device")
    *lead, k, n = w.shape
    layers = math.prod(lead)
    out = torch.empty((*lead, cols, k, n), dtype=torch.int8, device=w.device)
    if out.numel() == 0:
        return out
    err = _lib()(w.data_ptr(), inv_scale.contiguous().data_ptr(), out.data_ptr(),
                 layers, k, n, cols, current_stream())
    check_launch(err, "B6")
    LAUNCHES["B6"] += 1
    return out
