"""Wrapper of the bitslice kernel B6 (``csrc/bitslice.cu``).

``bitslice_planes`` is the counterpart of
``repro.kernels.bitslice.ops.bitslice_planes``: CUDA tensors launch B6,
CPU tensors run the plain version ``ref.bitslice_planes``.  Stacked weights
``[..., K, N]`` share one scale (the planner's per-tensor scale) and go to
the kernel as one ``[L * K, N]`` launch that writes ``[..., cols, K, N]``.
``LAUNCHES["B6"]`` counts kernel launches.  ``launch_plan`` is the
kernel's grid, and ``thread_span`` / ``plane_offset`` mirror its index math,
so the CPU tests can check that a launch covers every weight once.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from repro_torch.kernels._util import (
    cdiv,
    check_cuda_operand,
    check_launch,
    current_stream,
    load_kernel_lib,
    use_kernel,
)
from repro_torch.kernels.bitslice import ref as bs_ref

MAX_COLS = 16
THREADS = 256  # threads a block
CHUNK = 16  # consecutive weights of one row a thread
MAX_GRID_Y = 65535  # the card's limit on gridDim.y: layers past it loop

LAUNCHES = {"B6": 0}


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """B6's grid over w [layers, k, n]: blockIdx.x * THREADS + threadIdx.x
    is a 16-weight chunk of one layer, blockIdx.y the first of the layers
    that block walks (y, y + blocks_y, ...).  ``vec``: the vector path
    (n % 16 == 0 and 16-byte aligned w and out)."""

    layers: int
    k: int
    n: int
    chunks: int  # chunks a row
    blocks_x: int
    blocks_y: int
    vec: bool


def launch_plan(layers: int, k: int, n: int, vec: bool) -> LaunchPlan:
    """The grid ``csrc/bitslice.cu`` is launched with (it checks the same)."""
    chunks = cdiv(n, CHUNK)
    return LaunchPlan(layers, k, n, chunks, cdiv(k * chunks, THREADS),
                      min(layers, MAX_GRID_Y), vec and n % CHUNK == 0)


def thread_span(plan: LaunchPlan, u: int) -> tuple[int, int, int] | None:
    """(k-row, first column, columns) that chunk thread ``u`` slices in
    every layer it walks, or None for a thread past the layer's chunks: on
    the vector path chunk u starts at element 16u of the layer, otherwise
    at row u // chunks, column 16 (u % chunks), masked to the row."""
    if u >= plan.k * plan.chunks:
        return None
    if plan.vec:
        row, col = divmod(CHUNK * u, plan.n)
    else:
        row, c = divmod(u, plan.chunks)
        col = CHUNK * c
    return row, col, min(CHUNK, plan.n - col)


def plane_offset(plan: LaunchPlan, cols: int, layer: int, b: int, row: int, col: int) -> int:
    """Byte offset of weight (layer, row, col)'s plane ``b`` in the output
    [layers, cols, k, n], as the kernel computes it (64-bit)."""
    plane = plan.k * plan.n
    return layer * cols * plane + b * plane + row * plan.n + col


def reset_launches() -> None:
    LAUNCHES["B6"] = 0


@functools.cache
def _lib():
    """The C launcher, its argument types set once per process."""
    fn = load_kernel_lib("bitslice").bitslice_launch
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    fn.argtypes = [p, p, p, ll, ll, ll, ctypes.c_int, ll, ll, ctypes.c_int, ctypes.c_int, p]
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
    # a view at an offset (not 16-byte aligned) or a ragged n takes the
    # kernel's element path, never the plain version
    plan = launch_plan(layers, k, n, w.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    err = _lib()(w.data_ptr(), inv_scale.contiguous().data_ptr(), out.data_ptr(),
                 layers, k, n, cols, plan.chunks, plan.blocks_x, plan.blocks_y, int(plan.vec),
                 current_stream())
    check_launch(err, "B6")
    LAUNCHES["B6"] += 1
    return out
