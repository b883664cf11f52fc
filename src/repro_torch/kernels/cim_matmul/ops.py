"""Wrappers of the CIM matmul kernels (``csrc/cim_matmul.cu``, ``csrc/cim_planes.cu``).

Counterparts of ``repro.kernels.cim_matmul.ops``:

* ``cim_matmul_packed`` — bit-packed planes: kernel B2, or B4 when the
  const_rle codec's ``tile_nz`` flags are given; both take the col_perm
  codec's ``plane_ids``;
* ``cim_matmul`` — int8 signed planes: kernel B5 (``fused_dequant`` or the
  per-plane ``planes`` oracle).

CUDA tensors launch the kernels, CPU tensors run the plain versions in
``ref.py``.  ``LAUNCHES`` counts kernel launches by kernel (``"B2"``,
``"B4"``, ``"B5"``); ``reset_launches`` zeroes it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._util import (
    cdiv,
    check_cuda_operand,
    check_launch,
    current_stream,
    load_kernel_lib,
    round_up,
    use_kernel,
)
from repro_torch.kernels.cim_matmul import ref as cim_ref

MAX_COLS = 16
_THREADS, _COLS_PER_THREAD = 128, 4  # block shape of both kernel sources
_MIN_K_PER_SPLIT = 128
TILE_ROWS = 128  # K rows per tile_nz flag

LAUNCHES = {"B2": 0, "B4": 0, "B5": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _packed_lib():
    """The C launcher of B2/B4, its argument types set once per process."""
    fn = load_kernel_lib("cim_matmul").cim_matmul_packed_launch
    fn.argtypes = [_P, _I, _P, _P, _P, _P, _P, _P, _P,
                   _I, _I, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _planes_lib():
    """The C launcher of B5, its argument types set once per process."""
    fn = load_kernel_lib("cim_planes").cim_planes_launch
    fn.argtypes = [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def launch_plan(
    m: int, k: int, n: int, sms: int, blocks_per_sm: int = 2
) -> tuple[int, int, int]:
    """(rows per thread MT, K splits, K per split) for an [M, K] x [K, N] call.

    Split K until the grid holds about ``blocks_per_sm`` blocks per SM,
    keeping at least 128 K values (16 byte rows) per split; the split size
    is a multiple of 8 so no packed byte straddles two splits.
    """
    mt = 4 if m <= 4 else 16
    blocks = cdiv(cdiv(n, _COLS_PER_THREAD), _THREADS) * cdiv(m, mt)
    splits = max(1, min(cdiv(blocks_per_sm * sms, blocks), cdiv(k, _MIN_K_PER_SPLIT)))
    k_per_split = round_up(cdiv(k, splits), 8)
    return mt, cdiv(k, k_per_split), k_per_split


def _check_x_scale(x: torch.Tensor, scale: torch.Tensor) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    check_cuda_operand(x, "x", x.dtype, 2)
    if scale.device != x.device or scale.dtype != torch.float32 or scale.numel() != 1:
        raise ValueError("scale must be one float32 value on x's device")


def cim_matmul_packed(
    x: torch.Tensor,
    planes_packed: torch.Tensor,
    sign_packed: torch.Tensor,
    scale: torch.Tensor,
    *,
    tile_nz: torch.Tensor | None = None,
    plane_ids: torch.Tensor | None = None,
) -> torch.Tensor:
    """Bit-packed serving matmul: y = scale * (x @ unpack(planes, signs)) -> f32[M, N].

    x f32 or bf16 [M, K] (any K); planes_packed uint8[cols, ceil(K/8), N];
    sign_packed uint8[ceil(K/8), N]; scale an f32 scalar tensor.
    ``tile_nz`` uint8[cols, ceil(K/128)] zero-tile flags (the const_rle
    codec) select kernel B4, which skips the flagged-zero tiles;
    ``plane_ids`` int32[cols] (the col_perm codec) weighs stored plane ``p``
    by ``2**plane_ids[p]``.  Both kernels give the same bits.
    """
    m, k = x.shape
    cols, kw, n = planes_packed.shape
    if kw != cdiv(k, 8):
        raise ValueError(f"planes K bytes {kw} != ceil({k}/8)")
    if tuple(sign_packed.shape) != (kw, n):
        raise ValueError(f"sign shape {tuple(sign_packed.shape)} != {(kw, n)}")
    if tile_nz is not None and tuple(tile_nz.shape) != (cols, cdiv(k, TILE_ROWS)):
        raise ValueError(f"tile_nz shape {tuple(tile_nz.shape)} != {(cols, cdiv(k, TILE_ROWS))}")
    if plane_ids is not None and tuple(plane_ids.shape) != (cols,):
        raise ValueError(f"plane_ids shape {tuple(plane_ids.shape)} != {(cols,)}")
    if not use_kernel(x):
        # the flags only skip exact zeros: the plain version needs none
        return cim_ref.cim_matmul_packed(x, planes_packed, sign_packed, scale, plane_ids)
    if not 1 <= cols <= MAX_COLS:
        raise ValueError(f"cols={cols} outside [1, {MAX_COLS}]")
    _check_x_scale(x, scale)
    check_cuda_operand(planes_packed, "planes_packed", torch.uint8, 3)
    check_cuda_operand(sign_packed, "sign_packed", torch.uint8, 2)
    if tile_nz is not None:
        check_cuda_operand(tile_nz, "tile_nz", torch.uint8, 2)
    if plane_ids is not None:
        check_cuda_operand(plane_ids, "plane_ids", torch.int32, 1)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0 or k == 0:
        return out.zero_()
    mt, splits, k_per_split = launch_plan(m, k, n, _sm_count(x.device.index))
    vec = n % 4 == 0 and planes_packed.data_ptr() % 4 == 0 and sign_packed.data_ptr() % 4 == 0
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=x.device) if splits > 1 else out
    err = _packed_lib()(
        x.data_ptr(), int(x.dtype == torch.bfloat16), planes_packed.data_ptr(),
        sign_packed.data_ptr(), None if plane_ids is None else plane_ids.data_ptr(),
        None if tile_nz is None else tile_nz.data_ptr(), scale.data_ptr(), out.data_ptr(),
        ws.data_ptr(), m, k, n, cols, mt, int(vec), splits, k_per_split, current_stream(),
    )
    kernel = "B2" if tile_nz is None else "B4"
    check_launch(err, kernel)
    LAUNCHES[kernel] += 1
    return out


def cim_matmul(
    x: torch.Tensor,
    splanes: torch.Tensor,
    scale: torch.Tensor,
    *,
    mode: str = "fused_dequant",
) -> torch.Tensor:
    """Int8-plane matmul: y = scale * sum_b 2**b * (x @ splanes[b]) -> f32[M, N].

    x f32 or bf16 [M, K]; splanes int8[cols, K, N] in {-1, 0, 1}; scale an
    f32 scalar tensor.  ``mode`` is ``"fused_dequant"`` (rebuild the
    weight, one dot: what serving uses) or ``"planes"`` (one dot per
    plane).
    """
    if mode not in cim_ref.MODES:
        raise ValueError(f"unknown mode {mode!r}; choose from {cim_ref.MODES}")
    m, k = x.shape
    cols, k2, n = splanes.shape
    if k != k2:
        raise ValueError(f"K mismatch: x has {k}, splanes has {k2}")
    if not use_kernel(x):
        return cim_ref.cim_matmul(x, splanes, scale, mode)
    if not 1 <= cols <= MAX_COLS:
        raise ValueError(f"cols={cols} outside [1, {MAX_COLS}]")
    _check_x_scale(x, scale)
    check_cuda_operand(splanes, "splanes", torch.int8, 3)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0 or k == 0:
        return out.zero_()
    # B5 streams 8x the bytes of B2 with little work per byte: more blocks
    # per SM keep more of its loads in flight
    mt, splits, k_per_split = launch_plan(m, k, n, _sm_count(x.device.index), blocks_per_sm=4)
    vec = n % 4 == 0 and splanes.data_ptr() % 4 == 0
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=x.device) if splits > 1 else out
    err = _planes_lib()(
        x.data_ptr(), int(x.dtype == torch.bfloat16), splanes.data_ptr(), scale.data_ptr(),
        out.data_ptr(), ws.data_ptr(), m, k, n, cols, mt, int(vec), int(mode == "planes"),
        splits, k_per_split, current_stream(),
    )
    check_launch(err, "B5")
    LAUNCHES["B5"] += 1
    return out
