"""Wrapper of the bit-packed CIM matmul kernel (``csrc/cim_matmul.cu``).

``cim_matmul_packed`` is the counterpart of
``repro.kernels.cim_matmul.ops.cim_matmul_packed``: CUDA tensors launch the
kernel, CPU tensors run ``ref.cim_matmul_packed``.
``cim_matmul_packed.launches`` counts kernel launches.
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
_THREADS, _COLS_PER_THREAD = 128, 4  # block shape of csrc/cim_matmul.cu
_MIN_K_PER_SPLIT = 128


@functools.cache
def _lib():
    """The C launcher, its argument types set once per process."""
    fn = load_kernel_lib("cim_matmul").cim_matmul_packed_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def launch_plan(m: int, k: int, n: int, sms: int) -> tuple[int, int, int]:
    """(rows per thread MT, K splits, K per split) for an [M, K] x [K, N] call.

    Split K until the grid holds about two blocks per SM, keeping at least
    128 K values (16 byte rows) per split; the split size is a multiple of 8
    so no packed byte straddles two splits.
    """
    mt = 4 if m <= 4 else 16
    blocks = cdiv(cdiv(n, _COLS_PER_THREAD), _THREADS) * cdiv(m, mt)
    splits = max(1, min(cdiv(2 * sms, blocks), cdiv(k, _MIN_K_PER_SPLIT)))
    k_per_split = round_up(cdiv(k, splits), 8)
    return mt, cdiv(k, k_per_split), k_per_split


def cim_matmul_packed(
    x: torch.Tensor,
    planes_packed: torch.Tensor,
    sign_packed: torch.Tensor,
    scale: torch.Tensor,
) -> torch.Tensor:
    """Bit-packed serving matmul: y = scale * (x @ unpack(planes, signs)) -> f32[M, N].

    x f32 or bf16 [M, K] (any K); planes_packed uint8[cols, ceil(K/8), N];
    sign_packed uint8[ceil(K/8), N]; scale an f32 scalar tensor.
    """
    m, k = x.shape
    cols, kw, n = planes_packed.shape
    if kw != cdiv(k, 8):
        raise ValueError(f"planes K bytes {kw} != ceil({k}/8)")
    if tuple(sign_packed.shape) != (kw, n):
        raise ValueError(f"sign shape {tuple(sign_packed.shape)} != {(kw, n)}")
    if not use_kernel(x):
        return cim_ref.cim_matmul_packed(x, planes_packed, sign_packed, scale)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not 1 <= cols <= MAX_COLS:
        raise ValueError(f"cols={cols} outside [1, {MAX_COLS}]")
    check_cuda_operand(x, "x", x.dtype, 2)
    check_cuda_operand(planes_packed, "planes_packed", torch.uint8, 3)
    check_cuda_operand(sign_packed, "sign_packed", torch.uint8, 2)
    if scale.device != x.device or scale.dtype != torch.float32 or scale.numel() != 1:
        raise ValueError("scale must be one float32 value on x's device")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0 or k == 0:
        return out.zero_()
    mt, splits, k_per_split = launch_plan(m, k, n, _sm_count(x.device.index))
    vec = n % 4 == 0 and planes_packed.data_ptr() % 4 == 0 and sign_packed.data_ptr() % 4 == 0
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=x.device) if splits > 1 else out
    err = _lib()(
        x.data_ptr(), int(x.dtype == torch.bfloat16), planes_packed.data_ptr(),
        sign_packed.data_ptr(), scale.data_ptr(), out.data_ptr(), ws.data_ptr(),
        m, k, n, cols, mt, int(vec), splits, k_per_split, current_stream(),
    )
    check_launch(err, "cim_matmul_packed")
    cim_matmul_packed.launches += 1
    return out


cim_matmul_packed.launches = 0
