"""Wrapper of the Hamming pair-pricing kernel (``csrc/hamming.cu``).

``price_pairs`` is the planner's pricing entry (the counterpart of
``repro.kernels.hamming.ops.price_pairs``): CUDA tensors launch the kernel,
CPU tensors run ``ref.hamming_pairs``.  ``price_pairs.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._util import (
    check_cuda_operand,
    check_launch,
    current_stream,
    load_kernel_lib,
    pad_axis_to,
    round_up,
    use_kernel,
)
from repro_torch.kernels.hamming import ref as hamming_ref


@functools.cache
def _lib():
    """The C launcher, its argument types set once per process."""
    fn = load_kernel_lib("hamming").hamming_pairs_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _as_vec16(x: torch.Tensor) -> torch.Tensor:
    """uint8[T, W, C] -> contiguous 16-byte aligned uint8[T, P], P % 16 == 0
    (zero-padded pairs price the same: zero bytes XOR to zero)."""
    t = x.shape[0]
    flat = x.reshape(t, -1)
    p = flat.shape[1]
    pp = round_up(max(p, 1), 16)
    flat = pad_axis_to(flat, 1, pp)
    if not flat.is_contiguous() or flat.data_ptr() % 16:
        flat = flat.clone(memory_format=torch.contiguous_format)
    return flat


def price_pairs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-pair transition counts popcount(a[t] ^ b[t]) -> int32[T]; T may be 0.

    a, b: uint8[T, W, C] packed planes on one device.
    """
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.ndim != 3:
        raise ValueError(f"expected uint8[T, W, C], got shape {tuple(a.shape)}")
    if a.device != b.device:
        raise ValueError(f"device mismatch: {a.device} vs {b.device}")
    if a.dtype != torch.uint8 or b.dtype != torch.uint8:
        raise TypeError(f"expected uint8 planes, got {a.dtype} / {b.dtype}")
    t = a.shape[0]
    if t == 0:
        return torch.zeros((0,), dtype=torch.int32, device=a.device)
    if not use_kernel(a):
        return hamming_ref.hamming_pairs(a, b)
    av, bv = _as_vec16(a), _as_vec16(b)
    check_cuda_operand(av, "a", torch.uint8, 2)
    check_cuda_operand(bv, "b", torch.uint8, 2)
    out = torch.empty((t,), dtype=torch.int32, device=a.device)
    err = _lib()(av.data_ptr(), bv.data_ptr(), out.data_ptr(), t, av.shape[1] // 16,
                 current_stream())
    check_launch(err, "hamming_pairs")
    price_pairs.launches += 1
    return out


price_pairs.launches = 0

