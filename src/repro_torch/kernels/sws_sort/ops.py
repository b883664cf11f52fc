"""Wrapper of the planner's SWS argsort (``csrc/sws_sort.cu``).

``sws_argsort`` gives the planner's slot -> source permutation as int32:
CUDA tensors launch the key kernel and CUB's radix sort (16 bytes a weight
in flight), CPU tensors run ``ref.sws_argsort`` (``torch.sort(stable=True)``).
It replaces no TPU kernel: the reference sorts on the host.
``LAUNCHES["SORT"]`` counts launches.
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
    use_kernel,
)
from repro_torch.kernels.sws_sort import ref as sort_ref

LAUNCHES = {"SORT": 0}
ENCODINGS = ("sign_magnitude", "offset_binary")


def reset_launches() -> None:
    LAUNCHES["SORT"] = 0


@functools.cache
def _lib():
    """The C entry points, their argument types set once per process."""
    lib = load_kernel_lib("sws_sort")
    lib.sws_sort_temp_bytes.argtypes = [ctypes.c_longlong, ctypes.POINTER(ctypes.c_ulonglong)]
    lib.sws_sort_temp_bytes.restype = ctypes.c_int
    fn = lib.sws_argsort_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_ulonglong, ctypes.c_longlong,
                                           ctypes.c_longlong, ctypes.c_int,
                                           ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def sws_argsort(w: torch.Tensor, n_total: int, encoding: str) -> torch.Tensor:
    """Stable ascending argsort of the SWS keys of ``w`` (float32[n], flat)
    zero-padded to ``n_total`` slots -> int32[n_total] (see ``ref.py``)."""
    if encoding not in ENCODINGS:
        raise ValueError(f"unknown encoding: {encoding!r}")
    n = w.shape[0]
    if w.ndim != 1 or n_total < n:
        raise ValueError(f"expected float32[n] with n <= n_total, got {tuple(w.shape)}, "
                         f"n_total {n_total}")
    if not use_kernel(w):
        return sort_ref.sws_argsort(w, n_total, encoding)
    if n_total >= 2**31:
        raise ValueError(f"{n_total} slots: the int32 permutation holds fewer than 2^31")
    check_cuda_operand(w, "w", torch.float32, 1)
    lib = _lib()
    temp_bytes = ctypes.c_ulonglong(0)
    check_launch(lib.sws_sort_temp_bytes(n_total, ctypes.byref(temp_bytes)), "sws_sort")
    dev = w.device
    keys = [torch.empty((n_total,), dtype=torch.int32, device=dev) for _ in range(2)]
    idx = [torch.empty((n_total,), dtype=torch.int32, device=dev) for _ in range(2)]
    temp = torch.empty((max(1, temp_bytes.value),), dtype=torch.uint8, device=dev)
    selector = ctypes.c_int(0)
    err = lib.sws_argsort_launch(
        w.data_ptr(), keys[0].data_ptr(), keys[1].data_ptr(), idx[0].data_ptr(),
        idx[1].data_ptr(), temp.data_ptr(), temp_bytes.value, n, n_total,
        int(encoding == "offset_binary"), ctypes.byref(selector), current_stream())
    check_launch(err, "sws_sort")
    LAUNCHES["SORT"] += 1
    return idx[selector.value]
