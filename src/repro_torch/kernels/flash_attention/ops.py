"""Wrapper of the flash-attention kernel B3 (``csrc/flash_attention.cu``).

``flash_attention`` is the counterpart of
``repro.kernels.flash_attention.ops.flash_attention``: CUDA tensors launch
B3, CPU tensors run the plain version ``ref.flash_attention``.  bf16 q/k/v
take B3's tensor-core kernel, which reads any Sq and Sk through TMA (zeros
past the edges), so nothing is padded; f32 q/k/v take its FMA kernel, for
which the wrapper pads Sq and Sk to the tiles (the static ``sk_valid`` tail
masks the padded keys).  A Python int ``q_offset`` / ``kv_valid_len`` goes
to the kernel as a scalar argument; a tensor (scalar or (B,)) as per-row
int32 on the card.  ``LAUNCHES["B3"]`` counts every launch,
``LAUNCHES["B3_tc"]`` those of the tensor-core kernel.

B3 is forward only (the reference's Pallas kernel has no VJP either): the
wrapper raises, on either device, while autograd records and q, k or v
requires grad, rather than return a result without a ``grad_fn``.  The f32 FMA kernel
takes the head dims of ``HEAD_DIMS`` (the reduced configs' 16, 20 and 32
among them); the tensor-core kernel only ``TC_HEAD_DIMS`` (64: hymba-1.5b's
25 query heads over 5 KV heads).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Union

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
from repro_torch.kernels.flash_attention import ref as fa_ref

KINDS = {"causal": 0, "bidir": 1, "swa": 2}
HEAD_DIMS = (16, 20, 32, 64, 128, 256)  # the head dims the f32 FMA kernel is built for
TC_HEAD_DIMS = (64, 128, 256)  # the head dims of the bf16 tensor-core kernel
BQ = 32  # q rows per block of the f32 kernel (kBQ in the source)
TMA_ALIGN = 16  # bytes: TMA's base-address alignment

LAUNCHES = {"B3": 0, "B3_tc": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib():
    """The C launcher, the key-tile query and the descriptor timer, argument
    types set once per process."""
    lib = load_kernel_lib("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                   ctypes.c_float, _P]
    fn.restype = ctypes.c_int
    lib.flash_attention_tile_k.argtypes = [_I]
    lib.flash_attention_tile_k.restype = ctypes.c_int
    lib.flash_attention_encode_us.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I]
    lib.flash_attention_encode_us.restype = ctypes.c_double
    return fn, lib.flash_attention_tile_k, lib.flash_attention_encode_us


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a TMA-aligned address (a copy only if it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % TMA_ALIGN == 0 else t.clone()


def encode_us(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, reps: int = 1000) -> float:
    """Host microseconds B3 spends encoding one bf16 call's TMA descriptors."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    us = _lib()[2](q.data_ptr(), k.data_ptr(), v.data_ptr(), b, hq, hkv, sq, sk, d, reps)
    if us < 0:
        raise RuntimeError("B3 could not encode its TMA descriptors")
    return us


def _per_row(value, b: int, device) -> tuple[torch.Tensor | None, int]:
    """(per-row int32 (B,) on ``device``, None) for a tensor; (None, value)
    for a Python int, which the kernel takes as an argument."""
    if not isinstance(value, torch.Tensor):
        return None, int(value)
    t = value.to(device=device, dtype=torch.int32)
    return (t.expand(b) if t.ndim == 0 else t.reshape(b)).contiguous(), 0


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_valid_len: Union[int, torch.Tensor, None] = None,
    *,
    kind: str = "causal",
    window: Optional[int] = None,
    q_offset: Union[int, torch.Tensor] = 0,
) -> torch.Tensor:
    """Masked GQA attention; see ``ref.py`` for the contract.  Any Sq, Sk."""
    if kind not in KINDS:
        raise ValueError(f"unknown attention kind {kind!r}; choose from {tuple(KINDS)}")
    if kind == "swa" and window is None:
        raise ValueError("kind='swa' needs a window")
    b, hq, sq, d = q.shape
    _, hkv, sk, dk = k.shape
    if dk != d or tuple(v.shape) != tuple(k.shape) or k.shape[0] != b:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         f"do not match (v's head dim must equal q's)")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("B3 has no backward: differentiate blockwise_attention "
                           "(attention(..., train=True)) instead")
    if not use_kernel(q):
        return fa_ref.flash_attention(q, k, v, kv_valid_len, kind=kind, window=window,
                                      q_offset=q_offset)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    dims = TC_HEAD_DIMS if q.dtype == torch.bfloat16 else HEAD_DIMS
    if d not in dims:
        raise ValueError(f"head dim {d} not in {dims} for {q.dtype}")
    launch, tile_k, _ = _lib()
    tensor_cores = q.dtype == torch.bfloat16
    if tensor_cores:
        qp, kp, vp = _aligned(q), _aligned(k), _aligned(v)
    else:
        bk = tile_k(d)
        qp = pad_axis_to(q, 2, round_up(max(sq, 1), BQ)).contiguous()
        kp = pad_axis_to(k, 2, round_up(max(sk, 1), bk)).contiguous()
        vp = pad_axis_to(v, 2, round_up(max(sk, 1), bk)).contiguous()
    for name, t in (("q", qp), ("k", kp), ("v", vp)):
        check_cuda_operand(t, name, q.dtype, 4)
    qoff, qoff0 = _per_row(q_offset, b, q.device)
    kvl, kvl0 = _per_row(sk if kv_valid_len is None else kv_valid_len, b, q.device)
    out = torch.empty_like(qp)
    if out.numel() == 0 or kp.shape[2] == 0:
        return out.zero_()[:, :, :sq]
    err = launch(
        qp.data_ptr(), kp.data_ptr(), vp.data_ptr(),
        None if qoff is None else qoff.data_ptr(), None if kvl is None else kvl.data_ptr(),
        qoff0, kvl0, out.data_ptr(), int(q.dtype == torch.bfloat16), b, hq, hkv, qp.shape[2],
        kp.shape[2], sk, d, KINDS[kind], 0 if window is None else int(window), d**-0.5,
        current_stream(),
    )
    check_launch(err, "B3")
    LAUNCHES["B3"] += 1
    LAUNCHES["B3_tc"] += int(tensor_cores)
    return out[:, :, :sq]
