"""Wrappers of the CIM matmul kernels (``csrc/cim_matmul.cu``, ``csrc/cim_planes.cu``).

Counterparts of ``repro.kernels.cim_matmul.ops``:

* ``cim_matmul_packed`` — bit-packed planes: kernel B2, or B4 when the
  const_rle codec's ``tile_nz`` flags are given; both take the col_perm
  codec's ``plane_ids``; bf16 x takes their tensor-core kernel; drift
  ``plane_gain`` runs B2's FMA kernel (x in float32);
* ``cim_matmul`` — int8 signed planes: kernel B5 (``fused_dequant`` or the
  per-plane ``planes`` oracle); ``fused_dequant`` on bf16 x takes B5's
  tensor-core kernel.

Both take a leading group axis (x ``[G, M, K]``, every operand with the
same ``[G, ...]`` lead, scale ``[G]``; result ``[G, M, N]``): G matmuls of
one shape, the experts of a MoE layer, in ONE launch of the kernel, each
group computing what a single launch with the same launch plan computes.

CUDA tensors launch the kernels, CPU tensors run the plain versions in
``ref.py`` (one group at a time).  ``LAUNCHES`` counts kernel launches by
kernel (``"B2"``, ``"B4"``, ``"B5"``; ``"B2_tc"``, ``"B4_tc"`` and
``"B5_tc"`` count the launches that took a tensor-core kernel,
``"B2_gain"`` those with plane gains); ``reset_launches`` zeroes it.
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
_THREADS, _COLS_PER_THREAD = 128, 4  # block shape of the FMA kernels (f32 x, B5 planes)
_MIN_K_PER_SPLIT = 128
TILE_ROWS = 128  # K rows per tile_nz flag

TC_BK = 64  # K rows per stage of the tensor-core kernels (B2/B4 and B5)
TC_MIN_TILES = 4  # K stages per split at least (the ring's depth plus one)
TC_FILL = 2  # stages' worth of time a block spends filling its ring and in its epilogue
TC_PACKED_BN = 128  # output columns per block of B2/B4's tensor-core kernel

LAUNCHES = {"B2": 0, "B2_tc": 0, "B2_gain": 0, "B4": 0, "B4_tc": 0, "B5": 0, "B5_tc": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _packed_lib():
    """The C launcher of B2/B4's FMA kernel (f32 x), argument types set once per process."""
    fn = load_kernel_lib("cim_matmul").cim_matmul_packed_launch
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                   _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _packed_tc_lib():
    """The C launcher of B2/B4's tensor-core kernel (bf16 x), argument types set once per process."""
    fn = load_kernel_lib("cim_matmul").cim_matmul_packed_tc_launch
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P,
                   _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _planes_lib():
    """The C launcher of B5, its argument types set once per process."""
    fn = load_kernel_lib("cim_planes").cim_planes_launch
    fn.argtypes = [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _planes_tc_lib():
    """The C launcher of B5's tensor-core kernel, argument types set once per process."""
    fn = load_kernel_lib("cim_planes").cim_planes_tc_launch
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def launch_plan(
    m: int, k: int, n: int, sms: int, blocks_per_sm: int = 2, groups: int = 1
) -> tuple[int, int, int]:
    """(rows per thread MT, K splits, K per split) for ``groups`` [M, K] x
    [K, N] matmuls in one launch.

    Split K until the grid holds about ``blocks_per_sm`` blocks per SM,
    keeping at least 128 K values (16 byte rows) per split; the split size
    is a multiple of 8 so no packed byte straddles two splits.
    """
    mt = 4 if m <= 4 else 16
    blocks = cdiv(cdiv(n, _COLS_PER_THREAD), _THREADS) * cdiv(m, mt) * groups
    splits = max(1, min(cdiv(blocks_per_sm * sms, blocks), cdiv(k, _MIN_K_PER_SPLIT)))
    k_per_split = round_up(cdiv(k, splits), 8)
    return mt, cdiv(k, k_per_split), k_per_split


def _tc_plan(m: int, k: int, n: int, bn: int, sms: int, groups: int = 1) -> tuple[int, int, int]:
    """(wgmma warpgroups, K splits, K per split) of a tensor-core kernel
    whose block owns 64 rows of x per wgmma warpgroup (two where M > 64) by
    ``bn`` columns and streams its K range in 64-row stages (``groups``
    matmuls of that shape in one launch: groups times the blocks).

    The split count minimises waves x (stages per split + ``TC_FILL``): a
    block's time is its stage count plus the filling of its ring; the
    fewest splits among equals, with at least ``TC_MIN_TILES`` stages a
    split.
    """
    nwg = 1 if m <= 64 else 2
    blocks = cdiv(n, bn) * cdiv(m, 64 * nwg) * groups
    tiles = cdiv(k, TC_BK)
    splits = min(range(1, max(1, tiles // TC_MIN_TILES) + 1),
                 key=lambda s: (cdiv(blocks * s, sms) * (cdiv(tiles, s) + TC_FILL), s))
    k_per_split = round_up(cdiv(k, splits), TC_BK)
    return nwg, cdiv(k, k_per_split), k_per_split


def tc_launch_plan(m: int, k: int, n: int, cols: int, sms: int,
                   groups: int = 1) -> tuple[int, int, int]:
    """(wgmma warpgroups, K splits, K per split) for B5's tensor-core kernel:
    128 columns a block (64 where cols > 10, whose 16 int8 planes would not
    fit two stages), one block an SM (its ring takes the shared memory)."""
    return _tc_plan(m, k, n, 128 if cols <= 10 else 64, sms, groups)


def tc_packed_launch_plan(m: int, k: int, n: int, sms: int,
                          groups: int = 1) -> tuple[int, int, int]:
    """(wgmma warpgroups, K splits, K per split) for B2/B4's tensor-core
    kernel: 128 columns a block for every cols (a packed stage is small).
    B2 and B4 take the same plan, so their split boundaries agree."""
    return _tc_plan(m, k, n, TC_PACKED_BN, sms, groups)


MAX_GRID_Z = 65535  # groups x M tiles share gridDim.z


def _check_x_scale(x: torch.Tensor, scale: torch.Tensor) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    check_cuda_operand(x, "x", x.dtype, x.ndim)
    if scale.device != x.device or scale.dtype != torch.float32:
        raise ValueError("scale must be float32 on x's device")
    if x.ndim == 2 and scale.numel() != 1:
        raise ValueError("scale must be one float32 value")
    if x.ndim == 3 and (tuple(scale.shape) != tuple(x.shape[:1]) or not scale.is_contiguous()):
        raise ValueError(f"grouped scale must be contiguous f32[{x.shape[0]}], one a group")


def _check_grid(groups: int, m: int, rows_per_block: int) -> None:
    if groups * cdiv(m, rows_per_block) > MAX_GRID_Z:
        raise ValueError(f"{groups} groups x {cdiv(m, rows_per_block)} M tiles exceed the grid's "
                         f"{MAX_GRID_Z} z blocks")


def cim_matmul_packed(
    x: torch.Tensor,
    planes_packed: torch.Tensor,
    sign_packed: torch.Tensor,
    scale: torch.Tensor,
    *,
    tile_nz: torch.Tensor | None = None,
    plane_ids: torch.Tensor | None = None,
    plane_gain: torch.Tensor | None = None,
) -> torch.Tensor:
    """Bit-packed serving matmul: y = scale * (x @ unpack(planes, signs)) -> f32[M, N].

    x f32 or bf16 [M, K] (any K); planes_packed uint8[cols, ceil(K/8), N];
    sign_packed uint8[ceil(K/8), N]; scale an f32 scalar tensor.  Grouped:
    x [G, M, K] and every operand with a leading [G] (scale f32[G]) ->
    f32[G, M, N], one launch.
    ``tile_nz`` uint8[cols, ceil(K/128)] zero-tile flags (the const_rle
    codec) select kernel B4, which skips the flagged-zero tiles;
    ``plane_ids`` int32[cols] (the col_perm codec) weighs stored plane ``p``
    by ``2**plane_ids[p]``.  Both kernels give the same bits.
    ``plane_gain`` f32[cols, N] (drifted conductances) weighs stored plane
    ``p`` at column ``n`` by ``gain[p, n] * 2**plane_ids[p]``: B2's FMA
    kernel serves it with x cast to float32 (the tensor-core kernel's exact
    hi/lo split needs integer weights), and ``tile_nz`` is not used (the
    flags only skip exact zeros).

    On CUDA, bf16 x runs the tensor-core kernel and f32 x the FMA kernel.
    The tensor-core kernel needs ``plane_ids`` to be a permutation of
    ``range(cols)`` (what the col_perm codec stores: an argsort): ids that
    are not (a repeated or out-of-range id) give NaN in every element of
    the result, checked on the card with no host sync.  The FMA kernel and
    the plain version take any ids.
    """
    if x.ndim not in (2, 3):
        raise ValueError(f"x must be [M, K] or [G, M, K], got {tuple(x.shape)}")
    lead = tuple(x.shape[:-2])
    m, k = x.shape[-2:]
    if planes_packed.ndim != len(lead) + 3 or tuple(planes_packed.shape[:-3]) != lead:
        raise ValueError(f"planes shape {tuple(planes_packed.shape)} does not lead with {lead}")
    cols, kw, n = planes_packed.shape[-3:]
    if kw != cdiv(k, 8):
        raise ValueError(f"planes K bytes {kw} != ceil({k}/8)")
    if tuple(sign_packed.shape) != lead + (kw, n):
        raise ValueError(f"sign shape {tuple(sign_packed.shape)} != {lead + (kw, n)}")
    if tile_nz is not None and tuple(tile_nz.shape) != lead + (cols, cdiv(k, TILE_ROWS)):
        raise ValueError(f"tile_nz shape {tuple(tile_nz.shape)} != "
                         f"{lead + (cols, cdiv(k, TILE_ROWS))}")
    if plane_ids is not None and tuple(plane_ids.shape) != lead + (cols,):
        raise ValueError(f"plane_ids shape {tuple(plane_ids.shape)} != {lead + (cols,)}")
    if plane_gain is not None:
        if tuple(plane_gain.shape) != lead + (cols, n):
            raise ValueError(f"plane_gain shape {tuple(plane_gain.shape)} != {lead + (cols, n)}")
        tile_nz = None
        x = x.to(torch.float32)
    if not use_kernel(x):
        # the flags only skip exact zeros: the plain version needs none
        return cim_ref.cim_matmul_packed(x, planes_packed, sign_packed, scale, plane_ids,
                                         plane_gain)
    if not 1 <= cols <= MAX_COLS:
        raise ValueError(f"cols={cols} outside [1, {MAX_COLS}]")
    _check_x_scale(x, scale)
    r = len(lead)
    check_cuda_operand(planes_packed, "planes_packed", torch.uint8, r + 3)
    check_cuda_operand(sign_packed, "sign_packed", torch.uint8, r + 2)
    if tile_nz is not None:
        check_cuda_operand(tile_nz, "tile_nz", torch.uint8, r + 2)
    if plane_ids is not None:
        check_cuda_operand(plane_ids, "plane_ids", torch.int32, r + 1)
    if plane_gain is not None:
        check_cuda_operand(plane_gain, "plane_gain", torch.float32, r + 2)
    groups = lead[0] if lead else 1
    out = torch.empty(lead + (m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0 or k == 0 or groups == 0:
        return out.zero_()
    sms = _sm_count(x.device.index)
    tensor_cores = x.dtype == torch.bfloat16
    if tensor_cores:
        nwg, splits, k_per_split = tc_packed_launch_plan(m, k, n, sms, groups)
        _check_grid(groups, m, 64 * nwg)
        vec = (n % 16 == 0 and k % 8 == 0 and x.data_ptr() % 16 == 0
               and planes_packed.data_ptr() % 16 == 0 and sign_packed.data_ptr() % 16 == 0)
    else:
        mt, splits, k_per_split = launch_plan(m, k, n, sms, groups=groups)
        _check_grid(groups, m, mt)
        vec = n % 4 == 0 and planes_packed.data_ptr() % 4 == 0 and sign_packed.data_ptr() % 4 == 0
    ws = (torch.empty((groups, splits, m, n), dtype=torch.float32, device=x.device)
          if splits > 1 else out)
    ptrs = (x.data_ptr(), planes_packed.data_ptr(), sign_packed.data_ptr(),
            None if plane_ids is None else plane_ids.data_ptr(),
            None if tile_nz is None else tile_nz.data_ptr())
    tail = (scale.data_ptr(), out.data_ptr(), ws.data_ptr(), m, k, n, cols, groups)
    if tensor_cores:
        err = _packed_tc_lib()(*ptrs, *tail, nwg, int(vec), splits, k_per_split,
                               current_stream())
    else:
        gain = None if plane_gain is None else plane_gain.data_ptr()
        err = _packed_lib()(*ptrs, gain, *tail, mt, int(vec), splits, k_per_split,
                            current_stream())
    kernel = "B2" if tile_nz is None else "B4"
    check_launch(err, kernel)
    LAUNCHES[kernel] += 1
    LAUNCHES[f"{kernel}_tc"] += int(tensor_cores)
    LAUNCHES["B2_gain"] += int(plane_gain is not None)
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
    f32 scalar tensor.  Grouped: x [G, M, K], splanes [G, cols, K, N],
    scale f32[G] -> f32[G, M, N], one launch.  ``mode`` is ``"fused_dequant"`` (rebuild the
    weight, one dot: what serving uses) or ``"planes"`` (one dot per
    plane).
    """
    if mode not in cim_ref.MODES:
        raise ValueError(f"unknown mode {mode!r}; choose from {cim_ref.MODES}")
    if x.ndim not in (2, 3):
        raise ValueError(f"x must be [M, K] or [G, M, K], got {tuple(x.shape)}")
    lead = tuple(x.shape[:-2])
    m, k = x.shape[-2:]
    if splanes.ndim != len(lead) + 3 or tuple(splanes.shape[:-3]) != lead:
        raise ValueError(f"splanes shape {tuple(splanes.shape)} does not lead with {lead}")
    cols, k2, n = splanes.shape[-3:]
    if k != k2:
        raise ValueError(f"K mismatch: x has {k}, splanes has {k2}")
    if not use_kernel(x):
        return cim_ref.cim_matmul(x, splanes, scale, mode)
    if not 1 <= cols <= MAX_COLS:
        raise ValueError(f"cols={cols} outside [1, {MAX_COLS}]")
    _check_x_scale(x, scale)
    check_cuda_operand(splanes, "splanes", torch.int8, len(lead) + 3)
    groups = lead[0] if lead else 1
    out = torch.empty(lead + (m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0 or k == 0 or groups == 0:
        return out.zero_()
    tensor_cores = x.dtype == torch.bfloat16 and mode == "fused_dequant"
    if tensor_cores:
        nwg, splits, k_per_split = tc_launch_plan(m, k, n, cols, _sm_count(x.device.index),
                                                  groups)
        _check_grid(groups, m, 64 * nwg)
        vec = (n % 16 == 0 and k % 8 == 0 and splanes.data_ptr() % 16 == 0
               and x.data_ptr() % 16 == 0)
    else:
        # B5 streams 8x the bytes of B2 with little work per byte: more
        # blocks per SM keep more of its loads in flight
        mt, splits, k_per_split = launch_plan(m, k, n, _sm_count(x.device.index),
                                              blocks_per_sm=4, groups=groups)
        _check_grid(groups, m, mt)
        vec = n % 4 == 0 and splanes.data_ptr() % 4 == 0
    ws = (torch.empty((groups, splits, m, n), dtype=torch.float32, device=x.device)
          if splits > 1 else out)
    if tensor_cores:
        err = _planes_tc_lib()(
            x.data_ptr(), splanes.data_ptr(), scale.data_ptr(), out.data_ptr(), ws.data_ptr(),
            m, k, n, cols, groups, nwg, int(vec), splits, k_per_split, current_stream(),
        )
    else:
        err = _planes_lib()(
            x.data_ptr(), int(x.dtype == torch.bfloat16), splanes.data_ptr(), scale.data_ptr(),
            out.data_ptr(), ws.data_ptr(), m, k, n, cols, groups, mt, int(vec),
            int(mode == "planes"), splits, k_per_split, current_stream(),
        )
    check_launch(err, "B5")
    LAUNCHES["B5"] += 1
    LAUNCHES["B5_tc"] += int(tensor_cores)
    return out
