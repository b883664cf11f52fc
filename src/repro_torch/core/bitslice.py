"""Quantization and bit-plane slicing for bit-sliced CIM crossbars.

Port of ``repro.core.bitslice``.  Conventions are the reference's:

* plane axis is the **last** axis of section planes; index ``0`` is the
  lowest-order column (LSB) — the column bit stucking targets;
* ``sign_magnitude``: ``w ~= sign * scale * q`` with ``q`` in
  ``[0, 2**cols - 1]``; ``offset_binary``: ``w ~= scale * q + offset`` with
  all signs +1 and ``offset = min(w)`` (the rank-1 term ``sum(x) * offset``
  corrects a matmul);
* packed words hold 8 rows (or 8 K values) MSB-first per byte, the order of
  ``numpy.packbits``; padding bits are zero.

Every function is a plain function on tensors and keeps its inputs' device.
Packing works one bit plane at a time, so a tensor of ``n`` weights never
needs more than a few ``n``-sized temporaries (the full-width planner packs
134M-weight stacks on the card).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

ENCODINGS = ("sign_magnitude", "offset_binary")


@dataclasses.dataclass
class Quantized:
    """A flat quantized tensor: ``q`` int32[n] magnitudes, ``sign`` int8[n]
    (+1/-1; all +1 for offset_binary), ``scale``/``offset`` float32 scalars
    (offset 0 for sign_magnitude), static ``cols`` and ``encoding``."""

    q: torch.Tensor
    sign: torch.Tensor
    scale: torch.Tensor
    offset: torch.Tensor
    cols: int
    encoding: str


def quant_params(flat: torch.Tensor, cols: int,
                 encoding: str = "sign_magnitude") -> tuple[torch.Tensor, torch.Tensor]:
    """(scale, offset) of :func:`quantize` for the flat float32 ``flat``,
    from its min and max alone (no full-size temporary): range ``max|w|``
    (the larger of ``|min|`` and ``|max|``, the same float) or ``max - min``
    for offset_binary, and ``scale = range * (1/levels)`` with a float32
    reciprocal constant.  A range below ``tiny * levels`` (a constant
    tensor) gives a subnormal scale, which XLA:CPU flushes to zero; so does
    the port."""
    if encoding not in ENCODINGS:
        raise ValueError(f"unknown encoding: {encoding!r}")
    dev = flat.device
    inv_levels = torch.tensor(1.0 / (2**cols - 1), dtype=torch.float32, device=dev)
    tiny = torch.tensor(torch.finfo(torch.float32).tiny, dtype=torch.float32, device=dev)
    if encoding == "offset_binary":
        lo, hi = torch.aminmax(flat)
        rng, offset = hi - lo, lo
    else:
        if flat.numel():
            lo, hi = torch.aminmax(flat)
            rng = torch.maximum(lo.abs(), hi.abs())
        else:
            rng = tiny
        offset = torch.zeros((), dtype=torch.float32, device=dev)
    scale = torch.maximum(rng, tiny) * inv_levels
    scale = torch.where(scale < tiny, torch.zeros_like(scale), scale)
    return scale, offset


def quantize_values(flat: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor, cols: int,
                    encoding: str = "sign_magnitude") -> tuple[torch.Tensor, torch.Tensor]:
    """(q int32, sign int8) of float32 weights under a given scale and
    offset: ``round(|w| / scale)`` or ``round((w - offset) / scale)``, a true
    division rounding half to even, clamped to the levels (``0 / 0`` gives
    q = 0, as XLA's conversion of NaN does); elementwise, so any slice of a
    tensor quantizes as the whole does."""
    levels = float(2**cols - 1)
    mag = flat - offset if encoding == "offset_binary" else flat.abs()
    q = torch.clamp(torch.nan_to_num(torch.round(mag / scale), nan=0.0), 0, levels)
    if encoding == "offset_binary":
        sign = torch.ones(flat.shape, dtype=torch.int8, device=flat.device)
    else:
        sign = torch.where(flat < 0, -1, 1).to(torch.int8)
    return q.to(torch.int32), sign


def quantize(w: torch.Tensor, cols: int, encoding: str = "sign_magnitude") -> Quantized:
    """Quantize a tensor (any shape; flattened) to ``cols``-bit crossbar form.

    Same operation order as the reference (:func:`quant_params`, then
    :func:`quantize_values`).
    """
    flat = w.reshape(-1).to(torch.float32)
    scale, offset = quant_params(flat, cols, encoding)
    q, sign = quantize_values(flat, scale, offset, cols, encoding)
    return Quantized(q=q, sign=sign, scale=scale, offset=offset, cols=cols, encoding=encoding)


def dequantize(qt: Quantized) -> torch.Tensor:
    """Inverse of :func:`quantize` (returns the flat tensor)."""
    mag = qt.q.to(torch.float32) * qt.scale
    if qt.encoding == "sign_magnitude":
        return mag * qt.sign.to(torch.float32)
    return mag + qt.offset


def dequantize_from_planes(planes: torch.Tensor, sign: torch.Tensor, scale: torch.Tensor,
                           offset: torch.Tensor) -> torch.Tensor:
    """Weights from (possibly stuck) bit planes bool/int[..., cols] (plane 0
    = LSB): the integer magnitude, then ``q * scale * sign + offset`` as
    separate multiplies and one add, the reference's operation order (a
    fused multiply-add would change the last bit).  The bool oracle's
    dequantization; the packed planner rebuilds q from packed words."""
    cols = planes.shape[-1]
    weights_of_two = 2 ** torch.arange(cols, dtype=torch.int32, device=planes.device)
    q = torch.sum(planes.to(torch.int32) * weights_of_two, dim=-1, dtype=torch.int32)
    return q.to(torch.float32) * scale * sign.to(torch.float32) + offset


def bitplanes(q: torch.Tensor, cols: int) -> torch.Tensor:
    """Extract bit planes: int[...] -> bool[..., cols]; plane 0 = LSB."""
    shifts = torch.arange(cols, dtype=q.dtype, device=q.device)
    return ((q[..., None] >> shifts) & 1).to(torch.bool)


def _msb_weights(device) -> torch.Tensor:
    return torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8, device=device)


def packbits(bits: torch.Tensor, axis: int) -> torch.Tensor:
    """``numpy.packbits(bits, axis)``: {0,1} values packed MSB-first, zero-padded."""
    axis = axis % bits.ndim
    n = bits.shape[axis]
    pad = (-n) % 8
    b = bits.to(torch.uint8)
    if pad:
        b = F.pad(b, [0, 0] * (b.ndim - axis - 1) + [0, pad])
    shape = b.shape[:axis] + ((n + pad) // 8, 8) + b.shape[axis + 1:]
    b = b.reshape(shape)
    w = _msb_weights(b.device).reshape((8,) + (1,) * (b.ndim - axis - 2))
    return (b * w).sum(dim=axis + 1, dtype=torch.uint8)


def unpackbits(packed: torch.Tensor, axis: int, count: int) -> torch.Tensor:
    """``numpy.unpackbits(packed, axis, count=count)`` -> uint8 {0,1}."""
    axis = axis % packed.ndim
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    shifts = shifts.reshape((8,) + (1,) * (packed.ndim - axis - 1))
    bits = (packed.unsqueeze(axis + 1) >> shifts) & 1
    shape = packed.shape[:axis] + (packed.shape[axis] * 8,) + packed.shape[axis + 1:]
    return bits.reshape(shape).narrow(axis, 0, count)


def pack_rows(planes: torch.Tensor) -> torch.Tensor:
    """bool[S, rows, cols] -> uint8[S, ceil(rows/8), cols] (rows MSB-first)."""
    return packbits(planes, 1)


def unpack_rows(packed: torch.Tensor, rows: int) -> torch.Tensor:
    """Inverse of :func:`pack_rows` -> bool[S, rows, cols]."""
    return unpackbits(packed, 1, rows).to(torch.bool)


def pack_axis0(mask: torch.Tensor) -> torch.Tensor:
    """bool[rows, k] -> uint8[ceil(rows/8), k] (same MSB-first convention)."""
    return packbits(mask, 0)


def section_planes_packed(q: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """int32[S*rows] magnitudes -> packed uint8[S, ceil(rows/8), cols] planes.

    ``q`` must already be padded to a multiple of ``rows``.  Built one plane
    at a time (equal to ``pack_rows(bitplanes(q.reshape(-1, rows), cols))``).
    """
    sec = q.reshape(-1, rows)
    return torch.stack(
        [packbits((sec >> b) & 1, 1) for b in range(cols)], dim=-1
    )


def pack_linear_planes(q: torch.Tensor, cols: int) -> torch.Tensor:
    """int[..., K, N] magnitudes -> packed uint8[..., cols, ceil(K/8), N].

    The serving operand layout: plane axis first (plane 0 = LSB), K packed
    MSB-first per byte, K-padding bits zero.
    """
    return torch.stack([packbits((q >> b) & 1, -2) for b in range(cols)], dim=-3)


def pack_linear_sign(sign: torch.Tensor) -> torch.Tensor:
    """+1/-1 int8[..., K, N] -> sign bits uint8[..., ceil(K/8), N] (1 = negative)."""
    return packbits(sign < 0, -2)


def section(flat: torch.Tensor, rows: int) -> tuple[torch.Tensor, int]:
    """Zero-pad a flat array to whole sections: (sections[S, rows], n)."""
    n = flat.shape[0]
    pad = (-n) % rows
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(-1, rows), n


def unsection(sections: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`section`: drop padding, return flat[n]."""
    return sections.reshape(-1)[:n]


def section_planes(q: torch.Tensor, rows: int, cols: int) -> tuple[torch.Tensor, int]:
    """int32[n] magnitudes -> (bool[S, rows, cols] section bit planes, n)."""
    sec, n = section(q, rows)
    return bitplanes(sec, cols), n


def encode_planes(packed: torch.Tensor, codec: str = "raw", *, chains=None, pin_cols: int = 0):
    """Canonical packed planes -> stored :class:`~repro_torch.core.planes.PlaneSet`
    (``planes.encode``); ``decode_planes(encode_planes(p, c))`` is ``p``
    byte for byte for every codec."""
    from repro_torch.core import planes  # deferred: planes imports schedule -> bitslice

    return planes.encode(packed, codec, chains=chains, pin_cols=pin_cols)


def decode_planes(plane_set) -> torch.Tensor:
    """Stored ``PlaneSet`` -> canonical packed uint8[S, ceil(rows/8), cols]
    planes."""
    return plane_set.decode()
