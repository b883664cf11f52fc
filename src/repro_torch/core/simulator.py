"""CIM crossbar forward: matmuls computed on the deployed bit planes.

Port of the operand part of ``repro.core.simulator``.  The serving operand
of a deployed weight ``[..., K, N]`` is one of two dicts:

* **packed planes** — ``planes_packed`` uint8[..., cols, ceil(K/8), N]
  (plane 0 = LSB, K packed MSB-first per byte) and ``sign_packed``
  uint8[..., ceil(K/8), N] (bit 1 = negative): the bits the crossbars hold,
  one bit of weight traffic per cell; ``kdim`` float32[..., K, 0] is a
  zero-size marker whose shape carries the true contraction length.  A
  plane codec may add ``plane_ids`` int32[..., cols] (col_perm: stored plane
  ``p`` weighs ``2**plane_ids[p]``) and ``plane_tile_nz``
  uint8[..., cols, ceil(K/128)] (const_rle: zero-tile flags);
* **int8 signed planes** — ``splanes`` int8[..., cols, K, N] in
  {-1, 0, 1}, sign folded in: one byte of traffic per bit cell, the
  per-step bit-sliced simulation baseline.

Both carry ``scale`` / ``offset`` float32[...].  ``cim_linear`` runs the
matching kernel on CUDA tensors (B5 for int8 planes, B4 for flagged packed
planes, B2 otherwise) and its plain version on CPU tensors
(``kernels.cim_matmul.ops``), then adds the rank-1 offset term.
Numerically every route equals ``x @ w_hat``.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitslice
from repro_torch.core import planes as planes_mod
from repro_torch.kernels.cim_matmul import ops as cim_ops
from repro_torch.kernels.cim_matmul import ref as cim_ref


def _lead_scalars(scale, offset, lead: tuple[int, ...], dev) -> dict[str, torch.Tensor]:
    def expand(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev).expand(lead).contiguous()

    return {"scale": expand(scale), "offset": expand(offset)}


def int8_plane_operands(
    q: torch.Tensor, sign: torch.Tensor, scale, offset, cols: int
) -> dict[str, torch.Tensor]:
    """Magnitudes + signs [..., K, N] -> int8 signed-plane operands
    (``splanes`` [..., cols, K, N], plane 0 = LSB, sign folded in)."""
    splanes = torch.stack(
        [((q >> b) & 1).to(torch.int8) * sign for b in range(cols)], dim=-3
    )
    return {"splanes": splanes, **_lead_scalars(scale, offset, tuple(q.shape[:-2]), q.device)}


def packed_operands(
    q: torch.Tensor, sign: torch.Tensor, scale, offset, cols: int
) -> dict[str, torch.Tensor]:
    """Magnitudes + signs [..., K, N] -> bit-packed serving operands."""
    lead = tuple(q.shape[:-2])
    return {
        "planes_packed": bitslice.pack_linear_planes(q, cols),
        "sign_packed": bitslice.pack_linear_sign(sign),
        **_lead_scalars(scale, offset, lead, q.device),
        "kdim": torch.zeros(lead + (q.shape[-2], 0), dtype=torch.float32, device=q.device),
    }


def operands_from_dense(
    w_hat: torch.Tensor,
    scale: float | torch.Tensor,
    offset: float | torch.Tensor,
    encoding: str,
    cols: int,
    materialize: str = "packed",
    codec: str = "raw",
) -> dict[str, torch.Tensor]:
    """Recover crossbar operands from achieved dense weights ``w_hat``.

    ``w_hat`` is exactly representable under (scale, encoding) for any
    planner-deployed tensor, so the rounding below recovers the integer
    magnitudes exactly.  ``signbit`` (not ``< 0``) keeps the sign of a
    q = 0 cell stored as -0.0.  ``codec`` applies the serving-side plane
    codec (``planes.encode_operands``) to packed operands; only they have a
    stored-plane layout to encode.
    """
    if codec != "raw" and materialize != "packed":
        raise ValueError(
            f"codec {codec!r} encodes packed serving operands; materialize "
            f"{materialize!r} has no stored-plane layout"
        )
    if materialize not in ("packed", "planes_int8"):
        raise ValueError(f"unknown operand materialize {materialize!r}")
    if encoding != "sign_magnitude":
        raise NotImplementedError(
            f"encoding {encoding!r} is not ported (offset_binary: ROADMAP A.2)"
        )
    w32 = w_hat.to(torch.float32)
    scale_t = torch.as_tensor(scale, dtype=torch.float32, device=w32.device)
    levels = float(2**cols - 1)
    q = torch.clamp(torch.round(w32.abs() / scale_t), 0, levels).to(torch.int32)
    sign = torch.where(torch.signbit(w32), -1, 1).to(torch.int8)
    if materialize == "planes_int8":
        return int8_plane_operands(q, sign, scale_t, offset, cols)
    return planes_mod.encode_operands(packed_operands(q, sign, scale_t, offset, cols), codec)


def is_cim_operands(w) -> bool:
    """True if ``w`` is a crossbar operand dict rather than a dense tensor."""
    return isinstance(w, dict) and ("planes_packed" in w or "splanes" in w)


def densify_operands(op: dict[str, torch.Tensor]) -> torch.Tensor:
    """Packed operand dict -> dense achieved weights f32[..., K, N]
    (unpack, weight by ``2**plane_ids``, sign, then ``* scale + offset``)."""
    k = op["kdim"].shape[-2]
    w = cim_ref.unpack_weights(op["planes_packed"], op["sign_packed"], k, op.get("plane_ids"))
    return w * op["scale"][..., None, None] + op["offset"][..., None, None]


def densify_packed(params):
    """Replace every packed operand dict in a params tree with its dense
    achieved weights; int8-plane dicts (the per-step bit-sliced simulation
    baseline) and dense leaves pass through untouched."""
    if isinstance(params, dict) and "planes_packed" in params:
        return densify_operands(params)
    if isinstance(params, dict):
        return {k: densify_packed(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(densify_packed(v) for v in params)
    return params


def cim_linear(x: torch.Tensor, operands: dict[str, torch.Tensor]) -> torch.Tensor:
    """y = x @ w_hat computed on the deployed planes -> f32[M, N].

    x: [M, K] on the operands' device.  Int8 planes take kernel B5;
    packed planes take B4 when they carry zero-tile flags and B2 otherwise,
    with ``plane_ids`` inside the kernel (plain versions on the CPU).  The
    rank-1 term ``sum(x) * offset`` is the offset encoding's digital
    correction; offset is exactly 0 for sign_magnitude.
    """
    if "splanes" in operands:
        y = cim_ops.cim_matmul(x, operands["splanes"], operands["scale"])
    else:
        y = cim_ops.cim_matmul_packed(
            x, operands["planes_packed"], operands["sign_packed"], operands["scale"],
            tile_nz=operands.get("plane_tile_nz"), plane_ids=operands.get("plane_ids"),
        )
    return y + torch.sum(x, dim=-1, keepdim=True, dtype=torch.float32) * operands["offset"]
