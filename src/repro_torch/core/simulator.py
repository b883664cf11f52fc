"""CIM crossbar forward: matmuls computed on the deployed bit planes.

Port of the packed-operand part of ``repro.core.simulator``.  The serving
operand of a deployed weight ``[..., K, N]`` is a dict of

* ``planes_packed`` uint8[..., cols, ceil(K/8), N] (plane 0 = LSB, K packed
  MSB-first per byte) and ``sign_packed`` uint8[..., ceil(K/8), N]
  (bit 1 = negative) — the same bits the crossbars hold, one bit of weight
  traffic per cell;
* ``scale`` / ``offset`` float32[...] dequantization constants;
* ``kdim`` float32[..., K, 0]: a zero-size marker whose shape carries the
  true (unpadded) contraction length.

``cim_linear`` runs the packed matmul kernel on CUDA tensors and its plain
version on CPU tensors (``kernels.cim_matmul.ops``), then adds the rank-1
offset term.  Numerically every route equals ``x @ w_hat``.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitslice
from repro_torch.kernels.cim_matmul import ops as cim_ops
from repro_torch.kernels.cim_matmul import ref as cim_ref


def packed_operands(
    q: torch.Tensor, sign: torch.Tensor, scale, offset, cols: int
) -> dict[str, torch.Tensor]:
    """Magnitudes + signs [..., K, N] -> bit-packed serving operands."""
    lead = tuple(q.shape[:-2])
    dev = q.device
    return {
        "planes_packed": bitslice.pack_linear_planes(q, cols),
        "sign_packed": bitslice.pack_linear_sign(sign),
        "scale": torch.as_tensor(scale, dtype=torch.float32, device=dev).expand(lead).contiguous(),
        "offset": torch.as_tensor(offset, dtype=torch.float32, device=dev).expand(lead).contiguous(),
        "kdim": torch.zeros(lead + (q.shape[-2], 0), dtype=torch.float32, device=dev),
    }


def operands_from_dense(
    w_hat: torch.Tensor,
    scale: float | torch.Tensor,
    offset: float | torch.Tensor,
    encoding: str,
    cols: int,
) -> dict[str, torch.Tensor]:
    """Recover packed crossbar operands from achieved dense weights ``w_hat``.

    ``w_hat`` is exactly representable under (scale, encoding) for any
    planner-deployed tensor, so the rounding below recovers the integer
    magnitudes exactly.  ``signbit`` (not ``< 0``) keeps the sign of a
    q = 0 cell stored as -0.0.
    """
    if encoding != "sign_magnitude":
        raise NotImplementedError(f"encoding {encoding!r} is not ported")
    w32 = w_hat.to(torch.float32)
    scale_t = torch.as_tensor(scale, dtype=torch.float32, device=w32.device)
    levels = float(2**cols - 1)
    q = torch.clamp(torch.round(w32.abs() / scale_t), 0, levels).to(torch.int32)
    sign = torch.where(torch.signbit(w32), -1, 1).to(torch.int8)
    return packed_operands(q, sign, scale_t, offset, cols)


def is_cim_operands(w) -> bool:
    """True if ``w`` is a packed crossbar operand dict rather than a dense tensor."""
    return isinstance(w, dict) and "planes_packed" in w


def densify_operands(op: dict[str, torch.Tensor]) -> torch.Tensor:
    """Packed operand dict -> dense achieved weights f32[..., K, N]
    (unpack, weight, sign, then ``* scale + offset``)."""
    k = op["kdim"].shape[-2]
    w = cim_ref.unpack_weights(op["planes_packed"], op["sign_packed"], k)
    return w * op["scale"][..., None, None] + op["offset"][..., None, None]


def densify_packed(params):
    """Replace every packed operand dict in a params tree with its dense
    achieved weights; dense leaves pass through untouched."""
    if is_cim_operands(params):
        return densify_operands(params)
    if isinstance(params, dict):
        return {k: densify_packed(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(densify_packed(v) for v in params)
    return params


def cim_linear(x: torch.Tensor, operands: dict[str, torch.Tensor]) -> torch.Tensor:
    """y = x @ w_hat computed on the packed planes -> f32[M, N].

    x: [M, K] on the operands' device (CUDA: the packed kernel; CPU: its
    plain version).  The rank-1 term ``sum(x) * offset`` is the offset
    encoding's digital correction; offset is exactly 0 for sign_magnitude.
    """
    y = cim_ops.cim_matmul_packed(
        x, operands["planes_packed"], operands["sign_packed"], operands["scale"]
    )
    return y + torch.sum(x, dim=-1, keepdim=True, dtype=torch.float32) * operands["offset"]
