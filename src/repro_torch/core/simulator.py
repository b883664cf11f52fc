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
  uint8[..., cols, ceil(K/128)] (const_rle: zero-tile flags), and
  ``nonideal.perturb_operands`` the faults of a non-ideal array
  (``stuck0_packed`` / ``stuck1_packed`` masks, ``plane_gain``
  f32[..., cols, N], ``row_atten`` f32[..., K]);
* **int8 signed planes** — ``splanes`` int8[..., cols, K, N] in
  {-1, 0, 1}, sign folded in (built by kernel B6 on CUDA): one byte of
  traffic per bit cell, the per-step bit-sliced simulation baseline.

Both carry ``scale`` / ``offset`` float32[...].  ``cim_linear`` runs the
matching kernel on CUDA tensors (B5 for int8 planes, B4 for flagged packed
planes, B2 otherwise) and its plain version on CPU tensors
(``kernels.cim_matmul.ops``), then adds the rank-1 offset term.
Numerically every route equals ``x @ w_hat``.

``prepare_linear`` quantizes one [K, N] weight straight into either dict
(the natural, unsorted layout).  The fidelity probes ``output_mse``,
``logit_kl`` and ``top1_agreement`` compare a model's outputs under two
parameter sets (fp and deployed), as the reference's do, and
``deploy_and_probe`` plans, deploys and probes in one call.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitslice
from repro_torch.core import planes as planes_mod
from repro_torch.core.planner import (
    CrossbarSpec,
    DeploymentPlan,
    PlannerConfig,
    build_deployment,
    deploy_params,
)
from repro_torch.kernels.bitslice import ops as bs_ops
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
    (``splanes`` [..., cols, K, N], plane 0 = LSB, sign folded in).

    The route of the reference's ``operands_from_dense``, in plain torch ops;
    serving builds its planes with kernel B6 instead (``operands_from_dense``),
    and the tests and ``chip_smoke.py`` hold B6 against this."""
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

    ``w_hat`` is exactly representable under (scale, offset, encoding) for
    any planner-deployed tensor, so the rounding below recovers the integer
    magnitudes exactly: ``round(|w_hat| / scale)`` with the sign from
    ``signbit`` (not ``< 0``: a q = 0 cell stored as -0.0 keeps its sign)
    for sign_magnitude, ``round((w_hat - offset) / scale)`` with all signs
    +1 for offset_binary.  ``codec`` applies the serving-side plane codec
    (``planes.encode_operands``) to packed operands; only they have a
    stored-plane layout to encode.

    Int8 planes are built by ``bitslice_planes(d, 1 / scale, cols)`` on
    ``d = w_hat`` (sign_magnitude) or ``d = w_hat - offset`` (offset_binary)
    — kernel B6 on CUDA, its plain version on the CPU — the role the
    reference's bitslice kernel was written for: for a deployed weight
    ``|d| * (1 / scale)`` lies within ~1e-4 of the same integer as
    ``d / scale``, and a q = 0 cell (also one whose ``d`` comes out as -0.0
    or a tiny negative) is 0 in every plane whatever its sign, so the
    planes equal the reference's.
    """
    if codec != "raw" and materialize != "packed":
        raise ValueError(
            f"codec {codec!r} encodes packed serving operands; materialize "
            f"{materialize!r} has no stored-plane layout"
        )
    if materialize not in ("packed", "planes_int8"):
        raise ValueError(f"unknown operand materialize {materialize!r}")
    if encoding not in bitslice.ENCODINGS:
        raise ValueError(f"unknown encoding: {encoding!r}")
    w32 = w_hat.to(torch.float32).contiguous()
    scale_t = torch.as_tensor(scale, dtype=torch.float32, device=w32.device)
    offset_t = torch.as_tensor(offset, dtype=torch.float32, device=w32.device)
    d = w32 if encoding == "sign_magnitude" else w32 - offset_t
    if materialize == "planes_int8":
        splanes = bs_ops.bitslice_planes(d, 1.0 / scale_t, cols)
        return {"splanes": splanes,
                **_lead_scalars(scale_t, offset_t, tuple(w32.shape[:-2]), w32.device)}
    levels = float(2**cols - 1)
    if encoding == "sign_magnitude":
        q = torch.clamp(torch.round(w32.abs() / scale_t), 0, levels).to(torch.int32)
        sign = torch.where(torch.signbit(w32), -1, 1).to(torch.int8)
    else:
        q = torch.clamp(torch.round(d / scale_t), 0, levels).to(torch.int32)
        sign = torch.ones_like(q, dtype=torch.int8)
    return planes_mod.encode_operands(packed_operands(q, sign, scale_t, offset_t, cols), codec)


def is_cim_operands(w) -> bool:
    """True if ``w`` is a crossbar operand dict rather than a dense tensor."""
    return isinstance(w, dict) and ("planes_packed" in w or "splanes" in w)


def shard_operands(op: dict[str, torch.Tensor], *, axis: int, index: int,
                   n: int) -> dict[str, torch.Tensor]:
    """Slice a crossbar operand dict along one logical weight axis: shard
    ``index`` of ``n`` of a tensor-parallel layout (column-parallel slices
    ``axis=-1``/N, row-parallel slices ``axis=-2``/K).  Views, no copy.

    Exactness contract: ``densify_operands(shard_operands(op, ...)) ==
    densify_operands(op)[..., slice]`` byte for byte — no repacking, no
    requantization.  The planes store K packed 8 per byte, so a K slice must
    land on byte boundaries (``(K // n) % 8 == 0``; ``parallel.tp.plan_tp``
    replicates otherwise).  Per field:

    * ``planes_packed`` / ``stuck0_packed`` / ``stuck1_packed``
      uint8[..., cols, K8, N] and ``sign_packed`` uint8[..., K8, N]: N on
      the last axis, or bytes ``k0//8:k1//8`` of the packed-K axis;
    * ``kdim`` [..., K, 0]: its K axis sliced on K shards;
    * ``plane_ids``, ``scale``, ``offset``: passed through;
    * ``plane_gain`` f32[..., cols, N]: sliced on N shards, passed through
      on K shards (the reference passes it through on both, which leaves an
      N shard's gains at the full width: ROADMAP C.9);
    * ``plane_tile_nz`` [..., cols, ceil(K/128)]: kept on N shards (flags
      reduced over N stay honest: a missed skip, never a wrong read),
      dropped on K shards (the tile grid moves; B2 then runs in place of B4);
    * ``row_atten`` [..., K]: sliced on K shards;
    * ``splanes`` int8[..., cols, K, N]: either axis, no byte rule.
    """
    if axis not in (-1, -2):
        raise ValueError(f"axis must be -1 (N) or -2 (K), got {axis}")
    if not 0 <= index < n:
        raise ValueError(f"shard index {index} outside [0, {n})")
    packed = "planes_packed" in op
    planes = op["planes_packed"] if packed else op["splanes"]
    if axis == -1:
        dim = planes.shape[-1]
    else:
        dim = op["kdim"].shape[-2] if packed else planes.shape[-2]
    if dim % n:
        raise ValueError(f"axis {axis} extent {dim} not divisible by {n} shards")
    lo, hi = index * (dim // n), (index + 1) * (dim // n)
    if packed and axis == -2 and (lo % 8 or hi % 8):
        raise ValueError(f"packed K shard [{lo}:{hi}) not byte-aligned (K//n must be % 8)")
    out = {}
    for name, arr in op.items():
        if name in ("scale", "offset", "plane_ids"):
            out[name] = arr
        elif name == "plane_gain":
            out[name] = arr[..., lo:hi] if axis == -1 else arr
        elif name == "plane_tile_nz":
            if axis == -1:
                out[name] = arr
        elif name == "row_atten":
            out[name] = arr[..., lo:hi] if axis == -2 else arr
        elif name == "kdim":
            out[name] = arr[..., lo:hi, :] if axis == -2 else arr
        elif axis == -1:
            out[name] = arr[..., lo:hi]
        elif name == "sign_packed":
            out[name] = arr[..., lo // 8: hi // 8, :]
        else:  # planes_packed / stuck0_packed / stuck1_packed / splanes
            k0, k1 = (lo // 8, hi // 8) if packed else (lo, hi)
            out[name] = arr[..., k0:k1, :]
    return out


def read_planes(op: dict[str, torch.Tensor]) -> torch.Tensor:
    """The stored planes of a packed operand dict as a read returns them:
    through the stuck masks ``nonideal.perturb_operands`` adds, if any."""
    planes = op["planes_packed"]
    if "stuck0_packed" in op:
        planes = (planes & ~op["stuck0_packed"]) | op["stuck1_packed"]
    return planes


def densify_operands(op: dict[str, torch.Tensor]) -> torch.Tensor:
    """Packed operand dict -> dense achieved weights f32[..., K, N]
    (unpack, weight by ``plane_gain * 2**plane_ids``, sign, then ``* scale
    + offset``).

    A perturbed dict (``nonideal.perturb_operands``) densifies to what a
    faulty read yields: stuck masks applied to the stored planes,
    ``plane_gain`` in the plane weights (significance from ``plane_ids``
    after the masked read) and ``row_atten`` folded into the rows (``x @
    (diag(a) W) == (x * a) @ W``, as ``cim_linear`` folds it into x)."""
    k = op["kdim"].shape[-2]
    w = cim_ref.unpack_weights(read_planes(op), op["sign_packed"], k, op.get("plane_ids"),
                               op.get("plane_gain"))
    w = w * op["scale"][..., None, None] + op["offset"][..., None, None]
    if "row_atten" in op:
        w = w * op["row_atten"][..., :, None]
    return w


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


def prepare_linear(
    w: torch.Tensor,
    spec: CrossbarSpec = CrossbarSpec(),
    *,
    materialize: str = "int8",
    codec: str = "raw",
) -> dict[str, torch.Tensor]:
    """Quantize a [K, N] weight matrix into crossbar operands for ``cim_linear``.

    The execution path's natural, unpermuted layout (the planner's
    programming order does not apply), on ``w``'s device.
    ``materialize="int8"`` gives the signed int8 planes (plain torch ops,
    as the reference builds them here) plus the ``encoding`` tag;
    ``"packed"`` the bit-packed serving operands, codec-encoded by
    ``planes.encode_operands``.
    """
    if w.ndim != 2:
        raise ValueError("prepare_linear expects a 2-D weight")
    if codec != "raw" and materialize != "packed":
        raise ValueError(
            f"codec {codec!r} encodes packed serving operands; materialize "
            f"{materialize!r} has no stored-plane layout"
        )
    qt = bitslice.quantize(w, spec.cols, spec.encoding)
    q, sign = qt.q.reshape(w.shape), qt.sign.reshape(w.shape)
    if materialize == "packed":
        return planes_mod.encode_operands(
            packed_operands(q, sign, qt.scale, qt.offset, spec.cols), codec)
    if materialize != "int8":
        raise ValueError(f"unknown materialize: {materialize!r}")
    return {**int8_plane_operands(q, sign, qt.scale, qt.offset, spec.cols),
            "encoding": spec.encoding}


def cim_linear(x: torch.Tensor, operands: dict[str, torch.Tensor]) -> torch.Tensor:
    """y = x @ w_hat computed on the deployed planes -> f32[M, N].

    x: [M, K] on the operands' device.  Int8 planes take kernel B5;
    packed planes take B4 when they carry zero-tile flags and B2 otherwise,
    with ``plane_ids`` inside the kernel (plain versions on the CPU).  The
    rank-1 term ``sum(x) * offset`` is the offset encoding's digital
    correction, added once on every operand kind; offset is exactly 0 for
    sign_magnitude, and an operand tagged ``encoding="sign_magnitude"``
    (``prepare_linear``'s int8 planes) skips it, as in the reference.

    A perturbed packed dict (``nonideal.perturb_operands``) reads its planes
    through the stuck masks first (the zero-tile flags no longer describe
    them, so B2 serves it), folds ``row_atten`` into x (the offset term
    then sums the folded x, as in the reference) and hands ``plane_gain``
    to B2's FMA kernel (x in float32).
    """
    if "splanes" in operands:
        y = cim_ops.cim_matmul(x, operands["splanes"], operands["scale"])
    else:
        if "row_atten" in operands:
            x = x * operands["row_atten"]
        masked = "stuck0_packed" in operands
        y = cim_ops.cim_matmul_packed(
            x, read_planes(operands), operands["sign_packed"], operands["scale"],
            tile_nz=None if masked else operands.get("plane_tile_nz"),
            plane_ids=operands.get("plane_ids"), plane_gain=operands.get("plane_gain"),
        )
    if operands.get("encoding") == "sign_magnitude":
        return y
    return y + torch.sum(x, dim=-1, keepdim=True, dtype=torch.float32) * operands["offset"]


# ---------------------------------------------------------------------------
# Fidelity probes
# ---------------------------------------------------------------------------

def output_mse(f, params_a, params_b, batch) -> torch.Tensor:
    """Mean squared error between model outputs under two parameter sets."""
    ya, yb = f(params_a, batch), f(params_b, batch)
    return torch.mean((ya - yb) ** 2)


def logit_kl(f, params_a, params_b, batch) -> torch.Tensor:
    """KL(softmax(f_a) || softmax(f_b)) averaged over positions."""
    la, lb = f(params_a, batch), f(params_b, batch)
    pa = torch.log_softmax(la, dim=-1)
    pb = torch.log_softmax(lb, dim=-1)
    return torch.mean(torch.sum(torch.exp(pa) * (pa - pb), dim=-1))


def top1_agreement(f, params_a, params_b, batch) -> torch.Tensor:
    """Fraction of positions where argmax predictions agree (accuracy proxy)."""
    la, lb = f(params_a, batch), f(params_b, batch)
    return torch.mean((torch.argmax(la, -1) == torch.argmax(lb, -1)).to(torch.float32))


def deploy_and_probe(
    f,
    params,
    batch,
    spec: CrossbarSpec = CrossbarSpec(),
    config: PlannerConfig = PlannerConfig(),
    *,
    device=None,
) -> tuple[DeploymentPlan, dict[str, float]]:
    """One call: plan the deployment (on ``device``: CUDA unless the caller
    asks for the CPU), swap the weights, measure fidelity."""
    plan = build_deployment(params, spec, config, device=device)
    params_hat = deploy_params(params, plan)
    probes = {
        "output_mse": float(output_mse(f, params, params_hat, batch)),
        "logit_kl": float(logit_kl(f, params, params_hat, batch)),
        "top1_agreement": float(top1_agreement(f, params, params_hat, batch)),
    }
    return plan, probes
