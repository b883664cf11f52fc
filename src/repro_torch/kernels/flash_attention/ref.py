"""Plain PyTorch version of the flash-attention kernel (B3).

Contract (shared with ``ops.py`` and ``csrc/flash_attention.cu``; the port
of ``repro.kernels.flash_attention.ref``):
  q: f32/bf16 [B, Hq, Sq, D]; k, v: [B, Hkv, Sk, D] with Hq % Hkv == 0
  kind: "causal" | "bidir" | "swa" (causal sliding window of ``window``)
  q_offset: absolute position of q[0]; a scalar shared by the batch, or
    (B,) per-row
  kv_valid_len: optional scalar or (B,) per-row; key positions >= it are
    masked

  out[b,h,i] = sum_j softmax_j(q_i . k_j / sqrt(D) + mask) v_j   (q's dtype)

Scores are materialised and masked with -inf (a row that sees no key is
NaN, as in the reference).  ``flash_attention.calls`` counts calls, so a run
can show that its kernel, not this, served it.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


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
    flash_attention.calls += 1
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    g = hq // hkv
    dev = q.device
    qg = q.reshape(b, hkv, g, sq, d)
    scores = torch.einsum(
        "bhgqd,bhkd->bhgqk", qg.to(torch.float32), k.to(torch.float32)
    ) * (d**-0.5)
    # (B, Sq, Sk) masks when offsets/extents are per-row; (Sq, Sk) otherwise
    off = torch.as_tensor(q_offset, device=dev)
    qp = (off[:, None, None] + torch.arange(sq, device=dev)[None, :, None]) if off.ndim else (
        off + torch.arange(sq, device=dev)[:, None]
    )
    kp = torch.arange(sk, device=dev)
    if kind == "bidir":
        mask = torch.ones_like(qp + kp, dtype=torch.bool)
    elif kind in ("causal", "swa"):
        mask = kp <= qp
        if kind == "swa":
            if window is None:
                raise ValueError("kind='swa' needs a window")
            mask = mask & (kp > qp - window)
    else:
        raise ValueError(f"unknown attention kind {kind!r}")
    if kv_valid_len is not None:
        vl = torch.as_tensor(kv_valid_len, device=dev)
        vl = vl[:, None, None] if vl.ndim else vl
        mask = mask & (kp < vl)
    if mask.ndim == 2:
        mask = mask[None]
    scores = torch.where(mask[:, None, None], scores, -torch.inf)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(torch.float32))
    return out.reshape(b, hq, sq, d).to(q.dtype)


flash_attention.calls = 0

TOL = 2e-5  # the reference's own kernel tolerance (both sum f32 in another order)


def attention_bound(want: torch.Tensor) -> torch.Tensor:
    """Allowed |kernel - plain| of B3 per element of the plain output
    ``want``: 2e-5 absolute + relative, and in bf16 one bf16 ulp of the
    output more (both round an f32 result to bf16)."""
    w = want.float().abs()
    bound = TOL + TOL * w
    if want.dtype == torch.bfloat16:
        ulp = torch.finfo(torch.bfloat16).eps * torch.exp2(torch.floor(torch.log2(
            w.clamp_min(torch.finfo(torch.float32).tiny))))
        bound = bound + ulp
    return bound
