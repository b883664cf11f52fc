"""Attention for prefill and decode (port of ``repro.models.attention``).

``attention`` is the blocks' entry point, the counterpart of the
reference's dispatcher: on CUDA tensors it runs kernel B3
(``kernels/flash_attention``, the port of the Pallas flash-attention kernel
that implements this contract for the TPU); on CPU tensors it runs
``blockwise_attention``, the reference's default attention, in plain
PyTorch.  The training forward asks for ``train=True``, which runs
``blockwise_attention`` on every device: it is the function the reference
differentiates, and B3 has no backward (it raises under autograd).  ``decode_attention`` stays plain PyTorch on every device, as the
reference's decode does.

Mask kinds: "causal", "bidir", "swa" (sliding window, causal); masked
scores are filled with -1e30.  GQA/MQA groups queries (B, Hkv, G, S, D)
instead of repeating KV.

``banded_swa_attention`` is the reference's sliding-window variant that
scores only the live band, in plain PyTorch.  ``attention`` never routes
to it: B3 applies the window mask on the card, so the reference's
``set_attention_impl`` switch has no counterpart here.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels._util import use_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops

NEG_INF = -1e30


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    kind: str = "causal",
    window: Optional[int] = None,
    q_offset: Union[int, torch.Tensor] = 0,
    kv_valid_len: Union[int, torch.Tensor, None] = None,
    block_k: int = 1024,
    train: bool = False,
) -> torch.Tensor:
    """Attention entry point used by the blocks: kernel B3 on CUDA tensors,
    ``blockwise_attention`` on CPU tensors (same contract) and wherever
    ``train`` asks for the differentiable path.  ``q_offset`` and
    ``kv_valid_len`` may be (B,) device tensors (the engine's chunk step):
    B3 reads them per row on the card, nothing is read on the host."""
    if use_kernel(q) and not train:
        return fa_ops.flash_attention(q, k, v, kv_valid_len, kind=kind, window=window,
                                      q_offset=q_offset)
    return blockwise_attention(q, k, v, kind=kind, window=window, q_offset=q_offset,
                               block_k=block_k, kv_valid_len=kv_valid_len)


def _block_mask(
    q_pos: torch.Tensor, k_pos: torch.Tensor, kind: str, window: Optional[int]
) -> torch.Tensor:
    """(..., Sq, bk) boolean visibility mask from absolute positions;
    ``q_pos`` is (Sq,) or (B, Sq) for per-row offsets."""
    qp = q_pos[..., None]
    if kind == "bidir":
        return torch.ones(q_pos.shape + (k_pos.shape[0],), dtype=torch.bool, device=q_pos.device)
    if kind not in ("causal", "swa"):
        raise ValueError(f"unknown attention kind {kind!r}")
    mask = k_pos <= qp
    if kind == "swa":
        if window is None:
            raise ValueError("kind='swa' needs a window")
        mask = mask & (k_pos > qp - window)
    return mask


def banded_swa_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window: int,
    q_offset: int = 0,
    block_q: int = 512,
) -> torch.Tensor:
    """Sliding-window attention that only computes the live band.

    q is processed in blocks of ``block_q``; each block attends to a band of
    ``window + block_q`` keys, so FLOPs and bytes are O(S * (window +
    block_q)) instead of O(S^2).  Same contract as
    ``blockwise_attention(kind="swa")``: k/v hold positions [0, Sk); q holds
    positions [q_offset, q_offset + Sq).  q: (B, Hq, Sq, D); k, v: (B, Hkv,
    Sk, D).  The softmax is f32; the probabilities are rounded to v's dtype
    before the PV product, which sums in f32 (the reference's order).
    """
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    dv = v.shape[-1]
    g = hq // hkv
    scale = d**-0.5
    band = window + block_q
    dev = q.device

    nq = -(-sq // block_q)
    q_pad = nq * block_q - sq
    if q_pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, q_pad))
    # keys padded left by `window` (so the first band exists) and right so
    # the last band's slice is in bounds
    pad_r = max(0, q_offset + nq * block_q - sk)
    kp = torch.nn.functional.pad(k, (0, 0, window, pad_r))
    vp = torch.nn.functional.pad(v, (0, 0, window, pad_r))
    qg = q.reshape(b, hkv, g, nq * block_q, d)
    out = []
    for i in range(nq):
        q_lo = i * block_q
        qb = qg[:, :, :, q_lo:q_lo + block_q].to(torch.float32)
        lo = q_offset + q_lo  # padded coordinates of the band's first key
        kb = kp[:, :, lo:lo + band].to(torch.float32)
        vb = vp[:, :, lo:lo + band]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qb, kb) * scale
        q_pos = q_offset + q_lo + torch.arange(block_q, device=dev)[:, None]
        k_pos = q_offset + q_lo - window + torch.arange(band, device=dev)[None, :]
        mask = (k_pos <= q_pos) & (k_pos > q_pos - window) & (k_pos >= 0) & (k_pos < sk)
        s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1).to(v.dtype).to(torch.float32)
        out.append(torch.einsum("bhgqk,bhkd->bhgqd", p, vb.to(torch.float32)))
    o = torch.stack(out, dim=3).reshape(b, hkv, g, nq * block_q, dv)
    return o[:, :, :, :sq].reshape(b, hq, sq, dv).to(q.dtype)


def blockwise_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    kind: str = "causal",
    window: Optional[int] = None,
    q_offset: Union[int, torch.Tensor] = 0,
    block_k: int = 1024,
    kv_valid_len: Union[int, torch.Tensor, None] = None,
) -> torch.Tensor:
    """Online-softmax attention over key blocks of ``block_k``.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D) with Hq % Hkv == 0.
    ``q_offset``: absolute position of q[0], a scalar or a (B,) vector of
    per-row offsets.  ``kv_valid_len``: optional scalar or (B,) vector; key
    positions >= it are masked.  Returns (B, Hq, Sq, Dv) in q's dtype.
    """
    blockwise_attention.calls += 1
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    dv = v.shape[-1]  # v head dim may differ from qk head dim (MLA)
    g = hq // hkv
    if hq != hkv * g:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    scale = d**-0.5
    dev = q.device
    nk = -(-sk // block_k)
    pad = nk * block_k - sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    qg = q.reshape(b, hkv, g, sq, d).to(torch.float32)
    # (Sq,) shared positions, or (B, Sq) per-row
    off = torch.as_tensor(q_offset, device=dev)
    q_pos = (off[..., None] if off.ndim else off) + torch.arange(sq, device=dev)
    vl = None if kv_valid_len is None else torch.as_tensor(kv_valid_len, device=dev).reshape(-1, 1)

    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, sq, dv), dtype=torch.float32, device=dev)
    for kj in range(nk):
        kb = k[:, :, kj * block_k:(kj + 1) * block_k].to(torch.float32)
        vb = v[:, :, kj * block_k:(kj + 1) * block_k].to(torch.float32)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kb) * scale
        k_pos = kj * block_k + torch.arange(block_k, device=dev)
        mask = _block_mask(q_pos, k_pos, kind, window)  # (Sq, bk) or (B, Sq, bk)
        valid = k_pos < sk
        if vl is not None:
            valid = valid & (k_pos[None, :] < vl)  # (1|B, bk)
        mask = mask & valid[..., None, :]
        if mask.ndim == 2:
            mask = mask[None]
        s = torch.where(mask[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.max(dim=-1).values)
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, hq, sq, dv).to(q.dtype)


blockwise_attention.calls = 0


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    valid_len: Union[int, torch.Tensor],
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Single-step attention against a partially filled KV cache.

    q: (B, Hq, 1, D); caches: (B, Hkv, S, D); ``valid_len`` cache positions
    are valid (the new token's KV already written): a scalar, or a (B,)
    vector of per-row lengths.  ``window`` keeps only the last ``window``
    valid positions (sliding-window layers).
    """
    b, hq, _, d = q.shape
    _, hkv, s, _ = k_cache.shape
    g = hq // hkv
    qg = q.reshape(b, hkv, g, 1, d).to(torch.float32)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg, k_cache.to(torch.float32)) * d**-0.5
    pos = torch.arange(s, device=q.device)
    # a Python int stays on the host (no per-step copy to the card)
    vl = valid_len if isinstance(valid_len, int) else valid_len.to(q.device).reshape(-1, 1)
    mask = pos < vl  # (S,) or (B, S)
    if window is not None:
        mask = mask & (pos >= vl - window)
    scores = torch.where(mask.reshape(-1, 1, 1, 1, s), scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v_cache.to(torch.float32))
    return out.reshape(b, hq, 1, d).to(q.dtype)
