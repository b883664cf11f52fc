"""Attention for prefill and decode (port of ``repro.models.attention``).

Plain PyTorch: the reference computes attention in pure JAX (no Pallas
kernel is on the serving path).  The causal mask and the -1e30 fill are the
reference's; its bidirectional and sliding-window masks come with the model
families that use them.  GQA/MQA groups queries (B, Hkv, G, S, D) instead of
repeating KV.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def blockwise_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    block_k: int = 1024,
) -> torch.Tensor:
    """Causal online-softmax attention over key blocks of ``block_k``.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D); q holds positions [0, Sq).
    Returns (B, Hq, Sq, Dv) in q's dtype.
    """
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    dv = v.shape[-1]
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
    q_pos = torch.arange(sq, device=dev)

    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, sq, dv), dtype=torch.float32, device=dev)
    for kj in range(nk):
        kb = k[:, :, kj * block_k:(kj + 1) * block_k].to(torch.float32)
        vb = v[:, :, kj * block_k:(kj + 1) * block_k].to(torch.float32)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kb) * scale
        k_pos = kj * block_k + torch.arange(block_k, device=dev)
        mask = (k_pos[None, :] <= q_pos[:, None]) & (k_pos < sk)[None, :]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.max(dim=-1).values)
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, hq, sq, dv).to(q.dtype)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    valid_len: int,
) -> torch.Tensor:
    """Single-step attention against a partially filled KV cache.

    q: (B, Hq, 1, D); caches: (B, Hkv, S, D); ``valid_len`` cache positions
    are valid (the new token's KV already written).
    """
    b, hq, _, d = q.shape
    _, hkv, s, _ = k_cache.shape
    g = hq // hkv
    qg = q.reshape(b, hkv, g, 1, d).to(torch.float32)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg, k_cache.to(torch.float32)) * d**-0.5
    pos = torch.arange(s, device=q.device)
    scores = torch.where(pos < valid_len, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v_cache.to(torch.float32))
    return out.reshape(b, hq, 1, d).to(q.dtype)
