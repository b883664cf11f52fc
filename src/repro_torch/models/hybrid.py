"""Hymba-style hybrid block: parallel attention + Mamba heads in one layer
(port of ``repro.models.hybrid``).

Both branches read the same pre-normed input; their outputs are per-branch
RMS-normalized and averaged (the Hymba fusion rule), then a gated MLP
follows.  Two block kinds share the parameters' structure:

  * ``hymba_swa``    — sliding-window attention; its decode cache is a ring
    of ``cfg.attn_window`` entries, slot ``pos % window`` holding position
    ``pos``;
  * ``hymba_global`` — full causal attention over a full-length cache.

Prefill attention is ``attention()`` (kernel B3 on the card, with the
window for ``hymba_swa``); decode attention is ``decode_attention`` over
the ring's valid slots.  The decode step writes K/V and the SSM state in
place at a device position (a 0-d or (B,) tensor; the ring slot and valid
length are computed on the device), so a CUDA graph captures it.  Meta
tokens are prepended by the LM assembly (``models/transformer.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers, ssm
from repro_torch.models.attention import attention, decode_attention
from repro_torch.models.blocks import _position_index, _qkv, _write_rows, init_attention
from repro_torch.models.layers import Params


def init_hymba_block(key: torch.Tensor, cfg: ArchConfig) -> Params:
    """One block's params from ``key``; keys ``[L, 2]`` give the segment's
    ``[L, ...]`` stack, as the reference's vmap over per-layer keys does."""
    k1, k2, k3 = prng.split(key, 3).unbind(-2)
    lead = tuple(key.shape[:-1])
    dev = key.device
    return {
        "ln1": layers.init_norm(cfg.d_model, dev, lead),
        "attn": init_attention(k1, cfg),
        "mamba": ssm.init_mamba(k2, cfg),
        "norm_attn": layers.init_norm(cfg.d_model, dev, lead),
        "norm_ssm": layers.init_norm(cfg.d_model, dev, lead),
        "ln2": layers.init_norm(cfg.d_model, dev, lead),
        "mlp": layers.init_glu_mlp(k3, cfg.d_model, cfg.d_ff),
    }


def _fuse(p: Params, attn_out: torch.Tensor, ssm_out: torch.Tensor) -> torch.Tensor:
    return 0.5 * (layers.rmsnorm(p["norm_attn"], attn_out) + layers.rmsnorm(p["norm_ssm"], ssm_out))


def _finish(p: Params, cfg: ArchConfig, x, attn_out, ssm_out) -> torch.Tensor:
    x = x + _fuse(p, attn_out, ssm_out)
    return x + layers.glu_mlp(p["mlp"], layers.rmsnorm(p["ln2"], x), cfg.act, x.dtype)


def hymba_block_fwd(p: Params, cfg: ArchConfig, x: torch.Tensor, *, kind: str = "swa",
                    window: int | None = None, return_cache: bool = False,
                    train: bool = False):
    """Prefill / training over the whole of ``x`` (positions from 0).  The
    ``swa`` kind's cache keeps the trailing window as a ring aligned so that
    slot ``pos % window`` holds position ``pos`` (zero-padded when the
    sequence is shorter than the window)."""
    b, s, _ = x.shape
    xn = layers.rmsnorm(p["ln1"], x)
    q, k, v = _qkv(p["attn"], cfg, xn, torch.arange(s, device=x.device))
    a = attention(q, k, v, kind=kind, window=window, train=train)
    a = layers.linear(p["attn"]["wo"], a.transpose(1, 2).reshape(b, s, -1), x.dtype)
    ssm_out, ssm_cache = ssm.mamba_fwd(p["mamba"], cfg, xn, return_cache=return_cache)
    x = _finish(p, cfg, x, a, ssm_out)
    cache = None
    if return_cache:
        if kind == "swa":
            w = int(window)
            if s >= w:
                roll = s % w
                k = torch.roll(k[:, :, -w:], roll, dims=2)
                v = torch.roll(v[:, :, -w:], roll, dims=2)
            else:
                k = F.pad(k, (0, 0, 0, w - s))
                v = F.pad(v, (0, 0, 0, w - s))
        cache = {"k": k, "v": v, "ssm": ssm_cache}
    return x, cache


def hymba_block_step(p: Params, cfg: ArchConfig, x: torch.Tensor, cache: dict,
                     pos: int | torch.Tensor, *, window: int | None = None) -> torch.Tensor:
    """One token at ``pos`` (a Python int, a 0-d or a (B,) int tensor): with
    a ``window`` (the ``swa`` kind, whose cache is a ring of that length) it
    writes K/V at ring slot ``pos % window`` and attends to ``min(pos + 1,
    window)`` slots; without one (the global kind) it writes at ``pos`` and
    attends to ``pos + 1``.  K/V, the SSM state and the conv tail are
    written in place."""
    b = x.shape[0]
    xn = layers.rmsnorm(p["ln1"], x)
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        pos = pos.to(device=x.device, dtype=torch.int64)
        q, k, v = _qkv(p["attn"], cfg, xn, pos[:, None])
        slot = pos % window if window else pos
        _write_rows(cache["k"], k, slot)
        _write_rows(cache["v"], v, slot)
    else:
        pos = _position_index(pos, x.device)
        q, k, v = _qkv(p["attn"], cfg, xn, pos)
        slot = pos % window if window else pos
        cache["k"].index_copy_(2, slot, k.to(cache["k"].dtype))
        cache["v"].index_copy_(2, slot, v.to(cache["v"].dtype))
    valid = torch.clamp(pos + 1, max=window) if window else pos + 1
    a = decode_attention(q, cache["k"], cache["v"], valid)
    a = layers.linear(p["attn"]["wo"], a.transpose(1, 2).reshape(b, 1, -1), x.dtype)
    ssm_out = ssm.mamba_step(p["mamba"], cfg, xn, cache["ssm"])
    return _finish(p, cfg, x, a, ssm_out)


def init_hymba_cache(cfg: ArchConfig, batch: int, seq_len: int, dtype, device,
                     lead: tuple[int, ...] = (), *, kind: str) -> dict:
    """Zero cache of one layer (``lead`` stacks it): k/v (*lead, B, Hkv, L,
    hd) with L = ``cfg.attn_window`` for ``hymba_swa`` (the prefill emits
    exactly this shape, so the merge copies it whole) and ``seq_len`` for
    ``hymba_global``, and the Mamba state."""
    length = cfg.attn_window if kind == "hymba_swa" else seq_len
    shape = lead + (batch, cfg.n_kv_heads, length, cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "ssm": ssm.init_mamba_cache(cfg, batch, dtype, device, lead),
    }
