"""Encoder-decoder LM (port of ``repro.models.encdec``; SeamlessM4T-style
backbone, audio frontend stubbed).

The encoder takes precomputed frame embeddings (B, S_src, d_model), the
modality frontend stub, through ``src_proj`` and bidirectional attention
blocks (``attn_block_fwd(kind="bidir")``: kernel B3 on the card).  The
decoder is a causal LM (its self-attention B3 on the card too) with
cross-attention into the encoder output in every layer.  The prefill's
cross-attention calls ``blockwise_attention(kind="bidir")`` on every
device, as the reference's ``_cross_attend`` does.

The decode cache holds the self-attention K/V, written in place by each
step, and the cross-attention K/V, projected once from the encoder output
by the prefill and only read after it: {"self": {"k", "v": (L, B, Hkv, S,
hd)}, "cross_k", "cross_v": (L, B, Hkv, S_src, hd)}.  ``decode_step``
returns the cache it was given (a decode graph holds it by address).
Params stack the encoder's and the decoder's layers on a leading axis,
walked one layer at a time, as ``models.transformer`` walks a segment.
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels._util import resolve_device
from repro_torch.models import blocks, layers
from repro_torch.models.attention import blockwise_attention, decode_attention
from repro_torch.models.layers import Params
from repro_torch.models.transformer import (
    REMATS,
    _logits,
    _remat_layer,
    _stack_caches,
    compute_dtype,
    layer_slice,
)


# ---------------------------------------------------------------------------
# Decoder block: causal self-attn + cross-attn + MLP
# ---------------------------------------------------------------------------

def init_dec_block(key: torch.Tensor, cfg: ArchConfig) -> Params:
    """One decoder block's params from ``key``; keys ``[L, 2]`` give the
    ``[L, ...]`` stack, as the reference's vmap over per-layer keys does."""
    k1, k2, k3 = prng.split(key, 3).unbind(-2)
    lead = tuple(key.shape[:-1])
    return {
        "ln1": layers.init_norm(cfg.d_model, key.device, lead),
        "self": blocks.init_attention(k1, cfg),
        "ln_x": layers.init_norm(cfg.d_model, key.device, lead),
        "cross": blocks.init_attention(k2, cfg),
        "ln2": layers.init_norm(cfg.d_model, key.device, lead),
        "mlp": layers.init_glu_mlp(k3, cfg.d_model, cfg.d_ff),
    }


def _heads(t: torch.Tensor, n_heads: int, hd: int) -> torch.Tensor:
    """(B, S, n_heads * hd) -> (B, n_heads, S, hd)."""
    b, s, _ = t.shape
    return t.reshape(b, s, n_heads, hd).transpose(1, 2)


def _cross_kv(p: Params, cfg: ArchConfig, enc_out: torch.Tensor):
    hd, dtype = cfg.resolved_head_dim, enc_out.dtype
    k = _heads(layers.linear(p["wk"], enc_out, dtype), cfg.n_kv_heads, hd)
    v = _heads(layers.linear(p["wv"], enc_out, dtype), cfg.n_kv_heads, hd)
    return k, v


def _cross_attend(p: Params, cfg: ArchConfig, x: torch.Tensor, k, v) -> torch.Tensor:
    b, s, _ = x.shape
    q = _heads(layers.linear(p["wq"], x, x.dtype), cfg.n_heads, cfg.resolved_head_dim)
    out = blockwise_attention(q, k, v, kind="bidir")
    return layers.linear(p["wo"], out.transpose(1, 2).reshape(b, s, -1), x.dtype)


def _self_attn_fwd(p: Params, cfg: ArchConfig, x, *, return_cache: bool, train: bool):
    return blocks.attention_fwd(p["self"], cfg, layers.rmsnorm(p["ln1"], x), kind="causal",
                                return_cache=return_cache, train=train)


def dec_block_fwd(p: Params, cfg: ArchConfig, x, enc_out, *, return_cache: bool = False,
                  train: bool = False):
    """-> (x, {"self": {"k", "v"}, "cross_k", "cross_v"} or None)."""
    a, cache = _self_attn_fwd(p, cfg, x, return_cache=return_cache, train=train)
    x = x + a
    ck, cv = _cross_kv(p["cross"], cfg, enc_out)
    x = x + _cross_attend(p["cross"], cfg, layers.rmsnorm(p["ln_x"], x), ck, cv)
    x = x + layers.glu_mlp(p["mlp"], layers.rmsnorm(p["ln2"], x), cfg.act, x.dtype)
    if return_cache:
        cache = {"self": cache, "cross_k": ck, "cross_v": cv}
    return x, cache


def dec_block_step(p: Params, cfg: ArchConfig, x, cache, pos) -> torch.Tensor:
    """One token: the self-attention K/V written into ``cache["self"]`` in
    place at ``pos``; the cross K/V read over the whole source."""
    x = x + blocks.attention_step(p["self"], cfg, layers.rmsnorm(p["ln1"], x), cache["self"],
                                  pos)
    xq = layers.rmsnorm(p["ln_x"], x)
    b = x.shape[0]
    q = _heads(layers.linear(p["cross"]["wq"], xq, x.dtype), cfg.n_heads,
               cfg.resolved_head_dim)
    out = decode_attention(q, cache["cross_k"], cache["cross_v"], cache["cross_k"].shape[2])
    x = x + layers.linear(p["cross"]["wo"], out.transpose(1, 2).reshape(b, 1, -1), x.dtype)
    return x + layers.glu_mlp(p["mlp"], layers.rmsnorm(p["ln2"], x), cfg.act, x.dtype)


# ---------------------------------------------------------------------------
# Model assembly
# ---------------------------------------------------------------------------

def init(key: torch.Tensor, cfg: ArchConfig, *, device=None) -> Params:
    """f32 master params from a ``prng`` key, the reference's ``init(key,
    cfg)`` bit for bit, on CUDA unless ``device="cpu"`` is asked for."""
    key = key.to(resolve_device(device))
    ks = prng.split(key, 6)
    enc_keys = prng.split(ks[0], cfg.n_enc_layers)
    dec_keys = prng.split(ks[1], cfg.n_layers)
    return {
        "src_proj": layers.init_dense(ks[2], cfg.d_model, cfg.d_model),
        "embed": layers.init_embedding(ks[3], cfg.vocab_size, cfg.d_model),
        "encoder": blocks.init_attn_block(enc_keys, cfg),
        "enc_norm": layers.init_norm(cfg.d_model, key.device),
        "decoder": init_dec_block(dec_keys, cfg),
        "final_norm": layers.init_norm(cfg.d_model, key.device),
        "head": layers.init_dense(ks[4], cfg.d_model, cfg.vocab_size),
    }


def encode(params: Params, cfg: ArchConfig, src_embeds: torch.Tensor, *,
           train: bool = False) -> torch.Tensor:
    dtype = compute_dtype(cfg)
    x = layers.dense(params["src_proj"], src_embeds.to(dtype), dtype)
    for i in range(cfg.n_enc_layers):
        x, _ = blocks.attn_block_fwd(layer_slice(params["encoder"], i), cfg, x, kind="bidir",
                                     train=train)
    return layers.rmsnorm(params["enc_norm"], x)


def forward(params: Params, cfg: ArchConfig, batch: dict, *, remat: str = "none",
            train: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """batch: {"src_embeds": (B, Ss, d), "tokens": (B, St)} -> (logits (B,
    St, V) f32, aux 0).  ``train=True`` runs the self-attention through
    ``blockwise_attention`` (the differentiable path); ``remat`` checkpoints
    each decoder layer, as the reference does."""
    if remat not in REMATS:
        raise ValueError(f"unknown remat policy {remat!r}")
    enc_out = encode(params, cfg, batch["src_embeds"], train=train)
    x = layers.embed(params["embed"], batch["tokens"], compute_dtype(cfg))

    def layer(p_layer, xc):
        return dec_block_fwd(p_layer, cfg, xc, enc_out, train=train)[0]

    layer = _remat_layer(layer, remat)
    for i in range(cfg.n_layers):
        x = layer(layer_slice(params["decoder"], i), x)
    return _logits(params, cfg, x), torch.zeros((), dtype=torch.float32, device=x.device)


def prefill(params: Params, cfg: ArchConfig, batch: dict) -> tuple[torch.Tensor, dict]:
    """Returns (last-position logits (B, 1, V), the prompt cache: the
    decoder's self K/V over the prompt and its cross K/V over the source)."""
    enc_out = encode(params, cfg, batch["src_embeds"])
    x = layers.embed(params["embed"], batch["tokens"], compute_dtype(cfg))
    caches = []
    for i in range(cfg.n_layers):
        x, cache = dec_block_fwd(layer_slice(params["decoder"], i), cfg, x, enc_out,
                                 return_cache=True)
        caches.append(cache)
    return _logits(params, cfg, x[:, -1:]), _stack_caches(caches)


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, src_len: int, dtype=None, *,
               device=None) -> dict:
    """Zero decode cache: self K/V over ``seq_len`` positions, cross K/V over
    ``src_len`` source frames (CUDA unless ``device="cpu"``)."""
    device = resolve_device(device)
    dtype = compute_dtype(cfg) if dtype is None else dtype
    hd, lead = cfg.resolved_head_dim, (cfg.n_layers, batch, cfg.n_kv_heads)

    def zeros(s):
        return torch.zeros(lead + (s, hd), dtype=dtype, device=device)

    return {"self": {"k": zeros(seq_len), "v": zeros(seq_len)},
            "cross_k": zeros(src_len), "cross_v": zeros(src_len)}


def decode_step(params: Params, cfg: ArchConfig, caches: dict, token: torch.Tensor,
                pos: int | torch.Tensor) -> tuple[torch.Tensor, dict]:
    """token: (B, 1) int; pos: a Python int or a 0-d int tensor on the
    device.  Writes the self K/V in place and returns (logits (B, 1, V),
    caches)."""
    x = layers.embed(params["embed"], token, compute_dtype(cfg))
    for i in range(cfg.n_layers):
        x = dec_block_step(layer_slice(params["decoder"], i), cfg, x, layer_slice(caches, i),
                           pos)
    return _logits(params, cfg, x), caches
