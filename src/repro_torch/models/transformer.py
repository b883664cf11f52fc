"""Decoder-only LM over the attention block (port of ``repro.models.transformer``).

``cfg.layer_kinds()`` groups consecutive identical kinds into segments; each
segment's params are stacked on a leading layer axis (the reference scans
over it), and the port walks that axis in a Python loop, handing each layer
its slice — dense tensors and packed operand dicts alike.  The port has
the ``attn`` kind only (the dense decoders).

Interface:
  init(cfg, seed=, device=)                        -> params (device: cuda default)
  forward(params, cfg, batch)                      -> (logits, aux)
  prefill(params, cfg, batch)                      -> (logits, cache)
  decode_step(params, cfg, cache, token, pos)      -> (logits, cache)
  init_cache(cfg, batch, seq_len, dtype=, device=) -> cache
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels._util import resolve_device
from repro_torch.models import blocks, layers
from repro_torch.models.layers import Params

KINDS = ("attn",)


def segments_of(cfg: ArchConfig) -> list[tuple[str, int]]:
    """Group layer kinds into maximal homogeneous runs."""
    runs: list[tuple[str, int]] = []
    for kind in cfg.layer_kinds():
        if kind not in KINDS:
            raise NotImplementedError(
                f"block kind {kind!r} is ported with the other model families (ROADMAP A.16)"
            )
        if runs and runs[-1][0] == kind:
            runs[-1] = (kind, runs[-1][1] + 1)
        else:
            runs.append((kind, 1))
    return runs


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def layer_slice(tree: Any, i: int) -> Any:
    """Layer ``i`` of a segment stack: index the leading axis of every leaf."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def init(cfg: ArchConfig, *, seed: int = 0, device=None) -> Params:
    """Random params from ``seed`` (f32 masters, the reference's layout), on
    CUDA unless ``device="cpu"`` is asked for."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params: Params = {"embed": layers.init_embedding(gen, cfg.vocab_size, cfg.d_model, device)}
    params["segments"] = [
        blocks.init_attn_block(gen, cfg, device, lead=(count,)) for _, count in segments_of(cfg)
    ]
    params["final_norm"] = layers.init_norm(cfg.d_model, device)
    if not cfg.tie_embeddings:
        params["head"] = {"w": layers._dense_init(gen, (cfg.d_model, cfg.vocab_size), device)}
    return params


def _embed_inputs(params: Params, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    dtype = compute_dtype(cfg)
    x = layers.embed(params["embed"], tokens, dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=dtype, device=x.device)
    return x


def _logits(params: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = layers.rmsnorm(params["final_norm"], x)
    if cfg.tie_embeddings:
        return layers.unembed(params["embed"], x)
    return layers.linear(params["head"]["w"], x.to(torch.float32), torch.float32)


def _run_segments(params: Params, cfg: ArchConfig, x: torch.Tensor, *, return_cache: bool):
    caches = []
    for (_, count), p_stack in zip(segments_of(cfg), params["segments"]):
        layer_caches = []
        for i in range(count):
            x, cache = blocks.attn_block_fwd(layer_slice(p_stack, i), cfg, x, return_cache=return_cache)
            layer_caches.append(cache)
        if return_cache:
            caches.append({k: torch.stack([c[k] for c in layer_caches]) for k in ("k", "v")})
    return x, caches if return_cache else None


def forward(params: Params, cfg: ArchConfig, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """batch: {"tokens": (B, S) int}.  Returns (logits (B, S, V) f32, aux 0)."""
    x = _embed_inputs(params, cfg, batch["tokens"])
    x, _ = _run_segments(params, cfg, x, return_cache=False)
    return _logits(params, cfg, x), torch.zeros((), device=x.device)


def prefill(params: Params, cfg: ArchConfig, batch: dict) -> tuple[torch.Tensor, list]:
    """Returns (last-position logits (B, 1, V), per-segment prompt caches
    {"k", "v": (count, B, Hkv, S, hd)})."""
    x = _embed_inputs(params, cfg, batch["tokens"])
    x, caches = _run_segments(params, cfg, x, return_cache=True)
    return _logits(params, cfg, x[:, -1:]), caches


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, dtype=None, *, device=None) -> list:
    """Zero decode cache, one stacked {"k", "v"} per segment (CUDA unless
    ``device="cpu"``)."""
    device = resolve_device(device)
    dtype = compute_dtype(cfg) if dtype is None else dtype
    return [
        blocks.init_attn_cache(cfg, batch, seq_len, dtype, device, lead=(count,))
        for _, count in segments_of(cfg)
    ]


def decode_step(
    params: Params, cfg: ArchConfig, caches: list, token: torch.Tensor, pos: int
) -> tuple[torch.Tensor, list]:
    """token: (B, 1) int; pos: absolute position.  Writes the caches in
    place and returns (logits (B, 1, V), caches)."""
    x = _embed_inputs(params, cfg, token)
    for (_, count), p_stack, c_stack in zip(segments_of(cfg), params["segments"], caches):
        for i in range(count):
            x = blocks.attn_block_step(
                layer_slice(p_stack, i), cfg, x, layer_slice(c_stack, i), pos
            )
    return _logits(params, cfg, x), caches
