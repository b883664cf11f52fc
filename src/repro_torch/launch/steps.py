"""Serving step functions (port of the serving part of ``repro.launch.steps``).

``prepare_serving_params`` is the counterpart of the reference's backend
policy (``steps._serving_params``): on CUDA, packed operand dicts stay
packed and every prefill and decode step computes on them through the
packed matmul kernel; on the CPU they are densified once per deployment,
as the reference does off-TPU.

The reference's decode is one ``lax.scan`` over a donated cache; here it is
a Python loop whose steps write the cache in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import simulator
from repro_torch.models import api


def _params_device(params) -> torch.device:
    if isinstance(params, torch.Tensor):
        return params.device
    items = params.values() if isinstance(params, dict) else params
    for v in items:
        dev = _params_device(v)
        if dev is not None:
            return dev
    return None


def prepare_serving_params(params):
    """Once per deployment: CUDA keeps packed operands; CPU densifies them."""
    dev = _params_device(params)
    if dev is not None and dev.type == "cuda":
        return params
    return simulator.densify_packed(params)


def make_prefill_step(cfg: ArchConfig):
    def prefill_step(params, batch):
        return api.prefill(params, cfg, batch)

    return prefill_step


def greedy_pick(logits: torch.Tensor) -> torch.Tensor:
    """Next token from the last position: (B, S, V) -> (B, 1) (first max on ties)."""
    return torch.argmax(logits[:, -1:], dim=-1)


def make_decode_loop(cfg: ArchConfig, n_steps: int, *, greedy: bool = True):
    """Whole-generation greedy decode.

    Returns decode_loop(params, cache, tok0, prompt_len) -> (tokens (B,
    n_steps), cache); the cache is written in place.
    """
    if not greedy:
        raise NotImplementedError("sampled decode is queued (ROADMAP A.1); the port decodes greedily")

    def decode_loop(params, cache, tok0, prompt_len: int):
        tok, out = tok0, []
        for i in range(n_steps):
            logits, cache = api.decode_step(params, cfg, cache, tok, prompt_len + i)
            tok = greedy_pick(logits)
            out.append(tok)
        toks = torch.cat(out, dim=1) if out else tok0[:, :0]
        return toks, cache

    return decode_loop
