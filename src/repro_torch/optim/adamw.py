"""AdamW with global-norm clipping and a cosine schedule (port of ``repro.optim.adamw``).

Optimizer state mirrors the param tree (same shapes, float32).  The
reference's numerical choices are kept: weight decay on every leaf with
``ndim >= 2`` (the stacked norm gains ``(layers, d)`` are decayed too), the
bias corrections as float32 powers ``b**count``, every schedule constant
rounded to float32, and ``global_norm`` summing the leaves in jax's flatten
order (sorted dict keys).  The update is functional: new params and state,
the inputs untouched.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch import tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _f32(value: float, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_frac``; float32 scalar."""
    dev = step.device
    c = lambda v: _f32(v, dev)  # noqa: E731
    step = step.to(torch.float32)
    warm = torch.minimum(step / c(max(cfg.warmup_steps, 1)), c(1.0))
    t = torch.clamp((step - c(cfg.warmup_steps)) / c(max(cfg.total_steps - cfg.warmup_steps, 1)),
                    0.0, 1.0)
    cos = c(cfg.min_lr_frac) + c((1 - cfg.min_lr_frac) * 0.5) * (c(1.0) + torch.cos(c(math.pi) * t))
    return c(cfg.lr) * warm * cos


def adamw_init(params: Any) -> dict[str, Any]:
    zeros = lambda: tree.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)  # noqa: E731
    dev = tree.leaves(params)[0].device
    return {"m": zeros(), "v": zeros(), "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(t: Any) -> torch.Tensor:
    """sqrt of the sum of squares, leaf sums added in jax's leaf order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))) for x in tree.leaves(t)))


@torch.no_grad()
def adamw_update(
    grads: Any, state: dict[str, Any], params: Any, cfg: AdamWConfig
) -> tuple[Any, dict[str, Any], dict[str, torch.Tensor]]:
    count = state["count"] + 1
    dev = count.device
    c = lambda v: _f32(v, dev)  # noqa: E731
    lr = cosine_lr(cfg, count)

    gnorm = global_norm(grads)
    scale = torch.minimum(c(1.0), c(cfg.clip_norm) / torch.maximum(gnorm, c(1e-9)))
    grads = tree.tree_map(lambda g: g.to(torch.float32) * scale, grads)

    b1, b2 = c(cfg.b1), c(cfg.b2)
    m = tree.tree_map(lambda mm, g: b1 * mm + c(1 - cfg.b1) * g, state["m"], grads)
    v = tree.tree_map(lambda vv, g: b2 * vv + c(1 - cfg.b2) * g * g, state["v"], grads)
    cf = count.to(torch.float32)
    bc1 = c(1.0) - torch.pow(b1, cf)
    bc2 = c(1.0) - torch.pow(b2, cf)

    def upd(p, mm, vv):
        step = (mm / bc1) / (torch.sqrt(vv / bc2) + c(cfg.eps))
        p32 = p.to(torch.float32)
        if p.ndim >= 2:
            step = step + c(cfg.weight_decay) * p32
        return (p32 - lr * step).to(p.dtype)

    new_params = tree.tree_map(upd, params, m, v)
    metrics = {"lr": lr, "grad_norm": gnorm}
    return new_params, {"m": m, "v": v, "count": count}, metrics
