"""Shared neural-net layers (port of ``repro.models.layers``).

Params are nested dicts of tensors, stored in float32 and cast at use to
the compute dtype the caller passes (cfg.dtype).  The dict layout is the
reference's, so the planner's '/'-joined names (``segments/0/mlp/wo``)
address the same tensors in both packages.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

Params = dict[str, Any]


def _dense_init(gen: torch.Generator, shape: tuple[int, ...], device, scale: float = 1.0) -> torch.Tensor:
    """Truncated-normal fan-in init ([-3, 3] sigma), fan-in = shape[-2]."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-3.0, b=3.0, generator=gen)
    return w * (scale / math.sqrt(shape[-2]))


def _cim_apply(w: dict, x: torch.Tensor) -> torch.Tensor:
    """Crossbar operand dict @ activations, any rank.

    Leading operand dims beyond the canonical 3-D planes (stacked layers)
    pair with the same leading dims of ``x``, one matmul per index (the
    reference vmaps them): every entry of the dict (planes, signs, scales,
    ``plane_ids``, ``plane_tile_nz``) is sliced on that axis.  The remaining
    dims of ``x`` flatten into M.
    """
    from repro_torch.core import simulator

    planes = w["splanes"] if "splanes" in w else w["planes_packed"]
    if planes.ndim > 3:
        return torch.stack(
            [_cim_apply({k: v[i] for k, v in w.items()}, x[i]) for i in range(x.shape[0])]
        )
    lead = x.shape[:-1]
    y = simulator.cim_linear(x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*lead, y.shape[-1])


def linear(w, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x @ w for a dense weight or a packed crossbar operand dict.

    The routing point for crossbar-native serving: operand dicts run
    through ``simulator.cim_linear`` (the CIM kernels on CUDA), dense
    weights take the ordinary matmul in ``dtype``.
    """
    if isinstance(w, dict):
        return _cim_apply(w, x).to(dtype)
    return x @ w.to(dtype)


def init_norm(dim: int, device, lead: tuple[int, ...] = ()) -> Params:
    return {"g": torch.ones(lead + (dim,), dtype=torch.float32, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["g"].to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, D) with D even; positions: broadcastable to (..., S)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP
# ---------------------------------------------------------------------------

def init_glu_mlp(gen, d_model: int, d_ff: int, device, lead: tuple[int, ...] = ()) -> Params:
    return {
        "wi_gate": _dense_init(gen, lead + (d_model, d_ff), device),
        "wi_up": _dense_init(gen, lead + (d_model, d_ff), device),
        "wo": _dense_init(gen, lead + (d_ff, d_model), device),
    }


def glu_mlp(p: Params, x: torch.Tensor, act: str, dtype: torch.dtype) -> torch.Tensor:
    if act != "geglu":
        raise NotImplementedError(
            f"MLP activation {act!r} is ported with the model-families slice (ROADMAP A16)"
        )
    gate = linear(p["wi_gate"], x, dtype)
    up = linear(p["wi_up"], x, dtype)
    h = F.gelu(gate, approximate="tanh") * up
    return linear(p["wo"], h, dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embedding(gen, vocab: int, d_model: int, device) -> Params:
    t = torch.randn((vocab, d_model), dtype=torch.float32, device=device, generator=gen)
    return {"table": t * 0.02}


def embed(p: Params, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    # gather then cast: the same values as the reference's cast-then-gather
    # without converting the whole table every step
    return p["table"][tokens].to(dtype)


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    # logits in f32 regardless of compute dtype
    return x.to(torch.float32) @ p["table"].to(torch.float32).T
