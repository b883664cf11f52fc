"""Shared neural-net layers (port of ``repro.models.layers``).

Params are nested dicts of tensors, stored in float32 and cast at use to
the compute dtype the caller passes (cfg.dtype).  The dict layout is the
reference's, so the planner's '/'-joined names (``segments/0/mlp/wo``)
address the same tensors in both packages.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import prng

Params = dict[str, Any]


def _f32(value: float, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def _dense_init(key: torch.Tensor, in_dim: int, out_dim: int, scale: float = 1.0) -> torch.Tensor:
    """Truncated-normal fan-in init ([-3, 3] sigma) from ``key`` (keys
    ``[..., 2]`` give a ``[..., in, out]`` stack), the reference's draw bit
    for bit: the std is a Python float rounded to float32 once."""
    std = scale / (in_dim**0.5)
    w = prng.truncated_normal(key, -3.0, 3.0, (in_dim, out_dim))
    return w * _f32(std, key.device)


def init_dense(key: torch.Tensor, in_dim: int, out_dim: int, scale: float = 1.0) -> Params:
    return {"w": _dense_init(key, in_dim, out_dim, scale)}


def _cim_apply(w: dict, x: torch.Tensor) -> torch.Tensor:
    """Crossbar operand dict @ activations, any rank.

    Leading operand dims beyond the canonical 3-D planes pair with the same
    leading dims of ``x`` (the reference vmaps them).  ONE leading axis (a
    MoE layer's expert stack, x ``[E, ..., K]``) is one grouped kernel
    launch over it (``simulator.cim_linear`` on x ``[E, M, K]``); further
    leading axes are walked one index at a time, every entry of the dict
    (planes, signs, scales, ``plane_ids``, ``plane_tile_nz``) sliced on
    them.  The remaining dims of ``x`` flatten into M.
    """
    from repro_torch.core import simulator

    planes = w["splanes"] if "splanes" in w else w["planes_packed"]
    x = x.contiguous()  # the kernels read x row-major (a column slice is a strided view)
    if planes.ndim > 4:
        return torch.stack(
            [_cim_apply({k: v[i] for k, v in w.items()}, x[i]) for i in range(x.shape[0])]
        )
    if planes.ndim == 4:
        if x.shape[0] != planes.shape[0]:
            raise ValueError(f"x leads with {x.shape[0]}, the operands with {planes.shape[0]}")
        lead = x.shape[:-1]
        y = simulator.cim_linear(x.reshape(x.shape[0], -1, x.shape[-1]), w)
        return y.reshape(*lead, y.shape[-1])
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


def dense(p: Params, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return linear(p["w"], x, dtype)


def init_norm(dim: int, device, lead: tuple[int, ...] = ()) -> Params:
    """Unit gains (``lead`` stacks them per layer)."""
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

def init_glu_mlp(key: torch.Tensor, d_model: int, d_ff: int) -> Params:
    k1, k2, k3 = prng.split(key, 3).unbind(-2)
    return {
        "wi_gate": _dense_init(k1, d_model, d_ff),
        "wi_up": _dense_init(k2, d_model, d_ff),
        "wo": _dense_init(k3, d_ff, d_model),
    }


def glu_mlp(p: Params, x: torch.Tensor, act: str, dtype: torch.dtype) -> torch.Tensor:
    gate = linear(p["wi_gate"], x, dtype)
    up = linear(p["wi_up"], x, dtype)
    if act == "swiglu":
        h = F.silu(gate) * up
    elif act == "geglu":
        h = F.gelu(gate, approximate="tanh") * up
    else:
        raise ValueError(f"unknown act {act!r}")
    return linear(p["wo"], h, dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embedding(key: torch.Tensor, vocab: int, d_model: int) -> Params:
    return {"table": prng.normal(key, (vocab, d_model)) * _f32(0.02, key.device)}


def embed(p: Params, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    # gather then cast: the same values as the reference's cast-then-gather
    # without converting the whole table every step
    return p["table"][tokens].to(dtype)


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    # logits in f32 regardless of compute dtype
    return x.to(torch.float32) @ p["table"].to(torch.float32).T
