"""Mamba-style selective SSM, Hymba's SSM heads (port of the Mamba half of
``repro.models.ssm``).

Training and prefill run the selective scan chunked over time
(:func:`_mamba_scan_chunked`); the decode step is one recurrent update of
the state ``{"state": (B, d_inner, N) f32, "conv": (B, W - 1, d_inner)}``,
written in place (the decode graph holds the cache by address).  Every
function reads no value on the host.  The mLSTM / sLSTM half of the
reference's module waits for xlstm (ROADMAP A.16.3).

``in_proj``, ``x_proj``, ``dt_proj`` and ``out_proj`` go through
``layers.linear`` (the CIM kernels for operand dicts); ``conv``, ``a_log``,
``dt_bias`` and ``d_skip`` are read elementwise, so they stay dense under
every materialization (``planner.MATERIALIZE_DENSE_ONLY``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers
from repro_torch.models.layers import Params


# ---------------------------------------------------------------------------
# Depthwise causal conv
# ---------------------------------------------------------------------------

def init_conv(key: torch.Tensor, channels: int, width: int) -> Params:
    """Taps (W, C) from ``key`` (keys ``[L, 2]`` give ``[L, W, C]``), the
    reference's draw bit for bit."""
    return {"w": prng.normal(key, (width, channels)) * layers._f32(width**-0.5, key.device)}


def causal_conv(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C) -> (B, S, C), depthwise causal conv of width W."""
    w = p["w"].to(x.dtype)  # (W, C)
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = xp[:, 0:s] * w[0]
    for i in range(1, width):
        out = out + xp[:, i:i + s] * w[i]
    return out


def causal_conv_step(p: Params, state: torch.Tensor, x1: torch.Tensor):
    """state: (B, W-1, C) trailing inputs; x1: (B, 1, C) -> (new_state, y1)."""
    w = p["w"].to(x1.dtype)
    window = torch.cat([state, x1], dim=1)  # (B, W, C)
    y = torch.einsum("bwc,wc->bc", window, w)[:, None, :]
    return window[:, 1:], y


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

def _linspace(start: float, stop: float, num: int, device) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` in float32 as XLA:CPU computes it:
    ``start * (1 - i * r) + i * (stop * r)`` with ``r = 1 / (num - 1)`` and
    both sums fused (``prng._fma``), then ``stop`` appended."""
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
    a, b = f(start), f(stop)
    if num == 1:
        return a[None]
    div = num - 1
    r = f(1.0) / f(float(div))
    i = torch.arange(div, dtype=torch.float32, device=device)
    sub = prng._fma(-i, r.expand(div), f(1.0).expand(div))
    return torch.cat([prng._fma(i, (b * r).expand(div), a * sub), b[None]])


def mamba_constants(cfg: ArchConfig, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The deterministic leaves of one layer, the reference's bytes:
    ``dt_bias = log(exp(linspace(1e-3, 1e-1, di)) - 1)`` (di,) and ``a_log
    = log(1..N)`` (di, N), through XLA:CPU's float32 ``exp`` / ``log``."""
    s = cfg.ssm
    if s is None:
        raise ValueError(f"{cfg.name} has no SSM config")
    di, n = s.expand * cfg.d_model, s.state_size
    dt_bias = prng._log(prng.xla_exp(_linspace(1e-3, 1e-1, di, device))
                        - layers._f32(1.0, device))
    a_log = prng._log(torch.arange(1, n + 1, dtype=torch.float32, device=device).expand(di, n))
    return dt_bias, a_log


def init_mamba(key: torch.Tensor, cfg: ArchConfig) -> Params:
    """The Mamba projections from ``key`` (keys ``[L, 2]`` give ``[L, ...]``
    stacks) and its deterministic leaves (:func:`mamba_constants`)."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    n = s.state_size
    dt_rank = max(1, d // 16)
    ks = prng.split(key, 6).unbind(-2)
    lead = tuple(key.shape[:-1])
    dev = key.device
    dt_bias, a_log = mamba_constants(cfg, dev)
    return {
        "in_proj": layers._dense_init(ks[0], d, 2 * di),
        "conv": init_conv(ks[1], di, s.conv_width),
        "x_proj": layers._dense_init(ks[2], di, dt_rank + 2 * n),
        "dt_proj": layers._dense_init(ks[3], dt_rank, di),
        "dt_bias": dt_bias.expand(lead + (di,)).contiguous(),
        "a_log": a_log.expand(lead + (di, n)).contiguous(),
        "d_skip": torch.ones(lead + (di,), dtype=torch.float32, device=dev),
        "out_proj": layers._dense_init(ks[4], di, d),
    }


def _mamba_scan_chunked(a_bar: torch.Tensor, bx: torch.Tensor, state: torch.Tensor,
                        chunk: int):
    """h_t = a_bar_t * h_{t-1} + bx_t, chunked as the reference chunks it.

    a_bar, bx: (B, S, di, N) f32; state: (B, di, N).  Returns (hs (B, S,
    di, N), final state).  The tail is padded with identity steps (a = 1,
    b = 0).  Within a chunk the reference's associative scan is taken in
    order (the same products and sums, associated left to right): one pass
    over the chunk's ``chunk`` positions for every chunk at once, then one
    over the chunks carrying the state — ``chunk + S / chunk`` vector steps,
    no host read.
    """
    b, s, di, n = a_bar.shape
    pad = (-s) % chunk
    if pad:
        a_bar = F.pad(a_bar, (0, 0, 0, 0, 0, pad), value=1.0)
        bx = F.pad(bx, (0, 0, 0, 0, 0, pad))
    nchunk = (s + pad) // chunk
    a = a_bar.reshape(b, nchunk, chunk, di, n)
    bb = bx.reshape(b, nchunk, chunk, di, n)
    a_acc, b_acc = [a[:, :, 0]], [bb[:, :, 0]]
    for t in range(1, chunk):  # differentiable: new tensors, no in-place writes
        a_acc.append(a_acc[-1] * a[:, :, t])
        b_acc.append(a[:, :, t] * b_acc[-1] + bb[:, :, t])
    a_acc, b_acc = torch.stack(a_acc, dim=2), torch.stack(b_acc, dim=2)
    hs, h = [], state
    for c in range(nchunk):
        hs.append(a_acc[:, c] * h[:, None] + b_acc[:, c])
        h = hs[-1][:, -1]
    return torch.stack(hs, dim=1).reshape(b, s + pad, di, n)[:, :s], h


def _dt_b_c(p: Params, cfg: ArchConfig, xc: torch.Tensor):
    """-> dt, B, C (f32) from the conv output ``xc`` (compute dtype)."""
    n = cfg.ssm.state_size
    dtype = xc.dtype
    proj = layers.linear(p["x_proj"], xc, dtype)
    dt_rank = proj.shape[-1] - 2 * n
    dt = F.softplus(layers.linear(p["dt_proj"], proj[..., :dt_rank], dtype)
                    + p["dt_bias"].to(dtype)).to(torch.float32)
    b_in = proj[..., dt_rank:dt_rank + n].to(torch.float32)
    c_out = proj[..., dt_rank + n:].to(torch.float32)
    return dt, b_in, c_out


def mamba_fwd(p: Params, cfg: ArchConfig, xn: torch.Tensor, *, return_cache: bool = False):
    """xn: (B, S, d) pre-normed input -> (y, {"state", "conv"} | None)."""
    s_cfg = cfg.ssm
    b, s, d = xn.shape
    di = s_cfg.expand * d
    n = s_cfg.state_size
    dtype = xn.dtype

    u = layers.linear(p["in_proj"], xn, dtype)
    xc, z = u[..., :di], u[..., di:]
    conv_tail = xc[:, -(s_cfg.conv_width - 1):, :]
    xc = F.silu(causal_conv(p["conv"], xc))
    dt, b_in, c_out = _dt_b_c(p, cfg, xc)  # (B, S, di), (B, S, N), (B, S, N)

    a = -torch.exp(p["a_log"])  # (di, N)
    a_bar = torch.exp(dt[..., None] * a)  # (B, S, di, N)
    bx = (dt * xc.to(torch.float32))[..., None] * b_in[:, :, None, :]
    state0 = torch.zeros((b, di, n), dtype=torch.float32, device=xn.device)
    hs, state = _mamba_scan_chunked(a_bar, bx, state0, s_cfg.chunk_size)
    del a_bar, bx
    y = torch.einsum("bsdn,bsn->bsd", hs, c_out) + p["d_skip"] * xc.to(torch.float32)
    y = layers.linear(p["out_proj"], y.to(dtype) * F.silu(z), dtype)
    cache = {"state": state, "conv": conv_tail.contiguous()} if return_cache else None
    return y, cache


def mamba_step(p: Params, cfg: ArchConfig, xn: torch.Tensor, cache: dict) -> torch.Tensor:
    """xn: (B, 1, d) -> y (B, 1, d); the state and the conv tail are
    updated in place."""
    s_cfg = cfg.ssm
    di = s_cfg.expand * xn.shape[-1]
    dtype = xn.dtype

    u = layers.linear(p["in_proj"], xn, dtype)
    xc, z = u[..., :di], u[..., di:]
    conv_state, xc1 = causal_conv_step(p["conv"], cache["conv"], xc)
    xc1 = F.silu(xc1)  # (B, 1, di)
    dt, b_in, c_out = _dt_b_c(p, cfg, xc1)
    dt, b_in, c_out = dt[:, 0], b_in[:, 0], c_out[:, 0]  # (B, di), (B, N), (B, N)

    a = -torch.exp(p["a_log"])
    a_bar = torch.exp(dt[..., None] * a)  # (B, di, N)
    x32 = xc1[:, 0].to(torch.float32)
    bx = (dt * x32)[..., None] * b_in[:, None, :]
    state = a_bar * cache["state"] + bx
    y = torch.einsum("bdn,bn->bd", state, c_out) + p["d_skip"] * x32
    cache["state"].copy_(state)
    cache["conv"].copy_(conv_state)
    return layers.linear(p["out_proj"], y[:, None].to(dtype) * F.silu(z), dtype)


def init_mamba_cache(cfg: ArchConfig, batch: int, dtype, device,
                     lead: tuple[int, ...] = ()) -> dict[str, torch.Tensor]:
    """Zero state (*lead, B, d_inner, N) f32 and conv tail (*lead, B, W-1,
    d_inner) in ``dtype``."""
    s = cfg.ssm
    di = s.expand * cfg.d_model
    return {
        "state": torch.zeros(lead + (batch, di, s.state_size), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros(lead + (batch, s.conv_width - 1, di), dtype=dtype, device=device),
    }
