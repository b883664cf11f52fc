"""Recurrent sequence blocks: the xLSTM pair (mLSTM and sLSTM) and the
Mamba-style selective SSM of Hymba's SSM heads (port of
``repro.models.ssm``).  Their serving state is O(1) in sequence length.

  * mLSTM (:func:`mlstm_block_fwd`) — chunkwise-parallel linear attention
    with per-head sigmoid gates, in float32: within a chunk a dense
    (P, P) decay-masked attention, across chunks a (dh, dh) matrix state
    and a (dh,) normaliser carried by a Python loop over the chunks (the
    reference's ``lax.scan``; new tensors each chunk, no in-place write,
    so autograd differentiates it).
  * sLSTM (:func:`slstm_block_fwd`) — the exp-gated recurrence with its
    stabiliser ``m`` and per-head recurrent weights ``r``, a Python loop
    over time.
  * Mamba (:func:`mamba_fwd`) — the selective scan chunked over time
    (:func:`_mamba_scan_chunked`).

Each decode step is one recurrent update, written into the cache in place
(a decode graph holds the cache by address): mLSTM ``{"state" (B, H, dh,
dh) f32, "norm" (B, H, dh) f32, "conv" (B, W - 1, d_inner)}``, sLSTM ``{"h",
"c", "n", "m"}`` (B, H, dh) f32, Mamba ``{"state" (B, d_inner, N) f32,
"conv"}``.  The prefill's conv tail is always W - 1 inputs long, zeros
before the prompt when it is shorter (ROADMAP C.13), so the merged cache
decodes as ``forward`` does.  Every function reads no value on the host.

The projections go through ``layers.linear`` (the CIM kernels for operand
dicts); ``conv``, ``r``, ``a_log``, ``dt_bias`` and ``d_skip`` are read
elementwise or by an einsum, so they stay dense under every
materialization (``planner.MATERIALIZE_DENSE_ONLY``).
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


def conv_tail(x: torch.Tensor, width: int) -> torch.Tensor:
    """The decode's conv state after a prefill of ``x`` (B, S, C): its last
    W - 1 inputs, left-padded with zeros (what :func:`causal_conv` pads
    with) when S < W - 1.  The reference slices ``x[:, -(W-1):]``, shorter
    than W - 1 for such a prompt, and its merge then writes it first
    (ROADMAP C.13)."""
    tail = x[:, -(width - 1):]
    return F.pad(tail, (0, 0, width - 1 - tail.shape[1], 0)).contiguous()


# ---------------------------------------------------------------------------
# mLSTM (matrix-memory LSTM), chunkwise-parallel
# ---------------------------------------------------------------------------

def init_mlstm_block(key: torch.Tensor, cfg: ArchConfig) -> Params:
    """One block's params from ``key`` (keys ``[L, 2]`` give the segment's
    ``[L, ...]`` stack), the reference's draws bit for bit: ``split(key,
    8)``, seven used."""
    s = cfg.ssm
    di = s.expand * cfg.d_model
    ks = prng.split(key, 8).unbind(-2)
    return {
        "ln": layers.init_norm(cfg.d_model, key.device, tuple(key.shape[:-1])),
        "w_up": layers._dense_init(ks[0], cfg.d_model, 2 * di),
        "conv": init_conv(ks[1], di, s.conv_width),
        "wq": layers._dense_init(ks[2], di, di),
        "wk": layers._dense_init(ks[3], di, di),
        "wv": layers._dense_init(ks[4], di, di),
        "w_if": layers._dense_init(ks[5], cfg.d_model, 2 * cfg.n_heads),
        "w_down": layers._dense_init(ks[6], di, cfg.d_model),
    }


def _mlstm_chunk(q, k, v, li, lf, state, norm):
    """One chunk of the mLSTM recurrence, in float32.

    q, k, v: (B, P, H, dh); li / lf: (B, P, H) log input / forget gates
    (<= 0); state: (B, H, dh, dh) matrix memory; norm: (B, H, dh)
    normaliser.  Returns (y (B, P, H, dh), new state, new norm).
    """
    p = q.shape[1]
    q, k, v = q.to(torch.float32), k.to(torch.float32), v.to(torch.float32)
    cum = torch.cumsum(lf, dim=1)  # (B, P, H) inclusive log decay products
    # intra-chunk: D[t, j] = exp(cum_t - cum_j + li_j) for j <= t
    logd = cum[:, :, None, :] - cum[:, None, :, :] + li[:, None, :, :]  # (B, P, P, H)
    tri = torch.ones((p, p), dtype=torch.bool, device=q.device).tril()
    d = torch.where(tri[None, :, :, None], torch.exp(logd), 0.0)
    scores = torch.einsum("bthd,bjhd->btjh", q, k) * d
    y_intra = torch.einsum("btjh,bjhd->bthd", scores, v)
    # the normaliser accumulates i_j k_j, so the intra-chunk term of q_t . n_t
    # is sum_j D_tj (q_t . k_j): the row sums of the scores
    n_intra = scores.sum(dim=2)  # (B, P, H)
    # inter-chunk: the decayed readout of the carried state
    qd = q * torch.exp(cum)[..., None]
    y_inter = torch.einsum("bthd,bhde->bthe", qd, state)
    n_inter = torch.einsum("bthd,bhd->bth", qd, norm)
    denom = torch.clamp(torch.abs(n_intra + n_inter), min=1.0)
    y = (y_intra + y_inter) / denom[..., None]
    total = cum[:, -1:]  # (B, 1, H) the whole chunk's log decay
    kw = k * torch.exp(total - cum + li)[..., None]  # decayed from step j to the chunk's end
    decay = torch.exp(total[:, 0])  # (B, H)
    new_state = decay[..., None, None] * state + torch.einsum("bjhd,bjhe->bhde", kw, v)
    new_norm = decay[..., None] * norm + kw.sum(dim=1)
    return y, new_state, new_norm


def _scale(x: torch.Tensor, value: float) -> torch.Tensor:
    """``x * value`` with ``value`` rounded to x's dtype first, as the
    reference multiplies by a Python float (filled on the device: no copy
    from the host in a captured step)."""
    return x * torch.full((), value, dtype=x.dtype, device=x.device)


def mlstm_cell(q, k, v, i_logit, f_logit, state, norm, chunk: int):
    """The whole sequence, chunkwise.  q, k, v: (B, S, H, dh); gates (B, S,
    H); state (B, H, dh, dh) and norm (B, H, dh) f32.  Returns (y (B, S, H,
    dh) f32, state, norm).

    The tail is padded to a chunk multiple with identity steps: input gate
    0 (``li = -1e30``) and forget gate 1 (``lf = 0``), exact for the state
    and the outputs, which are sliced back.
    """
    b, s, h, dh = q.shape
    q = _scale(q, dh**-0.5)
    li = F.logsigmoid(i_logit.to(torch.float32))
    lf = F.logsigmoid(f_logit.to(torch.float32))
    pad = (-s) % chunk
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        li = F.pad(li, (0, 0, 0, pad), value=-1e30)
        lf = F.pad(lf, (0, 0, 0, pad))
    ys = []
    for c0 in range(0, s + pad, chunk):
        c = slice(c0, c0 + chunk)
        y, state, norm = _mlstm_chunk(q[:, c], k[:, c], v[:, c], li[:, c], lf[:, c], state,
                                      norm)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :s], state, norm


def _mlstm_dims(cfg: ArchConfig, d: int) -> tuple[int, int, int]:
    """(heads, d_inner, head dim)."""
    di = cfg.ssm.expand * d
    return cfg.n_heads, di, di // cfg.n_heads


def mlstm_block_fwd(p: Params, cfg: ArchConfig, x: torch.Tensor, *, return_cache: bool = False,
                    train: bool = False):
    """Prefill / training over the whole of ``x`` (B, S, d) -> (x + out,
    {"state", "norm", "conv"} | None).  ``wq`` / ``wk`` read the conv
    output, ``wv`` the input before it; the output is gated by
    ``silu(u_g)``."""
    b, s, d = x.shape
    h, di, dh = _mlstm_dims(cfg, d)
    dtype = x.dtype
    xn = layers.rmsnorm(p["ln"], x)
    u = layers.linear(p["w_up"], xn, dtype)
    u_c, u_g = u[..., :di], u[..., di:]
    c = F.silu(causal_conv(p["conv"], u_c))
    q = layers.linear(p["wq"], c, dtype).reshape(b, s, h, dh)
    k = layers.linear(p["wk"], c, dtype).reshape(b, s, h, dh)
    v = layers.linear(p["wv"], u_c, dtype).reshape(b, s, h, dh)
    gates = layers.linear(p["w_if"], xn, dtype)
    state0 = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=x.device)
    norm0 = torch.zeros((b, h, dh), dtype=torch.float32, device=x.device)
    y, state, norm = mlstm_cell(q, k, v, gates[..., :h], gates[..., h:], state0, norm0,
                                cfg.ssm.chunk_size)
    out = layers.linear(p["w_down"], y.reshape(b, s, di).to(dtype) * F.silu(u_g), dtype)
    cache = None
    if return_cache:
        cache = {"state": state, "norm": norm, "conv": conv_tail(u_c, cfg.ssm.conv_width)}
    return x + out, cache


def mlstm_block_step(p: Params, cfg: ArchConfig, x: torch.Tensor, cache: dict,
                     pos) -> torch.Tensor:
    """One token: x (B, 1, d) -> x + out; the state, normaliser and conv
    tail are written in place (``pos`` is not read)."""
    b, _, d = x.shape
    h, di, dh = _mlstm_dims(cfg, d)
    dtype = x.dtype
    xn = layers.rmsnorm(p["ln"], x)
    u = layers.linear(p["w_up"], xn, dtype)
    u_c, u_g = u[..., :di], u[..., di:]
    conv_state, c = causal_conv_step(p["conv"], cache["conv"], u_c)
    c = F.silu(c)
    q = _scale(layers.linear(p["wq"], c, dtype).reshape(b, h, dh), dh**-0.5).to(torch.float32)
    k = layers.linear(p["wk"], c, dtype).reshape(b, h, dh).to(torch.float32)
    v = layers.linear(p["wv"], u_c, dtype).reshape(b, h, dh).to(torch.float32)
    gates = layers.linear(p["w_if"], xn, dtype)
    i_g = torch.sigmoid(gates[..., :h].to(torch.float32)).reshape(b, h)
    f_g = torch.sigmoid(gates[..., h:].to(torch.float32)).reshape(b, h)
    state = (f_g[..., None, None] * cache["state"]
             + i_g[..., None, None] * torch.einsum("bhd,bhe->bhde", k, v))
    norm = f_g[..., None] * cache["norm"] + i_g[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, state)
    den = torch.clamp(torch.abs(torch.einsum("bhd,bhd->bh", q, norm)), min=1.0)
    y = (num / den[..., None]).reshape(b, 1, di).to(dtype)
    cache["state"].copy_(state)
    cache["norm"].copy_(norm)
    cache["conv"].copy_(conv_state)
    return x + layers.linear(p["w_down"], y * F.silu(u_g), dtype)


def init_mlstm_cache(cfg: ArchConfig, batch: int, dtype, device,
                     lead: tuple[int, ...] = ()) -> dict[str, torch.Tensor]:
    """Zero state (*lead, B, H, dh, dh) and normaliser (*lead, B, H, dh) in
    f32, and conv tail (*lead, B, W-1, d_inner) in ``dtype``."""
    h, di, dh = _mlstm_dims(cfg, cfg.d_model)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "state": torch.zeros(lead + (batch, h, dh, dh), **f32),
        "norm": torch.zeros(lead + (batch, h, dh), **f32),
        "conv": torch.zeros(lead + (batch, cfg.ssm.conv_width - 1, di), dtype=dtype,
                            device=device),
    }


# ---------------------------------------------------------------------------
# sLSTM (scalar-memory LSTM with exp gating and a stabiliser), sequential
# ---------------------------------------------------------------------------

def init_slstm_block(key: torch.Tensor, cfg: ArchConfig) -> Params:
    """One block's params from ``key`` (keys ``[L, 2]`` stack them), the
    reference's draws bit for bit: ``split(key, 4)``, three used; ``r`` is
    the per-head recurrent kernel [H, dh, 4 dh] of the i, f, z, o gates."""
    h = cfg.n_heads
    dh = cfg.d_model // h
    ks = prng.split(key, 4).unbind(-2)
    return {
        "ln": layers.init_norm(cfg.d_model, key.device, tuple(key.shape[:-1])),
        "w": layers._dense_init(ks[0], cfg.d_model, 4 * cfg.d_model),  # i, f, z, o
        "r": prng.normal(ks[1], (h, dh, 4 * dh)) * layers._f32(dh**-0.5, key.device),
        "w_out": layers._dense_init(ks[2], cfg.d_model, cfg.d_model),
    }


def _slstm_step(p: Params, wx_t: torch.Tensor, hs: dict) -> dict[str, torch.Tensor]:
    """wx_t: (B, H, 4 dh) input contribution; hs: {"h", "c", "n", "m"}
    (B, H, dh) f32 -> the next state (new tensors)."""
    h_prev, c_prev, n_prev, m_prev = hs["h"], hs["c"], hs["n"], hs["m"]
    g = (wx_t + torch.einsum("bhd,hde->bhe", h_prev, p["r"])).to(torch.float32)
    ig, fg, zg, og = g.chunk(4, dim=-1)
    lf = F.logsigmoid(fg)
    m_t = torch.maximum(lf + m_prev, ig)
    i_p = torch.exp(ig - m_t)
    f_p = torch.exp(lf + m_prev - m_t)
    c_t = f_p * c_prev + i_p * torch.tanh(zg)
    n_t = f_p * n_prev + i_p
    h_t = torch.sigmoid(og) * c_t / torch.clamp(n_t, min=1e-6)
    return {"h": h_t, "c": c_t, "n": n_t, "m": m_t}


def slstm_block_fwd(p: Params, cfg: ArchConfig, x: torch.Tensor, *, return_cache: bool = False,
                    train: bool = False):
    """Prefill / training over the whole of ``x`` (B, S, d), one step a
    position -> (x + out, {"h", "c", "n", "m"} | None)."""
    b, s, d = x.shape
    h = cfg.n_heads
    dh = d // h
    dtype = x.dtype
    xn = layers.rmsnorm(p["ln"], x)
    wx = layers.linear(p["w"], xn, dtype).reshape(b, s, h, 4 * dh)
    hs = init_slstm_cache(cfg, b, dtype, x.device)
    ys = []
    for t in range(s):
        hs = _slstm_step(p, wx[:, t], hs)
        ys.append(hs["h"])
    y = torch.stack(ys, dim=1).reshape(b, s, d).to(dtype)
    return x + layers.linear(p["w_out"], y, dtype), hs if return_cache else None


def slstm_block_step(p: Params, cfg: ArchConfig, x: torch.Tensor, cache: dict,
                     pos) -> torch.Tensor:
    """One token: x (B, 1, d) -> x + out; ``h``, ``c``, ``n`` and ``m`` are
    written in place (``pos`` is not read)."""
    b, _, d = x.shape
    h = cfg.n_heads
    dtype = x.dtype
    xn = layers.rmsnorm(p["ln"], x)
    wx = layers.linear(p["w"], xn, dtype).reshape(b, h, 4 * (d // h))
    hs = _slstm_step(p, wx, cache)
    for name, t in hs.items():
        cache[name].copy_(t)
    return x + layers.linear(p["w_out"], hs["h"].reshape(b, 1, d).to(dtype), dtype)


def init_slstm_cache(cfg: ArchConfig, batch: int, dtype, device,
                     lead: tuple[int, ...] = ()) -> dict[str, torch.Tensor]:
    """Zero h, c, n and the stabiliser m at -1e30, each (*lead, B, H, dh)
    f32 (``dtype`` is not read: the state is float32)."""
    shape = lead + (batch, cfg.n_heads, cfg.d_model // cfg.n_heads)
    z = lambda: torch.zeros(shape, dtype=torch.float32, device=device)  # noqa: E731
    return {"h": z(), "c": z(), "n": z(),
            "m": torch.full(shape, -1e30, dtype=torch.float32, device=device)}


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
    tail = conv_tail(xc, s_cfg.conv_width)
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
    cache = {"state": state, "conv": tail} if return_cache else None
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
