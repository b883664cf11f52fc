"""Device non-idealities: stuck-at faults, drift, IR drop, fault-aware remapping.

Port of ``repro.core.nonideal``.  A programmed memristive cell need not read
back the bit that was written: cells get stuck at 0 or 1, conductances
drift, and line resistance attenuates the rows far from where a line is
driven.  This module models those effects:

* ``FaultModel`` — the fault distribution: stuck-at-0/1 rates, lognormal
  drift sigma, IR-drop strength and a hotspot mixture (a fraction of
  crossbars with multiplied stuck rates).  Construction validates it.
* ``inject`` — a per-crossbar ``FaultState`` drawn from a ``prng`` key:
  packed stuck masks in the pool's ``uint8[L, W, cols]`` layout, the
  reference's masks bit for bit (``prng.bernoulli`` with a per-crossbar
  float32 probability).
* ``read_packed`` — the faulty read ``(planes & ~stuck0) | stuck1``; with
  all-zero masks the identity, byte for byte.
* ``damage_matrix`` / ``fault_aware_assignment`` — the fault-aware remap:
  the significance-weighted bit flips each chain would suffer on each
  crossbar, then a greedy chain -> crossbar assignment (the pool's
  ``"fault"`` leveling).  The damage is summed over sections a chunk at a
  time, so a full-width tensor never holds ``[S, L, W, cols]`` whole.
* ``perturb_operands`` — the serving-side twin: stuck masks in the packed
  serving layout, per-plane drift gains ``exp(sigma * normal)`` (XLA:CPU's
  float32 ``exp``, ``prng.xla_exp``, so the gains are the reference's bit
  for bit) and an IR-drop row attenuation, consumed by
  ``simulator.cim_linear`` and ``densify_operands``.

Masks live on the pool's (or the operands') device; entry points take
their device from their inputs, or run on CUDA unless ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Sequence

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.bitslice import packbits, unpackbits
from repro_torch.kernels._util import resolve_device

if TYPE_CHECKING:  # CrossbarSpec lives in planner; avoid the import cycle
    from repro_torch.core.planner import CrossbarSpec

DAMAGE_CHUNK_BYTES = 1 << 26  # flip bytes per section chunk of damage_matrix


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Fault distribution of a crossbar population (all rates per cell).

    ``stuck0``/``stuck1`` are stuck-at rates of the magnitude bit cells
    (sign bits live in the digital periphery).  ``drift_sigma`` is the sigma
    of a lognormal per-bit-line gain ``exp(sigma * N(0, 1))``; ``ir_alpha``
    scales a row attenuation ``1 / (1 + alpha * r / R)``.
    ``hotspot_fraction`` of crossbars have their stuck rates multiplied by
    ``hotspot_mult`` (clipped to 1).
    """

    stuck0: float = 0.0
    stuck1: float = 0.0
    drift_sigma: float = 0.0
    ir_alpha: float = 0.0
    hotspot_fraction: float = 0.0
    hotspot_mult: float = 1.0

    def __post_init__(self):
        for field in ("stuck0", "stuck1", "hotspot_fraction"):
            v = getattr(self, field)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"FaultModel.{field} must be in [0, 1], got {v}")
        for field in ("drift_sigma", "ir_alpha"):
            v = getattr(self, field)
            if v < 0.0:
                raise ValueError(f"FaultModel.{field} must be >= 0, got {v}")
        if self.hotspot_mult < 0.0:
            raise ValueError(f"FaultModel.hotspot_mult must be >= 0, got {self.hotspot_mult}")

    @property
    def ideal(self) -> bool:
        """True when every non-ideality is off (reads are exact)."""
        return (self.stuck0 == 0.0 and self.stuck1 == 0.0
                and self.drift_sigma == 0.0 and self.ir_alpha == 0.0)


@dataclasses.dataclass
class FaultState:
    """Drawn faults of one pool of ``L`` crossbars."""

    model: FaultModel
    stuck0: torch.Tensor  # uint8[L, W, cols] packed mask: cell reads 0 (pool's device)
    stuck1: torch.Tensor  # uint8[L, W, cols] packed mask: cell reads 1 (disjoint)
    hot: np.ndarray  # bool[L] which crossbars drew the hotspot multiplier

    def fault_cells(self) -> np.ndarray:
        """Faulty cells per crossbar -> int64[L]."""
        both = unpackbits(self.stuck0 | self.stuck1, 1, self.stuck0.shape[1] * 8)
        return both.sum(dim=(1, 2), dtype=torch.int64).cpu().numpy()


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def inject(
    spec: "CrossbarSpec", n_crossbars: int, model: FaultModel, key: torch.Tensor,
    *, device: str | torch.device | None = None,
) -> FaultState:
    """Draw a per-crossbar fault realization, masks on ``device`` (CUDA
    unless the caller asks for the CPU).

    Masks are packed like ``CrossbarPool`` state (``uint8[L, W, cols]``,
    rows MSB-first); padding rows beyond ``spec.rows`` are fault-free.
    Stuck-at-1 cells are disjoint from stuck-at-0 cells; hotspot crossbars
    multiply both rates (float32, clipped to [0, 1], as the reference
    computes them).
    """
    dev = resolve_device(device)
    key = key.to(dev)
    rows, cols = spec.rows, spec.cols
    words = -(-rows // 8)
    kh, k0, k1 = prng.split(key, 3).unbind(-2)
    hot = prng.bernoulli(kh, float(model.hotspot_fraction), (n_crossbars,))
    mult = torch.where(hot, _f32(model.hotspot_mult, dev), _f32(1.0, dev))
    shape = (n_crossbars, words * 8, cols)
    valid = (torch.arange(words * 8, device=dev) < rows)[None, :, None]
    masks = []
    for k, rate in ((k0, model.stuck0), (k1, model.stuck1)):
        r = torch.clamp(_f32(rate, dev) * mult, 0.0, 1.0)[:, None, None]
        masks.append(prng.bernoulli(k, r, shape) & valid)
    s0, s1 = masks
    s1 = s1 & ~s0
    return FaultState(model=model, stuck0=packbits(s0, 1), stuck1=packbits(s1, 1),
                      hot=hot.cpu().numpy())


def read_packed(planes: torch.Tensor, stuck0: torch.Tensor, stuck1: torch.Tensor) -> torch.Tensor:
    """Faulty read of packed planes: stuck-at-0 clears, stuck-at-1 sets
    (shapes broadcast).  All-zero masks give the planes back unchanged."""
    return (planes & ~stuck0) | stuck1


def _popcount8(x: torch.Tensor) -> torch.Tensor:
    """Set bits of every uint8 byte (uint8 arithmetic, no lookup table)."""
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return (x + (x >> 4)) & 0x0F


def damage_matrix(
    packed: torch.Tensor,
    chains: Sequence[np.ndarray],
    state: FaultState,
) -> np.ndarray:
    """Significance-weighted bit-flip damage of every chain on every crossbar.

    ``damage[j, l]`` sums over the sections of chain ``j`` the bits a read
    from crossbar ``l`` would flip — stuck-at-0 cells holding a 1 plus
    stuck-at-1 cells holding a 0 — each weighted ``2**col``.  Sections go
    in chunks of at most ``DAMAGE_CHUNK_BYTES`` flip bytes, on the device
    of ``packed``; integer sums, so the chunking changes no value.
    Returns host ``int64[Lc, L]``.
    """
    dev = packed.device
    s0, s1 = state.stuck0.to(dev), state.stuck1.to(dev)
    s, words, cols = packed.shape
    n_xbar = s0.shape[0]
    chain_of = torch.empty(s, dtype=torch.int64, device=dev)
    for j, c in enumerate(chains):
        chain_of[torch.from_numpy(np.asarray(c, np.int64)).to(dev)] = j
    weight = (1 << torch.arange(cols, dtype=torch.int64, device=dev))
    damage = torch.zeros((len(chains), n_xbar), dtype=torch.int64, device=dev)
    step = max(1, DAMAGE_CHUNK_BYTES // (n_xbar * words * cols))
    for lo in range(0, s, step):
        p = packed[lo:lo + step, None]
        flips = (p & s0[None]) | (~p & s1[None])  # [chunk, L, W, cols]
        pop = _popcount8(flips).sum(dim=2, dtype=torch.int64)  # [chunk, L, cols]
        damage.index_add_(0, chain_of[lo:lo + step], (pop * weight).sum(dim=-1))
    return damage.cpu().numpy()


def fault_aware_assignment(damage: np.ndarray, wear: np.ndarray | None = None) -> np.ndarray:
    """Greedy chain -> crossbar assignment minimizing read damage.

    Chains choose in descending order of damage spread; each takes the free
    crossbar of least damage, ties toward least wear, then lowest index.
    No damage and no wear skew give the identity.  Returns ``int32[Lc]``
    distinct crossbar ids.
    """
    lc, l = damage.shape
    if lc > l:
        raise ValueError(f"{lc} chains for {l} crossbars")
    wear = np.zeros(l, np.int64) if wear is None else np.asarray(wear, np.int64)
    spread = damage.max(axis=1) - damage.min(axis=1)
    order = np.argsort(-spread, kind="stable")
    free = np.ones(l, dtype=bool)
    out = np.zeros(lc, np.int32)
    for j in order:
        cand = np.flatnonzero(free)
        best = cand[np.lexsort((cand, wear[cand], damage[j, cand]))[0]]
        out[j] = best
        free[best] = False
    return out


def perturb_operands(
    op: dict[str, torch.Tensor], model: FaultModel, key: torch.Tensor
) -> dict[str, torch.Tensor]:
    """Perturb a packed serving operand dict with the model's non-idealities.

    Adds ``stuck0_packed``/``stuck1_packed`` masks in the serving plane
    layout (``uint8[..., cols, ceil(K/8), N]``), a lognormal per-bit-line
    ``plane_gain`` ``f32[..., cols, N]`` and an IR-drop ``row_atten``
    ``f32[..., K]``, on the operands' device; ``simulator.cim_linear`` and
    ``densify_operands`` consume them with one arithmetic.  An ``ideal``
    model returns ``op`` itself.  Codec-encoded operands perturb in their
    stored layout: masks and gains attach to stored planes, and
    ``plane_ids`` significance applies after the masked read.
    """
    if "planes_packed" not in op:
        raise ValueError("perturb_operands expects packed serving operands")
    if model.ideal:
        return op
    planes = op["planes_packed"]  # [..., cols, Wk, N]
    dev = planes.device
    key = key.to(dev)
    lead = tuple(planes.shape[:-3])
    cols, wk, n = planes.shape[-3:]
    k = op["kdim"].shape[-2]
    k0, k1, kg = prng.split(key, 3).unbind(-2)
    out = dict(op)
    if model.stuck0 > 0.0 or model.stuck1 > 0.0:
        shape = lead + (cols, wk * 8, n)
        valid = (torch.arange(wk * 8, device=dev) < k)[:, None]
        s0 = prng.bernoulli(k0, min(model.stuck0, 1.0), shape) & valid
        s1 = prng.bernoulli(k1, min(model.stuck1, 1.0), shape) & valid & ~s0
        out["stuck0_packed"] = packbits(s0, -2)
        del s0
        out["stuck1_packed"] = packbits(s1, -2)
    if model.drift_sigma > 0.0:
        g = _f32(model.drift_sigma, dev) * prng.normal(kg, lead + (cols, n))
        out["plane_gain"] = prng.xla_exp(g)
    if model.ir_alpha > 0.0:
        # 1 / (1 + alpha * r / (K - 1)) in the reference's float32 steps;
        # each division taken in float64 rounds once, correctly, to float32
        r = _f32(model.ir_alpha, dev) * torch.arange(k, dtype=torch.float32, device=dev)
        r = (r.double() / max(k - 1, 1)).float()
        atten = (1.0 / (_f32(1.0, dev) + r).double()).float()
        out["row_atten"] = atten.expand(lead + (k,)).contiguous()
    return out
