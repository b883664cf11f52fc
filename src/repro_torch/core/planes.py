"""Pluggable plane codecs: how packed bit planes are *stored* on crossbars.

Port of ``repro.core.planes``.  Upstream modules treat the canonical packed
planes (``uint8[S, W, cols]``, ``bitslice.section_planes_packed``) as the
literal crossbar content; a codec picks another stored representation:

* ``raw``        — identity: payload is the canonical packed planes.
* ``const_rle``  — a (section, column) tile whose ``W`` bytes are all equal
  is stored as (flag, value) and its words are elided from the payload
  (zeroed here; ``compression_stats`` prices the elision).
* ``col_perm``   — per-section column permutation planned along each
  programming chain (a greedy minimum-cost matching on Hamming distances
  priced through ``price_pairs``) so consecutive reprograms toggle fewer
  cells; a chain keeps its permutations only when they beat the identity.
* ``col_perm_rle`` — ``col_perm`` then ``const_rle`` on the permuted words.

The contract is byte identity: ``decode(encode(planes)) == planes`` for
every codec.  ``PlaneSet.physical`` is what the crossbars hold; the pool
prices seams and counts wear on those bits, and logical planes come back
through ``logical_from_physical``.

Serving-side twins (``encode_operands``): the serving layout
``uint8[..., cols, ceil(K/8), N]`` gets a plane-axis permutation
(``plane_ids``: stored plane ``p`` weighs ``2**plane_ids[p]``) and zero-tile
flags (``plane_tile_nz``, one per (plane, 128-row K block)) that the packed
matmul kernels consume — exact re-encodings, so served tokens are unchanged.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import schedule
from repro_torch.core.cost import popcount_u8
from repro_torch.kernels.hamming import ops as hamming_ops

CODECS = ("raw", "const_rle", "col_perm", "col_perm_rle")

# serving-side zero-tile granularity: 16 packed bytes = 128 weight rows, so
# one flag covers one (plane, 128-row K block) of the packed matmul
OPERAND_TILE_BYTES = 16


def _check_codec(codec: str) -> None:
    if codec not in CODECS:
        raise ValueError(f"unknown plane codec {codec!r}; choose from {CODECS}")


@dataclasses.dataclass
class PlaneSet:
    """One tensor's sections in a codec-defined stored representation.

    ``payload`` is ``uint8[S, W, cols]`` stored words: for the ``*_rle``
    codecs, constant tiles are elided (zeroed) from it and carried in
    (``const_mask``, ``const_val``); for ``col_perm*``, stored column ``j``
    of section ``s`` holds logical plane ``col_order[s, j]``.
    """

    codec: str
    payload: torch.Tensor  # uint8[S, W, cols]
    col_order: torch.Tensor | None = None  # int32[S, cols] stored pos -> logical plane
    const_mask: torch.Tensor | None = None  # bool[S, cols] tile is constant
    const_val: torch.Tensor | None = None  # uint8[S, cols] the constant byte

    def physical(self) -> torch.Tensor:
        """Dense stored words the crossbar holds -> uint8[S, W, cols]
        (``raw``/``col_perm``: the payload itself; ``*_rle``: constant tiles
        re-broadcast)."""
        if self.const_mask is None:
            return self.payload
        return torch.where(self.const_mask[:, None, :], self.const_val[:, None, :], self.payload)

    def decode(self) -> torch.Tensor:
        """Logical canonical packed planes, byte-identical to the encoder input."""
        return logical_from_physical(self.physical(), self.col_order)

    def compression_stats(self) -> dict[str, int | float]:
        """Stored size: ``payload_bytes`` counts ``W`` bytes per non-elided
        (section, column) tile; ``meta_bytes`` prices the sideband (1 byte
        per column-order entry, 1 bit per constant flag, 1 byte per constant
        value); ``raw_bytes`` is the uncompressed ``S * W * cols``."""
        s, w, cols = self.payload.shape
        raw_bytes = s * w * cols
        if self.const_mask is not None:
            kept = int((~self.const_mask).sum())
            n_const = s * cols - kept
            payload_bytes = kept * w
            meta_bytes = -(-s * cols // 8) + n_const
        else:
            payload_bytes = raw_bytes
            meta_bytes = 0
        if self.col_order is not None:
            meta_bytes += s * cols
        total = payload_bytes + meta_bytes
        return {
            "raw_bytes": raw_bytes,
            "payload_bytes": payload_bytes,
            "meta_bytes": meta_bytes,
            "total_bytes": total,
            "ratio_vs_raw": raw_bytes / max(total, 1),
        }


def logical_from_physical(
    physical: torch.Tensor, col_order: torch.Tensor | None
) -> torch.Tensor:
    """Invert a per-section column permutation on dense stored words (the
    decode direction for the target planes or an achieved readback)."""
    if col_order is None:
        return physical
    # col_order is a permutation per section, so argsort is its inverse:
    # logical column c lives at stored position inv[c]
    inv = torch.argsort(col_order, dim=-1)
    return torch.gather(physical, 2, inv[:, None, :].expand(physical.shape))


# ---------------------------------------------------------------------------
# Encoders
# ---------------------------------------------------------------------------

def _const_tiles(payload: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Detect constant (section, column) tiles: all ``W`` bytes equal."""
    mask = (payload == payload[:, :1, :]).all(dim=1)  # bool[S, cols]
    val = payload[:, 0, :]  # uint8[S, cols]
    elided = torch.where(mask[:, None, :], torch.zeros_like(payload), payload)
    return elided, mask, val


def encode(
    packed: torch.Tensor,
    codec: str,
    *,
    chains: list[np.ndarray] | None = None,
    pin_cols: int = 0,
) -> PlaneSet:
    """Canonical packed planes ``uint8[S, W, cols]`` -> :class:`PlaneSet`.

    ``col_perm*`` needs ``chains`` (the programming schedule) to plan column
    orders against each section's predecessor; ``pin_cols`` keeps the
    lowest columns at identity (see :func:`plan_col_order`).
    """
    _check_codec(codec)
    if packed.dtype != torch.uint8 or packed.ndim != 3:
        raise ValueError(
            f"expected canonical uint8[S, W, cols] planes, got {packed.dtype}{tuple(packed.shape)}"
        )
    if codec == "raw":
        return PlaneSet("raw", packed)
    if codec == "const_rle":
        payload, mask, val = _const_tiles(packed)
        return PlaneSet(codec, payload, None, mask, val)
    if chains is None:
        raise ValueError(f"codec {codec!r} plans column orders along chains; pass chains=")
    order = torch.from_numpy(plan_col_order(packed, chains, pin_cols=pin_cols)).to(packed.device)
    stored = torch.gather(packed, 2, order[:, None, :].to(torch.int64).expand(packed.shape))
    if codec == "col_perm":
        return PlaneSet(codec, stored, order)
    payload, mask, val = _const_tiles(stored)
    return PlaneSet(codec, payload, order, mask, val)


def _greedy_assign(m: np.ndarray, pin: int = 0) -> np.ndarray:
    """Greedy minimum-cost matching on small square cost matrices.

    ``m`` is ``[n, n]`` or a batch ``[B, n, n]``.  Repeatedly takes the
    globally cheapest free (row, col) pair of each matrix — ties break at
    ``np.argmin``'s first minimum in row-major order.  ``out[..., j] = b``:
    stored position ``j`` takes logical plane ``b``.  The first ``pin``
    positions are fixed to identity before matching.
    """
    batched = m.ndim == 3
    m = (m if batched else m[None]).astype(np.int64)  # a copy
    nb, n, _ = m.shape
    big = np.iinfo(np.int64).max
    out = np.full((nb, n), -1, np.int32)
    ar = np.arange(nb)
    pin = min(pin, n)
    out[:, :pin] = np.arange(pin)
    m[:, :pin, :] = big
    m[:, :, :pin] = big
    for _ in range(n - pin):
        flat = np.argmin(m.reshape(nb, -1), axis=1)
        j, b = flat // n, flat % n
        out[ar, j] = b
        m[ar, j, :] = big
        m[ar, :, b] = big
    return out if batched else out[0]


def plan_col_order(
    packed: torch.Tensor, chains: list[np.ndarray], *, pin_cols: int = 0
) -> np.ndarray:
    """Chain-aware per-section column orders -> host int32[S, cols].

    For every chain step the logical-column cross-distance matrix
    ``D[a, b] = hamming(prev[:, a], cur[:, b])`` is priced in ONE batched
    ``price_pairs`` call, then a host greedy matching walks each chain:
    stored slot ``j``'s cost of taking logical plane ``b`` is
    ``D[prev_order[j], b]``, so choices compose along the chain.  All chains
    walk at once (step ``i`` of every chain is one batched matching).  The
    first section of every chain keeps the identity order, and a chain
    reverts to identity when its matched layout does not beat the raw one.

    ``pin_cols`` fixes the lowest ``pin_cols`` logical columns at their
    identity positions: bit stucking under-programs the stored lowest
    column(s), which must keep holding the logical LSBs.
    """
    s, w, cols = packed.shape
    pin_cols = min(max(int(pin_cols), 0), cols)
    order = np.tile(np.arange(cols, dtype=np.int32), (s, 1))
    prev_i, cur_i = schedule.chain_pairs(chains, include_initial=False)
    t_total = prev_i.shape[0]
    if t_total == 0:
        return order

    # D[t, a, b] = popcount(packed[prev_t][:, a] ^ packed[cur_t][:, b]); each
    # side's broadcast is materialised once, contiguous, as price_pairs takes it
    dev = packed.device
    at = packed[torch.from_numpy(prev_i.astype(np.int64)).to(dev)].transpose(1, 2)  # [T, cols, W]
    bt = packed[torch.from_numpy(cur_i.astype(np.int64)).to(dev)].transpose(1, 2)
    a_full = at[:, :, None, :].expand(t_total, cols, cols, w).reshape(-1, w, 1)
    b_full = bt[:, None, :, :].expand(t_total, cols, cols, w).reshape(-1, w, 1)
    del at, bt
    d = hamming_ops.price_pairs(a_full, b_full)
    del a_full, b_full
    d = d.cpu().numpy().astype(np.int64).reshape(t_total, cols, cols)

    lens = np.array([len(c) - 1 for c in chains], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    idx = np.arange(cols)
    prev_order = np.tile(idx, (len(chains), 1))
    raw_cost = np.zeros(len(chains), np.int64)
    new_cost = np.zeros(len(chains), np.int64)
    chain_orders = np.zeros((len(chains), int(lens.max(initial=0)), cols), np.int32)
    for step in range(int(lens.max(initial=0))):
        live = np.nonzero(lens > step)[0]
        dm = d[offs[live] + step]  # [B, cols, cols]
        raw_cost[live] += dm[:, idx, idx].sum(axis=1)
        m = np.take_along_axis(dm, prev_order[live][:, :, None], axis=1)  # m[j, b] = D[prev[j], b]
        cur = _greedy_assign(m, pin_cols)
        new_cost[live] += np.take_along_axis(m, cur[:, :, None].astype(np.int64), axis=2).sum(
            axis=(1, 2))
        chain_orders[live, step] = cur
        prev_order[live] = cur
    for c, ch in enumerate(chains):
        if new_cost[c] < raw_cost[c]:
            ch = np.asarray(ch, dtype=np.int64)
            order[ch[1:]] = chain_orders[c, : len(ch) - 1]
    return order


# ---------------------------------------------------------------------------
# Serving-operand twins (simulator.packed_operands layout)
# ---------------------------------------------------------------------------

def _tile_nz(planes: torch.Tensor) -> torch.Tensor:
    """Zero-tile flags for serving planes ``uint8[..., cols, Kw, N]`` ->
    ``uint8[..., cols, ceil(Kw/16)]``: 1 iff any byte of the (plane, 16-byte
    K block) tile, across all N, is nonzero."""
    kw = planes.shape[-2]
    pad = (-kw) % OPERAND_TILE_BYTES
    if pad:
        planes = F.pad(planes, (0, 0, 0, pad))
    shaped = planes.reshape(planes.shape[:-2] + (-1, OPERAND_TILE_BYTES) + planes.shape[-1:])
    return (shaped != 0).any(dim=-1).any(dim=-1).to(torch.uint8)


def encode_operands(op: dict[str, torch.Tensor], codec: str) -> dict[str, torch.Tensor]:
    """Apply a codec to a packed serving operand dict (exactness-preserving).

    * ``col_perm*`` reorders the plane axis by descending bit count (a
      stable sort, so ties keep plane order) and records ``plane_ids``
      (stored plane ``p`` holds logical plane ``plane_ids[p]``);
    * ``*_rle`` adds ``plane_tile_nz`` zero-tile flags; the payload needs no
      rewrite, since zero tiles are already zero bytes.
    """
    _check_codec(codec)
    if codec == "raw":
        return op
    if "planes_packed" not in op:
        raise ValueError("encode_operands expects packed serving operands")
    out = dict(op)
    planes = op["planes_packed"]  # [..., cols, Kw, N]
    if codec in ("col_perm", "col_perm_rle"):
        ones = popcount_u8(planes).sum(dim=(-2, -1), dtype=torch.int64)  # [..., cols]
        plane_ids = torch.argsort(-ones, dim=-1, stable=True)
        idx = plane_ids[..., :, None, None].expand(planes.shape)
        planes = torch.gather(planes, -3, idx)
        out["plane_ids"] = plane_ids.to(torch.int32)
        out["planes_packed"] = planes
    if codec in ("const_rle", "col_perm_rle"):
        out["plane_tile_nz"] = _tile_nz(planes)
    return out


def operand_payload_bytes(op: dict[str, torch.Tensor]) -> dict[str, int]:
    """Weight bytes a decode step reads from an encoded operand dict: zero
    tiles flagged in ``plane_tile_nz`` are not read; the sign mask and the
    codec sideband are."""
    planes = op["planes_packed"]
    n = planes.shape[-1]
    sign_bytes = int(np.prod(op["sign_packed"].shape))
    meta = 0
    if "plane_ids" in op:
        meta += int(np.prod(op["plane_ids"].shape))
    if "plane_tile_nz" in op:
        flags = op["plane_tile_nz"].cpu().numpy().astype(np.int64)
        meta += flags.size
        # the last K-tile may be ragged: count the bytes it actually holds
        kw = planes.shape[-2]
        n_tiles = flags.shape[-1]
        tile_bytes = np.minimum(OPERAND_TILE_BYTES, kw - OPERAND_TILE_BYTES * np.arange(n_tiles))
        plane_bytes = int((flags * tile_bytes).sum()) * n
    else:
        plane_bytes = int(np.prod(planes.shape))
    return {
        "plane_bytes": plane_bytes,
        "sign_bytes": sign_bytes,
        "meta_bytes": meta,
        "total_bytes": plane_bytes + sign_bytes + meta,
    }
