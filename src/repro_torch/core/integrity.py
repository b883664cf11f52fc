"""Online crossbar integrity: scrub, detect, localize, and self-repair.

Port of ``repro.core.integrity``.  ``core/nonideal.py`` gives the pool stuck
cells that reads go through; this module finds which stored bits went bad
and repairs them, pricing every repair write in the planner's currency
(``price_pairs``: kernel B1 on the card):

* **Registration** (``IntegrityManager.register``, called by
  ``CrossbarPool.program``): each deployed tensor keeps its reference
  stored planes, the expected read through the registration-time fault
  masks (``achieved_read``: the deployment's contract) and position-weighted
  byte sums per (section, tile, column) over the expected read, plus an
  optional parity column (XOR of the data columns).
* **Scrubbing** (``scrub_round``): a budgeted round-robin cursor over all
  registered tiles.  A mismatching tile is read again (a match classifies a
  transient flip), then a masked read diffed against the expected planes
  localizes the faulty cells.
* **Repair**, per tile: rewrite corrupted stored bits in place; remap a
  column that stays wrong (hard stuck-at) onto a clean spare column, or
  tolerate it below ``tolerate_cols``; migrate the whole section to the
  least-worn crossbar when the spares are used up.  Each write is priced
  and charged to the pool's wear and write counters; ``repair_budget`` caps
  a round's repair transitions.
* **Refresh** (``rebuild`` / ``rebuild_plan``): the current read
  dequantized through the planner's pipeline, byte for byte the original
  ``w_hat`` once every hard fault is remapped or migrated.

The records (``reference``, ``expected``, ``stored``, the masks, checksums,
spares) live on the pool's device.  Where the reference reads a whole
tensor to check one tile, the port reads the sections it needs: without
transient flips the two give the same bytes.  With ``transient_rate > 0``
every read the reference draws transient flips for is taken whole, from
``numpy.random.default_rng((seed, ctr))`` over the whole tensor, so the
stream advances as it does there.  The round-robin order is the
reference's, kept as per-tensor tile offsets rather than a list of every
tile.  ``storm`` draws its masks on the device (``prng.fold_in`` /
``split`` / ``bernoulli``, the reference's bits) and packs them there.

One departure (ROADMAP C.3): a round's progress guarantee counts repair
*actions*.  The first rewrite, remap or migration of a round proceeds
whatever it costs, and every later one must fit ``repair_budget``; the
reference grants the guarantee while the round has spent no transitions,
so after a first action that costs 0 it lets a second one through.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import planes as planes_mod
from repro_torch.core.bitslice import packbits
from repro_torch.kernels.hamming import ops as hamming_ops

if TYPE_CHECKING:  # the pool imports this module lazily; keep the cycle type-only
    from repro_torch.core.pool import CrossbarPool, PoolProgramReport

_U32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Config + reports
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class IntegrityConfig:
    """Scrub / repair policy.

    ``spare_cols`` clean spare column planes per section are the remap
    targets (``parity_col`` adds an XOR parity column); ``scrub_tiles``
    bounds the tiles a round verifies; ``repair_budget`` caps a round's
    repair transitions (None: unbounded; the first repair action of a round
    always proceeds); hard faults in logical columns below
    ``tolerate_cols`` stay unrepaired; ``transient_rate`` is the per-bit
    rate of transient read flips, which the re-read must classify.
    """

    tile_bytes: int = planes_mod.OPERAND_TILE_BYTES  # one 128-row K block of an operand
    spare_cols: int = 2
    parity_col: bool = True
    scrub_tiles: int = 64
    repair_budget: int | None = None
    tolerate_cols: int = 0
    transient_rate: float = 0.0
    seed: int = 0

    def __post_init__(self):
        if self.tile_bytes < 1:
            raise ValueError(f"tile_bytes must be >= 1, got {self.tile_bytes}")
        if self.spare_cols < 0:
            raise ValueError(f"spare_cols must be >= 0, got {self.spare_cols}")
        if self.scrub_tiles < 1:
            raise ValueError(f"scrub_tiles must be >= 1, got {self.scrub_tiles}")
        if self.repair_budget is not None and self.repair_budget < 1:
            raise ValueError(f"repair_budget must be >= 1 or None, got {self.repair_budget}")
        if self.tolerate_cols < 0:
            raise ValueError(f"tolerate_cols must be >= 0, got {self.tolerate_cols}")
        if not 0.0 <= self.transient_rate <= 1.0:
            raise ValueError(f"transient_rate must be in [0, 1], got {self.transient_rate}")


@dataclasses.dataclass
class ScrubReport:
    """Counters of one scrub round, or of several merged."""

    rounds: int = 0
    tiles_scanned: int = 0
    detections: int = 0  # tiles with a persistent (non-transient) mismatch
    transients: int = 0  # tiles whose mismatch vanished on re-read
    localized_bits: int = 0  # faulty cells pinpointed by the diff
    rewrites: int = 0  # in-place tile rewrites
    remaps: int = 0  # column remaps onto spare planes
    migrations: int = 0  # whole-section migrations
    tolerated: int = 0  # hard-faulty low-order columns left unrepaired
    parity_mismatches: int = 0  # tiles only the parity column caught
    repair_transitions: int = 0  # total repair write cost (price_pairs)
    pending: int = 0  # repairs deferred past the round's budget

    def merge(self, other: "ScrubReport") -> None:
        for f in dataclasses.fields(self):
            if f.name == "pending":
                self.pending = other.pending  # a level, not a flow
            else:
                setattr(self, f.name, getattr(self, f.name) + getattr(other, f.name))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class TensorRecord:
    """Integrity metadata and live modeled cells of one deployed tensor (all
    tensors on the pool's device).

    ``reference`` is what the cells should hold, ``expected`` what a read
    should return (the contract).  ``stored`` / ``stuck0`` / ``stuck1`` are
    the live cells that storms corrupt; ``col_map[s, c] >= cols`` means
    stored column ``c`` of section ``s`` reads from spare ``col_map[s, c] -
    cols``.
    """

    name: str
    reference: torch.Tensor  # uint8[S, W, C] target stored bits
    expected: torch.Tensor  # uint8[S, W, C] expected read
    checksums: torch.Tensor  # int64[S, T, C] position-weighted tile sums (uint32 values)
    parity: torch.Tensor | None  # uint8[S, W] XOR of the expected data columns
    sec_xbar: np.ndarray  # int32[S] owning physical crossbar per section (host)
    col_order: torch.Tensor | None  # int32[S, C] stored position -> logical plane
    transitions_full: int  # full-reprogram cost of the tensor
    stored: torch.Tensor  # uint8[S, W, C] live cell contents
    stuck0: torch.Tensor  # uint8[S, W, C] live stuck-at-0 mask
    stuck1: torch.Tensor  # uint8[S, W, C] live stuck-at-1 mask (disjoint)
    spare: torch.Tensor  # uint8[S, W, n_spare] spare column planes
    spare_used: torch.Tensor  # bool[S, n_spare]
    col_map: torch.Tensor  # int32[S, C]
    detections: int = 0
    aux: dict[str, Any] | None = None  # the planner's reconstruction closure


def tile_checksums(expected: torch.Tensor, tile_bytes: int) -> torch.Tensor:
    """Position-weighted byte sums per (section, tile, column) -> int64[S, T,
    C], the reference's uint32 values: byte ``i`` of a tile weighs ``i +
    1``, so any single-byte change shows."""
    s, w, c = expected.shape
    t = -(-w // tile_bytes)
    p = torch.nn.functional.pad(expected, (0, 0, 0, t * tile_bytes - w)).to(torch.int64)
    weights = torch.arange(1, tile_bytes + 1, dtype=torch.int64, device=expected.device)
    return (p.reshape(s, t, tile_bytes, c) * weights[None, None, :, None]).sum(dim=2) & _U32


def _xor_cols(planes: torch.Tensor) -> torch.Tensor:
    """XOR over the last axis: uint8[..., C] -> uint8[...]."""
    out = planes[..., 0].clone()
    for c in range(1, planes.shape[-1]):
        out ^= planes[..., c]
    return out


def _price(a: torch.Tensor, b: torch.Tensor) -> int:
    """Total transitions a -> b through ``price_pairs`` (kernel B1 on the
    card): every repair write is priced here."""
    a3 = a if a.ndim == 3 else a[None]
    b3 = b if b.ndim == 3 else b[None]
    if a3.shape[0] == 0:
        return 0
    return int(hamming_ops.price_pairs(a3.contiguous(), b3.contiguous()).sum(dtype=torch.int64))


# ---------------------------------------------------------------------------
# The manager
# ---------------------------------------------------------------------------

class IntegrityManager:
    """Per-pool scrub / detect / repair state over all registered tensors."""

    def __init__(self, pool: "CrossbarPool", cfg: IntegrityConfig | None = None):
        self.pool = pool
        self.cfg = cfg or IntegrityConfig()
        self.rows = pool.spec.rows
        self.cols = pool.spec.cols
        self.words = -(-pool.spec.rows // 8)
        self.tensors: dict[str, TensorRecord] = {}
        self.totals = ScrubReport()
        self.spare_writes = 0  # repair writes landing on spare planes
        self._names: list[str] = []
        self._offsets = np.zeros(1, np.int64)  # first flat tile of each tensor, then the total
        self._segments: dict[str, tuple[int, int]] = {}  # name -> (S, T) of its tile grid
        self._cursor = 0
        self._clean_streak = 0
        self._pending: set[tuple[str, int, int]] = set()
        self._read_ctr = 0
        self._round_actions = 0

    # -- registration ------------------------------------------------------

    def register(
        self,
        report: "PoolProgramReport",
        *,
        chains: list[np.ndarray],
        col_order: torch.Tensor | None = None,
    ) -> TensorRecord:
        """Record a freshly programmed tensor.  The expected read is
        ``achieved_read`` verbatim, so pool faults present at program time
        are part of the contract, not defects."""
        reference = report.achieved
        s = reference.shape[0]
        dev = reference.device
        sec_xbar = np.zeros(s, np.int32)
        for j, c in enumerate(chains):
            sec_xbar[np.asarray(c)] = report.assignment[j]
        faults = self.pool.faults
        if faults is not None:
            idx = torch.from_numpy(sec_xbar.astype(np.int64)).to(dev)
            stuck0, stuck1 = faults.stuck0[idx], faults.stuck1[idx]
        else:
            stuck0, stuck1 = torch.zeros_like(reference), torch.zeros_like(reference)
        expected = report.achieved_read.clone()
        cfg = self.cfg
        rec = TensorRecord(
            name=report.name,
            reference=reference.clone(),
            expected=expected,
            checksums=tile_checksums(expected, cfg.tile_bytes),
            parity=_xor_cols(expected) if cfg.parity_col else None,
            sec_xbar=sec_xbar,
            col_order=None if col_order is None else col_order.to(torch.int32),
            transitions_full=int(report.transitions_full),
            stored=reference.clone(),
            stuck0=stuck0.clone(),
            stuck1=stuck1.clone(),
            spare=torch.zeros((s, self.words, cfg.spare_cols), dtype=torch.uint8, device=dev),
            spare_used=torch.zeros((s, cfg.spare_cols), dtype=torch.bool, device=dev),
            col_map=torch.arange(self.cols, dtype=torch.int32, device=dev).repeat(s, 1),
        )
        self.tensors[report.name] = rec
        self._rebuild_tile_index()
        return rec

    def attach_aux(self, name: str, aux: dict[str, Any]) -> None:
        """Planner hook: the reconstruction closure (sign slots, scale,
        offset, slot -> source permutation, size, shape, dtype) ``rebuild``
        needs."""
        self.tensors[name].aux = aux

    def _rebuild_tile_index(self) -> None:
        """Tile offsets in registration order; the cursor restarts."""
        self._names = list(self.tensors)
        self._segments = {n: (r.checksums.shape[0], r.checksums.shape[1])
                          for n, r in self.tensors.items()}
        self._offsets = np.cumsum([0] + [s * t for s, t in self._segments.values()],
                                  dtype=np.int64)
        self._cursor = 0
        self._clean_streak = 0

    @property
    def total_tiles(self) -> int:
        return int(self._offsets[-1])

    def _tile_at(self, cursor: int) -> tuple[str, int, int]:
        """(tensor, section, tile) of a flat tile index."""
        i = int(np.searchsorted(self._offsets, cursor, side="right")) - 1
        name = self._names[i]
        local = cursor - int(self._offsets[i])
        t_per = self._segments[name][1]
        return name, local // t_per, local % t_per

    # -- the modeled read path ---------------------------------------------

    def _masked_read(self, rec: TensorRecord, sec: slice) -> torch.Tensor:
        """Stored bits of sections ``sec`` through the live stuck masks, with
        remapped columns served from their spare planes."""
        out = (rec.stored[sec] & ~rec.stuck0[sec]) | rec.stuck1[sec]
        col_map = rec.col_map[sec]
        remapped = torch.nonzero(col_map >= self.cols)
        if remapped.shape[0]:
            ss, cc = remapped.unbind(1)
            out[ss, :, cc] = rec.spare[sec][ss, :, (col_map[ss, cc] - self.cols).long()]
        return out

    def read(self, rec: TensorRecord, *, transient: bool = True,
             sections: slice | None = None) -> torch.Tensor:
        """What the array returns for this tensor (or its ``sections``) now:
        live stored bits through the live stuck masks, remapped columns from
        their spares, plus (``transient``) transient per-read bit flips,
        drawn for the whole tensor from ``default_rng((seed, ctr))``."""
        sec = slice(None) if sections is None else sections
        if not (transient and self.cfg.transient_rate > 0.0):
            return self._masked_read(rec, sec)
        out = self._masked_read(rec, slice(None))
        self._read_ctr += 1
        rng = np.random.default_rng((self.cfg.seed, self._read_ctr))
        bits = rng.random((out.shape[0], self.rows, self.cols)) < self.cfg.transient_rate
        pad = self.words * 8 - self.rows
        if pad:
            bits = np.pad(bits, ((0, 0), (0, pad), (0, 0)))
        return (out ^ torch.from_numpy(np.packbits(bits, axis=1)).to(out.device))[sec]

    def verify_all(self) -> bool:
        """Deterministic full sweep: every tensor's read matches its contract."""
        return all(torch.equal(self.read(rec, transient=False), rec.expected)
                   for rec in self.tensors.values())

    def pending_faults(self) -> int:
        """Known-but-unrepaired tiles (budget-deferred)."""
        return len(self._pending)

    @property
    def clean(self) -> bool:
        """A full scrub cycle has passed with zero detections and no backlog."""
        return self._clean_streak >= self.total_tiles and not self._pending

    # -- fault-storm injection ---------------------------------------------

    def storm(
        self,
        key: torch.Tensor,
        *,
        corrupt_rate: float = 0.0,
        stuck_rate: float = 0.0,
        tensors: list[str] | None = None,
    ) -> dict:
        """A deterministic fault storm: flip stored bits at ``corrupt_rate``
        (repairable in place) and add stuck cells at ``stuck_rate`` (half
        stuck at 1).  Tensor ``i`` of the sorted names draws from
        ``fold_in(key, i)``; masks are drawn and packed on the records'
        device.  Returns the injected counts."""
        if not 0.0 <= corrupt_rate <= 1.0 or not 0.0 <= stuck_rate <= 1.0:
            raise ValueError("storm rates must be in [0, 1]")
        names = sorted(tensors if tensors is not None else self.tensors)
        corrupted = new_stuck = 0
        for i, name in enumerate(names):
            rec = self.tensors[name]
            dev = rec.stored.device
            k = prng.fold_in(key.to(dev), i)
            kc, ks, kv = prng.split(k, 3).unbind(-2)
            shape = (rec.stored.shape[0], self.rows, self.cols)
            if corrupt_rate > 0.0:
                bits = prng.bernoulli(kc, corrupt_rate, shape)
                corrupted += int(bits.sum(dtype=torch.int64))
                rec.stored ^= packbits(bits, 1)
                del bits
            if stuck_rate > 0.0:
                cells = prng.bernoulli(ks, stuck_rate, shape)
                s1_p = packbits(cells & prng.bernoulli(kv, 0.5, shape), 1)
                cells_p = packbits(cells, 1)
                del cells
                s0_new = (cells_p & ~s1_p) & ~rec.stuck1
                s1_new = s1_p & ~(rec.stuck0 | s0_new)
                rec.stuck0 |= s0_new
                rec.stuck1 |= s1_new
                new = s0_new | s1_new
                new_stuck += _price(new, torch.zeros_like(new))
        return {"tensors": len(names), "corrupted_bits": corrupted, "new_stuck_cells": new_stuck}

    # -- scrubbing ----------------------------------------------------------

    def scrub_round(self, budget_tiles: int | None = None) -> ScrubReport:
        """Verify up to ``budget_tiles`` tiles (default ``cfg.scrub_tiles``)
        from the round-robin cursor, classifying and repairing mismatches
        within the round's repair-write budget."""
        rep = ScrubReport(rounds=1)
        total = self.total_tiles
        if not total:
            return rep
        n = min(budget_tiles or self.cfg.scrub_tiles, total)
        transient = self.cfg.transient_rate > 0.0
        cache: dict[str, torch.Tensor] = {}  # whole transient reads, as the reference caches
        tb = self.cfg.tile_bytes
        budget = self.cfg.repair_budget
        spent = 0
        self._round_actions = 0

        scanned = 0
        while scanned < n:
            name, s, t = self._tile_at(self._cursor)
            rec = self.tensors[name]
            big_s, big_t = self._segments[name]
            flat = s * big_t + t
            limit = min(big_s * big_t - flat, n - scanned)
            sub = slice(s, (flat + limit - 1) // big_t + 1)  # sections in the window
            if transient:
                if name not in cache:
                    cache[name] = self.read(rec)
                read1 = cache[name][sub]
            else:
                read1 = self.read(rec, transient=False, sections=sub)
            bad = (tile_checksums(read1, tb) != rec.checksums[sub]).any(dim=2)
            dirty = bad
            if rec.parity is not None:
                eq = _xor_cols(read1) == rec.parity[sub]
                pad = (-eq.shape[1]) % tb
                if pad:
                    eq = torch.nn.functional.pad(eq, (0, pad), value=True)
                dirty = bad | ~eq.reshape(eq.shape[0], -1, tb).all(dim=2)
            # advance over the window's run of clean tiles in bulk
            window = dirty.reshape(-1)[t : t + limit]
            run = int(window.to(torch.int8).argmax()) if bool(window.any()) else limit
            if run:
                if self._pending:
                    for p in [p for p in self._pending if p[0] == name]:
                        if flat <= p[1] * big_t + p[2] < flat + run:
                            self._pending.discard(p)
                rep.tiles_scanned += run
                self._clean_streak += run
                scanned += run
                self._cursor = (self._cursor + run) % total
                continue
            # a dirty tile at the cursor: classify and repair it
            scanned += 1
            rep.tiles_scanned += 1
            sl = slice(t * tb, min((t + 1) * tb, rec.reference.shape[1]))
            if not bool(bad.reshape(-1)[t]):  # checksum clean, parity caught it
                rep.parity_mismatches += 1
            # re-read: a transient flip vanishes on the second read
            sec = slice(s, s + 1)
            read2 = self.read(rec, sections=sec)
            persistent = bool((tile_checksums(read2, tb)[0, t] != rec.checksums[s, t]).any())
            # localize: the masked read diffed against the expected planes
            det = self.read(rec, transient=False, sections=sec)[0, sl] ^ rec.expected[s, sl]
            if not persistent or not bool(det.any()):
                rep.transients += 1
                self._clean_streak += 1
                self._cursor = (self._cursor + 1) % total
                continue
            rep.detections += 1
            rec.detections += 1
            self._clean_streak = 0
            rep.localized_bits += _price(det, torch.zeros_like(det))
            done, cost = self._repair_tile(rec, s, sl, rep, budget=budget, spent=spent)
            spent += cost
            cache.pop(name, None)  # repairs invalidate the round's cached read
            if not done:
                self._pending.add((name, s, t))
                rep.pending = len(self._pending)
                break  # budget exhausted: resume at this tile next round
            self._pending.discard((name, s, t))
            self._cursor = (self._cursor + 1) % total
        rep.pending = len(self._pending)
        self.totals.merge(rep)
        return rep

    def scrub_until_clean(self, *, max_rounds: int = 10_000) -> ScrubReport:
        """Drive ``scrub_round`` until a full clean cycle (or ``max_rounds``);
        the merged report.  ``clean`` tells whether it converged."""
        agg = ScrubReport()
        for _ in range(max_rounds):
            agg.merge(self.scrub_round())
            if self.clean:
                break
        return agg

    # -- repair -------------------------------------------------------------

    def _afford(self, cost: int, budget: int | None, spent: int) -> bool:
        # the first repair action of a round always proceeds (progress
        # guarantee); every later one must fit the budget (ROADMAP C.3)
        return budget is None or self._round_actions == 0 or spent + cost <= budget

    def _repair_tile(
        self, rec: TensorRecord, s: int, sl: slice, rep: ScrubReport,
        *, budget: int | None, spent: int,
    ) -> tuple[bool, int]:
        """Repair one persistently mismatching tile.  Returns (done, cost)."""
        cost = 0
        # 1) in-place rewrite of corrupted stored bits (cells still write)
        toggle = rec.stored[s, sl] ^ rec.reference[s, sl]
        if bool(toggle.any()):
            c_rw = _price(toggle, torch.zeros_like(toggle))
            if not self._afford(c_rw, budget, spent + cost):
                return False, cost
            rec.stored[s, sl] = rec.reference[s, sl]
            self._charge_pool(int(rec.sec_xbar[s]), toggle, sl)
            self._round_actions += 1
            rep.rewrites += 1
            rep.repair_transitions += c_rw
            cost += c_rw
        # 2) verified re-read: what survives a rewrite is hard stuck-at
        verify = self.read(rec, transient=False, sections=slice(s, s + 1))[0]
        resid = verify[sl] ^ rec.expected[s, sl]
        bad_cols = torch.nonzero(resid.any(dim=0)).reshape(-1).tolist()
        order = None if rec.col_order is None else rec.col_order[s].tolist()

        def logical(c: int) -> int:
            return c if order is None else int(order[c])

        # highest logical significance first: MSB-plane faults flip the
        # largest magnitudes, so they get the budget first
        for c in sorted(bad_cols, key=logical, reverse=True):
            if logical(c) < self.cfg.tolerate_cols:
                # bit stucking: a low-order faulty column stays unrepaired and
                # its bounded error becomes part of the contract
                rec.expected[s, :, c] = verify[:, c]
                rec.checksums[s, :, c] = tile_checksums(rec.expected[s : s + 1],
                                                        self.cfg.tile_bytes)[0, :, c]
                if rec.parity is not None:
                    rec.parity[s] = _xor_cols(rec.expected[s])
                rep.tolerated += 1
                continue
            free = torch.nonzero(~rec.spare_used[s]).reshape(-1)
            if free.numel():
                j = int(free[0])
                col = rec.expected[s, :, c]
                c_rm = _price(col[None, :, None], rec.spare[s, :, j][None, :, None])
                if not self._afford(c_rm, budget, spent + cost):
                    return False, cost
                rec.spare[s, :, j] = col
                rec.spare_used[s, j] = True
                rec.col_map[s, c] = self.cols + j
                self.spare_writes += c_rm
                self.pool.total_writes += c_rm
                self._round_actions += 1
                rep.remaps += 1
                rep.repair_transitions += c_rm
                cost += c_rm
            else:
                c_mig = self._migrate_section(rec, s, budget=budget, spent=spent + cost)
                if c_mig is None:
                    return False, cost
                self._round_actions += 1
                rep.migrations += 1
                rep.repair_transitions += c_mig
                cost += c_mig
                break  # the whole section is now pristine
        return True, cost

    def _migrate_section(
        self, rec: TensorRecord, s: int, *, budget: int | None, spent: int
    ) -> int | None:
        """Rewrite a whole section into the least-worn crossbar: frees its
        spares, clears its live masks and re-anchors it at the expected
        bits."""
        target = rec.expected[s].clone()
        c_mig = _price(target, torch.zeros_like(target))
        if not self._afford(c_mig, budget, spent):
            return None
        xbar = int(np.argmin(self.pool.wear_totals()))
        rec.sec_xbar[s] = xbar
        rec.stored[s] = target
        rec.reference[s] = target
        rec.stuck0[s] = 0
        rec.stuck1[s] = 0
        rec.col_map[s] = torch.arange(self.cols, dtype=torch.int32, device=target.device)
        rec.spare_used[s] = False
        rec.spare[s] = 0
        rec.checksums[s] = tile_checksums(rec.expected[s : s + 1], self.cfg.tile_bytes)[0]
        if rec.parity is not None:
            rec.parity[s] = _xor_cols(rec.expected[s])
        self._charge_pool(xbar, target, slice(0, rec.reference.shape[1]))
        return c_mig

    def _charge_pool(self, xbar: int, toggle: torch.Tensor, sl: slice) -> None:
        """Charge a physical write's per-cell wear to the owning crossbar."""
        bits = np.unpackbits(toggle.cpu().numpy(), axis=0)
        row0 = sl.start * 8
        row1 = min(row0 + bits.shape[0], self.rows)
        if row1 > row0:
            self.pool.wear[xbar, row0:row1, :] += bits[: row1 - row0].astype(np.int64)
        self.pool.total_writes += int(bits.sum())

    # -- repaired-plane refresh --------------------------------------------

    def rebuild(self, name: str) -> torch.Tensor:
        """Dequantize the tensor's current read into served weights through
        the planner's pipeline: a fully repaired tensor gives the original
        deployment's bytes."""
        from repro_torch.core import planner as _planner  # lazy: planner imports pool

        rec = self.tensors[name]
        if rec.aux is None:
            raise ValueError(
                f"tensor {name!r} has no reconstruction aux; deploy it through "
                "planner.build_deployment with integrity enabled"
            )
        arr = planes_mod.logical_from_physical(self.read(rec, transient=False), rec.col_order)
        aux = rec.aux
        flat = _planner.w_hat_from_slots(arr, aux["sign_slots"], aux["scale"], aux["offset"],
                                         aux["perm"], aux["n"], self.rows)
        return flat.reshape(aux["shape"]).to(aux["dtype"])

    def rebuild_plan(self, plan):
        """A ``DeploymentPlan`` whose deployed tensors are the current
        (possibly repaired) reads, for ``planner.deploy_params``."""
        deployed = dict(plan.deployed)
        for name in self.tensors:
            if name in deployed:
                deployed[name] = self.rebuild(name)
        return dataclasses.replace(plan, deployed=deployed)

    # -- reporting ----------------------------------------------------------

    def affected(self) -> list[str]:
        """Tensors with at least one persistent detection so far."""
        return sorted(n for n, r in self.tensors.items() if r.detections > 0)

    def transitions_full_affected(self) -> int:
        """Full-reprogram cost of every affected tensor (the repair gate's baseline)."""
        return sum(self.tensors[n].transitions_full for n in self.affected())

    def summary(self) -> dict:
        return {
            "tensors": len(self.tensors),
            "tiles": self.total_tiles,
            "spare_cols": self.cfg.spare_cols,
            "parity_col": self.cfg.parity_col,
            "pending": self.pending_faults(),
            "clean": self.clean if self.total_tiles else True,
            "spare_writes": self.spare_writes,
            "totals": self.totals.to_dict(),
        }
