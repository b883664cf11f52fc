"""Persistent crossbar pool: cross-tensor scheduling + per-cell wear accounting.

Port of ``repro.core.pool``.  Per-tensor pricing restarts every tensor from
L pristine crossbars; a pool instead streams a whole model through one fixed
set of crossbars and answers the endurance question: how many writes each
*physical* cell absorbs.

* ``CrossbarPool`` holds the packed crossbar content ``uint8[L, W, cols]``
  on its device (the planner's canonical packed-plane layout) and per-cell
  wear counters on the host (int64: device int32 would wrap under long
  wear histories).
* ``program(sections, chains)`` carries state across calls: the first
  program of every chain is a **cross-tensor seam**, priced from what the
  assigned crossbar holds now.  Intra-chain jobs are one ``price_pairs``
  call and the seams another (T = number of chains), both through the
  Hamming kernel on CUDA.
* Wear-leveling chain -> crossbar assignment (``leveling=``): ``"rotate"``
  starts the chain block at the least-worn crossbar; ``"lpt"`` gives the
  heaviest chains the least-worn crossbars (``schedule.lpt_assignment``
  with capacity 1, seeded by accumulated wear); ``"fault"`` steers chains
  away from crossbars whose stuck cells would flip their high-order bits
  (``nonideal.damage_matrix`` and ``fault_aware_assignment``, ties toward
  least wear), and falls back to ``"lpt"`` when no faults are injected.
* Faulty reads (``inject_faults``): a drawn ``nonideal.FaultState``
  attaches stuck-at masks per crossbar; ``PoolProgramReport.achieved_read``
  is what each section's crossbar reads back through them, equal to
  ``achieved`` byte for byte at zero fault rate.
* Integrity (``enable_integrity``): every ``program`` registers the tensor
  with an ``integrity.IntegrityManager`` (reference planes, tile checksums,
  spare columns) for the scrub / detect / repair loop.

Parity invariants (pinned by ``tests/test_torch_pool.py`` against the
reference):

(a) with the pool ``reset()`` between tensors, streaming reproduces the
    planner's per-tensor ``transitions_*`` totals — the seam from an
    all-zero pool is the pristine initial program, and the stucked walk
    shares ``stucking._pad_chains``'s key schedule;
(b) wear conservation — the per-cell wear increments of a ``program`` call
    sum exactly to its programmed transitions (seams included);
(c) the packed and bool (``program(impl="bool")``, the reference's eager
    oracle: XOR sums and the step-by-step walk on bool planes, no kernel)
    implementations agree on every output.

``PoolProgramReport.achieved`` is the resident packed state per section
after a program call; the planner dequantizes ``achieved_read`` into the
plan's ``deployed`` weights.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import bitslice, nonideal, schedule, stucking
from repro_torch.kernels._util import resolve_device
from repro_torch.kernels.hamming import ops as hamming_ops

if TYPE_CHECKING:  # CrossbarSpec lives in planner; avoid the import cycle
    from repro_torch.core.planner import CrossbarSpec


LEVELINGS = ("none", "rotate", "lpt", "fault")

DEFAULT_ENDURANCE = 1e8  # typical ReRAM cell write endurance (order of magnitude)


@dataclasses.dataclass
class PoolProgramReport:
    """Outcome of streaming one tensor's sections through the pool."""

    name: str
    assignment: np.ndarray  # int32[Lc] chain -> physical crossbar id
    seam_costs: np.ndarray  # int64[Lc] first program per chain, from pool state
    chain_totals: np.ndarray  # int64[Lc] full-reprogram totals (seam + intra)
    job_costs: np.ndarray  # int64[njobs] chain-major, seam job first per chain
    programmed_job_costs: np.ndarray  # int64[njobs] actually programmed (stucked)
    transitions_full: int  # sum(job_costs): full reprogramming from pool state
    transitions_programmed: int  # == transitions_full when p_stuck >= 1
    wear_increment_total: int
    wear_increment_max: int
    achieved: torch.Tensor  # uint8[S, W, cols] resident state per section
    # what a read returns through the pool's fault masks (== achieved when
    # no faults are injected)
    achieved_read: torch.Tensor


@dataclasses.dataclass(frozen=True)
class PoolStats:
    """Lifetime wear summary of a pool; ``exhaustion_horizon`` turns the
    worst cell into how many such histories the endurance budget allows."""

    n_crossbars: int
    cells: int  # L * rows * cols physical memristors
    tensors_seen: int
    programs: int  # crossbar program operations (jobs) executed
    total_writes: int
    max_cell_writes: int
    mean_cell_writes: float

    def exhaustion_horizon(self, endurance: float = DEFAULT_ENDURANCE) -> float:
        """How many times the observed programming history could repeat before
        the most-worn cell exceeds ``endurance`` writes (inf if unworn)."""
        if self.max_cell_writes == 0:
            return float("inf")
        return endurance / self.max_cell_writes

    def to_dict(self, endurance: float = DEFAULT_ENDURANCE) -> dict:
        d = dataclasses.asdict(self)
        d["endurance"] = endurance
        d["exhaustion_horizon"] = self.exhaustion_horizon(endurance)
        return d


def _xor_sums(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Differing cells of bool planes [..., rows, cols] -> int64[...]: the
    bool oracle's transition count (no packing, no kernel)."""
    return torch.logical_xor(a, b).sum(dim=(-2, -1), dtype=torch.int64)


class CrossbarPool:
    """L physical crossbars with persistent content and per-cell wear.

    ``state`` is packed like the planner's canonical planes
    (``uint8[L, ceil(rows/8), cols]``, rows MSB-first) and lives on the
    pool's device (CUDA unless ``device="cpu"``); ``wear`` is a host
    ``int64[L, rows, cols]`` count of programmed transitions per cell.
    """

    def __init__(self, spec: "CrossbarSpec", n_crossbars: int, *, leveling: str = "none",
                 device: str | torch.device | None = None):
        if leveling not in LEVELINGS:
            raise ValueError(f"unknown pool leveling {leveling!r}; choose from {LEVELINGS}")
        if n_crossbars < 1:
            raise ValueError("pool needs at least one crossbar")
        if spec.rows < 1 or spec.cols < 1:
            raise ValueError(
                f"crossbar geometry must be positive, got {spec.rows}x{spec.cols}"
            )
        self.spec = spec
        self.n_crossbars = int(n_crossbars)
        self.leveling = leveling
        self._words = -(-spec.rows // 8)
        self._state = torch.zeros((self.n_crossbars, self._words, spec.cols),
                                  dtype=torch.uint8, device=resolve_device(device))
        self.device = self._state.device  # with its index: "cuda" -> cuda:0
        self.wear = np.zeros((self.n_crossbars, spec.rows, spec.cols), np.int64)
        self.tensors_seen = 0
        self.programs = 0
        self.total_writes = 0
        self.faults: nonideal.FaultState | None = None
        self.integrity = None  # Optional[integrity.IntegrityManager]

    # -- faults and integrity ------------------------------------------------

    def enable_integrity(self, cfg=None):
        """Attach an :class:`~repro_torch.core.integrity.IntegrityManager`:
        every later ``program()`` registers its tensor (reference planes,
        tile checksums, spare columns) for the scrub / repair loop.
        Returns the manager (also kept on ``self.integrity``)."""
        from repro_torch.core import integrity  # local: integrity imports pool's planner

        self.integrity = integrity.IntegrityManager(self, cfg or integrity.IntegrityConfig())
        return self.integrity

    def inject_faults(self, model: nonideal.FaultModel, key: torch.Tensor | None = None):
        """Draw and attach a ``nonideal.FaultState`` (masks on the pool's
        device), deterministic per (model, key).  Every later ``program()``
        reads ``achieved_read`` through the masks, and the ``"fault"``
        leveling remaps against them.  Returns the state."""
        if key is None:
            key = prng.PRNGKey(0)
        self.faults = nonideal.inject(self.spec, self.n_crossbars, model, key, device=self.device)
        return self.faults

    def read_state(self) -> np.ndarray:
        """Host copy of the pool content as read through any fault masks."""
        if self.faults is None:
            return self.state
        return nonideal.read_packed(self._state, self.faults.stuck0, self.faults.stuck1).cpu().numpy()

    # -- introspection -----------------------------------------------------

    @property
    def state(self) -> np.ndarray:
        """Host copy of the packed pool content uint8[L, W, cols] (a copy on
        every device: it does not change when the pool is programmed again)."""
        return self._state.to("cpu", copy=True).numpy()

    def wear_totals(self) -> np.ndarray:
        """Accumulated writes per crossbar -> int64[L]."""
        return self.wear.sum(axis=(1, 2))

    def stats(self) -> PoolStats:
        return PoolStats(
            n_crossbars=self.n_crossbars,
            cells=int(self.wear.size),
            tensors_seen=self.tensors_seen,
            programs=self.programs,
            total_writes=self.total_writes,
            max_cell_writes=int(self.wear.max()),
            mean_cell_writes=float(self.wear.mean()),
        )

    def reset(self, *, wear: bool = False) -> None:
        """Zero the crossbar content (and optionally the wear history).

        Resetting content between tensors recovers the planner's per-tensor
        pristine accounting exactly (parity invariant (a)); wear normally
        survives resets.
        """
        self._state.zero_()
        if wear:
            self.wear[:] = 0
            self.tensors_seen = 0
            self.programs = 0
            self.total_writes = 0

    # -- chain -> crossbar assignment --------------------------------------

    def _assign(self, chain_costs: np.ndarray, leveling: str, packed: torch.Tensor,
                chains: list[np.ndarray]) -> np.ndarray:
        lc = chain_costs.shape[0]
        if leveling == "none":
            return np.arange(lc, dtype=np.int32)
        if leveling == "rotate":
            # seed the contiguous chain block at the least-worn crossbar
            start = int(np.argmin(self.wear_totals()))
            return ((start + np.arange(lc)) % self.n_crossbars).astype(np.int32)
        if leveling == "fault" and self.faults is not None:
            # steer damage-sensitive chains away from crossbars whose stuck
            # cells would flip their high-order bits, ties toward least wear
            damage = nonideal.damage_matrix(packed, chains, self.faults)
            return nonideal.fault_aware_assignment(damage, wear=self.wear_totals())
        # "lpt", and "fault" with no injected faults (nothing to avoid):
        # heaviest chains to least-worn crossbars, one chain per crossbar,
        # loads seeded with accumulated wear
        tids, _ = schedule.lpt_assignment(
            chain_costs, self.n_crossbars,
            initial_loads=self.wear_totals(), capacity=1,
        )
        return tids

    # -- programming -------------------------------------------------------

    def program(
        self,
        packed,
        chains: list[np.ndarray],
        *,
        p_stuck: float = 1.0,
        key: torch.Tensor | None = None,
        stuck_cols: int = 1,
        leveling: str | None = None,
        impl: str = "packed",
        name: str = "w",
    ) -> PoolProgramReport:
        """Stream one tensor's sections through the pool along ``chains``.

        ``packed`` are canonical packed planes ``uint8[S, W, cols]`` on the
        pool's device (bool planes are packed on entry), or a
        :class:`~repro_torch.core.planes.PlaneSet`, whose ``physical()``
        bits — what the crossbars hold under its codec — are programmed, so
        seams and wear see the stored layout.  Each chain is assigned a
        crossbar (``leveling=None`` defers to the pool's own setting); its
        first program reprograms whatever that crossbar holds.  State and
        wear are updated in place; every program is counted (the seam is a
        physical write).
        """
        if impl not in ("packed", "bool"):
            raise ValueError(f"unknown pool impl: {impl!r}")
        leveling = self.leveling if leveling is None else leveling
        if leveling not in LEVELINGS:
            raise ValueError(f"unknown pool leveling {leveling!r}; choose from {LEVELINGS}")
        col_order = None
        if hasattr(packed, "physical"):  # PlaneSet: program the stored bits
            col_order = packed.col_order
            packed = packed.physical()
        if packed.dtype != torch.uint8:
            packed = bitslice.pack_rows(packed)
        if packed.device != self.device:
            raise ValueError(f"sections on {packed.device}, pool on {self.device}")
        s, words, cols = packed.shape
        if (words, cols) != (self._words, self.spec.cols):
            raise ValueError(
                f"section planes {tuple(packed.shape)} do not fit pool geometry "
                f"{self.spec.rows}x{self.spec.cols}"
            )
        chains = [np.asarray(c, dtype=np.int32) for c in chains]
        lc = len(chains)
        if not 1 <= lc <= self.n_crossbars:
            raise ValueError(f"{lc} chains for a pool of {self.n_crossbars} crossbars")
        if key is None:
            key = prng.PRNGKey(0)
        rows = self.spec.rows
        full = p_stuck >= 1.0 or stuck_cols == 0
        planes = bitslice.unpack_rows(packed, rows) if impl == "bool" else None

        # --- intra-chain job costs (assignment-independent) ----------------
        prev_i, cur_i = schedule.chain_pairs(chains, include_initial=False)
        if prev_i.size:
            prev_t = torch.from_numpy(prev_i.astype(np.int64)).to(self.device)
            cur_t = torch.from_numpy(cur_i.astype(np.int64)).to(self.device)
            if impl == "bool":
                intra = _xor_sums(planes[prev_t], planes[cur_t])
            else:
                intra = hamming_ops.price_pairs(packed[prev_t], packed[cur_t])
            intra = intra.cpu().numpy().astype(np.int64)
        else:
            intra = np.zeros((0,), np.int64)
        lens = [len(c) - 1 for c in chains]
        intra_per_chain = np.split(intra, np.cumsum(lens)[:-1])
        chain_intra = np.array([x.sum() for x in intra_per_chain], np.int64)

        # --- chain -> crossbar assignment + seam pricing --------------------
        assignment = self._assign(chain_intra, leveling, packed, chains)
        firsts = torch.from_numpy(np.array([c[0] for c in chains], np.int64)).to(self.device)
        assignment_dev = torch.from_numpy(assignment.astype(np.int64)).to(self.device)
        state_assigned = self._state[assignment_dev]
        if impl == "bool":
            state_bool = bitslice.unpack_rows(state_assigned, rows)
            seam = _xor_sums(state_bool, planes[firsts])
        else:
            seam = hamming_ops.price_pairs(state_assigned, packed[firsts])
        seam = seam.cpu().numpy().astype(np.int64)
        job_costs = np.concatenate(
            [np.concatenate([seam[j : j + 1], intra_per_chain[j]]) for j in range(lc)]
        )
        chain_totals = seam + chain_intra

        # --- the physical walk: wear, final states, achieved planes ---------
        # (at p = 1 no mask is drawn: every differing cell is programmed)
        padded, valid, keys = stucking._pad_chains(chains, key.to(self.device))
        if impl == "bool":
            # the eager oracle: every step of every chain on bool planes
            counts, states_b, wear_inc = stucking.walk_bool(
                planes, padded, p_stuck, keys, stuck_cols=0 if full else stuck_cols,
                valid=valid, state0=state_bool)
            new_states = bitslice.pack_rows(states_b[:, -1])
            achieved_b = planes.clone()
            achieved_b[padded[valid]] = states_b[valid]
            achieved = bitslice.pack_rows(achieved_b)
            counts = counts.cpu().numpy()
            programmed_job_costs = np.concatenate(
                [counts[j, : len(c)] for j, c in enumerate(chains)]
            ).astype(np.int64)
        else:
            _, states, counts, wear_inc = stucking.walk_packed(
                packed, padded, p_stuck, keys, rows=rows, stuck_cols=0 if full else stuck_cols,
                include_initial=True, valid=valid, state0=state_assigned, with_wear=True,
            )
            new_states = states[:, -1]  # padding repeats a chain's last section
            if full:
                achieved = packed
                programmed_job_costs = job_costs
            else:
                # padded steps are no-ops, so the valid steps' states scatter
                # back to their sections without collisions
                achieved = packed.clone()
                achieved[padded[valid]] = states[valid]
                counts = counts.cpu().numpy()
                programmed_job_costs = np.concatenate(
                    [counts[j, : len(c)] for j, c in enumerate(chains)]
                )
        wear_inc = wear_inc.cpu().numpy().astype(np.int64)

        # --- the read through the fault masks of each section's crossbar ------
        achieved_read = achieved
        if self.faults is not None:
            sec_xbar = np.zeros(s, np.int64)
            for j, c in enumerate(chains):
                sec_xbar[c] = assignment[j]
            idx = torch.from_numpy(sec_xbar).to(self.device)
            achieved_read = nonideal.read_packed(achieved, self.faults.stuck0[idx],
                                                 self.faults.stuck1[idx])

        # --- commit ---------------------------------------------------------
        self._state[assignment_dev] = new_states
        self.wear[assignment] += wear_inc
        self.tensors_seen += 1
        self.programs += int(job_costs.shape[0])
        wear_total = int(wear_inc.sum())
        self.total_writes += wear_total

        report = PoolProgramReport(
            name=name,
            assignment=assignment,
            seam_costs=seam,
            chain_totals=chain_totals,
            job_costs=job_costs,
            programmed_job_costs=programmed_job_costs,
            transitions_full=int(job_costs.sum()),
            transitions_programmed=int(programmed_job_costs.sum()),
            wear_increment_total=wear_total,
            wear_increment_max=int(wear_inc.max()),
            achieved=achieved,
            achieved_read=achieved_read,
        )
        if self.integrity is not None:
            # reference planes + tile checksums for the scrub loop
            self.integrity.register(report, chains=chains, col_order=col_order)
        return report
