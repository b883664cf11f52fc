"""Bit-stucking-based reprogramming (§IV of the paper) on packed planes.

Port of the packed walk of ``repro.core.stucking``.  Bit stucking programs
only a random fraction ``p`` of the transitional memristors in the
lowest-order column(s); the rest keep their stale state.  The reference
walks each chain with a ``lax.scan`` over programming steps: at step ``t``
the crossbar holds ``state``, the target is ``seq[t]``, a Bernoulli mask
(one subkey per step, drawn as ``bool[rows, stuck_cols]``) selects which
transitional stuck-column bits are programmed, and padded steps
(``valid=False``) program nothing.

A Python loop of small torch ops per step cannot walk a full-width stack
(a 4-layer gemma-2b FFN tensor has ~1M sections, i.e. 16 chains of ~65k
steps), so the port walks every chain and step at once in an equivalent
closed form:

* a non-stuck cell is programmed to its target on every valid step, so its
  state is the target of the last valid step ``<= t`` (``seq[t]`` itself on
  a schedule, whose padding only trails and repeats the last section);
* a stuck-column cell becomes the target on a masked valid step and keeps
  its state otherwise, so its state at step ``t`` is the target at the last
  masked step ``<= t`` (an index ``cummax`` over steps), or the chain's
  starting content ``state0`` before any such step (pristine zero for the
  planner, the pool's persistent crossbar for ``core.pool``);
* the bits programmed at step ``t`` are ``state[t-1] ^ state[t]`` (with
  ``state[-1] = state0``), so the per-step count is their popcount
  (``include_initial=False`` drops step 0) and a cell's wear is the number
  of steps that toggle it.

States, per-chain totals, per-step counts, wear and achieved planes are
bit-identical to the scan (pinned against the reference in
``tests/test_torch_planner.py`` and ``tests/test_torch_pool.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import bitslice
from repro_torch.core.cost import popcount_u8

_MASK_CHUNK = 1 << 24  # mask elements drawn per prng call (bounds int64 temporaries)


def _pad_chains(
    chains: list[np.ndarray], key: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pad chains to equal length + validity mask + per-chain keys.

    Returns (padded int64[L, T], valid bool[L, T], keys int64[L, 2]) on the
    key's device.  Padding repeats a chain's last section and is a no-op
    step: no programming, no counted transitions, no state change.
    """
    max_len = max(int(c.shape[0]) for c in chains)
    padded = np.stack([
        np.concatenate([c, np.full(max_len - c.shape[0], c[-1], dtype=c.dtype)]) for c in chains
    ]).astype(np.int64)
    valid = np.stack([np.arange(max_len) < c.shape[0] for c in chains])
    dev = key.device
    return (torch.from_numpy(padded).to(dev), torch.from_numpy(valid).to(dev),
            prng.split(key, len(chains)))


def _step_masks(
    keys: torch.Tensor, steps: int, p: float, rows: int, stuck_cols: int
) -> torch.Tensor:
    """bool[L, T, rows, stuck_cols]: step ``t`` of chain ``l`` draws
    ``bernoulli(split(keys[l], T)[t], p, (rows, stuck_cols))``."""
    step_keys = prng.split(keys, steps)  # [L, T, 2]
    per_step = rows * stuck_cols
    chunk = max(1, _MASK_CHUNK // max(1, per_step * keys.shape[0]))
    parts = [
        prng.bernoulli(step_keys[:, t0:t0 + chunk], p, (rows, stuck_cols))
        for t0 in range(0, steps, chunk)
    ]
    return torch.cat(parts, dim=1)


def walk_packed(
    packed: torch.Tensor,
    order: torch.Tensor,
    p: float,
    keys: torch.Tensor,
    *,
    rows: int,
    stuck_cols: int,
    include_initial: bool,
    valid: torch.Tensor | None = None,
    state0: torch.Tensor | None = None,
    with_wear: bool = False,
) -> tuple[torch.Tensor, ...]:
    """Walk L crossbars at once -> (totals int64[L], states uint8[L, T, W, cols]).

    packed: uint8[S, W, cols]; order: int[L, T] section indices; keys:
    int64[L, 2] one key per chain (split into one subkey per step, as the
    reference's ``_walk_packed`` does); valid: optional bool[L, T];
    state0: optional uint8[L, W, cols], each crossbar's content before its
    first program (pristine zero by default).  ``states[l, t]`` is what
    crossbar ``l`` holds while ``order[l, t]`` is resident.  With
    ``with_wear`` the walk also returns per-step counts int64[L, T] and
    per-cell wear int32[L, rows, cols] (toggles of each cell over the walk).
    """
    n_chains, steps = order.shape
    seq = packed[order]  # [L, T, W, cols]
    if valid is None:
        valid = torch.ones((n_chains, steps), dtype=torch.bool, device=packed.device)
    if state0 is None:
        state0 = torch.zeros((n_chains,) + tuple(packed.shape[1:]), dtype=torch.uint8,
                             device=packed.device)
    t_idx = torch.arange(steps, dtype=torch.int32, device=packed.device)
    # non-stuck cells hold the target of the last valid step (state0 before)
    last_valid = torch.cummax(torch.where(valid, t_idx[None, :], -1), dim=1).values
    idx = last_valid.clamp(min=0).to(torch.int64)[:, :, None, None].expand(seq.shape)
    states = torch.where((last_valid >= 0)[:, :, None, None], torch.gather(seq, 1, idx),
                         state0[:, None])
    if stuck_cols > 0:
        mask = _step_masks(keys, steps, p, rows, stuck_cols)
        mask &= valid[:, :, None, None]
        last = torch.where(mask, t_idx[None, :, None, None], -1)
        last = torch.cummax(last, dim=1).values  # last masked step <= t, or -1
        target = bitslice.unpackbits(seq[..., :stuck_cols], -2, rows)  # [L, T, rows, sc]
        held = torch.gather(target, 1, last.clamp(min=0).to(torch.int64))
        start = bitslice.unpackbits(state0[..., :stuck_cols], -2, rows)[:, None]
        held = torch.where(last >= 0, held, start)
        states[..., :stuck_cols] = bitslice.packbits(held, -2)
    toggled = torch.cat([state0[:, None], states[:, :-1]], dim=1) ^ states
    counts = popcount_u8(toggled).sum(dim=(2, 3), dtype=torch.int64)  # [L, T]
    totals = counts.sum(dim=1) if include_initial else counts[:, 1:].sum(dim=1)
    if with_wear:
        return totals, states, counts, cell_toggles(toggled, rows)
    return totals, states


def cell_toggles(toggled: torch.Tensor, rows: int) -> torch.Tensor:
    """Per-cell toggle counts: uint8[L, T, W, cols] packed XORs of
    consecutive states -> int32[L, rows, cols], summed over T.

    Counts one bit position of the packed words at a time (row ``8w + j``
    is bit ``7 - j`` of word ``w``), so no [L, T, rows, cols] temporary is
    built.
    """
    per_bit = [((toggled >> (7 - j)) & 1).sum(dim=1, dtype=torch.int32) for j in range(8)]
    wear = torch.stack(per_bit, dim=2)  # [L, W, 8, cols]
    return wear.reshape(wear.shape[0], -1, wear.shape[-1])[:, :rows]


def stuck_schedule_packed(
    packed: torch.Tensor,
    chains: list[np.ndarray],
    p: float,
    key: torch.Tensor,
    *,
    rows: int,
    stuck_cols: int = 1,
    include_initial: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Bit stucking over every chain of a schedule.

    Returns (chain_totals int64[L], achieved uint8[S, W, cols]); chain ``l``
    walks under ``split(key, L)[l]``, as in the reference.  Each section
    belongs to exactly one chain, so the valid steps' states scatter back to
    their sections without collisions.
    """
    padded, valid, keys = _pad_chains(chains, key.to(packed.device))
    totals, states = walk_packed(
        packed, padded, p, keys, rows=rows, stuck_cols=stuck_cols,
        include_initial=include_initial, valid=valid,
    )
    achieved = packed.clone()
    achieved[padded[valid]] = states[valid]
    return totals, achieved


def stuck_schedule(
    planes: torch.Tensor,
    chains: list[np.ndarray],
    p: float,
    key: torch.Tensor,
    *,
    stuck_cols: int = 1,
    include_initial: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`stuck_schedule_packed` on bool planes[S, rows, cols].

    Returns (total int64[], achieved bool[S, rows, cols]): the reference's
    bool-plane entry point, on the packed walk (same padding and key
    schedule), with the total summed over the chains in int64.
    """
    rows = planes.shape[1]
    totals, achieved = stuck_schedule_packed(
        bitslice.pack_rows(planes), chains, p, key, rows=rows, stuck_cols=stuck_cols,
        include_initial=include_initial,
    )
    return totals.sum(), bitslice.unpack_rows(achieved, rows)


def expected_saving_fraction(
    planes: torch.Tensor, order, p: float, *, stuck_cols: int = 1
) -> torch.Tensor:
    """Analytic expected fraction of chain transitions avoided by stucking.

    ``(1 - p) * (transitions in the stuck columns) / (all transitions)`` along
    ``order`` of bool planes[S, rows, cols], in float32 as the reference
    computes it: ``float32(1 - p)`` times the stuck columns' count, over the
    count of all columns floored at 1 (counts are exact below 2**24).
    """
    seq = bitslice.pack_rows(planes)[order]
    col = popcount_u8(seq[1:] ^ seq[:-1]).sum(dim=(0, 1), dtype=torch.int64)
    total = torch.clamp(col.sum().to(torch.float32), min=1.0)
    saved = torch.tensor(1.0 - p, dtype=torch.float32, device=planes.device)
    saved = saved * col[:stuck_cols].sum().to(torch.float32)
    return (saved.to(torch.float64) / total.to(torch.float64)).to(torch.float32)
