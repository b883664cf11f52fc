"""Reprogramming cost model (Eq. 1 of the paper) on packed planes.

Port of ``repro.core.cost``: the cost of reprogramming a crossbar holding
bit matrix ``A`` to hold ``B`` is the number of memristors that change
state, ``popcount(A ^ B)`` over the packed words ``uint8[..., W, cols]``
(``bitslice.section_planes_packed``).  Row padding inside the words is zero
on every state, so it never costs anything.  The planner's pricing goes
through ``kernels.hamming.ops.price_pairs``; these chain-level functions
serve the paper's figures, parity checks and ad-hoc pricing.  The bool-plane
entry points pack the rows once and price the packed words: there is one
implementation.  The per-column fractions (the paper's §IV observation)
count integers and divide once in float32.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitslice
from repro_torch.kernels.hamming.ref import popcount_bytes as popcount_u8


def pair_transitions(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """R_AB for bool planes of identical shape [..., rows, cols] -> int32[...]."""
    return pair_transitions_packed(bitslice.packbits(a, -2), bitslice.packbits(b, -2))


def pair_transitions_packed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """R_AB for packed uint8 planes [..., words, cols] -> int32[...]."""
    return popcount_u8(torch.bitwise_xor(a, b)).sum(dim=(-2, -1), dtype=torch.int32)


def chain_transitions_packed(
    packed: torch.Tensor,
    order: torch.Tensor | None = None,
    *,
    include_initial: bool = True,
    per_column: bool = False,
) -> torch.Tensor:
    """Total transitions walking ``order`` on ONE crossbar from pristine.

    packed: uint8[S, W, cols]; returns int32[] or int32[cols] per column.
    """
    seq = packed if order is None else packed[order]
    diffs = popcount_u8(torch.bitwise_xor(seq[1:], seq[:-1]))
    dims = (0, 1) if per_column else (0, 1, 2)
    total = diffs.sum(dim=dims, dtype=torch.int32)
    if include_initial:
        first = popcount_u8(seq[0])
        total = total + (first.sum(dim=0, dtype=torch.int32) if per_column
                         else first.sum(dtype=torch.int32))
    return total


def consecutive_costs_packed(
    packed: torch.Tensor, order: torch.Tensor | None = None, *, include_initial: bool = True
) -> torch.Tensor:
    """Per-step reprogramming costs along a chain -> int32[T] (or [T-1])."""
    seq = packed if order is None else packed[order]
    step = popcount_u8(torch.bitwise_xor(seq[1:], seq[:-1])).sum(dim=(1, 2), dtype=torch.int32)
    if include_initial:
        first = popcount_u8(seq[0]).sum(dtype=torch.int32).reshape(1)
        step = torch.cat([first, step])
    return step


def chain_transitions(
    planes: torch.Tensor,
    order: torch.Tensor | None = None,
    *,
    include_initial: bool = True,
    per_column: bool = False,
) -> torch.Tensor:
    """Total transitions programming bool planes[S, rows, cols] along
    ``order`` on ONE crossbar from pristine -> int32[] (or int32[cols])."""
    return chain_transitions_packed(bitslice.pack_rows(planes), order,
                                    include_initial=include_initial, per_column=per_column)


def consecutive_costs(
    planes: torch.Tensor, order: torch.Tensor | None = None, *, include_initial: bool = True
) -> torch.Tensor:
    """Per-step costs along a chain of bool planes[S, rows, cols] -> int32[T]
    (or [T-1]); step 0 programs over the pristine crossbar."""
    return consecutive_costs_packed(bitslice.pack_rows(planes), order,
                                    include_initial=include_initial)


def active_fraction_per_column(planes: torch.Tensor) -> torch.Tensor:
    """Fraction of active memristors per bit column of bool planes[..., cols]
    -> f32[cols]: ~0.5 in the lowest-order column of bell-shaped weights,
    falling toward 0 in the high-order ones.  The active count is exact and
    divided once in float32 (the reference's f32 mean, exact while a
    column holds fewer than 2^24 cells)."""
    dims = tuple(range(planes.ndim - 1))
    n = torch.tensor(float(max(planes[..., 0].numel(), 1)), device=planes.device)
    return planes.sum(dim=dims, dtype=torch.int64).to(torch.float32) / n


def transition_fraction_per_column(planes: torch.Tensor,
                                   order: torch.Tensor | None = None) -> torch.Tensor:
    """Per-column share of the transitions between consecutive sections of
    bool planes[S, rows, cols] along ``order`` (the first program from
    pristine not counted) -> f32[cols], summing to 1 (all 0 for a chain
    without a transition)."""
    col = chain_transitions(planes, order, include_initial=False, per_column=True)
    return col.to(torch.float32) / torch.clamp(col.sum().to(torch.float32), min=1.0)
