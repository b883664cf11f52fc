"""Reprogramming cost model (Eq. 1 of the paper) on packed planes.

Port of ``repro.core.cost``: the cost of reprogramming a crossbar holding
bit matrix ``A`` to hold ``B`` is the number of memristors that change
state, ``popcount(A ^ B)`` over the packed words ``uint8[..., W, cols]``
(``bitslice.section_planes_packed``).  Row padding inside the words is zero
on every state, so it never costs anything.  The planner's pricing goes
through ``kernels.hamming.ops.price_pairs``; these chain-level functions
serve the paper's figures, parity checks and ad-hoc pricing.  The bool-plane
entry points pack the rows once and price the packed words: there is one
implementation.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitslice
from repro_torch.kernels.hamming.ref import popcount_bytes as popcount_u8


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
