"""Sorted Weight Sectioning (SWS) for crossbar reprogramming (§III of the paper).

Port of ``repro.core.sws``.  Weights are sorted by magnitude once, offline,
then partitioned into crossbar-sized sections; consecutive sorted sections
hold near-identical high-order bit patterns, so programming them in order
minimizes memristor state transitions.  The sort permutation and its
inverse give exact index matching back to the logical layout.

The reference's host ``pure_callback`` sort works around XLA:CPU's slow
comparison sort; a stable sort yields the identical permutation on any
route.  The planner's weight permutation goes through
``kernels.sws_sort`` (CUB's radix sort on the card, into int32, whose plain
version is ``torch.sort(stable=True)``); the rest here sorts with
``torch.sort(stable=True)``.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitslice
from repro_torch.kernels.hamming import ops as hamming_ops


def stable_argsort(keys: torch.Tensor, *, with_inverse: bool = False):
    """Stable ascending argsort (int64) (+ its inverse permutation).

    Ties keep their original order, as ``jnp.argsort(stable=True)`` does;
    ``|w|`` keys make -0.0 and +0.0 equal ties.
    """
    perm = torch.sort(keys, stable=True).indices
    if not with_inverse:
        return perm
    return perm, inverse_permutation(perm)


def sws_permutation(flat: torch.Tensor) -> torch.Tensor:
    """Sort permutation by |w|, ascending (small -> large)."""
    return stable_argsort(flat.abs())


def inverse_permutation(perm: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], dtype=perm.dtype, device=perm.device)
    return inv


def sorted_sections(flat: torch.Tensor, rows: int) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Sort + section: returns (sections[S, rows], perm[n], n)."""
    perm = sws_permutation(flat)
    sections, n = bitslice.section(flat[perm], rows)
    return sections, perm, n


def restore_flat(sections: torch.Tensor, perm: torch.Tensor, n: int) -> torch.Tensor:
    """Undo sort + section: sections[S, rows] -> flat[n] in logical order."""
    return bitslice.unsection(sections, n)[inverse_permutation(perm)]


def tsp_greedy_order(packed_planes: torch.Tensor, *, start: int = 0) -> torch.Tensor:
    """Beyond-paper: nearest-neighbour section order on true Hamming distance.

    packed_planes: uint8[S, W, cols].  Returns an int64[S] visiting order
    from ``start``: each step prices the current section against all S
    (``price_pairs``, the Hamming kernel on CUDA), masks the visited ones
    with int32 max and moves to the first nearest, the tie rule of the
    reference's ``jnp.argmin``.  O(S^2) work in S - 1 steps, meant for
    per-tensor section counts up to a few thousand.
    """
    s = packed_planes.shape[0]
    dev = packed_planes.device
    visited = torch.zeros((s,), dtype=torch.bool, device=dev)
    order = torch.empty((s,), dtype=torch.int64, device=dev)
    order[0] = current = start
    visited[start] = True
    big = torch.iinfo(torch.int32).max
    for i in range(1, s):
        d = hamming_ops.price_pairs(packed_planes[current].expand_as(packed_planes), packed_planes)
        nxt = torch.argmin(d.masked_fill(visited, big))
        order[i] = nxt
        visited[nxt] = True
        current = nxt
    return order


def section_norm_order(sections: torch.Tensor, *, descending: bool = False) -> torch.Tensor:
    """Order *pre-formed* sections[S, rows] by mean |w| (scheduling-only SWS).

    For layouts that cannot be permuted element-wise: sections keep their
    membership and only the programming order is sorted, stably (ties keep
    section order, also under ``descending``).  Weaker than full SWS;
    provided for ablation.
    """
    key = sections.abs().mean(dim=-1)
    return stable_argsort(-key if descending else key)
