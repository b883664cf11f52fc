"""Sorted Weight Sectioning (SWS) for crossbar reprogramming (§III of the paper).

Port of ``repro.core.sws``.  Weights are sorted by magnitude once, offline,
then partitioned into crossbar-sized sections; consecutive sorted sections
hold near-identical high-order bit patterns, so programming them in order
minimizes memristor state transitions.  The sort permutation and its
inverse give exact index matching back to the logical layout.

The reference's host ``pure_callback`` sort works around XLA:CPU's slow
comparison sort; a stable sort yields the identical permutation on any
route, so the port uses ``torch.sort(stable=True)`` everywhere.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitslice


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
