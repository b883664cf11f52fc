"""Incremental re-deployment across training checkpoints (port of ``repro.core.redeploy``).

During training the deployed weights drift; refreshing the crossbars with a
new checkpoint is itself a reprogramming workload.  ``delta_cost`` prices
it with and without SWS: in-place rewrites (old planes -> new planes, per
section), the streaming chain of the new checkpoint in its natural order,
in the old checkpoint's sort order (stale SWS) and re-sorted (fresh SWS),
and, with a persistent ``CrossbarPool``, the stale-SWS refresh through the
pool, which seats ``w_old`` first when the pool is pristine.

Every count is priced on packed planes through
``kernels.hamming.ops.price_pairs`` (kernel B1 on CUDA) and the pool's own
pricing; the integers equal the reference's (``tests/test_torch_train.py``).
Used by ``runtime.TrainLoop`` when ``redeploy_every > 0``.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import torch
import torch.nn.functional as F

from repro_torch.core import bitslice, schedule
from repro_torch.core.planner import CrossbarSpec, PlannerConfig, _perm_full_with_inverse
from repro_torch.kernels.hamming import ops as hamming_ops

if TYPE_CHECKING:
    from repro_torch.core.pool import CrossbarPool


@dataclasses.dataclass
class RedeployReport:
    name: str
    transitions_natural: int  # reprogram in-place, natural layout
    transitions_sws: int  # reprogram in-place, SWS layout (old perm kept)
    n_bits: int  # physical memristors holding real weights (upper bound on transitions)
    # streaming-chain costs of the NEW checkpoint through a crossbar pool:
    chain_natural: int = 0  # natural layout
    chain_stale_sws: int = 0  # the OLD checkpoint's sort order (index map kept)
    chain_fresh_sws: int = 0  # re-sorted on the new weights (new index map)
    chain_pool: int = 0  # stale-SWS refresh through a persistent CrossbarPool

    @property
    def sws_delta_speedup(self) -> float:
        """In-place rewrite cost ratio: 1.0 by construction (summed Hamming
        distance is permutation-invariant), a check of the index matching."""
        return self.transitions_natural / max(self.transitions_sws, 1)

    @property
    def stale_sort_speedup(self) -> float:
        """Streaming speedup of keeping the old sort across a checkpoint."""
        return self.chain_natural / max(self.chain_stale_sws, 1)

    @property
    def fresh_sort_speedup(self) -> float:
        return self.chain_natural / max(self.chain_fresh_sws, 1)


def _pairs_total(a: torch.Tensor, b: torch.Tensor) -> int:
    return int(hamming_ops.price_pairs(a, b).sum(dtype=torch.int64))


def _chain_total(packed: torch.Tensor) -> int:
    """Sections programmed one after another on one crossbar from pristine."""
    first = _pairs_total(packed[:1], torch.zeros_like(packed[:1]))
    return first + _pairs_total(packed[1:], packed[:-1])


def delta_cost(
    w_old: torch.Tensor,
    w_new: torch.Tensor,
    spec: CrossbarSpec = CrossbarSpec(),
    config: PlannerConfig = PlannerConfig(),
    name: str = "w",
    *,
    pool: "CrossbarPool | None" = None,
) -> RedeployReport:
    """Price reprogramming crossbars holding ``w_old`` to hold ``w_new`` (on
    their device; a pool must live there too).

    The SWS path keeps the *old* checkpoint's permutation; the shared scale
    is re-fit on the new tensor.  With ``pool``, the new checkpoint is also
    programmed (stale-SWS layout, full reprogramming) through the persistent
    pool: ``chain_pool`` prices the multi-crossbar stream from what the pool
    holds, and its wear counters absorb the refresh.
    """
    rows, cols = spec.rows, spec.cols
    fo = w_old.reshape(-1).to(torch.float32)
    fn = w_new.reshape(-1).to(w_old.device, torch.float32)
    pad = (-fo.shape[0]) % rows
    fo_p, fn_p = F.pad(fo, (0, pad)), F.pad(fn, (0, pad))
    qo = F.pad(bitslice.quantize(fo, cols, spec.encoding).q, (0, pad))
    qn = F.pad(bitslice.quantize(fn, cols, spec.encoding).q, (0, pad))

    def planes(q, perm):
        return bitslice.section_planes_packed(q if perm is None else q[perm], rows, cols)

    def transitions(perm):
        return _pairs_total(planes(qo, perm), planes(qn, perm))

    perm_stale = _perm_full_with_inverse(fo_p, spec, config, qo)[0]
    perm_fresh = _perm_full_with_inverse(fn_p, spec, config, qn)[0]

    chain_pool = 0
    if pool is not None:
        s = fo_p.shape[0] // rows
        chains = schedule.make_chains(s, max(1, min(config.crossbars, s)), config.schedule)
        if pool.tensors_seen == 0:
            # a pristine pool has never held w_old: seat it first, so the
            # refresh seams come from resident content and the wear counters
            # include the initial deployment's writes
            pool.program(planes(qo, perm_stale), chains, p_stuck=1.0,
                         leveling=config.pool_leveling, name=f"{name}@deploy")
        chain_pool = pool.program(planes(qn, perm_stale), chains, p_stuck=1.0,
                                  leveling=config.pool_leveling, name=name).transitions_full

    return RedeployReport(
        name=name,
        transitions_natural=transitions(None),
        transitions_sws=transitions(perm_stale),
        # unpadded count: zero padding never transitions
        n_bits=int(fo.shape[0]) * cols,
        chain_natural=_chain_total(planes(qn, None)),
        chain_stale_sws=_chain_total(planes(qn, perm_stale)),
        chain_fresh_sws=_chain_total(planes(qn, perm_fresh)),
        chain_pool=chain_pool,
    )
