"""Multi-crossbar reprogramming schedules and thread balancing (§III.B–C).

Port of ``repro.core.schedule``.  Given S sections (in SWS order) and L
crossbars programmed in parallel, a schedule gives each crossbar a chain of
sections to walk:

* **stride-L** — crossbar ``i`` programs sections ``i, i+L, i+2L, …``;
* **stride-1** — crossbar ``i`` walks the ``i``-th contiguous block of the
  sorted list (the paper's winning schedule).

Chains are host numpy arrays (static structure from section counts).
Pricing flattens every chain step into one batched ``(prev, cur)`` pairs
array and prices it with ONE ``price_pairs`` call — the Hamming kernel on
CUDA, its plain version on the CPU.  Totals are aggregated on the host in
int64.
"""
from __future__ import annotations

import heapq
import math

import numpy as np
import torch

from repro_torch.core import bitslice
from repro_torch.kernels.hamming import ops as hamming_ops


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

def stride_l_chains(s: int, l: int) -> list[np.ndarray]:
    """Chains for stride-L scheduling: chains[i] = [i, i+L, i+2L, ...]."""
    return [np.arange(i, s, l, dtype=np.int32) for i in range(min(l, s))]


def stride_1_chains(s: int, l: int) -> list[np.ndarray]:
    """Chains for stride-1 scheduling: L contiguous blocks of the sorted list."""
    block = math.ceil(s / l)
    chains = []
    for i in range(l):
        lo, hi = i * block, min((i + 1) * block, s)
        if lo >= hi:
            break
        chains.append(np.arange(lo, hi, dtype=np.int32))
    return chains


def make_chains(s: int, l: int, kind: str) -> list[np.ndarray]:
    if kind == "stride1":
        return stride_1_chains(s, l)
    if kind == "strideL":
        return stride_l_chains(s, l)
    raise ValueError(f"unknown schedule kind: {kind!r}")


# ---------------------------------------------------------------------------
# Batched pair pricing
# ---------------------------------------------------------------------------

def chain_pairs(
    chains: list[np.ndarray], *, include_initial: bool = True
) -> tuple[np.ndarray, np.ndarray]:
    """Flatten chains into one batched (prev, cur) job-index array.

    Job ``i`` reprograms a crossbar holding section ``prev[i]`` with section
    ``cur[i]``; ``prev == -1`` is the pristine all-zero crossbar.  Jobs come
    chain by chain in walk order.
    """
    prevs, curs = [], []
    for c in chains:
        c = np.asarray(c, dtype=np.int32)
        if include_initial:
            prevs.append(np.concatenate([np.array([-1], np.int32), c[:-1]]))
            curs.append(c)
        else:
            prevs.append(c[:-1])
            curs.append(c[1:])
    if not prevs:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    return np.concatenate(prevs), np.concatenate(curs)


def _as_packed(planes: torch.Tensor) -> torch.Tensor:
    """Accept bool[S, rows, cols] or packed uint8[S, W, cols] planes."""
    return planes if planes.dtype == torch.uint8 else bitslice.pack_rows(planes)


def schedule_job_costs(
    planes: torch.Tensor, chains: list[np.ndarray], *, include_initial: bool = True
) -> torch.Tensor:
    """Flat per-job costs (one job = one crossbar reprogram) -> int32[njobs].

    planes: bool[S, rows, cols] (packed here) or canonical packed planes
    uint8[S, W, cols].  All chain steps are priced in ONE batched
    ``price_pairs`` call.
    """
    packed = _as_packed(planes)
    prev, cur = chain_pairs(chains, include_initial=include_initial)
    if prev.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.int32, device=packed.device)
    # the pristine all-zero state sits at index 0, so prev == -1 gathers zeros
    states = torch.cat([torch.zeros_like(packed[:1]), packed], dim=0)
    prev_t = torch.from_numpy(prev.astype(np.int64) + 1).to(packed.device)
    cur_t = torch.from_numpy(cur.astype(np.int64) + 1).to(packed.device)
    return hamming_ops.price_pairs(states[prev_t], states[cur_t])


def schedule_transitions(
    planes: torch.Tensor, chains: list[np.ndarray], *, include_initial: bool = True
) -> torch.Tensor:
    """Total transitions across all crossbars -> int64[] (sum over chains)."""
    return schedule_job_costs(planes, chains, include_initial=include_initial).sum(
        dtype=torch.int64)


# ---------------------------------------------------------------------------
# Thread balancing
# ---------------------------------------------------------------------------

def lockstep_time(job_costs: torch.Tensor, threads: int, *, sort_jobs: bool) -> torch.Tensor:
    """Lockstep-rounds total time: sum over rounds of the round's max cost."""
    costs = job_costs.to(torch.int64)
    if sort_jobs:
        costs = torch.sort(costs, descending=True).values
    pad = (-costs.shape[0]) % threads
    costs = torch.nn.functional.pad(costs, (0, pad))
    if costs.numel() == 0:
        return torch.zeros((), dtype=torch.int64, device=costs.device)
    return costs.reshape(-1, threads).max(dim=1).values.sum()


def lockstep_speedup(job_costs: torch.Tensor, threads: int, *, sort_jobs: bool) -> torch.Tensor:
    """Parallel speedup vs programming all jobs sequentially on one engine.

    float32, as the reference computes it: the sum and the lockstep time
    cast to float32, the time floored at 1, one float32 division (taken in
    float64 and rounded once more, which is exact for a quotient).
    """
    seq = job_costs.sum(dtype=torch.int64).to(torch.float32)
    t = lockstep_time(job_costs, threads, sort_jobs=sort_jobs).to(torch.float32)
    quotient = seq.to(torch.float64) / torch.clamp(t, min=1.0).to(torch.float64)
    return quotient.to(torch.float32)


def lockstep_time_host(job_costs, threads: int, *, sort_jobs: bool) -> np.int64:
    """Host int64 twin of :func:`lockstep_time` (same algorithm, same values)."""
    costs = np.asarray(job_costs, dtype=np.int64)
    if sort_jobs:
        costs = np.sort(costs)[::-1]
    pad = (-costs.shape[0]) % threads
    if pad:
        costs = np.concatenate([costs, np.zeros(pad, np.int64)])
    rounds = costs.reshape(-1, threads)
    return np.sum(rounds.max(axis=1), dtype=np.int64) if rounds.size else np.int64(0)


def lpt_assignment(
    job_costs,
    threads: int,
    *,
    initial_loads: np.ndarray | None = None,
    capacity: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Longest-processing-time greedy makespan balancing (host, int64).

    Returns (thread_id int32[njobs], thread_loads int64[threads]); ties
    break toward the lowest thread id.  ``initial_loads`` seeds each
    thread's load; ``capacity`` bounds the jobs one thread may take.
    """
    costs = np.asarray(job_costs, dtype=np.int64)
    if capacity is not None and costs.shape[0] > threads * capacity:
        raise ValueError(
            f"{costs.shape[0]} jobs exceed {threads} threads x capacity {capacity}"
        )
    order = np.argsort(-costs, kind="stable")
    tids = np.empty(costs.shape[0], np.int32)
    if initial_loads is None:
        loads = np.zeros(threads, np.int64)
    else:
        loads = np.asarray(initial_loads, dtype=np.int64).copy()
        if loads.shape != (threads,):
            raise ValueError(f"initial_loads shape {loads.shape} != ({threads},)")
    taken = np.zeros(threads, np.int64)
    heap = [(int(loads[t]), t) for t in range(threads)]
    heapq.heapify(heap)
    for j in order:
        while True:
            load, t = heapq.heappop(heap)
            if capacity is None or taken[t] < capacity:
                break
        taken[t] += 1
        tids[j] = t
        loads[t] = load + int(costs[j])
        heapq.heappush(heap, (int(loads[t]), t))
    return tids, loads


def lpt_makespan(job_costs, threads: int) -> np.int64:
    _, loads = lpt_assignment(job_costs, threads)
    return np.max(loads)
