"""Paper Fig. 7 — greedy similar-cost grouping with 64 programming threads,
on the port.

Lockstep-rounds model (§III.C): each round programs one crossbar per thread
and lasts as long as its slowest job.  Unsorted arrival order mixes small
and large jobs per round (VGGs suffer most — disparate layer magnitudes);
the greedy sort groups similar costs and approaches the ideal 64x.  The
jobs are priced by B1 (``price_pairs``) on the card.

  PYTHONPATH=src python -m benchmarks_torch.fig7_greedy [--full] [--device cpu]
"""
from __future__ import annotations

import argparse

from benchmarks_torch.common import PAPER_DEFAULT_MODELS, banner, model_planes, save_json
from repro_torch.core import schedule
from repro_torch.kernels._util import resolve_device

COLS = 10
THREADS = 64


def run(models=None, *, max_elems=2_000_000, seed=0, device=None) -> dict:
    dev = resolve_device(device)
    models = models or PAPER_DEFAULT_MODELS
    results = {}
    for m in models:
        planes = model_planes(m, cols=COLS, sort=True, max_elems=max_elems, seed=seed,
                              device=dev)
        chains = schedule.stride_1_chains(planes.shape[0], THREADS)
        jobs = schedule.schedule_job_costs(planes, chains)
        del planes
        sp_u = float(schedule.lockstep_speedup(jobs, THREADS, sort_jobs=False))
        sp_g = float(schedule.lockstep_speedup(jobs, THREADS, sort_jobs=True))
        results[m] = {
            "n_jobs": int(jobs.shape[0]),
            "speedup_unsorted": sp_u,
            "speedup_greedy": sp_g,
            "ideal": float(THREADS),
        }
    return results


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    banner(f"Fig. 7 — greedy thread balancing ({THREADS} threads)")
    res = run(max_elems=0 if args.full else 2_000_000, device=args.device)
    for m, r in res.items():
        print(
            f"  {m:12s} unsorted={r['speedup_unsorted']:5.1f}x  "
            f"greedy={r['speedup_greedy']:5.1f}x  (ideal {THREADS}x)"
        )
    save_json("fig7_greedy", res)


if __name__ == "__main__":
    main()
