"""Paper Fig. 8 — bit-stucking speedup: p=0.5 over p=1 (full
reprogramming), on the port.

Reprogramming the SWS stride-1 schedule with only half the transitional
memristors in the lowest-order column actually programmed.  Paper band:
+19% (AlexNet) to +27% (DeiT-Base) fewer transitions.  The reference's key
schedule: one ``split`` of ``PRNGKey(seed)`` per model, the same subkey for
p=1 and p.

  PYTHONPATH=src python -m benchmarks_torch.fig8_stucking [--full] [--p P] [--device cpu]
"""
from __future__ import annotations

import argparse

from benchmarks_torch.common import PAPER_DEFAULT_MODELS, banner, model_planes, save_json
from repro_torch import prng
from repro_torch.core import schedule, stucking
from repro_torch.kernels._util import resolve_device

COLS = 10
L_CROSSBARS = 16
PAPER_BAND = "  [paper check] band: 19% (AlexNet) .. 27% (DeiT-Base)"


def run(models=None, *, p=0.5, max_elems=2_000_000, seed=0, device=None) -> dict:
    dev = resolve_device(device)
    models = models or PAPER_DEFAULT_MODELS
    key = prng.PRNGKey(seed, device=dev)
    results = {}
    for m in models:
        planes = model_planes(m, cols=COLS, sort=True, max_elems=max_elems, seed=seed,
                              device=dev)
        chains = schedule.stride_1_chains(planes.shape[0], L_CROSSBARS)
        key, sub = prng.split(key)
        t_full, _ = stucking.stuck_schedule(planes, chains, 1.0, sub)
        t_half, _ = stucking.stuck_schedule(planes, chains, p, sub)
        results[m] = {
            "p": p,
            "transitions_p1": int(t_full),
            "transitions_p": int(t_half),
            "speedup_pct": 100.0 * (int(t_full) - int(t_half)) / int(t_full),
        }
    return results


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--p", type=float, default=0.5)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    banner(f"Fig. 8 — bit stucking p={args.p} vs p=1")
    res = run(p=args.p, max_elems=0 if args.full else 2_000_000, device=args.device)
    for m, r in res.items():
        print(f"  {m:12s} saves {r['speedup_pct']:5.1f}% of transitions")
    save_json("fig8_stucking", res)
    print(PAPER_BAND)


if __name__ == "__main__":
    main()
