"""Paper Fig. 9 — sweeping the stucking probability p (ViT-Base, ResNet-50),
on the port: the transitions half.

``transitions_sweep`` is the reference's: the shape-faithful ViT-Base /
ResNet-50 weight sets at a 500k-weight cap per tensor, the SWS stride-1
schedule on 16 crossbars, one ``split`` of ``PRNGKey(seed)`` per p.

The reference's accuracy half (``accuracy_sweep``) deploys a *trained*
reduced LM (``benchmarks/trained_lm.py``: AdamW on a synthetic copy task)
at each p.  The port has no trainer yet (ROADMAP A.3(b)), so this module
has no accuracy half and ``run`` returns the transitions only.

  PYTHONPATH=src python -m benchmarks_torch.fig9_p_sweep [--full] [--device cpu]
"""
from __future__ import annotations

import argparse

from benchmarks_torch.common import SWEEP_CAP, banner, model_planes, save_json
from repro_torch import prng
from repro_torch.core import bitslice, schedule, stucking
from repro_torch.kernels._util import resolve_device

COLS = 10
L_CROSSBARS = 16
PS = (0.0, 0.25, 0.5, 0.75, 1.0)


def transitions_sweep(models=("vit-base", "resnet50"), *, max_elems=2_000_000, seed=0,
                      device=None):
    dev = resolve_device(device)
    max_elems = min(max_elems, SWEEP_CAP) if max_elems else 0
    out = {}
    key = prng.PRNGKey(seed, device=dev)
    for m in models:
        planes = model_planes(m, cols=COLS, sort=True, max_elems=max_elems, seed=seed,
                              device=dev)
        rows = planes.shape[1]
        packed = bitslice.pack_rows(planes)
        del planes
        chains = schedule.stride_1_chains(packed.shape[0], L_CROSSBARS)
        t_ref = None
        entry = {}
        for p in PS:
            key, sub = prng.split(key)
            totals, _ = stucking.stuck_schedule_packed(packed, chains, p, sub, rows=rows)
            t = int(totals.sum())
            if p == 1.0:
                t_ref = t
            entry[str(p)] = t
        out[m] = {
            "transitions": entry,
            "speedup_vs_p1": {k: t_ref / max(v, 1) for k, v in entry.items()},
        }
    return out


def run(*, max_elems=2_000_000, seed=0, device=None) -> dict:
    return {"transitions": transitions_sweep(max_elems=max_elems, seed=seed, device=device)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    banner("Fig. 9 — p sweep (transitions; the accuracy half needs A.3(b))")
    res = run(max_elems=0 if args.full else 2_000_000, device=args.device)
    for m, r in res["transitions"].items():
        sp = "  ".join(f"p={p}:{v:.2f}x" for p, v in r["speedup_vs_p1"].items())
        print(f"  {m:10s} {sp}")
    save_json("fig9_p_sweep", res)


if __name__ == "__main__":
    main()
