"""Paper Fig. 6 — stride-L vs stride-1 scheduling, 16 reprogrammable
crossbars, on the port.

Total reprogramming speedup vs the unsorted baseline under both schedules,
sweeping the stride parameter L of the stride-L method.  Paper finding:
speedup decays with L; stride-1 is best (ViT-Base stride-1 ~3x better than
stride L=4).  Every schedule is priced by B1 (``price_pairs``) on the card.

  PYTHONPATH=src python -m benchmarks_torch.fig6_strides [--full] [--device cpu]
"""
from __future__ import annotations

import argparse

from benchmarks_torch.common import banner, model_planes, save_json
from repro_torch.core import bitslice, schedule
from repro_torch.kernels._util import resolve_device

COLS = 10
L_CROSSBARS = 16


def run(models=None, *, strides=(1, 2, 4, 8, 16), max_elems=2_000_000, seed=0,
        device=None) -> dict:
    dev = resolve_device(device)
    models = models or ["resnet50", "vit-base"]
    results = {}
    for m in models:
        planes_u = model_planes(m, cols=COLS, sort=False, max_elems=max_elems, seed=seed,
                                device=dev)
        s = planes_u.shape[0]
        base = int(
            schedule.schedule_transitions(planes_u, schedule.stride_1_chains(s, L_CROSSBARS))
        )
        del planes_u
        planes_s = bitslice.pack_rows(  # packed once for the six schedules
            model_planes(m, cols=COLS, sort=True, max_elems=max_elems, seed=seed, device=dev))
        entry = {"baseline_unsorted": base, "strideL": {}, "stride1": None}
        for l in strides:
            tl = int(schedule.schedule_transitions(planes_s, schedule.stride_l_chains(s, l)))
            entry["strideL"][str(l)] = {"transitions": tl, "speedup": base / max(tl, 1)}
        t1 = int(schedule.schedule_transitions(planes_s, schedule.stride_1_chains(s, L_CROSSBARS)))
        entry["stride1"] = {"transitions": t1, "speedup": base / max(t1, 1)}
        results[m] = entry
    return results


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    banner(f"Fig. 6 — stride-L vs stride-1 ({L_CROSSBARS} crossbars)")
    res = run(max_elems=0 if args.full else 2_000_000, device=args.device)
    for m, r in res.items():
        ls = "  ".join(f"L={l}:{v['speedup']:.2f}x" for l, v in r["strideL"].items())
        print(f"  {m:10s} strideL[{ls}]  stride1: {r['stride1']['speedup']:.2f}x")
    save_json("fig6_strides", res)


if __name__ == "__main__":
    main()
