"""Paper Fig. 10 — sweeping crossbar columns (bitwidth) at p=0.5, on the
port: the transitions half.

``transitions_sweep`` is the reference's: speedup (p=1 over p=0.5 on the
SWS stride-1 schedule, 16 crossbars) per column count, on the ViT-Base /
ResNet-50 weight sets at a 500k-weight cap per tensor, with one
``split(key, 3)`` per column count (one subkey for p=1, one for p).

The reference's accuracy half (``accuracy_sweep``) deploys a *trained*
reduced LM (``benchmarks/trained_lm.py``) at each column count.  The port
has no trainer yet (ROADMAP A.3(b)), so this module has no accuracy half
and ``run`` returns the transitions only.

  PYTHONPATH=src python -m benchmarks_torch.fig10_columns [--full] [--device cpu]
"""
from __future__ import annotations

import argparse

from benchmarks_torch.common import SWEEP_CAP, banner, model_planes, save_json
from repro_torch import prng
from repro_torch.core import bitslice, schedule, stucking
from repro_torch.kernels._util import resolve_device

L_CROSSBARS = 16
COLS_SWEEP = (4, 6, 8, 10, 12, 14, 16)
P = 0.5


def transitions_sweep(models=("vit-base", "resnet50"), *, max_elems=2_000_000, seed=0,
                      device=None):
    dev = resolve_device(device)
    max_elems = min(max_elems, SWEEP_CAP) if max_elems else 0
    out = {}
    key = prng.PRNGKey(seed, device=dev)
    for m in models:
        entry = {}
        for cols in COLS_SWEEP:
            planes = model_planes(m, cols=cols, sort=True, max_elems=max_elems, seed=seed,
                                  device=dev)
            rows = planes.shape[1]
            packed = bitslice.pack_rows(planes)
            del planes
            chains = schedule.stride_1_chains(packed.shape[0], L_CROSSBARS)
            key, k1, k2 = prng.split(key, 3)
            t1 = int(stucking.stuck_schedule_packed(packed, chains, 1.0, k1, rows=rows)[0].sum())
            tp = int(stucking.stuck_schedule_packed(packed, chains, P, k2, rows=rows)[0].sum())
            entry[str(cols)] = {
                "transitions_p1": t1,
                "transitions_p": tp,
                "speedup_p1_over_p": t1 / max(tp, 1),
            }
        out[m] = entry
    return out


def run(*, max_elems=2_000_000, seed=0, device=None) -> dict:
    return {"transitions": transitions_sweep(max_elems=max_elems, seed=seed, device=device)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    banner(f"Fig. 10 — column sweep at p={P} (transitions; the accuracy half needs A.3(b))")
    res = run(max_elems=0 if args.full else 2_000_000, device=args.device)
    for m, entry in res["transitions"].items():
        sp = "  ".join(f"{c}:{v['speedup_p1_over_p']:.2f}x" for c, v in entry.items())
        print(f"  {m:10s} {sp}")
    save_json("fig10_columns", res)


if __name__ == "__main__":
    main()
