"""Paper Fig. 9 — sweeping the stucking probability p (ViT-Base, ResNet-50), on the port.

Two halves, as the reference's:

* ``transitions_sweep``: the shape-faithful ViT-Base / ResNet-50 weight
  sets at a 500k-weight cap per tensor, the SWS stride-1 schedule on 16
  crossbars, one ``split`` of ``PRNGKey(seed)`` per p;
* ``accuracy_sweep``: the trained reduced LM (``trained_lm``) deployed at
  each p (128x10 crossbars, min_size 1024), its next-token accuracy and the
  plan's total speedup.  ``lm`` swaps in other weights (e.g. the
  reference's, ``trained_lm.reference_lm``); ``record`` collects each
  evaluation's predictions and each plan's totals.

  PYTHONPATH=src python -m benchmarks_torch.fig9_p_sweep [--full] [--device cpu]
"""
from __future__ import annotations

import argparse

from benchmarks_torch.common import SWEEP_CAP, banner, model_planes, save_json
from benchmarks_torch.trained_lm import eval_accuracy, get_trained_lm
from repro_torch import prng
from repro_torch.core import bitslice, schedule, stucking
from repro_torch.core.planner import CrossbarSpec, PlannerConfig, build_deployment, deploy_params
from repro_torch.kernels._util import resolve_device

ROWS = 128
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


def accuracy_sweep(seed=0, device=None, *, lm=None, record: dict | None = None):
    dev = resolve_device(device)
    cfg, params, batch_fn = lm or get_trained_lm(seed=seed, device=dev)
    acc_fp = eval_accuracy(cfg, params, batch_fn, record=record, label="fp")
    out = {"fp_accuracy": acc_fp, "per_p": {}}
    for p in PS:
        plan = build_deployment(
            params, CrossbarSpec(rows=ROWS, cols=COLS),
            PlannerConfig(p_stuck=p, min_size=1024, seed=seed), device=dev,
        )
        acc = eval_accuracy(cfg, deploy_params(params, plan), batch_fn, record=record,
                            label=f"p={p}")
        if record is not None:
            record[f"p={p}"]["totals"] = plan.totals()
        out["per_p"][str(p)] = {
            "accuracy": acc,
            "drop_pct": 100.0 * (acc_fp - acc),
            "total_speedup": plan.totals()["total_speedup"],
        }
    return out


def run(*, max_elems=2_000_000, seed=0, device=None) -> dict:
    return {
        "transitions": transitions_sweep(max_elems=max_elems, seed=seed, device=device),
        "accuracy": accuracy_sweep(seed=seed, device=device),
    }


def print_accuracy(acc: dict) -> None:
    print(f"  trained-LM fp accuracy: {acc['fp_accuracy']:.4f}")
    for p, r in acc["per_p"].items():
        print(f"    p={p}: acc={r['accuracy']:.4f} (drop {r['drop_pct']:+.2f}%) "
              f"deploy-speedup={r['total_speedup']:.2f}x")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    banner("Fig. 9 — p sweep (speedup + accuracy)")
    res = run(max_elems=0 if args.full else 2_000_000, device=args.device)
    for m, r in res["transitions"].items():
        sp = "  ".join(f"p={p}:{v:.2f}x" for p, v in r["speedup_vs_p1"].items())
        print(f"  {m:10s} {sp}")
    print_accuracy(res["accuracy"])
    save_json("fig9_p_sweep", res)


if __name__ == "__main__":
    main()
