"""Paper Fig. 10 — sweeping crossbar columns (bitwidth) at p=0.5, on the port.

Two halves, as the reference's:

* ``transitions_sweep``: speedup (p=1 over p=0.5 on the SWS stride-1
  schedule, 16 crossbars) per column count, on the ViT-Base / ResNet-50
  weight sets at a 500k-weight cap per tensor, with one ``split(key, 3)``
  per column count (one subkey for p=1, one for p);
* ``accuracy_sweep``: the trained reduced LM (``trained_lm``) deployed at
  p=0.5 on 128-row crossbars of each column count, its next-token accuracy
  (``lm`` and ``record`` as in ``fig9_p_sweep``).

  PYTHONPATH=src python -m benchmarks_torch.fig10_columns [--full] [--device cpu]
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


def accuracy_sweep(seed=0, device=None, *, lm=None, record: dict | None = None):
    dev = resolve_device(device)
    cfg, params, batch_fn = lm or get_trained_lm(seed=seed, device=dev)
    acc_fp = eval_accuracy(cfg, params, batch_fn, record=record, label="fp")
    out = {"fp_accuracy": acc_fp, "per_cols": {}}
    for cols in COLS_SWEEP:
        plan = build_deployment(
            params, CrossbarSpec(rows=ROWS, cols=cols),
            PlannerConfig(p_stuck=P, min_size=1024, seed=seed), device=dev,
        )
        acc = eval_accuracy(cfg, deploy_params(params, plan), batch_fn, record=record,
                            label=f"cols={cols}")
        if record is not None:
            record[f"cols={cols}"]["totals"] = plan.totals()
        out["per_cols"][str(cols)] = {
            "accuracy": acc,
            "drop_pct": 100.0 * (acc_fp - acc),
        }
    return out


def run(*, max_elems=2_000_000, seed=0, device=None) -> dict:
    return {
        "transitions": transitions_sweep(max_elems=max_elems, seed=seed, device=device),
        "accuracy": accuracy_sweep(seed=seed, device=device),
    }


def print_accuracy(acc: dict) -> None:
    print(f"  trained-LM fp accuracy: {acc['fp_accuracy']:.4f}")
    for c, r in acc["per_cols"].items():
        print(f"    cols={c:>2s}: acc={r['accuracy']:.4f} (drop {r['drop_pct']:+.2f}%)")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    banner(f"Fig. 10 — column sweep at p={P}")
    res = run(max_elems=0 if args.full else 2_000_000, device=args.device)
    for m, entry in res["transitions"].items():
        sp = "  ".join(f"{c}:{v['speedup_p1_over_p']:.2f}x" for c, v in entry.items())
        print(f"  {m:10s} {sp}")
    print_accuracy(res["accuracy"])
    save_json("fig10_columns", res)


if __name__ == "__main__":
    main()
