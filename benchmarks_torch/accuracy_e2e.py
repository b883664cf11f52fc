"""End-to-end accuracy preservation on the port: train -> deploy -> measure (<1% drop).

The paper's bottom-line constraint at its headline operating point (SWS
stride-1, p=0.5, 128x10 crossbars): deployment must cost <1% accuracy.
Evaluated on the trained reduced LM (``trained_lm``: exact task accuracy)
plus the fidelity probes ``top1_agreement`` and ``logit_kl`` on the first
held-out batch, as ``benchmarks/accuracy_e2e.py`` does.  ``lm`` swaps in
other weights (the reference's: ``trained_lm.reference_lm``).

  PYTHONPATH=src python -m benchmarks_torch.accuracy_e2e [--device cpu] [--reference-weights]
"""
from __future__ import annotations

import argparse

import torch

from benchmarks_torch.common import banner, save_json
from benchmarks_torch.trained_lm import eval_accuracy, get_trained_lm, reference_lm
from repro_torch.core.planner import CrossbarSpec, PlannerConfig, build_deployment, deploy_params
from repro_torch.core.simulator import logit_kl, top1_agreement
from repro_torch.kernels._util import resolve_device
from repro_torch.models import api


def run(*, p=0.5, rows=128, cols=10, seed=0, device=None, lm=None,
        record: dict | None = None) -> dict:
    dev = resolve_device(device)
    cfg, params, batch_fn = lm or get_trained_lm(seed=seed, device=dev)
    acc_fp = eval_accuracy(cfg, params, batch_fn, record=record, label="fp")

    plan = build_deployment(
        params, CrossbarSpec(rows=rows, cols=cols),
        PlannerConfig(p_stuck=p, min_size=1024, seed=seed), device=dev,
    )
    params_hat = deploy_params(params, plan)
    acc_cim = eval_accuracy(cfg, params_hat, batch_fn, record=record, label="cim")
    if record is not None:
        record["cim"]["totals"] = plan.totals()

    def f(pp, b):
        with torch.no_grad():
            return api.forward(pp, cfg, b)[0]

    batch = batch_fn(0)
    t = plan.totals()
    return {
        "operating_point": {"p": p, "rows": rows, "cols": cols, "schedule": "stride1"},
        "accuracy_fp": acc_fp,
        "accuracy_cim": acc_cim,
        "accuracy_drop_pct": 100.0 * (acc_fp - acc_cim),
        "top1_agreement": float(top1_agreement(f, params, params_hat, batch)),
        "logit_kl": float(logit_kl(f, params, params_hat, batch)),
        "sws_speedup": t["sws_speedup"],
        "total_speedup": t["total_speedup"],
    }


def paper_check(res: dict) -> tuple[bool, str]:
    ok = res["accuracy_drop_pct"] < 1.0
    return ok, f"  [paper check] <1% accuracy drop: {'PASS' if ok else 'FAIL'}"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--p", type=float, default=0.5)
    ap.add_argument("--cols", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--reference-weights", action="store_true",
                    help="deploy the reference's trained weights (golden npz) instead of "
                         "training here")
    args = ap.parse_args()

    banner("Accuracy preservation (train -> deploy -> eval)")
    lm = reference_lm(device=args.device) if args.reference_weights else None
    res = run(p=args.p, cols=args.cols, device=args.device, lm=lm)
    print(f"  fp accuracy   : {res['accuracy_fp']:.4f}")
    print(f"  CIM accuracy  : {res['accuracy_cim']:.4f}  (drop {res['accuracy_drop_pct']:+.2f}%)")
    print(f"  top1 agreement: {res['top1_agreement']:.4f}   logit KL: {res['logit_kl']:.2e}")
    print(f"  reprog speedup: {res['total_speedup']:.2f}x (sws {res['sws_speedup']:.2f}x)")
    print(paper_check(res)[1])
    save_json("accuracy_e2e", res)


if __name__ == "__main__":
    main()
