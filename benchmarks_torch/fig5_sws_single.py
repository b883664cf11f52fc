"""Paper Fig. 5 — SWS speedup for a single 128x16 crossbar, on the port.

One physical crossbar walks every section of the model in (a) natural
unsorted order (ISAAC/CASCADE-style allocation) vs (b) per-layer SWS order;
speedup = transitions(a) / transitions(b).  Paper band: 1.47x (DeiT-Tiny,
sharp distribution) to 1.87x (VGG16, smooth distribution).

  PYTHONPATH=src python -m benchmarks_torch.fig5_sws_single [--full] [--device cpu]
"""
from __future__ import annotations

import argparse

from benchmarks_torch.common import PAPER_DEFAULT_MODELS, banner, model_planes, save_json
from repro_torch.core import cost
from repro_torch.kernels._util import resolve_device

COLS = 16
PAPER = {"deit-tiny": 1.47, "vgg16": 1.87}


def run(models=None, *, max_elems=2_000_000, seed=0, device=None) -> dict:
    dev = resolve_device(device)
    models = models or PAPER_DEFAULT_MODELS + ["internlm2-layer", "yi6b-layer"]
    results = {}
    for m in models:
        planes_u = model_planes(m, cols=COLS, sort=False, max_elems=max_elems, seed=seed,
                                device=dev)
        t_u = int(cost.chain_transitions(planes_u))
        n_sections = int(planes_u.shape[0])
        del planes_u
        planes_s = model_planes(m, cols=COLS, sort=True, max_elems=max_elems, seed=seed,
                                device=dev)
        t_s = int(cost.chain_transitions(planes_s))
        results[m] = {
            "n_sections": n_sections,
            "transitions_unsorted": t_u,
            "transitions_sws": t_s,
            "speedup": t_u / max(t_s, 1),
        }
    return results


def paper_check(res: dict) -> list[str]:
    return [f"  [paper check] {m}: paper={want:.2f}x ours={res[m]['speedup']:.2f}x"
            for m, want in PAPER.items() if m in res]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    banner("Fig. 5 — SWS single-crossbar (128x16) speedup")
    res = run(max_elems=0 if args.full else 2_000_000, seed=args.seed, device=args.device)
    for m, r in res.items():
        print(f"  {m:18s} sections={r['n_sections']:7d}  speedup={r['speedup']:.2f}x")
    save_json("fig5_sws_single", res)
    print("\n".join(paper_check(res)))


if __name__ == "__main__":
    main()
