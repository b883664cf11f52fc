"""The planner's bytes in flight a weight, on the card.

For each stack shape, ``analyze_tensor`` plans one random float32 tensor of
that shape (stateless, p_stuck 0.5, 128x10 crossbars) and the script prints
``torch.cuda.max_memory_allocated()`` over the call less what was allocated
before it (the tensor's ``w_hat`` included), over the tensor's weights.  A
shape that does not fit the card is reported as out of memory.

    python tools/planner_memory.py [--src DIR] [--shape 1,160,5120,1536 ...]

``--src`` imports the port from another tree's ``src`` (a parent commit
unpacked with ``git archive``), so two trees are compared on one card, one
process each.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

SHAPES = ("2,64,2048,1408", "1,40,5120,1536", "1,160,5120,1536")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--shape", action="append", default=None,
                    help="comma-separated stack shape (repeatable); default: qwen2-moe-a2.7b "
                         "x2's, a quarter and all of a deepseek-v2-236b expert stack")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    from repro_torch import prng
    from repro_torch.core import planner

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=False).stdout.strip()
    spec, cfg = planner.CrossbarSpec(), planner.PlannerConfig(p_stuck=0.5)
    out = {"src": args.src, "card": card, "stacks": {}}
    for text in args.shape or SHAPES:
        shape = tuple(int(v) for v in text.split(","))
        gen = torch.Generator(device=dev).manual_seed(0)
        w = torch.randn(shape, device=dev, generator=gen) * 0.02
        n = w.numel()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            report, w_hat = planner.analyze_tensor(w, spec, cfg, prng.PRNGKey(0).to(dev))
            torch.cuda.synchronize()
            rec = {"bytes_per_weight": (torch.cuda.max_memory_allocated() - base) / n,
                   "seconds": time.perf_counter() - t0,
                   "transitions_final": report.transitions_final}
            del report, w_hat
        except torch.cuda.OutOfMemoryError:
            rec = {"bytes_per_weight": None, "out_of_memory_after_s": time.perf_counter() - t0,
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        rec["weights"] = n
        out["stacks"][text] = rec
        print(f"{text}: {rec}", flush=True)
        del w
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
