"""Run the port's paper figures in the reference suite's order.

  PYTHONPATH=src python -m benchmarks_torch.run [--full] [--device cpu]

Runs Fig. 5, Fig. 6, Fig. 7, Fig. 8, the transition halves of Fig. 9 and
Fig. 10, and the planner throughput, prints each one's summary as
``benchmarks/run.py`` does, and writes the JSON artifacts and a summary to
experiments/bench_torch/.  --full removes the per-tensor element cap.

Left out, with the reason:

* the accuracy halves of Fig. 9 and Fig. 10 and ``accuracy_e2e``: they
  deploy a trained reduced LM, and the port has no trainer yet (ROADMAP
  A.3(b));
* plane codecs, pool wear, serving, engine, fault tolerance, integrity
  scrub, fleet, redeploy delta and the roofline: their benchmarks are not
  ported yet (ROADMAP A.1, A.11-A.15, A.18).
"""
from __future__ import annotations

import argparse
import time

from benchmarks_torch import (
    fig5_sws_single,
    fig6_strides,
    fig7_greedy,
    fig8_stucking,
    fig9_p_sweep,
    fig10_columns,
    planner_throughput,
)
from benchmarks_torch.common import banner, save_json


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    max_elems = 0 if args.full else 2_000_000
    dev = args.device

    t0 = time.time()
    summary = {}

    banner("Fig. 5 — SWS single crossbar")
    r5 = fig5_sws_single.run(max_elems=max_elems, device=dev)
    for m, r in r5.items():
        print(f"  {m:18s} speedup={r['speedup']:.2f}x")
    save_json("fig5_sws_single", r5)
    summary["fig5"] = {m: r["speedup"] for m, r in r5.items()}

    banner("Fig. 6 — stride-L vs stride-1")
    r6 = fig6_strides.run(max_elems=max_elems, device=dev)
    for m, r in r6.items():
        ls = "  ".join(f"L={l}:{v['speedup']:.2f}x" for l, v in r["strideL"].items())
        print(f"  {m:10s} {ls}  stride1:{r['stride1']['speedup']:.2f}x")
    save_json("fig6_strides", r6)
    summary["fig6"] = {
        m: {"stride1": r["stride1"]["speedup"], "strideL4": r["strideL"]["4"]["speedup"]}
        for m, r in r6.items()
    }

    banner("Fig. 7 — greedy thread balancing (64 threads)")
    r7 = fig7_greedy.run(max_elems=max_elems, device=dev)
    for m, r in r7.items():
        print(f"  {m:12s} unsorted={r['speedup_unsorted']:5.1f}x  "
              f"greedy={r['speedup_greedy']:5.1f}x")
    save_json("fig7_greedy", r7)
    summary["fig7"] = {m: r["speedup_greedy"] for m, r in r7.items()}

    banner("Fig. 8 — bit stucking p=0.5")
    r8 = fig8_stucking.run(max_elems=max_elems, device=dev)
    for m, r in r8.items():
        print(f"  {m:12s} saves {r['speedup_pct']:5.1f}%")
    save_json("fig8_stucking", r8)
    summary["fig8"] = {m: r["speedup_pct"] for m, r in r8.items()}

    banner("Fig. 9 — p sweep (transitions)")
    r9 = fig9_p_sweep.run(max_elems=max_elems, device=dev)
    for m, r in r9["transitions"].items():
        sp = "  ".join(f"p={p}:{v:.2f}x" for p, v in r["speedup_vs_p1"].items())
        print(f"  {m:10s} {sp}")
    save_json("fig9_p_sweep", r9)
    summary["fig9"] = {m: r["speedup_vs_p1"] for m, r in r9["transitions"].items()}

    banner("Fig. 10 — column sweep (transitions)")
    r10 = fig10_columns.run(max_elems=max_elems, device=dev)
    for m, entry in r10["transitions"].items():
        sp = "  ".join(f"{c}:{v['speedup_p1_over_p']:.2f}x" for c, v in entry.items())
        print(f"  {m:10s} {sp}")
    save_json("fig10_columns", r10)
    summary["fig10"] = {m: {c: v["speedup_p1_over_p"] for c, v in e.items()}
                        for m, e in r10["transitions"].items()}

    banner("Planner throughput — packed planner, card vs CPU")
    rpt = planner_throughput.run(
        max_elems=2_000_000 if args.full else 750_000,
        layers=None if args.full else 6,
        device=dev,
    )
    print(
        f"  {rpt['arch']} x{rpt['layers']} layers ({rpt['n_elements']/1e6:.1f}M weights): "
        f"{rpt['device']} {rpt['time_device_s']:.1f}s vs cpu {rpt['time_cpu_s']:.1f}s "
        f"-> {rpt['speedup']:.2f}x  bit_exact={rpt['bit_exact']}"
    )
    save_json("BENCH_planner", rpt)
    summary["planner_throughput"] = {"speedup": rpt["speedup"], "bit_exact": rpt["bit_exact"]}

    banner(f"benchmarks_torch.run complete in {time.time() - t0:.0f}s")
    save_json("summary", summary)
    print("  artifacts in experiments/bench_torch/*.json")


if __name__ == "__main__":
    main()
