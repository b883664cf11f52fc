"""Run the port's paper figures in the reference suite's order.

  PYTHONPATH=src python -m benchmarks_torch.run [--full] [--device cpu]

Runs Fig. 5, Fig. 6, Fig. 7, Fig. 8, Fig. 9 and Fig. 10 (both halves: the
accuracy halves deploy the reduced LM trained once per process by
``trained_lm``), the end-to-end accuracy check, the planner throughput and
the serving throughput (both decode loops), prints each one's summary as
``benchmarks/run.py`` does, and writes the JSON artifacts and a summary to
experiments/bench_torch/.  --full removes the per-tensor element cap.

Left out, with the reason:

* plane codecs, pool wear, engine, fault tolerance, integrity scrub,
  fleet, redeploy delta and the roofline: their benchmarks are not ported
  yet (ROADMAP A.11-A.15, A.18).
"""
from __future__ import annotations

import argparse
import time

from benchmarks_torch import (
    accuracy_e2e,
    fig5_sws_single,
    fig6_strides,
    fig7_greedy,
    fig8_stucking,
    fig9_p_sweep,
    fig10_columns,
    planner_throughput,
    serving_throughput,
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

    banner("Fig. 9 — p sweep (speedup + accuracy)")
    r9 = fig9_p_sweep.run(max_elems=max_elems, device=dev)
    for m, r in r9["transitions"].items():
        sp = "  ".join(f"p={p}:{v:.2f}x" for p, v in r["speedup_vs_p1"].items())
        print(f"  {m:10s} {sp}")
    fig9_p_sweep.print_accuracy(r9["accuracy"])
    save_json("fig9_p_sweep", r9)
    summary["fig9"] = {m: r["speedup_vs_p1"] for m, r in r9["transitions"].items()}
    summary["fig9_accuracy"] = {p: r["accuracy"] for p, r in r9["accuracy"]["per_p"].items()}

    banner("Fig. 10 — column sweep (speedup + accuracy)")
    r10 = fig10_columns.run(max_elems=max_elems, device=dev)
    for m, entry in r10["transitions"].items():
        sp = "  ".join(f"{c}:{v['speedup_p1_over_p']:.2f}x" for c, v in entry.items())
        print(f"  {m:10s} {sp}")
    fig10_columns.print_accuracy(r10["accuracy"])
    save_json("fig10_columns", r10)
    summary["fig10"] = {m: {c: v["speedup_p1_over_p"] for c, v in e.items()}
                        for m, e in r10["transitions"].items()}
    summary["fig10_accuracy"] = {c: r["accuracy"] for c, r in r10["accuracy"]["per_cols"].items()}

    banner("Accuracy preservation (train -> deploy -> eval)")
    re2e = accuracy_e2e.run(device=dev)
    print(f"  fp {re2e['accuracy_fp']:.4f}  CIM {re2e['accuracy_cim']:.4f} "
          f"(drop {re2e['accuracy_drop_pct']:+.2f}%)  top1 agreement "
          f"{re2e['top1_agreement']:.4f}  speedup {re2e['total_speedup']:.2f}x")
    print(accuracy_e2e.paper_check(re2e)[1])
    save_json("accuracy_e2e", re2e)
    summary["accuracy_e2e"] = {k: re2e[k] for k in ("accuracy_drop_pct", "total_speedup")}

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

    banner("Serving throughput — fp vs cim-dense vs int8-planes vs packed, by decode loop")
    rst = serving_throughput.run(device=dev)
    for name, by_loop in rst["tok_s"].items():
        print(f"  {name:16s} " + "  ".join(f"{loop} {tps:10.1f} tok/s"
                                          for loop, tps in by_loop.items()))
    save_json("BENCH_serve", rst)
    summary["serving_throughput"] = rst["tok_s"]

    banner(f"benchmarks_torch.run complete in {time.time() - t0:.0f}s")
    save_json("summary", summary)
    print("  artifacts in experiments/bench_torch/*.json")


if __name__ == "__main__":
    main()
