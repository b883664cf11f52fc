"""Run the port's paper figures in the reference suite's order.

  PYTHONPATH=src python -m benchmarks_torch.run [--full] [--device cpu]

Runs Fig. 5, Fig. 6, Fig. 7, Fig. 8, Fig. 9 and Fig. 10 (both halves: the
accuracy halves deploy the reduced LM trained once per process by
``trained_lm``), the end-to-end accuracy check, the planner throughput, the
plane codecs, the pool wear, the serving throughput (both decode loops),
the engine throughput (static, split and fused), the redeploy delta, the
fault tolerance, the integrity scrub and the fleet tolerance, prints each
one's summary as
``benchmarks/run.py`` does, and writes the JSON artifacts and a summary to
experiments/bench_torch/.  --full removes the per-tensor element cap.

Left out, with the reason: the roofline, which reads the dry run's
artifacts (ROADMAP A.18).
"""
from __future__ import annotations

import argparse
import time

from benchmarks_torch import (
    accuracy_e2e,
    engine_throughput,
    fig5_sws_single,
    fig6_strides,
    fig7_greedy,
    fig8_stucking,
    fig9_p_sweep,
    fig10_columns,
    fault_tolerance,
    fleet_tolerance,
    integrity_scrub,
    plane_compression,
    planner_throughput,
    pool_wear,
    redeploy_delta,
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

    banner("Plane codecs — reprogramming transitions + weight traffic")
    rpc = plane_compression.run(max_elems=max_elems, gen=4 if not args.full else 8, device=dev)
    for m, r in rpc["models"].items():
        for codec, c in r["codecs"].items():
            print(f"  {m:10s} {codec:12s} {c['transition_reduction_vs_raw']:.2f}x "
                  f"transitions, {c['compression_vs_raw']:.2f}x bytes vs raw")
    parity = all(r["tokens_match_dense"] for r in rpc["serving"]["codecs"].values())
    print(f"  best transition reduction {rpc['best_transition_reduction']:.2f}x, "
          f"serve token parity: {parity}")
    save_json("BENCH_compress", rpc)
    summary["plane_compression"] = {
        "best_transition_reduction": rpc["best_transition_reduction"],
        "serve_token_parity": parity,
    }

    banner("Pool wear — persistent crossbar pool + wear leveling")
    rpool = pool_wear.run(deployments=3 if not args.full else 6, device=dev)
    for lev, s in rpool["levelings"].items():
        print(f"  {lev:7s} max_cell={s['max_cell_writes']:8d}  "
              f"imbalance={s['crossbar_imbalance']:.3f}  "
              f"horizon={s['exhaustion_horizon_deployments']:.3g} deployments")
    print(f"  LPT leveling reduces max-cell wear "
          f"{rpool['max_wear_reduction_lpt_vs_none']:.2f}x")
    save_json("BENCH_pool", rpool)
    summary["pool_wear"] = {
        "max_wear_reduction_lpt_vs_none": rpool["max_wear_reduction_lpt_vs_none"],
        "max_cell_writes_lpt": rpool["levelings"]["lpt"]["max_cell_writes"],
    }

    banner("Serving throughput — fp vs cim-dense vs int8-planes vs packed, by decode loop")
    rst = serving_throughput.run(device=dev)
    for name, by_loop in rst["tok_s"].items():
        print(f"  {name:16s} " + "  ".join(f"{loop} {tps:10.1f} tok/s"
                                          for loop, tps in by_loop.items()))
    save_json("BENCH_serve", rst)
    summary["serving_throughput"] = rst["tok_s"]

    banner("Engine throughput — fused vs split vs static lockstep")
    ret = engine_throughput.run(device=dev)
    for name in ("static", "engine_split", "engine"):
        r = ret[name]
        print(f"  {name:12s} {r['tok_s']:9.1f} tok/s   p50 {r['p50_latency_ms']:8.1f} ms   "
              f"p95 {r['p95_latency_ms']:8.1f} ms")
    save_json("BENCH_engine", ret)
    summary["engine_throughput"] = {k: ret[k] for k in ("speedup_tok_s", "fused_vs_split_tok_s",
                                                        "p50_latency_ratio")}

    banner("Redeploy delta (training-time integration, beyond-paper)")
    rd = redeploy_delta.run(device=dev)
    for k, v in rd["tensors"].items():
        print(f"  {k}: stale-sort streaming {v['stale_sort_speedup']:.2f}x "
              f"(fresh re-sort {v['fresh_sort_speedup']:.2f}x)")
    save_json("redeploy_delta", rd)
    summary["redeploy"] = {k: v["stale_sort_speedup"] for k, v in rd["tensors"].items()}

    banner("Fault tolerance — logit KL vs stuck-cell rate, naive vs fault-aware")
    rft = fault_tolerance.run(device=dev)
    print(f"  remapping recovers {100 * rft['recovery_at_ref']:.1f}% of the KL degradation "
          f"at rate {rft['ref_rate']}; hot redeploy stream parity "
          f"{rft['redeploy']['stream_parity']}; horizons "
          + ", ".join(f"{h:.3g}" for h in rft["endurance"]["horizons"]))
    save_json("BENCH_fault", rft)
    summary["fault_tolerance"] = {"recovery_at_ref": rft["recovery_at_ref"],
                                  "redeploy_stream_parity": rft["redeploy"]["stream_parity"]}

    banner("Integrity scrub — storm, detect, repair, restore parity")
    ris = integrity_scrub.run(device=dev)
    sr = ris["storm_repair"]
    print(f"  {sr['detections']} tiles detected, repair cost "
          f"{100 * sr['repair_cost_ratio']:.1f}% of a full reprogram, token parity "
          f"{sr['post_repair_parity']}; engine scrub refreshes "
          f"{ris['engine_scrub']['scrub_refreshes']}, scrub overhead "
          f"{100 * ris['overhead']['throughput_ratio']:.1f}% of tok/s")
    save_json("BENCH_integrity", ris)
    summary["integrity_scrub"] = {"repair_cost_ratio": sr["repair_cost_ratio"],
                                  "post_repair_parity": sr["post_repair_parity"]}

    banner("Fleet tolerance — replica router under chaos")
    rfl = fleet_tolerance.run(counts=(1, 2) if not args.full else (1, 2, 4),
                              n_requests=8 if not args.full else 16, device=dev)
    kt, st = rfl["kill_trace"], rfl["stall_trace"]
    print(f"  kill trace: {kt['completed']}/{kt['admitted']} completed, "
          f"parity {kt['stream_parity']}, {kt['surviving_replicas']} survivors")
    print(f"  stall trace: {st['completed']}/{st['admitted']} completed, "
          f"parity {st['stream_parity']}, {st['hedges']} hedges")
    save_json("BENCH_fleet", rfl)
    summary["fleet"] = {
        "tok_s_by_replicas": {str(r["n_replicas"]): r["tok_s"] for r in rfl["scaling"]},
        "kill_completed": kt["completed"],
        "stall_completed": st["completed"],
        "stream_parity": kt["stream_parity"] and st["stream_parity"],
        "shed": rfl["admission"]["shed"],
    }

    banner(f"benchmarks_torch.run complete in {time.time() - t0:.0f}s")
    save_json("summary", summary)
    print("  artifacts in experiments/bench_torch/*.json")


if __name__ == "__main__":
    main()
