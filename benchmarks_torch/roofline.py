"""Roofline table from the port's dry-run artifacts.

The port's copy of ``benchmarks/roofline.py``.  Reads
``experiments/dryrun_torch/*.json`` (written by
``repro_torch.launch.dryrun``) and emits the per-(arch x shape x mesh)
three-term roofline table of one H100 (``repro_torch.launch.roofline``):
compute / memory / collective seconds, the dominant term, MODEL_FLOPS /
counted FLOPs, and the roofline fraction (useful FLOP/s at the roofline step
time over the card's peak).  The counts are one device's eager step on the
host (``launch.step_cost``), not a measurement, and of the plain path
(each cell's ``counted_path``): a step that runs B2-B6 is not bounded by them.

It also folds in the CIM weight-traffic accounting: the deployed-weight
bytes a decode step reads under each serving representation
(:func:`cim_weight_bytes`, owned by ``benchmarks_torch.serving_throughput``
in the port) from ``experiments/bench_torch/BENCH_serve.json``, and the
per-codec bytes a weight from ``BENCH_compress.json``, where those exist.

  PYTHONPATH=src python -m benchmarks_torch.roofline [--mesh single|multi] [--variant V]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from benchmarks_torch.common import OUT_DIR, banner, save_json
from benchmarks_torch.serving_throughput import cim_weight_bytes  # noqa: F401  (the API's)
from repro_torch.launch.dryrun import OUT_DIR as DRYRUN_DIR


def load_cells(dryrun_dir: Path = DRYRUN_DIR, variant: str = "") -> list[dict]:
    cells = []
    for p in sorted(Path(dryrun_dir).glob("*.json")):
        d = json.loads(p.read_text())
        if d.get("status") != "ok":
            continue
        if (d.get("variant") or "") != variant:
            continue
        cells.append(d)
    return cells


def table_rows(cells: list[dict]) -> list[dict]:
    rows = []
    for d in cells:
        r = d["roofline"]
        rows.append(
            {
                "arch": d["arch"],
                "shape": d["shape"],
                "mesh": d["mesh"],
                "counted_path": d["counted_path"],
                "compute_s": r["compute_s"],
                "memory_s": r["memory_s"],
                "collective_s": r["collective_s"],
                "bottleneck": r["bottleneck"],
                "step_time_s": r["step_time_s"],
                "useful_flops_ratio": r["useful_flops_ratio"],
                "roofline_fraction": r["roofline_fraction"],
            }
        )
    return rows


def serving_weight_traffic() -> dict | None:
    """The serving benchmark's weight-traffic roofline, if it has run."""
    path = OUT_DIR / "BENCH_serve.json"
    if not path.exists():
        return None
    d = json.loads(path.read_text())
    t = d.get("weight_bytes_per_decode_step")
    if not t:
        return None
    return {"arch": d.get("arch"), "bytes_per_decode_step": t, "tok_s": d.get("tok_s")}


def codec_weight_traffic() -> dict | None:
    """Per-codec deployed-operand bytes a weight (benchmarks_torch.plane_compression)."""
    path = OUT_DIR / "BENCH_compress.json"
    if not path.exists():
        return None
    d = json.loads(path.read_text())
    srv = d.get("serving")
    if not srv:
        return None
    return {
        "arch": srv.get("arch"),
        "bytes_per_weight": {c: r["bytes_per_weight"] for c, r in srv["codecs"].items()},
        "traffic_reduction_vs_raw": {
            c: r.get("traffic_reduction_vs_raw") for c, r in srv["codecs"].items()
        },
    }


def run(variant: str = "", dryrun_dir: Path = DRYRUN_DIR) -> dict:
    rows = table_rows(load_cells(dryrun_dir, variant=variant))
    worst = sorted(
        (r for r in rows if r["roofline_fraction"] is not None and r["mesh"] == "single"),
        key=lambda r: r["roofline_fraction"],
    )
    most_coll = sorted(
        (r for r in rows if r["mesh"] == "single"),
        key=lambda r: -(r["collective_s"] / max(r["step_time_s"], 1e-30)),
    )
    return {
        "rows": rows,
        "worst_roofline_fraction": worst[:3],
        "most_collective_bound": most_coll[:3],
        "serving_weight_traffic": serving_weight_traffic(),
        "codec_weight_traffic": codec_weight_traffic(),
    }


def print_report(res: dict, mesh: str | None = None) -> None:
    swt = res["serving_weight_traffic"]
    if swt:
        t = swt["bytes_per_decode_step"]
        print(f"  serving weight traffic ({swt['arch']}): dense {t['dense_f32']:,} B/step, "
              f"int8-planes {t['planes_int8']:,} B/step, packed {t['packed']:,} B/step "
              f"(int8/packed = {t['int8_over_packed']:.2f}x)")
    cwt = res["codec_weight_traffic"]
    if cwt:
        per = "  ".join(f"{c}:{b:.3f}" for c, b in cwt["bytes_per_weight"].items())
        print(f"  codec weight traffic ({cwt['arch']}): B/weight  {per}")
    rows = [r for r in res["rows"] if mesh in (None, r["mesh"])]
    if not rows:
        print("  no dry-run artifacts found — run: "
              "PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both")
        return
    print(f"  counted path: {', '.join(sorted({r['counted_path'] for r in rows}))} (every op's "
          f"plain version: not a bound on a step that runs B2-B6)")
    print(f"  {'arch':24s}{'shape':13s}{'mesh':7s}{'compute':>10s}{'memory':>10s}{'coll':>10s}"
          f"  {'bound':10s}{'frac':>9s}")
    for r in rows:
        frac = f"{r['roofline_fraction']:.2e}" if r["roofline_fraction"] is not None else "-"
        print(f"  {r['arch']:24s}{r['shape']:13s}{r['mesh']:7s}"
              f"{r['compute_s']:10.2e}{r['memory_s']:10.2e}{r['collective_s']:10.2e}"
              f"  {r['bottleneck']:10s}{frac:>9s}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default="")
    ap.add_argument("--mesh", default=None, choices=[None, "single", "multi"])
    args = ap.parse_args()

    banner("Roofline (from the port's dry-run artifacts, one H100 a device)")
    res = run(variant=args.variant)
    print_report(res, args.mesh)
    save_json("roofline", res)


if __name__ == "__main__":
    main()
