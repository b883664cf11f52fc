"""Plane codec compression on the port: reprogramming transitions + weight traffic.

The port's copy of ``benchmarks/plane_compression.py``.  The codec layer
(``core/planes.py``) stores the canonical packed planes in a re-encoded
physical form: ``col_perm`` re-aligns each section's bit columns against its
reprogramming predecessor (fewer cell transitions for the same logical
planes), ``const_rle`` elides constant 16-byte tiles (less payload to move),
and ``col_perm_rle`` composes both.  This benchmark measures both on the
paper's model set through the real pipeline (per-layer quantize -> SWS sort
-> packed sections -> stride-1 chains, priced by kernel B1 on the card),
plus the serving-side twin: per-codec deployed-operand bytes and token
parity on the reduced gemma-2b, served from the packed planes (kernel B2,
or B4 under the ``*_rle`` codecs, on the card).

The weights are the reference's bit for bit (``common.model_weights``), so
every transition and byte count equals the reference's.

  PYTHONPATH=src python -m benchmarks_torch.plane_compression [--quick|--full] [--check]
      [--device cpu]

Writes ``experiments/bench_torch/BENCH_compress.json``.  ``--quick`` caps
model size; ``--check`` exits non-zero unless (a) every model's ``col_perm``
transition reduction is >= 1.0x vs raw and (b) every codec's served token
stream matches dense bit for bit.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
import torch.nn.functional as F

from benchmarks_torch.common import banner, model_weights, save_json, weights_per_section
from repro_torch import prng
from repro_torch.core import bitslice, planes, schedule, sws
from repro_torch.kernels._util import resolve_device

COLS = 10
L_CROSSBARS = 16


def model_packed_planes(
    name: str, *, cols: int = COLS, max_elems: int = 2_000_000, seed: int = 0, device=None
) -> torch.Tensor:
    """Packed section planes for a whole model via the deployment pipeline
    (per-layer scale + SWS sort, layer streams concatenated in order)."""
    w_per = weights_per_section(cols)
    chunks = []
    for _, w in model_weights(name, max_elems=max_elems, seed=seed, device=device):
        w = w[sws.sws_permutation(w)]
        q = F.pad(bitslice.quantize(w, cols).q, (0, (-w.shape[0]) % w_per))
        chunks.append(bitslice.section_planes_packed(q, w_per, cols))
    return torch.cat(chunks, dim=0)


def _transitions(phys: torch.Tensor, chains) -> int:
    costs = schedule.schedule_job_costs(phys, chains, include_initial=True)
    return int(costs.sum(dtype=torch.int64))


def _walk_operands(tree, out: list) -> None:
    if isinstance(tree, dict):
        if "planes_packed" in tree:
            out.append(tree)
            return
        for v in tree.values():
            _walk_operands(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _walk_operands(v, out)


def serving_traffic(codecs, *, gen: int = 4, device=None) -> dict:
    """Deployed-operand weight bytes + token parity per codec (reduced LM)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.planner import (
        CrossbarSpec, PlannerConfig, build_deployment, deploy_params,
    )
    from repro_torch.launch.serve import generate
    from repro_torch.models import api

    dev = resolve_device(device)
    cfg = get_arch("gemma-2b", reduced=True)
    key = prng.PRNGKey(0)
    params = api.init(key, cfg, device=dev)
    batch = api.make_batch(cfg, key, 2, 12, device=dev)
    plan = build_deployment(
        params, CrossbarSpec(rows=128, cols=COLS),
        PlannerConfig(p_stuck=1.0, min_size=1024), device=dev,
    )
    toks_dense, _ = generate(cfg, deploy_params(params, plan), batch, gen_len=gen)
    out = {"arch": "gemma-2b(reduced)", "codecs": {},
           "tokens_dense": toks_dense.cpu().tolist()}
    for codec in codecs:
        p = deploy_params(params, plan, materialize="packed", codec=codec)
        ops: list = []
        _walk_operands(p, ops)
        total = {"plane_bytes": 0, "sign_bytes": 0, "meta_bytes": 0, "total_bytes": 0}
        n_weights = 0
        for op in ops:
            b = planes.operand_payload_bytes(op)
            for k in total:
                total[k] += b[k]
            pp = op["planes_packed"]
            lead = int(np.prod(pp.shape[:-3])) if pp.ndim > 3 else 1
            n_weights += lead * op["kdim"].shape[-2] * pp.shape[-1]
        toks, _ = generate(cfg, p, batch, gen_len=gen)
        out["codecs"][codec] = {
            **total,
            "n_weights": n_weights,
            "bytes_per_weight": total["total_bytes"] / max(n_weights, 1),
            "tokens_match_dense": bool(torch.equal(toks_dense, toks)),
            "tokens": toks.cpu().tolist(),
        }
    raw_b = out["codecs"].get("raw", {}).get("total_bytes")
    if raw_b:
        for codec, r in out["codecs"].items():
            r["traffic_reduction_vs_raw"] = raw_b / max(r["total_bytes"], 1)
    return out


def run(
    models=None,
    codecs=None,
    *,
    max_elems: int = 2_000_000,
    l_crossbars: int = L_CROSSBARS,
    seed: int = 0,
    serve: bool = True,
    gen: int = 4,
    device=None,
) -> dict:
    """Transitions and bytes per model and codec on ``device`` (CUDA unless
    the caller asks for the CPU), then the serving half."""
    dev = resolve_device(device)
    models = models or ["resnet50", "vit-base"]
    codecs = list(codecs or planes.CODECS)
    out = {
        "config": {
            "cols": COLS, "l_crossbars": l_crossbars, "schedule": "stride1",
            "max_elems": max_elems, "codecs": codecs,
        },
        "models": {},
    }
    for m in models:
        packed = model_packed_planes(m, max_elems=max_elems, seed=seed, device=dev)
        chains = schedule.make_chains(packed.shape[0], l_crossbars, "stride1")
        raw_t = _transitions(packed, chains)
        entry = {"sections": int(packed.shape[0]), "codecs": {}}
        for codec in codecs:
            ps = planes.encode(packed, codec, chains=chains)
            t = _transitions(ps.physical(), chains)
            stats = ps.compression_stats()
            entry["codecs"][codec] = {
                "transitions": t,
                "transition_reduction_vs_raw": raw_t / max(t, 1),
                "payload_bytes": int(stats["payload_bytes"]),
                "meta_bytes": int(stats["meta_bytes"]),
                "total_bytes": int(stats["total_bytes"]),
                "compression_vs_raw": float(stats["ratio_vs_raw"]),
            }
        out["models"][m] = entry
    if serve:
        out["serving"] = serving_traffic(codecs, gen=gen, device=dev)
    best = max(
        (r["codecs"][c]["transition_reduction_vs_raw"]
         for r in out["models"].values() for c in codecs),
        default=1.0,
    )
    out["best_transition_reduction"] = best
    return out


def check(res: dict) -> list[str]:
    """Structural floor + exact serve parity.  Returns failures."""
    fails = []
    for m, r in res["models"].items():
        for codec, c in r["codecs"].items():
            if codec.startswith("col_perm") and c["transition_reduction_vs_raw"] < 1.0:
                fails.append(
                    f"{m}/{codec}: transition reduction "
                    f"{c['transition_reduction_vs_raw']:.3f}x < 1.0x vs raw"
                )
    for codec, r in res.get("serving", {}).get("codecs", {}).items():
        if not r["tokens_match_dense"]:
            fails.append(f"serving/{codec}: token stream diverged from dense")
    return fails


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--quick", action="store_true", help="small configuration")
    ap.add_argument("--check", action="store_true", help="exit 1 on gate failure")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    if args.quick:
        kwargs = dict(models=["resnet50"], max_elems=250_000, gen=4)
    else:
        kwargs = dict(max_elems=0 if args.full else 2_000_000, gen=8)

    banner("Plane codecs — reprogramming transitions + weight traffic")
    res = run(**kwargs, device=args.device)
    for m, r in res["models"].items():
        for codec, c in r["codecs"].items():
            print(f"  {m:10s} {codec:12s} transitions {c['transitions']:>10,} "
                  f"({c['transition_reduction_vs_raw']:.2f}x vs raw)  "
                  f"bytes {c['total_bytes']:>9,} ({c['compression_vs_raw']:.2f}x)")
    srv = res.get("serving")
    if srv:
        for codec, r in srv["codecs"].items():
            print(f"  serve {codec:12s} {r['total_bytes']:>9,} B "
                  f"({r['bytes_per_weight']:.3f} B/weight, "
                  f"{r.get('traffic_reduction_vs_raw', 1.0):.2f}x vs raw packed)  "
                  f"tokens_match={r['tokens_match_dense']}")
    save_json("BENCH_compress", res)

    if args.check:
        fails = check(res)
        for f in fails:
            print(f"  GATE FAIL: {f}")
        if fails:
            sys.exit(1)
        print("  gates passed: col_perm reduction >= 1.0x, serve token parity")


if __name__ == "__main__":
    main()
