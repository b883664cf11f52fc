"""Serving throughput on the port: fp vs cim-dense vs cim int8-planes vs cim-packed.

The port's copy of ``benchmarks/serving_throughput.py``.  Serves one LM
four times through ``launch.serve.make_generator``:

  * ``fp``              — float weights, the framework baseline;
  * ``cim_dense``       — crossbar-achieved weights materialized dense;
  * ``cim_planes_int8`` — achieved weights served as signed int8 bit planes
    (kernel B5 on the card; one byte of weight traffic per bit cell);
  * ``cim_packed``      — achieved weights served straight from the
    bit-packed planes (kernel B2 on the card; one bit per bit cell).

Each variant is served through every decode loop asked for (``--loop``:
``scan``, one CUDA graph a generation on the card, and ``python``, one
dispatch a token), so the graph's effect is in the record.  Alongside tok/s
it emits the weight-traffic roofline of one decode step
(:func:`cim_weight_bytes`, the port's copy of ``benchmarks/roofline.py``'s)
and, on the card, the device-busy share of one traced generate per loop for
cim-packed and cim-planes_int8.

Timing: every generator is built (and warmed) once, then the timed passes
are INTERLEAVED across variants and loops and each keeps its best pass, so
every variant samples the same background conditions.

  PYTHONPATH=src python -m benchmarks_torch.serving_throughput [--quick] [--device cpu]
  PYTHONPATH=src python -m benchmarks_torch.serving_throughput --full-size --layers 4

Writes experiments/bench_torch/BENCH_serve.json.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time

import torch

from benchmarks_torch.common import Timer, banner, save_json
from repro_torch import prng
from repro_torch.configs import get_arch
from repro_torch.core.planner import (
    CrossbarSpec,
    PlannerConfig,
    _dense_only,
    build_deployment,
    deploy_params,
)
from repro_torch.core.pool import CrossbarPool
from repro_torch.kernels._util import full_f32_matmuls, resolve_device
from repro_torch.launch.serve import LOOPS, make_generator
from repro_torch.models import api

VARIANTS = ("fp", "cim_dense", "cim_planes_int8", "cim_packed")
TRACED = ("cim_packed", "cim_planes_int8")


def cim_weight_bytes(
    shape: tuple[int, ...], cols: int, repr: str, *, tile_density: float = 1.0
) -> int:
    """Weight bytes one matmul pass must read for a [..., K, N] tensor.

    * ``dense_f32``    — 4 bytes per weight (the dense-materialized baseline);
    * ``planes_int8``  — ``cols`` bytes per weight: one int8 per bit cell;
    * ``packed``       — bit-packed planes + sign mask: ``(cols+1) *
      ceil(K/8) * N`` bytes per [K, N] slab, i.e. ~(cols+1)/8 per weight;
    * ``packed_codec`` — codec-compressed packed planes: ``tile_density``
      is the fraction of 16-byte plane tiles flagged nonzero, plus the
      sideband (one flag byte per plane tile and ``cols`` plane-id bytes
      per slab).
    """
    if len(shape) < 2:
        raise ValueError(f"weight shape {shape} has no (K, N) axes")
    n_elem = math.prod(shape)
    if repr == "dense_f32":
        return 4 * n_elem
    if repr == "planes_int8":
        return cols * n_elem
    if repr in ("packed", "packed_codec"):
        k, n = shape[-2], shape[-1]
        lead = math.prod(shape[:-2]) if len(shape) > 2 else 1
        kw = -(-k // 8)
        if repr == "packed":
            return lead * (cols + 1) * kw * n
        n_tiles = -(-kw // 16)  # core.planes.OPERAND_TILE_BYTES
        plane_b = round(cols * kw * n * min(max(tile_density, 0.0), 1.0))
        meta_b = cols * n_tiles + cols  # nz flags + plane ids
        return lead * (plane_b + kw * n + meta_b)
    raise ValueError(f"unknown representation {repr!r}")


def weight_traffic(plan) -> dict:
    """Deployed-weight bytes one decode step reads, per representation.

    Tensors the planner forces dense under every materialization
    (``planner.MATERIALIZE_DENSE_ONLY``) are priced as dense f32 in all
    three columns, matching what ``deploy_params`` serves.
    """
    out = {rep: 0 for rep in ("dense_f32", "planes_int8", "packed")}
    for name, r in plan.reports.items():
        for rep in out:
            eff = "dense_f32" if _dense_only(name) else rep
            out[rep] += cim_weight_bytes(r.shape, plan.spec.cols, eff)
    out["int8_over_packed"] = out["planes_int8"] / max(out["packed"], 1)
    out["dense_over_packed"] = out["dense_f32"] / max(out["packed"], 1)
    return out


def busy_share(timed_run) -> dict:
    """Wall and device time of one ``timed_run()`` under torch.profiler
    (CUPTI): the device time is the sum of every kernel's; the busy share
    their ratio."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        timed_run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_ms = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
                 if str(getattr(e, "device_type", "")).endswith("CUDA")) / 1e3
    return {"wall_ms": wall_ms, "device_ms": dev_ms, "busy": dev_ms / wall_ms}


def run(
    arch: str = "gemma-2b",
    *,
    reduced: bool = True,
    layers: int | None = None,
    batch: int = 4,
    prompt_len: int = 32,
    gen: int = 16,
    p_stuck: float = 0.5,
    min_size: int = 1024,
    seed: int = 0,
    repeats: int = 5,
    loops: tuple[str, ...] = LOOPS,
    device=None,
) -> dict:
    """Plan ``arch`` (``layers`` cuts its depth), serve every variant through
    every loop, interleaved best-of-``repeats``; on the card trace one
    generate per loop of each ``TRACED`` variant."""
    dev = resolve_device(device)
    full_f32_matmuls()
    cfg = get_arch(arch, reduced=reduced)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    params = api.init(prng.PRNGKey(seed), cfg, device=dev)
    bt = api.make_batch(cfg, prng.PRNGKey(seed), batch, prompt_len, device=dev)

    spec = CrossbarSpec(rows=128, cols=10)
    pcfg = PlannerConfig(p_stuck=p_stuck, min_size=min_size)
    pool = CrossbarPool(spec, pcfg.crossbars, device=dev)
    plan = build_deployment(params, spec, pcfg, pool=pool, device=dev)

    variants = {
        "fp": params,
        "cim_dense": deploy_params(params, plan),
        "cim_planes_int8": deploy_params(params, plan, materialize="planes_int8"),
        "cim_packed": deploy_params(params, plan, materialize="packed"),
    }
    gens = {(name, loop): make_generator(cfg, p, bt, gen_len=gen, seed=seed, loop=loop)
            for name, p in variants.items() for loop in loops}
    best = {k: float("inf") for k in gens}
    tokens: dict = {}
    with Timer(dev) as t:
        for _ in range(max(1, repeats)):
            for k, g in gens.items():
                toks, dt = g()
                best[k] = min(best[k], dt)
                tokens[k] = toks
    tok_s = {name: {loop: batch * gen / best[(name, loop)] for loop in loops}
             for name in variants}
    agree = {loop: {name: float((tokens[("cim_dense", loop)] == tokens[(name, loop)])
                                .float().mean())
                    for name in ("cim_planes_int8", "cim_packed")} for loop in loops}
    same_across_loops = {name: all(torch.equal(tokens[(name, loops[0])], tokens[(name, loop)])
                                   for loop in loops) for name in variants}
    busy = {}
    if dev.type == "cuda":
        busy = {name: {loop: busy_share(gens[(name, loop)]) for loop in loops}
                for name in TRACED}
    return {
        "arch": arch,
        "reduced": reduced,
        "layers": cfg.n_layers,
        "batch": batch,
        "prompt_len": prompt_len,
        "gen": gen,
        "p_stuck": p_stuck,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "timing": f"best-of-{repeats}, passes interleaved across variants and loops "
                  f"(post-warmup); the suite {t.seconds:.2f} s",
        "tok_s": tok_s,
        "graph_over_python_tok_s": ({name: tok_s[name]["scan"] / tok_s[name]["python"]
                                     for name in variants}
                                    if {"scan", "python"} <= set(loops) else None),
        "packed_over_int8_tok_s": {loop: tok_s["cim_packed"][loop]
                                   / max(tok_s["cim_planes_int8"][loop], 1e-9) for loop in loops},
        "token_agreement_vs_dense": agree,
        "tokens_equal_across_loops": same_across_loops,
        "device_busy": busy,
        "weight_bytes_per_decode_step": weight_traffic(plan),
        "n_deployed_tensors": len(plan.reports),
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--full-size", action="store_true", help="no --reduced config")
    ap.add_argument("--layers", type=int, default=None, help="cut the depth to N layers")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--p-stuck", type=float, default=0.5)
    ap.add_argument("--loop", choices=LOOPS + ("both",), default="both",
                    help="decode loop(s) to serve through")
    ap.add_argument("--quick", action="store_true", help="smoke shapes: batch 2, prompt 8, gen 4")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.quick:
        args.batch, args.prompt_len, args.gen = 2, 8, 4

    banner("Serving throughput — fp vs cim-dense vs int8-planes vs packed, by decode loop")
    res = run(
        args.arch,
        reduced=not args.full_size,
        layers=args.layers,
        batch=args.batch,
        prompt_len=args.prompt_len,
        gen=args.gen,
        p_stuck=args.p_stuck,
        loops=LOOPS if args.loop == "both" else (args.loop,),
        device=args.device,
    )
    for name, by_loop in res["tok_s"].items():
        print(f"  {name:16s} " + "  ".join(f"{loop} {tps:10.1f} tok/s"
                                          for loop, tps in by_loop.items()))
    for name, by_loop in res["device_busy"].items():
        print(f"  {name:16s} device busy " + "  ".join(
            f"{loop} {b['device_ms']:.2f} of {b['wall_ms']:.2f} ms ({100 * b['busy']:.1f}%)"
            for loop, b in by_loop.items()))
    t = res["weight_bytes_per_decode_step"]
    print(f"  weight bytes/step: dense {t['dense_f32']:,}  int8-planes {t['planes_int8']:,}  "
          f"packed {t['packed']:,}  (int8/packed = {t['int8_over_packed']:.2f}x)")
    print(f"  token agreement vs cim-dense: {res['token_agreement_vs_dense']}")
    print(f"  tokens equal across loops: {res['tokens_equal_across_loops']}")
    save_json("BENCH_serve", res)


if __name__ == "__main__":
    main()
