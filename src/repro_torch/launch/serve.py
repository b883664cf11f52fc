"""Batched serving entry point: prefill + decode, optionally on crossbar bits.

Port of ``repro.launch.serve``: with ``--cim`` every eligible weight is
planned onto crossbars through one persistent ``CrossbarPool`` (cross-tensor
seams, per-cell wear) and served as its achieved weights — ``dense`` as
ordinary matmuls, ``packed`` straight from the bit-packed planes (kernel B2,
or B4 under a ``*_rle`` codec), ``planes_int8`` from one byte per bit cell
(built by kernel B6, served by kernel B5).  The report gives tok/s, token
agreement with fp weights, the reprogramming speedups, pool wear and the
endurance horizon.

``--codec`` (``core/planes.py``) changes the physical bits the pool
programs and, with ``--materialize packed``, the serving operand layout
(plane reorder + zero-tile skipping); tokens do not change.  Fault
injection and scrubbing are not ported yet (ROADMAP A.13).  Archs: the
dense decoders gemma-2b, yi-6b, internlm2-1.8b, phi3-medium-14b; prefill
attention runs kernel B3 on the card.

Decode loop (``--loop``): ``scan`` (default) runs the whole generation as
one dispatch, a CUDA graph of every decode step replayed once a generation
on the card; ``python`` dispatches one step a token.  Both give the same
tokens.  ``generate(..., greedy=False, seed=)`` samples with the
reference's key schedule (``prng.categorical``), bit for bit.

Usage (on the card):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b --layers 4 \
      --cim --materialize packed [--codec const_rle --pool-leveling lpt --p-stuck 0.5]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --layers 4 \
      --cim --materialize planes_int8 [--loop python]
Add ``--reduced --device cpu`` for the small config on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import prng
from repro_torch.configs import get_arch
from repro_torch.core.planes import CODECS
from repro_torch.core.planner import (
    MATERIALIZATIONS,
    CrossbarSpec,
    PlannerConfig,
    build_deployment,
    deploy_params,
)
from repro_torch.core.pool import DEFAULT_ENDURANCE, LEVELINGS, CrossbarPool
from repro_torch.kernels._util import full_f32_matmuls, resolve_device
from repro_torch.launch.steps import (
    CudaGraphCall,
    make_decode_loop,
    make_prefill_step,
    make_serve_step,
    pick,
    prepare_serving_params,
)
from repro_torch.models import api
from repro_torch.models.transformer import compute_dtype


LOOPS = ("scan", "python")


def make_generator(
    cfg, params, batch, *, gen_len: int, greedy: bool = True, seed: int = 0,
    loop: str = "scan",
):
    """Set up prefill + decode for one batch; returns ``timed_run()`` ->
    (tokens (B, gen_len), seconds).

    ``loop="scan"`` decodes the whole generation in one dispatch: on the
    card a CUDA graph of all its steps (``steps.CudaGraphCall``), captured
    here over the generator's cache and static token, key and position
    buffers, replayed once a run; on the CPU the same step function runs
    eagerly.  ``loop="python"`` dispatches token by token
    (``steps.make_serve_step``).  Both pick through ``steps.pick`` from
    ``prng.PRNGKey(seed)``, so they give the same tokens.  One untimed run
    is made here first (warm-up); every run re-serves the batch from the
    same key.  The prefill is one eager call.  ``timed_run.decode`` is the
    graph (``CudaGraphCall``, with its replay count) where there is one.
    """
    if loop not in LOOPS:
        raise ValueError(f"unknown decode loop {loop!r}; choose from {LOOPS}")
    tokens_in = batch["tokens"]
    dev = tokens_in.device
    b, prompt_len = tokens_in.shape
    params = prepare_serving_params(params, compute_dtype(cfg))
    prefill = make_prefill_step(cfg)
    cache = api.init_cache(cfg, b, prompt_len + gen_len, device=dev)
    key = prng.PRNGKey(seed, device=dev)
    pos0 = torch.full((), prompt_len, dtype=torch.int64, device=dev)
    if loop == "scan":
        decode = make_decode_loop(cfg, gen_len - 1, greedy=greedy)
        if dev.type == "cuda":
            with torch.inference_mode():
                decode = CudaGraphCall(decode, params, cache, torch.zeros_like(tokens_in[:, :1]),
                                       torch.zeros_like(key), torch.zeros_like(pos0))
    else:
        serve_step = make_serve_step(cfg)

    @torch.inference_mode()
    def run():
        logits, pf_cache = prefill(params, batch)
        run_cache = api.merge_prefill_cache(cfg, cache, pf_cache)
        tok, k = pick(logits, key, greedy)
        if loop == "scan":
            toks, _ = decode(params, run_cache, tok, k, pos0)
            tokens = torch.cat([tok, toks], dim=1)
        else:
            out = [tok]
            for i in range(gen_len - 1):
                logits, run_cache = serve_step(params, run_cache, tok, pos0 + i)
                tok, k = pick(logits, k, greedy)
                out.append(tok)
            tokens = torch.cat(out, dim=1)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return tokens

    run()

    def timed_run():
        t0 = time.perf_counter()
        tokens = run()
        return tokens, time.perf_counter() - t0

    timed_run.decode = decode if loop == "scan" else None
    return timed_run


def generate(
    cfg, params, batch, *, gen_len: int, greedy: bool = True, seed: int = 0,
    loop: str = "scan", repeats: int = 1,
):
    """Prefill then decode ``gen_len`` tokens; returns (tokens, tok/s).

    The first prefill+decode is run untimed; ``repeats`` timed passes follow
    and the best one gives tok/s (tokens come from the last).  ``greedy``,
    ``seed`` and ``loop`` as in :func:`make_generator`.
    """
    b = batch["tokens"].shape[0]
    timed_run = make_generator(cfg, params, batch, gen_len=gen_len, greedy=greedy, seed=seed,
                               loop=loop)
    best = float("inf")
    for _ in range(max(1, repeats)):
        tokens, dt = timed_run()
        best = min(best, dt)
    return tokens, b * gen_len / best


def main(argv: list[str] | None = None) -> None:
    """CLI: serve with fp weights, then (``--cim``) crossbar-deployed weights
    planned through a persistent pool, and report tok/s, token agreement,
    the plan's reprogramming speedups, pool wear and the endurance horizon."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None, help="cut the depth to N layers")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--cim", action="store_true", help="serve crossbar-deployed weights")
    ap.add_argument(
        "--materialize", choices=MATERIALIZATIONS, default="dense",
        help="serving representation of deployed tensors (packed = bit-plane-native)",
    )
    ap.add_argument(
        "--codec", choices=CODECS, default="raw",
        help="stored-plane codec: changes the physical bits the pool programs and, "
             "with --materialize packed, the serving operand layout",
    )
    ap.add_argument("--p-stuck", type=float, default=0.5)
    ap.add_argument("--rows", type=int, default=128)
    ap.add_argument("--cols", type=int, default=10)
    ap.add_argument(
        "--min-size", type=int, default=PlannerConfig().min_size,
        help="smallest tensor (elements) deployed to crossbars",
    )
    ap.add_argument(
        "--pool-leveling", choices=LEVELINGS, default="none",
        help="wear-leveling chain->crossbar assignment for the pool",
    )
    ap.add_argument(
        "--endurance", type=float, default=DEFAULT_ENDURANCE,
        help="per-cell write endurance budget for the exhaustion horizon",
    )
    ap.add_argument(
        "--loop", choices=LOOPS, default="scan",
        help="decode loop: one dispatch a generation (a CUDA graph on the card) or one a token",
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.codec != "raw":
        if not args.cim:
            ap.error("--codec applies to crossbar-deployed weights; add --cim")
        if args.materialize == "planes_int8":
            ap.error(
                "--codec encodes packed serving operands; --materialize "
                "planes_int8 has no stored-plane layout (use packed or dense)"
            )

    dev = resolve_device(args.device)
    full_f32_matmuls()
    cfg = get_arch(args.arch, reduced=args.reduced)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    params = api.init(prng.PRNGKey(args.seed), cfg, device=dev)
    batch = api.make_batch(cfg, args.batch, args.prompt_len, seed=args.seed, device=dev)

    tokens, tps = generate(cfg, params, batch, gen_len=args.gen, seed=args.seed, loop=args.loop)
    print(f"fp weights:   {tps:8.1f} tok/s   first request: {tokens[0, :12].tolist()}")
    if not args.cim:
        return
    spec = CrossbarSpec(rows=args.rows, cols=args.cols)
    planner_cfg = PlannerConfig(p_stuck=args.p_stuck, min_size=args.min_size, codec=args.codec)
    pool = CrossbarPool(spec, planner_cfg.crossbars, leveling=args.pool_leveling, device=dev)
    t0 = time.perf_counter()
    plan = build_deployment(params, spec, planner_cfg, pool=pool, device=dev)
    plan_s = time.perf_counter() - t0
    # dense and int8 planes have no stored-plane layout to encode; the plan's
    # codec already shaped the pool's physical programming above
    codec = args.codec if args.materialize == "packed" else "raw"
    params_hat = deploy_params(params, plan, materialize=args.materialize, codec=codec)
    tokens_hat, tps_hat = generate(cfg, params_hat, batch, gen_len=args.gen, seed=args.seed,
                                   loop=args.loop)
    agree = (tokens == tokens_hat).float().mean().item()
    t = plan.totals()
    stats = pool.stats()
    horizon = stats.exhaustion_horizon(args.endurance)
    print(f"cim weights:  {tps_hat:8.1f} tok/s   ({args.materialize} materialization)"
          f"   first request: {tokens_hat[0, :12].tolist()}")
    print(f"token agreement: {agree:.3f}   reprog speedup: {t['total_speedup']:.2f}x "
          f"(sws {t['sws_speedup']:.2f}x)   plan: {len(plan.reports)} tensors in {plan_s:.1f} s")
    print(f"pool wear: max cell {stats.max_cell_writes} writes, "
          f"mean {stats.mean_cell_writes:.2f}, total {stats.total_writes} "
          f"over {stats.tensors_seen} tensors")
    print(f"endurance horizon: ~{horizon:.3g} such deployments "
          f"@ {args.endurance:.0e} writes/cell ({args.pool_leveling} leveling)")


if __name__ == "__main__":
    main()
