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
(plane reorder + zero-tile skipping); tokens do not change.
``--fault-rate`` / ``--fault-hotspot`` inject stuck cells into the pool
before planning (``core/nonideal.py``: the deployment reads through them,
and ``--pool-leveling fault`` remaps around them); ``--scrub`` enables the
integrity layer (``core/integrity.py``), and ``--scrub-storm`` corrupts the
deployed bits, scrubs to convergence and prices the repair against a full
reprogram.  Archs: the dense decoders gemma-2b, yi-6b, internlm2-1.8b,
phi3-medium-14b, the MoE decoders qwen2-moe-a2.7b and deepseek-v2-236b
(each expert stack one grouped launch of B2 / B4 / B5), the hybrid
hymba-1.5b (attention beside Mamba heads, meta tokens, sliding-window ring
caches), the recurrent xlstm-350m (mLSTM and sLSTM blocks, no
attention), the encoder-decoder seamless-m4t-medium (source frames from
``make_batch``'s ``src_embeds``, a cross-attention cache over them) and
internvl2-76b (a dense decoder whose first 256 positions are the batch's
``prefix_embeds``: a shorter prompt raises, ROADMAP C.14); prefill
attention runs kernel B3 on the card (the encoder-decoder's
cross-attention is ``blockwise_attention``, as in the reference).

Decode loop (``--loop``): ``scan`` (default) runs the whole generation as
one dispatch, a CUDA graph of every decode step replayed once a generation
on the card; ``python`` dispatches one step a token.  Both give the same
tokens.  ``generate(..., greedy=False, seed=)`` samples with the
reference's key schedule (``prng.categorical``), bit for bit.

The MoE decoders serve under ``models.moe.set_moe_distribution(mesh)`` too
(the sharded dispatch, dense weights only; no CLI flag, as in the
reference).  A generator is bound to the distribution it was built under:
its decode graph holds that dispatch, so running it under another raises.

Usage (on the card):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b --layers 4 \
      --cim --materialize packed [--codec const_rle --pool-leveling lpt --p-stuck 0.5]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --layers 4 \
      --cim --materialize planes_int8 [--loop python]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b --layers 2 \
      --cim --materialize packed --codec const_rle
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b --layers 4 \
      --cim --materialize packed
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m --layers 8 \
      --cim --materialize packed --codec const_rle
  PYTHONPATH=src python -m repro_torch.launch.serve --arch seamless-m4t-medium \
      --layers 4 --cim --materialize packed
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-76b --layers 1 \
      --prompt-len 288 --cim --materialize planes_int8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b --layers 4 \
      --cim --fault-rate 2e-3 --fault-hotspot 0.25 --pool-leveling fault \
      --scrub --scrub-tiles 65536 --scrub-storm 2e-7
Add ``--reduced --device cpu`` for the small config on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import prng
from repro_torch.configs import get_arch
from repro_torch.core import nonideal
from repro_torch.core.integrity import IntegrityConfig
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
from repro_torch.models import api, moe
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
    params = prepare_serving_params(params, compute_dtype(cfg))
    return generator_on_prepared(cfg, params, batch, gen_len=gen_len, greedy=greedy,
                                 seed=seed, loop=loop)


def generator_on_prepared(
    cfg, params, batch, *, gen_len: int, greedy: bool = True, seed: int = 0,
    loop: str = "scan", cache_shards: int = 0, wrap=None,
):
    """:func:`make_generator` on a prepared param tree: ``cache_shards`` is
    the decode cache's shard axis (``init_cache``) and ``wrap`` wraps each
    step function (a tensor-parallel plan's gate, ``parallel.tp.tp_step``)."""
    if loop not in LOOPS:
        raise ValueError(f"unknown decode loop {loop!r}; choose from {LOOPS}")
    wrap = wrap or (lambda fn: fn)
    tokens_in = batch["tokens"]
    dev = tokens_in.device
    b, prompt_len = tokens_in.shape
    prefill = wrap(make_prefill_step(cfg))
    # an encoder-decoder's cross cache holds the source frames
    src_len = batch["src_embeds"].shape[1] if cfg.encdec else None
    cache = api.init_cache(cfg, b, prompt_len + gen_len, device=dev, shards=cache_shards,
                           src_len=src_len)
    key = prng.PRNGKey(seed, device=dev)
    pos0 = torch.full((), prompt_len, dtype=torch.int64, device=dev)
    dist = moe.distribution()  # the MoE dispatch the decode graph captures
    if loop == "scan":
        decode = wrap(make_decode_loop(cfg, gen_len - 1, greedy=greedy))
        if dev.type == "cuda":
            with torch.inference_mode():
                decode = CudaGraphCall(decode, params, cache, torch.zeros_like(tokens_in[:, :1]),
                                       torch.zeros_like(key), torch.zeros_like(pos0))
    else:
        serve_step = wrap(make_serve_step(cfg))

    @torch.inference_mode()
    def run():
        if moe.distribution() != dist:
            raise RuntimeError(
                f"this generator was built under the MoE distribution {dist} and is run under "
                f"{moe.distribution()}: its decode graph holds the other dispatch; build a new "
                f"generator")
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
        "--fault-rate", type=float, default=0.0,
        help="per-cell stuck-at rate (split evenly stuck-at-0/1) injected "
             "into the pool before deployment; reads go through the masks",
    )
    ap.add_argument(
        "--fault-hotspot", type=float, default=0.0,
        help="fraction of crossbars with 8x the stuck-at rate (the "
             "heterogeneous-yield setting 'fault' leveling remaps around)",
    )
    ap.add_argument(
        "--scrub", action="store_true",
        help="enable the integrity layer (core/integrity.py): tile checksums "
             "and spare columns registered as each tensor is programmed",
    )
    ap.add_argument(
        "--scrub-tiles", type=int, default=64,
        help="tile-verification budget per scrub round (bounds scrub latency)",
    )
    ap.add_argument(
        "--spare-cols", type=int, default=2,
        help="clean spare column planes per section (remap targets for hard "
             "stuck-at faults found by the scrubber)",
    )
    ap.add_argument(
        "--scrub-storm", type=float, default=0.0,
        help="after deployment, corrupt stored bits at this rate (plus 1/10th "
             "of it as new hard stuck cells), scrub to convergence, and report "
             "repair cost vs a full reprogram of the affected tensors",
    )
    ap.add_argument(
        "--loop", choices=LOOPS, default="scan",
        help="decode loop: one dispatch a generation (a CUDA graph on the card) or one a token",
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if (args.scrub or args.scrub_storm > 0.0) and not args.cim:
        ap.error("--scrub/--scrub-storm apply to crossbar-deployed weights; add --cim")
    if args.scrub_storm > 0.0 and not args.scrub:
        ap.error("--scrub-storm needs the integrity layer; add --scrub")
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
        # an encoder-decoder's encoder is cut with its decoder
        cfg = dataclasses.replace(cfg, n_layers=args.layers,
                                  **({"n_enc_layers": args.layers} if cfg.encdec else {}))
    params = api.init(prng.PRNGKey(args.seed), cfg, device=dev)
    batch = api.make_batch(cfg, prng.PRNGKey(args.seed), args.batch, args.prompt_len,
                           device=dev)

    tokens, tps = generate(cfg, params, batch, gen_len=args.gen, seed=args.seed, loop=args.loop)
    print(f"fp weights:   {tps:8.1f} tok/s   first request: {tokens[0, :12].tolist()}")
    if not args.cim:
        return
    spec = CrossbarSpec(rows=args.rows, cols=args.cols)
    planner_cfg = PlannerConfig(p_stuck=args.p_stuck, min_size=args.min_size, codec=args.codec)
    pool = CrossbarPool(spec, planner_cfg.crossbars, leveling=args.pool_leveling, device=dev)
    if args.scrub:
        pool.enable_integrity(IntegrityConfig(spare_cols=args.spare_cols,
                                              scrub_tiles=args.scrub_tiles))
    if args.fault_rate > 0.0:
        fstate = pool.inject_faults(
            nonideal.FaultModel(stuck0=args.fault_rate / 2, stuck1=args.fault_rate / 2,
                                hotspot_fraction=args.fault_hotspot, hotspot_mult=8.0),
            prng.PRNGKey(args.seed),
        )
        cells = fstate.fault_cells()
        print(f"injected faults: {int(cells.sum())} stuck cells across "
              f"{pool.n_crossbars} crossbars (worst {int(cells.max())}; "
              f"{int(fstate.hot.sum())} hotspots)")
    t0 = time.perf_counter()
    plan = build_deployment(params, spec, planner_cfg, pool=pool, device=dev)
    plan_s = time.perf_counter() - t0
    # dense and int8 planes have no stored-plane layout to encode; the plan's
    # codec already shaped the pool's physical programming above
    codec = args.codec if args.materialize == "packed" else "raw"
    # the served tree needs the deployed tensors and the unplanned leaves only: the f32
    # originals of the planned ones go first, and w_hat once the operands are built (a
    # full-width deepseek-v2-236b layer's int8 planes take 45 GB of the card)
    params = deploy_params(params, plan, materialize="dense")
    params_hat = deploy_params(params, plan, materialize=args.materialize, codec=codec)
    del params
    plan = dataclasses.replace(plan, deployed={})
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
    if not args.scrub:
        return
    mgr = pool.integrity
    s = mgr.summary()
    print(f"integrity: {s['tensors']} tensors registered, {s['tiles']} "
          f"checksum tiles, {s['spare_cols']} spare cols/section"
          + (" + parity" if s["parity_col"] else ""))
    if args.scrub_storm > 0.0:
        st = mgr.storm(prng.PRNGKey(args.seed + 1), corrupt_rate=args.scrub_storm,
                       stuck_rate=args.scrub_storm / 10)
        rep = mgr.scrub_until_clean()
        full = mgr.transitions_full_affected()
        ratio = rep.repair_transitions / max(full, 1)
        print(f"storm: {st['corrupted_bits']} bits corrupted, "
              f"{st['new_stuck_cells']} new stuck cells -> "
              f"{rep.detections} detections, {rep.rewrites} rewrites, "
              f"{rep.remaps} remaps, {rep.migrations} migrations, "
              f"{rep.tolerated} tolerated")
        print(f"repair cost: {rep.repair_transitions} transitions vs "
              f"{full} full reprogram ({ratio:.4f}x); reads restored: "
              f"{mgr.verify_all()}")


if __name__ == "__main__":
    main()
