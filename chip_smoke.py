#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Drives the port's main paths — plan gemma-2b onto 128x10 crossbars, alone
and through a persistent ``CrossbarPool`` with plane codecs, then serve it
from the packed bits and from int8 planes — at the model's full width with
the depth cut to 4 layers, and holds each hand-written kernel against its
plain PyTorch version on the card.  Phases (one line each, any failed check
exits 1):

  1. card + build: name and power limit, the kernels built from csrc/;
  2. B1 (Hamming pricing) == its plain version, exactly;
  3. B2 (packed CIM matmul) vs its plain version at gemma-2b's shapes,
     within |d| <= 2 * eps_f32 * K * (|x| @ |w|) (the two sum K products in
     different orders, each within K * eps of exact);
     B4 (the zero-tile skipping twin) == B2 bit for bit on synthetic
     operands with 0-90% zero tiles, with and without permuted plane_ids;
     B5 (int8-plane matmul, both modes) vs its plain version, same bound;
  4. plan: build_deployment on the card, B1 launches > 0, and one stacked
     tensor planned again on the CPU with an identical report and w_hat;
     plan-pool: the same model through a CrossbarPool with the const_rle
     codec, its wear and endurance horizon; the pool's state and wear after
     segments/0/attn/wk equal a CPU pool's;
  5. serve: generate with fp, cim-dense and cim-packed weights; B2 launches
     over one timed packed pass == 7 * layers * gen; then cim-packed
     const_rle (B4, tokens == raw-packed of the same plan) and cim-planes_int8
     (B5), each launching 7 * layers * gen times with no plain-version call;
     col_perm_rle at 1 layer (B4 with plane_ids, 7 * gen launches);
  6. kernels: time, bound, plain-version and library times.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Run from the repository root:
``python3 chip_smoke.py`` (needs one CUDA card; fails without one).
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

LAYERS, BATCH, PROMPT, GEN, P_STUCK = 4, 4, 32, 16, 0.5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
B2_BOUND_C = 2.0
CHECK_TENSOR = "segments/0/attn/wk"
CODEC = "const_rle"  # the pool plan's codec; col_perm_rle runs at COLPERM_LAYERS
COLPERM_LAYERS = 1  # bounds the host greedy of plan_col_order
ZERO_SHARES = (0.0, 0.25, 0.5, 0.75, 0.9)  # zero-tile shares of the synthetic B4 operands
QUANT_MSE_RTOL = 1e-6
F32_LOGIT_RTOL = 1e-3  # f32 prefill, packed vs dense: sums of <= 16384 terms reordered
BF16_LOGIT_RTOL = 0.02  # bf16 prefill: dense rounds w_hat to bf16, packed keeps it exact


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms, CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def trace(run, top: int = 6) -> str:
    """Profile one ``run()``: device busy share of its wall time and the
    kernels with the most device time (torch.profiler, CUPTI)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        # device-side events only: an aten op also reports its kernels' time
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        dev_us = getattr(e, "self_device_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    busy = sum(r[0] for r in rows)
    rows.sort(reverse=True)
    head = "; ".join(f"{name[:60]} x{n} {ms:.3f} ms" for ms, n, name in rows[:top])
    return (f"wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
            f"({100 * busy / wall_ms:.1f}%); top: {head or 'no device time seen'}")


def ptxas_summary(logs: dict) -> str:
    """Registers and spills per source from ``nvcc --ptxas-options=-v`` output."""
    import re

    parts = []
    for name, log in sorted(logs.items()):
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = [int(r) for r in re.findall(r"(\d+) bytes spill stores", log)]
        if regs:
            parts.append(f"{name}: {len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
                         f"max spill stores {max(spills, default=0)} B")
    return "; ".join(parts) or "n/a"


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: the smoke run needs one card")
    try:
        from repro_torch.configs import get_arch
        from repro_torch.core import bitslice, planes, planner, pool, simulator
        from repro_torch.kernels import _util
        from repro_torch.kernels.cim_matmul import ops as cim_ops
        from repro_torch.kernels.cim_matmul import ref as cim_ref
        from repro_torch.kernels.hamming import ops as ham_ops
        from repro_torch.kernels.hamming import ref as ham_ref
        from repro_torch.launch import serve
        from repro_torch.models import api
    except ImportError as e:
        fail(f"the port is not beside this script ({e})")

    dev = torch.device("cuda")
    _util.full_f32_matmuls()  # TF32 off: f32 results are compared, not approximated
    eps = torch.finfo(torch.float32).eps
    kind = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()

    # --- 1. card + build ---------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else f"{kind}, power limit not reported"
    say(card)
    t0 = time.perf_counter()
    logs = _util.build_kernels()
    build_s = time.perf_counter() - t0
    say(f"phase build: {sorted(logs) or 'cached'} in {build_s:.1f} s; ptxas: {ptxas_summary(logs)}")

    plain_fns = (cim_ref.cim_matmul, cim_ref.cim_matmul_packed, cim_ref.unpack_weights)

    def reset_counts():
        ham_ops.price_pairs.launches = 0
        cim_ops.reset_launches()
        for fn in plain_fns:
            fn.calls = 0

    def counts():
        return {"B1": ham_ops.price_pairs.launches, **cim_ops.LAUNCHES,
                "plain": sum(fn.calls for fn in plain_fns)}

    # --- 2. B1 against its plain version --------------------------------------
    g = torch.Generator(device=dev).manual_seed(0)
    b1_err = 0
    for t in (0, 1, 37, 4096, 1 << 20):
        a = torch.randint(0, 256, (t, 16, 10), dtype=torch.uint8, device=dev, generator=g)
        b = torch.randint(0, 256, (t, 16, 10), dtype=torch.uint8, device=dev, generator=g)
        got, want = ham_ops.price_pairs(a, b), ham_ref.hamming_pairs(a, b)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            fail(f"B1 differs from its plain version at T={t}")
        if t:
            b1_err = max(b1_err, int((got - want).abs().max()))
    say("phase B1: exact at T in {0, 1, 37, 4096, 1048576}")

    # --- 3. B2, B4 and B5 against their plain versions -------------------------
    def packed_operands(k, n, seed):
        gg = torch.Generator(device=dev).manual_seed(seed)
        q = torch.randint(0, 1024, (k, n), dtype=torch.int32, device=dev, generator=gg)
        s = torch.where(torch.rand(k, n, device=dev, generator=gg) < 0.5, -1, 1).to(torch.int8)
        return (bitslice.pack_linear_planes(q, 10), bitslice.pack_linear_sign(s),
                torch.tensor(0.02 / 1023, device=dev))

    def matmul_bound(x, w_abs):
        return B2_BOUND_C * eps * x.shape[-1] * (x.float().abs() @ w_abs)

    b2_err, n_checks = 0.0, 0
    cases = [(m, k, n) for k, n in ((2048, 2048), (2048, 256), (2048, 16384), (16384, 2048))
             for m in (1, 4, 128)] + [(5, 1001, 333)]
    for m, k, n in cases:
        planes_, signs, scale = packed_operands(k, n, m + k + n)
        w_abs = cim_ref.unpack_weights(planes_, signs, k).abs() * scale
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(m, k, device=dev, generator=g).to(dtype)
            got = cim_ops.cim_matmul_packed(x, planes_, signs, scale)
            want = cim_ref.cim_matmul_packed(x, planes_, signs, scale)
            torch.cuda.synchronize()
            err = (got - want).abs()
            if got.shape != (m, n) or not bool((err <= matmul_bound(x, w_abs)).all()):
                fail(f"B2 outside |d| <= {B2_BOUND_C}*eps*K*(|x|@|w|) at M={m} K={k} N={n} "
                     f"{dtype}: max err {err.max().item():.3e}")
            b2_err = max(b2_err, err.max().item())
            n_checks += 1
        del w_abs
    say(f"phase B2: {n_checks} cases within {B2_BOUND_C}*eps*K*(|x|@|w|), "
        f"max |d| {b2_err:.3e}")

    def zero_tile_operands(k, n, seed, share):
        """Packed operands whose (plane, 128-row K block) tiles are zero with
        probability ``share``, flagged by the const_rle codec."""
        gg = torch.Generator(device=dev).manual_seed(seed)
        q = torch.randint(0, 1024, (k, n), dtype=torch.int32, device=dev, generator=gg)
        s = torch.where(torch.rand(k, n, device=dev, generator=gg) < 0.5, -1, 1).to(torch.int8)
        op = simulator.packed_operands(q, s, 0.02 / 1023, 0.0, 10)
        if share:
            dead = torch.rand(10, -(-k // 128), device=dev, generator=gg) < share
            rows = dead.repeat_interleave(16, dim=1)[:, : op["planes_packed"].shape[1]]
            op["planes_packed"] = op["planes_packed"] * (~rows)[:, :, None]
        return planes.encode_operands(op, "const_rle")

    def check_b4(op, m, k, ids, what):
        """B4 == B2 bit for bit and within the bound of the plain version."""
        x = torch.randn(m, k, device=dev, generator=g).to(torch.bfloat16)
        args = (x, op["planes_packed"], op["sign_packed"], op["scale"])
        b2 = cim_ops.cim_matmul_packed(*args, plane_ids=ids)
        b4 = cim_ops.cim_matmul_packed(*args, tile_nz=op["plane_tile_nz"], plane_ids=ids)
        want = cim_ref.cim_matmul_packed(*args, plane_ids=ids)
        torch.cuda.synchronize()
        if not torch.equal(b2, b4):
            fail(f"B4 differs from B2 on {what} at M={m}: max |d| {(b2 - b4).abs().max().item():.3e}")
        w_abs = cim_ref.unpack_weights(op["planes_packed"], op["sign_packed"], k, ids).abs() * op["scale"]
        err = (b4 - want).abs()
        if not bool((err <= matmul_bound(x, w_abs)).all()):
            fail(f"B4 outside the bound of its plain version on {what} at M={m}")
        return err.max().item()

    b4_err, n4 = 0.0, 0
    perm = torch.randperm(10, generator=torch.Generator().manual_seed(1)).to(dev, torch.int32)
    for k, n in ((2048, 16384), (16384, 2048)):
        for share in (0.0, 0.5, 0.9):
            op = zero_tile_operands(k, n, k + n + int(100 * share), share)
            for ids in (None, perm):
                for m in (1, 4, 128):
                    b4_err = max(b4_err, check_b4(op, m, k, ids, f"{k}x{n}, {share:.0%} zero tiles"))
                    n4 += 1
    say(f"phase B4: {n4} synthetic cases (K x N in {{2048x16384, 16384x2048}}, zero tiles "
        f"0/50/90%, plane_ids identity and permuted {perm.tolist()}, M in {{1, 4, 128}}): "
        f"bit-equal to B2; max |d| to the plain version {b4_err:.3e}")

    b5_err, n5 = 0.0, 0
    for m, k, n in cases:
        gg = torch.Generator(device=dev).manual_seed(m + k + n)
        q = torch.randint(0, 1024, (k, n), dtype=torch.int32, device=dev, generator=gg)
        s = torch.where(torch.rand(k, n, device=dev, generator=gg) < 0.5, -1, 1).to(torch.int8)
        op = simulator.int8_plane_operands(q, s, 0.02 / 1023, 0.0, 10)
        w_abs = q.float() * op["scale"]
        del q, s
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(m, k, device=dev, generator=g).to(dtype)
            for mode in cim_ref.MODES:
                got = cim_ops.cim_matmul(x, op["splanes"], op["scale"], mode=mode)
                want = cim_ref.cim_matmul(x, op["splanes"], op["scale"], mode)
                torch.cuda.synchronize()
                err = (got - want).abs()
                if got.shape != (m, n) or not bool((err <= matmul_bound(x, w_abs)).all()):
                    fail(f"B5 {mode} outside |d| <= {B2_BOUND_C}*eps*K*(|x|@|w|) at M={m} "
                         f"K={k} N={n} {dtype}: max err {err.max().item():.3e}")
                b5_err = max(b5_err, err.max().item())
                n5 += 1
        del op, w_abs
    say(f"phase B5: {n5} cases (both modes, f32 and bf16 x) within {B2_BOUND_C}*eps*K*(|x|@|w|), "
        f"max |d| {b5_err:.3e}")
    torch.cuda.empty_cache()

    # --- 4. plan gemma-2b at full width --------------------------------------
    full = get_arch("gemma-2b")
    cfg = dataclasses.replace(full, n_layers=LAYERS)
    say(f"phase plan: gemma-2b d_model={cfg.d_model} heads={cfg.n_heads} kv={cfg.n_kv_heads} "
        f"head_dim={cfg.head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab_size}; depth cut "
        f"{full.n_layers} -> {LAYERS} layers (the only cut), p_stuck={P_STUCK}")
    params = api.init(cfg, seed=0, device=dev)
    spec, pcfg = planner.CrossbarSpec(), planner.PlannerConfig(p_stuck=P_STUCK)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = planner.build_deployment(params, spec, pcfg, device=dev)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    c = counts()
    for name, r in plan.reports.items():
        say(f"  {name} {list(r.shape)}: sws {r.sws_speedup:.3f}x total {r.total_speedup:.3f}x "
            f"({r.transitions_baseline} -> {r.transitions_sws} -> {r.transitions_final})")
    tot = plan.totals()
    say(f"phase plan: {len(plan.reports)} tensors in {plan_s:.2f} s; sws "
        f"{tot['sws_speedup']:.4f}x total {tot['total_speedup']:.4f}x; B1 launches {c['B1']}")
    if c["B1"] <= 0 or c["B2"] + c["B4"] + c["B5"] != 0:
        fail(f"plan launched {c}")

    def same_report(a, b, what):
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        for field in a:
            same = (abs(a[field] - b[field]) <= QUANT_MSE_RTOL * abs(a[field])
                    if field == "quant_mse" else a[field] == b[field])
            if not same:
                fail(f"CPU plan of {what} differs in {field}: {a[field]} vs {b[field]}")

    key = planner.tensor_keys(params, pcfg)[CHECK_TENSOR]
    w_cpu = dict(planner.iter_weights(params, pcfg))[CHECK_TENSOR].cpu()
    r_cpu, w_hat_cpu = planner.analyze_tensor(w_cpu, spec, pcfg, key, name=CHECK_TENSOR)
    same_report(plan.reports[CHECK_TENSOR], r_cpu, CHECK_TENSOR)
    if plan.deployed[CHECK_TENSOR].cpu().numpy().tobytes() != w_hat_cpu.numpy().tobytes():
        fail(f"CPU plan of {CHECK_TENSOR} deploys other w_hat bytes")
    say(f"phase plan-cpu: {CHECK_TENSOR} planned on the CPU: report equal (quant_mse, a "
        f"float mean summed in another order, within {QUANT_MSE_RTOL:g}), w_hat bytes identical")

    # --- 4b. the same model through a persistent pool, with a plane codec -------
    pcfg_pool = planner.PlannerConfig(p_stuck=P_STUCK, codec=CODEC)
    xbars = pool.CrossbarPool(spec, pcfg_pool.crossbars, device=dev)
    names = [n for n, _ in planner.iter_weights(params, pcfg_pool)]
    upto = names[: names.index(CHECK_TENSOR) + 1]
    snap = {}

    def progress(name):  # the pool's content once CHECK_TENSOR is programmed
        if name == (names + [None])[len(upto)]:
            snap["state"], snap["wear"] = xbars.state, xbars.wear.copy()

    reset_counts()
    t0 = time.perf_counter()
    pool_plan = planner.build_deployment(params, spec, pcfg_pool, pool=xbars, device=dev,
                                         progress=progress)
    torch.cuda.synchronize()
    pool_plan_s = time.perf_counter() - t0
    c_pool = counts()
    if "state" not in snap:
        snap["state"], snap["wear"] = xbars.state, xbars.wear.copy()
    stats = xbars.stats()
    ptot = pool_plan.totals()
    say(f"phase plan-pool: {len(pool_plan.reports)} tensors through a {xbars.n_crossbars}-crossbar "
        f"pool, codec {CODEC}, in {pool_plan_s:.2f} s; sws {ptot['sws_speedup']:.4f}x total "
        f"{ptot['total_speedup']:.4f}x; B1 launches {c_pool['B1']}")
    say(f"phase plan-pool: pool wear: max cell {stats.max_cell_writes} writes, mean "
        f"{stats.mean_cell_writes:.2f}, total {stats.total_writes} over {stats.tensors_seen} "
        f"tensors; endurance horizon ~{stats.exhaustion_horizon():.4g} such deployments @ 1e8 "
        f"writes/cell")
    if c_pool["B1"] <= 0 or c_pool["B2"] + c_pool["B4"] + c_pool["B5"] != 0:
        fail(f"pool plan launched {c_pool}")
    if stats.total_writes != sum(r.transitions_final for r in pool_plan.reports.values()):
        fail("pool wear does not sum to the programmed transitions")
    cpu_pool = pool.CrossbarPool(spec, pcfg_pool.crossbars, device="cpu")
    keys = planner.tensor_keys(params, pcfg_pool)
    weights = dict(planner.iter_weights(params, pcfg_pool))
    for name in upto:
        r_cpu, w_hat_cpu = planner.analyze_tensor(weights[name].cpu(), spec, pcfg_pool, keys[name],
                                                  name=name, pool=cpu_pool)
    same_report(pool_plan.reports[CHECK_TENSOR], r_cpu, f"{CHECK_TENSOR} (pool)")
    if pool_plan.deployed[CHECK_TENSOR].cpu().numpy().tobytes() != w_hat_cpu.numpy().tobytes():
        fail(f"CPU pool plan of {CHECK_TENSOR} deploys other w_hat bytes")
    if cpu_pool.state.tobytes() != snap["state"].tobytes() or not (cpu_pool.wear == snap["wear"]).all():
        fail(f"CPU pool after {CHECK_TENSOR} holds other state or wear than the CUDA pool")
    say(f"phase plan-pool-cpu: {CHECK_TENSOR} through a CPU pool: report equal, w_hat bytes, "
        f"pool state bytes and per-cell wear identical to the CUDA pool's")
    del weights, w_cpu

    # --- 5. serve ------------------------------------------------------------
    batch = api.make_batch(cfg, BATCH, PROMPT, seed=0, device=dev)
    want_launch = 7 * LAYERS * GEN

    def served(label, p, kernel, want, layers_cfg=cfg):
        """Warm up, then one timed generate with the counts zeroed just before
        and read just after; tok/s is the best of 3 timed passes."""
        timed = serve.make_generator(layers_cfg, p, batch, gen_len=GEN)
        reset_counts()
        toks, dt = timed()
        c = counts()
        tps = BATCH * GEN / dt
        for _ in range(2):
            tps = max(tps, BATCH * GEN / timed()[1])
        if toks.shape != (BATCH, GEN) or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
            fail(f"{label} tokens malformed: shape {tuple(toks.shape)}")
        others = {k: v for k, v in c.items() if k not in (kernel, "plain") and v}
        if (kernel and c[kernel] != want) or others or c["plain"]:
            fail(f"{label} generate launched {c} (want {kernel} = {want}, nothing else, "
                 f"no plain-version call)")
        return toks, tps, timed, c

    p_dense = planner.deploy_params(params, plan, materialize="dense")
    p_packed = planner.deploy_params(params, plan, materialize="packed")
    tok_fp, tps_fp = serve.generate(cfg, params, batch, gen_len=GEN, repeats=3)
    tok_dense, tps_dense = serve.generate(cfg, p_dense, batch, gen_len=GEN, repeats=3)
    tok_packed, tps_packed, timed_packed, c = served("packed", p_packed, "B2", want_launch)
    b2_launches = c["B2"]
    for name, toks in (("fp", tok_fp), ("dense", tok_dense)):
        if toks.shape != (BATCH, GEN) or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
            fail(f"{name} tokens malformed: shape {tuple(toks.shape)}")
    agree = (tok_packed == tok_dense).float().mean().item()
    say(f"phase serve: batch {BATCH} prompt {PROMPT} gen {GEN} greedy; tok/s fp "
        f"{tps_fp:.1f} cim-dense {tps_dense:.1f} cim-packed {tps_packed:.1f}; packed/dense "
        f"token agreement {agree:.3f}; B2 launches {b2_launches} (want {want_launch}); "
        f"plain-version calls 0")

    say(f"phase trace: cim-packed generate: {trace(timed_packed)}")
    timed_dense = serve.make_generator(cfg, p_dense, batch, gen_len=GEN)
    say(f"phase trace: cim-dense generate: {trace(timed_dense)}")

    def logit_check(p_x, label):
        with torch.inference_mode():
            for dtype_name, rtol in (("bfloat16", BF16_LOGIT_RTOL), ("float32", F32_LOGIT_RTOL)):
                c_ = dataclasses.replace(cfg, dtype=dtype_name)
                ld, _ = api.prefill(p_dense, c_, batch)
                lp, _ = api.prefill(p_x, c_, batch)
                if not (torch.isfinite(ld).all() and torch.isfinite(lp).all()):
                    fail(f"non-finite {dtype_name} prefill logits")
                d = (lp - ld).abs().max().item()
                bound = rtol * ld.abs().max().item()
                say(f"phase logits: {dtype_name} prefill {label} vs dense max |d| {d:.4e} "
                    f"(bound {rtol:g} * max|logit| = {bound:.4e})")
                if d > bound:
                    fail(f"{dtype_name} prefill logits of {label} and dense differ by {d:.4e}")

    logit_check(p_packed, "packed")
    del p_packed, timed_packed, timed_dense
    torch.cuda.empty_cache()

    # int8 planes of the same plan (kernel B5)
    p_int8 = planner.deploy_params(params, plan, materialize="planes_int8")
    int8_gb = sum(v["splanes"].numel() for v in _operand_dicts(p_int8)) / 1e9
    tok_int8, tps_int8, timed_int8, c = served("planes_int8", p_int8, "B5", want_launch)
    b5_launches = c["B5"]
    agree_int8 = (tok_int8 == tok_dense).float().mean().item()
    say(f"phase serve-int8: cim-planes_int8 {tps_int8:.1f} tok/s ({int8_gb:.2f} GB of int8 "
        f"planes); token agreement with dense {agree_int8:.3f}; B5 launches {b5_launches} "
        f"(want {want_launch}); plain-version calls 0")
    say(f"phase trace: cim-planes_int8 generate: {trace(timed_int8)}")
    logit_check(p_int8, "planes_int8")
    del p_int8, timed_int8, p_dense, plan
    torch.cuda.empty_cache()

    # the pool plan served raw (B2) and const_rle-encoded (B4): the same bits
    p_raw_pool = planner.deploy_params(params, pool_plan, materialize="packed", codec="raw")
    p_rle = planner.deploy_params(params, pool_plan, materialize="packed", codec=CODEC)
    n_planned = 0
    for path in ("attn/wq", "attn/wk", "mlp/wi_gate", "mlp/wo"):
        a, b = path.split("/")
        op = {k: v[0] for k, v in p_rle["segments"][0][a][b].items()}
        for m in (1, 4, 128):
            b4_err = max(b4_err, check_b4(op, m, op["kdim"].shape[-2], None, f"planned {path}"))
            n_planned += 1
    live = sum(int(d["plane_tile_nz"].sum()) for d in _operand_dicts(p_rle))
    tiles = sum(d["plane_tile_nz"].numel() for d in _operand_dicts(p_rle))
    say(f"phase B4-planned: layer 0 wq/wk/wi_gate/wo of the {CODEC} deployment at M in "
        f"{{1, 4, 128}}: bit-equal to B2 ({n_planned} cases); live tiles {live}/{tiles} "
        f"({100 * live / tiles:.2f}%)")
    tok_raw_pool, tps_raw_pool, _, _ = served("packed (pool plan)", p_raw_pool, "B2", want_launch)
    tok_rle, tps_rle, timed_rle, c = served(f"packed {CODEC}", p_rle, "B4", want_launch)
    b4_launches = c["B4"]
    if not torch.equal(tok_rle, tok_raw_pool):
        fail(f"{CODEC} tokens differ from raw-packed tokens of the same plan")
    say(f"phase serve-{CODEC}: pool plan served raw-packed {tps_raw_pool:.1f} tok/s and "
        f"{CODEC} {tps_rle:.1f} tok/s; tokens identical; B4 launches {b4_launches} "
        f"(want {want_launch}); plain-version calls 0")
    say(f"phase trace: cim-packed-{CODEC} generate: {trace(timed_rle)}")
    del timed_rle, p_raw_pool
    rle_ops = [{k: v[i] for k, v in p_rle["segments"][0]["mlp"]["wi_gate"].items()}
               for i in range(LAYERS)]
    del p_rle, pool_plan, params
    torch.cuda.empty_cache()

    # col_perm_rle at full width, 1 layer (the host greedy bounds the depth)
    cfg1 = dataclasses.replace(full, n_layers=COLPERM_LAYERS)
    params1 = api.init(cfg1, seed=0, device=dev)
    pcfg_cp = planner.PlannerConfig(p_stuck=P_STUCK, codec="col_perm_rle")
    w_ff = dict(planner.iter_weights(params1, pcfg_cp))["segments/0/mlp/wi_gate"]
    prep = planner._prep(w_ff, spec, pcfg_cp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    planes.plan_col_order(prep.packed_s, prep.chains, pin_cols=pcfg_cp.stuck_cols)
    col_order_s = time.perf_counter() - t0
    n_pairs = sum(len(ch) - 1 for ch in prep.chains) * 100
    say(f"phase plan_col_order: segments/0/mlp/wi_gate {list(w_ff.shape)} "
        f"({prep.packed_s.shape[0]} sections, {n_pairs} column pairs): {col_order_s:.2f} s")
    del prep
    xb1 = pool.CrossbarPool(spec, pcfg_cp.crossbars, device=dev)
    reset_counts()
    t0 = time.perf_counter()
    plan1 = planner.build_deployment(params1, spec, pcfg_cp, pool=xb1, device=dev)
    torch.cuda.synchronize()
    plan1_s = time.perf_counter() - t0
    c1 = counts()
    t1 = plan1.totals()
    say(f"phase plan-col_perm_rle: {COLPERM_LAYERS} layer, {len(plan1.reports)} tensors in "
        f"{plan1_s:.2f} s; sws {t1['sws_speedup']:.4f}x total {t1['total_speedup']:.4f}x; "
        f"B1 launches {c1['B1']}; pool max cell {xb1.stats().max_cell_writes} writes")
    want1 = 7 * COLPERM_LAYERS * GEN
    p1_raw = planner.deploy_params(params1, plan1, materialize="packed", codec="raw")
    p1_cp = planner.deploy_params(params1, plan1, materialize="packed", codec="col_perm_rle")
    tok1_raw, _, _, _ = served("packed (1 layer)", p1_raw, "B2", want1, cfg1)
    tok1_cp, tps1_cp, _, c = served("packed col_perm_rle", p1_cp, "B4", want1, cfg1)
    if not torch.equal(tok1_cp, tok1_raw):
        fail("col_perm_rle tokens differ from raw-packed tokens of the same plan")
    say(f"phase serve-col_perm_rle: {COLPERM_LAYERS} layer, {tps1_cp:.1f} tok/s; tokens "
        f"identical to raw-packed; B4 launches {c['B4']} (want {want1}); plain-version calls 0")
    del params1, plan1, p1_raw, p1_cp, w_ff
    torch.cuda.empty_cache()

    # --- 6. kernels: time, bound, plain, library -------------------------------
    t = 1 << 20
    pairs = [tuple(torch.randint(0, 256, (t, 16, 10), dtype=torch.uint8, device=dev, generator=g)
                   for _ in range(2))]
    b1_ms = cuda_ms(lambda: ham_ops.price_pairs(*pairs[0]))
    b1_plain = cuda_ms(lambda: ham_ref.hamming_pairs(*pairs[0]), reps=5)
    b1_bound = (2 * t * 160 + 4 * t) / HBM_BYTES_PER_S * 1e3
    say(f"phase kernels: B1 T={t}: {b1_ms:.4f} ms (bound {b1_bound:.4f}, plain {b1_plain:.4f})")
    del pairs

    def cycle(n_items):
        it = {"i": 0}

        def nxt():
            it["i"] = (it["i"] + 1) % n_items
            return it["i"]

        return nxt

    def bound(nbytes, flops):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    k, n = cfg.d_model, cfg.d_ff
    records = {}
    for label, m in (("decode", BATCH), ("prefill", BATCH * PROMPT)):
        # four weight copies (4 x 46 MB) cycled so each launch finds L2 cold,
        # as a decode step does: it reads every layer's weights once
        ops = [packed_operands(k, n, 100 + i) for i in range(4)]
        dense = [cim_ref.unpack_weights(p, s, k) * sc for p, s, sc in ops]
        x = torch.randn(m, k, device=dev, generator=g).to(torch.bfloat16)
        xf = x.float()
        nxt = cycle(4)
        ms = cuda_ms(lambda: cim_ops.cim_matmul_packed(x, *ops[nxt()]))
        plain = cuda_ms(lambda: cim_ref.cim_matmul_packed(x, *ops[nxt()]), reps=5)
        library = cuda_ms(lambda: torch.matmul(xf, dense[nxt()]))
        b, by = bound(m * k * 2 + 11 * (k // 8) * n + m * n * 4, 2 * m * k * n)
        records[label] = dict(ms=ms, plain_ms=plain, library_ms=library, bound_ms=b, bound_by=by)
        say(f"phase kernels: B2 {label} M={m} K={k} N={n} bf16: {ms:.4f} ms (bound "
            f"{b:.4f} by {by}, plain {plain:.4f}, torch.matmul on dense f32 {library:.4f})")

        # B4 on the const_rle deployment's wi_gate, one copy per layer
        nxt = cycle(LAYERS)

        def b4_call(op):
            return cim_ops.cim_matmul_packed(x, op["planes_packed"], op["sign_packed"], op["scale"],
                                             tile_nz=op["plane_tile_nz"])

        ms4 = cuda_ms(lambda: b4_call(rle_ops[nxt()]))
        ms2 = cuda_ms(lambda: cim_ops.cim_matmul_packed(
            x, *(rle_ops[nxt()][f] for f in ("planes_packed", "sign_packed", "scale"))))
        plain4 = cuda_ms(lambda: cim_ref.cim_matmul_packed(
            x, *(rle_ops[nxt()][f] for f in ("planes_packed", "sign_packed", "scale"))), reps=5)
        dense4 = [simulator.densify_operands(op) for op in rle_ops]
        library4 = cuda_ms(lambda: torch.matmul(xf, dense4[nxt()]))
        payload = planes.operand_payload_bytes(rle_ops[0])["total_bytes"]
        b, by = bound(m * k * 2 + payload + m * n * 4, 2 * m * k * n)
        records[f"B4 {label}"] = dict(ms=ms4, plain_ms=plain4, library_ms=library4, bound_ms=b,
                                      bound_by=by)
        say(f"phase kernels: B4 {label} M={m} on the {CODEC} wi_gate operands (all tiles "
            f"live): {ms4:.4f} ms, B2 on the same {ms2:.4f} ms (bound {b:.4f} by {by}, plain "
            f"{plain4:.4f}, torch.matmul {library4:.4f})")
        del ops, dense, dense4

        # B4 against B2 as the share of zero tiles grows
        sweep = []
        for share in ZERO_SHARES:
            zops = [zero_tile_operands(k, n, 200 + i, share) for i in range(4)]
            nxt = cycle(4)
            z4 = cuda_ms(lambda: b4_call(zops[nxt()]))
            z2 = cuda_ms(lambda: cim_ops.cim_matmul_packed(
                x, *(zops[nxt()][f] for f in ("planes_packed", "sign_packed", "scale"))))
            live_share = float(zops[0]["plane_tile_nz"].float().mean())
            zb, _ = bound(m * k * 2 + planes.operand_payload_bytes(zops[0])["total_bytes"]
                          + m * n * 4, 2 * m * k * n)
            sweep.append(f"{share:.0%}: B4 {z4:.4f} / B2 {z2:.4f} ms (live {live_share:.1%}, "
                         f"bound {zb:.4f})")
            del zops
        say(f"phase kernels: B4 vs B2 {label} M={m} by zero-tile share: " + "; ".join(sweep))

        # B5, both modes, on four int8-plane copies
        i8 = []
        for i in range(4):
            gg = torch.Generator(device=dev).manual_seed(300 + i)
            q = torch.randint(0, 1024, (k, n), dtype=torch.int32, device=dev, generator=gg)
            s = torch.where(torch.rand(k, n, device=dev, generator=gg) < 0.5, -1, 1).to(torch.int8)
            i8.append(simulator.int8_plane_operands(q, s, 0.02 / 1023, 0.0, 10))
            i8[-1]["dense"] = q.float() * s.float() * i8[-1]["scale"]
            del q, s
        nxt = cycle(4)
        ms5 = {mode: cuda_ms(lambda: cim_ops.cim_matmul(
            x, i8[nxt()]["splanes"], i8[0]["scale"], mode=mode)) for mode in cim_ref.MODES}
        plain5 = cuda_ms(lambda: cim_ref.cim_matmul(x, i8[nxt()]["splanes"], i8[0]["scale"]),
                         reps=3)
        library5 = cuda_ms(lambda: torch.matmul(xf, i8[nxt()]["dense"]))
        b, by = bound(m * k * 2 + 10 * k * n + m * n * 4, 2 * m * k * n)
        records[f"B5 {label}"] = dict(ms=ms5["fused_dequant"], plain_ms=plain5,
                                      library_ms=library5, bound_ms=b, bound_by=by)
        say(f"phase kernels: B5 {label} M={m} K={k} N={n} bf16: fused_dequant "
            f"{ms5['fused_dequant']:.4f} ms, planes {ms5['planes']:.4f} ms (bound {b:.4f} by "
            f"{by}, plain {plain5:.4f}, torch.matmul on dense f32 {library5:.4f})")
        del i8
        torch.cuda.empty_cache()

    def row(name, source, replaces, launches, err, rec):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]}

    kernels = [
        row("hamming_pairs", "src/repro_torch/csrc/hamming.cu",
            "src/repro/kernels/hamming/kernel.py:32", c_pool["B1"], b1_err,
            dict(ms=b1_ms, plain_ms=b1_plain, bound_ms=b1_bound, bound_by="bytes",
                 library_ms=None)),
        row("cim_matmul_packed", "src/repro_torch/csrc/cim_matmul.cu",
            "src/repro/kernels/cim_matmul/kernel.py:242", b2_launches, b2_err,
            records["decode"]),
        row("cim_matmul_packed_skip", "src/repro_torch/csrc/cim_matmul.cu",
            "src/repro/kernels/cim_matmul/kernel.py:193", b4_launches, b4_err,
            records["B4 decode"]),
        row("cim_matmul_planes", "src/repro_torch/csrc/cim_planes.cu",
            "src/repro/kernels/cim_matmul/kernel.py:74", b5_launches, b5_err,
            records["B5 decode"]),
    ]
    say("kernels: " + ", ".join(
        f"{r['name']} launches={r['launches']} max_abs_err={r['max_abs_err']:.3e} "
        f"ms={r['ms']:.4f} bound_ms={r['bound_ms']:.4f}"
        + (f" library_ms={r['library_ms']:.4f}" if r["library_ms"] is not None else "")
        for r in kernels))
    say(f"phase done: {time.perf_counter() - t_start:.1f} s after the build started")
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


def _operand_dicts(tree):
    """Every crossbar operand dict of a params tree."""
    if isinstance(tree, dict):
        if "planes_packed" in tree or "splanes" in tree:
            yield tree
            return
        for v in tree.values():
            yield from _operand_dicts(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _operand_dicts(v)


if __name__ == "__main__":
    main()
