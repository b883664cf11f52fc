#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Drives the port's main path — plan gemma-2b onto 128x10 crossbars, then
serve it from the packed bits — at the model's full width with the depth cut
to 4 layers, and holds each hand-written kernel against its plain PyTorch
version on the card.  Phases (one line each, any failed check exits 1):

  1. card + build: name and power limit, the kernels built from csrc/;
  2. B1 (Hamming pricing) == its plain version, exactly;
  3. B2 (packed CIM matmul) vs its plain version at gemma-2b's shapes,
     within |d| <= 2 * eps_f32 * K * (|x| @ |w|) (the two sum K products in
     different orders, each within K * eps of exact);
  4. plan: build_deployment on the card, B1 launches > 0, and one stacked
     tensor planned again on the CPU with an identical report and w_hat;
  5. serve: generate with fp, cim-dense and cim-packed weights; B2 launches
     over one timed packed pass == 7 * layers * gen;
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


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: the smoke run needs one card")
    try:
        from repro_torch.configs import get_arch
        from repro_torch.core import bitslice, planner
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
    regs = [ln.split(":", 1)[-1].strip() for log in logs.values()
            for ln in log.splitlines() if "registers" in ln]
    say(f"phase build: {sorted(logs) or 'cached'} in {build_s:.1f} s; "
        f"ptxas: {' | '.join(regs[:4]) or 'n/a'}")

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

    # --- 3. B2 against its plain version --------------------------------------
    def packed_operands(k, n, seed):
        gg = torch.Generator(device=dev).manual_seed(seed)
        q = torch.randint(0, 1024, (k, n), dtype=torch.int32, device=dev, generator=gg)
        s = torch.where(torch.rand(k, n, device=dev, generator=gg) < 0.5, -1, 1).to(torch.int8)
        return (bitslice.pack_linear_planes(q, 10), bitslice.pack_linear_sign(s),
                torch.tensor(0.02 / 1023, device=dev))

    b2_err, n_checks = 0.0, 0
    cases = [(m, k, n) for k, n in ((2048, 2048), (2048, 256), (2048, 16384), (16384, 2048))
             for m in (1, 4, 128)] + [(5, 1001, 333)]
    for m, k, n in cases:
        planes, signs, scale = packed_operands(k, n, m + k + n)
        w_abs = cim_ref.unpack_weights(planes, signs, k).abs() * scale
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(m, k, device=dev, generator=g).to(dtype)
            got = cim_ops.cim_matmul_packed(x, planes, signs, scale)
            want = cim_ref.cim_matmul_packed(x, planes, signs, scale)
            torch.cuda.synchronize()
            bound = B2_BOUND_C * eps * k * (x.float().abs() @ w_abs)
            err = (got - want).abs()
            if got.shape != (m, n) or not bool((err <= bound).all()):
                fail(f"B2 outside |d| <= {B2_BOUND_C}*eps*K*(|x|@|w|) at M={m} K={k} N={n} "
                     f"{dtype}: max err {err.max().item():.3e}")
            b2_err = max(b2_err, err.max().item())
            n_checks += 1
        del w_abs
    say(f"phase B2: {n_checks} cases within {B2_BOUND_C}*eps*K*(|x|@|w|), "
        f"max |d| {b2_err:.3e}")

    # --- 4. plan gemma-2b at full width --------------------------------------
    full = get_arch("gemma-2b")
    cfg = dataclasses.replace(full, n_layers=LAYERS)
    say(f"phase plan: gemma-2b d_model={cfg.d_model} heads={cfg.n_heads} kv={cfg.n_kv_heads} "
        f"head_dim={cfg.head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab_size}; depth cut "
        f"{full.n_layers} -> {LAYERS} layers (the only cut), p_stuck={P_STUCK}")
    params = api.init(cfg, seed=0, device=dev)
    spec, pcfg = planner.CrossbarSpec(), planner.PlannerConfig(p_stuck=P_STUCK)
    ham_ops.price_pairs.launches = cim_ops.cim_matmul_packed.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = planner.build_deployment(params, spec, pcfg, device=dev)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    b1_launches, b2_in_plan = ham_ops.price_pairs.launches, cim_ops.cim_matmul_packed.launches
    for name, r in plan.reports.items():
        say(f"  {name} {list(r.shape)}: sws {r.sws_speedup:.3f}x total {r.total_speedup:.3f}x "
            f"({r.transitions_baseline} -> {r.transitions_sws} -> {r.transitions_final})")
    tot = plan.totals()
    say(f"phase plan: {len(plan.reports)} tensors in {plan_s:.2f} s; sws "
        f"{tot['sws_speedup']:.4f}x total {tot['total_speedup']:.4f}x; B1 launches {b1_launches}")
    if b1_launches <= 0 or b2_in_plan != 0:
        fail(f"plan launched B1 {b1_launches} times and B2 {b2_in_plan} times")

    key = planner.tensor_keys(params, pcfg)[CHECK_TENSOR]
    w_cpu = dict(planner.iter_weights(params, pcfg))[CHECK_TENSOR].cpu()
    r_cpu, w_hat_cpu = planner.analyze_tensor(w_cpu, spec, pcfg, key, name=CHECK_TENSOR)
    r_gpu, w_hat_gpu = plan.reports[CHECK_TENSOR], plan.deployed[CHECK_TENSOR].cpu()
    a, b = dataclasses.asdict(r_gpu), dataclasses.asdict(r_cpu)
    for field in a:
        same = (abs(a[field] - b[field]) <= QUANT_MSE_RTOL * abs(a[field])
                if field == "quant_mse" else a[field] == b[field])
        if not same:
            fail(f"CPU plan of {CHECK_TENSOR} differs in {field}: {a[field]} vs {b[field]}")
    if w_hat_gpu.numpy().tobytes() != w_hat_cpu.numpy().tobytes():
        fail(f"CPU plan of {CHECK_TENSOR} deploys other w_hat bytes")
    say(f"phase plan-cpu: {CHECK_TENSOR} planned on the CPU: report equal (quant_mse, a "
        f"float mean summed in another order, within {QUANT_MSE_RTOL:g}), w_hat bytes identical")

    # --- 5. serve ------------------------------------------------------------
    batch = api.make_batch(cfg, BATCH, PROMPT, seed=0, device=dev)
    p_dense = planner.deploy_params(params, plan, materialize="dense")
    p_packed = planner.deploy_params(params, plan, materialize="packed")
    tok_fp, tps_fp = serve.generate(cfg, params, batch, gen_len=GEN, repeats=3)
    tok_dense, tps_dense = serve.generate(cfg, p_dense, batch, gen_len=GEN, repeats=3)
    timed_packed = serve.make_generator(cfg, p_packed, batch, gen_len=GEN)  # warm-up inside
    ham_ops.price_pairs.launches = cim_ops.cim_matmul_packed.launches = 0
    tok_packed, dt = timed_packed()
    b2_launches, b1_in_serve = cim_ops.cim_matmul_packed.launches, ham_ops.price_pairs.launches
    tps_packed = BATCH * GEN / dt
    for _ in range(2):
        tps_packed = max(tps_packed, BATCH * GEN / timed_packed()[1])
    want_b2 = 7 * LAYERS * GEN
    for name, toks in (("fp", tok_fp), ("dense", tok_dense), ("packed", tok_packed)):
        if toks.shape != (BATCH, GEN) or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
            fail(f"{name} tokens malformed: shape {tuple(toks.shape)}")
    agree = (tok_packed == tok_dense).float().mean().item()
    say(f"phase serve: batch {BATCH} prompt {PROMPT} gen {GEN} greedy; tok/s fp "
        f"{tps_fp:.1f} cim-dense {tps_dense:.1f} cim-packed {tps_packed:.1f}; packed/dense "
        f"token agreement {agree:.3f}; B2 launches {b2_launches} (want {want_b2})")
    if b2_launches != want_b2 or b1_in_serve != 0:
        fail(f"packed pass launched B2 {b2_launches} times (want {want_b2}), B1 {b1_in_serve}")

    say(f"phase trace: cim-packed generate: {trace(timed_packed)}")
    timed_dense = serve.make_generator(cfg, p_dense, batch, gen_len=GEN)
    say(f"phase trace: cim-dense generate: {trace(timed_dense)}")

    with torch.inference_mode():
        for dtype_name, rtol in (("bfloat16", BF16_LOGIT_RTOL), ("float32", F32_LOGIT_RTOL)):
            c = dataclasses.replace(cfg, dtype=dtype_name)
            ld, _ = api.prefill(p_dense, c, batch)
            lp, _ = api.prefill(p_packed, c, batch)
            if not (torch.isfinite(ld).all() and torch.isfinite(lp).all()):
                fail(f"non-finite {dtype_name} prefill logits")
            d = (lp - ld).abs().max().item()
            bound = rtol * ld.abs().max().item()
            say(f"phase logits: {dtype_name} prefill packed vs dense max |d| {d:.4e} "
                f"(bound {rtol:g} * max|logit| = {bound:.4e})")
            if d > bound:
                fail(f"{dtype_name} prefill logits of packed and dense differ by {d:.4e}")
    del p_dense, p_packed, plan, params
    torch.cuda.empty_cache()

    # --- 6. kernels: time, bound, plain, library -------------------------------
    t = 1 << 20
    pairs = [tuple(torch.randint(0, 256, (t, 16, 10), dtype=torch.uint8, device=dev, generator=g)
                   for _ in range(2))]
    b1_ms = cuda_ms(lambda: ham_ops.price_pairs(*pairs[0]))
    b1_plain = cuda_ms(lambda: ham_ref.hamming_pairs(*pairs[0]), reps=5)
    b1_bound = (2 * t * 160 + 4 * t) / HBM_BYTES_PER_S * 1e3
    say(f"phase kernels: B1 T={t}: {b1_ms:.4f} ms (bound {b1_bound:.4f}, plain {b1_plain:.4f})")

    records = {}
    for label, m in (("decode", BATCH), ("prefill", BATCH * PROMPT)):
        k, n = cfg.d_model, cfg.d_ff
        # four weight copies (4 x 46 MB) cycled so each launch finds L2 cold,
        # as a decode step does: it reads every layer's weights once
        ops = [packed_operands(k, n, 100 + i) for i in range(4)]
        dense = [cim_ref.unpack_weights(p, s, k) * sc for p, s, sc in ops]
        x = torch.randn(m, k, device=dev, generator=g).to(torch.bfloat16)
        xf = x.float()
        it = {"i": 0}

        def nxt():
            it["i"] = (it["i"] + 1) % 4
            return it["i"]

        ms = cuda_ms(lambda: cim_ops.cim_matmul_packed(x, *ops[nxt()]))
        plain = cuda_ms(lambda: cim_ref.cim_matmul_packed(x, *ops[nxt()]), reps=5)
        library = cuda_ms(lambda: torch.matmul(xf, dense[nxt()]))
        nbytes = m * k * 2 + 11 * (k // 8) * n + m * n * 4
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * m * k * n / F32_FLOPS * 1e3
        records[label] = dict(ms=ms, plain_ms=plain, library_ms=library,
                              bound_ms=max(t_bytes, t_ops),
                              bound_by="bytes" if t_bytes >= t_ops else "operations")
        say(f"phase kernels: B2 {label} M={m} K={k} N={n} bf16: {ms:.4f} ms (bound "
            f"{records[label]['bound_ms']:.4f} by {records[label]['bound_by']}, plain "
            f"{plain:.4f}, torch.matmul on dense f32 {library:.4f})")
        del ops, dense

    dec = records["decode"]
    kernels = [
        {"name": "hamming_pairs", "route": "cuda", "source": "src/repro_torch/csrc/hamming.cu",
         "replaces": "src/repro/kernels/hamming/kernel.py:32", "launches": b1_launches,
         "max_abs_err": b1_err, "ms": b1_ms, "plain_ms": b1_plain, "bound_ms": b1_bound,
         "bound_by": "bytes", "library_ms": None},
        {"name": "cim_matmul_packed", "route": "cuda",
         "source": "src/repro_torch/csrc/cim_matmul.cu",
         "replaces": "src/repro/kernels/cim_matmul/kernel.py:242", "launches": b2_launches,
         "max_abs_err": b2_err, "ms": dec["ms"], "plain_ms": dec["plain_ms"],
         "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
         "library_ms": dec["library_ms"]},
    ]
    say("kernels: " + ", ".join(
        f"{r['name']} launches={r['launches']} max_abs_err={r['max_abs_err']:.3e} "
        f"ms={r['ms']:.4f} bound_ms={r['bound_ms']:.4f}"
        + (f" library_ms={r['library_ms']:.4f}" if r["library_ms"] is not None else "")
        for r in kernels))
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
