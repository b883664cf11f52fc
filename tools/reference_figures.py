#!/usr/bin/env python
"""Write the JAX reference's figure and accuracy results for the port to match.

Runs the reference's own ``run`` functions (``benchmarks/fig5_sws_single.py``
through ``fig8_stucking.py``, the ``transitions_sweep`` halves of
``fig9_p_sweep.py`` and ``fig10_columns.py``) and its packed planner on
``benchmarks/planner_throughput.py``'s gemma-2b-scale weights, on the CPU,
and writes their integers and speedups, the caps, the seed and the jax
version to ``benchmarks_torch/golden/reference.json``.  The planner entry
also holds every tensor's report integers and a sha256 of each deployed
``w_hat``'s float32 bytes.

The ``accuracy`` entry is the reference's trained reduced LM
(``benchmarks/trained_lm.py``): its 120 training losses, the
``accuracy_sweep`` halves of fig9 and fig10 and ``accuracy_e2e.run()``,
and for every evaluation the predictions at each held-out position (hex,
one byte each), the positions whose top-2 logit gap is below
``NEAR_TIE`` and every plan's totals; the trained weights go to
``benchmarks_torch/golden/trained_lm_seed<seed>.npz`` ('/'-joined leaf
names).

The ``trainer`` entry is the full-width trainer cell of ``chip_smoke.py``:
internlm2-1.8b at its published widths with the depth cut to 2 layers
(bf16 compute on f32 masters), ``lm`` task, batch 8, seq 128, lr 3e-4,
8 steps, remat ``none``, run through the reference's ``make_train_step``
from ``init(PRNGKey(seed))``: the losses, grad norms and lrs, and the CPU
seconds of the compile and of each step (~75 s and ~12 GB on 8 cores).

The ``pool_wear``, ``plane_compression`` and ``redeploy_delta`` entries
are the reference's ``benchmarks/`` runs of those names at
``benchmarks/run.py``'s settings (3 deployments; ``--max-elems`` a tensor
and gen 4; 20 further steps), seconds apart.  ``pool_wear`` also
holds the ``jnp.std`` of every drifted leaf at each drift step (float32
hex), ``plane_compression`` the served token arrays, and
``redeploy_delta`` every ``RedeployReport`` field; the post-step weights
of the 4 priced tensors go to ``golden/redeploy_delta_seed<seed>.npz``.

The ``fault_tolerance`` and ``integrity_scrub`` entries are those
``benchmarks/`` runs at their settings (the fault curve and
endurance horizons; storm and repair and the tolerated-fault KL), each
logit KL also computed in float64 from the same float32 logits, and each
fault-curve deployment's pool stats, wear per crossbar and leaf sha256s.
Their engine halves are the reference's ``run_hot_redeploy`` (its counters
and horizons), ``run_engine_scrub`` (its counters and parities) and the
integers of ``run_scrub_overhead`` at the port's 32 requests and 5
trials (``OVERHEAD_REQUESTS``, ``OVERHEAD_TRIALS``; the reference
benchmark's own 4 requests give trials with no scrub round).
``serve_faults`` is the printed report of the reference's serve CLI with
faults, leveling and a scrubbed storm on the reduced gemma-2b (``SERVE_FAULTS_ARGS``).

The ``engine`` entry is the reference's continuous-batching engine on the
reduced gemma-2b: ``benchmarks_torch.engine_throughput``'s parity trace
(``PARITY_TRACE``, every arrival at 0.0, ``submit`` + ``step(now)``)
served ``PARITY_VARIANTS`` (dense and packed, fused and split) with
``PARITY_ENGINE``: every request's tokens, the engine's stats and shapes,
and for each request the steps whose top-2 gap (of the logits, plus the
step's Gumbel noise for a sampled request, from a teacher-forced forward of
the stream) is below ``NEAR_TIE``; and ``run_overcommit``'s integers in swap
and recompute mode.

The ``fleet_tolerance`` entry is the reference's
``benchmarks/fleet_tolerance.run()`` at its settings: the fields of each
section that do not depend on the wall clock
(``benchmarks_torch.fleet_tolerance.WALL_FREE``), every request's status
and tokens, and the TP rows' tokens.  The reference's ``launch/fleet.py``
does not import on Python 3.11+ (ROADMAP C.1): the tool gives
``FaultPolicy`` a hash while importing it, then takes it away again.

``--parts accuracy,trainer`` (any of the entry names) recomputes those
entries alone and keeps the rest of the file.

This tool imports ``jax``, ``repro`` and ``benchmarks`` on purpose: it is
not part of the port.  The port and ``chip_smoke.py`` only read the file.
It takes the record's layout (the planner's report fields, the sweep cap)
from ``benchmarks_torch``, which reads it.

  PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference_figures.py \\
      [--max-elems 2000000] [--planner-max-elems 750000] [--planner-layers 6] \\
      [--parts all|fig5,...,accuracy,trainer,pool_wear,...]

The weights come from ``jax.random.normal`` on XLA:CPU; the port's
``prng.normal`` reproduces those draws bit for bit on an x86-64 host with
FMA (XLA's machine code there fuses the multiply-adds of ``log1p`` and
``erf_inv``).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

OUT = ROOT / "benchmarks_torch" / "golden" / "reference.json"
NEAR_TIE = 1e-4  # top-2 logit gap below which the port's argmax may differ
OVERHEAD_REQUESTS = 32  # benchmarks_torch.integrity_scrub.OVERHEAD_REQUESTS
OVERHEAD_TRIALS = 5  # benchmarks_torch.integrity_scrub.OVERHEAD_TRIALS


def planner_plan(max_elems: int, layers: int, p_stuck: float = 0.5) -> dict:
    """The reference's packed plan of planner_throughput's weights."""
    import numpy as np

    from benchmarks.planner_throughput import gemma_scale_params
    from benchmarks_torch.planner_throughput import REPORT_FIELDS
    from repro.core.planner import CrossbarSpec, PlannerConfig, build_deployment

    params = gemma_scale_params(max_elems=max_elems, layers=layers)
    plan = build_deployment(params, CrossbarSpec(rows=128, cols=10),
                            PlannerConfig(p_stuck=p_stuck, min_size=1024, impl="packed"))
    return {
        "max_elems": max_elems,
        "layers": layers,
        "p_stuck": p_stuck,
        "totals": plan.totals(),
        "reports": {k: {f: getattr(r, f) for f in REPORT_FIELDS}
                    for k, r in plan.reports.items()},
        "w_hat_sha256": {k: hashlib.sha256(np.asarray(w).tobytes()).hexdigest()
                         for k, w in plan.deployed.items()},
    }


def _eval_record(cfg, params, batch_fn, n_batches: int = 4) -> dict:
    """The reference's held-out predictions, correct count and near ties."""
    import jax.numpy as jnp
    import numpy as np

    from repro.models import api

    preds, gaps, correct, total = [], [], 0, 0
    for i in range(n_batches):
        batch = batch_fn(i)
        logits = np.asarray(api.forward(params, cfg, batch)[0][:, :-1])
        pred = logits.argmax(-1)
        top2 = np.sort(logits, axis=-1)[..., -2:]
        tgt = np.asarray(batch["tokens"][:, 1:])
        correct += int((pred == tgt).sum())
        total += tgt.size
        preds.append(pred)
        gaps.append(top2[..., 1] - top2[..., 0])
    preds, gaps = np.stack(preds), np.stack(gaps).reshape(-1)
    assert preds.max() < 256
    return {"correct": correct, "total": total, "shape": list(preds.shape),
            "preds": preds.astype(np.uint8).tobytes().hex(),
            "near_ties": [int(i) for i in np.flatnonzero(gaps < NEAR_TIE)],
            "min_gap": float(gaps.min())}


def accuracy_record(seed: int = 0) -> dict:
    """The reference's trained LM, its sweeps and e2e check (see module doc)."""
    import jax
    import numpy as np

    from benchmarks import accuracy_e2e, fig9_p_sweep, fig10_columns, trained_lm
    from repro.core.planner import CrossbarSpec, PlannerConfig, build_deployment, deploy_params
    from repro.data import DataConfig, make_dataset
    from repro.launch.steps import make_train_step
    from repro.models import api
    from repro.optim import AdamWConfig, adamw_init

    # the losses of trained_lm's own loop, which it does not return
    t0 = time.perf_counter()
    cfg = trained_lm.get_arch(trained_lm.ARCH, reduced=True)
    ds = make_dataset(DataConfig(cfg.vocab_size, trained_lm.SEQ, trained_lm.BATCH, task="copy",
                                 seed=seed))
    step = jax.jit(make_train_step(cfg, AdamWConfig(lr=3e-3, warmup_steps=10,
                                                    total_steps=trained_lm.STEPS)))
    params = api.init(jax.random.PRNGKey(seed), cfg)
    opt = adamw_init(params)
    losses = []
    for s in range(trained_lm.STEPS):
        params, opt, m = step(params, opt, ds.batch_at(s))
        losses.append(float(m["loss"]))
    train_s = time.perf_counter() - t0
    cfg_, trained, batch_fn = trained_lm.get_trained_lm(seed=seed)
    flat = {jax.tree_util.keystr(p, simple=True, separator="/"): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(trained)[0]}
    mine = {jax.tree_util.keystr(p, simple=True, separator="/"): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert all(flat[k].tobytes() == mine[k].tobytes() for k in flat), "training not replayed"
    npz = OUT.parent / f"trained_lm_seed{seed}.npz"
    np.savez(npz, **flat)

    def sweep_evals(configs):
        ev = {"fp": _eval_record(cfg_, trained, batch_fn)}
        for label, spec, pcfg in configs:
            plan = build_deployment(trained, spec, pcfg)
            ev[label] = _eval_record(cfg_, deploy_params(trained, plan), batch_fn)
            ev[label]["totals"] = plan.totals()
        return ev

    spec10 = CrossbarSpec(rows=128, cols=10)
    out = {
        "arch": trained_lm.ARCH, "steps": trained_lm.STEPS, "seq": trained_lm.SEQ,
        "batch": trained_lm.BATCH, "seed": seed, "near_tie": NEAR_TIE,
        "train_losses": losses, "train_seconds_cpu": train_s,
        "npz": npz.name, "npz_values": int(sum(v.size for v in flat.values())),
        "npz_bytes": npz.stat().st_size,
        "npz_sha256": hashlib.sha256(npz.read_bytes()).hexdigest(),
        "fig9": fig9_p_sweep.accuracy_sweep(seed=seed),
        "fig10": fig10_columns.accuracy_sweep(seed=seed),
        "e2e": accuracy_e2e.run(seed=seed),
    }
    out["fig9_evals"] = sweep_evals([
        (f"p={p}", spec10, PlannerConfig(p_stuck=p, min_size=1024, seed=seed))
        for p in fig9_p_sweep.PS])
    out["fig10_evals"] = sweep_evals([
        (f"cols={c}", CrossbarSpec(rows=128, cols=c),
         PlannerConfig(p_stuck=fig10_columns.P, min_size=1024, seed=seed))
        for c in fig10_columns.COLS_SWEEP])
    out["e2e_evals"] = sweep_evals([
        ("cim", spec10, PlannerConfig(p_stuck=0.5, min_size=1024, seed=seed))])
    # the sweeps' own accuracies are the recorded predictions'
    for fig, key in (("fig9", "per_p"), ("fig10", "per_cols")):
        for k, r in out[fig][key].items():
            lab = f"p={k}" if fig == "fig9" else f"cols={k}"
            ev = out[f"{fig}_evals"][lab]
            assert ev["correct"] / ev["total"] == r["accuracy"], (fig, k)
    return out


TRAINER = dict(arch="internlm2-1.8b", layers=2, task="lm", batch=8, seq=128, lr=3e-4,
               total_steps=8, remat="none")


def trainer_record(seed: int = 0) -> dict:
    """The reference's steps of the full-width trainer cell."""
    import dataclasses

    import jax

    from repro.configs import get_arch
    from repro.data import DataConfig, make_dataset
    from repro.launch.steps import make_train_step
    from repro.models import api
    from repro.optim import AdamWConfig, adamw_init

    t = TRAINER
    cfg = dataclasses.replace(get_arch(t["arch"]), n_layers=t["layers"])
    opt_cfg = AdamWConfig(lr=t["lr"], total_steps=t["total_steps"],
                          warmup_steps=min(20, t["total_steps"] // 5))
    # donated: the old params and moments are not kept beside the new ones
    step = jax.jit(make_train_step(cfg, opt_cfg, remat=t["remat"]), donate_argnums=(0, 1))
    ds = make_dataset(DataConfig(cfg.vocab_size, t["seq"], t["batch"], task=t["task"],
                                 seed=seed))
    params = api.init(jax.random.PRNGKey(seed), cfg)
    opt = adamw_init(params)
    t0 = time.perf_counter()
    compiled = step.lower(params, opt, ds.batch_at(0)).compile()
    out = {**t, "seed": seed, "dtype": cfg.dtype, "d_model": cfg.d_model,
           "vocab_size": cfg.vocab_size, "compile_seconds_cpu": time.perf_counter() - t0,
           "losses": [], "grad_norms": [], "lrs": [], "step_seconds_cpu": []}
    for s in range(t["total_steps"]):
        t0 = time.perf_counter()
        params, opt, m = compiled(params, opt, ds.batch_at(s))
        out["losses"].append(float(m["loss"]))
        out["step_seconds_cpu"].append(time.perf_counter() - t0)
        out["grad_norms"].append(float(m["grad_norm"]))
        out["lrs"].append(float(m["lr"]))
        print(f"trainer step {s + 1}: loss {out['losses'][-1]!r} "
              f"({out['step_seconds_cpu'][-1]:.1f} s)", flush=True)
    return out


def _f32_hex(x) -> str:
    import numpy as np

    return f"{int(np.asarray(x, np.float32).reshape(1).view(np.uint32)[0]):08x}"


def pool_wear_record(deployments: int = 3, seed: int = 0) -> dict:
    """The reference's ``pool_wear.run`` (seconds apart) and the ``jnp.std``
    of every drifted leaf at each drift step, as float32 hex."""
    import jax
    import jax.numpy as jnp

    from benchmarks import pool_wear

    res = pool_wear.run(deployments=deployments, seed=seed)
    stds = []
    for params in pool_wear._checkpoints(deployments, seed):
        stds.append({jax.tree_util.keystr(p, simple=True, separator="/"): _f32_hex(jnp.std(w))
                     for p, w in jax.tree_util.tree_flatten_with_path(params)[0] if w.ndim >= 2})
    seconds = {lev: r.pop("seconds") for lev, r in res["levelings"].items()}
    res.pop("backend")
    return {**res, "seed": seed, "stds": stds, "seconds_cpu": seconds}


def plane_compression_record(max_elems: int, gen: int = 4, seed: int = 0) -> dict:
    """The reference's ``plane_compression.run`` and the token arrays of its
    serving half (dense and each codec), which ``run`` compares but does
    not return."""
    import jax
    import numpy as np

    from benchmarks import plane_compression as pc
    from repro.configs import get_arch
    from repro.core.planner import CrossbarSpec, PlannerConfig, build_deployment, deploy_params
    from repro.launch.serve import generate
    from repro.models import api

    res = pc.run(max_elems=max_elems, gen=gen, seed=seed)
    cfg = get_arch("gemma-2b", reduced=True)
    key = jax.random.PRNGKey(0)
    params = api.init(key, cfg)
    batch = api.make_batch(cfg, key, 2, 12)
    plan = build_deployment(params, CrossbarSpec(rows=128, cols=pc.COLS),
                            PlannerConfig(p_stuck=1.0, min_size=1024))
    dense = np.asarray(generate(cfg, deploy_params(params, plan), batch, gen_len=gen)[0])
    res["serving"]["tokens_dense"] = dense.tolist()
    for codec, r in res["serving"]["codecs"].items():
        p = deploy_params(params, plan, materialize="packed", codec=codec)
        toks = np.asarray(generate(cfg, p, batch, gen_len=gen)[0])
        assert r["tokens_match_dense"] == bool(np.array_equal(toks, dense)), codec
        r["tokens"] = toks.tolist()
    return {**res, "gen": gen, "seed": seed}


def redeploy_delta_record(seed: int = 0, extra_steps: int = 20) -> dict:
    """The reference's ``redeploy_delta.run``, every ``RedeployReport`` field
    of its priced tensors, and their post-step weights (golden npz)."""
    import dataclasses

    import jax
    import numpy as np

    from benchmarks import redeploy_delta, trained_lm
    from repro.core.redeploy import delta_cost
    from repro.data import DataConfig, make_dataset
    from repro.launch.steps import make_train_step
    from repro.optim import AdamWConfig, adamw_init

    res = redeploy_delta.run(extra_steps=extra_steps, seed=seed)
    # the same steps again, keeping the weights run() prices
    cfg, params_old, _ = trained_lm.get_trained_lm(seed=seed)
    ds = make_dataset(DataConfig(cfg.vocab_size, 64, 8, task="copy", seed=seed))
    step = jax.jit(make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1,
                                                    total_steps=extra_steps)))
    params, opt = params_old, adamw_init(params_old)
    for s in range(extra_steps):
        params, opt, _ = step(params, opt, ds.batch_at(20_000 + s))
    name_of = lambda p: jax.tree_util.keystr(p, simple=True, separator="/")  # noqa: E731
    old = dict((name_of(p), v) for p, v in jax.tree_util.tree_flatten_with_path(params_old)[0])
    new = dict((name_of(p), v) for p, v in jax.tree_util.tree_flatten_with_path(params)[0])
    reports = {}
    for name in res["tensors"]:
        rep = delta_cost(old[name], new[name], name=name)
        reports[name] = {**dataclasses.asdict(rep), "sws_delta_speedup": rep.sws_delta_speedup,
                         "stale_sort_speedup": rep.stale_sort_speedup,
                         "fresh_sort_speedup": rep.fresh_sort_speedup}
        assert reports[name]["chain_stale_sws"] == res["tensors"][name]["chain_stale_sws"], name
    npz = OUT.parent / f"redeploy_delta_seed{seed}.npz"
    np.savez(npz, **{name: np.asarray(new[name]) for name in res["tensors"]})
    return {**res, "seed": seed, "reports": reports, "npz": npz.name,
            "npz_sha256": hashlib.sha256(npz.read_bytes()).hexdigest()}


def _leaf_sha256(tree) -> dict:
    """sha256 of every leaf's float32 bytes, by '/'-joined name."""
    import jax
    import numpy as np

    return {jax.tree_util.keystr(p, simple=True, separator="/"):
            hashlib.sha256(np.asarray(v, np.float32).tobytes()).hexdigest()
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


class _KL64:
    """While active, every ``repro.core.simulator.logit_kl`` call also
    records the KL in float64 from the same float32 logits (``kls``, in
    call order): at the quantization floor (~4e-7) the float32 KL's own
    rounding is of the KL's size."""

    def __enter__(self):
        import numpy as np

        from repro.core import simulator

        self.kls, self._orig = [], simulator.logit_kl

        def logit_kl(f, params_a, params_b, batch):
            la = np.asarray(f(params_a, batch), np.float64)
            lb = np.asarray(f(params_b, batch), np.float64)
            pa = la - np.logaddexp.reduce(la, axis=-1, keepdims=True)
            pb = lb - np.logaddexp.reduce(lb, axis=-1, keepdims=True)
            self.kls.append(float(np.mean(np.sum(np.exp(pa) * (pa - pb), axis=-1))))
            return self._orig(f, params_a, params_b, batch)

        simulator.logit_kl = logit_kl
        return self

    def __exit__(self, *exc):
        from repro.core import simulator

        simulator.logit_kl = self._orig


def fault_tolerance_record(seed: int = 0) -> dict:
    """The reference's ``fault_tolerance.run`` at its settings: the fault
    curve (naive and fault-aware leveling, each KL also in float64), the
    recovery at the reference rate, the hot redeploy and the endurance
    horizons; beside each curve deployment, its pool's stats, wear per
    crossbar and deployed leaves' sha256."""
    import jax

    from benchmarks import fault_tolerance as ft
    from repro.configs import get_arch
    from repro.core.planner import PlannerConfig
    from repro.models import api

    cfg = get_arch("gemma-2b", reduced=True)
    params = api.init(jax.random.PRNGKey(seed), cfg)
    pcfg = PlannerConfig(p_stuck=0.5, min_size=1024)
    rates, ref_rate = (0.0, 5e-4, 2e-3, 8e-3), 2e-3
    deploys = []
    deploy = ft._deploy_through

    def recorded(params, pcfg, *, leveling, rate):
        params_hat, pool = deploy(params, pcfg, leveling=leveling, rate=rate)
        deploys.append({"rate": rate, "leveling": leveling, **pool.stats().to_dict(),
                        "wear_totals": pool.wear_totals().tolist(),
                        "leaf_sha256": _leaf_sha256(params_hat)})
        return params_hat, pool

    ft._deploy_through = recorded
    try:
        with _KL64() as kl64:
            t0 = time.perf_counter()
            curve = ft.run_fault_curve(cfg, params, rates=rates, pcfg=pcfg, seed=seed)
            curve_s = time.perf_counter() - t0
    finally:
        ft._deploy_through = deploy
    for i, row in enumerate(curve):
        row["kl_none_f64"], row["kl_fault_f64"] = kl64.kls[2 * i : 2 * i + 2]
    t0 = time.perf_counter()
    redeploy = ft.run_hot_redeploy(cfg, params, api.init(jax.random.PRNGKey(seed + 1), cfg),
                                   pcfg=pcfg, n_requests=6, seed=seed)
    redeploy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    endurance = ft.run_endurance(cfg, pcfg=pcfg, n_deploys=3, seed=seed)
    return {"arch": "gemma-2b", "reduced": True, "seed": seed, "rates": list(rates),
            "ref_rate": ref_rate, "fault_curve": curve,
            "recovery_at_ref": ft.recovery_fraction(curve, ref_rate), "deploys": deploys,
            "redeploy": redeploy, "endurance": endurance,
            "seconds_cpu": {"fault_curve": curve_s, "redeploy": redeploy_s,
                            "endurance": time.perf_counter() - t0}}


def integrity_scrub_record(seed: int = 0) -> dict:
    """The reference's ``integrity_scrub.run`` at its settings: storm and
    repair (4 requests), the tolerated-fault KL at rates 0, 1e-3 and 4e-3
    (also in float64), the engine scrub and the scrub overhead (on
    ``OVERHEAD_REQUESTS`` requests, ``OVERHEAD_TRIALS`` trials)."""
    import jax

    from benchmarks import integrity_scrub as isc
    from repro.configs import get_arch
    from repro.core.planner import PlannerConfig
    from repro.models import api

    cfg = get_arch("gemma-2b", reduced=True)
    params = api.init(jax.random.PRNGKey(seed), cfg)
    pcfg = PlannerConfig(p_stuck=0.5, min_size=1024)
    t0 = time.perf_counter()
    storm = isc.run_storm_repair(cfg, params, pcfg=pcfg, corrupt=2e-3, stuck=2e-4,
                                 n_requests=4, seed=seed)
    storm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    kl_rates = (0.0, 1e-3, 4e-3)
    with _KL64() as kl64:
        kl = isc.run_tolerated_kl(cfg, params, pcfg=pcfg, rates=kl_rates, seed=seed)
    for row, v in zip(kl, kl64.kls):
        row["kl_f64"] = v
    kl_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    esc = isc.run_engine_scrub(cfg, params, pcfg=pcfg, corrupt=2e-3, stuck=2e-4,
                               n_requests=4, seed=seed)
    esc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ovh = isc.run_scrub_overhead(cfg, params, pcfg=pcfg, n_requests=OVERHEAD_REQUESTS,
                                 trials=OVERHEAD_TRIALS, seed=seed)
    return {"arch": "gemma-2b", "reduced": True, "seed": seed, "n_requests": 4,
            "kl_rates": list(kl_rates), "storm_repair": storm, "tolerated_kl": kl,
            "engine_scrub": esc, "overhead": ovh,
            "seconds_cpu": {"storm_repair": storm_s, "tolerated_kl": kl_s, "engine_scrub": esc_s,
                            "overhead": time.perf_counter() - t0}}


def _near_ties(cfg, params, req, tokens) -> list[int]:
    """Steps of ``tokens`` (req's stream) whose top-2 gap is below NEAR_TIE:
    of the teacher-forced logits, plus the step's Gumbel noise (the solo
    key schedule) for a sampled request."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.models import api

    if not tokens:
        return []
    seq = np.concatenate([req.prompt, np.asarray(tokens[:-1], np.int32)])[None]
    logits = np.asarray(api.forward(params, cfg, {"tokens": jnp.asarray(seq)})[0][0])
    key, near = jax.random.PRNGKey(req.seed), []
    for i in range(len(tokens)):
        row = logits[req.prompt.size - 1 + i]
        if not req.greedy:
            key, sub = jax.random.split(key)
            row = row + np.asarray(jax.random.gumbel(sub, row.shape, row.dtype))
        top = np.sort(row)[-2:]
        if float(top[1] - top[0]) < NEAR_TIE:
            near.append(i)
    return near


def engine_record(seed: int = 0) -> dict:
    """The reference engine on the reduced gemma-2b: the parity trace through
    each of ``PARITY_VARIANTS`` (streams, stats, shapes, near ties), then
    ``run_overcommit`` in swap and recompute mode."""
    import jax
    import numpy as np

    from benchmarks import engine_throughput as et
    from benchmarks_torch import engine_throughput as tet
    from repro.configs import get_arch
    from repro.core.planner import CrossbarSpec, PlannerConfig, build_deployment, deploy_params
    from repro.launch.engine import Engine, EngineConfig, Request
    from repro.models import api

    cfg = get_arch("gemma-2b", reduced=True)
    params = api.init(jax.random.PRNGKey(seed), cfg)
    plan = build_deployment(params, CrossbarSpec(), PlannerConfig(**tet.PARITY_PLAN))
    trace = tet.make_trace(cfg, **tet.PARITY_TRACE)
    variants = {}
    for mat, fused in tet.PARITY_VARIANTS:
        served = deploy_params(params, plan, materialize=mat)
        reqs = tet.parity_requests(trace, Request)
        eng = Engine(cfg, served, EngineConfig(fused=fused, **tet.PARITY_ENGINE))
        t0 = time.perf_counter()
        streams = tet.serve_parity(eng, reqs)
        variants[f"{mat}/{'fused' if fused else 'split'}"] = {
            "tokens": {str(rid): t for rid, t in streams.items()},
            "status": {str(r.rid): eng.results[r.rid].status for r in reqs},
            "stats": dict(eng.stats),
            "shapes": sorted(map(list, eng._shapes_seen)),
            "near_ties": {str(r.rid): _near_ties(cfg, served, r, streams[r.rid]) for r in reqs},
            "seconds_cpu": time.perf_counter() - t0,
        }
    overcommit = {}
    for mode in ("swap", "recompute"):
        oc = et.run_overcommit(cfg, params, preempt=mode)
        overcommit[mode] = {k: oc[k] for k in tet.OVERCOMMIT_INTS}
    return {"arch": "gemma-2b", "reduced": True, "seed": seed, "near_tie": NEAR_TIE,
            "trace": tet.PARITY_TRACE, "engine": tet.PARITY_ENGINE, "plan": tet.PARITY_PLAN,
            "variants": variants, "overcommit": overcommit}


SERVE_FAULTS_ARGS = ["--arch", "gemma-2b", "--reduced", "--batch", "2", "--prompt-len", "8",
                     "--gen", "4", "--cim", "--materialize", "packed", "--fault-rate", "2e-3",
                     "--fault-hotspot", "0.25", "--pool-leveling", "fault", "--scrub",
                     "--scrub-storm", "2e-3"]


def serve_faults_record() -> dict:
    """The reference serve CLI's report with faults and a scrubbed storm:
    its printed lines (tok/s aside, every number in them is an integer, a
    ratio of integers or a token)."""
    import contextlib
    import io

    from repro.launch import serve

    out = io.StringIO()
    argv, sys.argv = sys.argv, ["serve"] + SERVE_FAULTS_ARGS
    try:
        with contextlib.redirect_stdout(out):
            serve.main()
    finally:
        sys.argv = argv
    return {"args": SERVE_FAULTS_ARGS, "lines": out.getvalue().splitlines()}


def import_reference_fleet():
    """``repro.launch.fleet``, imported with ``FaultPolicy.__hash__`` set
    for the import alone: the frozen ``FleetConfig``'s class default
    ``FaultPolicy(...)`` is a mutable default to dataclasses, which refuse
    it unless it is hashable (C.1).  ``__hash__`` is None again after."""
    import importlib

    from repro.runtime import fault

    fault.FaultPolicy.__hash__ = object.__hash__
    try:
        return importlib.import_module("repro.launch.fleet")
    finally:
        fault.FaultPolicy.__hash__ = None


def fleet_tolerance_record(seed: int = 0) -> dict:
    """The reference's fleet benchmark, its wall-clock-free fields."""
    import numpy as np

    import repro.parallel.tp as jtp
    from benchmarks_torch import fleet_tolerance as tft

    import_reference_fleet()
    from benchmarks import fleet_tolerance as ft

    summarize, tp_generate = ft._summarize, jtp.tp_generate
    tp_tokens = []

    def summarize_with_results(cfg, params, fleet, reqs, results, wall_s):
        row = summarize(cfg, params, fleet, reqs, results, wall_s)
        row["results"] = {str(r.rid): [r.status, [int(t) for t in r.tokens]] for r in results}
        return row

    def tp_generate_recorded(*args, **kw):
        toks, tok_s = tp_generate(*args, **kw)
        tp_tokens.append(np.asarray(toks).tolist())
        return toks, tok_s

    ft._summarize, jtp.tp_generate = summarize_with_results, tp_generate_recorded
    try:
        res = ft.run(seed=seed)
    finally:
        ft._summarize, jtp.tp_generate = summarize, tp_generate
    for row, toks in zip(res["tp_scaling"], tp_tokens):
        row["tokens"] = toks
    return {"arch": res["arch"], "reduced": res["reduced"], "seed": seed,
            **tft.wall_free(res)}


def collect(max_elems: int, planner_max_elems: int, planner_layers: int, seed: int = 0,
            only: set | None = None) -> dict:
    import jax

    from benchmarks import (fig5_sws_single, fig6_strides, fig7_greedy, fig8_stucking,
                            fig9_p_sweep, fig10_columns)
    from benchmarks_torch.common import SWEEP_CAP

    out = {
        "jax_version": jax.__version__,
        "backend": jax.default_backend(),
        "seed": seed,
        "max_elems": max_elems,
        "sweep_max_elems": min(max_elems, SWEEP_CAP) if max_elems else 0,
        "seconds": {},
    }
    parts = {
        "fig5": lambda: fig5_sws_single.run(max_elems=max_elems, seed=seed),
        "fig6": lambda: fig6_strides.run(max_elems=max_elems, seed=seed),
        "fig7": lambda: fig7_greedy.run(max_elems=max_elems, seed=seed),
        "fig8": lambda: fig8_stucking.run(max_elems=max_elems, seed=seed),
        "fig9": lambda: fig9_p_sweep.transitions_sweep(max_elems=max_elems, seed=seed),
        "fig10": lambda: fig10_columns.transitions_sweep(max_elems=max_elems, seed=seed),
        "planner": lambda: planner_plan(planner_max_elems, planner_layers),
        "accuracy": lambda: accuracy_record(seed),
        "trainer": lambda: trainer_record(seed),
        "pool_wear": lambda: pool_wear_record(seed=seed),
        "plane_compression": lambda: plane_compression_record(max_elems, seed=seed),
        "redeploy_delta": lambda: redeploy_delta_record(seed),
        "fault_tolerance": lambda: fault_tolerance_record(seed),
        "integrity_scrub": lambda: integrity_scrub_record(seed),
        "serve_faults": serve_faults_record,
        "engine": lambda: engine_record(seed),
        "fleet_tolerance": lambda: fleet_tolerance_record(seed),
    }
    if only is not None:
        if only - parts.keys():
            raise SystemExit(f"unknown parts {sorted(only - parts.keys())}")
        parts = {k: v for k, v in parts.items() if k in only}
    for name, fn in parts.items():
        t0 = time.perf_counter()
        out[name] = fn()
        out["seconds"][name] = time.perf_counter() - t0
        print(f"{name}: {out['seconds'][name]:.1f} s", flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-elems", type=int, default=2_000_000)
    ap.add_argument("--planner-max-elems", type=int, default=750_000)
    ap.add_argument("--planner-layers", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=OUT)
    ap.add_argument("--parts", default="all",
                    help="'all', or comma-separated entries to recompute keeping the rest")
    args = ap.parse_args()
    only = None if args.parts == "all" else set(args.parts.split(","))
    res = collect(args.max_elems, args.planner_max_elems, args.planner_layers, args.seed, only)
    if only is not None:
        old = json.loads(args.out.read_text())
        old["seconds"].update(res.pop("seconds"))
        old.update({k: v for k, v in res.items() if k in only})
        res = old
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(res, indent=1) + "\n")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
