"""End-to-end training entry point (port of ``repro.launch.train``).

Runs ``make_train_step`` inside ``runtime.TrainLoop`` (checkpoint/restart,
retries, straggler watchdog, optional crossbar redeploy pricing), on CUDA
unless ``--device cpu``.  The params start from the reference's
``init(PRNGKey(seed))`` and the batches are the reference's
``batch_at(step)``, bit for bit.  ``--layers`` cuts the depth of a full
config (published widths, fewer layers).

Usage (on the card; add ``--device cpu`` for the plain versions on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
      --layers 2 --steps 8 --batch 8 --seq 128 --ckpt-every 4 --redeploy-every 4 \\
      --ckpt-dir /tmp/ckpt
"""
from __future__ import annotations

import argparse
import dataclasses
import json

from repro_torch import prng
from repro_torch.configs import get_arch
from repro_torch.data import DataConfig, make_dataset
from repro_torch.kernels._util import full_f32_matmuls, resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import api
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import FaultPolicy, StragglerPolicy, TrainLoop, TrainLoopConfig


def build_loop(
    arch: str,
    *,
    reduced: bool = False,
    layers: int | None = None,
    steps: int = 100,
    batch: int = 8,
    seq: int = 128,
    lr: float = 3e-4,
    remat: str = "none",
    ckpt_dir: str = "/tmp/repro_ckpt",
    ckpt_every: int = 50,
    redeploy_every: int = 0,
    log_every: int = 10,
    task: str = "lm",
    seed: int = 0,
    device=None,
) -> TrainLoop:
    """The ``TrainLoop`` that ``main`` runs (resumed from ``ckpt_dir``'s
    latest checkpoint if it holds one)."""
    dev = resolve_device(device)
    full_f32_matmuls()
    cfg = get_arch(arch, reduced=reduced)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    opt_cfg = AdamWConfig(lr=lr, total_steps=steps, warmup_steps=min(20, steps // 5))
    step_fn = make_train_step(cfg, opt_cfg, remat=remat)
    data = make_dataset(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, task=task,
                   seed=seed),
        device=dev,
    )

    def init_state():
        params = api.init(prng.PRNGKey(seed), cfg, device=dev)
        return params, adamw_init(params)

    return TrainLoop(
        cfg,
        TrainLoopConfig(
            total_steps=steps,
            checkpoint_every=ckpt_every,
            checkpoint_dir=ckpt_dir,
            log_every=log_every,
            redeploy_every=redeploy_every,
        ),
        train_step=step_fn,
        init_state=init_state,
        dataset=data,
        fault=FaultPolicy(max_retries=2),
        straggler=StragglerPolicy(),
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", help="CPU-scale reduced config")
    ap.add_argument("--layers", type=int, default=None, help="cut the depth to this many layers")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--remat", default="none", choices=["none", "full", "dots"])
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--redeploy-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--task", default="lm", choices=["lm", "copy"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="write metrics JSON here")
    args = ap.parse_args(argv)

    loop = build_loop(
        args.arch, reduced=args.reduced, layers=args.layers, steps=args.steps,
        batch=args.batch, seq=args.seq, lr=args.lr, remat=args.remat, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, redeploy_every=args.redeploy_every,
        log_every=args.log_every, task=args.task, seed=args.seed, device=args.device,
    )
    print(f"training {loop.cfg.name} ({'reduced' if args.reduced else 'full'}, "
          f"{loop.cfg.n_layers} layers) from step {loop.start_step} to {args.steps}")
    result = loop.run()
    for rec in result["metrics_log"]:
        print(f"step {rec['step']:5d}  loss {rec['loss']:.4f}  lr {rec.get('lr', 0):.2e}  "
              f"wall {rec['wall_s']:.3f}s")
    if result["redeploy_log"]:
        print("redeploy pricing (per snapshot):")
        for rec in result["redeploy_log"]:
            print(f"  step {rec['step']:5d} {rec['tensor']}: inplace={rec['transitions_natural']} "
                  f"stale-sort streaming {rec['stale_sort_speedup']:.2f}x")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
