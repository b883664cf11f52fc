"""How far one bf16 rounding moves a random-weight model's logits, on the CPU.

Builds the port's model from ``PRNGKey(0)`` (the reference's draws) and one
batch (batch 4, prompt 32, ``make_batch`` from ``PRNGKey(0)``), then prints
the largest |logit| of the float32 forward and, as shares of it:

  * f32 vs bf16: the float32 forward against the bf16 forward;
  * bf16, rounded vs exact weights: the bf16 forward as the dense
    deployment runs it (weights rounded to bf16) against one whose matmuls
    take the exact float32 weights (what the packed and int8 kernels
    compute on), with bf16 activations in both.

    PYTHONPATH=src python tools/bf16_sensitivity.py --arch xlstm-350m --layers 8 \\
        [--reduced] [--pattern mlstm:7,slstm:1] [--threads 4]

At xlstm-350m's full width the init's threefry takes minutes on the CPU;
``--reduced`` takes seconds.  Imports neither JAX nor the reference
package.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch import prng
from repro_torch.configs import get_arch
from repro_torch.models import api, layers


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-350m")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--pattern", default=None,
                    help="block pattern as kind:count,... (default: the config's)")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    cfg = dataclasses.replace(get_arch(args.arch, reduced=args.reduced), n_layers=args.layers)
    if args.pattern:
        pattern = tuple((k, int(n)) for k, n in (p.split(":") for p in args.pattern.split(",")))
        cfg = dataclasses.replace(cfg, block_pattern=pattern)
    params = api.init(prng.PRNGKey(0), cfg, device="cpu")
    batch = api.make_batch(cfg, prng.PRNGKey(0), 4, 32, device="cpu")

    linear = layers.linear

    def exact(w, x, dtype):
        if isinstance(w, torch.Tensor) and dtype == torch.bfloat16:
            return (x.to(torch.float32) @ w.to(torch.float32)).to(dtype)
        return linear(w, x, dtype)

    def forward(dtype):
        c = dataclasses.replace(cfg, dtype=dtype)
        return api.forward(params, c, batch)[0]

    with torch.inference_mode():
        f32, b16 = forward("float32"), forward("bfloat16")
        layers.linear = exact
        try:
            b16_exact = forward("bfloat16")
        finally:
            layers.linear = linear
    top = f32.abs().max().item()
    rows = (("f32 vs bf16", (f32 - b16).abs().max().item()),
            ("bf16, rounded vs exact weights", (b16 - b16_exact).abs().max().item()))
    print(f"{cfg.name} x{cfg.n_layers} {'reduced' if args.reduced else 'full width'} "
          f"{cfg.layer_kinds()}: largest |logit| (f32) {top:.4g}")
    for label, d in rows:
        print(f"  {label}: max |d| {d:.4g} ({100 * d / top:.1f}% of it)")


if __name__ == "__main__":
    main()
