"""Checkpoint-to-checkpoint redeploy pricing (``core.redeploy``) on the port.

The port's copy of ``benchmarks/redeploy_delta.py``.  Trains the shared
reduced LM (``trained_lm``) a further ``extra_steps`` AdamW steps and
prices reprogramming the deployed crossbars from the old weights to the new
ones, in natural vs SWS layouts, for the first 4 tensors in flatten order
with ndim >= 2, >= 4096 weights and no ``embed`` in their name (kernel B1
prices every pair on the card).

The further steps match the reference's only within the training
tolerance, so :func:`price` also takes given weights: the golden
``redeploy_delta_seed0.npz`` (written by ``tools/reference_figures.py``)
holds the reference's post-step weights of the 4 priced tensors, and on
them with the reference's trained weights (``trained_lm.reference_lm``)
every integer equals the reference's (``run(reference_weights=True)``).

  PYTHONPATH=src python -m benchmarks_torch.redeploy_delta [--device cpu]

Writes ``experiments/bench_torch/redeploy_delta.json``.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from benchmarks_torch.common import banner, save_json
from benchmarks_torch.trained_lm import get_trained_lm, reference_lm
from repro_torch import tree
from repro_torch.core.redeploy import delta_cost
from repro_torch.data import DataConfig, make_dataset
from repro_torch.kernels._util import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.optim import AdamWConfig, adamw_init

N_TENSORS = 4
GOLDEN_NPZ = Path(__file__).resolve().parent / "golden" / "redeploy_delta_seed{seed}.npz"


def priced_leaves(params) -> list[tuple[str, torch.Tensor]]:
    """(name, leaf) of the tensors the benchmark prices, in flatten order."""
    out = []
    for path, leaf in tree.leaves_with_path(params):
        name = tree.path_name(path)
        if leaf.ndim < 2 or leaf.numel() < 4096 or "embed" in name:
            continue
        out.append((name, leaf))
        if len(out) >= N_TENSORS:
            break
    return out


def train_further(cfg, params_old, *, extra_steps: int = 20, seed: int = 0, device=None):
    """``extra_steps`` AdamW steps (lr 1e-3, 1 warmup) on the copy task's
    batches 20000.. from ``params_old``, the reference's settings."""
    dev = resolve_device(device)
    ds = make_dataset(DataConfig(cfg.vocab_size, 64, 8, task="copy", seed=seed), device=dev)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=extra_steps))
    params, opt = params_old, adamw_init(params_old)
    for s in range(extra_steps):
        params, opt, _ = step(params, opt, ds.batch_at(20_000 + s))
    return params


def price(params_old, new: dict[str, torch.Tensor]) -> dict:
    """The benchmark's record of each priced tensor, from ``params_old``'s
    leaf to ``new[name]``."""
    out = {}
    for name, lo in priced_leaves(params_old):
        rep = delta_cost(lo, new[name], name=name)
        out[name] = {
            "inplace_natural": rep.transitions_natural,
            "inplace_sws": rep.transitions_sws,  # == natural (perm-invariant sanity)
            "chain_natural": rep.chain_natural,
            "chain_stale_sws": rep.chain_stale_sws,
            "chain_fresh_sws": rep.chain_fresh_sws,
            "stale_sort_speedup": rep.stale_sort_speedup,
            "fresh_sort_speedup": rep.fresh_sort_speedup,
            "n_bits": rep.n_bits,
        }
    return out


def golden_new_weights(seed: int = 0, device=None) -> dict[str, torch.Tensor]:
    """The reference's post-step weights of the priced tensors (golden npz)."""
    dev = resolve_device(device)
    with np.load(str(GOLDEN_NPZ).format(seed=seed)) as z:
        return {k: torch.from_numpy(z[k]).to(dev) for k in z.files}


def run(*, extra_steps: int = 20, seed: int = 0, device=None,
        reference_weights: bool = False) -> dict:
    """Price the redeploy on ``device`` (CUDA unless the caller asks for the
    CPU): the LM trained here and trained further here, or with
    ``reference_weights`` the reference's trained and further-trained
    weights (golden files)."""
    dev = resolve_device(device)
    if reference_weights:
        _, params_old, _ = reference_lm(seed=seed, device=dev)
        new = golden_new_weights(seed, dev)
    else:
        cfg, params_old, _ = get_trained_lm(seed=seed, device=dev)
        params_new = train_further(cfg, params_old, extra_steps=extra_steps, seed=seed, device=dev)
        new = dict(priced_leaves(params_new))
    return {"extra_steps": extra_steps, "reference_weights": reference_weights,
            "tensors": price(params_old, new)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    banner("Redeploy delta pricing (beyond-paper)")
    res = run(device=args.device)
    for k, v in res["tensors"].items():
        print(f"  {k}: stale-sort {v['stale_sort_speedup']:.2f}x vs fresh "
              f"{v['fresh_sort_speedup']:.2f}x (in-place rewrite invariant: "
              f"{v['inplace_natural']}=={v['inplace_sws']})")
    save_json("redeploy_delta", res)


if __name__ == "__main__":
    main()
