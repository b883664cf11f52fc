"""A trained reduced LM shared by the accuracy benchmarks (fig9/fig10/e2e), on the port.

The reference's setting (``benchmarks/trained_lm.py``): reduced internlm2
(2 layers, d_model 64, vocab 256, float32) trained for ``STEPS`` AdamW
steps (lr 3e-3, 10 warmup, remat "full") on the deterministic copy task
t -> (5t + 7) mod V, from the reference's key and batches
(``prng``/``data`` draw what jax draws).  "Accuracy" is exact next-token
accuracy on held-out steps 10000.., so deployment error shows up directly
as accuracy drop.

``get_trained_lm`` trains on the given device (CUDA by default) and caches
the result per process; ``reference_lm`` loads the weights the reference
trained (``golden/trained_lm_seed0.npz``, written by
``tools/reference_figures.py``), so the sweeps can be held to the
reference's own weights exactly, apart from how the port's trainer trains.
Evaluation forwards run without gradients: B3 on the card.
"""
from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

from repro_torch import prng, tree
from repro_torch.configs import get_arch
from repro_torch.data import DataConfig, make_dataset
from repro_torch.kernels._util import full_f32_matmuls, resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import api
from repro_torch.optim import AdamWConfig, adamw_init

ARCH = "internlm2-1.8b"
STEPS = 120
SEQ, BATCH = 64, 8
EVAL_STEP0 = 10_000  # held-out batches start here
GOLDEN_NPZ = Path(__file__).resolve().parent / "golden" / "trained_lm_seed{seed}.npz"


def _dataset(cfg, seed: int, device):
    return make_dataset(DataConfig(cfg.vocab_size, SEQ, BATCH, task="copy", seed=seed),
                        device=device)


@functools.lru_cache(maxsize=4)
def _train(seed: int, device: torch.device):
    full_f32_matmuls()
    cfg = get_arch(ARCH, reduced=True)
    ds = _dataset(cfg, seed, device)
    step = make_train_step(cfg, AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=STEPS))
    params = api.init(prng.PRNGKey(seed), cfg, device=device)
    opt = adamw_init(params)
    losses = []
    for s in range(STEPS):
        params, opt, metrics = step(params, opt, ds.batch_at(s))
        losses.append(metrics["loss"])
    return cfg, params, [float(x) for x in losses], ds


def get_trained_lm(seed: int = 0, device=None):
    """(cfg, params, batch_fn) of the LM trained here; batch_fn(i) is the
    i-th held-out batch."""
    cfg, params, _, ds = _train(seed, resolve_device(device))
    return cfg, params, lambda i: ds.batch_at(EVAL_STEP0 + i)


def train_losses(seed: int = 0, device=None) -> list[float]:
    """The losses of ``get_trained_lm``'s 120 steps (step 1 first)."""
    return _train(seed, resolve_device(device))[2]


def reference_lm(seed: int = 0, device=None):
    """(cfg, params, batch_fn) with the reference's trained weights."""
    dev = resolve_device(device)
    cfg = get_arch(ARCH, reduced=True)
    with np.load(str(GOLDEN_NPZ).format(seed=seed)) as z:
        flat = {k: z[k] for k in z.files}
    like = api.init(prng.PRNGKey(seed), cfg, device="cpu")
    values = [torch.from_numpy(flat[tree.path_name(p)]).to(dev)
              for p, _ in tree.leaves_with_path(like)]
    ds = _dataset(cfg, seed, dev)
    return cfg, tree.unflatten(like, values), lambda i: ds.batch_at(EVAL_STEP0 + i)


@torch.no_grad()
def eval_predictions(cfg, params, batch_fn, *, n_batches: int = 4):
    """(predictions int64 [n_batches, B, S-1] on the host, targets alike)."""
    preds, tgts = [], []
    for i in range(n_batches):
        batch = batch_fn(i)
        logits, _ = api.forward(params, cfg, batch)
        preds.append(torch.argmax(logits[:, :-1], dim=-1).cpu())
        tgts.append(batch["tokens"][:, 1:].long().cpu())
    return torch.stack(preds), torch.stack(tgts)


def eval_accuracy(cfg, params, batch_fn, *, n_batches: int = 4, record: dict | None = None,
                  label: str = "") -> float:
    """Next-token accuracy on held-out batches; ``record[label]`` keeps the
    predictions when a record is given."""
    pred, tgt = eval_predictions(cfg, params, batch_fn, n_batches=n_batches)
    if record is not None:
        record[label] = {"preds": pred}
    return int((pred == tgt).sum()) / tgt.numel()


def golden_differences(record: dict, gold_evals: dict) -> list[str]:
    """Where a sweep's ``record`` departs from the reference's evaluations
    (``golden/reference.json``'s ``accuracy/<fig>_evals``): a prediction may
    differ only at a position the reference lists as a near tie (top-2 logit
    gap below its ``near_tie``), and every plan total must be equal."""
    problems = []
    if set(record) != set(gold_evals):
        problems.append(f"evaluations {sorted(record)} vs the reference's {sorted(gold_evals)}")
    for label in sorted(set(record) & set(gold_evals)):
        got, want = record[label], gold_evals[label]
        pred = got["preds"].numpy().reshape(-1)
        ref = np.frombuffer(bytes.fromhex(want["preds"]), dtype=np.uint8).astype(np.int64)
        if pred.shape != ref.shape:
            problems.append(f"{label}: {pred.shape} predictions vs {ref.shape}")
            continue
        off = np.flatnonzero(pred != ref)
        loose = sorted(set(off.tolist()) - set(want["near_ties"]))
        if loose:
            problems.append(f"{label}: {len(loose)} predictions differ away from near ties "
                            f"(first at flat position {loose[0]})")
        if "totals" in want and got.get("totals") != want["totals"]:
            problems.append(f"{label}: plan totals {got.get('totals')} vs {want['totals']}")
    return problems
