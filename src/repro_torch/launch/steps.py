"""Step functions (port of ``repro.launch.steps``): the train step and serving.

``loss_fn`` / ``make_train_step`` are the reference's: next-token cross
entropy on f32 logits, gradients of every param leaf (``torch.autograd``
in place of ``jax.value_and_grad``), then ``optim.adamw_update``.  The
training forward passes ``train=True`` down to the attention, which then
runs ``blockwise_attention`` (the function the reference differentiates)
on every device, never kernel B3, and ``remat`` to the per-layer
checkpointing of ``models.transformer``.  The step is functional: new params
and optimizer state come back, the inputs are untouched.

``prepare_serving_params`` is the counterpart of the reference's backend
policy (``steps._serving_params``): on CUDA, operand dicts stay as they are
and every prefill and decode step computes on them through the CIM matmul
kernels; on the CPU packed dicts are densified once per deployment, as the
reference does off-TPU.  Int8-plane dicts stay per step on every device:
they are the per-step bit-sliced simulation baseline, which the reference
exempts too.

The reference's decode is one ``lax.scan`` over a donated cache; here it is
a Python loop whose steps write the cache in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import tree
from repro_torch.configs.base import ArchConfig
from repro_torch.core import simulator
from repro_torch.models import api
from repro_torch.models.transformer import REMATS
from repro_torch.optim import AdamWConfig, adamw_update


def loss_fn(params, cfg: ArchConfig, batch: dict, remat: str = "none") -> tuple[torch.Tensor, dict]:
    """Mean next-token NLL (+ the model's aux loss, 0 for the dense decoders),
    through the training forward (``train=True``: the differentiable attention)."""
    logits, aux = api.forward(params, cfg, batch, remat=remat, train=True)
    targets = batch["tokens"][:, 1:].long()
    lp = F.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    nll = -torch.gather(lp, -1, targets[..., None])[..., 0]
    loss = torch.mean(nll)
    return loss + aux, {"nll": loss, "aux": aux}


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, *, remat: str = "full"):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state, metrics);
    metrics are 0-d tensors (loss, nll, aux, lr, grad_norm)."""
    if remat not in REMATS:
        raise ValueError(f"unknown remat policy {remat!r}")

    def train_step(params, opt_state, batch):
        p = tree.tree_map(lambda x: x.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, parts = loss_fn(p, cfg, batch, remat=remat)
            grads = torch.autograd.grad(loss, tree.leaves(p))
        grads = tree.unflatten(p, list(grads))
        new_params, new_state, opt_metrics = adamw_update(grads, opt_state, params, opt_cfg)
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in parts.items()},
                   **opt_metrics}
        return new_params, new_state, metrics

    return train_step


def _params_device(params) -> torch.device:
    if isinstance(params, torch.Tensor):
        return params.device
    items = params.values() if isinstance(params, dict) else params
    for v in items:
        dev = _params_device(v)
        if dev is not None:
            return dev
    return None


def prepare_serving_params(params):
    """Once per deployment: CUDA keeps operand dicts; the CPU densifies the
    packed ones (``simulator.densify_packed`` leaves int8-plane dicts)."""
    dev = _params_device(params)
    if dev is not None and dev.type == "cuda":
        return params
    return simulator.densify_packed(params)


def make_prefill_step(cfg: ArchConfig):
    def prefill_step(params, batch):
        return api.prefill(params, cfg, batch)

    return prefill_step


def greedy_pick(logits: torch.Tensor) -> torch.Tensor:
    """Next token from the last position: (B, S, V) -> (B, 1) (first max on ties)."""
    return torch.argmax(logits[:, -1:], dim=-1)


def make_decode_loop(cfg: ArchConfig, n_steps: int, *, greedy: bool = True):
    """Whole-generation greedy decode.

    Returns decode_loop(params, cache, tok0, prompt_len) -> (tokens (B,
    n_steps), cache); the cache is written in place.
    """
    if not greedy:
        raise NotImplementedError("sampled decode is queued (ROADMAP A.1); the port decodes greedily")

    def decode_loop(params, cache, tok0, prompt_len: int):
        tok, out = tok0, []
        for i in range(n_steps):
            logits, cache = api.decode_step(params, cfg, cache, tok, prompt_len + i)
            tok = greedy_pick(logits)
            out.append(tok)
        toks = torch.cat(out, dim=1) if out else tok0[:, :0]
        return toks, cache

    return decode_loop
