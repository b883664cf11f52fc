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
exempts too.  With a bf16 compute dtype it also casts the dense matmul
weights once, the cast ``layers.linear`` would make at every call (XLA
hoists it out of the reference's scan).

``make_decode_loop`` is the reference's whole-generation decode: one
``lax.scan`` there, here one ``torch.cuda.CUDAGraph`` of all its steps on
the card (:class:`CudaGraphCall`, replayed once a generation over static
cache, token, key and position buffers) and the same step function run
eagerly on the CPU.  ``make_serve_step`` is one token, for the per-token
loop (``loop="python"``).  Both pick tokens through :func:`pick`, the
reference's one sampling path and key schedule, so both loops give the
same tokens, greedy and sampled.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import prng, tree
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


MATMUL_BLOCKS = ("attn", "mlp")  # a layer's sub-dicts whose dense leaves ``layers.linear`` casts


def _cast_matmul_weights(params, dtype: torch.dtype):
    """The dense matmul weights of every layer cast to ``dtype``: the bytes
    ``layers.linear`` makes at every call.  The embedding table (read in f32
    by ``unembed``), the norm gains and the LM head (an f32 matmul) stay as
    they are, as do operand dicts."""
    def cast_block(block):
        return {k: v.to(dtype) if isinstance(v, torch.Tensor) else v for k, v in block.items()}

    segs = [{k: cast_block(v) if k in MATMUL_BLOCKS else v for k, v in seg.items()}
            for seg in params["segments"]]
    return {**params, "segments": segs}


def prepare_serving_params(params, dtype: torch.dtype | None = None):
    """Once per deployment: CUDA keeps operand dicts; the CPU densifies the
    packed ones (``simulator.densify_packed`` leaves int8-plane dicts).  A
    ``dtype`` other than float32 (the compute dtype) casts the dense matmul
    weights to it once (:func:`_cast_matmul_weights`)."""
    dev = _params_device(params)
    if dev is None or dev.type != "cuda":
        params = simulator.densify_packed(params)
    if dtype is not None and dtype != torch.float32:
        params = _cast_matmul_weights(params, dtype)
    return params


def make_prefill_step(cfg: ArchConfig):
    def prefill_step(params, batch):
        return api.prefill(params, cfg, batch)

    return prefill_step


def make_serve_step(cfg: ArchConfig):
    """One-token decode: (params, cache, token, pos) -> (logits, cache); the
    cache is written in place, ``pos`` an int or a 0-d device tensor."""
    def serve_step(params, cache, token, pos):
        return api.decode_step(params, cfg, cache, token, pos)

    return serve_step


def greedy_pick(logits: torch.Tensor) -> torch.Tensor:
    """Next token from the last position: (B, S, V) -> (B, 1) (first max on ties)."""
    return torch.argmax(logits[:, -1:], dim=-1)


def pick(logits: torch.Tensor, key: torch.Tensor, greedy: bool):
    """Next token (B, 1) from the last position and the key after it: the
    reference's one sampling path.  Greedy takes the argmax and consumes no
    randomness; sampling splits ``key`` once and draws
    ``prng.categorical`` from the second half."""
    if greedy:
        return greedy_pick(logits), key
    key, sub = prng.split(key).unbind(-2)
    return prng.categorical(sub, logits[:, -1])[:, None], key


def make_decode_loop(cfg: ArchConfig, n_steps: int, *, greedy: bool = True):
    """Whole-generation decode, the reference's ``lax.scan`` body step for step.

    Returns decode_loop(params, cache, tok0, key, prompt_len) -> (tokens (B,
    n_steps), cache): step ``i`` decodes at position ``prompt_len + i``
    (computed on the device when ``prompt_len`` is a 0-d tensor) and picks
    through :func:`pick`, one key split a sampled step.  The cache is
    written in place.  Nothing in it reads a value on the host, so on the
    card :class:`CudaGraphCall` captures it whole.
    """

    def decode_loop(params, cache, tok0, key, prompt_len):
        tok, out = tok0, []
        for i in range(n_steps):
            logits, cache = api.decode_step(params, cfg, cache, tok, prompt_len + i)
            tok, key = pick(logits, key, greedy)
            out.append(tok)
        toks = torch.cat(out, dim=1) if out else tok0[:, :0]
        return toks, cache

    return decode_loop


class CudaGraphCall:
    """``fn(*static)`` captured once as one CUDA graph, replayed per call.

    ``static`` are the graph's inputs: tensors, or trees of tensors (params,
    a cache) that it reads or writes in place at their addresses.  A call
    copies each given tensor into its static buffer, skips what is the
    static object itself, replays the graph and returns ``fn``'s outputs,
    which every replay rewrites (clone to keep them).  Before the capture
    ``fn`` runs once eagerly on a side stream: that loads the kernel
    libraries, sets their shared-memory attributes and sets up cuBLAS, which
    a capture may not do.  Capture and replay errors raise; nothing falls
    back to eager execution.
    """

    def __init__(self, fn, *static):
        self.static = static
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn(*static)
        torch.cuda.current_stream().wait_stream(stream)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream):
            self.out = fn(*static)
        self.replays = 0

    def __call__(self, *inputs):
        if len(inputs) != len(self.static):
            raise TypeError(f"expected {len(self.static)} inputs, got {len(inputs)}")
        for buf, x in zip(self.static, inputs):
            if x is not buf:
                buf.copy_(x)
        self.graph.replay()
        self.replays += 1
        return self.out
