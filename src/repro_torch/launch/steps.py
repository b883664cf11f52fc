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

The engine's ragged dispatches (``make_paged_decode_loop``,
``make_prefill_chunk_step``, ``make_fused_step``) are the reference's:
per-row positions, keys and greedy flags against the paged KV pools, which
they write in place (the counterpart of donation), every row's pick through
:func:`_row_pick`.  Nothing in them reads a value on the host, so the
engine captures each bucket of each as one :class:`CudaGraphCall` on the
card.

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
    through the training forward (``train=True``: the differentiable
    attention).  The modality-stub positions (``stub_prefix_len``) carry no
    next-token target: their NLL is masked out of the mean, as in the
    reference."""
    logits, aux = api.forward(params, cfg, batch, remat=remat, train=True)
    targets = batch["tokens"][:, 1:].long()
    lp = F.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    nll = -torch.gather(lp, -1, targets[..., None])[..., 0]
    if cfg.stub_prefix_len:
        mask = (torch.arange(nll.shape[1], device=nll.device) >= cfg.stub_prefix_len)
        mask = mask.to(torch.float32)[None]
        nll = nll * mask
        loss = torch.sum(nll) / torch.clamp(torch.sum(mask) * nll.shape[0], min=1.0)
    else:
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


# a layer's entries whose dense leaves the model casts at use: sub-dicts
# ("moe": the routed expert stacks and the shared GLU; "mla": its
# projections, wk_b and wv_b included; "mamba": its four projections, the
# conv taps and dt_bias; an encoder-decoder's "self" and "cross" attention)
# and the xLSTM blocks' own leaves (the mLSTM's six projections and conv
# taps, the sLSTM's two projections)
MATMUL_BLOCKS = ("attn", "mlp", "moe", "mla", "mamba", "self", "cross",
                 "w_up", "conv", "wq", "wk", "wv", "w_if", "w_down", "w", "w_out")
# entries of those sub-dicts left as they are: the MoE router (a float32
# matmul whatever the model's dtype), MLA's norm gains (rmsnorm reads them
# in float32, so a bf16 copy would round them) and Mamba's a_log and
# d_skip (read in float32).  The sLSTM's "r" is not cast either: its einsum
# takes the float32 state.
KEEP_F32 = ("router", "q_norm", "kv_norm", "a_log", "d_skip")


def _cast_matmul_weights(params, dtype: torch.dtype):
    """The dense matmul weights of every layer (and an encoder-decoder's
    ``src_proj``) cast to ``dtype``: the bytes ``layers.linear`` (and MLA's
    per-head ``wk_b`` / ``wv_b``, the conv taps) make at every call.  The
    embedding table (read in f32 by ``unembed``), the norm gains, the LM
    head, the MoE router (f32 matmuls) and the sLSTM's ``r`` stay as they
    are, as do operand dicts."""
    def cast(v):
        if isinstance(v, torch.Tensor):
            return v.to(dtype)
        if isinstance(v, dict) and not simulator.is_cim_operands(v):
            return {k: w if k in KEEP_F32 else cast(w) for k, w in v.items()}
        return v

    def cast_layers(stack):
        return {k: cast(v) if k in MATMUL_BLOCKS else v for k, v in stack.items()}

    if "segments" not in params:  # an encoder-decoder
        return {**params, "src_proj": cast(params["src_proj"]),
                "encoder": cast_layers(params["encoder"]),
                "decoder": cast_layers(params["decoder"])}
    return {**params, "segments": [cast_layers(seg) for seg in params["segments"]]}


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


def _row_pick(logits: torch.Tensor, keys: torch.Tensor, greedy: torch.Tensor,
              consume: torch.Tensor | None = None):
    """Per-row token pick — the sampling path and key schedule shared by
    every ragged dispatch, so their streams stay those of the solo
    :func:`pick`.

    logits (B, S, V) f32 — the last position samples; keys (B, 2); greedy
    (B,) bool — greedy rows take the argmax and keep their key; ``consume``
    optionally masks which sampled rows' keys really advance (rows whose
    pick the caller discards must not burn a split).  Each row's draw is
    ``jax.random.categorical`` of its own subkey (the reference vmaps it).
    Returns (tok (B,) int64, keys_out (B, 2)).
    """
    last = logits[:, -1]
    if last.dtype != torch.float32:
        raise TypeError(f"sampling takes float32 logits, got {last.dtype}")
    greedy_tok = torch.argmax(last, dim=-1)
    keys_new, subs = prng.split(keys).unbind(-2)  # (B, 2) each
    sampled = torch.argmax(prng.gumbel(subs, (last.shape[-1],)) + last, dim=-1)
    tok = torch.where(greedy, greedy_tok, sampled)
    advance = ~greedy if consume is None else consume & ~greedy
    return tok, torch.where(advance[:, None], keys_new, keys)


def _ragged_scan_body(params, cfg: ArchConfig, greedy: torch.Tensor):
    """The one decode-quantum step: ``make_paged_decode_loop`` and the fused
    step's decode sub-batch run this exact closure, so fused-vs-split is
    purely a scheduling difference.  Carry: (caches, tok (B, 1), keys, pos
    (B,)); emits each step's (B,) tokens."""

    def body(carry):
        caches, tok, keys, pos = carry
        logits, caches = api.decode_step(params, cfg, caches, tok, pos)
        nxt, keys = _row_pick(logits, keys, greedy)
        return (caches, nxt[:, None], keys, pos + 1), nxt

    return body


def _scan(body, carry, n_steps: int):
    """``lax.scan`` of ``body`` for ``n_steps`` steps, unrolled: (carry, the
    emitted (B,) values stacked to (B, n_steps))."""
    out = []
    for _ in range(n_steps):
        carry, y = body(carry)
        out.append(y)
    return carry, torch.stack(out, dim=1)


def make_paged_decode_loop(cfg: ArchConfig, n_steps: int, page_size: int):
    """Ragged continuous-batching decode quantum as one dispatch.

    Returns decode_loop(params, pools, table (B, P) int, state (B, 3) int
    rows = [tok, pos, greedy], keys (B, 2)) -> (tokens (B, n_steps), pools,
    keys (B, 2)).  Every slot carries its own position, key and greedy
    flag: the KV write and attention mask are per slot (paged pool + block
    table), and sampling splits each slot's key on its own — so each row's
    stream is that of a solo ``serve.generate`` of the request.  The table
    must cover positions up to ``pos + n_steps`` for every live row; padded
    rows point at the dummy page.  The view is gathered once, the quantum
    runs the ordinary decode step against it, and only the quantum's new
    cells are written back (in place).
    """

    def decode_loop(params, pools, table, state, keys):
        tok0 = state[:, 0:1].long()
        pos0 = state[:, 1].long()
        greedy = state[:, 2] != 0
        caches = api.paged_view(cfg, pools, table, page_size)
        (caches, _, keys, _), toks = _scan(
            _ragged_scan_body(params, cfg, greedy), (caches, tok0, keys, pos0), n_steps)
        pools = api.paged_writeback(cfg, pools, caches, table, pos0, n_steps, page_size)
        return toks, pools, keys

    return decode_loop


def make_fused_step(cfg: ArchConfig, n_steps: int, page_size: int):
    """Fused prefill+decode dispatch: one bucketed dispatch per engine cycle
    in which some rows are prefill chunks and others decode quanta.

    Returns fused_step(params, pools,
        pf_table (Bp, P), pf_tokens (Bp, C), pf_meta (Bp, 5), pf_keys (Bp, 2),
        table (B, P), state (B, 5), keys (B, 2), join (B,))
    -> (pf_tok (Bp,), toks (B, n_steps), keys_out (B, 2), pools).

    * Chunk sub-batch (prefill rows only): the ``make_prefill_chunk_step``
      compute; ``pf_meta`` rows are [start, kv_len, last_idx, greedy,
      consume], ``pf_tok`` each row's next token picked in-graph
      (``consume`` marks rows whose key this pick really advances).
    * Decode sub-batch (decode rows + rows whose prompt finishes in this
      dispatch): the ``make_paged_decode_loop`` quantum; ``state`` rows are
      [tok, pos, greedy, tok_override, use_override].  ``join`` maps each
      decode row to its chunk row (-1 for plain decode rows): a finishing
      row seeds from its in-graph first token and continuation key;
      ``use_override`` rows (recompute re-admissions) seed from
      ``tok_override`` without consuming randomness.

    The decode view is gathered after the chunk write-back, so a finishing
    row's prompt KV is visible to its own decode steps.
    """

    def fused_step(params, pools, pf_table, pf_tokens, pf_meta, pf_keys,
                   table, state, keys, join):
        start, kv_len, last_idx = pf_meta[:, 0], pf_meta[:, 1], pf_meta[:, 2]
        caches = api.paged_view(cfg, pools, pf_table, page_size)
        logits, caches = api.chunk_on_views(params, cfg, caches, pf_tokens.long(), start,
                                            kv_len, last_idx)
        pf_tok, pf_keys_out = _row_pick(logits, pf_keys, pf_meta[:, 3] != 0,
                                        consume=pf_meta[:, 4] != 0)
        pools = api.paged_writeback(cfg, pools, caches, pf_table, start, pf_tokens.shape[1],
                                    page_size)

        use_join = join >= 0
        jidx = join.clamp(min=0).long()
        tok0 = torch.where(use_join, pf_tok[jidx], state[:, 0].long())
        tok0 = torch.where(state[:, 4] != 0, state[:, 3].long(), tok0)[:, None]
        keys0 = torch.where(use_join[:, None], pf_keys_out[jidx], keys)
        pos0 = state[:, 1].long()
        caches = api.paged_view(cfg, pools, table, page_size)
        (caches, _, keys_out, _), toks = _scan(
            _ragged_scan_body(params, cfg, state[:, 2] != 0), (caches, tok0, keys0, pos0),
            n_steps)
        pools = api.paged_writeback(cfg, pools, caches, table, pos0, n_steps, page_size)
        return pf_tok, toks, keys_out, pools

    return fused_step


def make_prefill_chunk_step(cfg: ArchConfig, page_size: int):
    """One chunked-prefill dispatch, B requests wide, first-token pick fused
    in: (params, pools, table (B, P), tokens (B, C), meta (B, 4) rows =
    [start, kv_len, last_idx, greedy], keys (B, 2)) -> (tok (B,), keys_out
    (B, 2), pools).  ``tok[r]`` only means something on row r's final chunk;
    the caller adopts a row's key only when it accepts the token."""

    def chunk_step(params, pools, table, tokens, meta, keys):
        logits, pools = api.prefill_chunk(params, cfg, pools, table, tokens.long(), meta[:, 0],
                                          meta[:, 1], meta[:, 2], page_size)
        tok, keys_out = _row_pick(logits, keys, meta[:, 3] != 0)
        return tok, keys_out, pools

    return chunk_step


def dot_node_labels(text: str) -> list[str]:
    """The node statements of a DOT graph (``"name"[attributes];``), one
    string each, DOT's escapes of ``<>{}|`` undone and a kernel's launch
    configuration (``<<<grid, block, smem>>>``) left out; edges too."""
    import re

    nodes = re.split(r'(?m)^\s*"[^"]+"\s*\[', text)[1:]
    return [re.sub(r"<<<.*?>>>", "", re.sub(r"\\([<>{}|])", r"\1", n), flags=re.S)
            for n in nodes]


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

    With the class attribute ``keep_nodes`` set, graphs captured from then
    on keep their node list, which :meth:`node_labels` reads.  ``pool``
    (``torch.cuda.graph_pool_handle()``) shares one memory pool among
    graphs that never replay concurrently and whose outputs the caller
    copies out before another of them replays.
    """

    keep_nodes = False

    def __init__(self, fn, *static, pool=None):
        self.static = static
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn(*static)
        torch.cuda.current_stream().wait_stream(stream)
        if self.keep_nodes:
            self.graph = torch.cuda.CUDAGraph(keep_graph=True)
            self.graph.enable_debug_mode()
        else:
            self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool, stream=stream):
            self.out = fn(*static)
        if self.keep_nodes:
            self.graph.instantiate()  # a kept graph instantiates on demand
        self.replays = 0
        self._labels = None

    def node_labels(self) -> list[str]:
        """One label per node of the captured graph, as
        ``cudaGraphDebugDotPrint`` writes it (a kernel node's names its
        function), DOT's escapes undone.  Needs ``keep_nodes`` at capture."""
        if self._labels is None:
            import os
            import tempfile

            with tempfile.TemporaryDirectory() as d:
                path = os.path.join(d, "graph.dot")
                self.graph.debug_dump(path)
                if not os.path.exists(path):
                    raise RuntimeError("the CUDA graph wrote no node list (captured "
                                       "without keep_nodes?)")
                with open(path) as f:
                    self._labels = dot_node_labels(f.read())
        return self._labels

    def __call__(self, *inputs):
        if len(inputs) != len(self.static):
            raise TypeError(f"expected {len(self.static)} inputs, got {len(inputs)}")
        for buf, x in zip(self.static, inputs):
            if x is not buf:
                buf.copy_(x)
        self.graph.replay()
        self.replays += 1
        return self.out
