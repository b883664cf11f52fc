"""Decoder-only LM over the attention block (port of ``repro.models.transformer``).

``cfg.layer_kinds()`` groups consecutive identical kinds into segments; each
segment's params are stacked on a leading layer axis (the reference scans
over it), and the port walks that axis in a Python loop, handing each layer
its slice — dense tensors and packed operand dicts alike.  The port has
the ``attn`` kind (the dense decoders) and its sliding-window twin ``swa``,
the ``moe`` kind (attention + mixture-of-experts MLP, ``models/moe.py``),
the ``mla_moe`` kind (multi-head latent attention + MoE MLP,
``models/mla.py``), the hybrid ``hymba_global`` / ``hymba_swa`` kinds
(attention beside Mamba heads, ``models/hybrid.py``) and the recurrent
``mlstm`` / ``slstm`` kinds of the xLSTM family (``models/ssm.py``, no
attention); ``KINDS`` maps each to its init / forward / decode-step / cache
functions and its attention mask, as the reference's registry does, and
each segment's cache holds its kind's own keys ({"k", "v"}, the latent
{"c_kv", "k_rope"}, hymba's {"k", "v", "ssm": {"state", "conv"}} with a
window-long ring for ``hymba_swa``, the mLSTM's {"state", "norm", "conv"}
or the sLSTM's {"h", "c", "n", "m"}).  Meta tokens (``cfg.n_meta_tokens``)
are prepended to the prompt by ``forward`` / ``prefill``, dropped before
the logits, and occupy the first cache positions (the decode step runs at
``pos + n_meta_tokens``).  A modality-stub config (``cfg.stub_prefix_len``
P, internvl2's patch embeddings) takes the batch's ``prefix_embeds`` in
place of the first P token embeddings; a prompt shorter than P raises
(:func:`check_prompt`, ROADMAP C.14).  The encoder-decoder is
``models/encdec.py``; ``models/api.py`` dispatches on ``cfg.encdec``.

Interface:
  init(key, cfg, device=)                          -> params (device: cuda default)
  forward(params, cfg, batch, remat=, train=)      -> (logits, aux: summed over MoE layers);
                                                      batch {"tokens", ["prefix_embeds"]}
  prefill(params, cfg, batch)                      -> (logits, cache)
  decode_step(params, cfg, cache, token, pos)      -> (logits, cache); pos int, 0-d or (B,) tensor
  init_cache(cfg, batch, seq_len, dtype=, device=) -> cache

Paged KV (the continuous-batching engine): ``init_paged_pools``,
``paged_view`` / ``paged_writeback``, ``decode_step_paged``,
``chunk_on_views`` and ``prefill_chunk`` (the reference's paged half).
"""
from __future__ import annotations

import functools
from typing import Any

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch import prng
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels._util import resolve_device
from repro_torch.models import blocks, hybrid, layers, mla, moe, ssm
from repro_torch.models.layers import Params


class _Kind:
    """A block kind: init(keys, cfg), fwd(p, cfg, x, return_cache=, train=,
    [kind=, window=]) -> (x, cache[, aux]), step(p, cfg, x, cache, pos,
    [window=]) -> x and init_cache(cfg, batch, seq_len, dtype, device,
    lead) -> the zero decode cache of one layer (``lead`` stacks it);
    ``has_aux`` kinds return the layer's aux loss from ``fwd``.
    ``attn_kind`` ("causal" | "swa") is the mask the kind's fwd and step
    takes as ``kind=``, with ``window=`` (``cfg.attn_window`` for "swa",
    else None) for fwd and step alike; None for kinds whose attention takes
    no mask arguments."""

    def __init__(self, init, fwd, step, init_cache, has_aux=False, attn_kind=None):
        self.init, self.fwd, self.step = init, fwd, step
        self.init_cache, self.has_aux, self.attn_kind = init_cache, has_aux, attn_kind


def _state_cache(init_cache):
    """A recurrent kind's cache: its state has no sequence axis, so the
    cache length is not read."""
    return lambda cfg, batch, seq_len, dtype, device, lead=(): init_cache(cfg, batch, dtype,
                                                                          device, lead)


KINDS: dict[str, _Kind] = {
    "attn": _Kind(blocks.init_attn_block, blocks.attn_block_fwd, blocks.attn_block_step,
                  blocks.init_attn_cache, attn_kind="causal"),
    "swa": _Kind(blocks.init_attn_block, blocks.attn_block_fwd, blocks.attn_block_step,
                 blocks.init_attn_cache, attn_kind="swa"),
    "moe": _Kind(moe.init_moe_block, moe.moe_block_fwd, moe.moe_block_step,
                 blocks.init_attn_cache, has_aux=True),
    "mla_moe": _Kind(mla.init_mla_moe_block, mla.mla_moe_block_fwd, mla.mla_moe_block_step,
                     mla.init_mla_cache, has_aux=True),
    "hymba_swa": _Kind(hybrid.init_hymba_block, hybrid.hymba_block_fwd, hybrid.hymba_block_step,
                       functools.partial(hybrid.init_hymba_cache, kind="hymba_swa"),
                       attn_kind="swa"),
    "hymba_global": _Kind(hybrid.init_hymba_block, hybrid.hymba_block_fwd,
                          hybrid.hymba_block_step,
                          functools.partial(hybrid.init_hymba_cache, kind="hymba_global"),
                          attn_kind="causal"),
    "mlstm": _Kind(ssm.init_mlstm_block, ssm.mlstm_block_fwd, ssm.mlstm_block_step,
                   _state_cache(ssm.init_mlstm_cache)),
    "slstm": _Kind(ssm.init_slstm_block, ssm.slstm_block_fwd, ssm.slstm_block_step,
                   _state_cache(ssm.init_slstm_cache)),
}


def segments_of(cfg: ArchConfig) -> list[tuple[str, int]]:
    """Group layer kinds into maximal homogeneous runs."""
    runs: list[tuple[str, int]] = []
    for kind in cfg.layer_kinds():
        if kind not in KINDS:
            raise NotImplementedError(
                f"block kind {kind!r} is ported with the other model families (ROADMAP A.16)"
            )
        if runs and runs[-1][0] == kind:
            runs[-1] = (kind, runs[-1][1] + 1)
        else:
            runs.append((kind, 1))
    return runs


def _fwd_kwargs(cfg: ArchConfig, kind: str) -> dict:
    """The mask arguments of a kind's fwd: its attention kind, and
    ``cfg.attn_window`` for "swa" (else None).  The step takes the window
    alone: the plain ``swa`` kind's decode keeps it, where the reference
    drops it (ROADMAP C.11), and ``hymba_swa`` writes a ring of its length."""
    attn_kind = KINDS[kind].attn_kind
    if attn_kind is None:
        return {}
    return {"kind": attn_kind, "window": cfg.attn_window if attn_kind == "swa" else None}


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def layer_slice(tree: Any, i: int) -> Any:
    """Layer ``i`` of a segment stack: index the leading axis of every leaf."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def init(key: torch.Tensor, cfg: ArchConfig, *, device=None) -> Params:
    """f32 master params from a ``prng`` key, the reference's ``init(key,
    cfg)`` bit for bit (same key splits and draws), on CUDA unless
    ``device="cpu"`` is asked for."""
    key = key.to(resolve_device(device))
    segs = segments_of(cfg)
    keys = prng.split(key, len(segs) + 3)
    params: Params = {"embed": layers.init_embedding(keys[0], cfg.vocab_size, cfg.d_model)}
    params["segments"] = [
        KINDS[kind].init(prng.split(keys[i + 1], count), cfg)
        for i, (kind, count) in enumerate(segs)
    ]
    params["final_norm"] = layers.init_norm(cfg.d_model, key.device)
    if not cfg.tie_embeddings:
        params["head"] = {"w": layers._dense_init(keys[-1], cfg.d_model, cfg.vocab_size)}
    if cfg.n_meta_tokens:
        params["meta"] = (prng.normal(keys[-2], (cfg.n_meta_tokens, cfg.d_model))
                          * layers._f32(0.02, key.device))
    return params


@functools.cache
def _embed_scale(d_model: int, dtype: torch.dtype) -> float:
    """sqrt(d_model) rounded to the compute dtype, as the reference rounds
    it before the multiply (the rounded value, exact as a Python float)."""
    return float(torch.tensor(d_model**0.5, dtype=dtype))


def _embed_tokens(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                  prefix: torch.Tensor | None = None) -> torch.Tensor:
    """The token embeddings; a ``prefix`` (B, P, d) takes the place of the
    first P positions' (the modality frontend stub)."""
    dtype = compute_dtype(cfg)
    if prefix is None:
        x = layers.embed(params["embed"], tokens, dtype)
    else:
        x = torch.cat([prefix.to(dtype),
                       layers.embed(params["embed"], tokens[:, prefix.shape[1]:], dtype)], dim=1)
    if cfg.embed_scale:
        # filled on the device: no host-to-device copy in a captured step
        x = x * torch.full((), _embed_scale(cfg.d_model, dtype), dtype=dtype, device=x.device)
    return x


def check_prompt(cfg: ArchConfig, prompt_len: int) -> None:
    """A modality-stub config needs a prompt at least as long as its
    prefix: the reference serves a shorter one silently with every text
    token dropped (ROADMAP C.14), the port refuses it."""
    if prompt_len < cfg.stub_prefix_len:
        raise ValueError(f"{cfg.name}: a prompt of {prompt_len} positions is shorter than the "
                         f"stub_prefix_len of {cfg.stub_prefix_len} (ROADMAP C.14)")


def _embed_inputs(params: Params, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """A whole sequence's inputs: the token embeddings, the batch's
    ``prefix_embeds`` in place of the first ``stub_prefix_len`` positions
    (the modality frontend stub), and the meta tokens prepended (cast to
    the compute dtype, shared by the batch)."""
    tokens, prefix = batch["tokens"], None
    if cfg.stub_prefix_len:
        check_prompt(cfg, tokens.shape[1])
        prefix = batch["prefix_embeds"]
    x = _embed_tokens(params, cfg, tokens, prefix)
    if cfg.n_meta_tokens:
        meta = params["meta"].to(x.dtype)[None].expand(x.shape[0], -1, -1)
        x = torch.cat([meta, x], dim=1)
    return x


def _stack_caches(layer_caches: list) -> Any:
    """Per-layer caches (nested dicts of tensors) stacked on a layer axis."""
    first = layer_caches[0]
    if isinstance(first, dict):
        return {k: _stack_caches([c[k] for c in layer_caches]) for k in first}
    return torch.stack(layer_caches)


def _logits(params: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = layers.rmsnorm(params["final_norm"], x)
    if cfg.tie_embeddings:
        return layers.unembed(params["embed"], x)
    return layers.linear(params["head"]["w"], x.to(torch.float32), torch.float32)


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective checkpointing of ``remat="dots"``: keep the matmuls with no
    batch dims (the weight products, ``aten.mm``), recompute the rest — the
    reference's ``dots_with_no_batch_dims_saveable``."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


REMATS = ("none", "full", "dots")


def _remat_layer(fn, remat: str):
    """Per-layer rematerialization (the reference's ``jax.checkpoint`` of the
    scan body): "full" saves only the layer's inputs, "dots" also its weight
    matmuls' outputs."""
    if remat == "none":
        return fn
    kw = {"use_reentrant": False}
    if remat == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
    return lambda *args: checkpoint(fn, *args, **kw)


def _run_segments(params: Params, cfg: ArchConfig, x: torch.Tensor, *, return_cache: bool,
                  remat: str = "none", train: bool = False):
    """-> (x, aux summed over the aux kinds' layers (f32, in layer order),
    per-segment caches or None)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    for (kind, count), p_stack in zip(segments_of(cfg), params["segments"]):
        spec = KINDS[kind]
        layer_caches = []

        def layer(p_layer, xc, _spec=spec, _kw=_fwd_kwargs(cfg, kind)):
            return _spec.fwd(p_layer, cfg, xc, return_cache=return_cache, train=train, **_kw)

        layer = _remat_layer(layer, remat)
        for i in range(count):
            out = layer(layer_slice(p_stack, i), x)
            if spec.has_aux:
                x, cache, aux_l = out
                aux = aux + aux_l
            else:
                x, cache = out
            layer_caches.append(cache)
        if return_cache:
            caches.append(_stack_caches(layer_caches))
    return x, aux, caches if return_cache else None


def forward(params: Params, cfg: ArchConfig, batch: dict, *, remat: str = "none",
            train: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """batch: {"tokens": (B, S) int, ["prefix_embeds": (B, P, d)]}.  Returns
    (logits (B, S, V) f32, aux
    f32: the MoE layers' load-balance losses summed, 0 for the dense kinds).

    ``train=True`` is the differentiable forward of ``launch.steps.loss_fn``:
    its attention is ``blockwise_attention`` on every device (the function
    the reference differentiates; B3 has no backward).  ``remat`` is the
    per-layer rematerialization policy ("none" | "full" | "dots").
    """
    if remat not in REMATS:
        raise ValueError(f"unknown remat policy {remat!r}")
    x = _embed_inputs(params, cfg, batch)
    x, aux, _ = _run_segments(params, cfg, x, return_cache=False, remat=remat, train=train)
    return _logits(params, cfg, x[:, cfg.n_meta_tokens:]), aux


def prefill(params: Params, cfg: ArchConfig, batch: dict) -> tuple[torch.Tensor, list]:
    """Returns (last-position logits (B, 1, V), per-segment prompt caches:
    {"k", "v": (count, B, Hkv, S, hd)}, or MLA's {"c_kv": (count, B, S, r),
    "k_rope": (count, B, S, dr)}, or hymba's, meta tokens included: k/v
    over the whole sequence (global) or the window-long ring (swa), and the
    Mamba state and conv tail, or the xLSTM kinds' recurrent states)."""
    x = _embed_inputs(params, cfg, batch)
    x, _, caches = _run_segments(params, cfg, x, return_cache=True)
    return _logits(params, cfg, x[:, -1:]), caches


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, dtype=None, *, device=None,
               shards: int = 0) -> list:
    """Zero decode cache, one stacked cache of its kind's keys per segment
    (CUDA unless ``device="cpu"``); ``shards`` > 0 adds a shard axis after
    the layer axis (a TP plan's sharded attention: one cache per shard).
    ``seq_len`` counts every cache position, meta tokens included
    (``api.init_cache`` adds them)."""
    device = resolve_device(device)
    dtype = compute_dtype(cfg) if dtype is None else dtype
    extra = (shards,) if shards else ()
    return [
        KINDS[kind].init_cache(cfg, batch, seq_len, dtype, device, lead=(count, *extra))
        for kind, count in segments_of(cfg)
    ]


def decode_step(
    params: Params, cfg: ArchConfig, caches: list, token: torch.Tensor, pos: int | torch.Tensor
) -> tuple[torch.Tensor, list]:
    """token: (B, 1) int; pos: absolute position, a Python int or a 0-d int
    tensor on the device (no host sync: a CUDA graph can capture the step),
    or a (B,) int tensor of per-row positions (the engine's ragged decode);
    positions exclude the meta tokens, which the step adds.  Writes the
    caches in place and returns (logits (B, 1, V), caches)."""
    x = _embed_tokens(params, cfg, token)
    pos = pos + cfg.n_meta_tokens if cfg.n_meta_tokens else pos
    for (kind, count), p_stack, c_stack in zip(segments_of(cfg), params["segments"], caches):
        kw = {k: v for k, v in _fwd_kwargs(cfg, kind).items() if k == "window"}
        for i in range(count):
            x = KINDS[kind].step(layer_slice(p_stack, i), cfg, x, layer_slice(c_stack, i), pos,
                                 **kw)
    return _logits(params, cfg, x), caches


# ---------------------------------------------------------------------------
# Paged decode / chunked prefill (continuous-batching engine)
# ---------------------------------------------------------------------------

def supports_paged(cfg: ArchConfig) -> bool:
    """Paged KV serving covers pure-attention decoder stacks without meta
    tokens or a modality-stub prefix: ``attn`` and ``swa`` layers; a
    ``moe``, ``mla_moe``, hymba or xLSTM stack, an encoder-decoder and a
    ``stub_prefix_len`` config are refused, as in the reference."""
    return ({k for k, _ in segments_of(cfg)} <= {"attn", "swa"} and cfg.n_meta_tokens == 0
            and not cfg.encdec and cfg.stub_prefix_len == 0)


def init_paged_pools(cfg: ArchConfig, num_tokens: int, dtype=None, *, device=None,
                     shards: int = 0) -> list:
    """Token-major physical KV pools, one stacked pool per segment: k/v
    (count, T, Hkv, hd) with T = num_blocks * page_size (CUDA unless
    ``device="cpu"``); ``shards`` > 0 gives (count, shards, T, Hkv, hd), one
    pool per shard of a TP plan's sharded attention, all behind one block
    table."""
    device = resolve_device(device)
    dtype = compute_dtype(cfg) if dtype is None else dtype
    extra = (shards,) if shards else ()
    return [blocks.init_attn_pool(cfg, num_tokens, dtype, device, lead=(count, *extra))
            for _, count in segments_of(cfg)]


def paged_view(cfg: ArchConfig, pools: list, table: torch.Tensor, page_size: int) -> list:
    """Gather each slot's pages into contiguous per-slot caches — the same
    (count, B, Hkv, L, hd) layout ``init_cache`` builds, so the ordinary
    ``decode_step`` runs against it unchanged."""
    return [{k: blocks.gather_pool_view(a, table, page_size) for k, a in pool.items()}
            for pool in pools]


def paged_writeback(cfg: ArchConfig, pools: list, caches: list, table: torch.Tensor,
                    pos0: torch.Tensor, n_tokens: int, page_size: int) -> list:
    """Scatter the cells a dispatch wrote — view positions [pos0_r, pos0_r +
    n_tokens) per row — back into the physical pools, in place."""
    for pool, cache in zip(pools, caches):
        for k in pool:
            blocks.scatter_pool_view(pool[k], cache[k], table, pos0, n_tokens, page_size)
    return pools


def decode_step_paged(params: Params, cfg: ArchConfig, pools: list, table: torch.Tensor,
                      token: torch.Tensor, pos: torch.Tensor, page_size: int):
    """token: (B, 1) int; pos: (B,) per-slot absolute positions; table
    (B, P) block-table rows.  Gather view -> ordinary ``decode_step``
    (vector positions) -> write the one new cell per row back.  Returns
    (logits (B, 1, V), pools)."""
    caches = paged_view(cfg, pools, table, page_size)
    logits, caches = decode_step(params, cfg, caches, token, pos)
    return logits, paged_writeback(cfg, pools, caches, table, pos, 1, page_size)


def chunk_on_views(params: Params, cfg: ArchConfig, caches: list, tokens: torch.Tensor,
                   start, kv_len, last_idx) -> tuple[torch.Tensor, list]:
    """Chunk continuation against contiguous cache views (written in place).

    tokens: (B, C) int — row r holds chunk positions [start_r, start_r + C)
    of its own request; columns past a row's true extent are padding.
    start / kv_len / last_idx: (B,) int tensors (0-d or Python ints also
    accepted) — chunk start, valid cache length after the writes, and the
    chunk column whose logits each row emits.  Returns (logits (B, 1, V) —
    row r's column ``last_idx_r`` — and the views).
    """
    x = _embed_tokens(params, cfg, tokens)
    start = torch.as_tensor(start, device=x.device)
    kv_len = torch.as_tensor(kv_len, device=x.device)
    for (kind, count), p_stack, c_stack in zip(segments_of(cfg), params["segments"], caches):
        kw = _fwd_kwargs(cfg, kind)
        for i in range(count):
            x = blocks.attn_block_chunk_step(layer_slice(p_stack, i), cfg, x,
                                             layer_slice(c_stack, i), start, kv_len, **kw)
    last = torch.as_tensor(last_idx, device=x.device).to(torch.int64).reshape(-1, 1, 1)
    x_last = torch.gather(x, 1, last.expand(x.shape[0], 1, x.shape[-1]))
    return _logits(params, cfg, x_last), caches


def prefill_chunk(params: Params, cfg: ArchConfig, pools: list, table: torch.Tensor,
                  tokens: torch.Tensor, start, kv_len, last_idx, page_size: int):
    """One prompt-chunk dispatch, B requests wide, through the paged pools
    (see :func:`chunk_on_views`); start/kv_len/last_idx also accept scalars.
    Returns (logits (B, 1, V), pools)."""
    b, c = tokens.shape
    start_b = torch.as_tensor(start, device=tokens.device).reshape(-1).expand(b)
    caches = paged_view(cfg, pools, table, page_size)
    logits, caches = chunk_on_views(params, cfg, caches, tokens, start, kv_len, last_idx)
    return logits, paged_writeback(cfg, pools, caches, table, start_b, c, page_size)
