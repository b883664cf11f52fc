"""Tensor-parallel sharding of one serving replica over a "model" axis.

Port of ``repro.parallel.tp``.  One engine replica (or one
``serve.generate`` pipeline) is split N ways with the Megatron
column/row-parallel discipline, derived from the rule table of
``parallel.sharding``:

  * ``wq`` / ``wk`` / ``wv`` / ``wi_gate`` / ``wi_up`` — column-parallel
    (output axis sliced; each shard owns ``n_heads/N`` heads and ``d_ff/N``
    hidden channels, so attention and the GLU nonlinearity stay local),
  * ``attn/wo`` / ``mlp/wo`` — row-parallel (contraction axis sliced; each
    shard holds a PARTIAL output, summed at the reduction gates of
    ``models.blocks`` before the residual add),
  * embeddings / norms / ``head`` — replicated, so every shard finishes
    each layer with FULL activations and the host scheduler is untouched.

Packed CIM operands shard by slicing the stored bit planes
(``simulator.shard_operands``), never by requantizing, so
``densify(shard(op)) == shard(densify(op))`` byte for byte.  The paged KV
pool partitions on the head axis: each shard's ``wk``/``wv`` slice produces
only its own ``n_kv_heads/N`` heads, so the pools carry a shard axis behind
one block table and slot schedule.

Layout of a prepared TP tree (:func:`prepare_tp_params`): every leaf of a
sharded sublayer (``attn`` when ``plan.attn``, ``mlp`` when ``plan.mlp``)
holds its shards on an axis right after the layer axis — dense
``(layers, n, K, N/n)``, operand dict fields alike — and every replicated
leaf is kept once.  (The reference stacks every leaf n times, embedding and
head included.)  A replicated component runs once, not n times.

Execution (:func:`tp_step`): the step functions are the unsharded ones on
the local config; the shards meet at the gates of ``models.blocks``, where
the active gate of ``parallel.collective`` sums them — the in-process
:class:`~repro_torch.parallel.collective.ShardLoop` (every shard in turn on
one device: the counterpart of the reference's ``vmap``, and one CUDA graph
a dispatch) or a :class:`~repro_torch.parallel.collective.ProcessGroupGate`
with one shard a rank (``dist.all_reduce``, the counterpart of its
``shard_map``).

Divisibility is checked per *component*, not per leaf: GQA/MQA means
``n_kv_heads`` can refuse a split every leaf shape would accept.  A
component that cannot split degrades to replication, with the reason
recorded in the plan.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Sequence

import torch

from repro_torch import tree
from repro_torch.configs.base import ArchConfig
from repro_torch.core import simulator
from repro_torch.parallel import collective
from repro_torch.parallel import sharding as shrules

DEFAULT_AXIS = "model"

# component membership: the trailing "<sublayer>/<leaf>" of a param path;
# directions (col = output axis -1, row = contraction axis -2) are
# cross-checked against sharding._RULES in plan_tp
_ATTN_LEAVES = {"wq": -1, "wk": -1, "wv": -1, "wo": -2}
_MLP_LEAVES = {"wi_gate": -1, "wi_up": -1, "wo": -2}
_ATTN_SUBLAYERS = ("attn", "self", "cross")
_MLP_SUBLAYERS = ("mlp", "shared")
_TP_KINDS = {"attn", "swa"}  # block kinds with reduction gates (models.blocks)


@dataclasses.dataclass(frozen=True)
class TPPlan:
    """How one replica splits over ``n`` shards of axis ``axis``.

    ``attn`` / ``mlp``: whether that component is sharded (False =
    replicated, its gate off).  ``rules`` maps a component-qualified leaf
    suffix (``"attn/wo"``) to its slice axis; ``reasons`` records why a
    component degraded to replication.
    """

    n: int
    axis: str = DEFAULT_AXIS
    attn: bool = False
    mlp: bool = False
    rules: Mapping[str, int] = dataclasses.field(default_factory=dict)
    reasons: Mapping[str, str] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.n < 1:
            raise ValueError(f"shard count must be >= 1, got {self.n}")


def _rule_axis(name: str, stacked_shape: tuple[int, ...], axis: str, n: int) -> Optional[int]:
    """Slice axis the rule table assigns ``name`` (a negative axis), or None
    when the table replicates the leaf at this size."""
    spec = shrules._resolve(name, stacked_shape, {axis: n}, fsdp=False, fsdp_min=2**62)
    if axis not in spec:
        return None
    return spec.index(axis) - len(spec)


def plan_tp(cfg: ArchConfig, n: int, *, packed: bool = False, axis: str = DEFAULT_AXIS) -> TPPlan:
    """Plan an ``n``-way tensor-parallel split of ``cfg``.

    * attention: ``n_heads % n == 0`` and ``n_kv_heads % n == 0``; packed
      operands also need the row-parallel ``wo`` K slice ``(n_heads // n) *
      head_dim`` byte-aligned (``% 8``): planes are sliced by stored bytes.
    * mlp: ``d_ff % n == 0``; packed needs ``(d_ff // n) % 8 == 0``.

    A failing component is replicated, never an error, with its reason.
    """
    if n < 1:
        raise ValueError(f"shard count must be >= 1, got {n}")
    reasons: dict[str, str] = {}
    hd = cfg.resolved_head_dim
    kinds = set(cfg.layer_kinds())
    if getattr(cfg, "encdec", False) or not kinds <= _TP_KINDS:
        why = f"block kinds {sorted(kinds)} have no TP reduction gates"
        return TPPlan(n=n, axis=axis, reasons={"attn": why, "mlp": why})

    attn, mlp = True, True
    if cfg.n_heads % n:
        attn, reasons["attn"] = False, f"n_heads {cfg.n_heads} % {n} != 0"
    elif cfg.n_kv_heads % n:
        attn, reasons["attn"] = False, f"n_kv_heads {cfg.n_kv_heads} % {n} != 0"
    elif packed and ((cfg.n_heads // n) * hd) % 8:
        attn, reasons["attn"] = False, (
            f"packed wo K-slice {(cfg.n_heads // n) * hd} not byte-aligned"
        )
    if cfg.d_ff % n:
        mlp, reasons["mlp"] = False, f"d_ff {cfg.d_ff} % {n} != 0"
    elif packed and (cfg.d_ff // n) % 8:
        mlp, reasons["mlp"] = False, f"packed mlp K-slice {cfg.d_ff // n} not byte-aligned"

    shapes = {
        "attn/wq": (cfg.d_model, cfg.n_heads * hd),
        "attn/wk": (cfg.d_model, cfg.n_kv_heads * hd),
        "attn/wv": (cfg.d_model, cfg.n_kv_heads * hd),
        "attn/wo": (cfg.n_heads * hd, cfg.d_model),
        "mlp/wi_gate": (cfg.d_model, cfg.d_ff),
        "mlp/wi_up": (cfg.d_model, cfg.d_ff),
        "mlp/wo": (cfg.d_ff, cfg.d_model),
    }
    rules: dict[str, int] = {}
    for comp, leaves, on in (("attn", _ATTN_LEAVES, attn), ("mlp", _MLP_LEAVES, mlp)):
        if not on:
            continue
        want = {f"{comp}/{leaf}": ax for leaf, ax in leaves.items()}
        got = {
            key: _rule_axis(f"segments/0/{key}", (cfg.n_layers, *shapes[key]), axis, n)
            for key in want
        }
        if got != want:
            bad = sorted(k for k in want if got[k] != want[k])
            reasons[comp] = f"rule table resolves {bad} differently at n={n}"
            if comp == "attn":
                attn = False
            else:
                mlp = False
        else:
            rules.update(want)
    return TPPlan(n=n, axis=axis, attn=attn, mlp=mlp, rules=rules, reasons=reasons)


def local_config(cfg: ArchConfig, plan: TPPlan) -> ArchConfig:
    """The ArchConfig one shard runs: divided head / ff counts and the gate
    flags.  ``head_dim`` is pinned: its ``d_model // n_heads`` default would
    double under a halved head count."""
    kw: dict[str, Any] = {
        "tp_axis": plan.axis if (plan.attn or plan.mlp) else None,
        "tp_attn": plan.attn,
        "tp_mlp": plan.mlp,
    }
    if plan.attn:
        kw.update(
            n_heads=cfg.n_heads // plan.n,
            n_kv_heads=cfg.n_kv_heads // plan.n,
            head_dim=cfg.resolved_head_dim,
        )
    if plan.mlp:
        kw.update(d_ff=cfg.d_ff // plan.n)
    return dataclasses.replace(cfg, **kw)


def _leaf_rule(name: str, plan: TPPlan) -> Optional[int]:
    """Slice axis for a param leaf path, or None (replicated)."""
    parts = name.split("/")
    if len(parts) < 2:
        return None
    sub, leaf = parts[-2], parts[-1]
    if sub in _ATTN_SUBLAYERS:
        return plan.rules.get(f"attn/{leaf}")
    if sub in _MLP_SUBLAYERS:
        return plan.rules.get(f"mlp/{leaf}")
    return None


def _map_weights(fn, params: Any, prefix: tuple = ()) -> Any:
    """``fn(path, leaf)`` over a params tree whose leaves are tensors and
    whole operand dicts."""
    if simulator.is_cim_operands(params) or not isinstance(params, (dict, list, tuple)):
        return fn(prefix, params)
    if isinstance(params, dict):
        return {k: _map_weights(fn, v, prefix + (k,)) for k, v in params.items()}
    return type(params)(_map_weights(fn, v, prefix + (i,)) for i, v in enumerate(params))


def _slice_leaf(name: str, leaf, ax: int, index: int, n: int):
    if simulator.is_cim_operands(leaf):
        return simulator.shard_operands(leaf, axis=ax, index=index, n=n)
    dim = leaf.shape[ax]
    if dim % n:
        raise ValueError(
            f"{name}: axis {ax} extent {dim} not divisible by {n} "
            f"(plan_tp should have replicated this)"
        )
    return leaf.narrow(ax, index * (dim // n), dim // n)


def shard_params(params: Any, plan: TPPlan, index: int) -> Any:
    """Shard ``index``'s param tree: dense leaves sliced, operand dicts
    through ``simulator.shard_operands`` (stored-byte slicing, exact),
    replicated leaves returned as they are (shared, not copied)."""
    if not 0 <= index < plan.n:
        raise ValueError(f"shard index {index} outside [0, {plan.n})")

    def one(path, leaf):
        name = tree.path_name(path)
        ax = _leaf_rule(name, plan)
        if ax is None or plan.n == 1:
            return leaf
        return _slice_leaf(name, leaf, ax, index, plan.n)

    return _map_weights(one, params)


def _stack(parts: list, dim: int):
    if isinstance(parts[0], dict):
        return {k: _stack([p[k] for p in parts], dim) for k in parts[0]}
    return torch.stack(parts, dim=dim)


def shard_stack(params: Any, plan: TPPlan, shards: Optional[Sequence[int]] = None) -> Any:
    """The TP tree before preparation: each leaf of a sharded sublayer holds
    shards ``shards`` (default all) on an axis after its layer axis,
    replicated leaves are kept once.  ``shards=[rank]`` is one rank's tree
    for a process-group gate."""
    idx = list(range(plan.n)) if shards is None else list(shards)

    def one(path, leaf):
        name = tree.path_name(path)
        ax = _leaf_rule(name, plan)
        if ax is None or not (plan.attn or plan.mlp):
            return leaf
        stacked = bool(shrules._STACKED.search(name))
        return _stack([_slice_leaf(name, leaf, ax, i, plan.n) for i in idx], 1 if stacked else 0)

    return _map_weights(one, params)


def prepare_tp_params(params: Any, plan: TPPlan, dtype: Optional[torch.dtype] = None,
                      *, shards: Optional[Sequence[int]] = None) -> Any:
    """Shard -> stack -> prepare: the serving-ready TP tree
    (``steps.prepare_serving_params``: packed operands densified on the CPU,
    dense matmul weights cast to ``dtype`` once per shard).  Preparing after
    slicing is exact: densify and stored-byte slicing commute, the cast is
    elementwise."""
    from repro_torch.launch.steps import prepare_serving_params

    return prepare_serving_params(shard_stack(params, plan, shards), dtype)


def tree_has_packed(params: Any) -> bool:
    """True if any leaf of ``params`` is a packed CIM operand dict."""
    found = []
    _map_weights(lambda _, leaf: found.append(
        simulator.is_cim_operands(leaf) and "planes_packed" in leaf), params)
    return any(found)


def local_shards(plan: TPPlan, shards: Optional[Sequence[int]] = None) -> int:
    """The shard axis of a TP plan's KV caches and pools: the local shard
    count when attention is sharded, 0 (no axis) when it is replicated."""
    if not plan.attn:
        return 0
    return plan.n if shards is None else len(shards)


# ---------------------------------------------------------------------------
# Execution of unmodified step functions on the local config
# ---------------------------------------------------------------------------

def tp_step(fn, gate=None):
    """Step adapter: ``fn`` (a step function of the local config) with
    ``gate`` (default: the in-process
    :class:`~repro_torch.parallel.collective.ShardLoop`) at its reduction
    points; same signature and outputs as the unsharded step.  Replicated
    outputs (tokens, keys, logits) come back once; per-shard pools and
    caches keep their shard axis.  Only another gate needs it: the
    ``ShardLoop`` is also the gate in force by default, so the engine and a
    one-process generator call the local steps as they are."""
    gate = collective.ShardLoop() if gate is None else gate

    def wrapped(*args):
        with collective.active(gate):
            return fn(*args)

    return wrapped


# ---------------------------------------------------------------------------
# Sharded lockstep generation (the serve.generate twin)
# ---------------------------------------------------------------------------

def make_tp_generator(
    cfg: ArchConfig, params: Any, batch, *, n: int, gen_len: int,
    greedy: bool = True, seed: int = 0, plan: Optional[TPPlan] = None,
    loop: str = "scan", gate=None, shards: Optional[Sequence[int]] = None,
):
    """Set up an ``n``-way tensor-parallel prefill + decode; returns
    ``timed_run() -> (tokens, seconds)``.

    ``serve.make_generator`` on the local config and the TP tree: the same
    PRNG schedule and sampling path, ``loop="scan"`` as one CUDA graph of
    every decode step (all shards in it) on the card.  ``gate`` /
    ``shards``: a :class:`~repro_torch.parallel.collective.ProcessGroupGate`
    with this rank's shard (``shards=[rank]``) runs one shard a process.
    Tokens equal the solo generator's: identical at ``n == 1``, and at
    ``n > 1`` up to the reassociated sum at the gates.
    """
    from repro_torch.launch.serve import generator_on_prepared
    from repro_torch.models.transformer import compute_dtype

    if plan is None:
        plan = plan_tp(cfg, n, packed=tree_has_packed(params))
    elif plan.n != n:
        raise ValueError(f"plan is {plan.n}-way, asked for {n}")
    cfg_l = local_config(cfg, plan)
    tp_params = prepare_tp_params(params, plan, compute_dtype(cfg), shards=shards)
    return generator_on_prepared(
        cfg_l, tp_params, batch, gen_len=gen_len, greedy=greedy, seed=seed, loop=loop,
        cache_shards=local_shards(plan, shards),
        wrap=None if gate is None else (lambda fn: tp_step(fn, gate)))


def tp_generate(
    cfg: ArchConfig, params: Any, batch, *, n: int, gen_len: int,
    greedy: bool = True, seed: int = 0, repeats: int = 1, plan: Optional[TPPlan] = None,
    loop: str = "scan", gate=None, shards: Optional[Sequence[int]] = None,
):
    """Sharded twin of ``serve.generate``: returns (tokens, tok/s)."""
    timed_run = make_tp_generator(
        cfg, params, batch, n=n, gen_len=gen_len, greedy=greedy, seed=seed,
        plan=plan, loop=loop, gate=gate, shards=shards,
    )
    best = float("inf")
    for _ in range(max(1, repeats)):
        tokens, dt = timed_run()
        best = min(best, dt)
    return tokens, batch["tokens"].shape[0] * gen_len / best


# ---------------------------------------------------------------------------
# Per-shard crossbar pools + scrub coordination
# ---------------------------------------------------------------------------

def build_sharded_deployment(params: Any, spec, config, n: int, *, pools=None, device=None):
    """Deploy a model across ``n`` per-shard ``CrossbarPool``s.

    Pool sections live over SWS-sorted flat weights, a layout orthogonal to
    the serving axes, so physical storage partitions by TENSOR: eligible
    tensors go round-robin over the shard pools in ``iter_weights`` order.
    The per-tensor PRNG schedule is the global ``build_deployment`` one, so
    under per-tensor pristine accounting every tensor's plan (``w_hat``,
    stuck masks, transitions) equals the unsharded deployment's, and the
    summed wear of the shard pools equals the unsharded pool's.  Pricing
    runs through kernel B1 on the card.

    Returns ``(plan, pools, owner)``: one merged ``DeploymentPlan``, the
    shard pools, and ``owner[name] -> shard``.
    """
    from repro_torch.core.planner import (
        DeploymentPlan,
        analyze_tensor,
        iter_weights,
        tensor_keys,
    )
    from repro_torch.core.pool import CrossbarPool
    from repro_torch.kernels._util import resolve_device

    if n < 1:
        raise ValueError(f"shard count must be >= 1, got {n}")
    if pools is None:
        dev = resolve_device(device)
        pools = [
            CrossbarPool(spec, config.crossbars, leveling=config.pool_leveling or "none",
                         device=dev)
            for _ in range(n)
        ]
    elif len(pools) != n:
        raise ValueError(f"need {n} pools, got {len(pools)}")
    weights = dict(iter_weights(params, config))
    reports, deployed, owner = {}, {}, {}
    for i, (name, key) in enumerate(tensor_keys(params, config).items()):
        pool = pools[i % n]
        report, w_hat = analyze_tensor(weights[name].to(pool.device), spec, config,
                                       key.to(pool.device), name=name, pool=pool)
        reports[name] = report
        deployed[name] = w_hat
        owner[name] = i % n
    plan = DeploymentPlan(spec=spec, config=config, reports=reports, deployed=deployed)
    return plan, pools, owner


class ShardedScrub:
    """Per-shard IntegrityManagers behind the ``Engine.attach_scrub`` duck
    type.  Every ``scrub_round`` gives EVERY shard its slice of the budget
    (round-robin start, so no shard always goes first); the merged report's
    ``pending`` is the SUM over the shards (``ScrubReport.merge`` keeps a
    level, right for one manager over time, wrong across distinct pools),
    so the engine's repaired-plane refresh waits until every shard is
    clean."""

    def __init__(self, managers: Sequence[Any]):
        if not managers:
            raise ValueError("ShardedScrub needs at least one IntegrityManager")
        self.managers = list(managers)
        self._next = 0

    def pending_faults(self) -> int:
        return sum(m.pending_faults() for m in self.managers)

    def verify_all(self) -> bool:
        return all(m.verify_all() for m in self.managers)

    def scrub_round(self, budget_tiles: Optional[int] = None):
        n = len(self.managers)
        rep = None
        for j in range(n):
            m = self.managers[(self._next + j) % n]
            kw = {} if budget_tiles is None else {"budget_tiles": max(1, budget_tiles // n)}
            r = m.scrub_round(**kw)
            if rep is None:
                rep = r
            else:
                pend = rep.pending + r.pending
                rep.merge(r)
                rep.pending = pend
        self._next = (self._next + 1) % n
        return rep

    def rebuild_plan(self, plan):
        """Apply every shard's repaired reads onto one merged plan (each
        manager rebuilds only the tensors its own pool holds)."""
        for m in self.managers:
            plan = m.rebuild_plan(plan)
        return plan

