"""Continuous-batching CIM serving engine: paged KV + slot scheduler.

Port of ``repro.launch.engine``.  Serves heterogeneous, streaming requests
from one shared paged KV pool (``launch.paged_cache``) through
shape-bucketed dispatches:

  * **Admission** — waiting requests enter freed decode slots mid-flight as
    soon as a slot and enough KV blocks for their first prefill chunk are
    available (FIFO in arrival order).  Blocks are allocated lazily as a
    request grows.
  * **Fused prefill+decode** (default, ``EngineConfig.fused``) — each cycle
    runs one bucketed dispatch (``steps.make_fused_step``) in which prefill
    rows advance a chunk and decode rows a full quantum; a row that
    finishes its prompt samples its first token in-graph and decodes the
    rest of the quantum in the same dispatch.  With ``fused=False`` the
    engine keeps the split discipline (one chunked-prefill dispatch + one
    decode-quantum dispatch per cycle).
  * **Preemption** (``EngineConfig.preempt``) — when the free list cannot
    serve a growing request, the lowest-priority slot is preempted:
    ``"swap"`` copies its live KV cells to host memory
    (``paged_cache.swap_out``) and restores them byte-identical on
    re-admission; ``"recompute"`` drops the cells and re-prefills
    prompt+generated on re-admission (teacher-forced).
  * **Retirement** — EOS / max-new-tokens ends a request; its blocks return
    to the free list.

Row counts and page counts are padded to powers of two (dummy rows write to
the reserved dummy page).  Every dispatch kind of the reference is one
jitted function with one compiled variant per bucket; here each is a
step function (``launch.steps``) that writes the pools in place.  On CPU
pools it runs eagerly; on the card each (bucket, param epoch) is one CUDA
graph (``steps.CudaGraphCall``, captured at the bucket's first use or by
:meth:`Engine.prewarm`) over the engine's pools and the epoch's params,
which it reads at their addresses — no param tree is copied into a graph's
buffers.  A call copies the block table, tokens, per-row state and keys
into the graph's static buffers, replays it, and copies the tokens and keys
back to the host before any other graph replays; all graphs of an engine
share one memory pool.  A failed capture or replay raises.

Token parity: each request's stream is that of a solo
``launch.serve.generate`` run with the same seed, through fused and split
dispatches, mid-flight admission and preemption, for every
materialization; the scheduling (and so every ``stats`` counter) is the
reference's.

Tensor parallelism (``tp > 1``, ``parallel/tp.py``): the params are sharded
with sharded leaves on a shard axis and replicated ones once, the paged KV
pools of a sharded attention carry a shard axis behind the one block table
and slot schedule, and every dispatch runs the step functions of the local
config with all shards in process (``parallel.collective.ShardLoop`` at the
gates of ``models.blocks``) — on the card still one CUDA graph a bucket and
epoch.  The host scheduler is untouched.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels._util import resolve_device
from repro_torch.launch import paged_cache, steps
from repro_torch.launch.paged_cache import PagedCacheConfig, PagedKVCache
from repro_torch.models import api
from repro_torch.models.transformer import compute_dtype
from repro_torch.parallel import tp as tp_mod


@dataclasses.dataclass
class Request:
    """One generation request.  ``arrival_time`` is seconds relative to
    ``Engine.run`` start (0.0 = available immediately).

    ``deadline_s`` (seconds after arrival) bounds the request's total
    latency: once exceeded, the engine retires it with ``status="timeout"``
    — partial tokens returned, blocks freed.  ``priority_class`` is the SLO
    tier consumed by preemption victim-key policies (0 = most important).
    """

    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int
    greedy: bool = True
    seed: int = 0
    eos_id: Optional[int] = None
    arrival_time: float = 0.0
    deadline_s: Optional[float] = None
    priority_class: int = 0

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError("deadline_s must be positive (or None)")


@dataclasses.dataclass
class RequestResult:
    """Outcome of one request: its token stream plus the latency breakdown
    (seconds relative to ``Engine.run`` start, or the caller's clock).
    ``status``: ``"ok"``, ``"timeout"`` or ``"cancelled"``."""

    rid: int
    tokens: list[int]
    t_arrival: float
    t_admitted: float
    t_first_token: float
    t_done: float
    status: str = "ok"

    @property
    def latency(self) -> float:
        return self.t_done - self.t_arrival

    @property
    def ttft(self) -> float:
        return self.t_first_token - self.t_arrival


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Shape + scheduling policy for the engine.

    ``max_seq_len`` bounds prompt+generated per request; ``num_blocks``
    sizes the shared pool (default: enough for every slot's worst case).
    ``fused`` selects the fused prefill+decode dispatch; ``preempt`` what
    happens to a victim's KV under block pressure (``"swap"`` or
    ``"recompute"``).  ``victim_key`` maps a :class:`SlotView` to
    ``(protect, prefer)``: a slot may only evict slots whose ``protect`` is
    strictly larger than its own; ``prefer`` breaks ties (largest wins).
    ``None`` keeps :func:`fcfs_victim_key`.
    """

    max_slots: int = 8
    page_size: int = 16
    max_seq_len: int = 512  # upper bound on prompt + generated per request
    prefill_chunk: int = 32  # max prompt tokens per prefill dispatch
    decode_quantum: int = 8  # decode steps per dispatch
    num_blocks: Optional[int] = None  # default: dummy + max_slots * max_pages
    fused: bool = True  # fused prefill+decode dispatch per cycle
    preempt: str = "swap"  # "swap" | "recompute"
    victim_key: Optional[Callable[["SlotView"], tuple]] = None

    def __post_init__(self):
        for field in ("max_slots", "page_size", "max_seq_len",
                      "prefill_chunk", "decode_quantum"):
            if getattr(self, field) < 1:
                raise ValueError(f"{field} must be positive, got {getattr(self, field)}")
        if self.num_blocks is not None and self.num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (dummy page + one usable block), "
                f"got {self.num_blocks}"
            )
        if self.preempt not in ("swap", "recompute"):
            raise ValueError(
                f"unknown preemption mode {self.preempt!r}; "
                f"choose 'swap' or 'recompute'"
            )
        if self.victim_key is not None and not callable(self.victim_key):
            raise ValueError("victim_key must be callable (SlotView -> tuple) or None")


_WAITING, _PREFILL, _DECODE = "waiting", "prefill", "decode"


@dataclasses.dataclass(frozen=True)
class SlotView:
    """What a ``victim_key`` policy may observe of an occupied slot —
    host-only scheduling facts, never device state."""

    rid: int
    arrival_time: float
    priority_class: int
    decoding: bool  # prompt finished, emitting tokens
    generated: int  # tokens emitted so far
    deadline_s: Optional[float]


def fcfs_victim_key(v: SlotView) -> tuple:
    """Default preemption order: strict FCFS protection (latest arrival is
    evicted first), decode slots preferred among candidates."""
    return ((v.arrival_time, v.rid), (v.decoding,))


def priority_class_victim_key(v: SlotView) -> tuple:
    """SLO-tier preemption: a lower ``priority_class`` may evict any higher
    class regardless of arrival order; FCFS within a class; decode slots
    preferred among candidates."""
    return ((v.priority_class, v.arrival_time, v.rid), (v.decoding,))


def _seed_key(seed: int) -> np.ndarray:
    """A request's starting key on the host: ``prng.PRNGKey(seed)``."""
    return prng.PRNGKey(seed).numpy()


class _Slot:
    """Host state of one occupied decode slot."""

    def __init__(self, req: Request, t_admitted: float, epoch: int = 0):
        self.req = req
        self.epoch = epoch  # param epoch this request is pinned to (hot swap)
        self.state = _PREFILL
        self.prefill_done = 0  # target tokens already written to the pool
        self.pos = 0  # next decode write position (= tokens in cache)
        self.generated: list[int] = []
        self.tok_next = -1  # last emitted token (next decode input)
        self.pf_deferred = False  # lone-prefill batching: deferred one cycle
        self.key = _seed_key(req.seed)
        self.t_admitted = t_admitted
        self.t_first_token = 0.0
        # recompute re-admission: the sequence being re-prefilled (prompt +
        # already-generated tokens) and the pending token emitted before
        # preemption — adopted instead of a fresh sample when the replay ends
        self.replay: Optional[np.ndarray] = None
        self.saved_tok = -1

    @property
    def target(self) -> np.ndarray:
        """The token sequence prefill is walking: the prompt, or the
        teacher-forced prompt+generated replay after a recompute preemption."""
        return self.replay if self.replay is not None else self.req.prompt

    @property
    def view(self) -> SlotView:
        return SlotView(
            rid=self.req.rid,
            arrival_time=self.req.arrival_time,
            priority_class=self.req.priority_class,
            decoding=self.state == _DECODE,
            generated=len(self.generated),
            deadline_s=self.req.deadline_s,
        )


@dataclasses.dataclass
class ResumeState:
    """Everything needed to continue a request on *an* engine — the one it
    left (preemption requeue) or another replica (failover / hedging).

    ``n_live`` live cells ([0, n_live)) were either copied to the host
    (``snapshot``, swap mode) or dropped.  Re-admission restores what was
    copied, prefills the rest of the prefix prompt + generated[:-1]
    teacher-forced, then resumes decode with ``tok_next`` (already emitted —
    never re-sampled).  Keyed by logical position, so portable across
    engines with different block layouts (:meth:`Engine.resume` re-pins
    ``epoch``).
    """

    req: Request
    n_live: int
    generated: list[int]
    tok_next: int
    key: np.ndarray
    snapshot: Any  # host tree (swap) or None (recompute)
    t_admitted: float
    t_first_token: float
    epoch: int = 0  # param epoch the request stays pinned to across eviction

    @property
    def arrival_time(self) -> float:
        return self.req.arrival_time


def _bucket(n: int, cap: int) -> int:
    """Smallest power of two >= n, clamped to cap — the one bucketing rule
    for dispatch rows AND page counts."""
    b = 1
    while b < n and b < cap:
        b *= 2
    return min(b, cap)


def _buckets_upto(cap: int) -> list[int]:
    """Every value ``_bucket`` can return for caps up to ``cap``."""
    out, b = [], 1
    while b < cap:
        out.append(b)
        b *= 2
    out.append(cap)
    return out


class Engine:
    """Continuous-batching serving engine over a paged KV pool.

    ``params`` may be any ``deploy_params`` materialization (or plain fp
    weights); they are prepared once (``steps.prepare_serving_params``:
    packed operands densified on the CPU, matmul weights cast to the
    compute dtype).  The engine runs on the params' device: the card unless
    they are on the CPU.

    Public surface: :meth:`submit` / :meth:`step` for external event loops,
    :meth:`run` for a self-clocked trace, :meth:`prewarm` to build every
    bucketed dispatch up front; ``stats`` accumulates the reference's
    dispatch and preemption counters, ``graph_stats`` the CUDA graphs
    captured, their capture seconds and the memory they hold (zero on the
    CPU).
    """

    def __init__(self, cfg: ArchConfig, params: Any, ecfg: EngineConfig = EngineConfig(),
                 *, dispatch_from: Optional["Engine"] = None, tp: int = 1):
        if not api.supports_paged(cfg):
            raise NotImplementedError(
                f"{cfg.name}: the paged engine serves pure-attention decoder stacks"
            )
        self.cfg = cfg
        self.ecfg = ecfg
        dev = steps._params_device(params)
        self.device = resolve_device(None) if dev is None else dev
        # tensor parallelism: tp > 1 splits this replica over a "model" axis,
        # every shard in turn on the params' device at the gates of
        # models.blocks (the reference's one-device vmap emulation)
        if tp > 1:
            # plan against packed constraints even for dense trees: a hot
            # redeploy may swap a packed materialization in later, and the
            # shard layout must not change across epochs
            self._tp = tp_mod.plan_tp(cfg, tp, packed=True)
            self.cfg_local = tp_mod.local_config(cfg, self._tp)
        else:
            self._tp = None
            self.cfg_local = cfg
        # serving params are versioned by *epoch*: a hot redeploy swaps in a
        # new tree between dispatches while every in-flight request keeps
        # computing on the tree it was admitted under.  Replicas built from
        # one tree (dispatch_from, the fleet) share its prepared copy.
        self.params_epoch = 0
        src = dispatch_from
        if src is not None and src._source[0] is params and src._tp == self._tp:
            self._source = src._source
        else:
            self._source = (params, self._prepare(params))
        self._params: dict[int, Any] = {0: self._source[1]}

        # a slot's dispatches may address up to a fused window (one padded
        # prefill chunk + one decode quantum) past max_seq_len; writes beyond
        # its allocation land in the dummy page
        overhang = ecfg.prefill_chunk + ecfg.decode_quantum
        max_pages = -(-(ecfg.max_seq_len + overhang) // ecfg.page_size)
        num_blocks = ecfg.num_blocks or 1 + ecfg.max_slots * max_pages
        self.pcfg = PagedCacheConfig(
            page_size=ecfg.page_size,
            num_blocks=num_blocks,
            max_slots=ecfg.max_slots,
            max_pages=max_pages,
        )
        self.kv = PagedKVCache(self.pcfg)
        # written in place by every dispatch; never rebound (graphs hold the
        # leaves by address)
        self.pools = api.init_paged_pools(
            self.cfg_local, self.pcfg.num_tokens, device=self.device,
            shards=tp_mod.local_shards(self._tp) if self._tp is not None else 0)

        # two quantum lengths: the full quantum for steady decoding and a
        # short one for when most live rows sit near retirement
        self._quanta = sorted({max(2, ecfg.decode_quantum // 4), ecfg.decode_quantum})
        if dispatch_from is not None:
            # replicas of one fleet share the step functions; a graph holds
            # one engine's pools by address, so graphs are never shared
            src = dispatch_from
            if (src.cfg is not cfg
                    or src.ecfg.page_size != ecfg.page_size
                    or src.ecfg.decode_quantum != ecfg.decode_quantum
                    or src.ecfg.prefill_chunk != ecfg.prefill_chunk
                    or bool(src._fused_steps) != ecfg.fused
                    or src._tp != self._tp):
                raise ValueError(
                    "dispatch_from requires an engine with the same model "
                    "config, dispatch shapes (page_size, decode_quantum, "
                    "prefill_chunk, fused), and tensor-parallel layout"
                )
            self._decode_loops = src._decode_loops
            self._prefill_step = src._prefill_step
            self._fused_steps = src._fused_steps
        else:
            cl = self.cfg_local
            self._decode_loops = {
                q: steps.make_paged_decode_loop(cl, q, ecfg.page_size) for q in self._quanta
            }
            self._prefill_step = steps.make_prefill_chunk_step(cl, ecfg.page_size)
            self._fused_steps = {
                q: steps.make_fused_step(cl, q, ecfg.page_size) for q in self._quanta
            } if ecfg.fused else {}

        self._graphs: dict[tuple, steps.CudaGraphCall] = {}
        self._graph_pool = None
        # pool_bytes: the segments of the graphs' shared memory pool
        self.graph_stats = {"captured": 0, "dropped": 0, "capture_s": 0.0, "pool_bytes": 0}
        self.waiting: deque[Union[Request, ResumeState]] = deque()
        self.slots: list[Optional[_Slot]] = [None] * ecfg.max_slots
        self.results: dict[int, RequestResult] = {}
        self._shapes_seen: set[tuple] = set()
        self.stats = {
            "decode_dispatches": 0,
            "prefill_dispatches": 0,
            "fused_dispatches": 0,
            "decode_rows_live": 0,
            "decode_rows_padded": 0,
            "tokens_emitted": 0,
            "tokens_overrun": 0,
            "preemptions": 0,
            "preempt_swap": 0,
            "preempt_recompute": 0,
            "swap_ins": 0,
            "readmissions": 0,
            "hot_swaps": 0,
            "swap_rollbacks": 0,
            "epochs_retired": 0,
            "timeouts": 0,
            "cancels": 0,
            "scrub_rounds": 0,
            "scrub_tiles": 0,
            "scrub_detections": 0,
            "scrub_repairs": 0,
            "scrub_refreshes": 0,
        }
        self._scrub_mgr = None
        self._scrub_refresh = None
        self._scrub_every = 1
        self._scrub_cycles = 0

    def _prepare(self, params: Any) -> Any:
        """Serving-ready tree on the engine's device: prepared solo, or
        sharded (shards on an axis after the layer axis) under TP."""
        if self._tp is None:
            return steps.prepare_serving_params(params, compute_dtype(self.cfg))
        return tp_mod.prepare_tp_params(params, self._tp, compute_dtype(self.cfg))

    # -- dispatch: eager on the CPU, one CUDA graph per bucket on the card ---

    def _dispatch(self, name: tuple, fn, epoch: int, host: list[np.ndarray],
                  outs: tuple[int, ...]):
        """``fn(params, pools, *host)`` for ``epoch``; returns its outputs
        at the positions ``outs`` as numpy arrays.  On the card the (``name``,
        epoch) graph is captured at first use, then replayed."""
        params = self._params[epoch]
        if self.device.type != "cuda":
            args = [torch.from_numpy(h) for h in host]
            with torch.inference_mode():
                out = fn(params, self.pools, *args)
            return [out[i].numpy() for i in outs]
        key = (name, epoch)
        graph = self._graphs.get(key)
        args = [torch.from_numpy(h) for h in host]
        if graph is None:
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            static = [a.to(self.device) for a in args]
            torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            with torch.inference_mode():
                graph = steps.CudaGraphCall(fn, params, self.pools, *static,
                                            pool=self._graph_pool)
            torch.cuda.synchronize(self.device)
            self.graph_stats["capture_s"] += time.perf_counter() - t0
            self.graph_stats["pool_bytes"] = self._graph_pool_bytes()
            self.graph_stats["captured"] += 1
            self._graphs[key] = graph
        out = graph(params, self.pools, *args)
        return [out[i].cpu().numpy() for i in outs]

    def _graph_pool_bytes(self) -> int:
        """Bytes of the segments the caching allocator holds in this
        engine's graph pool."""
        pid = tuple(self._graph_pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pid)

    # -- public API ---------------------------------------------------------

    @property
    def params(self) -> Any:
        """The current-epoch serving params (what new admissions use)."""
        return self._params[self.params_epoch]

    def hot_swap(self, params: Any, *, policy=None) -> bool:
        """Atomically swap in new serving params between dispatches.

        ``params`` is a ready param tree or a zero-argument callable
        producing one, run under ``runtime.fault.run_with_retries`` with
        ``policy`` (default: no retries).  On failure the swap rolls back:
        the old params keep serving, ``stats["swap_rollbacks"]`` increments,
        and False is returned.  On success new admissions use the new epoch
        while in-flight requests finish on theirs; an epoch is dropped
        (with its graphs) once its last request drains.
        """
        from repro_torch.runtime.fault import FaultPolicy, run_with_retries

        if callable(params):
            try:
                params = run_with_retries(params, policy or FaultPolicy(max_retries=0))
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception:
                self.stats["swap_rollbacks"] += 1
                return False
        self.params_epoch += 1
        self._params[self.params_epoch] = self._prepare(params)
        self.stats["hot_swaps"] += 1
        return True

    def attach_scrub(self, manager, *, refresh=None, every: int = 1) -> None:
        """Run a budgeted integrity scrub between dispatch rounds.

        ``manager`` is a ``core.integrity.IntegrityManager`` (anything with
        ``scrub_round()`` / ``pending_faults()``); one round runs every
        ``every``-th scheduler cycle, after the cycle's dispatches.  When a
        round repairs and the manager comes back clean, ``refresh`` (a
        zero-arg callable producing repaired serving params) is swapped in
        through :meth:`hot_swap`.
        """
        if every < 1:
            raise ValueError(f"scrub interval must be >= 1, got {every}")
        self._scrub_mgr = manager
        self._scrub_refresh = refresh
        self._scrub_every = int(every)
        self._scrub_cycles = 0

    def _scrub_tick(self) -> None:
        if self._scrub_mgr is None:
            return
        self._scrub_cycles += 1
        if self._scrub_cycles % self._scrub_every:
            return
        rep = self._scrub_mgr.scrub_round()
        self.stats["scrub_rounds"] += 1
        self.stats["scrub_tiles"] += rep.tiles_scanned
        self.stats["scrub_detections"] += rep.detections
        repairs = rep.rewrites + rep.remaps + rep.migrations
        self.stats["scrub_repairs"] += repairs
        if (repairs and self._scrub_refresh is not None
                and self._scrub_mgr.pending_faults() == 0):
            if self.hot_swap(self._scrub_refresh):
                self.stats["scrub_refreshes"] += 1

    def _gc_params(self) -> None:
        """Drop param epochs (and their graphs) no live or queued-preempted
        request references."""
        live = {self.params_epoch}
        live.update(s.epoch for s in self.slots if s is not None)
        live.update(
            w.epoch for w in self.waiting if isinstance(w, ResumeState)
        )
        for ep in [e for e in self._params if e not in live]:
            del self._params[ep]
            if ep == 0:  # nothing may share the first tree any more
                self._source = (None, None)
            for key in [k for k in self._graphs if k[1] == ep]:
                del self._graphs[key]
                self.graph_stats["dropped"] += 1
            self.stats["epochs_retired"] += 1

    def _row_buckets(self) -> list[int]:
        return _buckets_upto(self.ecfg.max_slots)

    def _page_buckets(self) -> list[int]:
        return _buckets_upto(self.pcfg.max_pages)

    def prewarm(self) -> int:
        """Build bucketed dispatch variants up front with dummy dispatches
        aimed at the dummy page (slot state untouched; the pool only absorbs
        garbage into block 0): on the card each captures its graph for the
        current epoch.  The decode and prefill grids are covered
        exhaustively; fused variants the full-width chunk with bp 1 and bp =
        rows.  Returns the number of variants."""
        n = 0
        chunk = self.ecfg.prefill_chunk
        page = self.ecfg.page_size
        ep = self.params_epoch
        for q, loop in self._decode_loops.items():
            for rows in self._row_buckets():
                for pages in self._page_buckets():
                    self._dispatch(("decode", q, rows, pages), loop, ep, [
                        np.zeros((rows, pages), np.int32),
                        np.zeros((rows, 3), np.int32),
                        np.zeros((rows, 2), np.int64),
                    ], ())
                    self._shapes_seen.add(("decode", q, rows, pages))
                    n += 1
        min_pf_pages = -(-chunk // page)  # view must fit a chunk
        for rows in self._row_buckets():
            for pages in self._page_buckets():
                if pages < min_pf_pages:
                    continue
                meta = np.zeros((rows, 4), np.int32)
                meta[:, 1] = 1
                self._dispatch(("prefill", rows, pages), self._prefill_step, ep, [
                    np.zeros((rows, pages), np.int32),
                    np.zeros((rows, chunk), np.int32),
                    meta,
                    np.zeros((rows, 2), np.int64),
                ], ())
                self._shapes_seen.add(("prefill", rows, pages))
                n += 1
        for q, step in self._fused_steps.items():
            for rows in self._row_buckets():
                for pages in self._page_buckets():
                    if pages < min_pf_pages:
                        continue
                    for bp in {1, rows}:
                        pf_meta = np.zeros((bp, 5), np.int32)
                        pf_meta[:, 1] = 1  # pad rows: kv_len 1
                        state = np.zeros((rows, 5), np.int32)
                        state[:, 2] = 1  # greedy: no PRNG consumption
                        self._dispatch(("fused", q, chunk, bp, rows, pages), step, ep, [
                            np.zeros((bp, pages), np.int32),
                            np.zeros((bp, chunk), np.int32),
                            pf_meta,
                            np.zeros((bp, 2), np.int64),
                            np.zeros((rows, pages), np.int32),
                            state,
                            np.zeros((rows, 2), np.int64),
                            np.full((rows,), -1, np.int32),
                        ], ())
                        self._shapes_seen.add(("fused", q, chunk, bp, rows, pages))
                        n += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return n

    def _cap_tokens(self, req: Request) -> int:
        """Deepest cell a request ever reads: positions [0, prompt +
        max_new - 1); allocation requests clamp here."""
        return req.prompt.size + req.max_new_tokens - 1

    def _check_fits(self, req: Request) -> None:
        if req.prompt.size + req.max_new_tokens > self.ecfg.max_seq_len:
            raise ValueError(
                f"request {req.rid}: prompt+max_new "
                f"{req.prompt.size + req.max_new_tokens} > max_seq_len "
                f"{self.ecfg.max_seq_len}"
            )
        need = -(-self._cap_tokens(req) // self.ecfg.page_size)
        if need > self.pcfg.usable_blocks:
            raise ValueError(
                f"request {req.rid}: needs {need} KV blocks > pool's "
                f"{self.pcfg.usable_blocks} usable blocks"
            )

    def submit(self, req: Request) -> None:
        """Queue a request.  Rejects requests that could never complete:
        longer than ``max_seq_len``, or needing more KV blocks than the
        whole pool holds."""
        self._check_fits(req)
        self.waiting.append(req)

    def step(self, now: float) -> bool:
        """One scheduler cycle.  Returns True if any dispatch ran.

        Fused mode: admit, then one dispatch advancing every occupied slot.
        Split mode: admit, one chunked-prefill dispatch over prefilling
        slots, one decode-quantum dispatch over decoding slots.  After a hot
        swap each param epoch gets its own dispatch round."""
        self._expire(now)
        self._admit(now)
        epochs = sorted({s.epoch for s in self.slots if s is not None})
        did = False
        for ep in epochs:
            if self.ecfg.fused:
                did = self._fused_round(now, ep) or did
            else:
                did = self._prefill_round(now, ep) or did
                did = self._decode(now, ep) or did
        self._scrub_tick()
        self._gc_params()
        return did

    def run(self, requests: list[Request]) -> list[RequestResult]:
        """Serve ``requests`` to completion (wall-clock arrival times).
        Admission is FIFO in arrival order."""
        for r in sorted(requests, key=lambda r: r.arrival_time):
            self.submit(r)
        t0 = time.perf_counter()
        while self.waiting or any(s is not None for s in self.slots):
            now = time.perf_counter() - t0
            if not self.step(now):
                if any(s is not None for s in self.slots):
                    continue  # admission blocked on blocks about to free
                nxt = min(r.arrival_time for r in self.waiting)
                if nxt <= now:
                    raise RuntimeError(
                        "scheduler stalled: request exceeds pool capacity"
                    )
                time.sleep(min(nxt - now, 0.05))
        self.stats["compiled_variants"] = len(self._shapes_seen)
        return [self.results[r.rid] for r in requests]

    # -- deadlines / cancellation / cross-replica records --------------------

    def _finish_waiting(self, item: Union[Request, ResumeState], now: float,
                        status: str) -> None:
        """Record a result for a request that ends while still queued."""
        if isinstance(item, ResumeState):
            req, tokens = item.req, list(item.generated)
            t_admitted, t_first = item.t_admitted, item.t_first_token
        else:
            req, tokens = item, []
            t_admitted = t_first = now
        self.results[req.rid] = RequestResult(
            rid=req.rid, tokens=tokens, t_arrival=req.arrival_time,
            t_admitted=t_admitted, t_first_token=t_first, t_done=now,
            status=status,
        )
        self.stats["timeouts" if status == "timeout" else "cancels"] += 1
        self.stats["tokens_emitted"] += len(tokens)

    def _expire(self, now: float) -> None:
        """Retire everything past its deadline, in slots and in the queue."""

        def expired(req: Request) -> bool:
            return req.deadline_s is not None and (
                now >= req.arrival_time + req.deadline_s
            )

        for i, s in enumerate(self.slots):
            if s is not None and expired(s.req):
                self._retire(i, now, status="timeout")
        if any(expired(w.req if isinstance(w, ResumeState) else w)
               for w in self.waiting):
            keep: deque[Union[Request, ResumeState]] = deque()
            for w in self.waiting:
                if expired(w.req if isinstance(w, ResumeState) else w):
                    self._finish_waiting(w, now, "timeout")
                else:
                    keep.append(w)
            self.waiting = keep

    def cancel(self, rid: int, *, now: float = 0.0, status: str = "cancelled") -> bool:
        """Abort request ``rid`` wherever it is; False if unknown or done."""
        for i, s in enumerate(self.slots):
            if s is not None and s.req.rid == rid:
                self._retire(i, now, status=status)
                return True
        for j, w in enumerate(self.waiting):
            if (w.req if isinstance(w, ResumeState) else w).rid == rid:
                del self.waiting[j]
                self._finish_waiting(w, now, status)
                return True
        return False

    def _fresh_record(self, req: Request) -> ResumeState:
        return ResumeState(req=req, n_live=0, generated=[], tok_next=-1,
                           key=_seed_key(req.seed), snapshot=None,
                           t_admitted=0.0, t_first_token=0.0)

    def export_state(self, rid: int) -> Optional[ResumeState]:
        """Host-side copy of ``rid``'s progress without disturbing this
        engine (no eviction, no device copy); None if unknown or done."""
        for s in self.slots:
            if s is not None and s.req.rid == rid:
                return ResumeState(
                    req=s.req,
                    n_live=0,
                    generated=list(s.generated),
                    tok_next=s.saved_tok if s.replay is not None else s.tok_next,
                    key=np.array(s.key),
                    snapshot=None,
                    t_admitted=s.t_admitted,
                    t_first_token=s.t_first_token,
                )
        for w in self.waiting:
            if isinstance(w, ResumeState) and w.req.rid == rid:
                return dataclasses.replace(w, generated=list(w.generated),
                                           n_live=0, snapshot=None)
            if isinstance(w, Request) and w.rid == rid:
                return self._fresh_record(w)
        return None

    def evict(self, rid: int, *, snapshot: bool = False) -> Optional[ResumeState]:
        """Remove ``rid`` and return the record another replica needs to
        finish it; ``snapshot=True`` adds the KV copy.  None if unknown."""
        for i, s in enumerate(self.slots):
            if s is not None and s.req.rid == rid:
                return self._evict_record(i, want_snapshot=snapshot)
        for j, w in enumerate(self.waiting):
            if (w.req if isinstance(w, ResumeState) else w).rid == rid:
                del self.waiting[j]
                return w if isinstance(w, ResumeState) else self._fresh_record(w)
        return None

    def resume(self, rec: ResumeState) -> None:
        """Adopt a record exported by another engine, re-pinned to this
        engine's current param epoch, queued FIFO by arrival time."""
        self._check_fits(rec.req)
        rec.epoch = self.params_epoch
        self._reinsert(rec)

    # -- admission / preemption ---------------------------------------------

    def _admit(self, now: float) -> None:
        """FIFO admission of the waiting head into free slots.  Admission
        itself never preempts."""
        for i, slot in enumerate(self.slots):
            if slot is not None or not self.waiting:
                continue
            head = self.waiting[0]
            if head.arrival_time > now:
                break  # FIFO: later arrivals wait behind the head
            if isinstance(head, ResumeState):
                if not self._readmit(i, head):
                    break  # out of blocks until a retirement frees some
            else:
                first = min(self.ecfg.prefill_chunk, head.prompt.size)
                if not self.kv.ensure_capacity(i, first):
                    break
                self.slots[i] = _Slot(head, now, epoch=self.params_epoch)
            self.waiting.popleft()

    def _readmit(self, idx: int, rec: ResumeState) -> bool:
        """Seat a preempted request back into slot ``idx``; False if the
        free list can't yet hold its live cells plus its next chunk (then
        nothing is allocated or restored)."""
        gen = rec.generated
        prefix = (
            np.concatenate([rec.req.prompt, np.asarray(gen[:-1], np.int32)])
            if gen else rec.req.prompt
        )
        restored = rec.n_live if rec.snapshot is not None else 0
        decode_ready = bool(gen) and restored == prefix.size
        need = restored if decode_ready else (
            restored + min(self.ecfg.prefill_chunk, prefix.size - restored)
        )
        if not self.kv.ensure_capacity(idx, need):
            return False
        if rec.snapshot is not None:
            paged_cache.swap_in(self.pools, self.kv, idx, rec.snapshot)
            self.stats["swap_ins"] += 1
        slot = _Slot(rec.req, rec.t_admitted, epoch=rec.epoch)
        slot.key = rec.key
        slot.generated = gen
        slot.t_first_token = rec.t_first_token
        if decode_ready:
            slot.state = _DECODE
            slot.pos = restored
            slot.tok_next = rec.tok_next
        else:
            slot.prefill_done = restored
            if gen:
                slot.replay = prefix
                slot.saved_tok = rec.tok_next
        self.slots[idx] = slot
        self.stats["readmissions"] += 1
        return True

    def _wkey(self, item: Union[Request, ResumeState]) -> tuple[float, int]:
        r = item if isinstance(item, Request) else item.req
        return (r.arrival_time, r.rid)

    def _reinsert(self, rec: ResumeState) -> None:
        """Put a preempted request back into the queue in arrival order."""
        key = self._wkey(rec)
        at = len(self.waiting)
        for j, w in enumerate(self.waiting):
            if self._wkey(w) > key:
                at = j
                break
        self.waiting.insert(at, rec)

    def _vkey(self, slot: _Slot) -> tuple:
        """(protect, prefer) of a slot under the configured victim policy."""
        return (self.ecfg.victim_key or fcfs_victim_key)(slot.view)

    def _pick_victim(self, exclude: int, than: tuple) -> Optional[int]:
        """The most evictable slot whose ``protect`` key is strictly above
        ``than``, or None."""
        best, best_key = None, None
        for i, s in enumerate(self.slots):
            if s is None or i == exclude:
                continue
            protect, prefer = self._vkey(s)
            if protect <= than:
                continue
            key = (prefer, protect)
            if best_key is None or key > best_key:
                best, best_key = i, key
        return best

    def _evict_record(self, idx: int, *, want_snapshot: bool) -> ResumeState:
        """Remove slot ``idx`` and return the record that continues it."""
        slot = self.slots[idx]
        n_live = slot.pos if slot.state == _DECODE else slot.prefill_done
        snapshot = None
        if want_snapshot and n_live:
            snapshot = paged_cache.swap_out(self.pools, self.kv, idx, n_live)
        if not want_snapshot:
            n_live = 0  # drop the cells, replay the prefix on re-admission
        self.kv.release(idx)
        self.slots[idx] = None
        return ResumeState(
            req=slot.req,
            n_live=n_live,
            generated=slot.generated,
            tok_next=slot.saved_tok if slot.replay is not None else slot.tok_next,
            key=slot.key,
            snapshot=snapshot,
            t_admitted=slot.t_admitted,
            t_first_token=slot.t_first_token,
            epoch=slot.epoch,
        )

    def _preempt(self, idx: int) -> None:
        """Evict slot ``idx`` under block pressure and requeue it FIFO."""
        want = self.ecfg.preempt == "swap"
        self.stats["preempt_swap" if want else "preempt_recompute"] += 1
        self.stats["preemptions"] += 1
        self._reinsert(self._evict_record(idx, want_snapshot=want))

    def _ensure_blocks(self, idx: int, n_tokens: int) -> bool:
        """Grow slot ``idx`` to ``n_tokens`` cells, preempting lower-priority
        slots while the free list is short; False if it must skip a cycle."""
        protect = self._vkey(self.slots[idx])[0]
        while not self.kv.ensure_capacity(idx, n_tokens):
            victim = self._pick_victim(exclude=idx, than=protect)
            if victim is None:
                return False
            self._preempt(victim)
        return True

    def _secure_rows(self, rows: list[int], need_fn) -> list[int]:
        """Secure each row's block need in priority order and return the
        sorted survivors."""
        kept = []
        for i in sorted(rows, key=lambda i: self._vkey(self.slots[i])[0]):
            s = self.slots[i]
            if s is None:
                continue
            if self._ensure_blocks(i, need_fn(s)):
                kept.append(i)
        return sorted(kept)

    # -- retirement ---------------------------------------------------------

    def _retire(self, idx: int, now: float, status: str = "ok") -> None:
        slot = self.slots[idx]
        self.kv.release(idx)
        self.slots[idx] = None
        self.results[slot.req.rid] = RequestResult(
            rid=slot.req.rid,
            tokens=slot.generated,
            t_arrival=slot.req.arrival_time,
            t_admitted=slot.t_admitted,
            t_first_token=slot.t_first_token,
            t_done=now,
            status=status,
        )
        if status == "timeout":
            self.stats["timeouts"] += 1
        elif status == "cancelled":
            self.stats["cancels"] += 1
        self.stats["tokens_emitted"] += len(slot.generated)

    def _append_token(self, idx: int, tok: int, now: float) -> bool:
        """Append one emitted token; True if the request retired."""
        slot = self.slots[idx]
        slot.generated.append(tok)
        req = slot.req
        if (req.eos_id is not None and tok == req.eos_id) or len(
            slot.generated
        ) >= req.max_new_tokens:
            self._retire(idx, now)
            return True
        return False

    def _choose_quantum(self, remaining: list[int]) -> int:
        """The quantum with the best useful-tokens-per-cost (cost: q steps
        per row plus ~2.5 step-equivalents of dispatch overhead)."""
        return max(
            self._quanta,
            key=lambda qq: sum(min(qq, x) for x in remaining) / (qq + 2.5),
        )

    # -- fused dispatch ------------------------------------------------------

    def _fused_round(self, now: float, epoch: int = 0) -> bool:
        """One dispatch advancing every occupied slot of ``epoch``: prefill
        rows a chunk, decode rows a quantum, prompt-finishing rows both.
        All-decode mixes take the pure decode loop, all-mid-prompt ones the
        pure chunk step."""
        occupied = [
            i for i, s in enumerate(self.slots)
            if s is not None and s.epoch == epoch
        ]
        if not occupied:
            return False

        def c_true(s: _Slot) -> int:
            return min(self.ecfg.prefill_chunk, s.target.size - s.prefill_done)

        def finishing(s: _Slot) -> bool:
            return s.prefill_done + c_true(s) == s.target.size

        dec = [i for i in occupied if self.slots[i].state == _DECODE]
        pf = [i for i in occupied if self.slots[i].state == _PREFILL]
        if not pf:
            return self._decode(now, epoch)
        active0 = dec + [i for i in pf if finishing(self.slots[i])]
        if not active0:
            return self._prefill_round(now, epoch)
        # lone-prefill batching: with decode busy and more requests queued, a
        # single fresh admission waits one cycle to share its chunk stage
        if (
            len(pf) == 1
            and self.waiting
            and not self.slots[pf[0]].pf_deferred
            and len(dec) >= max(2, self.ecfg.max_slots // 2)
        ):
            self.slots[pf[0]].pf_deferred = True
            return self._decode(now, epoch)

        rem = [
            self.slots[i].req.max_new_tokens - len(self.slots[i].generated)
            for i in active0
        ]
        q = self._choose_quantum(rem)

        def fused_need(s: _Slot) -> int:
            cap = self._cap_tokens(s.req)
            if s.state == _DECODE:
                return min(s.pos + q, cap)
            if finishing(s):
                return min(s.target.size + q, cap)
            return s.prefill_done + c_true(s)

        rows = self._secure_rows(occupied, fused_need)
        pf_rows = [i for i in rows if self.slots[i].state == _PREFILL]
        scan_rows = [
            i for i in rows
            if self.slots[i].state == _DECODE or finishing(self.slots[i])
        ]
        if not pf_rows:
            return self._decode(now, epoch) if scan_rows else False
        if not scan_rows:
            return self._prefill_round(now, epoch)

        page = self.ecfg.page_size
        c = _bucket(max(c_true(self.slots[i]) for i in pf_rows), self.ecfg.prefill_chunk)
        bp = _bucket(len(pf_rows), self.ecfg.max_slots)
        nb = _bucket(len(scan_rows), self.ecfg.max_slots)

        def scan_pos0(s: _Slot) -> int:
            return s.pos if s.state == _DECODE else s.target.size

        pages = _bucket(
            max(
                max(-(-(self.slots[i].prefill_done + c) // page) for i in pf_rows),
                max(-(-(scan_pos0(self.slots[i]) + q) // page) for i in scan_rows),
            ),
            self.pcfg.max_pages,
        )
        shape = ("fused", q, c, bp, nb, pages)
        self._shapes_seen.add(shape)

        pf_tokens = np.zeros((bp, c), np.int32)
        pf_table = np.zeros((bp, pages), np.int32)
        pf_meta = np.zeros((bp, 5), np.int32)
        pf_meta[:, 1] = 1  # pad rows: kv_len 1 (any valid value)
        pf_keys = np.zeros((bp, 2), np.int64)
        for m, i in enumerate(pf_rows):
            s = self.slots[i]
            ct = c_true(s)
            start = s.prefill_done
            pf_tokens[m, :ct] = s.target[start : start + ct]
            pf_table[m] = self.kv.table_rows([i], pages)[0]
            pf_keys[m] = s.key
            consume = finishing(s) and s.replay is None  # replays never re-sample
            pf_meta[m] = (start, start + ct, ct - 1, int(s.req.greedy), int(consume))

        table = np.zeros((nb, pages), np.int32)
        state = np.zeros((nb, 5), np.int32)
        state[:, 2] = 1  # pad rows: greedy (no PRNG consumption)
        keys = np.zeros((nb, 2), np.int64)
        join = np.full((nb,), -1, np.int32)
        for r, i in enumerate(scan_rows):
            s = self.slots[i]
            table[r] = self.kv.table_rows([i], pages)[0]
            keys[r] = s.key
            if s.state == _DECODE:
                state[r] = (s.tok_next, s.pos, int(s.req.greedy), 0, 0)
            else:
                replay = s.replay is not None
                join[r] = pf_rows.index(i)
                state[r] = (
                    0, s.target.size, int(s.req.greedy),
                    s.saved_tok if replay else 0, int(replay),
                )

        pf_tok, toks, keys_out = self._dispatch(
            shape, self._fused_steps[q], epoch,
            [pf_table, pf_tokens, pf_meta, pf_keys, table, state, keys, join], (0, 1, 2))
        self.stats["fused_dispatches"] += 1
        self.stats["decode_rows_live"] += len(
            [i for i in scan_rows if self.slots[i].state == _DECODE]
        )
        self.stats["decode_rows_padded"] += nb - len(scan_rows)

        for i in pf_rows:
            self.slots[i].prefill_done += c_true(self.slots[i])
        for r, i in enumerate(scan_rows):
            s = self.slots[i]
            s.key = keys_out[r]
            if s.state == _DECODE:
                self._consume_quantum(i, toks[r, :q], s.pos + q, now)
                continue
            end_pos = s.target.size + q
            s.state = _DECODE
            if s.replay is not None:
                s.replay = None  # the first token was emitted pre-preemption
                self._consume_quantum(i, toks[r, :q], end_pos, now)
                continue
            s.t_first_token = now
            if self._append_token(i, int(pf_tok[join[r]]), now):
                self.stats["tokens_overrun"] += q  # retired on its 1st token
                continue
            self._consume_quantum(i, toks[r, :q], end_pos, now)
        return True

    def _consume_quantum(
        self, idx: int, emitted: np.ndarray, end_pos: int, now: float
    ) -> None:
        """Fold a dispatch's emitted tokens for one row into its slot."""
        slot = self.slots[idx]
        for j, tok in enumerate(emitted):
            if self._append_token(idx, int(tok), now):
                self.stats["tokens_overrun"] += len(emitted) - 1 - j
                return
        slot.tok_next = int(emitted[-1])
        slot.pos = end_pos

    # -- split prefill ------------------------------------------------------

    def _prefill_round(self, now: float, epoch: int = 0) -> bool:
        """One batched dispatch advancing every prefilling slot of ``epoch``
        by one chunk; a row's final chunk also picks its first token."""
        rows = [
            i for i, s in enumerate(self.slots)
            if s is not None and s.state == _PREFILL and s.epoch == epoch
        ]
        if not rows:
            return False
        # lone-prefill batching (split mode only)
        if (
            not self.ecfg.fused
            and len(rows) == 1
            and self.waiting
            and not self.slots[rows[0]].pf_deferred
            and sum(
                1 for s in self.slots if s is not None and s.state == _DECODE
            ) >= max(2, self.ecfg.max_slots // 2)
        ):
            self.slots[rows[0]].pf_deferred = True
            return False
        c = self.ecfg.prefill_chunk
        page = self.ecfg.page_size

        rows = self._secure_rows(
            rows,
            lambda s: s.prefill_done + min(c, s.target.size - s.prefill_done),
        )
        if not rows:
            return False
        c_trues = [
            min(c, self.slots[i].target.size - self.slots[i].prefill_done)
            for i in rows
        ]
        nb = _bucket(len(rows), self.ecfg.max_slots)
        # the view must address the full padded chunk [start, start + c)
        pages = _bucket(
            max(-(-(self.slots[i].prefill_done + c) // page) for i in rows),
            self.pcfg.max_pages,
        )
        shape = ("prefill", nb, pages)
        self._shapes_seen.add(shape)

        tokens = np.zeros((nb, c), np.int32)
        table = np.zeros((nb, pages), np.int32)
        meta = np.zeros((nb, 4), np.int32)
        meta[:, 1] = 1  # pad rows: kv_len 1 (any valid value)
        keys = np.zeros((nb, 2), np.int64)
        for r, (i, ct) in enumerate(zip(rows, c_trues)):
            slot = self.slots[i]
            start = slot.prefill_done
            tokens[r, :ct] = slot.target[start : start + ct]
            table[r] = self.kv.table_rows([i], pages)[0]
            meta[r] = (start, start + ct, ct - 1, int(slot.req.greedy))
            keys[r] = slot.key

        toks, keys_out = self._dispatch(shape, self._prefill_step, epoch,
                                        [table, tokens, meta, keys], (0, 1))
        self.stats["prefill_dispatches"] += 1
        for r, (i, ct) in enumerate(zip(rows, c_trues)):
            slot = self.slots[i]
            slot.prefill_done += ct
            if slot.prefill_done < slot.target.size:
                continue  # mid-prompt chunk: discard tok, keep the unsplit key
            if slot.replay is not None:
                # recompute replay complete: resume decode with the token
                # emitted before preemption — never re-sample it
                slot.pos = slot.replay.size
                slot.tok_next = slot.saved_tok
                slot.replay = None
                slot.state = _DECODE
                continue
            slot.key = keys_out[r]
            slot.state = _DECODE
            slot.pos = slot.req.prompt.size
            slot.tok_next = int(toks[r])
            slot.t_first_token = now
            self._append_token(i, slot.tok_next, now)
        return True

    # -- split decode -------------------------------------------------------

    def _decode(self, now: float, epoch: int = 0) -> bool:
        """One decode-quantum dispatch over every decoding slot of ``epoch``."""
        rows = [
            i for i, s in enumerate(self.slots)
            if s is not None and s.state == _DECODE and s.epoch == epoch
        ]
        if not rows:
            return False
        rem = [
            self.slots[i].req.max_new_tokens - len(self.slots[i].generated)
            for i in rows
        ]
        q = self._choose_quantum(rem)

        rows = self._secure_rows(
            rows, lambda s: min(s.pos + q, self._cap_tokens(s.req))
        )
        if not rows:
            return False

        page = self.ecfg.page_size
        nb = _bucket(len(rows), self.ecfg.max_slots)
        pages = _bucket(
            max(-(-(self.slots[i].pos + q) // page) for i in rows), self.pcfg.max_pages
        )
        shape = ("decode", q, nb, pages)
        self._shapes_seen.add(shape)

        table = np.zeros((nb, pages), np.int32)  # pad rows -> dummy page
        table[: len(rows)] = self.kv.table_rows(rows, pages)
        state = np.zeros((nb, 3), np.int32)  # [tok, pos, greedy] per row
        state[:, 2] = 1
        keys = np.zeros((nb, 2), np.int64)
        for r, i in enumerate(rows):
            s = self.slots[i]
            state[r] = (s.tok_next, s.pos, int(s.req.greedy))
            keys[r] = s.key

        toks, keys_out = self._dispatch(shape, self._decode_loops[q], epoch,
                                        [table, state, keys], (0, 2))
        self.stats["decode_dispatches"] += 1
        self.stats["decode_rows_live"] += len(rows)
        self.stats["decode_rows_padded"] += nb - len(rows)

        for r, i in enumerate(rows):
            slot = self.slots[i]
            slot.key = keys_out[r]
            self._consume_quantum(i, toks[r, :q], slot.pos + q, now)
        return True


# ---------------------------------------------------------------------------
# Health monitoring: degradation-triggered hot redeploy
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Trigger thresholds for :class:`HealthMonitor`: the shadow-batch logit
    KL of the serving params against a clean reference
    (``simulator.logit_kl``), and the pool's exhaustion horizon under
    ``endurance`` writes per cell; ``consecutive_breaches`` breached probes
    in a row trigger."""

    kl_threshold: float = 0.05
    min_horizon: float = 1.0
    endurance: float = 1e8  # pool.DEFAULT_ENDURANCE
    consecutive_breaches: int = 1

    def __post_init__(self):
        if self.consecutive_breaches < 1:
            raise ValueError(
                f"consecutive_breaches must be >= 1, got {self.consecutive_breaches}"
            )


class HealthMonitor:
    """Samples serving health against a clean reference on a shadow batch;
    ``check()`` recommends a redeploy (program the next checkpoint, then
    ``Engine.hot_swap`` it in)."""

    def __init__(self, cfg: ArchConfig, ref_params: Any, shadow_batch: Any,
                 hcfg: HealthConfig = HealthConfig()):
        self.cfg = cfg
        self.ref_params = ref_params
        self.shadow_batch = shadow_batch
        self.hcfg = hcfg
        self.history: list[dict] = []
        self.breaches = 0  # current run of consecutive breached probes

    def probe(self, params: Any) -> float:
        """Shadow-batch logit KL(reference || params) — degradation signal."""
        from repro_torch.core import simulator

        f = lambda p, b: api.forward(p, self.cfg, b)[0]  # noqa: E731
        with torch.inference_mode():
            return float(simulator.logit_kl(f, self.ref_params, params, self.shadow_batch))

    def check(self, params: Any, pool: Any = None) -> tuple[bool, dict]:
        """One health sample; returns (should_redeploy, record).  ``pool`` (a
        ``core.pool.CrossbarPool``) adds the wear signal: a redeploy is
        recommended when the KL exceeds the threshold or the exhaustion
        horizon drops below ``min_horizon``, for the configured run of
        consecutive breaches."""
        kl = self.probe(params)
        horizon = float("inf")
        if pool is not None:
            horizon = pool.stats().exhaustion_horizon(self.hcfg.endurance)
        breach = kl > self.hcfg.kl_threshold or horizon < self.hcfg.min_horizon
        self.breaches = self.breaches + 1 if breach else 0
        trigger = self.breaches >= self.hcfg.consecutive_breaches
        rec = {"kl": kl, "horizon": horizon, "breach": breach,
               "breaches": self.breaches, "trigger": trigger}
        self.history.append(rec)
        return trigger, rec
