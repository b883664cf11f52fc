"""Fault-tolerant serving fleet: a request router over N engine replicas.

Port of ``repro.launch.fleet``; the routing, failover, hedging, admission
and lifecycle rules below are the reference's, counter for counter.

One :class:`Engine` (launch/engine.py) is a single replica: a stalled
dispatch, a dead process, or a worn-out crossbar pool takes every request
on it down.  This module turns the per-replica signals the stack already
produces — queue depth, ``CrossbarPool`` endurance horizon, injected fault
state, ``StragglerPolicy`` step-time EWMA, ``HealthMonitor`` probes — into
fleet-level routing, failover, and graceful degradation:

  * **Placement** — each admitted request lands on the lowest-cost LIVE
    replica: ``w_queue * backlog + w_wear / endurance_horizon + w_fault *
    stuck_cell_fraction + w_straggler * consecutive_slow_marks`` (weights in
    :class:`FleetConfig`).  A wearing-out or fault-ridden replica keeps
    serving, it just attracts less new work — the paper's endurance
    accounting acting as a *routing* signal.
  * **Deadlines & retries** — requests carry ``deadline_s`` (enforced by
    the engines: expired work retires as ``status="timeout"`` with partial
    tokens, never hangs).  Work lost to a replica failure re-enters the
    fleet queue with a jittered exponential not-before timestamp
    (``runtime.fault.backoff_delay`` — the same formula
    ``run_with_retries`` sleeps, turned into queue time so the router keeps
    serving healthy replicas while the retry waits out its backoff).
  * **Failover** — a crashed replica's in-flight requests are salvaged from
    its host-side scheduler state (``Engine.export_state``: prompt +
    emitted tokens + pending token + PRNG key) and resumed on another
    replica as a teacher-forced replay — already-emitted tokens are never
    re-sampled, so the completed stream stays bit-identical to solo
    ``serve.generate``.  A crash that loses host state too
    (``lose_state=True``), or ``failover="restart"``, re-runs the request
    from scratch — generation is deterministic per seed, so the stream is
    *still* identical.  Draining a live replica migrates its work with
    device snapshots (``Engine.evict(snapshot=True)`` →
    ``paged_cache.swap_out`` → byte-identical ``swap_in`` on the adopter).
  * **Hedging** — a replica that stops making progress (wall-clock stall)
    or accumulates ``hedge_after_marks`` consecutive straggler marks gets
    its in-flight requests *duplicated* onto a healthy replica
    (``export_state`` → ``resume``); both copies compute the identical
    stream, the first to finish wins, and the loser is
    ``Engine.cancel``-ed.  Tail latency protection without ever forking
    the token stream.
  * **Admission control** — the fleet queue is bounded (``max_queue``;
    overflow is *shed* with ``status="shed"`` rather than queued forever),
    and above ``degrade_backlog`` the fleet enters degraded mode: new
    requests get their ``max_new_tokens`` clamped to ``degrade_cap`` —
    shorter answers for everyone beats no answers for some.
  * **Lifecycle** — replicas are health-checked (``HealthMonitor.probe``
    shadow-batch KL every ``health_every`` cycles; a failing probe kills
    the replica and fails its work over), drained (:meth:`Fleet.drain`),
    killed (:meth:`Fleet.kill`), and restored (:meth:`Fleet.restore` — a
    fresh engine sharing the fleet's compiled dispatches).

:class:`FaultInjector` drives deterministic chaos traces — crash-on-step-k
(with or without host state), stall-for-s, slow-by-factor, and
corrupt-health-probe — keyed on replica-local step counts so a trace
replays identically.  ``benchmarks/fleet_tolerance.py`` gates the whole
contract: kill-one-of-4 and stall traces must complete 100% of admitted
requests with every completed stream bit-identical to solo generation.

Replicas are data-parallel over ``launch.mesh.replica_submeshes`` (on one
card, or on the CPU, every replica shares the one device).  With
``FleetConfig.shards_per_replica > 1`` each replica is also
tensor-parallel (``Engine(tp=...)``, ``parallel/tp.py``), its shards in
turn on the first device of its group: where a group names several
devices the others stay idle, with a warning (one shard a device is one
process a shard, ``parallel.collective.ProcessGroupGate``).  All replicas
serve one prepared param tree (the first engine prepares it, the others
share it through ``dispatch_from``, with the step functions); each engine
captures its own CUDA graphs, since a graph holds one engine's KV pools by
address.  Placement, failover and hedging never change any request's
tokens, only *where* and *whether* they are computed.

``FleetConfig.retry`` takes a ``default_factory``: the reference's class
default of a mutable ``FaultPolicy`` does not import on Python 3.11+
(ROADMAP C.1).
"""
from __future__ import annotations

import dataclasses
import random
import time
import warnings
from collections import deque
from typing import Any, Optional, Union

import numpy as np

from repro_torch import prng, tree
from repro_torch.configs.base import ArchConfig
from repro_torch.launch import steps
from repro_torch.launch.engine import (
    Engine,
    EngineConfig,
    HealthMonitor,
    Request,
    ResumeState,
)
from repro_torch.launch.mesh import replica_submeshes
from repro_torch.runtime.fault import FaultPolicy, StragglerPolicy, backoff_delay

LIVE, DRAINING, DOWN, DEAD = "live", "draining", "down", "dead"


def _to_device(params: Any, device) -> Any:
    """``params`` on ``device``: the same tree object when every leaf is
    there already (replicas on one device share one prepared copy)."""
    if all(x.device == device for x in tree.leaves(params)):
        return params
    return tree.tree_map(lambda x: x.to(device), params)


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Routing + robustness policy for the fleet.

    ``max_queue`` bounds total fleet backlog (fleet queue + every engine's
    waiting line) — submissions beyond it are shed.  ``degrade_backlog``
    (default: half of ``max_queue``) triggers degraded mode.  ``retry``
    prices the jittered re-placement backoff after a replica failure
    (``backoff_s``/``jitter``/``seed``; ``max_retries`` bounds placements
    per request — a request that loses its replica more often than that is
    shed).  ``hedge_stall_s`` is the no-progress wall-clock bound before a
    replica's in-flight work is hedged; ``hedge_after_marks`` the
    consecutive straggler-mark bound (either triggers).
    """

    n_replicas: int = 2
    # tensor-parallel width of each replica: every replica's engine runs
    # its model sharded this many ways over a contiguous "model"-axis
    # device group (launch.mesh.replica_submeshes).  1 = the plain
    # single-device engine.
    shards_per_replica: int = 1
    max_queue: int = 64
    degrade_backlog: Optional[int] = None
    degrade_cap: int = 8
    default_deadline_s: Optional[float] = None
    retry: FaultPolicy = dataclasses.field(
        default_factory=lambda: FaultPolicy(max_retries=3, backoff_s=0.0, jitter=0.5))
    failover: str = "resume"  # "resume" (recorded prefix) | "restart"
    hedge: bool = True
    hedge_stall_s: float = 0.5
    hedge_after_marks: int = 2
    straggler_tolerance: float = 3.0
    health_every: int = 0  # probe cadence in cycles; 0 = off
    w_queue: float = 1.0
    w_wear: float = 1.0
    w_fault: float = 100.0
    w_straggler: float = 1.0
    # scrub findings feed placement: every known-but-unrepaired fault on a
    # replica's pool (core/integrity.py pending backlog) costs this much, so
    # traffic routes around replicas mid-repair until their scrubber
    # converges (they are also excluded outright while healthy peers exist)
    w_scrub: float = 10.0

    def __post_init__(self):
        if self.n_replicas < 1:
            raise ValueError("need at least one replica")
        if self.shards_per_replica < 1:
            raise ValueError("need at least one shard per replica")
        if self.max_queue < 1:
            raise ValueError("max_queue must be positive")
        if self.failover not in ("resume", "restart"):
            raise ValueError(
                f"unknown failover mode {self.failover!r}; "
                f"choose 'resume' or 'restart'"
            )
        if self.hedge_stall_s <= 0 or self.hedge_after_marks < 1:
            raise ValueError("hedge_stall_s must be > 0, hedge_after_marks >= 1")

    @property
    def degrade_at(self) -> int:
        return self.degrade_backlog if self.degrade_backlog is not None else (
            self.max_queue // 2
        )


@dataclasses.dataclass
class ChaosEvent:
    """One deterministic chaos action, fired when ``replica`` reaches its
    ``at_step``-th scheduler cycle (replica-local count — traces replay
    identically regardless of wall clock)."""

    replica: int
    at_step: int
    kind: str  # "crash" | "stall" | "slow" | "corrupt_probe" | "storm"
    duration_s: float = 0.0  # stall: wall-clock seconds of no progress
    factor: float = 1.0  # slow: reported step-wall multiplier
    steps: int = 1  # slow: cycles affected; corrupt_probe: probes affected
    lose_state: bool = False  # crash: host scheduler state unrecoverable too
    corrupt: float = 0.0  # storm: stored-bit corruption rate
    stuck: float = 0.0  # storm: new hard stuck-at cell rate
    fired: bool = False


class FaultInjector:
    """Deterministic chaos plans for :class:`Fleet` traces.

    Events are armed per replica at a replica-local step count; the fleet
    consults :meth:`fire` before stepping each replica and applies whatever
    comes back.  ``log`` records every fired event (with the fleet clock)
    for the benchmark report.
    """

    def __init__(self):
        self.events: list[ChaosEvent] = []
        self.log: list[dict] = []

    def crash(self, replica: int, at_step: int, *, lose_state: bool = False) -> None:
        """Hard-kill ``replica`` at its ``at_step``-th cycle.  With
        ``lose_state`` even the host scheduler records are gone — failover
        must restart the lost requests from scratch."""
        self.events.append(ChaosEvent(replica, at_step, "crash", lose_state=lose_state))

    def stall(self, replica: int, at_step: int, duration_s: float) -> None:
        """Freeze ``replica`` for ``duration_s`` wall-clock seconds — its
        dispatches hang (no progress) but nothing is lost; the hedging path
        must cover its in-flight requests in the meantime."""
        self.events.append(ChaosEvent(replica, at_step, "stall", duration_s=duration_s))

    def slow(self, replica: int, at_step: int, factor: float, steps: int = 4) -> None:
        """Inflate ``replica``'s *reported* step wall by ``factor`` for
        ``steps`` cycles — the straggler-EWMA detection path, without
        actually sleeping the benchmark."""
        self.events.append(ChaosEvent(replica, at_step, "slow", factor=factor, steps=steps))

    def corrupt_probe(self, replica: int, at_step: int, probes: int = 1) -> None:
        """Make ``replica``'s next ``probes`` health probes return garbage
        (infinite KL) — the fleet kills a perfectly healthy replica and its
        failover path must still preserve every stream."""
        self.events.append(ChaosEvent(replica, at_step, "corrupt_probe", steps=probes))

    def storm(self, replica: int, at_step: int, *, corrupt: float = 1e-3,
              stuck: float = 1e-4) -> None:
        """Unleash a mid-trace fault storm on ``replica``'s crossbar pool:
        stored bits flip at ``corrupt`` and new hard stuck-at cells appear
        at ``stuck`` (``core.integrity.IntegrityManager.storm``).  Requires
        the replica's pool to have integrity enabled; the scrub/repair loop
        — not failover — is what must recover the replica."""
        self.events.append(
            ChaosEvent(replica, at_step, "storm", corrupt=corrupt, stuck=stuck)
        )

    def fire(self, replica: int, step: int, now: float) -> list[ChaosEvent]:
        """Pop (mark fired + log) every armed event for ``replica`` whose
        ``at_step`` has been reached."""
        out = []
        for ev in self.events:
            if ev.fired or ev.replica != replica or step < ev.at_step:
                continue
            ev.fired = True
            self.log.append({"t": now, "replica": replica, "step": step,
                             "kind": ev.kind})
            out.append(ev)
        return out


class Replica:
    """One engine replica plus the host-side signals the router scores."""

    def __init__(self, rid: int, cfg: ArchConfig, params: Any, ecfg: EngineConfig,
                 *, devices=None, pool=None, fcfg: FleetConfig,
                 dispatch_from: Optional[Engine] = None):
        self.id = rid
        # the replica's contiguous "model"-axis device group; its engine and
        # every shard of it run on devices[0] (Fleet warns when the group
        # names more than one device)
        self.devices = list(devices) if devices else None
        self.device = self.devices[0] if self.devices else None
        self.pool = pool  # Optional[CrossbarPool]: wear + fault signals
        self.state = LIVE
        if self.device is not None:
            params = _to_device(params, self.device)
        tp = fcfg.shards_per_replica
        self.engine = Engine(cfg, params, ecfg, dispatch_from=dispatch_from,
                             tp=tp)
        self.straggler = StragglerPolicy(
            tolerance=fcfg.straggler_tolerance, warmup_steps=2,
            demote_after=max(fcfg.hedge_after_marks, 1),
        )
        self.steps = 0  # scheduler cycles this incarnation has run
        self.marks = 0  # consecutive straggler marks (hedge trigger)
        self.stall_until = 0.0  # injected stall: frozen while now < this
        self.slow_factor = 1.0
        self.slow_left = 0
        self.probe_corrupt_left = 0
        self.probe_breaches = 0  # consecutive failed health probes
        self.last_progress = 0.0  # fleet clock of the last completed step
        self.reported: set[int] = set()  # rids whose engine result was collected

    @property
    def alive(self) -> bool:
        return self.state in (LIVE, DRAINING)

    def stalled(self, now: float) -> bool:
        return now < self.stall_until

    def backlog(self) -> int:
        """Requests this replica still owes: occupied slots + waiting line."""
        eng = self.engine
        return sum(s is not None for s in eng.slots) + len(eng.waiting)

    def inflight_rids(self) -> list[int]:
        """Every rid currently on this replica (slots first, then queue)."""
        eng = self.engine
        out = [s.req.rid for s in eng.slots if s is not None]
        out += [
            (w.req if isinstance(w, ResumeState) else w).rid for w in eng.waiting
        ]
        return out

    def mid_repair(self) -> bool:
        """The replica's scrubber has found faults it hasn't repaired yet."""
        return (
            self.pool is not None
            and self.pool.integrity is not None
            and self.pool.integrity.pending_faults() > 0
        )

    def score(self, fcfg: FleetConfig) -> float:
        """Placement cost — smaller attracts more work."""
        cost = fcfg.w_queue * self.backlog() + fcfg.w_straggler * self.marks
        if self.pool is not None:
            horizon = self.pool.stats().exhaustion_horizon()
            if np.isfinite(horizon):
                cost += fcfg.w_wear / max(horizon, 1e-9)
            if self.pool.faults is not None:
                frac = float(self.pool.faults.fault_cells().sum()) / max(
                    self.pool.wear.size, 1
                )
                cost += fcfg.w_fault * frac
            if self.pool.integrity is not None:
                # scrub findings: every pending (detected, unrepaired) fault
                # makes this replica less attractive until repair converges
                cost += fcfg.w_scrub * self.pool.integrity.pending_faults()
        return cost


@dataclasses.dataclass
class FleetResult:
    """Fleet-level outcome of one request.  ``status``: ``"ok"`` /
    ``"timeout"`` (deadline) / ``"shed"`` (admission refused — never
    placed).  ``replica`` is the replica whose stream was adopted (None for
    shed), ``attempts`` the number of placements (>1 = retried or hedged),
    ``hedged`` whether a duplicate dispatch ever ran."""

    rid: int
    tokens: list[int]
    status: str
    replica: Optional[int]
    attempts: int
    t_arrival: float
    t_done: float
    hedged: bool = False

    @property
    def latency(self) -> float:
        return self.t_done - self.t_arrival


@dataclasses.dataclass
class _Pending:
    """A fleet-queue entry: a fresh request or a salvaged resume record,
    not placeable before ``not_before`` (retry backoff)."""

    item: Union[Request, ResumeState]
    attempts: int = 0
    not_before: float = 0.0

    @property
    def req(self) -> Request:
        return self.item.req if isinstance(self.item, ResumeState) else self.item


class Fleet:
    """Request router over ``FleetConfig.n_replicas`` engine replicas.

    ``params`` is one serving tree shared by every replica (moved to a
    replica's device where it differs); ``pools`` optionally attaches each
    replica's ``CrossbarPool`` (wear/fault placement signals);
    ``monitor`` + ``FleetConfig.health_every`` enable shadow-batch health
    probes; ``injector`` arms deterministic chaos.  Drive it with
    :meth:`run` (self-clocked trace, like ``Engine.run``) or externally
    with :meth:`submit` + :meth:`step`.
    """

    def __init__(self, cfg: ArchConfig, params: Any,
                 fcfg: FleetConfig = FleetConfig(),
                 ecfg: EngineConfig = EngineConfig(), *,
                 pools: Optional[list] = None,
                 devices: Optional[list] = None,
                 monitor: Optional[HealthMonitor] = None,
                 injector: Optional[FaultInjector] = None):
        self.cfg = cfg
        self.fcfg = fcfg
        self.ecfg = ecfg
        self.params = params
        self.monitor = monitor
        self.injector = injector
        if pools is not None and len(pools) != fcfg.n_replicas:
            raise ValueError("pools must have one entry per replica")
        if devices is None:
            dev = steps._params_device(params)
            groups = replica_submeshes(fcfg.n_replicas, fcfg.shards_per_replica,
                                       device=None if dev is None or dev.type == "cuda" else dev)
        else:
            # accept a flat device list (one device per replica, the PR 8
            # signature) or an explicit list of per-replica device groups
            groups = [d if isinstance(d, (list, tuple)) else [d] for d in devices]
        if any(len(set(g)) > 1 for g in groups):
            warnings.warn(
                f"shards_per_replica={fcfg.shards_per_replica}: each replica runs its "
                "shards in turn on the first device of its group; the port places no "
                "shard on a device of its own (one shard a process is "
                "parallel.collective.ProcessGroupGate)",
                stacklevel=2,
            )
        self.replicas: list[Replica] = []
        template: Optional[Engine] = None
        for i in range(fcfg.n_replicas):
            r = Replica(
                i, cfg, params, ecfg, devices=groups[i % len(groups)],
                pool=pools[i] if pools else None, fcfg=fcfg,
                dispatch_from=template,
            )
            template = template or r.engine
            self.replicas.append(r)
        # the compiled-dispatch donor outlives any replica that crashes —
        # restore() clones from it even if replica 0 is long dead
        self._dispatch_template = template
        self._rng = random.Random(fcfg.retry.seed)
        self.queue: deque[_Pending] = deque()
        self.results: dict[int, FleetResult] = {}
        self.requests: dict[int, Request] = {}  # originals, for clean restarts
        self.placements: dict[int, set[int]] = {}  # rid -> replica ids serving it
        self.attempts: dict[int, int] = {}
        self.hedged: set[int] = set()
        self.cycle = 0
        self._now = 0.0
        self.stats = {
            "submitted": 0, "admitted": 0, "shed": 0, "degraded": 0,
            "placements": 0, "retries": 0, "failovers": 0, "restarts": 0,
            "hedges": 0, "cancels": 0, "completed": 0, "timeouts": 0,
            "crashes": 0, "stalls": 0, "slows": 0, "kills": 0, "drains": 0,
            "restores": 0, "probes": 0, "probe_failures": 0, "storms": 0,
        }

    # -- admission -----------------------------------------------------------

    def backlog(self) -> int:
        """Total unserved demand: fleet queue + every live replica's line."""
        return len(self.queue) + sum(
            r.backlog() for r in self.replicas if r.alive
        )

    def submit(self, req: Request, now: Optional[float] = None) -> bool:
        """Admit (or shed) one request.  Applies the default deadline,
        degraded-mode clamping, and the bounded-queue shed policy; returns
        False (with a ``"shed"`` result recorded) when admission is
        refused.  Oversized requests raise, as ``Engine.submit`` would."""
        now = self._now if now is None else now
        self.stats["submitted"] += 1
        changed = {}
        if req.deadline_s is None and self.fcfg.default_deadline_s is not None:
            changed["deadline_s"] = self.fcfg.default_deadline_s
        backlog = self.backlog()
        if backlog >= self.fcfg.max_queue:
            self.stats["shed"] += 1
            self.results[req.rid] = FleetResult(
                rid=req.rid, tokens=[], status="shed", replica=None,
                attempts=0, t_arrival=req.arrival_time, t_done=now,
            )
            return False
        if backlog >= self.fcfg.degrade_at and (
            req.max_new_tokens > self.fcfg.degrade_cap
        ):
            # degraded mode: shorter answers for everyone beats shedding
            changed["max_new_tokens"] = self.fcfg.degrade_cap
            self.stats["degraded"] += 1
        if changed:
            req = dataclasses.replace(req, **changed)
        if req.prompt.size + req.max_new_tokens > self.ecfg.max_seq_len:
            raise ValueError(
                f"request {req.rid}: prompt+max_new exceeds engine max_seq_len"
            )
        self.stats["admitted"] += 1
        self.requests[req.rid] = req
        self.attempts[req.rid] = 0
        self.queue.append(_Pending(req))
        return True

    # -- placement -----------------------------------------------------------

    def _best_replica(self, now: float, exclude: set[int] = frozenset()) -> Optional[Replica]:
        cands = [
            r for r in self.replicas
            if r.state == LIVE and not r.stalled(now) and r.id not in exclude
        ]
        if not cands:
            return None
        # route around replicas mid-repair (scrubber has pending faults) as
        # long as a healthy candidate exists; fall back rather than wedge
        healthy = [r for r in cands if not r.mid_repair()]
        return min(healthy or cands, key=lambda r: (r.score(self.fcfg), r.id))

    def _place(self, now: float) -> None:
        """Drain the fleet queue onto the cheapest live replicas, honouring
        arrival times and retry not-before stamps.  Requests the engines
        enforce deadlines on from here; queue-stuck requests expire in
        :meth:`_expire_queue`."""
        remaining: deque[_Pending] = deque()
        for p in self.queue:
            if p.req.arrival_time > now or p.not_before > now:
                remaining.append(p)
                continue
            r = self._best_replica(now)
            if r is None:
                remaining.append(p)
                continue
            if isinstance(p.item, ResumeState):
                r.engine.resume(p.item)
            else:
                r.engine.submit(p.item)
            rid = p.req.rid
            self.placements.setdefault(rid, set()).add(r.id)
            self.attempts[rid] = self.attempts.get(rid, 0) + 1
            self.stats["placements"] += 1
            if p.attempts:
                self.stats["retries"] += 1
        self.queue = remaining

    def _expire_queue(self, now: float) -> None:
        """Deadline-expire requests still stuck in the *fleet* queue (the
        engines handle everything placed on them)."""
        keep: deque[_Pending] = deque()
        for p in self.queue:
            req = p.req
            if req.deadline_s is not None and now >= req.arrival_time + req.deadline_s:
                gen = list(p.item.generated) if isinstance(p.item, ResumeState) else []
                self.results[req.rid] = FleetResult(
                    rid=req.rid, tokens=gen, status="timeout", replica=None,
                    attempts=self.attempts.get(req.rid, 0),
                    t_arrival=req.arrival_time, t_done=now,
                    hedged=req.rid in self.hedged,
                )
                self.stats["timeouts"] += 1
            else:
                keep.append(p)
        self.queue = keep

    # -- failure handling ----------------------------------------------------

    def _requeue(self, item: Union[Request, ResumeState], attempts: int,
                 now: float) -> None:
        """Put salvaged (or restarted) work back in the fleet queue behind a
        jittered backoff stamp; shed it once its retry budget is spent."""
        req = item.req if isinstance(item, ResumeState) else item
        if attempts > self.fcfg.retry.max_retries:
            self.stats["shed"] += 1
            self.results[req.rid] = FleetResult(
                rid=req.rid, tokens=[], status="shed", replica=None,
                attempts=attempts, t_arrival=req.arrival_time, t_done=now,
            )
            self.placements.pop(req.rid, None)
            return
        delay = backoff_delay(self.fcfg.retry, max(attempts - 1, 0), self._rng)
        self.queue.append(_Pending(item, attempts=attempts, not_before=now + delay))

    def _fail_replica(self, r: Replica, now: float, *, lose_state: bool,
                      reason: str) -> None:
        """Mark ``r`` dead and fail its work over.  With host state intact
        and ``failover="resume"``, each request resumes teacher-forced from
        its recorded prefix; otherwise it restarts from the original
        request.  Device snapshots are never used here — a dead replica's
        device memory is gone by definition."""
        r.state = DEAD
        self.stats["crashes" if reason == "crash" else "kills"] += 1
        salvage = not lose_state and self.fcfg.failover == "resume"
        for rid in r.inflight_rids():
            if rid in self.results:
                continue
            twins = self.placements.get(rid, set()) - {r.id}
            if any(self.replicas[t].alive for t in twins):
                self.placements[rid].discard(r.id)
                continue  # a hedged twin is still computing the stream
            attempts = self.attempts.get(rid, 1)
            rec = r.engine.export_state(rid) if salvage else None
            if rec is not None and rec.generated:
                self.stats["failovers"] += 1
                self._requeue(rec, attempts, now)
            else:
                # nothing emitted yet (or state lost): clean restart — the
                # stream is deterministic per seed, so it stays identical
                self.stats["restarts"] += 1
                self._requeue(self.requests[rid], attempts, now)
            self.placements.pop(rid, None)

    # -- hedging -------------------------------------------------------------

    def _maybe_hedge(self, r: Replica, now: float) -> None:
        """Duplicate a struggling replica's in-flight requests onto healthy
        replicas (first finisher wins)."""
        if not self.fcfg.hedge or not r.alive:
            return
        struggling = r.stalled(now) or (
            r.marks >= self.fcfg.hedge_after_marks
        ) or (
            r.backlog() > 0
            and now - r.last_progress > self.fcfg.hedge_stall_s
        )
        if not struggling:
            return
        for rid in r.inflight_rids():
            if rid in self.results or len(self.placements.get(rid, set())) > 1:
                continue
            target = self._best_replica(now, exclude={r.id})
            if target is None:
                return  # nowhere to hedge to; keep waiting
            rec = r.engine.export_state(rid)
            if rec is None:
                continue
            target.engine.resume(rec)
            self.placements.setdefault(rid, set()).add(target.id)
            self.attempts[rid] = self.attempts.get(rid, 0) + 1
            self.hedged.add(rid)
            self.stats["hedges"] += 1

    # -- result collection ---------------------------------------------------

    def _collect(self, r: Replica, now: float) -> None:
        """Adopt newly finished streams from ``r``; cancel losing twins."""
        for rid, res in list(r.engine.results.items()):
            if rid in r.reported:
                continue
            r.reported.add(rid)
            if res.status == "cancelled":
                continue  # our own cancel of a losing hedge copy
            if rid in self.results:
                continue  # a twin already won
            self.results[rid] = FleetResult(
                rid=rid, tokens=list(res.tokens), status=res.status,
                replica=r.id, attempts=self.attempts.get(rid, 1),
                t_arrival=res.t_arrival, t_done=now,
                hedged=rid in self.hedged,
            )
            self.stats["completed" if res.status == "ok" else "timeouts"] += 1
            for twin in self.placements.pop(rid, set()) - {r.id}:
                rep = self.replicas[twin]
                if rep.alive and rep.engine.cancel(rid, now=now):
                    self.stats["cancels"] += 1

    # -- health --------------------------------------------------------------

    def _check_health(self, now: float) -> None:
        if self.monitor is None or self.fcfg.health_every < 1:
            return
        if self.cycle % self.fcfg.health_every:
            return
        for r in self.replicas:
            if r.state != LIVE:
                continue
            self.stats["probes"] += 1
            if r.probe_corrupt_left > 0:
                r.probe_corrupt_left -= 1
                kl = float("inf")  # injected: the probe path itself lies
            else:
                kl = self.monitor.probe(r.engine.params)
            if kl > self.monitor.hcfg.kl_threshold:
                self.stats["probe_failures"] += 1
                # a kill is expensive and one shadow batch is one noisy
                # sample: require the monitor's configured run of
                # consecutive breaches before failing the replica
                r.probe_breaches += 1
                if r.probe_breaches >= self.monitor.hcfg.consecutive_breaches:
                    self._fail_replica(r, now, lose_state=False, reason="kill")
            else:
                r.probe_breaches = 0

    # -- lifecycle -----------------------------------------------------------

    def drain(self, replica: int, now: Optional[float] = None) -> None:
        """Gracefully take ``replica`` out of rotation: no new placements;
        its queued work migrates immediately (device snapshots — restored
        byte-identical on the adopters) and its occupied slots finish where
        they are.  Once empty it parks as ``"down"``."""
        now = self._now if now is None else now
        r = self.replicas[replica]
        if r.state != LIVE:
            return
        r.state = DRAINING
        self.stats["drains"] += 1
        # migrate the waiting line right away; slots drain by finishing
        for w in list(r.engine.waiting):
            rid = (w.req if isinstance(w, ResumeState) else w).rid
            rec = r.engine.evict(rid, snapshot=True)
            target = self._best_replica(now)
            self.placements.get(rid, set()).discard(r.id)
            if rec is None:
                continue
            if target is None:
                self._requeue(rec, self.attempts.get(rid, 1), now)
            else:
                target.engine.resume(rec)
                self.placements.setdefault(rid, set()).add(target.id)
                self.stats["placements"] += 1

    def kill(self, replica: int, now: Optional[float] = None, *,
             lose_state: bool = False) -> None:
        """Hard-stop ``replica`` and fail its work over (operator-initiated
        version of an injected crash)."""
        now = self._now if now is None else now
        r = self.replicas[replica]
        if r.state == DEAD:
            return
        self._fail_replica(r, now, lose_state=lose_state, reason="kill")

    def restore(self, replica: int, now: Optional[float] = None) -> None:
        """Bring a dead/down replica back with a fresh engine (compiled
        dispatches shared from the fleet template — no recompilation) and a
        reset straggler baseline."""
        now = self._now if now is None else now
        r = self.replicas[replica]
        if r.state == LIVE:
            return
        if r.state == DRAINING:
            # un-drain: the engine (and its in-flight work) is intact
            r.state = LIVE
            self.stats["restores"] += 1
            return
        params = self.params
        if r.device is not None:
            params = _to_device(params, r.device)
        tp = self.fcfg.shards_per_replica
        r.engine = Engine(self.cfg, params, self.ecfg,
                          dispatch_from=self._dispatch_template,
                          tp=tp)
        r.state = LIVE
        r.steps = 0
        r.marks = 0
        r.stall_until = 0.0
        r.slow_factor, r.slow_left = 1.0, 0
        r.probe_breaches = 0
        r.last_progress = now
        r.reported = set()
        r.straggler.reset_ewma()
        self.stats["restores"] += 1

    # -- scheduling ----------------------------------------------------------

    def _apply_chaos(self, r: Replica, now: float) -> None:
        if self.injector is None:
            return
        for ev in self.injector.fire(r.id, r.steps, now):
            if ev.kind == "crash":
                self._fail_replica(r, now, lose_state=ev.lose_state, reason="crash")
            elif ev.kind == "stall":
                r.stall_until = max(r.stall_until, now + ev.duration_s)
                self.stats["stalls"] += 1
            elif ev.kind == "slow":
                r.slow_factor, r.slow_left = ev.factor, ev.steps
                self.stats["slows"] += 1
            elif ev.kind == "corrupt_probe":
                r.probe_corrupt_left += ev.steps
            elif ev.kind == "storm":
                if r.pool is not None and r.pool.integrity is not None:
                    # deterministic per (replica, step): traces replay exactly
                    r.pool.integrity.storm(
                        prng.PRNGKey(1_000_003 * r.id + ev.at_step),
                        corrupt_rate=ev.corrupt, stuck_rate=ev.stuck,
                    )
                    self.stats["storms"] += 1

    def step(self, now: float) -> bool:
        """One fleet cycle: chaos → queue expiry → placement → per-replica
        engine cycles (with straggler observation) → hedging → result
        collection → health probes.  Returns True if any engine dispatched.
        """
        self._now = now
        self.cycle += 1
        for r in self.replicas:
            if r.alive:
                self._apply_chaos(r, now)
        self._expire_queue(now)
        self._place(now)
        did = False
        for r in self.replicas:
            if not r.alive:
                continue
            if r.stalled(now):
                self._maybe_hedge(r, now)
                continue
            r.steps += 1
            t0 = time.perf_counter()
            try:
                stepped = r.engine.step(now)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception:
                # a real dispatch failure is a crash with host state intact
                self._fail_replica(r, now, lose_state=False, reason="crash")
                continue
            wall = (time.perf_counter() - t0) * r.slow_factor
            if r.slow_left > 0:
                r.slow_left -= 1
                if r.slow_left == 0:
                    r.slow_factor = 1.0
            straggling = r.straggler.observe(r.steps, wall)
            r.marks = r.marks + 1 if straggling else 0
            did = did or stepped
            if stepped or r.backlog() == 0:
                # an idle replica isn't "stalled" — only a replica that owes
                # work and isn't producing it trips the no-progress hedge
                r.last_progress = now
            self._maybe_hedge(r, now)
            self._collect(r, now)
            if r.state == DRAINING and r.backlog() == 0:
                r.state = DOWN
        self._check_health(now)
        return did

    def run(self, requests: list[Request]) -> list[FleetResult]:
        """Serve a trace to completion (wall-clock arrival times), like
        ``Engine.run`` but with arrivals submitted when they *happen* — the
        bounded queue and degraded mode react to real backlog.  Raises if
        every replica dies with work outstanding."""
        arrivals = deque(sorted(requests, key=lambda r: (r.arrival_time, r.rid)))
        t0 = time.perf_counter()
        while True:
            now = time.perf_counter() - t0
            while arrivals and arrivals[0].arrival_time <= now:
                self.submit(arrivals.popleft(), now)
            if not arrivals and all(r.rid in self.results for r in requests):
                break
            outstanding = self.queue or any(
                r.alive and r.backlog() for r in self.replicas
            )
            if outstanding and not any(
                r.state == LIVE for r in self.replicas
            ):
                raise RuntimeError(
                    "fleet lost every replica with requests outstanding"
                )
            if not self.step(now):
                # nothing dispatched: park briefly (next arrival, retry
                # not-before, or stall expiry) instead of spinning hot
                nxt = arrivals[0].arrival_time - now if arrivals else 0.001
                time.sleep(min(max(nxt, 0.0005), 0.05))
        return [self.results[r.rid] for r in requests]
