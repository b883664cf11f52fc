"""Fault tolerance and straggler mitigation policies (port of ``repro.runtime.fault``).

Host Python, the reference's policies as they are: bounded retries
(``FaultPolicy``, ``run_with_retries``) with a jittered exponential
backoff (``backoff_delay``), and the synchronous-with-spares straggler
policy (``StragglerPolicy``): a per-step wall-time EWMA, a step slower than
``ewma * tolerance`` is marked, and ``demote_after`` consecutive marks ask
the cluster layer for a hot spare (``swap_fn``; recorded in ``events``).
The data pipeline's (step, host) keying makes such a swap replay exactly
the same shard.  Failures are injected by the tests through the step
function (``tests/test_torch_train.py``).
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Any, Callable, Optional, Tuple, Type


@dataclasses.dataclass
class FaultPolicy:
    """Bounded-retry policy.  ``backoff_s`` is the exponential base between
    attempts; ``jitter`` spreads each sleep to ``backoff_s * 2**attempt *
    (1 + uniform(0, jitter))`` from a PRNG seeded with ``seed`` — N
    replicas retrying a shared dependency (checkpoint store, pool
    reprogramming) must not thunder-herd back in lockstep, while a fixed
    seed keeps every trace reproducible."""

    max_retries: int = 3
    backoff_s: float = 0.0  # exponential base; 0 for tests
    restore_on_failure: bool = True  # reload last checkpoint before retrying
    jitter: float = 0.0  # uniform backoff spread fraction (0 = deterministic)
    seed: int = 0

    def __post_init__(self):
        if self.jitter < 0:
            raise ValueError(f"jitter must be >= 0, got {self.jitter}")


def backoff_delay(
    policy: FaultPolicy, attempt: int, rng: Optional[random.Random] = None
) -> float:
    """The jittered exponential delay before retry ``attempt`` (0-based
    failure count): ``backoff_s * 2**attempt * (1 + uniform(0, jitter))``.

    One formula for both retry styles: :func:`run_with_retries` sleeps it
    inline, while the fleet router turns it into a not-before timestamp on
    its admission queue (a router must keep serving other replicas while a
    failed request waits out its backoff)."""
    if not policy.backoff_s:
        return 0.0
    spread = 1.0
    if policy.jitter:
        spread += (rng or random.Random(policy.seed)).uniform(0.0, policy.jitter)
    return policy.backoff_s * (2**attempt) * spread


def run_with_retries(
    fn: Callable[[], Any],
    policy: FaultPolicy,
    *,
    on_failure: Optional[Callable[[int, BaseException], None]] = None,
    retry_on: Tuple[Type[BaseException], ...] = (Exception,),
) -> Any:
    """Run ``fn`` with bounded retries; ``on_failure(attempt, err)`` between tries.

    ``KeyboardInterrupt``/``SystemExit`` always propagate immediately — a
    retry boundary must never swallow a shutdown request.  ``retry_on``
    narrows which exceptions are retried: anything outside it re-raises
    unchanged on the first occurrence.  The backoff sleep only runs when
    another attempt follows (never after the final failure) and is
    jittered per ``policy.jitter`` (seeded — deterministic per call), and
    the terminal ``RuntimeError`` chains the last underlying exception.
    """
    last: Optional[BaseException] = None
    rng = random.Random(policy.seed) if policy.jitter else None
    for attempt in range(policy.max_retries + 1):
        try:
            return fn()
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:  # noqa: BLE001 — deliberate retry boundary
            if not isinstance(e, retry_on):
                raise
            last = e
            if attempt == policy.max_retries:
                break  # no backoff after the final attempt
            if on_failure is not None:
                on_failure(attempt, e)
            if policy.backoff_s:
                time.sleep(backoff_delay(policy, attempt, rng))
    raise RuntimeError(f"step failed after {policy.max_retries + 1} attempts") from last


@dataclasses.dataclass
class StragglerPolicy:
    tolerance: float = 2.0  # step slower than ewma * tolerance => straggling
    ewma_alpha: float = 0.1
    demote_after: int = 3  # consecutive marks before requesting a swap
    warmup_steps: int = 5  # ignore compile/first-touch steps

    def __post_init__(self):
        self._ewma: Optional[float] = None
        self._marks = 0
        self._seen = 0
        self.events: list[dict] = []

    def reset_ewma(self) -> None:
        """Forget the wall-time baseline (and any pending marks).

        Called automatically after a swap is requested — the replacement
        host's step time must not be judged against the dead host's EWMA —
        and available to callers after any event that shifts the baseline
        (hot param redeploy, topology change).  The next observed step
        re-seeds the EWMA, exactly like the first post-warmup step.
        """
        self._ewma = None
        self._marks = 0

    def observe(self, step: int, wall_s: float, *, swap_fn: Optional[Callable[[], None]] = None) -> bool:
        """Record a step time; returns True if this step was marked straggling."""
        self._seen += 1
        if self._seen <= self.warmup_steps:
            return False
        if self._ewma is None:
            self._ewma = wall_s
            return False
        straggling = wall_s > self._ewma * self.tolerance
        if straggling:
            self._marks += 1
            self.events.append({"step": step, "wall_s": wall_s, "ewma": self._ewma})
            if self._marks >= self.demote_after:
                self.events.append({"step": step, "action": "request_spare_swap"})
                if swap_fn is not None:
                    swap_fn()
                self.reset_ewma()  # recalibrate against the replacement host
        else:
            self._marks = 0  # marks must be *consecutive* to demote
            self._ewma = (1 - self.ewma_alpha) * self._ewma + self.ewma_alpha * wall_s
        return straggling
