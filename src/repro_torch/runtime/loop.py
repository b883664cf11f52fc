"""Training loop with checkpoint/restart, retries, stragglers, redeploy pricing.

Port of ``repro.runtime.loop``.  ``TrainLoop`` wraps a functional train
step (``launch.steps.make_train_step``) in the reference's control plane:

* resume from the latest checkpoint on construction (crash -> restart is a
  no-op in user code);
* bounded per-step retries with checkpoint restore between attempts
  (``FaultPolicy``);
* the straggler watchdog (``StragglerPolicy``), fed the step's wall time
  after the loss has been synchronized (``.item()``), so ``wall_s`` is the
  step's device time too;
* every ``redeploy_every`` steps, the price of reprogramming the deployed
  crossbars from the previous snapshot to the current weights
  (``core.redeploy.delta_cost``) for the ``redeploy_tensors`` largest
  non-embedding tensors, each through its own persistent ``CrossbarPool``
  on the params' device (B1 prices every pair on CUDA).  Log names are the
  reference's '/'-joined paths (``head/w``, ``segments/0/mlp/wi_gate``).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Optional

import torch

from repro_torch import tree
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.core.planner import CrossbarSpec, PlannerConfig
from repro_torch.core.pool import CrossbarPool
from repro_torch.core.redeploy import delta_cost
from repro_torch.data import SyntheticLMDataset
from repro_torch.runtime.fault import FaultPolicy, StragglerPolicy, run_with_retries


@dataclasses.dataclass(frozen=True)
class TrainLoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3
    log_every: int = 10
    redeploy_every: int = 0  # 0 = off; else price crossbar redeploy every k steps
    redeploy_tensors: int = 2  # how many (largest) tensors to price


class TrainLoop:
    def __init__(
        self,
        cfg: ArchConfig,
        loop_cfg: TrainLoopConfig,
        *,
        train_step: Callable,  # (params, opt_state, batch) -> (params, opt_state, metrics)
        init_state: Callable[[], tuple[Any, Any]],  # () -> (params, opt_state)
        dataset: SyntheticLMDataset,
        fault: Optional[FaultPolicy] = None,
        straggler: Optional[StragglerPolicy] = None,
        crossbar_spec: CrossbarSpec = CrossbarSpec(),
        planner_cfg: PlannerConfig = PlannerConfig(),
        host: int = 0,
        n_hosts: int = 1,
    ):
        self.cfg = cfg
        self.loop_cfg = loop_cfg
        self.train_step = train_step
        self.dataset = dataset
        self.fault = fault if fault is not None else FaultPolicy()
        self.straggler = straggler or StragglerPolicy()
        self.crossbar_spec = crossbar_spec
        self.planner_cfg = planner_cfg
        # one persistent pool per priced tensor: each refresh reprograms the
        # cells the previous one left, and wear accumulates over the run
        self.pools: dict[str, CrossbarPool] = {}
        self.host, self.n_hosts = host, n_hosts
        self.ckpt = CheckpointManager(
            loop_cfg.checkpoint_dir, keep=loop_cfg.keep_checkpoints, async_write=True
        )
        self.metrics_log: list[dict] = []
        self.redeploy_log: list[dict] = []
        self._deployed_snapshot: Optional[dict[str, torch.Tensor]] = None

        # resume-or-init
        params, opt_state = init_state()
        latest = self.ckpt.latest()
        if latest is not None:
            params, opt_state = self.ckpt.restore(latest, (params, opt_state))
            self.start_step = latest
        else:
            self.start_step = 0
        self.params, self.opt_state = params, opt_state

    # -- redeploy pricing ------------------------------------------------------

    def _largest_weights(self) -> dict[str, torch.Tensor]:
        mats = [(tree.path_name(p), leaf) for p, leaf in tree.leaves_with_path(self.params)
                if leaf.ndim >= 2 and "embed" not in tree.path_name(p).lower()]
        mats.sort(key=lambda kv: -math.prod(kv[1].shape))  # stable: ties keep leaf order
        return dict(mats[: self.loop_cfg.redeploy_tensors])

    def _pool_for(self, name: str, device) -> CrossbarPool:
        if name not in self.pools:
            self.pools[name] = CrossbarPool(
                self.crossbar_spec, self.planner_cfg.crossbars,
                leveling=self.planner_cfg.pool_leveling or "none", device=device,
            )
        return self.pools[name]

    def _price_redeploy(self, step: int) -> None:
        current = self._largest_weights()
        if self._deployed_snapshot is not None:
            for name, w_new in current.items():
                w_old = self._deployed_snapshot.get(name)
                if w_old is None or w_old.shape != w_new.shape:
                    continue
                pool = self._pool_for(name, w_new.device)
                rep = delta_cost(w_old, w_new, self.crossbar_spec, self.planner_cfg,
                                 name=name, pool=pool)
                stats = pool.stats()
                self.redeploy_log.append({
                    "step": step,
                    "tensor": name,
                    "transitions_natural": rep.transitions_natural,
                    "transitions_sws": rep.transitions_sws,
                    "chain_stale_sws": rep.chain_stale_sws,
                    "chain_fresh_sws": rep.chain_fresh_sws,
                    "chain_pool": rep.chain_pool,
                    "stale_sort_speedup": rep.stale_sort_speedup,
                    "sws_delta_speedup": rep.sws_delta_speedup,
                    "n_bits": rep.n_bits,
                    "pool_max_cell_writes": stats.max_cell_writes,
                    "pool_total_writes": stats.total_writes,
                })
        # the step functions are functional, so the tensors are never updated
        # in place: the snapshot holds them without a copy
        self._deployed_snapshot = dict(current)

    # -- main loop ---------------------------------------------------------------

    def run(self) -> dict:
        lc = self.loop_cfg
        for step in range(self.start_step, lc.total_steps):
            batch = self.dataset.batch_at(step, self.host, self.n_hosts)

            def attempt():
                return self.train_step(self.params, self.opt_state, batch)

            def on_failure(att: int, err: BaseException) -> None:
                if self.fault.restore_on_failure:
                    latest = self.ckpt.latest()
                    if latest is not None:
                        self.params, self.opt_state = self.ckpt.restore(
                            latest, (self.params, self.opt_state)
                        )

            t0 = time.time()
            self.params, self.opt_state, metrics = run_with_retries(
                attempt, self.fault, on_failure=on_failure
            )
            metrics = {k: float(v) for k, v in metrics.items()}  # synchronizes on the loss
            wall = time.time() - t0
            self.straggler.observe(step, wall)

            if (step + 1) % lc.log_every == 0 or step == lc.total_steps - 1:
                self.metrics_log.append({"step": step + 1, "wall_s": round(wall, 4), **metrics})
            if lc.checkpoint_every and (step + 1) % lc.checkpoint_every == 0:
                self.ckpt.save(step + 1, (self.params, self.opt_state))
            if lc.redeploy_every and (step + 1) % lc.redeploy_every == 0:
                self._price_redeploy(step + 1)

        self.ckpt.save(lc.total_steps, (self.params, self.opt_state))
        self.ckpt.wait()
        return {
            "final_metrics": self.metrics_log[-1] if self.metrics_log else {},
            "metrics_log": self.metrics_log,
            "redeploy_log": self.redeploy_log,
            "straggler_events": self.straggler.events,
            "pool_wear": {name: p.stats().to_dict() for name, p in self.pools.items()},
        }
