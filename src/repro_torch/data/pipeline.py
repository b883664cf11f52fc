"""Deterministic, shardable synthetic token pipeline (port of ``repro.data.pipeline``).

Each host materializes only its shard of the global batch, keyed purely by
``(seed, step, host_index)``: the key is ``fold_in(fold_in(PRNGKey(seed),
step), host)`` and every draw is ``repro_torch.prng``'s, which draws what
``jax.random`` draws, so a batch is the reference's token for token and a
restarted host replays exactly the tokens it would have seen.

Two task families:

* ``lm``   — Zipf-distributed token stream with a planted Markov structure
  (the transition table from ``numpy.random.default_rng(seed)``, as in the
  reference), so a trained LM has signal to learn;
* ``copy`` — the deterministic rule t_{i+1} = (5 t_i + 7) mod V from a random
  first token, the fastest "does the training loop learn" probe.

Batches are int32 tensors on CUDA unless the dataset is built with
``device="cpu"``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import prng
from repro_torch.kernels._util import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    task: str = "lm"  # "lm" | "copy"
    seed: int = 0
    zipf_a: float = 1.2
    markov_order: int = 1
    n_states: int = 64  # planted structure size


class SyntheticLMDataset:
    """Stateless batch generator: ``batch_at(step, host, n_hosts)``."""

    def __init__(self, cfg: DataConfig, *, device=None):
        if cfg.global_batch < 1:
            raise ValueError("global_batch must be >= 1")
        self.cfg = cfg
        self.device = resolve_device(device)
        # planted Markov transition table (host-independent, from the seed only)
        rng = np.random.default_rng(cfg.seed)
        self._trans = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, size=(cfg.n_states, 8), dtype=np.int64)
        ).to(self.device)

    def host_batch(self, n_hosts: int) -> int:
        if self.cfg.global_batch % n_hosts != 0:
            raise ValueError(
                f"global_batch {self.cfg.global_batch} not divisible by {n_hosts} hosts"
            )
        return self.cfg.global_batch // n_hosts

    def _fold(self, step: int, host: int) -> torch.Tensor:
        key = prng.PRNGKey(self.cfg.seed, device=self.device)
        return prng.fold_in(prng.fold_in(key, step), host)

    def batch_at(self, step: int, host: int = 0, n_hosts: int = 1) -> dict[str, torch.Tensor]:
        """This host's shard of the global batch for ``step``: {"tokens": int32 (b, S)}."""
        cfg = self.cfg
        b = self.host_batch(n_hosts)
        key = self._fold(step, host)
        v = cfg.vocab_size
        if cfg.task == "copy":
            first = prng.randint(prng.split(key)[0], (b,), 0, v)
            cols = [first]
            for _ in range(cfg.seq_len - 1):
                cols.append((5 * cols[-1] + 7) % v)  # int32, as the reference's scan
            return {"tokens": torch.stack(cols, dim=1)}
        if cfg.task != "lm":
            raise ValueError(f"unknown task {cfg.task!r}")
        k1, k2, k3 = prng.split(key, 3)
        shape = (b, cfg.seq_len)
        # Zipf backbone via inverse-CDF on uniform samples: u ** (-1 / (a - 1))
        # correctly rounded to float32 (as XLA:CPU's pow), then truncated
        u = prng.uniform(k1, shape, 1e-6, 1.0)
        expo = torch.tensor(-1.0 / (cfg.zipf_a - 1.0), dtype=torch.float32)
        powed = torch.pow(u.to(torch.float64), expo.to(torch.float64)).to(torch.float32)
        ranks = torch.clamp(_f32_to_i32(powed) - 1, 0, v - 1)
        # planted Markov structure: with prob 0.5 the next token comes from the
        # transition band of the current token's state
        state = ranks % cfg.n_states
        band_pick = prng.randint(k2, shape, 0, self._trans.shape[1])
        markov_next = self._trans[state.long(), band_pick.long()].to(torch.int32)
        use_markov = prng.bernoulli(k3, 0.5, shape)
        shifted = torch.cat([markov_next[:, -1:], markov_next[:, :-1]], dim=1)
        tokens = torch.where(use_markov, shifted, ranks)
        return {"tokens": tokens % v}

    def batches(self, n_steps: int, host: int = 0, n_hosts: int = 1):
        for step in range(n_steps):
            yield self.batch_at(step, host, n_hosts)


def _f32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 as XLA converts: truncation, saturating at the int32
    range (inf and values past 2**31 become INT32_MAX)."""
    lim = torch.tensor(2.0**31, dtype=torch.float32, device=x.device)
    big = x >= lim
    out = torch.where(big, torch.zeros_like(x), x).to(torch.int32)
    return torch.where(big, torch.full_like(out, 2**31 - 1), out)


def make_dataset(cfg: DataConfig, *, device=None) -> SyntheticLMDataset:
    return SyntheticLMDataset(cfg, device=device)
