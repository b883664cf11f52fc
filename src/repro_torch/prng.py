"""Key-based threefry2x32 generator, bit-identical with ``jax.random``.

The planner's stuck-bit masks are ``jax.random.bernoulli`` draws under keys
split from ``PRNGKey(seed)`` (``core/planner.py`` per tensor,
``core/stucking.py`` per chain and per step).  A plan can only match the
reference bit for bit if the port draws the same bits, so this module is
the counterpart of the calls the planner makes, under jax's default
``threefry2x32`` with ``jax_threefry_partitionable=True``:

* ``PRNGKey(seed)`` -> ``[seed >> 32, seed & 0xFFFFFFFF]``;
* ``split(key, n)`` -> key ``i`` is ``threefry(key, (0, i))``;
* ``random_bits(key, shape)`` -> ``y0 ^ y1`` of ``threefry(key, (hi, lo))`` of
  each element's flat index;
* ``uniform`` puts the top 23 bits in the mantissa of ``[1, 2)`` and
  subtracts 1; ``bernoulli(key, p)`` is ``uniform < p`` in float32.

A key is an int64 tensor ``[..., 2]`` holding two uint32 words: torch has no
full uint32 arithmetic, so every sum is taken in int64 and masked with
``0xFFFFFFFF``.  Every function takes a batch of keys (leading dims) and
broadcasts it against the drawn shape, so a whole schedule's per-step masks
come from one call.  The generator is explicit: no global state.
"""
from __future__ import annotations

import math

import torch

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def PRNGKey(seed: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """Raw key of an integer seed (the 64-bit seed cast to two uint32 words)."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([seed >> 32, seed & _M], dtype=torch.int64, device=device)


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) & _M) | (v >> (32 - r))


def threefry2x32(
    k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash (20 rounds), elementwise on broadcast int64 words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M
    x1 = (x1 + ks[1]) & _M
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M
    return x0, x1


def _hash_iota(key: torch.Tensor, shape: tuple[int, ...]) -> tuple[torch.Tensor, torch.Tensor]:
    """threefry(key, flat index as (hi, lo)) for every element of ``shape``;
    keys ``[..., 2]`` broadcast over it -> two ``[..., *shape]`` word tensors."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    lead = key.shape[:-1]
    expand = lead + (1,) * len(shape)
    k0 = key[..., 0].reshape(expand)
    k1 = key[..., 1].reshape(expand)
    return threefry2x32(k0, k1, idx >> 32, idx & _M)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: keys ``[..., 2]`` -> ``[..., num, 2]``."""
    y0, y1 = _hash_iota(key, (num,))
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """32 random bits per element (uint32 values in int64): ``[..., *shape]``."""
    y0, y1 = _hash_iota(key, tuple(shape))
    return y0 ^ y1


def uniform(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """float32 uniform on [0, 1), same bits as ``jax.random.uniform``."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def bernoulli(key: torch.Tensor, p: float, shape: tuple[int, ...]) -> torch.Tensor:
    """bool ``[..., *shape]``: ``uniform < p`` with ``p`` cast to float32."""
    return uniform(key, shape) < torch.tensor(p, dtype=torch.float32, device=key.device)
