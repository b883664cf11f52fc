"""Architecture config schema and registry (the port's own copy).

Only the fields the ported decoder path reads are kept: the attention +
gated-MLP (SwiGLU or GeGLU) decoder stack of ``block_pattern=(("attn", 1),)``
families, and the tensor-parallel flags of ``parallel/tp.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    act: str = "swiglu"  # swiglu | geglu
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    embed_scale: bool = False  # multiply embeddings by sqrt(d_model) (gemma)
    dtype: str = "bfloat16"
    # sequence of (block_kind, repeat), expanded cyclically to n_layers
    block_pattern: tuple[tuple[str, int], ...] = (("attn", 1),)
    # --- tensor parallelism (parallel/tp.py) ---
    # When tp_axis is set, model code runs the shards of a tensor-parallel
    # group: tp_attn means q/k/v are column-parallel and wo row-parallel
    # (reduced over the shards after wo), tp_mlp means wi_gate/wi_up
    # column-parallel and mlp wo row-parallel (reduced after the MLP).  The
    # *local* head/ff counts are already divided down in this config (see
    # tp.local_config); the flags gate where the cross-shard reductions are
    # (models/blocks.py), and the sharded sublayers' leaves carry a shard
    # axis after the layer axis.
    tp_axis: Optional[str] = None
    tp_attn: bool = False
    tp_mlp: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    def layer_kinds(self) -> list[str]:
        """Expand block_pattern cyclically to exactly n_layers kinds."""
        kinds: list[str] = []
        while len(kinds) < self.n_layers:
            for kind, rep in self.block_pattern:
                kinds.extend([kind] * rep)
                if len(kinds) >= self.n_layers:
                    break
        return kinds[: self.n_layers]


_REGISTRY: dict[str, ArchConfig] = {}
_REDUCED: dict[str, Callable[[], ArchConfig]] = {}


def register(cfg: ArchConfig, reduced: Callable[[], ArchConfig]) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    _REDUCED[cfg.name] = reduced
    return cfg


def get_arch(name: str, *, reduced: bool = False) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REDUCED[name]() if reduced else _REGISTRY[name]


def list_archs() -> list[str]:
    return sorted(_REGISTRY)
