"""Architecture config schema and registry (the port's own copy).

Only the fields the ported decoder paths read are kept: the attention +
gated-MLP (SwiGLU or GeGLU) decoder stack of ``block_pattern=(("attn", 1),)``
families and its sliding-window ``swa`` kind (``attn_window``), the
mixture-of-experts block of ``(("moe", 1),)`` families (``MoEConfig``,
``models/moe.py``), the multi-head latent attention + MoE block of
``(("mla_moe", 1),)`` families (``MLAConfig``, ``models/mla.py``), the
hybrid attention + Mamba blocks ``hymba_global`` / ``hymba_swa``
(``SSMConfig``, ``attn_window``, ``n_meta_tokens``; ``models/hybrid.py``,
``models/ssm.py``), the recurrent ``mlstm`` / ``slstm`` blocks of the
xLSTM family (``SSMConfig``; ``models/ssm.py``), the encoder-decoder of
``encdec`` families (``n_enc_layers``; ``models/encdec.py``), the
modality-stub prefix of ``stub_prefix_len`` (``models/transformer.py``),
and the tensor-parallel flags of ``parallel/tp.py``; and the dry run's
cell shapes (``ShapeSpec``, ``SHAPES``, ``shape_applicable``;
``launch/dryrun.py``).  The reference's
``norm`` and ``global_layer_every`` are left out: none of its modules
reads them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_routed: int
    n_shared: int
    top_k: int
    d_expert: int  # per-expert FFN hidden dim
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # Allocate expert weights padded to this count (> n_routed); routing
    # never selects a padded expert, so they are dead weights that are
    # planned and served all the same, as in the reference.
    pad_experts_to: int | None = None

    @property
    def n_alloc(self) -> int:
        return self.pad_experts_to or self.n_routed


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_size: int = 16  # per-channel state (mamba N)
    conv_width: int = 4
    expand: int = 2  # d_inner = expand * d_model
    chunk_size: int = 256  # chunkwise-parallel training chunk


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
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # sequence of (block_kind, repeat), expanded cyclically to n_layers
    block_pattern: tuple[tuple[str, int], ...] = (("attn", 1),)
    attn_window: Optional[int] = None  # sliding-window size of the swa kinds
    # encoder-decoder: an n_enc_layers bidirectional encoder over the source
    # embeddings, and n_layers decoder layers with cross-attention into it
    encdec: bool = False
    n_enc_layers: int = 0
    # modality frontend stub: precomputed embeddings (vlm patches) replace the
    # token embeddings of the first stub_prefix_len positions
    stub_prefix_len: int = 0
    # learnable tokens prepended to the sequence (hymba's meta tokens)
    n_meta_tokens: int = 0
    # sub-quadratic in sequence length (SWA ring caches + O(1) SSM state);
    # nothing in the port reads it: it keeps the config field for field the
    # reference's, which the config parity tests hold
    subquadratic: bool = False
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


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


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


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether (arch, shape) is a runnable dry-run cell."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "long_500k needs sub-quadratic attention; pure full-attention arch"
    return True, ""
