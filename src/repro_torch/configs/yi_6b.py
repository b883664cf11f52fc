"""yi-6b — llama-arch dense GQA decoder [arXiv:2403.04652; hf].

32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000, SwiGLU,
rope_theta 5e6, untied LM head.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="yi-6b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=4,
        d_ff=11008,
        vocab_size=64000,
        act="swiglu",
        rope_theta=5_000_000.0,
        block_pattern=(("attn", 1),),
    ),
    reduced=lambda: ArchConfig(
        name="yi-6b",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=160,
        vocab_size=256,
        act="swiglu",
        dtype="float32",
        block_pattern=(("attn", 1),),
    ),
)
