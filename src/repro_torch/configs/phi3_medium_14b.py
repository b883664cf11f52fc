"""phi3-medium-14b — dense GQA decoder [arXiv:2404.14219; unverified].

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352, RoPE + SwiGLU.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="phi3-medium-14b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=40,
        n_kv_heads=10,
        d_ff=17920,
        vocab_size=100352,
        act="swiglu",
        block_pattern=(("attn", 1),),
    ),
    reduced=lambda: ArchConfig(
        name="phi3-medium-14b",
        family="dense",
        n_layers=2,
        d_model=80,
        n_heads=4,
        n_kv_heads=2,
        d_ff=192,
        vocab_size=256,
        act="swiglu",
        dtype="float32",
        block_pattern=(("attn", 1),),
    ),
)
