"""internlm2-1.8b — dense GQA decoder [arXiv:2403.17297; hf].

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544, RoPE + SwiGLU.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="internlm2-1.8b",
        family="dense",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=92544,
        act="swiglu",
        rope_theta=1_000_000.0,
        block_pattern=(("attn", 1),),
    ),
    reduced=lambda: ArchConfig(
        name="internlm2-1.8b",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        act="swiglu",
        dtype="float32",
        block_pattern=(("attn", 1),),
    ),
)
