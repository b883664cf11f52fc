"""gemma-2b — dense MQA decoder [arXiv:2403.08295; hf].

18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000, GeGLU,
head_dim=256, tied embeddings, sqrt(d) embedding scale.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="gemma-2b",
        family="dense",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        d_ff=16384,
        vocab_size=256000,
        head_dim=256,
        act="geglu",
        tie_embeddings=True,
        embed_scale=True,
        block_pattern=(("attn", 1),),
    ),
    reduced=lambda: ArchConfig(
        name="gemma-2b",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_ff=192,
        vocab_size=256,
        head_dim=32,
        act="geglu",
        tie_embeddings=True,
        embed_scale=True,
        dtype="float32",
        block_pattern=(("attn", 1),),
    ),
)
