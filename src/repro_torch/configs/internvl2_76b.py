"""internvl2-76b — VLM backbone (InternViT frontend stubbed) [arXiv:2404.16821].

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.  Per the brief the
transformer BACKBONE only is modeled; ``input_specs`` provides precomputed
patch embeddings for the first 256 positions (stub_prefix_len).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="internvl2-76b",
        family="vlm",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=28672,
        vocab_size=128256,
        act="swiglu",
        stub_prefix_len=256,
        block_pattern=(("attn", 1),),
    ),
    reduced=lambda: ArchConfig(
        name="internvl2-76b",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=160,
        vocab_size=256,
        act="swiglu",
        stub_prefix_len=8,
        dtype="float32",
        block_pattern=(("attn", 1),),
    ),
)
