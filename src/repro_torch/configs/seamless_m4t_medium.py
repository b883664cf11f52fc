"""seamless-m4t-medium — encoder-decoder, audio frontend stubbed
[arXiv:2308.11596; hf].

12L encoder + 12L decoder, d_model=1024 16H (kv=16) d_ff=4096 vocab=256206.
``input_specs`` provides precomputed audio-frame embeddings (B, S, d) for
the encoder; shapes interpret seq_len as both source frames and target
tokens (DESIGN.md §4).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="seamless-m4t-medium",
        family="audio",
        n_layers=12,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=4096,
        vocab_size=256206,
        act="swiglu",
        encdec=True,
        n_enc_layers=12,
        block_pattern=(("attn", 1),),
    ),
    reduced=lambda: ArchConfig(
        name="seamless-m4t-medium",
        family="audio",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        act="swiglu",
        dtype="float32",
        encdec=True,
        n_enc_layers=2,
        block_pattern=(("attn", 1),),
    ),
)
