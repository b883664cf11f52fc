"""hymba-1.5b — hybrid parallel attention + Mamba heads [arXiv:2411.13676; hf].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
3 global-attention layers (first / middle / last), SWA elsewhere; 128 meta
tokens.  Sub-quadratic: SWA ring caches + O(1) SSM state.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig, register

CONFIG = register(
    ArchConfig(
        name="hymba-1.5b",
        family="hybrid",
        n_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        d_ff=5504,
        vocab_size=32001,
        head_dim=64,
        ssm=SSMConfig(state_size=16, conv_width=4, expand=2, chunk_size=16),
        attn_window=1024,
        n_meta_tokens=128,
        block_pattern=(
            ("hymba_global", 1),
            ("hymba_swa", 14),
            ("hymba_global", 1),
            ("hymba_swa", 15),
            ("hymba_global", 1),
        ),
        subquadratic=True,
    ),
    reduced=lambda: ArchConfig(
        name="hymba-1.5b",
        family="hybrid",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        head_dim=16,
        dtype="float32",
        ssm=SSMConfig(state_size=8, conv_width=4, expand=2, chunk_size=8),
        attn_window=16,
        n_meta_tokens=8,
        block_pattern=(("hymba_global", 1), ("hymba_swa", 2), ("hymba_global", 1)),
        subquadratic=True,
    ),
)
