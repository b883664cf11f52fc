"""qwen2-moe-a2.7b — MoE decoder [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (GQA kv=16) d_ff=1408(per-expert) vocab=151936,
MoE: 4 shared + 60 routed top-4 (allocated as 64), untied LM head.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = register(
    ArchConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab_size=151936,
        act="swiglu",
        moe=MoEConfig(n_routed=60, n_shared=4, top_k=4, d_expert=1408, pad_experts_to=64),
        block_pattern=(("moe", 1),),
    ),
    reduced=lambda: ArchConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=96,
        vocab_size=256,
        act="swiglu",
        dtype="float32",
        moe=MoEConfig(n_routed=8, n_shared=2, top_k=2, d_expert=96),
        block_pattern=(("moe", 1),),
    ),
)
