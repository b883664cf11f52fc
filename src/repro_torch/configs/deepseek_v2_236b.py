"""deepseek-v2-236b — MLA + MoE decoder [arXiv:2405.04434; hf].

60L d_model=5120 128H (MLA) d_ff=1536(per-expert) vocab=102400,
MLA kv_lora=512, MoE: 2 shared + 160 routed top-6, untied LM head.
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig, register

CONFIG = register(
    ArchConfig(
        name="deepseek-v2-236b",
        family="moe",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        d_ff=1536,
        vocab_size=102400,
        act="swiglu",
        mla=MLAConfig(
            kv_lora_rank=512,
            q_lora_rank=1536,
            qk_nope_head_dim=128,
            qk_rope_head_dim=64,
            v_head_dim=128,
        ),
        moe=MoEConfig(n_routed=160, n_shared=2, top_k=6, d_expert=1536),
        block_pattern=(("mla_moe", 1),),
    ),
    reduced=lambda: ArchConfig(
        name="deepseek-v2-236b",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=48,
        vocab_size=256,
        act="swiglu",
        dtype="float32",
        mla=MLAConfig(
            kv_lora_rank=32, q_lora_rank=48, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16,
        ),
        moe=MoEConfig(n_routed=8, n_shared=1, top_k=2, d_expert=48),
        block_pattern=(("mla_moe", 1),),
    ),
)
