"""xlstm-350m — sLSTM + mLSTM recurrent LM [arXiv:2405.04517; unverified].

24L d_model=1024 4H d_ff=0 (xLSTM blocks carry their own projections)
vocab=50304.  Block ratio mLSTM:sLSTM = 7:1 (xLSTM[7:1]).  Sub-quadratic:
recurrent O(1) decode state.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig, register

CONFIG = register(
    ArchConfig(
        name="xlstm-350m",
        family="ssm",
        n_layers=24,
        d_model=1024,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        ssm=SSMConfig(state_size=16, conv_width=4, expand=2, chunk_size=256),
        block_pattern=(("mlstm", 7), ("slstm", 1)),
        subquadratic=True,
    ),
    reduced=lambda: ArchConfig(
        name="xlstm-350m",
        family="ssm",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=256,
        dtype="float32",
        ssm=SSMConfig(state_size=8, conv_width=4, expand=2, chunk_size=8),
        block_pattern=(("mlstm", 3), ("slstm", 1)),
        subquadratic=True,
    ),
)
