"""Architecture configs served by the port + registry."""
from repro_torch.configs.base import (
    ArchConfig,
    MLAConfig,
    MoEConfig,
    SSMConfig,
    ShapeSpec,
    SHAPES,
    get_arch,
    list_archs,
    register,
)

# importing each module registers its config
from repro_torch.configs import (  # noqa: F401  (registration side effect)
    deepseek_v2_236b,
    gemma_2b,
    hymba_1_5b,
    internlm2_1_8b,
    internvl2_76b,
    phi3_medium_14b,
    qwen2_moe_a2_7b,
    seamless_m4t_medium,
    xlstm_350m,
    yi_6b,
)

__all__ = ["ArchConfig", "MLAConfig", "MoEConfig", "SSMConfig", "ShapeSpec", "SHAPES",
           "get_arch", "list_archs", "register"]
