"""Architecture configs served by the port + registry."""
from repro_torch.configs.base import ArchConfig, get_arch, list_archs, register

# importing the module registers its config
from repro_torch.configs import gemma_2b  # noqa: F401  (registration side effect)

__all__ = ["ArchConfig", "get_arch", "list_archs", "register"]
