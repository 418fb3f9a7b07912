"""Architecture configuration registry (``--arch <id>``)."""
from repro_torch.configs.base import (
    HybridConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    get_config,
    list_archs,
    register,
)

__all__ = ["HybridConfig", "ModelConfig", "MoEConfig", "SSMConfig",
           "get_config", "list_archs", "register"]
