"""Architecture configuration registry (``--arch <id>``)."""
from repro_torch.configs.base import (
    ModelConfig,
    SSMConfig,
    get_config,
    list_archs,
    register,
)

__all__ = ["ModelConfig", "SSMConfig", "get_config", "list_archs",
           "register"]
