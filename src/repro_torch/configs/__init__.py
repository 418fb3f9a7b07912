"""Architecture configuration registry (``--arch <id>``)."""
from repro_torch.configs.base import (
    EncoderConfig,
    HybridConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    get_config,
    list_archs,
    register,
)

__all__ = ["EncoderConfig", "HybridConfig", "ModelConfig", "MoEConfig",
           "SSMConfig", "get_config", "list_archs", "register"]
