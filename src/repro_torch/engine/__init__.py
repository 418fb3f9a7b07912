from repro_torch.engine.engine import EngineConfig, EngineExecutor, InferenceEngine
from repro_torch.engine.sampler import SamplerConfig, sample

__all__ = [
    "EngineConfig",
    "EngineExecutor",
    "InferenceEngine",
    "SamplerConfig",
    "sample",
]
