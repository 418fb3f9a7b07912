from repro_torch.engine.engine import (EngineConfig, EngineExecutor,
                                      InferenceEngine, make_tp_pods)
from repro_torch.engine.sampler import SamplerConfig, sample

__all__ = [
    "EngineConfig",
    "EngineExecutor",
    "InferenceEngine",
    "SamplerConfig",
    "make_tp_pods",
    "sample",
]
