"""The simulator's latency model (a copy of ``repro.simulate.profiles``),
which the executor's live calibration fits."""
from repro_torch.simulate.profiles import (
    CALIBRATION_MEAN_TOKENS,
    PROFILES,
    ModelProfile,
)

__all__ = ["CALIBRATION_MEAN_TOKENS", "ModelProfile", "PROFILES"]
