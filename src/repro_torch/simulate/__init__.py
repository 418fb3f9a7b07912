"""The cluster simulator: the latency model (``profiles``), the
discrete-event executor behind the frontend (``executor``), the paper's
experiment runner (``runner``) and the vectorized scale fast path
(``scale``).  Host code (numpy and Python); the one piece of a run that
may sit on the card is a BGE predictor the caller passes in."""
from repro_torch.simulate.executor import SimExecutor
from repro_torch.simulate.profiles import (
    CALIBRATION_MEAN_TOKENS,
    PROFILES,
    SCHED_OVERHEAD_MS,
    ModelProfile,
    avg_request_rate,
)
from repro_torch.simulate.runner import (
    ARRIVAL_PROCESSES,
    ExperimentConfig,
    compare_policies,
    make_predictor,
    requests_to_jobs,
    run_experiment,
)
from repro_torch.simulate.scale import (
    ScaleResult,
    ScaleSimConfig,
    ScaleSimulator,
    run_exact_reference,
)

__all__ = [
    "ARRIVAL_PROCESSES",
    "CALIBRATION_MEAN_TOKENS",
    "ExperimentConfig",
    "ModelProfile",
    "PROFILES",
    "SCHED_OVERHEAD_MS",
    "ScaleResult",
    "ScaleSimConfig",
    "ScaleSimulator",
    "SimExecutor",
    "avg_request_rate",
    "compare_policies",
    "make_predictor",
    "requests_to_jobs",
    "run_exact_reference",
    "run_experiment",
]
