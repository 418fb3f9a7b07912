"""ELIS scheduling layer (host-side copies of ``repro.core``).

Public serving surface: ``ElisServer`` + the typed request lifecycle.
Only the oracle predictors are carried so far.
"""
from repro_torch.core.job import Job, JobState, TERMINAL_STATES
from repro_torch.core.load_balancer import (
    GlobalState,
    LoadBalancer,
    PLACEMENTS,
    PlacementPolicy,
    make_placement,
)
from repro_torch.core.metrics import (
    fairness_ratio,
    prediction_stats,
    summarize,
    summarize_by_tenant,
)
from repro_torch.core.predictor import (
    LengthPrediction,
    LengthPredictor,
    NoisyOraclePredictor,
    OraclePredictor,
    predict_lengths,
)
from repro_torch.core.scheduler import (
    PREEMPT_POLICIES,
    PreemptionConfig,
    SchedulerConfig,
    decide_preempt,
    make_policy,
    prefill_debt,
    select_preemptions,
)
from repro_torch.core.frontend import (
    Backend,
    ELISFrontend,
    Event,
    ExecResult,
    FrontendConfig,
)
from repro_torch.core.api import (
    ElisServer,
    Request,
    RequestHandle,
    RequestOptions,
    RequestStatus,
    Response,
    TokenChunk,
)

__all__ = [
    "Backend",
    "ELISFrontend",
    "ElisServer",
    "Event",
    "ExecResult",
    "FrontendConfig",
    "GlobalState",
    "Job",
    "JobState",
    "LengthPrediction",
    "LengthPredictor",
    "LoadBalancer",
    "NoisyOraclePredictor",
    "OraclePredictor",
    "PLACEMENTS",
    "PREEMPT_POLICIES",
    "PlacementPolicy",
    "PreemptionConfig",
    "Request",
    "RequestHandle",
    "RequestOptions",
    "RequestStatus",
    "Response",
    "SchedulerConfig",
    "TERMINAL_STATES",
    "TokenChunk",
    "decide_preempt",
    "fairness_ratio",
    "make_placement",
    "make_policy",
    "predict_lengths",
    "prediction_stats",
    "prefill_debt",
    "select_preemptions",
    "summarize",
    "summarize_by_tenant",
]
