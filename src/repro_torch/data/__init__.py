from repro_torch.data.arrivals import (
    FABRIX_ALPHA,
    FABRIX_SCALE,
    GammaArrivals,
    PoissonArrivals,
    diurnal_arrival_times,
    exponential_loglik,
    fit_gamma,
    gamma_loglik,
)
from repro_torch.data.dataset import (
    MIN_SEQ_BUCKET,
    WINDOW,
    batch_bucket,
    n_shape_buckets,
    seq_bucket,
)
from repro_torch.data.tokenizer import EOS_ID, PAD_ID, HashTokenizer
from repro_torch.data.workload import (
    SCENARIOS,
    Request,
    ScaleWorkload,
    WorkloadGenerator,
    build_scale_workload,
    bursty_arrival_times,
    scale_workload_requests,
)

__all__ = [
    "EOS_ID",
    "FABRIX_ALPHA",
    "FABRIX_SCALE",
    "GammaArrivals",
    "HashTokenizer",
    "MIN_SEQ_BUCKET",
    "PAD_ID",
    "PoissonArrivals",
    "Request",
    "SCENARIOS",
    "ScaleWorkload",
    "WINDOW",
    "WorkloadGenerator",
    "batch_bucket",
    "build_scale_workload",
    "bursty_arrival_times",
    "diurnal_arrival_times",
    "exponential_loglik",
    "fit_gamma",
    "gamma_loglik",
    "n_shape_buckets",
    "scale_workload_requests",
    "seq_bucket",
]
