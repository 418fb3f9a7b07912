"""Response-length predictors: the oracle subset of ``repro.core.predictor``.

The serving path of this slice ranks with :class:`OraclePredictor` (or its
noisy variant), so only the distribution-aware base (:class:`LengthPrediction`,
:class:`LengthPredictor`, :func:`predict_lengths`) and the two oracles are
kept here.  They are numpy-only copies of the reference; the BGE predictor,
the calibration wrappers and the ranking head are not part of this slice.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Protocol, Sequence, Tuple

import numpy as np

from repro_torch.core.job import Job
from repro_torch.data.dataset import WINDOW


class Predictor(Protocol):
    """Deprecated scalar protocol (pre-LengthPredictor).  New code should
    type against :class:`LengthPredictor` and call ``predict``/``observe``;
    these two methods remain only so old annotations keep resolving."""

    def init(self, job: Job) -> float: ...
    def iter(self, job: Job) -> float: ...


# --------------------------------------------------------------------------- #
# LengthPrediction — the typed result
# --------------------------------------------------------------------------- #


#: quantile ladder every distribution-aware predictor materialises; the
#: scheduler interpolates between rungs for other risk levels
QUANTILE_GRID: Tuple[float, ...] = (0.5, 0.6, 0.7, 0.8, 0.9, 0.95, 0.99)


def _norm_ppf(q: float) -> float:
    """Standard-normal inverse CDF (Acklam's rational approximation,
    |rel err| < 1.2e-9 — plenty for risk quantiles; avoids a scipy dep)."""
    if not 0.0 < q < 1.0:
        raise ValueError(f"quantile must be in (0, 1), got {q}")
    a = (-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00)
    plow = 0.02425
    if q < plow:
        u = math.sqrt(-2.0 * math.log(q))
        return (((((c[0] * u + c[1]) * u + c[2]) * u + c[3]) * u + c[4]) * u
                + c[5]) / ((((d[0] * u + d[1]) * u + d[2]) * u + d[3]) * u + 1)
    if q > 1 - plow:
        u = math.sqrt(-2.0 * math.log(1 - q))
        return -(((((c[0] * u + c[1]) * u + c[2]) * u + c[3]) * u + c[4]) * u
                 + c[5]) / ((((d[0] * u + d[1]) * u + d[2]) * u + d[3]) * u + 1)
    u = q - 0.5
    r = u * u
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r
            + a[5]) * u / (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r
                            + b[4]) * r + 1)


#: z-values for the grid, computed once — ladder construction sits on the
#: scheduling hot path (every scored job, every window)
_Z_GRID: Tuple[float, ...] = tuple(_norm_ppf(q) for q in QUANTILE_GRID)


def _lognormal_ladder(mean: float, mu: float,
                      s: float) -> Tuple[Tuple[float, float], ...]:
    """Quantile ladder of ``mean * LogNormal(mu, s)`` on the grid."""
    return tuple((q, mean * math.exp(mu + s * z))
                 for q, z in zip(QUANTILE_GRID, _Z_GRID))


@dataclass(frozen=True)
class LengthPrediction:
    """One job's predicted remaining length, as a distribution.

    ``mean`` is the point estimate every legacy consumer ranked on (for a
    stochastic predictor it is the *draw*, not the posterior mean — trace
    compatibility with the scalar API is exact).  ``quantiles`` is a sorted
    ``(q, value)`` ladder; :meth:`quantile` interpolates between rungs and
    falls back to a normal approximation from ``std`` (degenerate at the
    mean when ``std == 0``).
    """

    mean: float
    std: float = 0.0
    quantiles: Tuple[Tuple[float, float], ...] = ()

    def quantile(self, q: float) -> float:
        """The q-th quantile of the predicted remaining length."""
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {q}")
        lad = self.quantiles
        if lad:
            if q <= lad[0][0]:
                return lad[0][1]
            for (q0, v0), (q1, v1) in zip(lad, lad[1:]):
                if q <= q1:
                    w = (q - q0) / (q1 - q0)
                    return v0 + w * (v1 - v0)
            return lad[-1][1]
        if self.std > 0.0:
            return max(self.mean + _norm_ppf(q) * self.std, 0.0)
        return self.mean


# --------------------------------------------------------------------------- #
# LengthPredictor — the base class
# --------------------------------------------------------------------------- #


class LengthPredictor:
    """Distribution-aware predictor base.

    Subclasses implement EITHER ``predict_jobs(jobs) -> array`` (one batched
    dispatch of point estimates — the BGE path) OR ``_point(job) -> float``
    (per-job point estimate, e.g. the oracles), plus optionally
    ``_prediction(job, mean)`` to attach spread/quantiles.  ``observe`` is a
    no-op here; calibration wrappers override it to consume feedback.

    ``init``/``iter`` are the deprecated scalar shims (Algorithm 1's
    surface): both return ``predict([job])[0].mean``.
    """

    def predict(self, jobs: Sequence[Job]) -> List[LengthPrediction]:
        """Batched prediction for a scheduling pool — ONE dispatch when the
        underlying model supports it.  For stochastic predictors the draw
        order is the pool order (scoring order), which keeps drain-once
        traces bit-identical to the legacy per-job ``init``/``iter`` path."""
        jobs = list(jobs)
        if not jobs:
            return []
        pj = getattr(self, "predict_jobs", None)
        if pj is not None:
            means = [float(m) for m in pj(jobs)]
        else:
            means = [float(self._point(j)) for j in jobs]
        return [self._prediction(j, m) for j, m in zip(jobs, means)]

    def observe(self, job: Job, actual_remaining: float) -> None:
        """Online feedback: ``job`` has ``actual_remaining`` ground-truth
        tokens left *now*.  The serving loop calls this on every window where
        truth is known (trace replay / simulation), on every FINISH
        (``actual_remaining == 0``), and on CANCELLED/EXPIRED terminations
        (whose censored lengths calibrators must discard).  No-op for raw
        predictors."""

    # -- helpers subclasses provide ------------------------------------- #
    def _point(self, job: Job) -> float:  # pragma: no cover - abstract-ish
        raise NotImplementedError(
            f"{type(self).__name__} must implement _point or predict_jobs")

    def _prediction(self, job: Job, mean: float) -> LengthPrediction:
        return LengthPrediction(mean=mean)

    # -- deprecated scalar shims ---------------------------------------- #
    def init(self, job: Job) -> float:
        """Deprecated: use ``predict([job])[0]``."""
        return self.predict([job])[0].mean

    def iter(self, job: Job) -> float:
        """Deprecated: use ``predict([job])[0]``."""
        return self.predict([job])[0].mean


def predict_lengths(pred, jobs: Sequence[Job]) -> List[LengthPrediction]:
    """Adapt any predictor — new or legacy — to ``list[LengthPrediction]``.

    The scheduler's single entry point: a :class:`LengthPredictor` answers
    through its batched ``predict``; a legacy object with only
    ``predict_jobs`` or ``init``/``iter`` is wrapped into degenerate
    point-mass predictions (same call order as the old scoring loop)."""
    jobs = list(jobs)
    if not jobs:
        return []
    p = getattr(pred, "predict", None)
    if p is not None:
        return list(p(jobs))
    pj = getattr(pred, "predict_jobs", None)
    if pj is not None:
        return [LengthPrediction(mean=float(m)) for m in pj(jobs)]
    out = []
    for j in jobs:
        v = pred.init(j) if j.priority is None else pred.iter(j)
        out.append(LengthPrediction(mean=float(v)))
    return out


# --------------------------------------------------------------------------- #
# Oracle predictors
# --------------------------------------------------------------------------- #


class OraclePredictor(LengthPredictor):
    """Ground-truth remaining length (the SJF 'ideal' bound)."""

    def _point(self, job: Job) -> float:
        return float(job.true_remaining)


@dataclass
class NoisyOraclePredictor(LengthPredictor):
    """truth * lognormal(0, sigma_k) * bias;  sigma_k = sigma0 * decay^k.

    Defaults calibrated against our trained BGE predictor's per-step relative
    error (see benchmarks/fig2_iterative_mae.py): step-0 MAE/mean ≈ 0.45
    falling toward ≈ 0.25 by step 4 — matching the paper's Fig. 2(b) shape.

    ``bias`` injects a systematic multiplicative mis-calibration (< 1 =
    underestimates, the head-of-line-blocking direction) for the calibration
    benchmarks; the default 1.0 is bit-exact with the unbiased predictor.
    The quantile ladder is the analytic posterior of the truth given the
    draw (lognormal), so risk-aware consumers cost no extra RNG draws and
    the draw sequence — one per job, in scoring order — is untouched.
    """

    # calibrated to the trained BGE predictor's relative error per step
    # (benchmarks/fig2_iterative_mae.py): ~0.5 at step 0 -> ~0.3 floor
    sigma0: float = 0.50
    decay: float = 0.90
    sigma_floor: float = 0.30
    seed: int = 0
    #: systematic multiplicative bias applied to every prediction
    bias: float = 1.0
    _rng: np.random.RandomState = field(default=None, repr=False)

    def __post_init__(self):
        self._rng = np.random.RandomState(self.seed)

    def _sigma(self, step: int) -> float:
        return max(self.sigma0 * self.decay ** step, self.sigma_floor)

    def _point(self, job: Job) -> float:
        step = job.tokens_generated // WINDOW
        s = self._sigma(step)
        noise = self._rng.lognormal(mean=-0.5 * s * s, sigma=s)
        return max(float(job.true_remaining) * noise * self.bias, 1.0)

    def _prediction(self, job: Job, mean: float) -> LengthPrediction:
        # posterior of truth given the draw m = truth * noise:
        # truth = m / noise ~ m * LogNormal(s^2/2, s), so the q-quantile is
        # m * exp(s^2/2 + s * z_q) and the std carries the full
        # exp(mu + s^2/2) = exp(s^2) factor
        s = self._sigma(job.tokens_generated // WINDOW)
        ladder = _lognormal_ladder(mean, 0.5 * s * s, s)
        std = mean * math.exp(s * s) * math.sqrt(max(math.expm1(s * s), 0.0))
        return LengthPrediction(mean=mean, std=std, quantiles=ladder)
