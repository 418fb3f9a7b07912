"""Request arrival processes.

The paper analyses 200k+ FabriX trace points and finds inter-arrival times
follow a Gamma distribution (shape α=0.73, scale β=10.41 s) much better than
a Poisson process — bursty arrivals (α < 1 means over-dispersion).  We expose
both processes, a method-of-moments/MLE fitter, and a log-likelihood
comparison used by the Fig. 4 benchmark.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Tuple

import numpy as np

#: values fitted on the FabriX trace in the paper
FABRIX_ALPHA = 0.73
FABRIX_SCALE = 10.41


@dataclass(frozen=True)
class GammaArrivals:
    alpha: float = FABRIX_ALPHA
    scale: float = FABRIX_SCALE

    @property
    def mean_interval(self) -> float:
        return self.alpha * self.scale

    def rate_scaled(self, target_rate: float) -> "GammaArrivals":
        """Same burstiness (alpha), rescaled so mean rate = target (req/s)."""
        return GammaArrivals(self.alpha, 1.0 / (target_rate * self.alpha))

    def sample_intervals(self, n: int, rng: np.random.RandomState) -> np.ndarray:
        return rng.gamma(self.alpha, self.scale, size=n)

    def sample_arrival_times(self, n: int, rng: np.random.RandomState) -> np.ndarray:
        return np.cumsum(self.sample_intervals(n, rng))


@dataclass(frozen=True)
class PoissonArrivals:
    rate: float  # req/s

    @property
    def mean_interval(self) -> float:
        return 1.0 / self.rate

    def sample_intervals(self, n: int, rng: np.random.RandomState) -> np.ndarray:
        return rng.exponential(1.0 / self.rate, size=n)

    def sample_arrival_times(self, n: int, rng: np.random.RandomState) -> np.ndarray:
        return np.cumsum(self.sample_intervals(n, rng))


def diurnal_arrival_times(n: int, mean_rate: float,
                          rng: np.random.RandomState, *,
                          amplitude: float = 0.6,
                          period_s: float = 3600.0,
                          noise_sigma: float = 0.0,
                          grid_points: int = 4096) -> np.ndarray:
    """Inhomogeneous-Poisson arrivals under a diurnal (sinusoidal) rate
    curve, via integrated-rate inversion.

        rate(t) = mean_rate * (1 + amplitude * sin(2π t / period_s))
                  [* lognormal(noise_sigma) jitter per grid cell]

    Unit-rate exponential marks are mapped through the inverse of the
    cumulative rate Λ(t) (trapezoid-integrated on a time grid, inverted
    with ``np.interp``) — the standard time-change construction, fully
    vectorized: one million arrivals cost two cumsums and an interp.
    Returned times are sorted; the long-run mean rate is ``mean_rate``.
    """
    assert n > 0 and mean_rate > 0
    assert 0.0 <= amplitude < 1.0, "amplitude >= 1 makes the rate negative"
    # unit-rate event marks, drawn once; the grid (re)extends to cover them
    marks = np.cumsum(rng.exponential(1.0, size=n))
    horizon = 1.25 * n / mean_rate + period_s
    while True:
        t = np.linspace(0.0, horizon, grid_points)
        rate = mean_rate * (1.0 + amplitude *
                            np.sin(2.0 * np.pi * t / period_s))
        if noise_sigma > 0:
            rate = rate * rng.lognormal(-0.5 * noise_sigma ** 2,
                                        noise_sigma, size=grid_points)
        cum = np.concatenate(
            ([0.0], np.cumsum(0.5 * (rate[1:] + rate[:-1]) * np.diff(t))))
        if cum[-1] >= marks[-1]:
            return np.interp(marks, cum, t)
        horizon *= 2.0


# --------------------------------------------------------------------------- #
# Fitting
# --------------------------------------------------------------------------- #


def fit_gamma(intervals: np.ndarray, iters: int = 100) -> Tuple[float, float]:
    """MLE gamma fit via Newton iterations on the digamma equation
    (scipy-free).  Returns (alpha, scale)."""
    x = np.asarray(intervals, dtype=np.float64)
    x = x[x > 0]
    m = x.mean()
    logm = np.log(m)
    meanlog = np.log(x).mean()
    s = logm - meanlog
    # initial guess (Minka 2002)
    a = (3 - s + np.sqrt((s - 3) ** 2 + 24 * s)) / (12 * s)
    for _ in range(iters):
        num = np.log(a) - _digamma(a) - s
        den = 1.0 / a - _trigamma(a)
        step = num / den
        a_new = a - step
        if a_new <= 0:
            a_new = a / 2
        if abs(a_new - a) < 1e-12:
            a = a_new
            break
        a = a_new
    return float(a), float(m / a)


def _digamma(x: float) -> float:
    """Digamma via asymptotic expansion with recurrence shift."""
    r = 0.0
    while x < 6:
        r -= 1.0 / x
        x += 1
    f = 1.0 / (x * x)
    return r + np.log(x) - 0.5 / x - f * (
        1.0 / 12 - f * (1.0 / 120 - f * (1.0 / 252 - f / 240))
    )


def _trigamma(x: float) -> float:
    r = 0.0
    while x < 6:
        r += 1.0 / (x * x)
        x += 1
    f = 1.0 / (x * x)
    return r + 1.0 / x + f / 2 + f / x * (
        1.0 / 6 - f * (1.0 / 30 - f * (1.0 / 42 - f / 30))
    )


def _loggamma(a: float) -> float:
    """Stirling with shift."""
    shift = 0.0
    x = a
    while x < 8:
        shift -= np.log(x)
        x += 1
    return float(
        shift
        + 0.5 * np.log(2 * np.pi)
        + (x - 0.5) * np.log(x)
        - x
        + 1.0 / (12 * x)
        - 1.0 / (360 * x ** 3)
    )


def gamma_loglik(intervals: np.ndarray, alpha: float, scale: float) -> float:
    x = np.asarray(intervals, dtype=np.float64)
    x = x[x > 0]
    return float(
        np.sum(
            (alpha - 1) * np.log(x) - x / scale - alpha * np.log(scale)
            - _loggamma(alpha)
        )
    )


def exponential_loglik(intervals: np.ndarray) -> float:
    """Best-fit exponential (= Poisson process) log-likelihood."""
    x = np.asarray(intervals, dtype=np.float64)
    x = x[x > 0]
    lam = 1.0 / x.mean()
    return float(np.sum(np.log(lam) - lam * x))
