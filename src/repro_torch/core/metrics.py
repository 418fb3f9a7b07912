"""JCT / queuing-delay / throughput metrics (paper §6 evaluation).

:func:`summarize` aggregates a list of finished Job/Response records (all
percentile families in one ``np.percentile`` call); :func:`prediction_stats`
gives one request's prediction error; :func:`summarize_by_tenant` and
:func:`fairness_ratio` break a multi-tenant run down by tenant;
:func:`improvement` and :func:`kendall_tau` compare runs and rankings.
:class:`StreamingSummary` is the constant-memory path for
million-request runs: exact counts, sums and extremes plus
:class:`QuantileSketch`-backed percentiles (log-bucketed histogram,
relative error at most ``QuantileSketch.rel_error``, about 0.3% at the
defaults), mergeable across shards and tenants.  The scale simulator
(``repro_torch.simulate.scale``) streams into it.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.job import Job, JobState


def prediction_stats(job: Job) -> Tuple[Optional[float], Optional[float]]:
    """Per-request prediction-error stats from the job's scored trace.

    Returns ``(mae, bias)`` over every ``(tokens_at, expected_remaining)``
    entry the scheduler recorded (``Job.pred_trace``), measured against the
    realised remaining length at that point — only computable once the job
    FINISHED (an aborted job's realised length is censored).  ``bias`` is
    the geometric mean of predicted/actual (1.0 = perfectly calibrated,
    < 1 = underestimates)."""
    if job.state is not JobState.FINISHED or not job.pred_trace:
        return None, None
    total = job.tokens_generated
    errs, logr = [], []
    for g, m in job.pred_trace:
        actual = total - g
        # skip degenerate entries on EITHER side: SJF records a floored
        # 0.0 estimate once a job overruns its arrival prediction, and a
        # log-ratio against that (~ -19) would collapse the request's
        # geometric-mean bias to ~0 instead of reflecting the predictor
        if actual <= 0 or m <= 0:
            continue
        errs.append(abs(m - actual))
        logr.append(np.log(m / actual))
    if not errs:
        return None, None
    return float(np.mean(errs)), float(np.exp(np.mean(logr)))


def summarize(jobs: Sequence[Job]) -> Dict[str, float]:
    """Aggregate JCT/queuing/throughput metrics over finished jobs (or
    Response records — anything with the same timing surface)."""
    if not jobs:
        # zero requests finished (all cancelled/expired): report an empty
        # but well-formed summary rather than crashing the caller
        keys = ("jct_mean", "jct_p50", "jct_p99", "jct_min", "jct_max",
                "queuing_delay_mean", "throughput_rps", "makespan",
                "ttft_mean")
        out: Dict[str, float] = {k: 0.0 for k in keys}
        out["n"] = 0
        out["preemptions"] = 0
        return out
    jcts = np.array([j.jct() for j in jobs])
    qd = np.array([j.queuing_delay for j in jobs])
    makespan = max(j.finish_time for j in jobs) - min(
        j.arrival_time for j in jobs
    )
    # every percentile family in ONE fused call — a single sort of the JCT
    # array instead of one re-sort per metric (p0/p100 are exactly min/max)
    jct_min, jct_p50, jct_p99, jct_max = np.percentile(
        jcts, (0.0, 50.0, 99.0, 100.0))
    out = {
        "n": len(jobs),
        "jct_mean": float(jcts.mean()),
        "jct_p50": float(jct_p50),
        "jct_p99": float(jct_p99),
        "jct_min": float(jct_min),
        "jct_max": float(jct_max),
        "queuing_delay_mean": float(qd.mean()),
        "throughput_rps": len(jobs) / max(makespan, 1e-9),
        "makespan": float(makespan),
        "preemptions": int(sum(j.n_preemptions for j in jobs)),
        "ttft_mean": float(
            np.mean([
                j.first_token_time - j.arrival_time
                for j in jobs if j.first_token_time is not None
            ])
        ),
    }
    # prediction-error aggregates: present only when the records carry
    # per-request stats (Response.pred_mae / pred_bias from a
    # length-predicting policy) — raw Job summaries are unchanged
    maes = [v for j in jobs if (v := getattr(j, "pred_mae", None)) is not None]
    biases = [v for j in jobs
              if (v := getattr(j, "pred_bias", None)) is not None]
    if maes:
        out["pred_mae_mean"] = float(np.mean(maes))
    if biases:
        # geometric mean composes multiplicative per-request biases
        out["pred_bias_gmean"] = float(np.exp(np.mean(np.log(biases))))
    return out


def fairness_ratio(values: Dict[str, float]) -> float:
    """Max/min ratio across per-tenant metric values (1.0 = perfectly
    fair); 0.0 when fewer than two tenants have data.  A tenant sitting
    at exactly 0 (a degenerate zero mean JCT — e.g. every request
    finished within clock resolution) alongside a non-zero tenant is
    maximal unfairness by this ratio: reported as ``inf`` rather than
    tripping a ZeroDivisionError."""
    vals = [v for v in values.values() if v >= 0]
    if len(vals) < 2:
        return 0.0
    lo, hi = min(vals), max(vals)
    if lo == 0.0:
        return float("inf") if hi > 0.0 else 0.0
    return hi / lo


def summarize_by_tenant(jobs: Sequence, slo_targets: Optional[Dict[str, float]]
                        = None) -> Dict[str, Dict[str, float]]:
    """Exact per-tenant :func:`summarize` over finished records carrying a
    ``tenant`` attribute, plus ``slo_attainment`` for tenants with a target
    (fraction of finished requests with JCT ≤ target)."""
    slo_targets = slo_targets or {}
    groups: Dict[str, List] = {}
    for j in jobs:
        groups.setdefault(getattr(j, "tenant", "default"), []).append(j)
    out: Dict[str, Dict[str, float]] = {}
    for tenant, members in sorted(groups.items()):
        s = summarize(members)
        target = slo_targets.get(tenant)
        if target is not None:
            s["slo_target"] = float(target)
            s["slo_attainment"] = (
                sum(1 for j in members if j.jct() <= target) / len(members))
        out[tenant] = s
    return out


def improvement(base: Dict[str, float], new: Dict[str, float],
                key: str = "jct_mean") -> float:
    """Percent reduction of ``key`` relative to ``base`` (paper Fig. 6)."""
    return 100.0 * (base[key] - new[key]) / base[key]


def kendall_tau(x: Sequence[float], y: Sequence[float]) -> float:
    """Kendall's τ-b rank correlation between ``x`` and ``y``.

    The metric the ranking head is actually judged on: ISRTF consumes only
    the *order* of predicted remaining lengths, and τ measures exactly how
    well that order matches the realised one (+1 = identical ordering,
    −1 = reversed, 0 = uncorrelated).  τ-b applies the tie correction
    ``(P − Q) / sqrt((P + Q + Tx)(P + Q + Ty))`` so heavily quantised
    predictions aren't rewarded for abstaining.

    O(n²) pairwise comparison, vectorised per row — fine at benchmark
    sample counts (≲ 10k); returns 0.0 when fewer than two samples or
    either argument is constant."""
    xa = np.asarray(x, np.float64)
    ya = np.asarray(y, np.float64)
    n = len(xa)
    if n != len(ya):
        raise ValueError(f"length mismatch: {n} vs {len(ya)}")
    if n < 2:
        return 0.0
    conc = disc = tx = ty = 0
    for i in range(n - 1):
        dx = xa[i + 1:] - xa[i]
        dy = ya[i + 1:] - ya[i]
        s = np.sign(dx) * np.sign(dy)
        conc += int(np.sum(s > 0))
        disc += int(np.sum(s < 0))
        tx += int(np.sum((dx == 0) & (dy != 0)))
        ty += int(np.sum((dy == 0) & (dx != 0)))
    denom = math.sqrt((conc + disc + tx) * (conc + disc + ty))
    if denom == 0.0:
        return 0.0
    return (conc - disc) / denom


# --------------------------------------------------------------------------- #
# Streaming aggregation (million-request runs: no stored Response lists)
# --------------------------------------------------------------------------- #


class QuantileSketch:
    """Streaming quantile sketch over positive values (log-bucketed
    histogram).

    Fixed geometric bins over ``[lo, hi)`` — a value maps to the bin holding
    its logarithm, so any quantile is reported with *relative* error at most
    half a bin width (:attr:`rel_error`, ≈ 0.3% at the defaults), using
    O(n_bins) memory regardless of how many values are added.  Values
    outside the range clamp into under/overflow bins and are reported as the
    observed min/max.  Sketches with identical bin layouts merge exactly
    (shard/tenant roll-ups)."""

    __slots__ = ("lo", "hi", "n_bins", "_log_lo", "_w", "counts",
                 "n", "total", "min", "max")

    def __init__(self, lo: float = 1e-4, hi: float = 1e6,
                 n_bins: int = 4096):
        assert 0 < lo < hi and n_bins > 0
        self.lo, self.hi, self.n_bins = float(lo), float(hi), int(n_bins)
        self._log_lo = math.log(lo)
        self._w = (math.log(hi) - self._log_lo) / n_bins
        # [0] = underflow, [1..n_bins] = geometric bins, [-1] = overflow
        self.counts = np.zeros(n_bins + 2, dtype=np.int64)
        self.n = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    @property
    def rel_error(self) -> float:
        """Worst-case relative quantile error for in-range values."""
        return math.exp(self._w / 2.0) - 1.0

    def add(self, values) -> None:
        x = np.asarray(values, dtype=np.float64).ravel()
        if x.size == 0:
            return
        self.n += int(x.size)
        self.total += float(x.sum())
        self.min = min(self.min, float(x.min()))
        self.max = max(self.max, float(x.max()))
        idx = np.floor(
            (np.log(np.maximum(x, 1e-300)) - self._log_lo) / self._w
        ).astype(np.int64) + 1
        np.clip(idx, 0, self.n_bins + 1, out=idx)
        self.counts += np.bincount(idx, minlength=self.counts.size)

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def quantile(self, q: float) -> float:
        """The q-quantile (q in [0, 1]), nearest-rank over the histogram;
        in-range values are exact to within :attr:`rel_error`."""
        if self.n == 0:
            return 0.0
        rank = q * (self.n - 1)
        cum = np.cumsum(self.counts)
        b = int(np.searchsorted(cum, rank, side="right"))
        if b <= 0 and self.counts[0] > 0:
            return self.min
        if b >= self.n_bins + 1:
            return self.max
        # geometric midpoint of the bin, clamped to the observed range
        mid = math.exp(self._log_lo + (b - 0.5) * self._w)
        return min(max(mid, self.min), self.max)

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        assert (self.lo, self.hi, self.n_bins) == \
               (other.lo, other.hi, other.n_bins), "incompatible bin layout"
        self.counts += other.counts
        self.n += other.n
        self.total += other.total
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self


class StreamingSummary:
    """Constant-memory replacement for :func:`summarize`.

    Feed finished records one at a time (:meth:`add_response`) or as
    vectors (:meth:`add_batch`); :meth:`summarize` returns the same key
    surface as :func:`summarize` — means/counts/extremes exact, p50/p99
    from a :class:`QuantileSketch` (documented tolerance
    :attr:`QuantileSketch.rel_error`).  With ``slo_target`` set (seconds of
    JCT), also reports ``slo_attainment`` — the fraction of finished
    requests meeting the target."""

    def __init__(self, slo_target: Optional[float] = None):
        self.slo_target = slo_target
        self.sketch = QuantileSketch()
        self.n = 0
        self.qd_sum = 0.0
        self.ttft_sum = 0.0
        self.ttft_n = 0
        self.preemptions = 0
        self.slo_hits = 0
        self.arr_min = math.inf
        self.fin_max = -math.inf
        self.pred_mae_sum = 0.0
        self.pred_mae_n = 0
        self.pred_logbias_sum = 0.0
        self.pred_bias_n = 0

    # ------------------------------------------------------------------ #
    def add(self, jct: float, queuing_delay: float = 0.0, *,
            arrival: float = 0.0, ttft: Optional[float] = None,
            n_preemptions: int = 0, pred_mae: Optional[float] = None,
            pred_bias: Optional[float] = None) -> None:
        self.sketch.add(jct)
        self.n += 1
        self.qd_sum += queuing_delay
        self.preemptions += n_preemptions
        self.arr_min = min(self.arr_min, arrival)
        self.fin_max = max(self.fin_max, arrival + jct)
        if ttft is not None:
            self.ttft_sum += ttft
            self.ttft_n += 1
        if self.slo_target is not None and jct <= self.slo_target:
            self.slo_hits += 1
        if pred_mae is not None:
            self.pred_mae_sum += pred_mae
            self.pred_mae_n += 1
        if pred_bias is not None and pred_bias > 0:
            self.pred_logbias_sum += math.log(pred_bias)
            self.pred_bias_n += 1

    def add_response(self, r) -> None:
        """Add one finished Job/Response record (``summarize`` duck
        surface)."""
        jct = r.jct()
        ttft = (r.first_token_time - r.arrival_time
                if r.first_token_time is not None else None)
        self.add(jct, r.queuing_delay, arrival=r.arrival_time, ttft=ttft,
                 n_preemptions=r.n_preemptions,
                 pred_mae=getattr(r, "pred_mae", None),
                 pred_bias=getattr(r, "pred_bias", None))

    def add_batch(self, jct, queuing_delay, arrival, ttft,
                  n_preemptions) -> None:
        """Vectorized ingestion (the scale simulator's flush path).  All
        arguments are equal-length arrays; ``ttft`` entries may be NaN."""
        jct = np.asarray(jct, dtype=np.float64)
        if jct.size == 0:
            return
        arrival = np.asarray(arrival, dtype=np.float64)
        self.sketch.add(jct)
        self.n += int(jct.size)
        self.qd_sum += float(np.sum(queuing_delay))
        self.preemptions += int(np.sum(n_preemptions))
        self.arr_min = min(self.arr_min, float(arrival.min()))
        self.fin_max = max(self.fin_max, float((arrival + jct).max()))
        t = np.asarray(ttft, dtype=np.float64)
        ok = ~np.isnan(t)
        self.ttft_sum += float(t[ok].sum())
        self.ttft_n += int(ok.sum())
        if self.slo_target is not None:
            self.slo_hits += int(np.sum(jct <= self.slo_target))

    def merge(self, other: "StreamingSummary") -> "StreamingSummary":
        """Fold ``other`` in (tenant -> global roll-ups).  ``slo_hits``
        merges raw; ``slo_attainment`` is only reported when *this*
        summary has a target of its own."""
        self.sketch.merge(other.sketch)
        self.n += other.n
        self.qd_sum += other.qd_sum
        self.ttft_sum += other.ttft_sum
        self.ttft_n += other.ttft_n
        self.preemptions += other.preemptions
        self.slo_hits += other.slo_hits
        self.arr_min = min(self.arr_min, other.arr_min)
        self.fin_max = max(self.fin_max, other.fin_max)
        self.pred_mae_sum += other.pred_mae_sum
        self.pred_mae_n += other.pred_mae_n
        self.pred_logbias_sum += other.pred_logbias_sum
        self.pred_bias_n += other.pred_bias_n
        return self

    # ------------------------------------------------------------------ #
    def summarize(self) -> Dict[str, float]:
        if self.n == 0:
            keys = ("jct_mean", "jct_p50", "jct_p99", "jct_min", "jct_max",
                    "queuing_delay_mean", "throughput_rps", "makespan",
                    "ttft_mean")
            out: Dict[str, float] = {k: 0.0 for k in keys}
            out["n"] = 0
            out["preemptions"] = 0
            if self.slo_target is not None:
                out["slo_attainment"] = 0.0
            return out
        makespan = self.fin_max - self.arr_min
        out = {
            "n": self.n,
            "jct_mean": self.sketch.mean,
            "jct_p50": self.sketch.quantile(0.50),
            "jct_p99": self.sketch.quantile(0.99),
            "jct_min": self.sketch.min,
            "jct_max": self.sketch.max,
            "queuing_delay_mean": self.qd_sum / self.n,
            "throughput_rps": self.n / max(makespan, 1e-9),
            "makespan": float(makespan),
            "preemptions": int(self.preemptions),
            "ttft_mean": (self.ttft_sum / self.ttft_n
                          if self.ttft_n else 0.0),
        }
        if self.slo_target is not None:
            out["slo_attainment"] = self.slo_hits / self.n
        if self.pred_mae_n:
            out["pred_mae_mean"] = self.pred_mae_sum / self.pred_mae_n
        if self.pred_bias_n:
            out["pred_bias_gmean"] = math.exp(
                self.pred_logbias_sum / self.pred_bias_n)
        return out
