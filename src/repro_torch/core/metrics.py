"""JCT / queuing-delay / throughput metrics (paper §6 evaluation).

:func:`summarize` aggregates a list of finished Job/Response records (all
percentile families in one ``np.percentile`` call); :func:`prediction_stats`
gives one request's prediction error; :func:`summarize_by_tenant` and
:func:`fairness_ratio` break a multi-tenant run down by tenant;
:func:`improvement` and :func:`kendall_tau` compare runs and rankings.
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
