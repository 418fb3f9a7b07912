"""Scheduling policies: FCFS, SJF (oracle one-shot), ISRTF (the paper's
contribution), and MLFQ (FastServe-style, for comparison).

A policy assigns each job a *priority* — smaller runs earlier.  ISRTF
re-predicts the remaining length every scheduling iteration (Algorithm 1
lines 11–14) through the distribution-aware
:func:`repro_torch.core.predictor.predict_lengths` entry point; with
``SchedulerConfig.risk_quantile`` set it ranks on a calibrated upper
quantile of each :class:`~repro_torch.core.predictor.LengthPrediction` instead
of the point estimate (risk-aware ISRTF — hedging against underestimates,
the head-of-line-blocking direction).

This module owns the whole scoring pipeline:

* :func:`score_pool` — ONE fused scoring pass per scheduling window over
  ``running + waiting`` (a single batched predictor dispatch through
  :func:`~repro_torch.core.predictor.predict_lengths`), split back into
  per-queue effective priorities by the caller;
* :func:`effective_priority` — the single source of truth for
  priority-class banding and anti-starvation aging (an aging term subtracts
  ``aging_rate * wait_seconds`` so long-waiting jobs eventually run
  regardless of length — paper §3.4);
* ``SchedulerConfig.repredict_every`` — ALISE-style prediction staleness:
  between full re-scores a job reuses its cached prediction minus the
  tokens it generated since it was last scored, so the encoder runs on a
  configurable cadence instead of every window.

Preemption either discards a victim's KV cache, rebuilt by a prefill
when it resumes, or swaps it to host memory and back
(``PreemptionConfig.policy``; :func:`decide_preempt` prices the two per
victim under ``auto``).  With ``SchedulerConfig.prefill_chunk`` set,
:func:`score_pool` ranks each job by its remaining output plus its
:func:`prefill_debt`.  With ``SchedulerConfig.rank_by = "rank_score"`` a
re-predicting policy orders the pool by the ranking head's
:attr:`~repro_torch.core.predictor.LengthPrediction.rank_score` instead.
"""
from __future__ import annotations

import heapq
import itertools
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.job import Job
from repro_torch.core.predictor import (LengthPrediction, Predictor,
                                        predict_lengths)


@dataclass
class SchedulerConfig:
    policy: str = "isrtf"  # fcfs | sjf | isrtf | mlfq
    #: tokens per scheduling iteration (paper: 50)
    window: int = 50
    #: max jobs per backend batch
    batch_size: int = 4
    #: aging: priority units (tokens) forgiven per second of waiting; 0 = off
    aging_rate: float = 0.0
    #: MLFQ quantum boundaries in generated tokens
    mlfq_levels: Tuple[int, ...] = (50, 200, 800)
    #: risk-aware ISRTF: rank on this calibrated upper quantile of the
    #: predicted remaining length instead of the point estimate — hedging
    #: against underestimates, which are the expensive direction (a long
    #: job predicted short runs early and head-of-line-blocks the truly
    #: short ones).  None = the paper's Algorithm 1 (rank on the mean);
    #: bit-identical traces to the scalar-predictor era.  Only policies
    #: that re-predict (ISRTF) consume it; the cluster layer's
    #: predicted-work accounting always uses the expectation, never the
    #: quantile (see ``cached_expected_remaining``).
    risk_quantile: Optional[float] = None
    #: run the length predictor every N scheduling windows (per node); in
    #: between, a job's cached prediction is decayed by the tokens it has
    #: generated since it was scored (ALISE-style staleness).  1 = the
    #: paper's Algorithm 1 (re-predict every window).  Only policies that
    #: re-predict (ISRTF) are affected; newly arrived jobs are always
    #: scored on first sight regardless of the stride.
    repredict_every: int = 1
    #: chunked prefill: split prompt ingestion into chunks of this many
    #: tokens, at most one chunk per scheduling window, interleaved with
    #: the running decodes (Sarathi-style stall removal — a long prompt no
    #: longer freezes every decode for a full window).  None = one-shot
    #: prefill.  When set, ISRTF ranks partially-prefilled jobs by *total*
    #: remaining work: predicted remaining output plus the unprefilled
    #: prompt tail (:func:`prefill_debt`).
    prefill_chunk: Optional[int] = None
    #: what a re-predicting policy ORDERS the pool by: ``"magnitude"`` (the
    #: calibrated mean, or its ``risk_quantile``) or ``"rank_score"`` (the
    #: learning-to-rank head's score — ISRTF only needs the order of
    #: remaining lengths, and a head trained to rank beats the point
    #: regressor at exactly that).  Requires predictions carrying
    #: :attr:`~repro_torch.core.predictor.LengthPrediction.rank_score` (a
    #: ranked predictor).  Either way ``Job.expected_remaining`` and all
    #: cluster predicted-work accounting stay on the calibrated mean — rank
    #: scores never leak into load totals (see ``cached_expected_remaining``).
    rank_by: str = "magnitude"


class Policy:
    """Base: FCFS."""

    name = "fcfs"
    #: True when the policy calls the predictor anew every window (ISRTF);
    #: such policies may reuse stale predictions between full re-scores
    repredicts = False
    #: True when ``priority`` is a predicted remaining *length* in tokens —
    #: only then do priorities feed the cluster layer's predicted-work
    #: accounting (FCFS/MLFQ priorities are timestamps/levels, not work)
    predicts_length = False

    def __init__(self, cfg: SchedulerConfig, predictor: Optional[Predictor]):
        self.cfg = cfg
        self.predictor = predictor

    def priority(self, job: Job, now: float) -> float:
        return job.arrival_time


class FCFSPolicy(Policy):
    name = "fcfs"


class SJFPolicy(Policy):
    """One-shot shortest-job-first: predict once at arrival, never update
    (Qiu et al. / the paper's oracle baseline when given OraclePredictor)."""

    name = "sjf"
    predicts_length = True

    def priority(self, job: Job, now: float) -> float:
        if job.priority is None:
            return float(self.predictor.init(job))
        # keep the arrival-time estimate: total predicted length minus
        # whatever has already been generated
        first = job.predictions[0] if job.predictions else job.priority
        return max(float(first) - job.tokens_generated, 0.0)


class ISRTFPolicy(Policy):
    """Iterative shortest-remaining-time-first (the paper's scheduler)."""

    name = "isrtf"
    repredicts = True
    predicts_length = True

    def priority(self, job: Job, now: float) -> float:
        if job.priority is None:
            return float(self.predictor.init(job))
        return float(self.predictor.iter(job))


class MLFQPolicy(Policy):
    """FastServe-style multi-level feedback queue on service received."""

    name = "mlfq"

    def priority(self, job: Job, now: float) -> float:
        level = 0
        for bound in self.cfg.mlfq_levels:
            if job.tokens_generated >= bound:
                level += 1
        # within a level, FCFS
        return level * 1e9 + job.arrival_time


POLICIES = {
    "fcfs": FCFSPolicy,
    "sjf": SJFPolicy,
    "isrtf": ISRTFPolicy,
    "mlfq": MLFQPolicy,
}

#: valid pool-ordering sources for re-predicting policies
RANK_BY = ("magnitude", "rank_score")


def make_policy(cfg: SchedulerConfig, predictor: Optional[Predictor]) -> Policy:
    try:
        cls = POLICIES[cfg.policy]
    except KeyError:
        raise ValueError(f"unknown policy {cfg.policy!r}") from None
    if cls in (SJFPolicy, ISRTFPolicy) and predictor is None:
        raise ValueError(f"{cfg.policy} requires a predictor")
    if cfg.rank_by not in RANK_BY:
        raise ValueError(
            f"unknown rank_by {cfg.rank_by!r} (choose one of {RANK_BY})")
    if cfg.rank_by == "rank_score" and cfg.risk_quantile is not None:
        raise ValueError(
            "rank_by='rank_score' and risk_quantile are mutually exclusive: "
            "the ranking head orders the pool directly, quantiles order "
            "magnitudes — pick one")
    return cls(cfg, predictor)


# --------------------------------------------------------------------------- #
# Scoring pipeline (Algorithm 1 lines 11–14, fused + strided)
# --------------------------------------------------------------------------- #


#: effective-priority penalty per priority class — large enough that class
#: bands never interleave for any realistic predicted length (tokens)
PRIORITY_CLASS_WEIGHT = 1e7


def effective_priority(cfg: SchedulerConfig, job: Job, raw: float,
                       now: float) -> float:
    """Raw priority -> effective priority: priority-class banding plus the
    anti-starvation aging credit.  The single implementation — both the
    frontend's batch path and any per-job caller go through here."""
    eff = raw + job.priority_class * PRIORITY_CLASS_WEIGHT
    if cfg.aging_rate > 0 and job.last_enqueue_time is not None:
        eff -= cfg.aging_rate * max(now - job.last_enqueue_time, 0.0)
    return eff


def prefill_debt(cfg: SchedulerConfig, job: Job) -> float:
    """Context tokens the backend still has to materialise before ``job``
    can decode: ``prompt + generated - prefilled``.  Zero whenever chunked
    prefill is off (``cfg.prefill_chunk is None``); with chunking on, this
    is the unprefilled prompt tail for a mid-prefill job and the full
    context for a recompute-evicted one.  Added to the *raw* priority at
    ranking time (never stored in ``job.priority`` — predictions stay pure
    remaining-output estimates)."""
    if cfg.prefill_chunk is None:
        return 0.0
    return float(max(
        len(job.prompt_tokens) + job.tokens_generated - job.prefilled_tokens,
        0))


def _rank_scores(preds: Sequence[LengthPrediction]) -> List[float]:
    """Pool ordering from the ranking head — loud when it isn't there."""
    out = []
    for p in preds:
        if p.rank_score is None:
            raise ValueError(
                "rank_by='rank_score' needs predictions carrying a "
                "rank_score — use a two-head ranked predictor "
                "(make_predictor('ranked', bge=...)); this predictor "
                "returned none")
        out.append(float(p.rank_score))
    return out


def score_jobs(policy: Policy, jobs: Sequence[Job], now: float) -> List[float]:
    """Fresh raw priorities for ``jobs`` — at most ONE predictor dispatch
    (batched through :func:`~repro_torch.core.predictor.predict_lengths`, the
    distribution-aware entry point).  A re-predicting policy ranks on the
    point estimate, or — with ``SchedulerConfig.risk_quantile`` set — on
    that calibrated upper quantile of each :class:`LengthPrediction`.

    Records each score on the job: ``priority`` (the value ranked on), the
    ``predictions`` history (one entry per scored window), the staleness
    watermark ``tokens_at_last_score``, and — for length-predicting
    policies — ``expected_remaining`` (always the expectation, which is
    what the cluster layer's predicted-work accounting consumes) plus the
    ``pred_trace`` used for per-request prediction-error stats."""
    if not jobs:
        return []
    pred = policy.predictor
    if policy.repredicts and pred is not None:
        preds = predict_lengths(pred, jobs)
        q = policy.cfg.risk_quantile
        if policy.cfg.rank_by == "rank_score":
            raw = _rank_scores(preds)
        elif q is None:
            raw = [p.mean for p in preds]
        else:
            raw = [p.quantile(q) for p in preds]
        means = [p.mean for p in preds]
    else:
        raw = [policy.priority(j, now) for j in jobs]
        means = raw
    for j, p, m in zip(jobs, raw, means):
        j.priority = p
        j.predictions.append(p)
        j.tokens_at_last_score = j.tokens_generated
        if policy.predicts_length:
            j.expected_remaining = m
            j.pred_trace.append((j.tokens_generated, m))
    return raw


def cached_raw_priority(job: Job) -> float:
    """The raw priority the current window's scoring pass used for ``job``:
    its cached prediction decayed by the tokens generated since it was last
    scored.  Right after a fresh score the decay is zero, so this is exact
    on full re-score windows and matches the stale-window reuse otherwise."""
    if job.tokens_at_last_score is None:
        return float(job.priority)
    return max(float(job.priority)
               - (job.tokens_generated - job.tokens_at_last_score), 0.0)


def cached_expected_remaining(job: Job) -> float:
    """The job's *expected* remaining length (progress-decayed), for the
    cluster layer's predicted-work accounting.  Identical to
    :func:`cached_raw_priority` when no risk quantile is set (the scoring
    value IS the expectation then); with risk-aware scoring the priority is
    an upper quantile, and balancing load on a sum of upper quantiles would
    systematically over-count — work accounting stays on the mean."""
    base = (job.expected_remaining if job.expected_remaining is not None
            else job.priority)
    if job.tokens_at_last_score is None:
        return float(base)
    return max(float(base)
               - (job.tokens_generated - job.tokens_at_last_score), 0.0)


def batch_effective(policy: Policy, jobs: Sequence[Job],
                    now: float) -> List[float]:
    """Score ``jobs`` fresh and return effective priorities (one fused
    predictor dispatch; see :func:`score_jobs`)."""
    raw = score_jobs(policy, jobs, now)
    return [effective_priority(policy.cfg, j, p, now)
            for j, p in zip(jobs, raw)]


def score_pool(policy: Policy, running: Sequence[Job], waiting: Sequence[Job],
               now: float, *, full: bool = True
               ) -> Tuple[List[float], List[float]]:
    """One fused scoring pass over a node's whole pool.

    Scores ``running + waiting`` in a single :func:`score_jobs` call — one
    predictor dispatch per scheduling window instead of two — and splits the
    effective priorities back into ``(run_eff, wait_eff)``.

    With ``full=False`` (a stride window between full re-scores, see
    ``SchedulerConfig.repredict_every``) a re-predicting policy reuses each
    job's cached prediction decayed by the tokens generated since it was
    scored; jobs that were never scored (new arrivals) still get a fresh,
    batched prediction.  Non-repredicting policies always score fresh —
    their ``priority`` is O(1) and must track arrival order / service level.
    """
    pool = list(running) + list(waiting)
    if full or not policy.repredicts:
        raw = score_jobs(policy, pool, now)
    else:
        fresh = [j for j in pool
                 if j.priority is None or j.tokens_at_last_score is None]
        fresh_raw = {id(j): p
                     for j, p in zip(fresh, score_jobs(policy, fresh, now))}
        raw = [fresh_raw[id(j)] if id(j) in fresh_raw
               else cached_raw_priority(j) for j in pool]
    eff = [effective_priority(policy.cfg, j, p + prefill_debt(policy.cfg, j),
                              now)
           for j, p in zip(pool, raw)]
    return eff[: len(running)], eff[len(running):]


# --------------------------------------------------------------------------- #
# PriorityBuffer (paper §4.1: one priority queue per backend node)
# --------------------------------------------------------------------------- #


class PriorityBuffer:
    def __init__(self):
        self._heaps: Dict[int, List] = {}
        self._count = itertools.count()

    def push(self, node: int, prio: float, job: Job) -> None:
        heapq.heappush(self._heaps.setdefault(node, []),
                       (prio, next(self._count), job))

    def pop_batch(self, node: int, k: int) -> List[Job]:
        heap = self._heaps.get(node, [])
        out = []
        while heap and len(out) < k:
            out.append(heapq.heappop(heap)[2])
        return out

    def depth(self, node: int) -> int:
        return len(self._heaps.get(node, []))


# --------------------------------------------------------------------------- #
# Preemption (paper §3.4 / Appendix A)
# --------------------------------------------------------------------------- #


@dataclass
class PreemptionConfig:
    """Knobs for 'adjusting the frequency of preemption' (paper §1, §3.4)."""

    enabled: bool = True
    #: a waiting job must beat a running job's priority by this many tokens
    #: (paper §3.4: preemption should be rare; one window's worth of tokens)
    margin: float = 50.0
    #: at most this fraction of a batch may be preempted per iteration
    max_fraction: float = 0.25
    #: what happens to a victim's KV cache (ALISE, arXiv 2410.23537):
    #: ``recompute`` discards it (resume pays a full re-prefill),
    #: ``swap`` copies it to host memory and back, ``auto`` picks per
    #: victim via the :func:`decide_preempt` break-even on the backend's
    #: (swap_s, recompute_s) estimates and the victim's predicted
    #: remaining length
    policy: str = "recompute"
    #: ``auto`` penalty per predicted-remaining token for *holding* a
    #: swapped cache in host memory — a job expected to run long after
    #: resume ties up host KV (and risks a second swap) longer, so the
    #: break-even tilts toward recompute for it
    swap_hold_s_per_token: float = 1e-3
    #: watermark (in stashed context tokens) bounding the live engine's
    #: host swap pool.  When a new swap-out would push the pool past the
    #: watermark, the COLDEST stashed victims (oldest swap-outs) are
    #: evicted to the recompute-fallback path with a loud once-per-engine
    #: warning; if the fresh stash alone exceeds the pool it is refused
    #: and the victim recomputes.  None = unbounded.  Threaded onto each
    #: engine by ``EngineExecutor``.
    swap_pool_tokens: Optional[int] = None


PREEMPT_POLICIES = ("recompute", "swap", "auto")


def decide_preempt(cfg: PreemptionConfig,
                   costs: Optional[Tuple[float, float]],
                   predicted_remaining: Optional[float]) -> str:
    """Resolve a victim's preemption treatment to ``"swap"`` or
    ``"recompute"``.  ``costs`` is the backend's ``(swap_round_trip_s,
    recompute_s)`` estimate (None = backend can't price it → recompute);
    ``predicted_remaining`` feeds the hold-cost term under ``auto``."""
    if cfg.policy not in PREEMPT_POLICIES:
        raise ValueError(
            f"unknown preempt policy {cfg.policy!r}; "
            f"choose one of {PREEMPT_POLICIES}")
    if cfg.policy != "auto":
        return cfg.policy
    if costs is None:
        return "recompute"
    swap_s, rec_s = costs
    r_hat = max(float(predicted_remaining or 0.0), 0.0)
    return ("swap"
            if swap_s + cfg.swap_hold_s_per_token * r_hat < rec_s
            else "recompute")


def select_fills(waiting_eff: Sequence[float], free: int) -> List[int]:
    """Indices into a waiting queue to dispatch into ``free`` slots,
    best-first: ordered by (effective priority, queue position) — queue
    position breaks ties so equal-priority jobs dispatch in enqueue order.

    The single fill-selection rule of ``ELISFrontend._form_batch``."""
    if free <= 0 or not waiting_eff:
        return []
    order = sorted(range(len(waiting_eff)),
                   key=lambda k: (waiting_eff[k], k))
    return order[:free]


def select_preemptions(
    running: Sequence[Tuple[float, Job]],
    waiting: Sequence[Tuple[float, Job]],
    cfg: PreemptionConfig,
) -> List[Tuple[Job, Job]]:
    """Given (priority, job) for the running batch and the waiting queue,
    return [(victim, replacement), ...] — lowest-priority running jobs are
    displaced by strictly-higher-priority waiters (vLLM's priority preemption
    with our margin/frequency knobs)."""
    if not cfg.enabled or not running or not waiting:
        return []
    # ceiling, not floor: int() would zero the budget for any running batch
    # of <= 1/max_fraction jobs, silently disabling preemption at small
    # batch sizes (e.g. <= 3 running at the default 0.25); an enabled
    # policy with a positive fraction can always displace one victim
    budget = math.ceil(len(running) * cfg.max_fraction)
    victims = sorted(running, key=lambda t: -t[0])  # worst running first
    claimants = sorted(waiting, key=lambda t: t[0])  # best waiting first
    swaps: List[Tuple[Job, Job]] = []
    for (rp, rjob), (wp, wjob) in zip(victims, claimants):
        if len(swaps) >= budget:
            break
        if wp + cfg.margin < rp:
            swaps.append((rjob, wjob))
    return swaps
