"""Job records managed by the ELIS frontend (paper §4.1).

A *job* is the scheduler-internal record of one prompt: its text/tokens, the
backend node it was balanced onto, its current priority (predicted remaining
tokens), the partial response accumulated over scheduling iterations, and the
timestamps from which JCT / queuing delay are computed.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, List, Optional

if TYPE_CHECKING:
    from repro_torch.core.api import TokenChunk


class JobState(enum.Enum):
    WAITING = "waiting"      # in JobPool, not yet dispatched this iteration
    RUNNING = "running"      # inside a backend batch
    PREEMPTED = "preempted"  # evicted mid-generation; resumes from tokens
    FINISHED = "finished"
    CANCELLED = "cancelled"  # caller cancelled; slot released
    EXPIRED = "expired"      # deadline passed before completion


#: states a job never leaves
TERMINAL_STATES = frozenset(
    {JobState.FINISHED, JobState.CANCELLED, JobState.EXPIRED}
)


@dataclass
class Job:
    job_id: int
    prompt: str
    prompt_tokens: List[int]
    arrival_time: float
    #: ground-truth response length — known to the generator/oracle only
    true_output_len: int = 0
    #: precomputed response token stream (the simulator replays it)
    output_tokens: List[int] = field(default_factory=list)

    node: int = -1
    state: JobState = JobState.WAITING
    #: scheduler priority = predicted remaining tokens (lower runs first)
    priority: Optional[float] = None
    #: prediction history, one entry per scored scheduling iteration
    #: (paper Fig. 2; every window at ``repredict_every=1``)
    predictions: List[float] = field(default_factory=list)
    #: ``tokens_generated`` at the last fresh score — between full re-scores
    #: (``SchedulerConfig.repredict_every``) the scheduler reuses
    #: ``priority - (tokens_generated - tokens_at_last_score)``
    tokens_at_last_score: Optional[int] = None
    #: expected remaining length from the last score.  Equal to ``priority``
    #: unless risk-aware scoring is on (then ``priority`` is an upper
    #: quantile); the cluster layer's predicted-work accounting always
    #: consumes this expectation, never the quantile
    expected_remaining: Optional[float] = None
    #: (tokens_generated, expected_remaining) at each scored window — the
    #: realised-vs-predicted trace behind per-request prediction-error
    #: stats (``Response.pred_mae`` / ``pred_bias``); only populated by
    #: length-predicting policies (SJF/ISRTF)
    pred_trace: List[tuple] = field(default_factory=list)
    #: tokens of context currently materialised in the backend's KV cache
    #: for this job (prompt + generated).  Mid-chunked-prefill it lags
    #: ``len(prompt_tokens)``; a recompute-eviction resets it to 0 while a
    #: KV swap-out preserves it.  ``prefill_debt`` (scheduler) and the
    #: swap-vs-recompute break-even both read this cursor.
    prefilled_tokens: int = 0

    generated: List[int] = field(default_factory=list)
    finished: bool = False

    # request-lifecycle fields (populated from api.RequestOptions)
    #: absolute deadline on the serving clock; None = no deadline
    deadline: Optional[float] = None
    tenant: str = "default"
    #: coarse priority band (lower outranks higher regardless of length)
    priority_class: int = 0
    #: caller asked for cancellation; honoured at the next window boundary
    cancel_requested: bool = False
    #: retain per-iteration TokenChunks for a streaming consumer (bounded
    #: memory: non-streaming jobs keep only the flat ``generated`` list)
    stream: bool = False
    #: per-iteration token emissions, populated only when ``stream`` is set
    chunks: List["TokenChunk"] = field(default_factory=list)

    # timing
    first_dispatch_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    #: cumulative time spent waiting in the JobPool while not executing
    queuing_delay: float = 0.0
    last_enqueue_time: Optional[float] = None
    n_preemptions: int = 0
    #: times the rebalancer moved this job to another node while queued
    n_migrations: int = 0
    n_iterations: int = 0

    @property
    def tokens_generated(self) -> int:
        return len(self.generated)

    @property
    def true_remaining(self) -> int:
        return max(self.true_output_len - self.tokens_generated, 0)

    def jct(self) -> float:
        assert self.finish_time is not None
        return self.finish_time - self.arrival_time

    def record_enqueue(self, now: float) -> None:
        self.last_enqueue_time = now

    def record_dispatch(self, now: float) -> None:
        if self.first_dispatch_time is None:
            self.first_dispatch_time = now
        if self.last_enqueue_time is not None:
            self.queuing_delay += max(now - self.last_enqueue_time, 0.0)
            self.last_enqueue_time = None
