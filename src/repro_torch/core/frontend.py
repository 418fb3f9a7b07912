"""ELIS frontend scheduler — Algorithm 1 as a *steppable* event loop.

One implementation drives both backends:
  * the cluster simulator (:class:`repro_torch.simulate.SimExecutor`):
    virtual time and the calibrated per-model latency model;
  * the live engine (:class:`repro_torch.engine.EngineExecutor`): real
    decode windows, wall clock measured and fed back as event durations.

Semantics (faithful to the paper):
  * iteration-level batching with a fixed window of K=50 tokens;
  * ONE fused scoring pass per window: ``running + waiting`` are scored in
    a single :func:`repro_torch.core.scheduler.score_pool` call (one batched,
    shape-bucketed predictor dispatch), split back into per-queue
    priorities; ``SchedulerConfig.repredict_every`` stretches the encoder
    cadence — between full re-scores a job reuses its cached prediction
    decayed by the tokens generated since it was scored;
  * per-node waiting queues; pluggable placement at arrival
    (``FrontendConfig.placement``): greedy min-job-count (``least_jobs``,
    the paper's line 3), outstanding-predicted-tokens balancing
    (``least_predicted_work``), or per-node drain-time estimation over the
    calibrated latency profile (``least_eta``, which reads the now-live
    ``GlobalState.busy_until`` horizon);
  * optional cross-node rebalancing (``FrontendConfig.rebalance``): at each
    ``node_free`` event an under-loaded node steals the best queued jobs
    from the most-loaded node's waiting queue when the predicted-work
    imbalance exceeds a threshold — queued-only migration, so nothing with
    live KV state moves (a migrated PREEMPTED job abandons its old node's
    KV and pays the usual recompute on dispatch);
  * slot *stickiness*: a running job keeps its batch slot until it finishes —
    unless the preemption policy displaces it (FCFS ⇒ non-preemptive ORCA
    behaviour; ISRTF ⇒ priority preemption at window boundaries with
    margin/frequency knobs);
  * displaced jobs are evicted and pay a KV recompute when they next run,
    or keep their KV in host memory (``PreemptionConfig.policy`` swap /
    auto) and swap it back in;
  * prompts are sent to the backend once (re-dispatch is metadata-only).

Online extensions (paper §4.1, "continuously admits requests"):
  * the event heap is **resumable** — ``step``/``run_until`` interleave with
    late ``submit``/``cancel`` calls instead of the drain-once ``run``;
  * cancellation and deadline expiry flow through the scheduler: the job is
    evicted from its backend (releasing the slot) and surfaces as a terminal
    ``CANCELLED``/``EXPIRED`` state; expiry is enforced at the window
    boundary — tokens a window would deliver past the deadline are dropped,
    so no job ever finishes with ``finish_time > deadline``;
  * every window emits per-job :class:`~repro_torch.core.api.TokenChunk`\\ s, the
    unit of streaming.
"""
from __future__ import annotations

import abc
import heapq
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.api import TokenChunk
from repro_torch.core.job import TERMINAL_STATES, Job, JobState
from repro_torch.core.load_balancer import GlobalState, LoadBalancer, make_placement
from repro_torch.core.predictor import Predictor
from repro_torch.core.scheduler import (
    PRIORITY_CLASS_WEIGHT,
    PreemptionConfig,
    SchedulerConfig,
    batch_effective,
    cached_expected_remaining,
    cached_raw_priority,
    effective_priority,
    decide_preempt,
    make_policy,
    prefill_debt,
    score_pool,
    select_fills,
    select_preemptions,
)

__all__ = [
    "Backend", "ELISFrontend", "Event", "ExecResult", "FrontendConfig",
    # re-exported for callers that import these from here; they live in
    # repro_torch.core.scheduler
    "PRIORITY_CLASS_WEIGHT", "batch_effective",
]


class ExecResult:
    def __init__(self, duration: float, tokens: List[List[int]],
                 finished: List[bool]):
        self.duration = duration
        self.tokens = tokens
        self.finished = finished


class Backend(abc.ABC):
    """Execution backend behind the frontend (simulator or live engine).

    ``execute`` runs one scheduling window for a batch and reports the new
    tokens (which the frontend re-emits as per-window ``TokenChunk``\\ s);
    ``evict`` releases a job's backend residency (finish / preemption /
    cancellation / expiry all route through it); ``free_capacity`` bounds
    batch admissions when the backend is tighter than the configured batch
    size (``capacity`` is the static counterpart, for introspection).
    """

    @abc.abstractmethod
    def execute(self, node: int, jobs: Sequence[Job], window: int,
                now: float) -> ExecResult: ...

    @abc.abstractmethod
    def evict(self, node: int, job: Job) -> None: ...

    def offload(self, node: int, job: Job) -> bool:
        """Preempt ``job`` but *keep* its KV by swapping it to host memory
        (ALISE tier).  Returns False when the backend cannot swap (no
        cache, unsupported family) — the caller then falls back to
        :meth:`evict` + recompute-on-resume.  Backends that support it
        must restore the cache transparently when the job is next
        executed."""
        return False

    def restore(self, node: int, job: Job) -> bool:
        """Explicitly swap a previously offloaded job's KV back in.
        Optional — ``execute`` must restore lazily regardless."""
        return False

    def preempt_costs(self, node: int, job: Job
                      ) -> Optional[Tuple[float, float]]:
        """(swap_round_trip_s, recompute_s) estimates for preempting
        ``job`` — the ``auto`` preempt policy's break-even input.  None =
        the backend cannot price the trade (caller recomputes)."""
        return None

    def capacity(self, node: int) -> Optional[int]:
        """Max concurrent jobs node can hold; None = unbounded."""
        return None

    def free_capacity(self, node: int) -> Optional[int]:
        """Currently free job slots on ``node``; None = unbounded."""
        return None

    def counters(self) -> Dict[str, int]:
        """Backend-specific compile/dispatch counters for introspection
        (e.g. the live engine's recompile-storm hooks); {} = none."""
        return {}


@dataclass(frozen=True)
class Event:
    """One observable lifecycle transition, emitted by ``step``."""

    t: float
    #: arrival | tokens | preempted | migrated | finished | cancelled | expired
    kind: str
    job_id: int
    chunk: Optional[TokenChunk] = None


@dataclass
class FrontendConfig:
    n_nodes: int = 1
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    preemption: PreemptionConfig = field(default_factory=PreemptionConfig)
    #: placement policy at arrival: least_jobs | least_predicted_work |
    #: least_eta (see repro_torch.core.load_balancer)
    placement: str = "least_jobs"
    #: seconds per generated token per node, for ``least_eta`` on
    #: heterogeneous clusters (None = uniform nodes)
    node_token_cost: Optional[Dict[int, float]] = None
    #: enable cross-node work-stealing of queued jobs at node_free events
    rebalance: bool = False
    #: predicted-work imbalance (tokens) that triggers stealing
    rebalance_threshold: float = 200.0
    #: cap on jobs stolen per node_free event
    max_migrations_per_free: int = 4
    #: feed the predictor ground-truth remaining length on EVERY window
    #: (``predictor.observe``) — exact in trace replay / simulation, where
    #: ``true_output_len`` is the realised length.  A live engine only
    #: learns a request's length at its finish, so the serving launcher
    #: turns this off and calibration runs on finish observations alone.
    observe_in_flight: bool = True


class ELISFrontend:
    def __init__(self, cfg: FrontendConfig, predictor: Optional[Predictor],
                 executor: Backend):
        self.cfg = cfg
        self.policy = make_policy(cfg.scheduler, predictor)
        self.executor = executor
        #: online-feedback hook (no-op on raw predictors, residual/bias
        #: updates on calibration wrappers); None for predictor-less
        #: policies and legacy predictor objects
        self._observe = getattr(predictor, "observe", None)
        self.state = GlobalState(cfg.n_nodes)
        self.balancer = LoadBalancer(
            self.state, make_placement(cfg.placement, cfg.node_token_cost))
        #: rebalancing is meaningful only across nodes
        self._rebalance_active = cfg.rebalance and cfg.n_nodes > 1
        #: predicted-work accounting has a consumer
        self._track_work = (self.balancer.placement.uses_work
                            or self._rebalance_active)
        if self._track_work and predictor is None:
            # without length predictions, work-aware placement degrades to
            # the count tie-break and the rebalancer never finds work to
            # steal — fail loudly instead of silently measuring least_jobs
            raise ValueError(
                f"placement={cfg.placement!r}"
                f"{' with rebalance' if self._rebalance_active else ''} "
                f"requires a predictor (got None)")
        #: cross-node migrations performed by the rebalancing pass
        self.migrations = 0
        # per-node structures
        self.waiting: Dict[int, List[Job]] = {n: [] for n in range(cfg.n_nodes)}
        self.running: Dict[int, List[Job]] = {n: [] for n in range(cfg.n_nodes)}
        self.node_busy: Dict[int, bool] = {n: False for n in range(cfg.n_nodes)}
        #: scheduling windows formed per node — drives the re-prediction
        #: stride (``SchedulerConfig.repredict_every``)
        self._windows: Dict[int, int] = {n: 0 for n in range(cfg.n_nodes)}
        self.finished: List[Job] = []
        #: cancelled + expired jobs (terminal but not FINISHED)
        self.terminated: List[Job] = []
        self.jobs: Dict[int, Job] = {}
        self.now: float = 0.0
        self._events: List[Tuple[float, int, int, str, object]] = []
        self._seq = itertools.count()
        #: lifecycle events produced outside step() (e.g. immediate cancels),
        #: flushed into the next step()/run_until() return value
        self._side_events: List[Event] = []

    #: tie-break at equal timestamps: arrivals land before deadline checks,
    #: which land before node scheduling — so a job arriving exactly when a
    #: node frees is schedulable in that very window, regardless of whether
    #: it was submitted before or after the simulation started (this keeps
    #: interleaved step()/submit() traces identical to drain-once runs)
    _KIND_RANK = {"arrival": 0, "deadline": 1, "node_free": 2}

    # ------------------------------------------------------------------ #
    def _push_event(self, t: float, kind: str, data) -> None:
        heapq.heappush(self._events,
                       (t, self._KIND_RANK[kind], next(self._seq), kind, data))

    def submit(self, job: Job) -> None:
        """Admit a job.  May be called at any point — before, between, or
        after ``step``/``run_until`` calls.  Arrivals dated before the
        current clock are admitted at the current clock."""
        self.jobs[job.job_id] = job
        t = max(job.arrival_time, self.now)
        self._push_event(t, "arrival", job)
        if job.deadline is not None:
            self._push_event(max(job.deadline, t), "deadline", job)

    def cancel(self, job_id: int) -> bool:
        """Cancel a live job.  Waiting (or not-yet-arrived) jobs terminate
        immediately; running jobs are evicted at the next window boundary.
        Returns False for unknown or already-terminal jobs."""
        job = self.jobs.get(job_id)
        if job is None or job.state in TERMINAL_STATES:
            return False
        node = job.node
        if node >= 0 and job in self.waiting.get(node, ()):
            self.waiting[node].remove(job)
            self._terminate(job, node, JobState.CANCELLED, self.now,
                            self._side_events)
        else:
            # running (evicted when its node next schedules) or not yet
            # arrived (terminated at its arrival event)
            job.cancel_requested = True
        return True

    def forget(self, job_id: int) -> bool:
        """Drop a *terminal* job's record (long-lived servers release
        completed requests to bound memory).  Returns False if the job is
        unknown or still live."""
        job = self.jobs.get(job_id)
        if job is None or job.state not in TERMINAL_STATES:
            return False
        del self.jobs[job_id]
        if job in self.finished:
            self.finished.remove(job)
        elif job in self.terminated:
            self.terminated.remove(job)
        return True

    # ------------------------------------------------------------------ #
    def pending(self) -> int:
        """Unprocessed scheduler events."""
        return len(self._events)

    def next_event_time(self) -> Optional[float]:
        return self._events[0][0] if self._events else None

    def step(self, now: Optional[float] = None) -> List[Event]:
        """Process the single next event.  With ``now`` given, only events
        due by ``now`` are processed (and the clock advances to at most
        ``now``).  Returns the lifecycle events the step produced."""
        out: List[Event] = []
        if self._side_events:
            out.extend(self._side_events)
            self._side_events.clear()
        if not self._events:
            return out
        if now is not None and self._events[0][0] > now:
            self.now = max(self.now, now)
            return out
        t, _, _, kind, data = heapq.heappop(self._events)
        self.now = max(self.now, t)
        if kind == "arrival":
            self._on_arrival(data, t, out)
        elif kind == "node_free":
            self._on_node_free(data, t, out)
        elif kind == "deadline":
            self._on_deadline(data, t, out)
        return out

    def run_until(self, t: float) -> List[Event]:
        """Process every event due by ``t`` and advance the clock to ``t``."""
        out: List[Event] = []
        while self._events and self._events[0][0] <= t:
            out.extend(self.step())
        out.extend(self._side_events)
        self._side_events.clear()
        self.now = max(self.now, t)
        return out

    def run(self) -> List[Job]:
        """Drain every pending event (legacy closed-loop mode) and return
        the finished jobs."""
        while self._events:
            self.step()
        return self.finished

    # ------------------------------------------------------------------ #
    def _terminate(self, job: Job, node: int, state: JobState, t: float,
                   out: List[Event]) -> None:
        """Move a non-finished job to a terminal state, releasing its
        backend residency and its load-balancer count."""
        assert job.state not in TERMINAL_STATES
        job.state = state
        job.finish_time = t
        job.cancel_requested = False
        self.executor.evict(node, job)
        # retract the live count AND the predicted-work contribution — a job
        # cancelled/expired while still queued (never dispatched) must not
        # leave phantom work behind (GlobalState totals return to zero once
        # everything is terminal)
        self.state.finish_job(node, job.job_id)
        self.terminated.append(job)
        if self._observe is not None:
            # notify the calibrator so it drops the job's pending residuals
            # (CANCELLED/EXPIRED lengths are censored — never learned from)
            self._observe(job, 0.0)
        out.append(Event(t, state.value, job.job_id))

    def _on_arrival(self, job: Job, now: float, out: List[Event]) -> None:
        if job.cancel_requested:
            # cancelled (or expired) before it ever reached a node
            expired = job.deadline is not None and now >= job.deadline
            job.state = (JobState.EXPIRED if expired else JobState.CANCELLED)
            job.finish_time = now
            job.cancel_requested = False
            self.terminated.append(job)
            out.append(Event(now, job.state.value, job.job_id))
            return
        node = self.balancer.assign(job, self._arrival_estimate(job), now)
        job.state = JobState.WAITING
        job.record_enqueue(now)
        self.waiting[node].append(job)
        out.append(Event(now, "arrival", job.job_id))
        if not self.node_busy[node]:
            self._push_event(now, "node_free", node)
            self.node_busy[node] = True  # claimed; released when truly idle

    def _on_deadline(self, job: Job, now: float, out: List[Event]) -> None:
        if job.state in TERMINAL_STATES:
            return
        node = job.node
        if node >= 0 and job in self.waiting.get(node, ()):
            self.waiting[node].remove(job)
            self._terminate(job, node, JobState.EXPIRED, now, out)
        elif node >= 0 and job in self.running.get(node, ()):
            self.running[node].remove(job)
            self._terminate(job, node, JobState.EXPIRED, now, out)
        else:
            # not yet arrived: expire at its arrival event
            job.cancel_requested = True

    def _arrival_estimate(self, job: Job) -> float:
        """Predicted response length at arrival, for placement/rebalancing.

        Only spent when something consumes predicted work (a work-aware
        placement policy or the rebalancer) AND a predictor is available —
        ``least_jobs`` without rebalancing therefore never touches the
        predictor at arrival, which keeps its traces bit-identical to the
        pre-cluster-layer balancer (stochastic predictors draw RNG per
        call, in call order).  The ordering policy need not consume
        predictions itself: prediction-aware *placement* over FCFS nodes
        (Qiu et al.'s proxy-model setting) is exactly ``policy=fcfs`` plus
        a predictor here.
        """
        if not self._track_work:
            return 0.0
        pred = self.policy.predictor
        if pred is None:
            return 0.0
        from repro_torch.core.predictor import predict_lengths

        # the *expectation* (debiased when a calibration wrapper is
        # composed in) — work-aware placement balances expected tokens
        return max(predict_lengths(pred, [job])[0].mean, 0.0)

    def _rebalance(self, node: int, now: float, out: List[Event]) -> None:
        """Work-stealing at a ``node_free`` event: while the most-loaded
        node's predicted-work backlog exceeds ours by more than the
        threshold, steal its best queued job (the one its ISRTF order would
        run next).  Queued-only migration — RUNNING jobs never move, so no
        live KV state crosses nodes; a stolen PREEMPTED job abandons its
        old node's cache and pays the normal recompute at dispatch."""
        cfg = self.cfg
        work = self.state.predicted_work
        for _ in range(cfg.max_migrations_per_free):
            # consider sources most-loaded first: the max node may hold all
            # its work in RUNNING jobs (nothing stealable), while a lesser
            # but still over-threshold node has a queue to relieve
            best = None
            for src in sorted(work, key=lambda n: (-work[n], n)):
                gap = work[src] - work[node]
                if src == node or gap <= cfg.rebalance_threshold:
                    break  # descending order: no further source qualifies
                for job in self.waiting[src]:
                    w = self.state.work_of(job.job_id)
                    # moving must strictly shrink the gap (0 < w < gap)
                    if 0.0 < w < gap and (best is None or w < best[0]):
                        best = (w, job)
                if best is not None:
                    break
            if best is None:
                return
            _, job = best
            src = job.node
            self.waiting[src].remove(job)
            if job.state is JobState.PREEMPTED:
                # its KV residue on the old node is dead weight — release it
                self.executor.evict(src, job)
            job.node = node
            self.state.move_job(job.job_id, node)
            self.waiting[node].append(job)
            job.n_migrations += 1
            self.migrations += 1
            out.append(Event(now, "migrated", job.job_id))

    def _wake_idle_nodes(self, node: int, now: float) -> None:
        """Give idle peers a chance to steal from our leftover queue (their
        own ``node_free`` streams stop once they drain).  Only peers whose
        predicted-work gap to us clears the steal threshold are woken —
        anything closer would scan the queues and do nothing."""
        work = self.state.predicted_work
        for m in self.node_busy:
            if not self.node_busy[m] \
                    and work[node] - work[m] > self.cfg.rebalance_threshold:
                self._push_event(now, "node_free", m)
                self.node_busy[m] = True

    def _sweep_cancelled(self, node: int, now: float,
                         out: List[Event]) -> None:
        """Honour cancel requests against running jobs (window boundary)."""
        for job in list(self.running[node]):
            if job.cancel_requested:
                self.running[node].remove(job)
                self._terminate(job, node, JobState.CANCELLED, now, out)

    def _on_node_free(self, node: int, now: float, out: List[Event]) -> None:
        self._sweep_cancelled(node, now, out)
        if self._rebalance_active:
            self._rebalance(node, now, out)
        batch = self._form_batch(node, now, out)
        if not batch:
            self.node_busy[node] = False
            return
        pc = self.cfg.scheduler.prefill_chunk
        if pc is not None:
            # kwarg only when configured: Backend.execute's positional
            # signature is unchanged for chunk-unaware backends
            res = self.executor.execute(node, batch,
                                        self.cfg.scheduler.window, now,
                                        prefill_chunk=pc)
        else:
            res = self.executor.execute(node, batch,
                                        self.cfg.scheduler.window, now)
        end = now + res.duration
        # the horizon this window runs to — least_eta placement reads it
        self.state.note_busy(node, end)
        for job, toks, fin in zip(batch, res.tokens, res.finished):
            if job.deadline is not None and end > job.deadline:
                # the window straddles the deadline: its tokens materialise
                # at the window boundary ``end``, i.e. past the deadline —
                # drop them and expire the job at the deadline instead of
                # letting it FINISH with finish_time > deadline (the pending
                # deadline event would fire too late to stop that)
                self.running[node].remove(job)
                self._terminate(job, node, JobState.EXPIRED, job.deadline,
                                out)
                continue
            job.generated.extend(toks)
            # progress-based decay of the job's predicted-work contribution
            # (kept fresh between scoring refreshes; the next scoring pass
            # overwrites it with the policy's own remaining-length estimate
            # when the policy predicts lengths)
            if toks and self.state.work_of(job.job_id) > 0:
                self.state.set_work(
                    job.job_id,
                    max(self.state.work_of(job.job_id) - len(toks), 0.0))
            iteration = job.n_iterations
            job.n_iterations += 1
            if job.first_token_time is None and toks:
                job.first_token_time = end
            if toks or fin:
                chunk = TokenChunk(request_id=job.job_id,
                                   tokens=tuple(toks), index=iteration,
                                   t=end, final=fin)
                if job.stream:
                    job.chunks.append(chunk)
                out.append(Event(end, "tokens", job.job_id, chunk))
            if fin:
                job.finished = True
                job.state = JobState.FINISHED
                job.finish_time = end
                self.finished.append(job)
                self.running[node].remove(job)
                self.state.finish_job(node, job.job_id)
                self.executor.evict(node, job)
                if self._observe is not None:
                    # finish reveals the exact length: resolve every logged
                    # prediction into a residual (actual_remaining == 0)
                    self._observe(job, 0.0)
                out.append(Event(end, "finished", job.job_id))
            elif (self._observe is not None and self.cfg.observe_in_flight
                  and job.true_output_len > 0):
                # mid-flight ground truth (trace replay / simulation only —
                # see FrontendConfig.observe_in_flight): calibrators adapt
                # within a window or two instead of waiting for finishes
                self._observe(job, float(job.true_remaining))
        self._push_event(end, "node_free", node)
        self.node_busy[node] = True
        if self._rebalance_active and self.waiting[node]:
            self._wake_idle_nodes(node, now)

    # ------------------------------------------------------------------ #
    def _form_batch(self, node: int, now: float,
                    out: List[Event]) -> List[Job]:
        cap = self.cfg.scheduler.batch_size
        running = self.running[node]
        waiting = self.waiting[node]
        if not running and not waiting:
            return []

        # ONE fused predictor pass over running + waiting per window (two
        # separate dispatches would double the per-window predictor latency
        # sitting on the scheduling critical path); every repredict_every-th
        # window is a full re-score, in between cached predictions are
        # decayed by progress (new arrivals are still scored fresh)
        widx = self._windows[node]
        self._windows[node] = widx + 1
        stride = max(self.cfg.scheduler.repredict_every, 1)
        run_eff, wait_eff = score_pool(self.policy, running, waiting, now,
                                       full=(widx % stride == 0))
        # step 2 reuses these (no second scoring pass)
        eff = {j.job_id: e for j, e in zip(waiting, wait_eff)}

        # refresh the cluster layer's predicted-work view from the raw
        # (un-banded, un-aged) remaining-length scores this window used —
        # skipped entirely when nothing consumes predicted work (default
        # least_jobs placement without rebalancing keeps the original hot path)
        # (the *expectation*, not the risk quantile — summing upper
        # quantiles across a node would systematically over-count its load)
        if self._track_work and self.policy.predicts_length:
            for j in running:
                self.state.set_work(
                    j.job_id, max(cached_expected_remaining(j), 0.0))
            for j in waiting:
                self.state.set_work(
                    j.job_id, max(cached_expected_remaining(j), 0.0))

        # backend capacity snapshot BEFORE preemption: a preemption is
        # net-zero on residency (victim evicted now, replacement occupies
        # the slot at dispatch), so reading free_capacity after the
        # evictions would double-count the freed slots and overfill the
        # backend
        fc = getattr(self.executor, "free_capacity", None)
        backend_free = fc(node) if fc is not None else None

        # 1. preemption: displace low-priority running jobs (margin-gated)
        swaps = select_preemptions(
            list(zip(run_eff, running)), list(zip(wait_eff, waiting)),
            self.cfg.preemption,
        )
        pcfg = self.cfg.preemption
        for victim, repl in swaps:
            running.remove(victim)
            victim.state = JobState.PREEMPTED
            victim.n_preemptions += 1
            victim.record_enqueue(now)
            waiting.append(victim)
            # swap-vs-recompute (PreemptionConfig.policy): costs are priced
            # BEFORE the offload/evict mutates the victim's cache state
            mode = "recompute"
            if pcfg.policy != "recompute":
                mode = decide_preempt(
                    pcfg, self.executor.preempt_costs(node, victim),
                    cached_expected_remaining(victim))
            if mode == "swap" and not self.executor.offload(node, victim):
                mode = "recompute"  # backend can't swap this job
            if mode == "recompute":
                self.executor.evict(node, victim)
            out.append(Event(now, "preempted", victim.job_id))
            # freshly re-enqueued at ``now`` ⇒ zero aging: re-band the same
            # (possibly stale-decayed) raw priority this window's scoring
            # pass used — NOT the undecayed cached prediction, which would
            # rank the victim inconsistently against stale-scored waiters.
            # The prefill debt is re-read AFTER the evict/offload above: a
            # recompute-evicted victim's debt is its whole context, a
            # swapped one's is unchanged
            eff[victim.job_id] = effective_priority(
                self.cfg.scheduler, victim,
                cached_raw_priority(victim)
                + prefill_debt(self.cfg.scheduler, victim), now)
            eff.pop(repl.job_id, None)
            waiting.remove(repl)
            repl.state = JobState.RUNNING
            repl.record_dispatch(now)
            running.append(repl)

        # 2. fill free slots with the best remaining waiters, reusing the
        #    step-1 priorities (membership changes were patched in above);
        #    the backend's own capacity bounds admissions when it is tighter
        #    than the configured batch size
        free = cap - len(running)
        if backend_free is not None:
            free = min(free, backend_free)
        if free > 0 and waiting:
            picks = select_fills([eff[job.job_id] for job in waiting], free)
            for job in [waiting[k] for k in picks]:
                waiting.remove(job)
                job.state = JobState.RUNNING
                job.record_dispatch(now)
                running.append(job)
        return list(running)
