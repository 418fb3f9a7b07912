"""Public serving API — the online request lifecycle (paper §4.1).

The ELIS paper describes a cloud-native scheduler that admits requests
continuously.  This module is that public surface: callers construct
:class:`Request` objects, submit them to an :class:`ElisServer`, and get back
opaque :class:`RequestHandle`\\ s.  Results surface as :class:`TokenChunk`
streams (one chunk per scheduling iteration) and terminal
:class:`Response` records.  The scheduler-internal ``Job`` is an
implementation detail constructed *from* a ``Request`` — it is never handed
back to callers.

Lifecycle::

    QUEUED -> RUNNING <-> PREEMPTED -> FINISHED
                   \\-> CANCELLED (caller)  |  EXPIRED (deadline)

The server is *steppable*: ``submit`` / ``cancel`` / ``step`` / ``run_until``
may be interleaved freely over the live engine's executor.
"""
from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import (
    TYPE_CHECKING,
    Dict,
    Iterator,
    List,
    Optional,
    Sequence,
    Tuple,
)

from repro_torch.core.job import Job, JobState

if TYPE_CHECKING:  # avoid a circular import (frontend imports TokenChunk)
    from repro_torch.core.frontend import ELISFrontend, Event, FrontendConfig
    from repro_torch.core.predictor import Predictor


class RequestStatus(enum.Enum):
    """Externally visible request state (terminal states are final)."""

    QUEUED = "queued"
    RUNNING = "running"
    PREEMPTED = "preempted"
    FINISHED = "finished"
    CANCELLED = "cancelled"
    EXPIRED = "expired"

    @property
    def terminal(self) -> bool:
        return self in (RequestStatus.FINISHED, RequestStatus.CANCELLED,
                        RequestStatus.EXPIRED)


_STATE_TO_STATUS = {
    JobState.WAITING: RequestStatus.QUEUED,
    JobState.RUNNING: RequestStatus.RUNNING,
    JobState.PREEMPTED: RequestStatus.PREEMPTED,
    JobState.FINISHED: RequestStatus.FINISHED,
    JobState.CANCELLED: RequestStatus.CANCELLED,
    JobState.EXPIRED: RequestStatus.EXPIRED,
}


@dataclass(frozen=True)
class RequestOptions:
    """Per-request knobs, orthogonal to the prompt itself."""

    #: cap on generated tokens (None = backend's own cap)
    max_tokens: Optional[int] = None
    #: absolute deadline on the serving clock; the request is EXPIRED if it
    #: has not finished by then (slot is released at the deadline)
    deadline: Optional[float] = None
    #: multi-tenancy label, carried through to the Response
    tenant: str = "default"
    #: coarse priority band: lower classes always outrank higher ones,
    #: independent of predicted length (0 = default band)
    priority_class: int = 0
    #: caller intends to consume ``ElisServer.stream`` for this request
    stream: bool = False


@dataclass
class Request:
    """One serving request as the caller sees it."""

    prompt: str
    prompt_tokens: Sequence[int]
    arrival_time: float = 0.0
    #: caller-chosen id; None = server assigns a fresh one
    request_id: Optional[int] = None
    options: RequestOptions = field(default_factory=RequestOptions)
    #: ground-truth response length: the oracle predictors read it, and an
    #: engine with ``respect_job_max`` stops the request there
    true_output_len: int = 0
    #: ground-truth response stream: the cluster simulator replays it; the
    #: live engine ignores it
    output_tokens: Sequence[int] = ()

    @classmethod
    def from_workload(cls, r, options: Optional[RequestOptions] = None
                      ) -> "Request":
        """Adapt a ``repro_torch.data.workload.Request`` (generator ground
        truth).

        Without explicit ``options``, the workload record's own serving
        attributes (tenant / priority class / deadline — set by the
        scenario library, absent on plain generator output) are forwarded
        so multi-tenant scenarios flow through unchanged."""
        if options is None:
            options = RequestOptions(
                deadline=getattr(r, "deadline", None),
                tenant=getattr(r, "tenant", None) or "default",
                priority_class=int(getattr(r, "priority_class", 0) or 0),
            )
        return cls(
            prompt=r.prompt,
            prompt_tokens=r.prompt_tokens,
            arrival_time=r.arrival_time,
            request_id=r.request_id,
            options=options,
            true_output_len=r.true_output_len,
            output_tokens=r.output_tokens,
        )


@dataclass(frozen=True)
class TokenChunk:
    """Tokens emitted by one scheduling iteration of one request."""

    request_id: int
    tokens: Tuple[int, ...]
    #: scheduling-iteration index this chunk came from (0-based)
    index: int
    #: serving-clock time at which the tokens materialised
    t: float
    #: True on the request's last chunk
    final: bool = False


@dataclass
class Response:
    """Terminal record of one request (duck-compatible with ``summarize``)."""

    request_id: int
    status: RequestStatus
    tokens: Tuple[int, ...]
    node: int
    arrival_time: float
    finish_time: Optional[float]
    first_token_time: Optional[float]
    queuing_delay: float
    n_preemptions: int
    n_iterations: int
    tenant: str = "default"
    #: cross-node migrations while queued (cluster rebalancing)
    n_migrations: int = 0
    #: mean |predicted - actual| remaining tokens over the request's scored
    #: windows (None when the policy predicted no lengths or the request
    #: never finished — aborted lengths are censored)
    pred_mae: Optional[float] = None
    #: geometric mean of predicted/actual remaining (1.0 = calibrated,
    #: < 1 = the predictor underestimated this request)
    pred_bias: Optional[float] = None

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)

    @property
    def ok(self) -> bool:
        return self.status is RequestStatus.FINISHED

    def jct(self) -> float:
        assert self.finish_time is not None
        return self.finish_time - self.arrival_time

    @classmethod
    def from_job(cls, job: Job) -> "Response":
        from repro_torch.core.metrics import prediction_stats

        mae, bias = prediction_stats(job)
        return cls(
            request_id=job.job_id,
            status=_STATE_TO_STATUS[job.state],
            tokens=tuple(job.generated),
            node=job.node,
            arrival_time=job.arrival_time,
            finish_time=job.finish_time,
            first_token_time=job.first_token_time,
            queuing_delay=job.queuing_delay,
            n_preemptions=job.n_preemptions,
            n_iterations=job.n_iterations,
            tenant=job.tenant,
            n_migrations=job.n_migrations,
            pred_mae=mae,
            pred_bias=bias,
        )


class RequestHandle:
    """Opaque ticket for a submitted request."""

    __slots__ = ("request_id", "_server")

    def __init__(self, request_id: int, server: "ElisServer"):
        self.request_id = request_id
        self._server = server

    @property
    def status(self) -> RequestStatus:
        return self._server.status(self)

    @property
    def done(self) -> bool:
        return self.status.terminal

    def result(self) -> Optional[Response]:
        """The terminal Response, or None while the request is live."""
        return self._server.response(self)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"RequestHandle(id={self.request_id}, status={self.status.value})"


class ElisServer:
    """Facade over the steppable ELIS frontend — the online serving surface.

    Construct either from scheduler config + predictor + backend, or wrap an
    existing :class:`~repro_torch.core.frontend.ELISFrontend`::

        server = ElisServer(FrontendConfig(...), OraclePredictor(), backend)
        h = server.submit(Request(prompt, tokens, arrival_time=0.0))
        for chunk in server.stream(h):
            ...
        responses = server.drain()
    """

    def __init__(self, cfg: Optional["FrontendConfig"] = None,
                 predictor: Optional["Predictor"] = None,
                 backend=None, *,
                 frontend: Optional["ELISFrontend"] = None):
        from repro_torch.core.frontend import ELISFrontend, FrontendConfig

        if frontend is None:
            if backend is None:
                raise ValueError("ElisServer needs a backend (or a frontend)")
            frontend = ELISFrontend(cfg or FrontendConfig(), predictor,
                                    backend)
        self._fe = frontend
        self._ids = itertools.count()
        self._jobs: Dict[int, Job] = {}
        self._order: List[int] = []

    # -- introspection -------------------------------------------------- #
    @property
    def frontend(self) -> "ELISFrontend":
        return self._fe

    @property
    def backend(self):
        return self._fe.executor

    @property
    def now(self) -> float:
        """Current serving-clock time."""
        return self._fe.now

    def pending(self) -> int:
        """Number of unprocessed scheduler events."""
        return self._fe.pending()

    # -- lifecycle ------------------------------------------------------ #
    def submit(self, request: Request) -> RequestHandle:
        """Admit a request; returns an opaque handle (never the Job)."""
        rid = request.request_id
        if rid is None:
            rid = next(self._ids)
            while rid in self._jobs:
                rid = next(self._ids)
        elif rid in self._jobs:
            raise ValueError(f"duplicate request_id {rid}")
        opts = request.options
        max_out = request.true_output_len
        if opts.max_tokens is not None:
            max_out = (min(max_out, opts.max_tokens) if max_out
                       else opts.max_tokens)
        job = Job(
            job_id=rid,
            prompt=request.prompt,
            prompt_tokens=list(request.prompt_tokens),
            arrival_time=request.arrival_time,
            true_output_len=max_out,
            output_tokens=list(request.output_tokens),
            deadline=opts.deadline,
            tenant=opts.tenant,
            priority_class=opts.priority_class,
            stream=opts.stream,
        )
        self._fe.submit(job)
        self._jobs[rid] = job
        self._order.append(rid)
        return RequestHandle(rid, self)

    def cancel(self, handle: RequestHandle) -> bool:
        """Cancel a live request. Waiting requests terminate immediately;
        running ones are evicted at the next window boundary.  Returns False
        if the request is unknown or already terminal."""
        return self._fe.cancel(handle.request_id)

    def status(self, handle: RequestHandle) -> RequestStatus:
        job = self._job(handle)
        return _STATE_TO_STATUS[job.state]

    def response(self, handle: RequestHandle) -> Optional[Response]:
        job = self._job(handle)
        if _STATE_TO_STATUS[job.state].terminal:
            return Response.from_job(job)
        return None

    # -- time ----------------------------------------------------------- #
    def step(self, now: Optional[float] = None) -> List["Event"]:
        """Process the next scheduler event (if due by ``now``)."""
        return self._fe.step(now)

    def run_until(self, t: float) -> List["Event"]:
        """Advance the serving clock to ``t``, processing all due events."""
        return self._fe.run_until(t)

    def drain(self) -> List[Response]:
        """Run the system to completion and return every terminal Response,
        in submission order."""
        while self._fe.pending():
            self._fe.step()
        out = []
        for rid in self._order:
            job = self._jobs[rid]
            if _STATE_TO_STATUS[job.state].terminal:
                out.append(Response.from_job(job))
        return out

    def drain_stream(self) -> Iterator[Response]:
        """Like :meth:`drain`, but yield each terminal Response and
        immediately release the underlying job's records — constant memory
        over arbitrarily long runs.  Responses come in submission order;
        released requests are forgotten (``status`` raises for them
        afterwards)."""
        while self._fe.pending():
            self._fe.step()
        order = list(self._order)
        try:
            for rid in order:
                job = self._jobs.get(rid)
                if job is None or not _STATE_TO_STATUS[job.state].terminal:
                    continue
                resp = Response.from_job(job)
                self._fe.forget(rid)
                del self._jobs[rid]
                yield resp
        finally:
            self._order = [rid for rid in order if rid in self._jobs]

    def release(self, handle: RequestHandle) -> bool:
        """Drop a *terminal* request's records (job, chunks, response data)
        so long-lived servers don't grow without bound.  Returns False if
        the request is unknown or still live."""
        job = self._jobs.get(handle.request_id)
        if job is None or not _STATE_TO_STATUS[job.state].terminal:
            return False
        self._fe.forget(handle.request_id)
        del self._jobs[handle.request_id]
        self._order.remove(handle.request_id)
        return True

    # -- streaming ------------------------------------------------------ #
    def stream(self, handle: RequestHandle) -> Iterator[TokenChunk]:
        """Yield the request's TokenChunks in generation order, stepping the
        scheduler as needed until the request reaches a terminal state.
        Requires the request to have been submitted with
        ``RequestOptions(stream=True)`` (chunks are only retained then)."""
        job = self._job(handle)
        if not job.stream:
            raise ValueError(
                f"request {handle.request_id} was not submitted with "
                f"options.stream=True; no chunks are retained for it")
        i = 0
        while True:
            while i < len(job.chunks):
                yield job.chunks[i]
                i += 1
            if _STATE_TO_STATUS[job.state].terminal:
                return
            if not self._fe.pending():
                return  # starved: nothing left that could produce tokens
            self._fe.step()

    # ------------------------------------------------------------------ #
    def _job(self, handle: RequestHandle) -> Job:
        try:
            return self._jobs[handle.request_id]
        except KeyError:
            raise KeyError(f"unknown request {handle.request_id}") from None
