"""Cluster scheduling: prediction-aware placement over backend workers.

The paper deploys ELIS cloud-natively (§4.1): the frontend consults the
global state G and load-balances every new request across Kubernetes pods
(StatefulSet pod identity maps to the integer node id).  This module is
that cluster layer:

* :class:`GlobalState` — the frontend's shared-memory view of the cluster:
  per-node live-job counts, per-node outstanding *predicted remaining
  tokens* (kept in sync by the scheduler on assign / re-score / finish /
  preempt / cancel), and the ``busy_until`` horizon each node's executing
  window runs to;
* placement policies — :class:`LeastJobsPlacement` (the original greedy
  job-counter, kept for ablation), :class:`LeastPredictedWorkPlacement`
  (length-prediction-aware placement a la Qiu et al.: balance outstanding
  predicted tokens, not request counts), and :class:`LeastEtaPlacement`
  (estimated time to drain the node's backlog, using per-node token costs
  from the calibrated latency profiles — the policy that separates fast
  from slow pods in a heterogeneous cluster);
* :class:`LoadBalancer` — applies the selected placement at arrival.

Cross-node *rebalancing* (work-stealing of queued jobs at ``node_free``
events) lives in :class:`repro_torch.core.frontend.ELISFrontend`, which owns the
per-node queues being migrated.
"""
from __future__ import annotations

from typing import Dict, Optional


class GlobalState:
    """The frontend's shared-memory view of the cluster (paper's G).

    Tracks, per node: live-job count, outstanding predicted remaining
    tokens, and the time horizon the node's currently executing window runs
    to.  Per-job work contributions are keyed by ``job_id`` so retractions
    (finish / cancel / expiry / migration) are exact — totals return to
    zero once every admitted job is terminal (:meth:`assert_drained`).
    """

    def __init__(self, n_nodes: int):
        self.n_nodes = n_nodes
        self.active_jobs: Dict[int, int] = {n: 0 for n in range(n_nodes)}
        #: outstanding predicted remaining tokens per node
        self.predicted_work: Dict[int, float] = {n: 0.0 for n in range(n_nodes)}
        #: serving-clock time the node's executing window completes at;
        #: monotone per node (windows execute back to back)
        self.busy_until: Dict[int, float] = {n: 0.0 for n in range(n_nodes)}
        self._job_node: Dict[int, int] = {}
        self._job_work: Dict[int, float] = {}

    # ------------------------------------------------------------------ #
    def add_job(self, node: int, job_id: int, work: float = 0.0) -> None:
        assert job_id not in self._job_node, f"job {job_id} already placed"
        self.active_jobs[node] += 1
        self.predicted_work[node] += work
        self._job_node[job_id] = node
        self._job_work[job_id] = work

    def set_work(self, job_id: int, work: float) -> None:
        """Refresh a live job's predicted-remaining-tokens contribution
        (called by the scheduler after each scoring pass)."""
        node = self._job_node[job_id]
        self.predicted_work[node] += work - self._job_work[job_id]
        self._job_work[job_id] = work

    def work_of(self, job_id: int) -> float:
        return self._job_work[job_id]

    def node_of(self, job_id: int) -> int:
        return self._job_node[job_id]

    def move_job(self, job_id: int, dst: int) -> None:
        """Migrate a job's accounting to another node (work-stealing)."""
        src = self._job_node[job_id]
        if src == dst:
            return
        w = self._job_work[job_id]
        self.active_jobs[src] -= 1
        self.predicted_work[src] -= w
        self.active_jobs[dst] += 1
        self.predicted_work[dst] += w
        self._job_node[job_id] = dst

    def finish_job(self, node: int, job_id: int) -> None:
        """Retract a terminal job (FINISHED / CANCELLED / EXPIRED) — both
        the live count and its predicted-work contribution."""
        assert self._job_node.get(job_id) == node, (
            f"job {job_id} is on node {self._job_node.get(job_id)}, "
            f"not {node}")
        self.active_jobs[node] -= 1
        assert self.active_jobs[node] >= 0
        self.predicted_work[node] -= self._job_work.pop(job_id)
        del self._job_node[job_id]

    def note_busy(self, node: int, until: float) -> None:
        """Record the horizon of the window ``node`` just started executing.
        Windows run back to back, so the horizon is monotone per node."""
        assert until >= self.busy_until[node], (
            f"busy_until must be monotone per node: node {node} "
            f"{self.busy_until[node]} -> {until}")
        self.busy_until[node] = until

    def assert_drained(self) -> None:
        """Invariant: with every admitted job terminal, totals are zero."""
        assert not self._job_node, (
            f"{len(self._job_node)} jobs still accounted: "
            f"{sorted(self._job_node)[:8]}")
        assert all(c == 0 for c in self.active_jobs.values()), self.active_jobs
        assert all(abs(w) < 1e-6 for w in self.predicted_work.values()), \
            self.predicted_work


# --------------------------------------------------------------------------- #
# Placement policies
# --------------------------------------------------------------------------- #


class PlacementPolicy:
    """Chooses the node for a newly arrived job."""

    name = "least_jobs"
    #: True when the policy reads predicted work — the frontend only spends
    #: an arrival-time prediction when some consumer needs it
    uses_work = False

    def select(self, state: GlobalState, job, estimate: float,
               now: float) -> int:
        raise NotImplementedError


class LeastJobsPlacement(PlacementPolicy):
    """Greedy min-job-count (paper §4.1 line 3 — the original balancer)."""

    name = "least_jobs"

    def select(self, state: GlobalState, job, estimate: float,
               now: float) -> int:
        return min(state.active_jobs,
                   key=lambda n: (state.active_jobs[n], n))


class LeastPredictedWorkPlacement(PlacementPolicy):
    """Balance outstanding *predicted tokens*, not request counts.

    Length-prediction-aware placement (Qiu et al.): a node holding three
    10-token answers is emptier than one holding a single 900-token essay,
    which the job counter cannot see.
    """

    name = "least_predicted_work"
    uses_work = True

    def select(self, state: GlobalState, job, estimate: float,
               now: float) -> int:
        return min(state.predicted_work,
                   key=lambda n: (state.predicted_work[n],
                                  state.active_jobs[n], n))


class LeastEtaPlacement(PlacementPolicy):
    """Minimise the estimated time for the node to drain its backlog plus
    this job: ``max(busy_until - now, 0) + (work + estimate) * token_cost``.

    ``token_cost`` is seconds per generated token on that node (from the
    calibrated :mod:`repro.simulate.profiles` latency model), which is what
    distinguishes fast from slow pods in a heterogeneous cluster — the only
    policy here that does.
    """

    name = "least_eta"
    uses_work = True

    def __init__(self, node_token_cost: Optional[Dict[int, float]] = None):
        self.node_token_cost = dict(node_token_cost or {})
        costs = list(self.node_token_cost.values())
        self._default_cost = sum(costs) / len(costs) if costs else 1.0

    def eta(self, state: GlobalState, node: int, extra_tokens: float,
            now: float) -> float:
        cost = self.node_token_cost.get(node, self._default_cost)
        backlog = max(state.busy_until[node] - now, 0.0)
        return backlog + (state.predicted_work[node] + extra_tokens) * cost

    def select(self, state: GlobalState, job, estimate: float,
               now: float) -> int:
        return min(state.predicted_work,
                   key=lambda n: (self.eta(state, n, estimate, now),
                                  state.active_jobs[n], n))


PLACEMENTS = {
    p.name: p for p in (LeastJobsPlacement, LeastPredictedWorkPlacement,
                        LeastEtaPlacement)
}


def make_placement(name: str,
                   node_token_cost: Optional[Dict[int, float]] = None
                   ) -> PlacementPolicy:
    try:
        cls = PLACEMENTS[name]
    except KeyError:
        raise ValueError(
            f"unknown placement {name!r} (have {sorted(PLACEMENTS)})"
        ) from None
    if cls is LeastEtaPlacement:
        return cls(node_token_cost)
    return cls()


# --------------------------------------------------------------------------- #


class LoadBalancer:
    """Applies the placement policy at arrival and books the assignment."""

    def __init__(self, state: GlobalState,
                 placement: Optional[PlacementPolicy] = None):
        self.state = state
        self.placement = placement or LeastJobsPlacement()

    def assign(self, job, estimate: float = 0.0, now: float = 0.0) -> int:
        node = self.placement.select(self.state, job, estimate, now)
        job.node = node
        self.state.add_job(node, job.job_id, estimate)
        return node
