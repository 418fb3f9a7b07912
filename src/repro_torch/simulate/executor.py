"""Discrete-event cluster executor.

Implements the frontend's ``Backend`` ABC with virtual time and the
calibrated latency model.  Replays each job's pre-generated response token
stream (the simulator never invents tokens — ground truth lives with the
workload generator), tracks per-node KV residency for preemption/recompute
accounting, and enforces the Appendix-A memory capacity.

Clusters may be *heterogeneous*: ``node_profiles`` maps node ids to their
own :class:`~repro_torch.simulate.profiles.ModelProfile` (e.g. fast and slow pods
mixing two calibrated entries); unmapped nodes fall back to ``profile``.
Each node's latency AND its Appendix-A KV capacity come from its own
profile, so placement policies are evaluated where nodes actually differ.
A job that resumes on a *different* node after preemption or migration is
simply not resident there — it pays the normal cold-start KV recompute.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.frontend import Backend, ExecResult
from repro_torch.core.job import Job
from repro_torch.simulate.profiles import SCHED_OVERHEAD_MS, ModelProfile


@dataclass
class SimExecutor(Backend):
    profile: ModelProfile
    #: include the paper's measured 11.04 ms scheduling overhead per iteration
    sched_overhead_s: float = SCHED_OVERHEAD_MS / 1000.0
    #: global cap on resident KV tokens per node; None = each node's own
    #: Appendix-A capacity (per-profile on heterogeneous clusters)
    kv_capacity_tokens: Optional[int] = None
    #: heterogeneous clusters: node id -> that pod's profile (latency and
    #: KV capacity); nodes absent from the map run ``profile``
    node_profiles: Optional[Dict[int, ModelProfile]] = None
    #: host<->device copy model for the KV swap tier (ALISE): one
    #: direction costs ``swap_latency_s + tokens * kv_bytes_per_token /
    #: swap_bandwidth_bytes_s``.  Defaults approximate a PCIe-4 x16 link.
    swap_bandwidth_bytes_s: float = 16e9
    swap_latency_s: float = 0.0005

    _resident: Dict[int, Set[int]] = field(default_factory=dict)
    _resident_tokens: Dict[int, Dict[int, int]] = field(default_factory=dict)
    #: node -> {job_id: KV tokens} stashed in host memory by ``offload``
    _swapped: Dict[int, Dict[int, int]] = field(default_factory=dict)
    #: swap-out seconds awaiting attribution to the node's next window
    _pending_swap_s: Dict[int, float] = field(default_factory=dict)
    mem_preemptions: int = 0
    #: context tokens re-prefilled by recompute-on-resume — the simulated
    #: counterpart of the live engine's ``resume_context_tokens`` (the
    #: preempt->resume cost-parity tests equate the two)
    recompute_prefill_tokens: int = 0
    n_swapouts: int = 0
    n_swapins: int = 0
    swapout_tokens: int = 0
    swapin_tokens: int = 0

    def __post_init__(self):
        if self.kv_capacity_tokens is None and not self.node_profiles:
            # homogeneous cluster: materialise the single capacity up front
            # (kept for introspection; heterogeneous runs stay per-node)
            self.kv_capacity_tokens = self.profile.kv_capacity_tokens()

    # ------------------------------------------------------------------ #
    def profile_of(self, node: int) -> ModelProfile:
        if self.node_profiles:
            return self.node_profiles.get(node, self.profile)
        return self.profile

    def node_token_cost(self, n_nodes: int) -> Dict[int, float]:
        """Seconds per generated token per node (batch-1 decode rate) — the
        calibrated cost map the ``least_eta`` placement policy consumes."""
        return {n: self.profile_of(n).decode_ms_1 / 1000.0
                for n in range(n_nodes)}

    def _capacity_of(self, node: int) -> int:
        if self.kv_capacity_tokens is not None:
            return self.kv_capacity_tokens
        return self.profile_of(node).kv_capacity_tokens()

    # ------------------------------------------------------------------ #
    def evict(self, node: int, job: Job) -> None:
        self._resident.setdefault(node, set()).discard(job.job_id)
        self._resident_tokens.setdefault(node, {}).pop(job.job_id, None)
        self._swapped.setdefault(node, {}).pop(job.job_id, None)
        # recompute eviction discards the KV: the job's next dispatch pays a
        # full re-prefill, and its scheduling debt reflects that
        job.prefilled_tokens = 0

    # ------------------------------------------------------------------ #
    # KV offload tier (Backend.offload / Backend.restore)
    # ------------------------------------------------------------------ #

    def _swap_cost_s(self, prof: ModelProfile, n_tokens: int) -> float:
        """One-direction host<->device copy time for ``n_tokens`` of KV."""
        return (self.swap_latency_s
                + n_tokens * prof.kv_bytes_per_token
                / self.swap_bandwidth_bytes_s)

    def offload(self, node: int, job: Job) -> bool:
        """Move the job's resident KV to host memory instead of discarding
        it; the copy time lands on the node's next window (the transfer
        occupies the device's DMA engines, not the caller's clock)."""
        res_toks = self._resident_tokens.setdefault(node, {})
        n = res_toks.get(job.job_id)
        if n is None:
            return False
        self._swapped.setdefault(node, {})[job.job_id] = n
        self._resident.setdefault(node, set()).discard(job.job_id)
        res_toks.pop(job.job_id)
        self._pending_swap_s[node] = (
            self._pending_swap_s.get(node, 0.0)
            + self._swap_cost_s(self.profile_of(node), n))
        self.n_swapouts += 1
        self.swapout_tokens += n
        return True

    def restore(self, node: int, job: Job) -> bool:
        """Explicit swap-in (execute() also restores lazily on dispatch)."""
        n = self._swapped.setdefault(node, {}).pop(job.job_id, None)
        if n is None:
            return False
        self._resident.setdefault(node, set()).add(job.job_id)
        self._resident_tokens.setdefault(node, {})[job.job_id] = n
        self._pending_swap_s[node] = (
            self._pending_swap_s.get(node, 0.0)
            + self._swap_cost_s(self.profile_of(node), n))
        self.n_swapins += 1
        self.swapin_tokens += n
        return True

    def preempt_costs(self, node: int, job: Job
                      ) -> Optional[Tuple[float, float]]:
        """(swap_round_trip_s, recompute_s) for the ``auto`` break-even:
        two copies of the job's current KV footprint vs a batch-1
        re-prefill of the same context through the latency model."""
        n = job.prefilled_tokens
        if n <= 0:
            return None
        prof = self.profile_of(node)
        swap_s = 2.0 * self._swap_cost_s(prof, n)
        rec_s = prof.prefill_ms(1, n) / 1000.0
        return swap_s, rec_s

    def counters(self) -> Dict[str, int]:
        return {
            "recompute_prefill_tokens": self.recompute_prefill_tokens,
            "swapouts": self.n_swapouts, "swapins": self.n_swapins,
            "swapout_tokens": self.swapout_tokens,
            "swapin_tokens": self.swapin_tokens,
            "mem_preemptions": self.mem_preemptions,
        }

    def resident_token_count(self, node: int) -> int:
        return sum(self._resident_tokens.get(node, {}).values())

    def capacity(self, node: int) -> Optional[int]:
        # job count is unbounded in the simulator; residency is bounded by
        # KV *tokens* (Appendix-A memory model), enforced inside execute()
        return None

    def free_capacity(self, node: int) -> Optional[int]:
        return None

    @staticmethod
    def _chunk_goal(job: Job) -> int:
        """Context tokens a chunked prefill must materialise before ``job``
        decodes — mirrors the live engine's ``_resume_tokens``: the prompt
        for a fresh job, ``prompt + generated[:-1]`` for a resumed one (the
        last emitted token seeds decode; its KV is written by the first
        decode step).  Monotone under decode progress, so a job that
        completed prefill stays complete as it generates."""
        plen = len(job.prompt_tokens)
        return plen + job.tokens_generated - 1 if job.tokens_generated \
            else plen

    # ------------------------------------------------------------------ #
    def execute(self, node: int, jobs: Sequence[Job], window: int,
                now: float, prefill_chunk: Optional[int] = None
                ) -> ExecResult:
        prof = self.profile_of(node)
        res = self._resident.setdefault(node, set())
        res_toks = self._resident_tokens.setdefault(node, {})
        swapped = self._swapped.setdefault(node, {})
        b = len(jobs)
        chunked = prefill_chunk is not None
        extra = self._pending_swap_s.pop(node, 0.0)

        prefill_ms = 0.0
        for job in jobs:
            if job.job_id in swapped:
                # swap-in: the KV comes back from host memory — copy time
                # instead of recompute, and the prefill cursor survives
                n = swapped.pop(job.job_id)
                res.add(job.job_id)
                res_toks[job.job_id] = n
                extra += self._swap_cost_s(prof, n)
                self.n_swapins += 1
                self.swapin_tokens += n
            elif job.job_id not in res:
                # cold start or resumed-after-preemption/migration: recompute
                # the KV cache for everything generated so far (vLLM
                # recompute mode)
                n = len(job.prompt_tokens) + job.tokens_generated
                if job.tokens_generated > 0:
                    # mirrors the engine's resume_context_tokens: a fresh
                    # job's first prefill is not a recompute charge
                    self.recompute_prefill_tokens += n
                res.add(job.job_id)
                if chunked:
                    # chunk admission: KV materialises chunk by chunk below
                    res_toks[job.job_id] = 0
                    job.prefilled_tokens = 0
                else:
                    prefill_ms += prof.prefill_ms(b, n)
                    res_toks[job.job_id] = n
                    job.prefilled_tokens = n

        # decode eligibility is decided BEFORE the chunk advances (the live
        # engine partitions the batch the same way): a job completing its
        # final chunk this window starts decoding next window
        if chunked:
            eligible = [j for j in jobs
                        if j.prefilled_tokens >= self._chunk_goal(j)]
            incomplete = [j for j in jobs
                          if j.prefilled_tokens < self._chunk_goal(j)]
            if incomplete:
                # at most ONE batch-1 chunk per window, first incomplete
                # job in batch order — exactly the engine's dispatch
                j0 = incomplete[0]
                n_c = min(prefill_chunk,
                          self._chunk_goal(j0) - j0.prefilled_tokens)
                prefill_ms += prof.prefill_ms(1, n_c)
                j0.prefilled_tokens += n_c
                res_toks[j0.job_id] = j0.prefilled_tokens
        else:
            eligible = list(jobs)
        elig_ids = {j.job_id for j in eligible}

        tokens_out: List[List[int]] = []
        finished: List[bool] = []
        max_new = 0
        for job in jobs:
            if len(job.output_tokens) < job.true_output_len:
                # the simulator REPLAYS ground-truth streams — a job whose
                # stream is shorter than its declared length would stop
                # progressing once the stream runs dry and spin the event
                # loop forever; fail loudly instead (the live engine has no
                # such requirement: it invents tokens)
                raise ValueError(
                    f"job {job.job_id}: output_tokens has "
                    f"{len(job.output_tokens)} tokens but true_output_len="
                    f"{job.true_output_len}; the simulator cannot replay it "
                    "(use repro_torch.data.workload streams or fill output_tokens)")
            if job.job_id not in elig_ids:
                # mid-prefill: no decode participation, no emission
                tokens_out.append([])
                finished.append(False)
                continue
            remaining = job.true_output_len - job.tokens_generated
            n_new = min(window, remaining)
            start = job.tokens_generated
            tokens_out.append(job.output_tokens[start : start + n_new])
            finished.append(n_new >= remaining)
            job.prefilled_tokens = (len(job.prompt_tokens)
                                    + job.tokens_generated + n_new)
            # residency tracks the cursor exactly (``offload`` stashes this
            # count, ``preempt_costs`` prices it — they must agree)
            res_toks[job.job_id] = job.prefilled_tokens
            max_new = max(max_new, n_new)

        # chunked windows decode only the eligible sub-batch (the engine's
        # compacted dispatch); the unchunked arithmetic is bit-identical to
        # the pre-chunking model
        b_dec = len(eligible) if chunked else b
        decode_ms = max_new * prof.decode_ms(b_dec) if b_dec else 0.0
        duration = self.sched_overhead_s + (prefill_ms + decode_ms) / 1000.0
        if extra:
            duration += extra

        # Appendix-A memory pressure: if resident KV exceeds capacity, evict
        # the largest non-batch residents (counted as memory preemptions)
        cap = self._capacity_of(node)
        total = sum(res_toks.values())
        if total > cap:
            batch_ids = {j.job_id for j in jobs}
            evictable = sorted(
                ((t, jid) for jid, t in res_toks.items()
                 if jid not in batch_ids),
                reverse=True,
            )
            for t, jid in evictable:
                if total <= cap:
                    break
                res.discard(jid)
                res_toks.pop(jid)
                total -= t
                self.mem_preemptions += 1

        return ExecResult(duration, tokens_out, finished)
