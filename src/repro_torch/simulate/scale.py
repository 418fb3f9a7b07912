"""Scale-out traffic simulation: the vectorized window-synchronous fast path.

:class:`repro_torch.core.frontend.ELISFrontend` + :class:`SimExecutor` replay the
cluster one heap event at a time with full ``Job`` objects and token
streams — exact, but ~10k requests/minute.  This module re-implements the
*same semantics* over a trace-compressed :class:`~repro_torch.data.workload.
ScaleWorkload` (struct-of-arrays: one numpy row per request, no Job
objects, no token streams) so million-request scenario sweeps run in
minutes on a laptop CPU:

* the event loop keeps only three event sources — the sorted arrival
  array, the pre-sorted deadline events, and one boundary heap entry per
  node — and advances each node window-synchronously: the whole
  score → preempt → fill → execute → apply pipeline of one scheduling
  window is a handful of numpy calls over the node's pool;
* scoring, banding and aging are computed vectorized but in the *same
  IEEE op order* as the exact loop (elementwise ops are order-free; the
  order-sensitive accumulations — prefill, predicted-work deltas, the
  batch apply — run sequentially in batch order, which is O(batch), not
  O(queue));
* stochastic predictions reuse the exact loop's RNG stream:
  ``RandomState.lognormal`` with array parameters consumes the underlying
  gauss stream element-by-element, identically to the per-job scalar
  draws of :class:`~repro_torch.core.predictor.NoisyOraclePredictor`;
* when a node's waiting queue is empty, no running job has a deadline,
  and no global arrival lands before a window's start, the loop
  *coalesces* up to ``(min_remaining - 1) // window`` whole windows into
  one step — the per-window durations are still accumulated sequentially
  (``end += duration``), so the virtual clock is bit-identical.

Exactness contract (tested in ``tests/test_torch_sim_scale.py``):

* ``predictor="oracle"`` — trace-identical to the exact loop for every
  supported config (fcfs/sjf/isrtf x preemption x aging x priority
  classes x deadlines x placements x heterogeneous nodes), including
  with coalescing: all scores are integer-valued, so skipped scoring
  passes and single-shot work decay are bit-neutral;
* ``predictor="noisy_oracle"`` — trace-identical with coalescing off
  (every scoring pass then draws the same RNG sequence as the exact
  loop); with coalescing on, ISRTF's skipped per-window draws shift the
  stream, so the run is *statistically* equivalent instead (the
  benchmark reports the fidelity delta).  Coalescing therefore
  auto-disables whenever it would change the draw sequence or
  non-integer work accounting.

Everything the exact loop treats as irregular — ``cancel``, rebalancing
(work-stealing), MLFQ, BGE predictors, risk quantiles — is out of scope
here by design: :meth:`ScaleSimConfig.validate` fails loudly and points
back to :func:`repro_torch.simulate.runner.run_experiment`.
"""
from __future__ import annotations

import heapq
import itertools
import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.metrics import StreamingSummary, fairness_ratio
from repro_torch.core.scheduler import (
    PREEMPT_POLICIES,
    PRIORITY_CLASS_WEIGHT,
    RANK_BY,
    PreemptionConfig,
    decide_preempt,
    select_fills,
    select_preemptions,
)
from repro_torch.core.load_balancer import PLACEMENTS
from repro_torch.data.workload import ScaleWorkload
from repro_torch.simulate.profiles import PROFILES, SCHED_OVERHEAD_MS, ModelProfile

__all__ = [
    "ScaleSimConfig", "ScaleSimulator", "ScaleResult",
    "run_exact_reference",
]

#: job lifecycle codes in ``ScaleResult.state``
UNARRIVED, WAITING, RUNNING, FINISHED, EXPIRED = 0, 1, 2, 3, 4

_POLICIES = ("fcfs", "sjf", "isrtf")
_PREDICTORS = ("oracle", "noisy_oracle")

#: queue size beyond which selection switches from the shared Python
#: rules to their numpy equivalents (proven identical; see tests)
_VECTOR_CUTOVER = 64


def _resolve_profile(p) -> ModelProfile:
    """Registry name or a ModelProfile instance (live-calibrated fits)."""
    return p if isinstance(p, ModelProfile) else PROFILES[p]


@dataclass
class ScaleSimConfig:
    """Configuration of one fast-path run (mirrors the exact loop's
    ``ExperimentConfig``/``FrontendConfig`` surface for the supported
    subset)."""

    #: profile name in ``PROFILES`` — or a :class:`ModelProfile` instance
    #: (live-calibrated fits from ``EngineExecutor.calibrated_profile()``
    #: plug in directly; the live↔sim loop never round-trips a registry)
    model: object = "vic"
    policy: str = "isrtf"            # fcfs | sjf | isrtf
    predictor: str = "oracle"        # oracle | noisy_oracle
    n_nodes: int = 1
    batch_size: int = 4
    window: int = 50
    aging_rate: float = 0.0
    repredict_every: int = 1
    preemption: PreemptionConfig = field(default_factory=PreemptionConfig)
    placement: str = "least_jobs"
    seed: int = 0
    hw_speedup: float = 1.0
    #: heterogeneous clusters: node id -> profile name or ModelProfile
    #: instance (others run ``model``)
    node_profiles: Optional[Dict[int, object]] = None
    #: per-window scheduling overhead [s]; None = the paper-calibrated
    #: ``SCHED_OVERHEAD_MS`` (live replays pass the fitted intercept)
    sched_overhead_s: Optional[float] = None
    #: systematic multiplicative mis-calibration of the noisy oracle
    predictor_bias: float = 1.0
    #: window coalescing on idle-queue nodes; auto-disabled whenever it
    #: would change the RNG draw sequence or non-integer work accounting
    coalesce: bool = True
    #: finished records buffered between streaming-metrics flushes
    flush_every: int = 8192
    #: chunked prefill (SchedulerConfig.prefill_chunk mirror): at most one
    #: batch-1 prefill chunk of this many tokens per window, decode runs
    #: only the prefill-complete sub-batch.  None = one-shot prefill.
    #: Coalescing auto-disables when set (a mid-prefill job breaks the
    #: all-jobs-decode invariant coalescing relies on).
    prefill_chunk: Optional[int] = None
    #: host<->device KV copy model for ``preemption.policy`` swap/auto
    #: (SimExecutor mirror)
    swap_bandwidth_bytes_s: float = 16e9
    swap_latency_s: float = 0.0005
    #: pool-ordering source (SchedulerConfig.rank_by mirror).  The fast
    #: path only supports "magnitude": rank scores come from the two-head
    #: BGE predictor, which is exact-loop-only (see ``_PREDICTORS``)
    rank_by: str = "magnitude"

    # ------------------------------------------------------------------ #
    def validate(self) -> None:
        if self.prefill_chunk is not None and self.prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1 or None, got {self.prefill_chunk}")
        if self.preemption.policy not in PREEMPT_POLICIES:
            raise ValueError(
                f"unknown preempt policy {self.preemption.policy!r}; "
                f"choose one of {PREEMPT_POLICIES}")
        if (not isinstance(self.model, ModelProfile)
                and self.model not in PROFILES):
            raise ValueError(f"unknown model {self.model!r} "
                             f"(have {sorted(PROFILES)})")
        for node, name in (self.node_profiles or {}).items():
            if not isinstance(name, ModelProfile) and name not in PROFILES:
                raise ValueError(f"unknown profile {name!r} for node {node} "
                                 f"(have {sorted(PROFILES)})")
        if self.policy not in _POLICIES:
            raise ValueError(
                f"unknown/unsupported policy {self.policy!r} for the scale "
                f"fast path (have {list(_POLICIES)}); mlfq and other "
                "irregular policies run through "
                "repro_torch.simulate.runner.run_experiment")
        if self.predictor not in _PREDICTORS:
            raise ValueError(
                f"unknown/unsupported predictor {self.predictor!r} for the "
                f"scale fast path (have {list(_PREDICTORS)}); bge/calibrated "
                "predictors run through repro_torch.simulate.runner.run_experiment")
        if self.placement not in PLACEMENTS:
            raise ValueError(f"unknown placement {self.placement!r} "
                             f"(have {sorted(PLACEMENTS)})")
        if self.rank_by not in RANK_BY:
            raise ValueError(
                f"unknown rank_by {self.rank_by!r} (choose one of {RANK_BY})")
        if self.rank_by == "rank_score":
            raise ValueError(
                "rank_by='rank_score' needs the two-head ranked (bge) "
                "predictor, which the scale fast path does not support — "
                "run through repro_torch.simulate.runner.run_experiment")
        if self.n_nodes < 1 or self.batch_size < 1 or self.window < 1:
            raise ValueError("n_nodes, batch_size and window must be >= 1")

    # ------------------------------------------------------------------ #
    def profiles(self) -> List[ModelProfile]:
        """Per-node calibrated profiles (scaled by ``hw_speedup``)."""
        over = self.node_profiles or {}
        return [_resolve_profile(over.get(n, self.model))
                .scaled(self.hw_speedup) for n in range(self.n_nodes)]


@dataclass
class ScaleResult:
    """Per-job outcome arrays plus the streamed per-tenant summaries."""

    cfg: ScaleSimConfig
    workload: ScaleWorkload
    state: np.ndarray          # int8 lifecycle codes (FINISHED/EXPIRED/...)
    finish: np.ndarray         # float64; NaN when never terminal
    first_token: np.ndarray    # float64; NaN when never dispatched
    queuing_delay: np.ndarray  # float64 cumulative queue time
    n_preemptions: np.ndarray  # int64
    n_iterations: np.ndarray   # int64 scheduling windows participated in
    finished_order: np.ndarray  # int64 job ids in finish order
    tenant_summaries: Dict[str, StreamingSummary]
    n_windows: int
    n_coalesced: int
    wall_s: float
    n_swapouts: int = 0
    n_swapins: int = 0
    #: context tokens re-prefilled by recompute-on-resume (SimExecutor's
    #: ``recompute_prefill_tokens`` mirror)
    recompute_prefill_tokens: int = 0

    def jct(self) -> np.ndarray:
        """Finished jobs' completion times (NaN elsewhere)."""
        out = self.finish - self.workload.arrival
        out[self.state != FINISHED] = np.nan
        return out

    def metrics(self) -> Dict[str, object]:
        """Aggregate + per-tenant summary dict (streaming quantiles)."""
        g = StreamingSummary()
        for s in self.tenant_summaries.values():
            g.merge(s)
        out: Dict[str, object] = g.summarize()
        out["tenants"] = {t: s.summarize()
                          for t, s in sorted(self.tenant_summaries.items())}
        # deadline-heavy scenarios (agent): expiry is a per-tenant outcome —
        # streamed summaries only see *finished* jobs, so count from the
        # lifecycle arrays
        tid = self.workload.tenant_id
        for ti, t in enumerate(self.workload.tenants):
            mask = tid == ti
            n_t = int(mask.sum())
            if n_t and t in out["tenants"]:
                out["tenants"][t]["n_submitted"] = n_t
                out["tenants"][t]["expiry_rate"] = round(
                    float((self.state[mask] == EXPIRED).sum()) / n_t, 4)
        out["fairness_jct"] = fairness_ratio(
            {t: s.sketch.mean for t, s in self.tenant_summaries.items()})
        out["n_finished"] = int((self.state == FINISHED).sum())
        out["n_expired"] = int((self.state == EXPIRED).sum())
        out["n_windows"] = self.n_windows
        out["n_coalesced_windows"] = self.n_coalesced
        out["n_swapouts"] = self.n_swapouts
        out["n_swapins"] = self.n_swapins
        out["recompute_prefill_tokens"] = self.recompute_prefill_tokens
        out["wall_s"] = self.wall_s
        out["requests_per_s"] = (self.workload.n / self.wall_s
                                 if self.wall_s > 0 else 0.0)
        return out


# --------------------------------------------------------------------------- #


class ScaleSimulator:
    """The vectorized window-synchronous event loop (see module docs)."""

    def __init__(self, cfg: ScaleSimConfig):
        cfg.validate()
        self.cfg = cfg
        self._profiles = cfg.profiles()
        #: seconds per generated token per node (= SimExecutor.node_token_cost)
        self._cost = [p.decode_ms_1 / 1000.0 for p in self._profiles]
        self._track_work = PLACEMENTS[cfg.placement].uses_work
        self._predicts_length = cfg.policy in ("sjf", "isrtf")
        noisy = cfg.predictor == "noisy_oracle"
        # coalescing skips per-window scoring passes; that is bit-neutral
        # only when those passes draw no RNG (oracle, or noisy under a
        # non-repredicting policy) AND the skipped predicted-work refreshes
        # are integer-valued (oracle) or absent (no work tracking)
        self._coalesce = cfg.coalesce and (
            not noisy or (cfg.policy != "isrtf" and not self._track_work)
        ) and cfg.prefill_chunk is None

    # ------------------------------------------------------------------ #
    def run(self, w: ScaleWorkload) -> ScaleResult:
        cfg = self.cfg
        t0 = time.perf_counter()
        n = w.n
        n_nodes = cfg.n_nodes
        window = cfg.window
        cap = cfg.batch_size
        policy = cfg.policy
        isrtf = policy == "isrtf"
        sjf = policy == "sjf"
        noisy = cfg.predictor == "noisy_oracle"
        bias = cfg.predictor_bias
        aging = cfg.aging_rate
        stride = max(cfg.repredict_every, 1)
        pcfg = cfg.preemption
        chunk = cfg.prefill_chunk
        chunked = chunk is not None
        swap_policy = pcfg.policy != "recompute"
        swap_lat = cfg.swap_latency_s
        swap_bw = cfg.swap_bandwidth_bytes_s
        track_work = self._track_work
        refresh_work = track_work and self._predicts_length
        placement = cfg.placement
        coalesce = self._coalesce
        overhead = (cfg.sched_overhead_s if cfg.sched_overhead_s is not None
                    else SCHED_OVERHEAD_MS / 1000.0)
        INF = math.inf

        arrival = np.ascontiguousarray(w.arrival, dtype=np.float64)
        length = np.ascontiguousarray(w.length, dtype=np.int64)
        plen = np.ascontiguousarray(w.prompt_len, dtype=np.int64)
        band = w.priority_class.astype(np.float64) * PRIORITY_CLASS_WEIGHT
        deadline = np.ascontiguousarray(w.deadline, dtype=np.float64)
        has_deadlines = bool(np.isfinite(deadline).any())

        # per-job state (struct of arrays)
        gen = np.zeros(n, dtype=np.int64)
        state = np.zeros(n, dtype=np.int8)
        node_of = np.full(n, -1, dtype=np.int32)
        last_enq = np.full(n, np.nan)
        qdelay = np.zeros(n)
        first_tok = np.full(n, np.nan)
        finish = np.full(n, np.nan)
        npre = np.zeros(n, dtype=np.int64)
        niter = np.zeros(n, dtype=np.int64)
        resident = np.zeros(n, dtype=bool)
        pref = np.zeros(n, dtype=np.int64)   # Job.prefilled_tokens mirror
        swapped = np.zeros(n, dtype=bool)    # KV stashed in host memory
        n_swapouts = 0
        n_swapins = 0
        recompute_toks = 0
        workv = np.zeros(n)          # GlobalState._job_work mirror
        # prediction caches (repredict_every stride; noisy ISRTF only —
        # oracle scores are reproducible from (length, gen) at any time)
        prio_cache = np.zeros(n)
        gen_at = np.zeros(n, dtype=np.int64)
        scored = np.zeros(n, dtype=bool)
        sjf_first = np.full(n, np.nan)

        rng: Optional[np.random.RandomState] = None
        sigma_tab = mu_tab = None
        if noisy:
            from repro_torch.core.predictor import NoisyOraclePredictor
            from repro_torch.data.dataset import WINDOW as pred_window
            # same seed derivation as run_experiment / run_exact_reference
            rng = np.random.RandomState(cfg.seed + 1)
            s0, dec, fl = (NoisyOraclePredictor.sigma0,
                           NoisyOraclePredictor.decay,
                           NoisyOraclePredictor.sigma_floor)
            kmax = int(length.max()) // pred_window + 2 if n else 1
            # python pow, like NoisyOraclePredictor._sigma — not np.power
            sigma_tab = np.array([max(s0 * dec ** k, fl)
                                  for k in range(kmax + 1)])
            mu_tab = -0.5 * sigma_tab * sigma_tab
            pred_step_window = pred_window
        else:
            pred_step_window = 0  # unused

        # per-node structures (GlobalState + ELISFrontend queue mirrors)
        waitq: List[List[int]] = [[] for _ in range(n_nodes)]
        runq: List[List[int]] = [[] for _ in range(n_nodes)]
        busy = [False] * n_nodes
        widx = [0] * n_nodes
        active = [0] * n_nodes
        work_node = [0.0] * n_nodes
        busy_g = [0.0] * n_nodes
        cost = self._cost
        profiles = self._profiles
        decode_cache: Dict[Tuple[int, int], float] = {}

        # event sources: arrivals (sorted array), deadline events (sorted
        # once; event time max(deadline, arrival) as in submit()), and one
        # boundary heap entry per busy node
        arr_l = arrival.tolist()
        i_arr = 0
        didx = np.nonzero(np.isfinite(deadline))[0]
        devt = np.maximum(deadline, arrival)[didx]
        dorder = np.argsort(devt, kind="stable")
        d_ids = didx[dorder].tolist()
        d_ts = devt[dorder].tolist()
        n_dead = len(d_ids)
        d_ptr = 0
        bheap: List[Tuple[float, int, int]] = []
        seq = itertools.count()

        finished_order: List[int] = []
        fptr = 0
        flush_every = max(cfg.flush_every, 1)
        tenants = w.tenants
        tenant_id = np.ascontiguousarray(w.tenant_id, dtype=np.int64)
        t_sum = {t: StreamingSummary(slo_target=w.slo_targets.get(t))
                 for t in tenants}

        n_windows = 0
        n_coalesced = 0

        # -------------------------------------------------------------- #
        def flush(upto: int) -> None:
            nonlocal fptr
            ids = np.asarray(finished_order[fptr:upto], dtype=np.intp)
            fptr = upto
            if ids.size == 0:
                return
            tid = tenant_id[ids]
            arr = arrival[ids]
            jct = finish[ids] - arr
            ttft = first_tok[ids] - arr
            qd = qdelay[ids]
            pre = npre[ids]
            for ti, name in enumerate(tenants):
                m = tid == ti
                if m.any():
                    t_sum[name].add_batch(jct[m], qd[m], arr[m],
                                          ttft[m], pre[m])

        def expire(j: int, node: int, t: float) -> None:
            state[j] = EXPIRED
            finish[j] = t
            resident[j] = False
            swapped[j] = False
            pref[j] = 0
            active[node] -= 1
            work_node[node] -= workv[j]
            workv[j] = 0.0

        # mirror of LoadBalancer placement policies — min over the same
        # lexicographic keys, iterated in node-id order like the dicts
        if n_nodes == 1:
            def place(now: float, est: float) -> int:
                return 0
        elif placement == "least_jobs":
            def place(now: float, est: float) -> int:
                best, ba = 0, active[0]
                for m in range(1, n_nodes):
                    if active[m] < ba:
                        best, ba = m, active[m]
                return best
        elif placement == "least_predicted_work":
            def place(now: float, est: float) -> int:
                best, bw, ba = 0, work_node[0], active[0]
                for m in range(1, n_nodes):
                    wm = work_node[m]
                    if wm < bw or (wm == bw and active[m] < ba):
                        best, bw, ba = m, wm, active[m]
                return best
        else:  # least_eta
            def place(now: float, est: float) -> int:
                be = max(busy_g[0] - now, 0.0) + (work_node[0] + est) * cost[0]
                best, ba = 0, active[0]
                for m in range(1, n_nodes):
                    em = (max(busy_g[m] - now, 0.0)
                          + (work_node[m] + est) * cost[m])
                    if em < be or (em == be and active[m] < ba):
                        best, be, ba = m, em, active[m]
                return best

        # -------------------------------------------------------------- #
        while True:
            t_arr = arr_l[i_arr] if i_arr < n else INF
            t_d = d_ts[d_ptr] if d_ptr < n_dead else INF
            t_b = bheap[0][0] if bheap else INF
            if t_b is INF and t_arr is INF and t_d is INF:
                break

            # same-timestamp ordering as ELISFrontend._KIND_RANK:
            # arrival < deadline < node_free
            if t_arr <= t_d and t_arr <= t_b:
                now = t_arr
                j = i_arr
                i_arr += 1
                est = 0.0
                if track_work:
                    # ELISFrontend._arrival_estimate: one prediction per
                    # arrival (one RNG draw for the noisy oracle)
                    trem = float(length[j])
                    if noisy:
                        s = sigma_tab[0]
                        noise = rng.lognormal(-0.5 * s * s, s)
                        est = max(trem * noise * bias, 1.0)
                    else:
                        est = trem
                    est = max(est, 0.0)
                node = place(now, est)
                node_of[j] = node
                state[j] = WAITING
                last_enq[j] = now
                active[node] += 1
                work_node[node] += est
                workv[j] = est
                waitq[node].append(j)
                if not busy[node]:
                    heapq.heappush(bheap, (now, next(seq), node))
                    busy[node] = True
                continue

            if t_d <= t_b:
                now = t_d
                j = d_ids[d_ptr]
                d_ptr += 1
                st = state[j]
                if st == WAITING:
                    node = int(node_of[j])
                    waitq[node].remove(j)
                    expire(j, node, now)
                elif st == RUNNING:
                    # reachable when a window ends exactly on the deadline
                    node = int(node_of[j])
                    runq[node].remove(j)
                    expire(j, node, now)
                continue

            now, _, node = heapq.heappop(bheap)
            rq = runq[node]
            wq = waitq[node]
            if not rq and not wq:
                busy[node] = False
                continue

            # ---------------- scoring (score_pool mirror) -------------- #
            wi = widx[node]
            widx[node] = wi + 1
            full = (wi % stride == 0)
            nr = len(rq)
            pool = rq + wq
            idx = np.asarray(pool, dtype=np.intp)
            g = gen[idx]

            if policy == "fcfs":
                raw = arrival[idx]
            elif sjf:
                first = sjf_first[idx]
                need = np.isnan(first)
                if need.any():
                    sub = idx[need]
                    if noisy:
                        k = sub.size
                        s = sigma_tab[0]
                        noise = rng.lognormal(np.full(k, -0.5 * s * s),
                                              np.full(k, s))
                        f = np.maximum(
                            length[sub].astype(np.float64) * noise * bias,
                            1.0)
                    else:
                        f = length[sub].astype(np.float64)
                    sjf_first[sub] = f
                    first = sjf_first[idx]
                raw = np.maximum(first - g, 0.0)
            elif not noisy:  # oracle ISRTF: fresh == cached-decayed, always
                raw = (length[idx] - g).astype(np.float64)
            else:  # noisy ISRTF with the repredict stride
                if full:
                    steps = g // pred_step_window
                    s = sigma_tab[steps]
                    noise = rng.lognormal(mu_tab[steps], s)
                    raw = np.maximum(
                        (length[idx] - g).astype(np.float64) * noise * bias,
                        1.0)
                    prio_cache[idx] = raw
                    gen_at[idx] = g
                    scored[idx] = True
                else:
                    fresh = ~scored[idx]
                    raw = np.maximum(prio_cache[idx] - (g - gen_at[idx]), 0.0)
                    if fresh.any():
                        sub = idx[fresh]
                        gs = g[fresh]
                        steps = gs // pred_step_window
                        s = sigma_tab[steps]
                        noise = rng.lognormal(mu_tab[steps], s)
                        fr = np.maximum(
                            (length[sub] - gs).astype(np.float64)
                            * noise * bias, 1.0)
                        raw[fresh] = fr
                        prio_cache[sub] = fr
                        gen_at[sub] = gs
                        scored[sub] = True

            if chunked:
                # prefill debt joins the raw score exactly as score_pool's
                # ``p + prefill_debt(cfg, j)`` (then banding), so partially
                # prefilled / recompute-evicted jobs rank by TOTAL work
                debt = np.maximum(plen[idx] + g - pref[idx], 0
                                  ).astype(np.float64)
                eff = (raw + debt) + band[idx]
            else:
                eff = raw + band[idx]
            if aging > 0:
                le = last_enq[idx]
                m = ~np.isnan(le)
                if m.any():
                    eff[m] -= aging * np.maximum(now - le[m], 0.0)

            # predicted-work refresh (running then waiting, like
            # _form_batch): raw IS max(cached_expected_remaining, 0) for
            # every supported config, so refresh to it directly
            if refresh_work:
                cur = workv[idx]
                if not noisy:
                    # integer-valued: pairwise sum == sequential sum
                    work_node[node] += float(np.sum(raw - cur))
                else:
                    acc = work_node[node]
                    for a, b_ in zip(raw.tolist(), cur.tolist()):
                        acc += a - b_
                    work_node[node] = acc
                workv[idx] = raw

            # ---------------- preemption ------------------------------- #
            weff = eff[nr:]
            weff_l = weff.tolist()
            extra_swap = 0.0   # host<->device KV copy seconds this window
            if pcfg.enabled and nr and wq:
                run_pairs = list(zip(eff[:nr].tolist(), rq))
                nw = len(wq)
                if nw <= _VECTOR_CUTOVER:
                    wait_pairs = list(zip(weff_l, wq))
                else:
                    # only the best min(nr, nw) claimants can ever pair
                    top = np.lexsort((np.arange(nw), weff))[:min(nr, nw)]
                    wait_pairs = [(weff_l[k], wq[k]) for k in top.tolist()]
                swaps = select_preemptions(run_pairs, wait_pairs, pcfg)
                for vid, rid in swaps:
                    rq.remove(vid)
                    state[vid] = WAITING
                    npre[vid] += 1
                    last_enq[vid] = now
                    wq.append(vid)
                    vraw = raw[pool.index(vid)]
                    # swap-vs-recompute treatment of the victim's KV —
                    # same decide_preempt call / cost arithmetic as
                    # ELISFrontend + SimExecutor.preempt_costs
                    mode = "recompute"
                    if swap_policy:
                        n_kv = int(pref[vid])
                        costs = None
                        if n_kv > 0:
                            profv = profiles[node]
                            costs = (
                                2.0 * (swap_lat
                                       + n_kv * profv.kv_bytes_per_token
                                       / swap_bw),
                                profv.prefill_ms(1, n_kv) / 1000.0)
                        mode = decide_preempt(pcfg, costs, float(vraw))
                    if mode == "swap":
                        swapped[vid] = True
                        resident[vid] = False
                        extra_swap += (swap_lat
                                       + int(pref[vid])
                                       * profiles[node].kv_bytes_per_token
                                       / swap_bw)
                        n_swapouts += 1
                    else:
                        resident[vid] = False
                        pref[vid] = 0
                    # re-banded, zero-aging eff of the raw score this
                    # window used (frontend's cached_raw_priority patch,
                    # plus the post-evict/offload prefill debt)
                    if chunked:
                        debt_v = float(max(int(plen[vid]) + int(gen[vid])
                                           - int(pref[vid]), 0))
                        weff_l.append((float(vraw) + debt_v)
                                      + float(band[vid]))
                    else:
                        weff_l.append(float(vraw) + float(band[vid]))
                    k = wq.index(rid)
                    del wq[k]
                    del weff_l[k]
                    qdelay[rid] += max(now - last_enq[rid], 0.0)
                    last_enq[rid] = np.nan
                    state[rid] = RUNNING
                    rq.append(rid)

            # ---------------- fill (select_fills rule) ----------------- #
            free = cap - len(rq)
            if free > 0 and wq:
                if len(wq) <= _VECTOR_CUTOVER:
                    picks = select_fills(weff_l, free)
                else:
                    warr = np.asarray(weff_l)
                    picks = np.lexsort(
                        (np.arange(warr.size), warr))[:free].tolist()
                for jid in [wq[k] for k in picks]:
                    wq.remove(jid)
                    qdelay[jid] += max(now - last_enq[jid], 0.0)
                    last_enq[jid] = np.nan
                    state[jid] = RUNNING
                    rq.append(jid)

            # ---------------- execute (SimExecutor mirror) ------------- #
            batch = list(rq)
            b = len(batch)
            prof = profiles[node]
            dec = decode_cache.get((node, b))
            if dec is None:
                dec = prof.decode_ms(b)
                decode_cache[(node, b)] = dec
            prefill_ms = 0.0
            speedup = prof.prefill_speedup
            for jid in batch:
                if swapped[jid]:
                    # lazy swap-in on dispatch: copy time, KV + prefill
                    # cursor survive (SimExecutor.execute mirror)
                    swapped[jid] = False
                    resident[jid] = True
                    extra_swap += (swap_lat
                                   + int(pref[jid]) * prof.kv_bytes_per_token
                                   / swap_bw)
                    n_swapins += 1
                elif not resident[jid]:
                    nt = int(plen[jid] + gen[jid])
                    if gen[jid] > 0:
                        recompute_toks += nt
                    resident[jid] = True
                    if chunked:
                        pref[jid] = 0  # KV materialises chunk by chunk
                    else:
                        prefill_ms += nt * dec / speedup
                        pref[jid] = nt
            idxb = np.asarray(batch, dtype=np.intp)
            gb = gen[idxb]
            elig = None
            if chunked:
                # decode eligibility BEFORE the chunk advances: a job
                # completing its final chunk decodes from the next window
                goal = plen[idxb] + np.where(gb > 0, gb - 1, 0)
                elig = pref[idxb] >= goal
                if not bool(elig.all()):
                    # at most ONE batch-1 chunk per window, first
                    # incomplete job in batch order
                    k0 = int(np.nonzero(~elig)[0][0])
                    j0 = batch[k0]
                    n_c = min(chunk, int(goal[k0]) - int(pref[j0]))
                    dec1 = decode_cache.get((node, 1))
                    if dec1 is None:
                        dec1 = prof.decode_ms(1)
                        decode_cache[(node, 1)] = dec1
                    prefill_ms += n_c * dec1 / speedup
                    pref[j0] += n_c
            rem = length[idxb] - gb
            n_new = np.minimum(window, rem)
            if chunked:
                n_new = np.where(elig, n_new, 0)
                b_dec = int(elig.sum())
                if b_dec:
                    dec_e = decode_cache.get((node, b_dec))
                    if dec_e is None:
                        dec_e = prof.decode_ms(b_dec)
                        decode_cache[(node, b_dec)] = dec_e
                    decode_ms = int(n_new.max()) * dec_e
                else:
                    decode_ms = 0.0
            else:
                decode_ms = int(n_new.max()) * dec
            duration = overhead + (prefill_ms + decode_ms) / 1000.0
            if extra_swap:
                duration += extra_swap
            end = now + duration
            busy_g[node] = end

            # deadline-straddling windows: drop the tokens, expire at the
            # deadline (frontend's per-job check before applying tokens)
            if has_deadlines:
                dl = deadline[idxb]
                exm = dl < end
                if exm.any():
                    exm_l = exm.tolist()
                    dl_l = dl.tolist()
                    for k, jid in enumerate(batch):
                        if exm_l[k]:
                            rq.remove(jid)
                            expire(jid, node, dl_l[k])
                    keep = ~exm
                    batch = [jid for k, jid in enumerate(batch)
                             if not exm_l[k]]
                    idxb = idxb[keep]
                    gb = gb[keep]
                    rem = rem[keep]
                    n_new = n_new[keep]
                    if elig is not None:
                        elig = elig[keep]

            if batch:
                # Job.prefilled_tokens mirror: decoded jobs' KV now covers
                # prompt + everything generated (read before gen advances)
                if chunked:
                    pref[idxb] = np.where(elig, plen[idxb] + gb + n_new,
                                          pref[idxb])
                else:
                    pref[idxb] = plen[idxb] + gb + n_new
                gen[idxb] = gb + n_new
                niter[idxb] += 1
                ftb = first_tok[idxb]
                first_tok[idxb] = np.where(np.isnan(ftb) & (n_new > 0),
                                           end, ftb)
                fin = n_new >= rem
                fins: List[int] = []
                if track_work:
                    # sequential, interleaving decay-then-finish per job in
                    # batch order — the exact loop's accumulation order
                    # (mid-prefill jobs emit no tokens: no decay, exactly
                    # the frontend's ``if toks`` guard)
                    nn_l = n_new.tolist()
                    fin_l = fin.tolist()
                    acc = work_node[node]
                    for k, jid in enumerate(batch):
                        wv = workv[jid]
                        if nn_l[k] and wv > 0:
                            nv = max(wv - nn_l[k], 0.0)
                            acc += nv - wv
                            workv[jid] = nv
                        if fin_l[k]:
                            acc -= workv[jid]
                            workv[jid] = 0.0
                            fins.append(jid)
                    work_node[node] = acc
                else:
                    fins = [jid for jid, f in zip(batch, fin.tolist()) if f]
                for jid in fins:
                    state[jid] = FINISHED
                    finish[jid] = end
                    rq.remove(jid)
                    active[node] -= 1
                    resident[jid] = False
                    pref[jid] = 0
                    finished_order.append(jid)
            n_windows += 1

            # ---------------- window coalescing ------------------------ #
            if coalesce and rq and not wq:
                idx2 = np.asarray(rq, dtype=np.intp)
                if not has_deadlines or \
                        not np.isfinite(deadline[idx2]).any():
                    rem2 = length[idx2] - gen[idx2]
                    k1 = (int(rem2.min()) - 1) // window
                    if k1 > 0:
                        t_next = arr_l[i_arr] if i_arr < n else INF
                        b2 = len(rq)
                        dec2 = decode_cache.get((node, b2))
                        if dec2 is None:
                            dec2 = profiles[node].decode_ms(b2)
                            decode_cache[(node, b2)] = dec2
                        dur_full = overhead + (window * dec2) / 1000.0
                        k = 0
                        while k < k1 and t_next > end:
                            # bit-exact clock: same sequential accumulation
                            # as k separate windows
                            end = end + dur_full
                            k += 1
                        if k:
                            gen[idx2] += k * window
                            niter[idx2] += k
                            widx[node] += k
                            n_windows += k
                            n_coalesced += k
                            busy_g[node] = end
                            if track_work:
                                total = k * window
                                acc = work_node[node]
                                for jid in rq:
                                    wv = workv[jid]
                                    if wv > 0:
                                        nv = max(wv - total, 0.0)
                                        acc += nv - wv
                                        workv[jid] = nv
                                work_node[node] = acc

            heapq.heappush(bheap, (end, next(seq), node))
            if len(finished_order) - fptr >= flush_every:
                flush(len(finished_order))

        flush(len(finished_order))
        return ScaleResult(
            cfg=cfg, workload=w, state=state, finish=finish,
            first_token=first_tok, queuing_delay=qdelay,
            n_preemptions=npre, n_iterations=niter,
            finished_order=np.asarray(finished_order, dtype=np.int64),
            tenant_summaries=t_sum, n_windows=n_windows,
            n_coalesced=n_coalesced, wall_s=time.perf_counter() - t0,
            n_swapouts=n_swapouts, n_swapins=n_swapins,
            recompute_prefill_tokens=recompute_toks)


# --------------------------------------------------------------------------- #
# Exact reference (validation slices)
# --------------------------------------------------------------------------- #


@dataclass
class ExactResult:
    """The exact event loop's outcome, shaped like :class:`ScaleResult`
    for elementwise comparison."""

    state: np.ndarray
    finish: np.ndarray
    first_token: np.ndarray
    queuing_delay: np.ndarray
    n_preemptions: np.ndarray
    n_iterations: np.ndarray
    finished_order: np.ndarray
    jobs: list
    # executor-side swap/recompute totals, compared against ScaleResult's
    n_swapouts: int = 0
    n_swapins: int = 0
    recompute_prefill_tokens: int = 0


def run_exact_reference(cfg: ScaleSimConfig, w: ScaleWorkload) -> ExactResult:
    """Drive :class:`ELISFrontend` + :class:`SimExecutor` over the same
    workload/config — the ground truth the fast path is validated against."""
    from repro_torch.core.frontend import ELISFrontend, FrontendConfig
    from repro_torch.core.job import Job, JobState
    from repro_torch.core.predictor import make_predictor
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.simulate.executor import SimExecutor

    cfg.validate()
    profs = cfg.profiles()
    base = _resolve_profile(cfg.model).scaled(cfg.hw_speedup)
    node_profiles = None
    if cfg.node_profiles:
        node_profiles = {n: _resolve_profile(name).scaled(cfg.hw_speedup)
                         for n, name in cfg.node_profiles.items()}
    kw = ({} if cfg.sched_overhead_s is None
          else {"sched_overhead_s": cfg.sched_overhead_s})
    executor = SimExecutor(profile=base, node_profiles=node_profiles,
                           swap_bandwidth_bytes_s=cfg.swap_bandwidth_bytes_s,
                           swap_latency_s=cfg.swap_latency_s, **kw)
    predictor = make_predictor(cfg.predictor, seed=cfg.seed + 1,
                               bias=cfg.predictor_bias)
    fcfg = FrontendConfig(
        n_nodes=cfg.n_nodes,
        scheduler=SchedulerConfig(
            policy=cfg.policy, window=cfg.window, batch_size=cfg.batch_size,
            aging_rate=cfg.aging_rate, repredict_every=cfg.repredict_every,
            prefill_chunk=cfg.prefill_chunk, rank_by=cfg.rank_by),
        preemption=cfg.preemption,
        placement=cfg.placement,
        node_token_cost=executor.node_token_cost(cfg.n_nodes),
    )
    fe = ELISFrontend(fcfg, predictor, executor)
    tok = 5
    jobs = []
    for i in range(w.n):
        L = int(w.length[i])
        dl = float(w.deadline[i])
        job = Job(
            job_id=i, prompt=f"scale request {i}",
            prompt_tokens=[tok] * int(w.prompt_len[i]),
            arrival_time=float(w.arrival[i]),
            true_output_len=L, output_tokens=[tok] * L,
            deadline=None if math.isinf(dl) else dl,
            tenant=w.tenants[int(w.tenant_id[i])],
            priority_class=int(w.priority_class[i]),
        )
        jobs.append(job)
        fe.submit(job)
    fe.run()

    n = w.n
    state = np.zeros(n, dtype=np.int8)
    finish = np.full(n, np.nan)
    first_token = np.full(n, np.nan)
    qd = np.zeros(n)
    pre = np.zeros(n, dtype=np.int64)
    it = np.zeros(n, dtype=np.int64)
    code = {JobState.WAITING: WAITING, JobState.RUNNING: RUNNING,
            JobState.PREEMPTED: WAITING, JobState.FINISHED: FINISHED,
            JobState.EXPIRED: EXPIRED}
    for job in jobs:
        state[job.job_id] = code.get(job.state, UNARRIVED)
        if job.finish_time is not None:
            finish[job.job_id] = job.finish_time
        if job.first_token_time is not None:
            first_token[job.job_id] = job.first_token_time
        qd[job.job_id] = job.queuing_delay
        pre[job.job_id] = job.n_preemptions
        it[job.job_id] = job.n_iterations
    order = np.asarray([j.job_id for j in fe.finished], dtype=np.int64)
    assert len(profs) == cfg.n_nodes
    return ExactResult(state=state, finish=finish, first_token=first_token,
                       queuing_delay=qd, n_preemptions=pre, n_iterations=it,
                       finished_order=order, jobs=jobs,
                       n_swapouts=executor.n_swapouts,
                       n_swapins=executor.n_swapins,
                       recompute_prefill_tokens=
                       executor.recompute_prefill_tokens)
