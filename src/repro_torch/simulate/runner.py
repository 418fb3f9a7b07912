"""Experiment runner: workload -> frontend -> metrics (paper §6 harness)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import (
    ElisServer,
    FrontendConfig,
    Job,
    PreemptionConfig,
    SchedulerConfig,
    summarize,
)
from repro_torch.core import predictor as predictor_mod
from repro_torch.core import api
from repro_torch.core.metrics import (
    StreamingSummary,
    fairness_ratio,
    summarize_by_tenant,
)
from repro_torch.data.arrivals import GammaArrivals
from repro_torch.data.workload import (
    Request,
    WorkloadGenerator,
    build_scale_workload,
    bursty_arrival_times,
    scale_workload_requests,
)
from repro_torch.simulate.executor import SimExecutor
from repro_torch.simulate.profiles import PROFILES, ModelProfile, avg_request_rate

#: arrival processes ``ExperimentConfig.arrivals`` dispatches on
ARRIVAL_PROCESSES = ("bursty", "gamma")


def requests_to_jobs(requests: List[Request]) -> List[Job]:
    return [
        Job(
            job_id=r.request_id,
            prompt=r.prompt,
            prompt_tokens=r.prompt_tokens,
            arrival_time=r.arrival_time,
            true_output_len=r.true_output_len,
            output_tokens=r.output_tokens,
        )
        for r in requests
    ]


@dataclass
class ExperimentConfig:
    model: str = "lam13"
    policy: str = "isrtf"
    n_requests: int = 200         # paper: 200 prompts per experiment
    n_nodes: int = 1
    batch_size: int = 4           # paper Table 5: batch size 4
    rps_multiple: float = 1.0     # multiple of AVG.RequestRate
    window: int = 50
    predictor: str = "noisy_oracle"  # oracle | noisy_oracle | bge
    seed: int = 0
    aging_rate: float = 0.0
    preemption: PreemptionConfig = field(default_factory=PreemptionConfig)
    #: override arrival rate directly (req/s); None = rps_multiple formula
    rate_override: Optional[float] = None
    #: hardware speed multiplier (Fig 7 uses H100s: see profiles.H100_SPEEDUP)
    hw_speedup: float = 1.0
    #: full predictor re-score every N scheduling windows (ALISE-style
    #: staleness; 1 = the paper's every-window Algorithm 1)
    repredict_every: int = 1
    #: cluster placement policy: least_jobs | least_predicted_work | least_eta
    placement: str = "least_jobs"
    #: cross-node work-stealing of queued jobs at node_free events
    rebalance: bool = False
    #: predicted-work imbalance (tokens) that triggers stealing
    rebalance_threshold: float = 200.0
    #: heterogeneous cluster: node id -> profile name (PROFILES key); nodes
    #: absent from the map run ``model``'s profile.  hw_speedup applies to
    #: every node.
    node_profiles: Optional[Dict[int, str]] = None
    #: arrival process: "gamma" (FabriX-calibrated) | "bursty" (flash
    #: crowds, repro_torch.data.workload.bursty_arrival_times)
    arrivals: str = "gamma"
    #: run a registered traffic scenario (repro_torch.data.workload.SCENARIOS:
    #: diurnal | multi_tenant_slo | flash_crowd) instead of the default
    #: LMSYS-style workload + ``arrivals`` process; scenario workloads carry
    #: their own arrivals, tenants, priority classes and SLO targets, and
    #: the summary gains per-tenant metrics + a JCT fairness ratio
    scenario: Optional[str] = None
    #: requests per flash crowd when ``arrivals="bursty"``
    burst_size: int = 8
    #: serving-time calibration over the base predictor:
    #: none | ema | conformal | ema+conformal
    #: (repro_torch.core.predictor.wrap_calibration)
    calibrate: str = "none"
    #: risk-aware ISRTF: rank on this calibrated upper quantile instead of
    #: the point estimate (None = the paper's mean ranking)
    risk_quantile: Optional[float] = None
    #: pool-ordering source for re-predicting policies: "magnitude" (the
    #: calibrated mean / risk quantile) | "rank_score" (the learning-to-rank
    #: head — needs predictor="ranked" with a two-head bge).  Load
    #: accounting stays on the mean either way (SchedulerConfig.rank_by)
    rank_by: str = "magnitude"
    #: synthetic multiplicative mis-calibration injected into the noisy
    #: oracle (< 1 = systematic underestimates); 1.0 = unbiased
    predictor_bias: float = 1.0
    #: feed ground-truth remaining to predictor.observe every window (the
    #: simulator replays realised lengths, so truth is available mid-flight)
    observe_in_flight: bool = True
    #: chunked prefill: split prompt ingestion into chunks of this many
    #: tokens, at most one chunk per scheduling window, interleaved with
    #: decode (None = one-shot prefill)
    prefill_chunk: Optional[int] = None
    #: host<->device KV transfer bandwidth/latency the swap preemption
    #: tier is priced with (PreemptionConfig.policy = swap | auto)
    swap_bandwidth_bytes_s: float = 16e9
    swap_latency_s: float = 0.0005


def make_predictor(kind: str, seed: int = 0, bge=None, *,
                   calibration=None, bias: float = 1.0):
    """Back-compat wrapper over :func:`repro_torch.core.predictor.make_predictor`
    (the registry), keeping the old positional (kind, seed, bge) call."""
    cal = None if calibration in (None, "none") else calibration
    return predictor_mod.make_predictor(kind, seed=seed, bge=bge,
                                        calibration=cal, bias=bias)


def run_experiment(cfg: ExperimentConfig, *, bge=None,
                   requests: Optional[List[Request]] = None,
                   stream_metrics: bool = False) -> Dict[str, float]:
    try:
        profile = PROFILES[cfg.model]
    except KeyError:
        raise ValueError(f"unknown model {cfg.model!r} "
                         f"(have {sorted(PROFILES)})") from None
    if cfg.hw_speedup != 1.0:
        profile = profile.scaled(cfg.hw_speedup)
    rng = np.random.RandomState(cfg.seed)

    rate = cfg.rate_override
    if rate is None:
        rate = avg_request_rate(profile, cfg.batch_size) * cfg.rps_multiple
        rate *= cfg.n_nodes
    scale_w = None
    if cfg.scenario is not None:
        if requests is not None:
            raise ValueError(
                "ExperimentConfig.scenario and explicit requests are "
                "mutually exclusive — scenarios build their own workload")
        # fails loudly on unknown names, listing the registry
        scale_w = build_scale_workload(cfg.scenario, cfg.n_requests, rate,
                                       rng)
        requests = scale_workload_requests(scale_w)
    else:
        if requests is None:
            gen = WorkloadGenerator(seed=cfg.seed)
            requests = gen.sample_requests(cfg.n_requests)
        if cfg.arrivals == "bursty":
            times = bursty_arrival_times(len(requests), rate, rng,
                                         burst_size=cfg.burst_size)
        elif cfg.arrivals == "gamma":
            times = GammaArrivals().rate_scaled(rate).sample_arrival_times(
                len(requests), rng)
        else:
            raise ValueError(f"unknown arrivals {cfg.arrivals!r} "
                             f"(have {list(ARRIVAL_PROCESSES)})")
        for r, t in zip(requests, times):
            r.arrival_time = float(t)

    node_profiles = None
    if cfg.node_profiles:
        node_profiles = {
            int(n): (PROFILES[name].scaled(cfg.hw_speedup)
                     if cfg.hw_speedup != 1.0 else PROFILES[name])
            for n, name in cfg.node_profiles.items()
        }
    executor = SimExecutor(profile, node_profiles=node_profiles,
                           swap_bandwidth_bytes_s=cfg.swap_bandwidth_bytes_s,
                           swap_latency_s=cfg.swap_latency_s)

    predictor = make_predictor(cfg.predictor, seed=cfg.seed + 1, bge=bge,
                               calibration=cfg.calibrate,
                               bias=cfg.predictor_bias)
    fe_cfg = FrontendConfig(
        n_nodes=cfg.n_nodes,
        scheduler=SchedulerConfig(
            policy=cfg.policy, window=cfg.window, batch_size=cfg.batch_size,
            aging_rate=cfg.aging_rate, repredict_every=cfg.repredict_every,
            risk_quantile=cfg.risk_quantile,
            prefill_chunk=cfg.prefill_chunk,
            rank_by=cfg.rank_by,
        ),
        preemption=cfg.preemption,
        placement=cfg.placement,
        node_token_cost=executor.node_token_cost(cfg.n_nodes),
        rebalance=cfg.rebalance,
        rebalance_threshold=cfg.rebalance_threshold,
        observe_in_flight=cfg.observe_in_flight,
    )
    server = ElisServer(fe_cfg, predictor, executor)
    for r in requests:
        server.submit(api.Request.from_workload(r))
    slo_targets = dict(scale_w.slo_targets) if scale_w is not None else {}
    if stream_metrics:
        # constant-memory aggregation: responses are consumed (and their
        # job records released) as they stream out of the server
        g = StreamingSummary()
        per_tenant: Dict[str, StreamingSummary] = {}
        n_unfinished = 0
        for resp in server.drain_stream():
            if not resp.ok:
                n_unfinished += 1
                continue
            g.add_response(resp)
            s = per_tenant.get(resp.tenant)
            if s is None:
                s = per_tenant[resp.tenant] = StreamingSummary(
                    slo_target=slo_targets.get(resp.tenant))
            s.add_response(resp)
        server.frontend.state.assert_drained()
        m = g.summarize()
        m["n_finished"] = g.n
        m["n_unfinished"] = n_unfinished
        if cfg.scenario is not None:
            m["tenants"] = {t: s.summarize()
                            for t, s in sorted(per_tenant.items())}
            m["fairness_jct"] = fairness_ratio(
                {t: s.sketch.mean for t, s in per_tenant.items()})
    else:
        responses = server.drain()
        # cluster-accounting invariant: every admitted job is terminal, so
        # the load balancer's live-count and predicted-work totals are back
        # to zero
        server.frontend.state.assert_drained()
        done = [r for r in responses if r.ok]
        m = summarize(done)
        m["n_finished"] = len(done)
        m["n_unfinished"] = len(responses) - len(done)
        if cfg.scenario is not None:
            m["tenants"] = summarize_by_tenant(done, slo_targets)
            m["fairness_jct"] = fairness_ratio(
                {t: s["jct_mean"] for t, s in m["tenants"].items()})
    m.update(executor.counters())
    m["migrations"] = server.frontend.migrations
    return m


def compare_policies(base_cfg: ExperimentConfig, policies=("fcfs", "isrtf", "sjf"),
                     *, bge=None, n_trials: int = 3) -> Dict[str, Dict]:
    """Paper §6.2: same sampled prompts, shuffled per trial, 3 repeats."""
    import dataclasses

    out: Dict[str, Dict] = {}
    for pol in policies:
        trials = []
        for t in range(n_trials):
            cfg = dataclasses.replace(
                base_cfg,
                policy=pol,
                seed=base_cfg.seed + 1000 * t,
                predictor="oracle" if pol == "sjf" else base_cfg.predictor,
            )
            trials.append(run_experiment(cfg, bge=bge))
        agg = {
            k: float(np.mean([tr[k] for tr in trials]))
            for k in trials[0]
        }
        agg["jct_mean_min"] = float(np.min([tr["jct_mean"] for tr in trials]))
        agg["jct_mean_max"] = float(np.max([tr["jct_mean"] for tr in trials]))
        out[pol] = agg
    return out
