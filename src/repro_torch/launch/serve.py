"""Serving launcher — the port of ``repro.launch.serve``.

Assembles the ELIS stack from CLI args: N backend workers (each an
``InferenceEngine`` on the selected ``--arch``), the frontend scheduler with
the chosen policy, and either a trace file or a synthetic stream.  On the
card (``--device cuda``, the default) it serves the published config of
``--arch`` in its dtype through the hand-written kernels; with ``--device
cpu`` it serves the reduced config, as the reference's CLI does on its CPU.
Weights are random, from seed 0.

    python -m repro_torch.launch.serve --arch qwen2-1.5b --n 12
    python -m repro_torch.launch.serve --arch zamba2-7b --mesh 1x2 --n 12
    python -m repro_torch.launch.serve --device cpu --mesh 1x2 \\
        --arch qwen2-vl-7b --n 12
    python -m repro_torch.launch.serve --device cpu --policy isrtf \\
        --prefill-chunk 8 --preempt-policy swap --n 12

    python -m repro_torch.launch.serve --device cpu --predictor bge \\
        --calibrate ema+conformal --n 6

Prints one JSON line per request and a summary on stderr.  ``--predictor
bge`` ranks with the BGE length predictor (a small encoder, random from
seed 0 unless ``--predictor-ckpt`` restores a trained one, on
``--device``).  ``--mesh DxM`` serves D tensor-parallel pods of M ranks
(dense, MoE, SSM, hybrid and vlm archs), chunked prefill (the SSM and
hybrid archs fall back to one-shot prefill, as on one device) and swap
included; on a machine with fewer cards than ranks, ranks share cards.
``--arch qwen2-vl-7b`` serves text, as the reference's CLI does, on one
device or a pod; ``--arch whisper-large-v3`` exits at launch, with or
without ``--mesh``: a request carries no audio frames for its encoder.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.core import (
    PLACEMENTS,
    PREEMPT_POLICIES,
    BGEPredictor,
    ElisServer,
    FrontendConfig,
    OraclePredictor,
    PredictorConfig,
    PreemptionConfig,
    Request,
    RequestOptions,
    SchedulerConfig,
    fairness_ratio,
    summarize,
    summarize_by_tenant,
    wrap_calibration,
)
from repro_torch.core.job import Job
from repro_torch.data import GammaArrivals, WorkloadGenerator
from repro_torch.data.workload import (
    SCENARIOS,
    build_scale_workload,
    scale_workload_requests,
)
from repro_torch.device import resolve_device
from repro_torch.engine.engine import AUDIO_PREFILL_NOT_SERVED
from repro_torch.engine import (
    EngineConfig,
    EngineExecutor,
    InferenceEngine,
    make_tp_pods,
)
from repro_torch.launch.mesh import visible_devices
from repro_torch.models import transformer as T
from repro_torch.models.encoder import EncoderArchConfig
from repro_torch.training import latest_step, restore_checkpoint

#: the probe windows' lengths: each probe pass runs one of each
PROBE_WINDOWS = (4, 16)


def parse_mesh(spec: str):
    """Parse a ``--mesh`` shape string into ``(D, M)``.

    The only accepted form is ``DxM`` — exactly two ``x``-separated
    positive integers (e.g. ``2x4``).  Anything else (``2x``, ``2x3x4``,
    ``ax4``, ``0x4``, ``2x-1``) raises :class:`ValueError` naming the
    offending spec and the expected format, so a typo dies at launch
    instead of materialising a mis-shaped device mesh.
    """
    parts = spec.lower().split("x")
    if len(parts) != 2 or not all(p.strip() for p in parts):
        raise ValueError(
            f"--mesh wants exactly two 'x'-separated fields DxM "
            f"(e.g. 2x4), got {spec!r}")
    try:
        d, m = (int(p) for p in parts)
    except ValueError:
        raise ValueError(
            f"--mesh wants integer dimensions DxM (e.g. 2x4), "
            f"got {spec!r}") from None
    if d < 1 or m < 1:
        raise ValueError(
            f"--mesh dimensions must be positive integers DxM "
            f"(e.g. 2x4), got {spec!r}")
    return d, m


def load_requests(args):
    """The requests to serve and the scenario's per-tenant SLO targets."""
    if args.scenario:
        if args.trace:
            sys.exit("--scenario and --trace are mutually exclusive")
        rng = np.random.RandomState(args.seed)
        w = build_scale_workload(args.scenario, args.n, args.rate, rng)
        # scenario workloads carry tenant / priority / deadline per request;
        # from_workload forwards them into RequestOptions so the frontend's
        # priority banding and SLO accounting see them
        reqs = [Request.from_workload(r) for r in scale_workload_requests(w)]
        return reqs, dict(w.slo_targets)
    if args.trace:
        reqs = []
        with open(args.trace) as f:
            for line in f:
                r = json.loads(line)
                reqs.append(Request(
                    request_id=r["request_id"], prompt=r["prompt"],
                    prompt_tokens=r["prompt_tokens"],
                    arrival_time=r["arrival_time"],
                    true_output_len=r.get("max_tokens", args.max_output),
                    options=RequestOptions(max_tokens=args.max_output,
                                           deadline=r.get("deadline")),
                ))
        return reqs, {}
    gen = WorkloadGenerator(seed=args.seed)
    rng = np.random.RandomState(args.seed)
    times = GammaArrivals().rate_scaled(args.rate).sample_arrival_times(
        args.n, rng)
    reqs = []
    for i, t in enumerate(times):
        r = gen.sample_request()
        reqs.append(Request(
            request_id=i, prompt=r.prompt, prompt_tokens=r.prompt_tokens,
            arrival_time=float(t), true_output_len=r.true_output_len,
            options=RequestOptions(max_tokens=args.max_output)))
    return reqs, {}


def probe_node_costs(executor, reps: int):
    """Fit per-pod token costs live before serving: run ``reps`` probe
    windows per (batch, window) cell on every pod and least-squares the
    measurements (``calibrated_node_profiles``).  The first window of each
    shape pays one-off launch costs and is dropped by the fit — probing
    doubles as warmup, so serving never pays those costs mid-traffic."""
    jid = 10 ** 9  # out of any real request-id range
    for node, eng in executor.engines.items():
        batches = sorted({1, min(2, eng.cfg.max_slots)})
        for _ in range(reps + 1):  # +1: the dropped first window
            for batch in batches:
                for window in PROBE_WINDOWS:
                    jobs = [Job(job_id=jid + i, prompt="probe",
                                prompt_tokens=[7, 8, 9, 10],
                                arrival_time=0.0)
                            for i in range(batch)]
                    executor.execute(node, jobs, window, now=0.0)
                    for j in jobs:
                        executor.evict(node, j)
    return executor.node_token_cost()


def build_predictor(args, device="cuda"):
    """The length predictor ``--predictor`` names, on ``device``, wrapped
    in the ``--calibrate`` wrappers."""
    if args.predictor == "oracle":
        base = OraclePredictor()
    else:
        cfg = PredictorConfig(
            encoder=EncoderArchConfig(d_model=128, n_heads=4, n_layers=3,
                                      d_ff=256, max_len=192),
            n_fc_layers=8, fc_hidden=256, max_len=192,
        )
        base = BGEPredictor(cfg, seed=0, device=device)
        if args.predictor_ckpt:
            step = latest_step(args.predictor_ckpt)
            if step is None:
                sys.exit(f"no checkpoint in {args.predictor_ckpt}")
            base.params, _ = restore_checkpoint(args.predictor_ckpt, step,
                                                base.params)
    # serving-time calibration wrappers compose over any base predictor;
    # the live loop feeds them finish-time observations (ELIS frontend
    # calls predictor.observe as requests complete)
    cal = None if args.calibrate == "none" else args.calibrate
    return wrap_calibration(base, cal)


def _refuse_unported(args) -> None:
    """Exit at launch on a flag whose slice is not ported yet; never serve
    something else in its place."""
    if get_config(args.arch).family == "audio":
        sys.exit(f"--arch {args.arch}: {AUDIO_PREFILL_NOT_SERVED} "
                 "(ROADMAP.md, section 3)")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-1.5b", choices=list(list_archs()))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the published config through the "
                         "hand-written kernels; cpu: the reduced config "
                         "(never a fallback: cuda without a card exits)")
    ap.add_argument("--policy", default="isrtf",
                    choices=["fcfs", "sjf", "isrtf", "mlfq"])
    ap.add_argument("--predictor", default="oracle",
                    choices=["oracle", "bge"])
    ap.add_argument("--predictor-ckpt", default=None,
                    help="restore a trained BGE predictor (a checkpoint of "
                         "examples/train_predictor.py, JAX or port)")
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="shard the serving fleet over a DxM data×model "
                         "device mesh: D tensor-parallel pods of M devices "
                         "each (supersedes --workers; D*M ranks on the "
                         "visible cards, which ranks share when there are "
                         "fewer, or D*M CPU ranks with --device cpu)")
    ap.add_argument("--pods", type=int, default=None,
                    help="with --mesh DxM: use only the first N of the D "
                         "data rows as live pods (default: all D)")
    ap.add_argument("--placement", default="least_jobs",
                    choices=sorted(PLACEMENTS),
                    help="cluster placement policy consulted at arrival "
                         "(prediction-aware modes need a length predictor; "
                         "least_eta uses per-pod token costs fitted by "
                         "--probe-nodes, else assumes uniform speed)")
    ap.add_argument("--probe-nodes", type=int, default=0, metavar="REPS",
                    help="before serving, run REPS calibration windows per "
                         "pod and fit per-node token costs from the live "
                         "measurements (wired into least_eta placement)")
    ap.add_argument("--rebalance", action="store_true",
                    help="steal queued jobs across workers when the "
                         "predicted-work imbalance exceeds the threshold")
    ap.add_argument("--rebalance-threshold", type=float, default=200.0,
                    help="predicted-token imbalance that triggers stealing")
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--repredict-every", type=int, default=1,
                    help="full predictor re-score every N windows (between "
                         "them cached predictions decay by progress)")
    ap.add_argument("--calibrate", default="none",
                    choices=["none", "ema", "conformal", "ema+conformal"],
                    help="serving-time calibration over the predictor: EMA "
                         "multiplicative debiasing and/or conformal "
                         "quantiles from finish-time residuals")
    ap.add_argument("--risk-quantile", type=float, default=None,
                    help="rank ISRTF on this calibrated upper quantile of "
                         "the predicted remaining length instead of the "
                         "point estimate (e.g. 0.9 hedges against "
                         "underestimates)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    metavar="TOKENS",
                    help="chunked prefill: ingest each prompt in chunks of "
                         "this many tokens, at most one chunk per "
                         "scheduling window, interleaved with decode "
                         "(default: one-shot prefill)")
    ap.add_argument("--preempt-policy", default="recompute",
                    choices=list(PREEMPT_POLICIES),
                    help="what preemption does to the victim's KV cache: "
                         "recompute = evict and re-prefill on resume; "
                         "swap = offload to host memory and restore; "
                         "auto = per-victim break-even between the two on "
                         "predicted remaining length")
    ap.add_argument("--swap-bandwidth", type=float, default=16e9,
                    metavar="BYTES_PER_S",
                    help="host<->device KV transfer bandwidth the swap "
                         "preemption tier is priced with")
    ap.add_argument("--swap-latency", type=float, default=5e-4, metavar="S",
                    help="fixed per-transfer latency of one KV swap leg")
    ap.add_argument("--swap-pool", type=int, default=None, metavar="TOKENS",
                    help="watermark bounding each engine's host KV swap "
                         "pool, in stashed context tokens; over-watermark "
                         "swap-outs evict the coldest stashed victims to "
                         "recompute-fallback (default: unbounded)")
    ap.add_argument("--max-output", type=int, default=32)
    ap.add_argument("--trace", default=None)
    ap.add_argument("--scenario", default=None, choices=sorted(SCENARIOS),
                    help="run a registered traffic scenario instead of the "
                         "default synthetic stream: --n requests at --rate "
                         "mean req/s, with per-tenant arrival processes, "
                         "priority classes and SLO targets; the summary "
                         "gains per-tenant metrics and a JCT fairness ratio")
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--rate", type=float, default=1.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-preemption", action="store_true")
    return ap


def main(argv=None):
    """Serve as the command line asks; returns the responses and the
    executor, for callers that drive the CLI in-process."""
    args = _parser().parse_args(argv)
    _refuse_unported(args)
    if args.prefill_chunk is not None and args.prefill_chunk < 1:
        sys.exit(f"--prefill-chunk must be >= 1, got {args.prefill_chunk}")
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        sys.exit(f"--device {args.device}: {e}")
    cfg = get_config(args.arch)
    if device.type == "cpu":
        cfg = cfg.reduced()
    ecfg = EngineConfig(
        max_slots=args.slots, max_len=512, max_output=args.max_output,
        eos_id=-1, respect_job_max=True, attn_impl="kernel")
    params = T.init_params(cfg, torch.Generator(device).manual_seed(0))
    if device.type == "cuda":
        print(f"[serve] device {torch.cuda.get_device_name(device)}, "
              f"{cfg.dtype}", file=sys.stderr)
    if args.mesh:
        try:
            d, m = parse_mesh(args.mesh)
        except ValueError as e:
            sys.exit(str(e))
        n_pods = args.pods if args.pods is not None else d
        if not 1 <= n_pods <= d:
            sys.exit(f"--pods {n_pods} outside the mesh's {d} data rows")
        args.workers = n_pods
        devices = [device] * (n_pods * m)
        if device.type == "cuda":
            # one rank a card while they last; ranks share them beyond
            cards = visible_devices()
            devices = [cards[i % len(cards)] for i in range(n_pods * m)]
        try:
            engines = make_tp_pods(cfg, params, ecfg, n_pods=n_pods, tp=m,
                                   devices=devices)
        except RuntimeError as e:
            sys.exit(f"--mesh {args.mesh}: {e}")
        print(f"[serve] {n_pods} TP={m} pod(s) x {args.slots} slots over "
              f"{n_pods * m} ranks on {len(set(devices))} device(s), "
              f"{cfg.arch_id}, policy={args.policy}", file=sys.stderr)
    else:
        engines = {n: InferenceEngine(cfg, params, ecfg, device=device)
                   for n in range(args.workers)}
        print(f"[serve] {args.workers} worker(s) x {args.slots} slots, "
              f"{cfg.arch_id}, policy={args.policy}", file=sys.stderr)
    # prediction-aware placement / rebalancing consume length predictions
    # even when the ordering policy (fcfs/mlfq) does not; rebalancing is
    # meaningful only across workers
    if args.rebalance and args.workers < 2:
        print("[serve] --rebalance ignored with a single worker",
              file=sys.stderr)
    needs_predictor = (args.policy in ("sjf", "isrtf")
                       or args.placement != "least_jobs"
                       or (args.rebalance and args.workers > 1))
    predictor = build_predictor(args, device) if needs_predictor else None
    executor = EngineExecutor(engines,
                              swap_bandwidth_bytes_s=args.swap_bandwidth,
                              swap_latency_s=args.swap_latency,
                              swap_pool_tokens=args.swap_pool)
    node_token_cost = None
    if args.probe_nodes > 0:
        node_token_cost = probe_node_costs(executor, args.probe_nodes)
        executor.window_log.clear()  # probe windows are not served traffic
        print("[serve] probed node token costs: "
              + "  ".join(f"{n}={c * 1000:.2f}ms/tok"
                          for n, c in sorted(node_token_cost.items())),
              file=sys.stderr)
    server = ElisServer(
        FrontendConfig(
            n_nodes=args.workers,
            scheduler=SchedulerConfig(policy=args.policy, window=args.window,
                                      batch_size=args.slots,
                                      repredict_every=args.repredict_every,
                                      risk_quantile=args.risk_quantile,
                                      prefill_chunk=args.prefill_chunk),
            preemption=PreemptionConfig(enabled=not args.no_preemption,
                                        policy=args.preempt_policy,
                                        swap_pool_tokens=args.swap_pool),
            placement=args.placement,
            node_token_cost=node_token_cost,
            rebalance=args.rebalance,
            rebalance_threshold=args.rebalance_threshold,
            # the live engine only reveals a request's length at finish
            observe_in_flight=False,
        ),
        predictor,
        executor,
    )
    requests, slo_targets = load_requests(args)
    for r in requests:
        server.submit(r)
    responses = server.drain()
    for r in sorted(responses, key=lambda r: r.request_id):
        rec = {
            "request_id": r.request_id,
            "node": r.node,
            "status": r.status.value,
            "n_tokens": r.n_tokens,
            "jct_s": round(r.jct(), 3),
            "queuing_delay_s": round(r.queuing_delay, 3),
            "preemptions": r.n_preemptions,
            "migrations": r.n_migrations,
        }
        if args.scenario:
            rec["tenant"] = r.tenant
        print(json.dumps(rec))
    finished = [r for r in responses if r.ok]
    m = summarize(finished)
    print(f"[serve] mean JCT {m['jct_mean']:.2f}s  queue "
          f"{m['queuing_delay_mean']:.2f}s  throughput "
          f"{m['throughput_rps']:.2f} req/s  "
          f"placement={args.placement} "
          f"migrations={server.frontend.migrations}  "
          f"({len(finished)}/{len(responses)} finished)", file=sys.stderr)
    ec = executor.counters()
    if ec["chunk_dispatches"] or ec["swapouts"]:
        print(f"[serve] chunk_dispatches={ec['chunk_dispatches']} "
              f"(traces {ec['chunk_traces']})  "
              f"swapouts={ec['swapouts']} swapins={ec['swapins']}  "
              f"resume_prefill_tokens={ec['resume_context_tokens']}",
              file=sys.stderr)
    if args.scenario:
        tenants = summarize_by_tenant(finished, slo_targets)
        # expiry is a per-tenant outcome (deadline-heavy agent traffic):
        # count over ALL responses — expired ones never reach `finished`
        submitted, expired = {}, {}
        for r in responses:
            submitted[r.tenant] = submitted.get(r.tenant, 0) + 1
            if r.status.value == "expired":
                expired[r.tenant] = expired.get(r.tenant, 0) + 1
        for t, tm in sorted(tenants.items()):
            slo = (f"  slo_attainment {tm['slo_attainment']:.2f}"
                   if "slo_attainment" in tm else "")
            exp = expired.get(t, 0) / max(submitted.get(t, 0), 1)
            print(f"[serve]   tenant={t:<12} n={tm['n']:<5} mean JCT "
                  f"{tm['jct_mean']:.2f}s  p99 {tm['jct_p99']:.2f}s"
                  f"{slo}  expiry_rate {exp:.2f}", file=sys.stderr)
        fair = fairness_ratio(
            {t: tm["jct_mean"] for t, tm in tenants.items()})
        print(f"[serve]   fairness(max/min mean JCT) {fair:.2f}",
              file=sys.stderr)
    return responses, executor


if __name__ == "__main__":
    main()
