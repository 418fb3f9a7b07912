"""End-to-end serving driver (the paper's system, reduced scale).

    python -m repro_torch.examples.serve_isrtf [--jobs 12] [--device cpu]

Serves a stream of Gamma-arrival requests on the live engine under all
three schedulers (FCFS, ISRTF, SJF-oracle) through the online
:class:`ElisServer` API and prints the JCT comparison: the full ELIS
pipeline, workload -> frontend (Algorithm 1) -> priority buffer ->
continuous-batching engine -> iterative re-prediction.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import (
    ElisServer,
    FrontendConfig,
    OraclePredictor,
    PreemptionConfig,
    Request,
    RequestOptions,
    SchedulerConfig,
    summarize,
)
from repro_torch.data import GammaArrivals, HashTokenizer
from repro_torch.device import device_or_exit
from repro_torch.engine import EngineConfig, EngineExecutor, InferenceEngine
from repro_torch.models import init_params

POLICIES = ("fcfs", "isrtf", "sjf")


def make_requests(n, seed=0, max_tokens=40):
    tok = HashTokenizer()
    rng = np.random.RandomState(seed)
    arrivals = GammaArrivals().rate_scaled(1.5).sample_arrival_times(n, rng)
    reqs = []
    for i in range(n):
        length = int(rng.choice([6, 12, 40], p=[0.5, 0.3, 0.2]))
        text = f"request {i} with target verbosity {length}"
        reqs.append(Request(
            prompt=text, prompt_tokens=tok.encode(text),
            arrival_time=float(arrivals[i]),
            true_output_len=length,
            options=RequestOptions(max_tokens=max_tokens)))
    return reqs


def main(argv=None):
    """Run the example; returns ``{policy: (summary, responses)}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=12)
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = device_or_exit(args.device)

    cfg = get_config("qwen2-1.5b").reduced()
    params = init_params(cfg, torch.Generator(device).manual_seed(0))

    results = {}
    for policy in POLICIES:
        engine = InferenceEngine(cfg, params, EngineConfig(
            max_slots=2, max_len=256, max_output=40, eos_id=-1,
            respect_job_max=True), device=device)
        server = ElisServer(
            FrontendConfig(
                n_nodes=1,
                scheduler=SchedulerConfig(policy=policy, window=args.window,
                                          batch_size=2),
                preemption=PreemptionConfig(enabled=policy != "fcfs"),
            ),
            OraclePredictor() if policy != "fcfs" else None,
            EngineExecutor({0: engine}),
        )
        for r in make_requests(args.jobs):
            server.submit(r)
        responses = server.drain()
        m = summarize(responses)
        results[policy] = (m, responses)
        print(f"{policy:6s}: mean JCT {m['jct_mean']:7.2f}s  "
              f"queue {m['queuing_delay_mean']:6.2f}s  "
              f"preemptions {m['preemptions']:.0f}")

    base = results["fcfs"][0]["jct_mean"]
    for policy in ("isrtf", "sjf"):
        gain = 100 * (base - results[policy][0]["jct_mean"]) / base
        print(f"{policy} vs fcfs: {gain:+.1f}% JCT")
    return results


if __name__ == "__main__":
    main()
