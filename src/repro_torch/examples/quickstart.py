"""Quickstart: serve a reduced model through the ELIS online API.

    python -m repro_torch.examples.quickstart [--device cpu]

Builds a reduced qwen2-1.5b, submits a handful of prompts with bursty
(Gamma) arrivals through :class:`ElisServer`, streams one response chunk by
chunk, and prints per-request JCT under the ISRTF scheduler driving the
live engine (its kernels on the card, their plain versions on the CPU).
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import (
    ElisServer,
    FrontendConfig,
    OraclePredictor,
    Request,
    RequestOptions,
    SchedulerConfig,
    summarize,
)
from repro_torch.data import GammaArrivals, HashTokenizer
from repro_torch.device import device_or_exit
from repro_torch.engine import EngineConfig, EngineExecutor, InferenceEngine
from repro_torch.models import init_params

PROMPTS = [
    ("what is the weather forecast", 8),
    ("write a long detailed story about a storm", 24),
    ("yes or no: is it raining", 6),
    ("explain how rain forms step by step", 16),
]


def main(argv=None):
    """Run the example; returns the responses, in request order."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = device_or_exit(args.device)
    cfg = get_config("qwen2-1.5b").reduced()
    print(f"model: {cfg.arch_id} ({cfg.n_layers}L d={cfg.d_model})")
    params = init_params(cfg, torch.Generator(device).manual_seed(0))
    engine = InferenceEngine(cfg, params, EngineConfig(
        max_slots=2, max_len=256, max_output=24, eos_id=-1,
        respect_job_max=True), device=device)

    server = ElisServer(
        FrontendConfig(n_nodes=1,
                       scheduler=SchedulerConfig(policy="isrtf", window=8,
                                                 batch_size=2)),
        OraclePredictor(),
        EngineExecutor({0: engine}),
    )

    tok = HashTokenizer()
    rng = np.random.RandomState(0)
    arrivals = GammaArrivals().rate_scaled(2.0).sample_arrival_times(
        len(PROMPTS), rng)
    handles = []
    for (text, length), t in zip(PROMPTS, arrivals):
        handles.append(server.submit(Request(
            prompt=text, prompt_tokens=tok.encode(text),
            arrival_time=float(t), true_output_len=length,
            options=RequestOptions(max_tokens=length, stream=True))))

    # stream the first request token-chunk by token-chunk (this steps the
    # scheduler just far enough to produce each chunk)
    print("\nstreaming request 0:")
    for chunk in server.stream(handles[0]):
        tail = " (final)" if chunk.final else ""
        print(f"  t={chunk.t:6.2f}s iter {chunk.index}: "
              f"{len(chunk.tokens)} tokens{tail}")

    # then drain the rest of the system to completion
    responses = server.drain()
    print(f"\n{'req':>3s} {'len':>4s} {'JCT s':>8s} {'queue s':>8s}  prompt")
    for r, (text, _) in zip(responses, PROMPTS):
        print(f"{r.request_id:3d} {r.n_tokens:4d} {r.jct():8.2f} "
              f"{r.queuing_delay:8.2f}  {text[:40]}")
    m = summarize(responses)
    print(f"\nmean JCT {m['jct_mean']:.2f}s; mean queuing delay "
          f"{m['queuing_delay_mean']:.2f}s; throughput "
          f"{m['throughput_rps']:.2f} req/s")
    return responses


if __name__ == "__main__":
    main()
