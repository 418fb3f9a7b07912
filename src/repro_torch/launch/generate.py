"""Stand-alone request generator (paper §6.1): the port of
``repro.launch.generate``, over the port's copies of the workload and the
arrival processes.

Emits a JSONL trace of requests with Gamma(0.73, 10.41) arrivals — the
FabriX-calibrated process — or Poisson ones, which
``repro_torch.launch.serve --trace`` replays.  For the same arguments it
writes the same lines as the reference, byte for byte.

    python -m repro_torch.launch.generate --n 200 --rate 2.0 --out trace.jsonl
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from repro_torch.data import GammaArrivals, PoissonArrivals, WorkloadGenerator


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--rate", type=float, default=None,
                    help="mean req/s (default: the raw FabriX fit)")
    ap.add_argument("--process", default="gamma",
                    choices=["gamma", "poisson"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="-")
    args = ap.parse_args(argv)

    rng = np.random.RandomState(args.seed)
    gen = WorkloadGenerator(seed=args.seed)
    if args.process == "gamma":
        proc = GammaArrivals()
        if args.rate:
            proc = proc.rate_scaled(args.rate)
    else:
        proc = PoissonArrivals(rate=args.rate or 1.0)
    times = proc.sample_arrival_times(args.n, rng)

    out = sys.stdout if args.out == "-" else open(args.out, "w")
    for t in times:
        r = gen.sample_request()
        rec = {
            "request_id": r.request_id,
            "arrival_time": round(float(t), 4),
            "prompt": r.prompt,
            "prompt_tokens": r.prompt_tokens,
            "max_tokens": r.true_output_len,
            # latents kept for offline analysis (never fed to ELIS)
            "_task": r.task,
            "_topic": r.topic,
        }
        out.write(json.dumps(rec) + "\n")
    if out is not sys.stdout:
        out.close()
        print(f"wrote {args.n} requests to {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
