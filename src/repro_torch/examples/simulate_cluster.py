"""Cluster-scale simulation (paper §6 at full size, on a laptop).

    python -m repro_torch.examples.simulate_cluster [--model lam13]

Reproduces a Table-5 slice (FCFS vs ISRTF vs SJF at 1x/3x/5x RPS) and a
Fig-7-style worker-scaling curve on the calibrated discrete-event
cluster.  Host code: it takes no ``--device``.
"""
import argparse

from repro_torch.core.metrics import improvement
from repro_torch.simulate import (ExperimentConfig, compare_policies,
                                  run_experiment)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="lam13",
                    choices=["opt6.7", "opt13", "lam7", "lam13", "vic"])
    ap.add_argument("--requests", type=int, default=200)
    args = ap.parse_args(argv)

    print(f"== Table 5 slice: {args.model}, batch 4, 200 prompts ==")
    for rps in (1.0, 3.0, 5.0):
        cfg = ExperimentConfig(model=args.model, n_requests=args.requests,
                               batch_size=4, rps_multiple=rps, seed=7)
        res = compare_policies(cfg, ("fcfs", "isrtf", "sjf"), n_trials=3)
        print(f"  RPS {rps:.1f}x: FCFS {res['fcfs']['jct_mean']:7.1f}s  "
              f"ISRTF {res['isrtf']['jct_mean']:7.1f}s  "
              f"SJF {res['sjf']['jct_mean']:7.1f}s  "
              f"(ISRTF {improvement(res['fcfs'], res['isrtf']):+.1f}%)")

    print("\n== Fig 7: worker scaling (ISRTF) ==")
    for workers in (1, 2, 4, 8):
        cfg = ExperimentConfig(model=args.model, n_requests=args.requests,
                               batch_size=4, n_nodes=workers,
                               rate_override=0.3 * workers, seed=7)
        m = run_experiment(cfg)
        print(f"  {workers} workers @ {0.3*workers:.1f} req/s: "
              f"JCT {m['jct_mean']:7.1f}s  queue "
              f"{m['queuing_delay_mean']:6.2f}s")


if __name__ == "__main__":
    main()
