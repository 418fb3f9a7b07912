"""Train a small language model end-to-end (training-substrate demo).

    python -m repro_torch.examples.train_lm --arch mamba2-130m --steps 150

Uses the reduced variant of any assigned architecture, the synthetic
workload's token stream as data, AdamW, per-layer remat, and a checkpoint
in the JAX package's layout (``repro_torch.training.checkpoint``), which
``repro.training.restore_checkpoint`` reads too.  Loss must fall:
asserted at the end.  On the card by default (``--device cpu`` for the
CPU).
"""
import argparse
import os
import time

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.device import device_or_exit
from repro_torch.launch.train import batches
from repro_torch.models import init_params, loss_fn
from repro_torch.training import (AdamWConfig, adamw_init, make_train_step,
                                  save_checkpoint)


def main(argv=None):
    """Run the example; returns (first loss, final loss, checkpoint)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m", choices=list(list_archs()))
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default="experiments/lm_ckpt_torch")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = device_or_exit(args.device)

    cfg = get_config(args.arch).reduced()
    print(f"training {cfg.arch_id}: {cfg.n_layers}L d={cfg.d_model} "
          f"vocab={cfg.vocab_size} ({cfg.param_count()/1e6:.1f}M params)")
    params = init_params(cfg, torch.Generator(device).manual_seed(0))
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=args.steps,
                          weight_decay=0.01)
    opt_state = adamw_init(params)
    step = make_train_step(lambda p, b: loss_fn(p, cfg, b, remat=True),
                           opt_cfg)

    it = batches(cfg, args.batch, args.seq)
    t0 = time.time()
    first = None
    for i in range(args.steps):
        params, opt_state, m = step(params, opt_state, next(it))
        loss = float(m["loss"])
        if i == 0:
            first = loss
        if i % 25 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {loss:.4f}  "
                  f"({time.time()-t0:.0f}s)")
    final = loss
    os.makedirs(args.ckpt, exist_ok=True)
    path = save_checkpoint(args.ckpt, args.steps, params,
                           metadata={"loss": final, "arch": args.arch})
    print(f"loss {first:.3f} -> {final:.3f}; checkpoint in {args.ckpt}")
    assert final < first, "training did not reduce the loss"
    return first, final, path


if __name__ == "__main__":
    main()
