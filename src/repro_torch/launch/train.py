"""Training launcher for any assigned architecture: the port of
``repro.launch.train``.

Trains the reduced variant of ``--arch`` (``get_config(arch).reduced()``,
fp32, random weights from seed 0) on the synthetic request stream, with
AdamW, remat and the plain attention, on the card (``--device cuda``, the
default) or on the CPU (``--device cpu``); without a card and without
``--device cpu`` it exits.  ``--ckpt`` writes a checkpoint in the JAX
package's layout after the last step, and ``--resume`` restores the
latest one there first (the parameters: the optimiser starts afresh, as in
the reference).

    python -m repro_torch.launch.train --device cpu --arch qwen2-1.5b --steps 5
    python -m repro_torch.launch.train --arch mamba2-130m --steps 100 \\
        --ckpt build/lm_ckpt

``--dry-run`` (and ``--mesh multi``) runs the port's dry run of the
FULL config's train step (``train_4k``) on the production mesh, single
or multi-pod, over the meta device, in a subprocess, as the reference
hands its dry run to ``repro.launch.dryrun``:

    python -m repro_torch.launch.train --arch yi-6b --dry-run --mesh multi
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.data import WorkloadGenerator
from repro_torch.device import device_or_exit
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as T
from repro_torch.training import (
    AdamWConfig,
    adamw_init,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

def batches(cfg, batch_size: int, seq_len: int, seed: int = 0):
    """The reference's token stream: the synthetic requests' prompt and
    output ids (mod the vocab) cut into ``batch_size`` rows of ``seq_len +
    1``; yields CPU tensors ``tokens`` and ``labels`` (int32), the vlm's
    zero stub ``embeds`` (its labels left-padded with -1 over them) and
    the audio family's zero ``frames`` (fp32, as the reference's)."""
    gen = WorkloadGenerator(seed=seed)
    buf = []
    n = batch_size * (seq_len + 1)
    while True:
        while len(buf) < n:
            r = gen.sample_request()
            buf.extend(t % cfg.vocab_size for t in r.prompt_tokens)
            buf.extend(t % cfg.vocab_size for t in r.output_tokens)
        chunk = torch.from_numpy(
            np.asarray(buf[:n], np.int32).reshape(batch_size, seq_len + 1))
        buf = buf[n:]
        batch = {"tokens": chunk[:, :-1].contiguous(),
                 "labels": chunk[:, 1:].contiguous()}
        if cfg.family == "vlm":
            batch["embeds"] = torch.zeros(
                (batch_size, cfg.frontend_tokens, cfg.d_model))
            batch["labels"] = torch.nn.functional.pad(
                batch["labels"], (cfg.frontend_tokens, 0), value=-1)
        if cfg.family == "audio":
            batch["frames"] = torch.zeros(
                (batch_size, cfg.encoder.n_frames, cfg.d_model))
        yield batch


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-1.5b", choices=list(list_archs()))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--dry-run", action="store_true",
                    help="dry-run the FULL config's train step on the "
                         "production mesh (meta device)")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--dry-run-out", default=None,
                    help="the dry run's record directory (default: "
                         "dryrun's, experiments/dryrun_torch/)")
    return ap


def main(argv=None) -> dict:
    """Run the CLI; returns ``start`` (the step trained from), ``losses``
    (per step, host floats) and ``ckpt`` (the checkpoint written, or
    None), or for a dry run ``dry_run``: the subprocess's exit code."""
    args = _parser().parse_args(argv)
    if args.dry_run or args.mesh != "single":
        out = [] if args.dry_run_out is None else ["--out", args.dry_run_out]
        rc = subprocess.call([
            sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
            args.arch, "--shape", "train_4k", "--mesh", args.mesh] + out)
        if rc:
            sys.exit(rc)
        return {"dry_run": rc}
    device = device_or_exit(args.device)
    cfg = get_config(args.arch).reduced()
    print(f"[train] {cfg.arch_id}: {cfg.param_count() / 1e6:.1f}M params, "
          f"batch {args.batch} x seq {args.seq} on {device}")
    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(0))
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps)
    opt_state = adamw_init(params)
    start = 0
    if args.resume and args.ckpt:
        step0 = latest_step(args.ckpt)
        if step0 is not None:
            params, _ = restore_checkpoint(args.ckpt, step0, params)
            start = step0
            print(f"[train] resumed from step {step0}")
    step_fn = make_train_step(cfg, remat=True, opt_cfg=opt_cfg)
    it = batches(cfg, args.batch, args.seq)
    losses = []
    t0 = time.time()
    for i in range(start, start + args.steps):
        params, opt_state, m = step_fn(params, opt_state, next(it))
        losses.append(float(m["loss"]))
        if i % args.log_every == 0 or i == start + args.steps - 1:
            print(f"step {i:5d}  loss {losses[-1]:7.4f}  "
                  f"gnorm {float(m['grad_norm']):8.3f}  "
                  f"{time.time() - t0:5.0f}s")
    path = None
    if args.ckpt:
        path = save_checkpoint(args.ckpt, start + args.steps, params,
                               metadata={"loss": losses[-1],
                                         "arch": args.arch})
        print(f"[train] checkpoint: {path}")
    return {"start": start, "losses": losses, "ckpt": path}


if __name__ == "__main__":
    main()
