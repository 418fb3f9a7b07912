"""Train the response-length predictor (paper §4.2) and checkpoint it.

    python -m repro_torch.examples.train_predictor [--steps 600]

Reports Table-2-style metrics (MAE/RMSE/R²) before and after training plus
the Fig-2(b) per-step MAE curve, and saves a checkpoint in the JAX
package's layout (``repro_torch.training.checkpoint``), which the serve
CLI's ``--predictor-ckpt`` of either package restores.  On the card by
default (``--device cpu`` for the CPU).
"""
import argparse
import os

from repro_torch.core import BGEPredictor, PredictorConfig
from repro_torch.data import make_predictor_dataset
from repro_torch.device import device_or_exit
from repro_torch.models.encoder import EncoderArchConfig
from repro_torch.training import save_checkpoint


def main(argv=None):
    """Run the example; returns (metrics after training, checkpoint)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--requests", type=int, default=1200)
    ap.add_argument("--out", default="experiments/predictor_ckpt_torch")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = device_or_exit(args.device)

    cfg = PredictorConfig(
        encoder=EncoderArchConfig(d_model=128, n_heads=4, n_layers=3,
                                  d_ff=256, max_len=192),
        n_fc_layers=8, fc_hidden=256, max_len=192, lr=1e-4,
    )
    train, val, test = make_predictor_dataset(args.requests, seed=0,
                                              max_len=192, max_steps=6)
    print(f"dataset: {len(train)} train / {len(val)} val / {len(test)} test")

    pred = BGEPredictor(cfg, seed=0, device=device)
    print("before:", pred.evaluate(test))
    pred.fit(train, num_steps=args.steps, batch_size=32,
             log_fn=lambda i, m: print(f"  step {i:4d} loss={m['loss']:.4f} "
                                       f"mae={m['mae']:.1f}"))
    after = pred.evaluate(test)
    print("after:", after)
    print("per-step MAE (Fig 2b):", pred.evaluate_per_step(test))

    os.makedirs(args.out, exist_ok=True)
    path = save_checkpoint(args.out, args.steps, pred.params,
                           metadata={"metrics": after})
    print("checkpoint:", path)
    return after, path


if __name__ == "__main__":
    main()
