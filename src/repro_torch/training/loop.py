"""Generic training loop (the port of ``repro.training.loop``): autograd
for the gradients, :func:`adamw_update` for the step.  Nothing is compiled:
the reference's jit is a plain call here."""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.training.optimizer import (
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
)
from repro_torch.training.tree import leaves, unflatten


def to_device(batch: Dict, device: torch.device) -> Dict:
    """A batch of numpy arrays (or tensors) as tensors on ``device``."""
    return {k: (v.to(device) if torch.is_tensor(v)
                else torch.from_numpy(np.asarray(v)).to(device))
            for k, v in batch.items()}


def make_train_step(
    loss_fn: Callable,
    opt_cfg: AdamWConfig,
    *,
    trainable_mask: Optional[Any] = None,
):
    """loss_fn(params, batch) -> (loss, metrics_dict).

    Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  The batch goes to the parameters' device; the gradients
    are taken of every leaf (frozen ones too: they count in the clipping
    norm, as in the reference)."""

    def step(params, opt_state: AdamWState, batch):
        flat = [p.detach().requires_grad_(True) for p in leaves(params)]
        batch = to_device(batch, flat[0].device)
        loss, inner = loss_fn(unflatten(params, flat), batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = unflatten(params, [torch.zeros_like(p) if g is None else g
                                   for p, g in zip(flat, grads)])
        params, opt_state, opt_metrics = adamw_update(
            opt_cfg, grads, opt_state, params, trainable_mask=trainable_mask)
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in inner.items()},
                   **opt_metrics}
        return params, opt_state, metrics

    return step


def train(
    params: Any,
    loss_fn: Callable,
    data_iter: Iterable,
    opt_cfg: AdamWConfig,
    *,
    num_steps: int,
    trainable_mask: Optional[Any] = None,
    log_every: int = 50,
    log_fn: Callable[[int, Dict], None] = None,
) -> Tuple[Any, Dict]:
    """Run ``num_steps`` of AdamW over ``data_iter``.  Returns
    (params, history) where history maps step -> host metrics."""
    step_fn = make_train_step(loss_fn, opt_cfg, trainable_mask=trainable_mask)
    opt_state = adamw_init(params)
    history: Dict[int, Dict] = {}
    t0 = time.time()
    for i in range(num_steps):
        batch = next(data_iter)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if i % log_every == 0 or i == num_steps - 1:
            host = {k: float(v) for k, v in metrics.items()}
            host["wall_s"] = time.time() - t0
            history[i] = host
            if log_fn:
                log_fn(i, host)
    return params, history
