"""AdamW, global-norm clipping and LR schedules over parameter trees: the
port of ``repro.training.optimizer``.

Written out rather than taken from ``torch.optim.AdamW``, whose step differs
from the reference's: it decays ``p * (1 - lr * wd)`` before the Adam step
and folds the bias corrections elsewhere.  Here, as in the reference, the
gradients are clipped by their global norm first, then
``delta = m_hat / (sqrt(v_hat) + eps) + wd * p`` in fp32 and
``p <- p - lr * delta``; frozen leaves keep ``p`` and zero ``m`` and ``v``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.training.tree import leaves, tree_map, unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    #: schedule: constant | cosine | linear
    schedule: str = "cosine"
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Warmup, then constant, linear or cosine decay to ``min_lr_ratio``;
    fp32, on ``step``'s device."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        decay = 1.0
    else:
        frac = torch.clamp(
            (step - cfg.warmup_steps)
            / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
        if cfg.schedule == "linear":
            decay = 1.0 - (1.0 - cfg.min_lr_ratio) * frac
        else:  # cosine
            decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * 0.5 * (
                1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * decay


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in leaves(tree)))


def clip_by_global_norm(tree: Any,
                        max_norm: float) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), tree), norm


def adamw_init(params: Any) -> AdamWState:
    dev = leaves(params)[0].device
    zeros = lambda: tree_map(
        lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=zeros(), nu=zeros())


def adamw_leaf(cfg: AdamWConfig, step: torch.Tensor, lr: torch.Tensor,
               p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
               v: torch.Tensor):
    """One leaf's AdamW update at ``step`` (already advanced) and ``lr``:
    (new p, new m, new v), elementwise, so a slice of a leaf (ZeRO-1)
    updates as the same slice of the whole."""
    b1c = 1.0 - cfg.b1 ** step.float().to(m.device)
    b2c = 1.0 - cfg.b2 ** step.float().to(m.device)
    g32 = g.float()
    m = cfg.b1 * m + (1 - cfg.b1) * g32
    v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g32)
    mhat = m / b1c
    vhat = v / b2c
    delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * (
        p.float())
    newp = (p.float() - lr.to(m.device) * delta).to(p.dtype)
    return newp, m, v


def adamw_update(
    cfg: AdamWConfig,
    grads: Any,
    state: AdamWState,
    params: Any,
    *,
    trainable_mask: Optional[Any] = None,
) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """Returns (new_params, new_state, metrics).

    ``trainable_mask``: a tree of bools congruent with params; False leaves
    are left untouched (the paper freezes the BGE encoder and trains only
    the FC head — this is how).  Their gradients still count in the global
    norm, as in the reference."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state.step + 1
    lr = schedule_lr(cfg, step)

    def upd(p, g, m, v, t):
        if not t:
            return p, torch.zeros_like(m), torch.zeros_like(v)
        return adamw_leaf(cfg, step, lr, p, g, m, v)

    if trainable_mask is None:
        trainable_mask = tree_map(lambda _: True, params)
    flat = [upd(*xs) for xs in zip(leaves(params), leaves(grads),
                                   leaves(state.mu), leaves(state.nu),
                                   leaves(trainable_mask))]
    newp = unflatten(params, [f[0] for f in flat])
    newm = unflatten(params, [f[1] for f in flat])
    newv = unflatten(params, [f[2] for f in flat])
    metrics = {"grad_norm": gnorm, "lr": lr}
    return newp, AdamWState(step=step, mu=newm, nu=newv), metrics
