"""Training objectives (the port of ``repro.models.objective``):
next-token cross-entropy (+ the MoE aux loss) for the serving models, and
the learning-to-rank losses for the length predictor's ranking head
(pairwise margin / listwise softmax over in-batch pools).

ISRTF only consumes the *order* of predicted remaining lengths, so a head
trained to rank (Fu et al., arXiv 2408.15792; Tao et al., arXiv 2510.03243)
can beat the point regressor at the scheduling objective even when its
magnitudes are useless — the two-head design in
:class:`repro_torch.core.predictor.BGEPredictor` keeps the regression head
for the cluster layer's predicted-work accounting and trains this ranking
head as a sibling on the shared encoder trunk."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import transformer as T


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Mean masked token-level CE in fp32 (log-sum-exp over the vocab).
    labels < 0 are also ignored."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    safe = labels.long().clamp(min=0)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    mask = mask & (labels >= 0)
    denom = torch.clamp(mask.sum(), min=1)
    return torch.where(mask, lse - gold, torch.zeros_like(lse)).sum() / denom


def loss_fn(params, cfg, batch: Dict, *, attn_impl: str = "torch",
            moe_impl: str = "dense", remat: bool = False, mesh=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, {"ce", "aux"}) of :func:`transformer.forward` on ``batch``:
    next-token CE over ``batch["labels"]``, plus ``router_aux_weight``
    times the aux loss for MoE configs.  The vlm's logits cover [patches |
    text]: labels shorter than the logits are left-padded with -1 (no
    loss at the patches), and a ``loss_mask`` shorter than the labels is
    left-padded with False.  With ``mesh`` (a ``("model",)`` mesh),
    ``params`` is the list of rank trees and the forward runs over the
    ranks (``transformer.forward(mesh=)``); the loss lies on rank 0's
    device."""
    logits, aux = T.forward(params, cfg, batch, attn_impl=attn_impl,
                            moe_impl=moe_impl, remat=remat, mesh=mesh)
    labels = batch["labels"].to(logits.device)
    extra = logits.shape[1] - labels.shape[1]
    if extra:
        labels = torch.cat([labels.new_full((labels.shape[0], extra), -1),
                            labels], dim=1)
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.bool,
                          device=labels.device)
    else:
        mask = mask.to(labels.device, torch.bool)
        extra = labels.shape[1] - mask.shape[1]
        if extra:
            mask = torch.cat([mask.new_zeros((mask.shape[0], extra)), mask],
                             dim=1)
    ce = cross_entropy(logits, labels, mask)
    total = ce + cfg.moe.router_aux_weight * aux if cfg.moe.enabled else ce
    return total, {"ce": ce, "aux": aux}


RANKING_LOSSES = ("pairwise", "listwise")
PAIR_SAMPLING = ("all", "same_step")


@dataclass(frozen=True)
class RankingConfig:
    """Configuration for the sibling ranking head on the BGE predictor.

    Presence of this config on :class:`repro_torch.core.predictor
    .PredictorConfig` *enables* the second head; ``None`` (the default)
    keeps the predictor's parameter tree identical to the single-head
    model.  ``margin`` is in log-token units (0.1 ≈ "10% longer should
    score higher"), matching the head's log-space output."""

    #: hinge margin for the pairwise loss, in log-token units
    margin: float = 0.1
    #: weight of the ranking loss relative to the regression Huber loss
    weight: float = 1.0
    #: "pairwise" margin hinge | "listwise" softmax cross-entropy
    loss: str = "pairwise"
    #: which in-batch pairs train the head: "all" | "same_step" (only
    #: compare requests observed at the same 50-token scheduling step, the
    #: comparison ISRTF actually makes)
    pair_sampling: str = "all"
    #: temperature on the log-label target distribution (listwise only)
    listwise_temperature: float = 1.0

    def __post_init__(self) -> None:
        if self.loss not in RANKING_LOSSES:
            raise ValueError(
                f"unknown ranking loss {self.loss!r} "
                f"(choose one of {RANKING_LOSSES})")
        if self.pair_sampling not in PAIR_SAMPLING:
            raise ValueError(
                f"unknown pair_sampling {self.pair_sampling!r} "
                f"(choose one of {PAIR_SAMPLING})")


def pairwise_margin_loss(scores: torch.Tensor, log_labels: torch.Tensor,
                         valid: torch.Tensor, *, margin: float,
                         pair_mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Mean hinge over all ordered in-batch pairs where label_i > label_j.

    ``scores`` and ``log_labels`` are (B,) in log space; the hinge wants
    score_i − score_j ≥ margin whenever request i truly runs longer than
    request j.  Ties contribute nothing.  ``valid`` masks padded rows and
    ``pair_mask`` optionally restricts which (i, j) pairs count."""
    sdiff = scores[:, None] - scores[None, :]
    want = (log_labels[:, None] - log_labels[None, :]) > 0.0
    pairs = valid[:, None] & valid[None, :] & want
    if pair_mask is not None:
        pairs = pairs & pair_mask
    # maximum, not clamp: its gradient at a tie is split as JAX's is
    hinge = torch.maximum(margin - sdiff, torch.zeros_like(sdiff))
    denom = torch.clamp(pairs.sum(), min=1)
    return torch.where(pairs, hinge, torch.zeros_like(hinge)).sum() / denom


def listwise_softmax_loss(scores: torch.Tensor, log_labels: torch.Tensor,
                          valid: torch.Tensor, *,
                          temperature: float = 1.0) -> torch.Tensor:
    """ListNet-style cross-entropy between the label and score distributions.

    The target is softmax(log_labels / T) over valid rows — longer requests
    get more probability mass — and the loss is its cross-entropy against
    log_softmax(scores)."""
    neg = torch.tensor(-1e9, dtype=torch.float32, device=scores.device)
    target = torch.softmax(torch.where(valid, log_labels / temperature, neg),
                           dim=-1)
    logp = torch.log_softmax(torch.where(valid, scores, neg), dim=-1)
    return -torch.where(valid, target * logp, torch.zeros_like(logp)).sum()


def ranking_loss(cfg: RankingConfig, scores: torch.Tensor,
                 labels: torch.Tensor, valid: torch.Tensor,
                 steps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dispatch to the configured ranking loss.

    ``labels`` are raw remaining-token counts (compared in log space so the
    margin is scale-relative); ``steps`` is the per-row scheduling step used
    by ``pair_sampling="same_step"``."""
    log_labels = torch.log(torch.clamp(labels.float(), min=1.0))
    if cfg.loss == "listwise":
        return listwise_softmax_loss(
            scores, log_labels, valid, temperature=cfg.listwise_temperature)
    pair_mask = None
    if cfg.pair_sampling == "same_step" and steps is not None:
        pair_mask = steps[:, None] == steps[None, :]
    return pairwise_margin_loss(
        scores, log_labels, valid, margin=cfg.margin, pair_mask=pair_mask)
