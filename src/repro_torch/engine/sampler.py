"""Token samplers."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0  # 0 = greedy
    top_k: int = 0            # 0 = full softmax


def sample(logits: torch.Tensor, generator: Optional[torch.Generator],
           cfg: SamplerConfig, active: Optional[torch.Tensor] = None,
           pad_token: int = 0) -> torch.Tensor:
    """logits (B, V) -> (B,) int32.

    Greedy takes the first maximal index, as ``jnp.argmax`` does.  With a
    temperature, tokens are drawn from ``generator`` (its stream is not
    JAX's: only greedy decoding matches the reference token for token).
    Rows with ``active=False`` emit ``pad_token``.
    """
    if cfg.temperature <= 0.0:
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
    else:
        logits = logits.float() / cfg.temperature
        if cfg.top_k > 0:
            kth = torch.topk(logits, cfg.top_k, dim=-1).values[..., -1:]
            logits = logits.masked_fill(logits < kth, float("-inf"))
        probs = torch.softmax(logits, dim=-1)
        tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        tok = tok.to(torch.int32)
    if active is not None:
        tok = torch.where(active, tok, torch.full_like(tok, pad_token))
    return tok
