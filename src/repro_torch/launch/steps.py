"""Step functions of the serving entry point (the port of
``repro.launch.steps``), runnable on the card:

  prefill_step(params, batch_with_cache) -> (logits, cache)
  serve_step(params, tokens, cache) -> (next_token, cache)   # ONE new token

They take the caches of :func:`repro_torch.launch.shapes.input_specs`,
int8 and ring caches included, and update them in place (the reference
returns new ones).  ``attn_impl="kernel"`` runs the hand-written kernels
(prefill through ``flash_attention``, decode over an int8 linear cache
through ``flash_decode_int8``, over a dense one through
``flash_decode``); ``"torch"`` the plain path.  The training step waits
for the port of the training stack.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models import transformer as T


def make_prefill_step(cfg, *, attn_impl: str = "kernel"):
    def prefill_step(params, batch: Dict):
        batch = dict(batch)
        cache = batch.pop("cache")
        return T.prefill(params, cfg, batch, cache, attn_impl=attn_impl)

    return prefill_step


def make_serve_step(cfg, *, attn_impl: str = "kernel"):
    """One-token decode; returns the greedy token (B,) int32, not the
    logits, so the step's output footprint matches a real serving system."""

    def serve_step(params, tokens: torch.Tensor, cache):
        logits, cache = T.decode_step(params, cfg, tokens, cache,
                                      attn_impl=attn_impl)
        return logits[:, -1, :].argmax(dim=-1).to(torch.int32), cache

    return serve_step
