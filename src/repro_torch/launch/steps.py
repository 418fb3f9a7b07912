"""Step functions of the serving entry point (the port of
``repro.launch.steps``), runnable on the card:

  prefill_step(params, batch_with_cache) -> (logits, cache)
  serve_step(params, tokens, cache) -> (next_token, cache)   # ONE new token

They take the caches of :func:`repro_torch.launch.shapes.input_specs`,
int8 and ring caches included, and update them in place (the reference
returns new ones).  ``attn_impl="kernel"`` runs the hand-written kernels
(prefill through ``flash_attention``, decode over an int8 linear cache
through ``flash_decode_int8``, over a dense one through
``flash_decode``); ``"torch"`` the plain path.  ``moe_impl`` picks the MoE
block of both steps, ``"dense"`` by default as in the reference (the
engine's decode runs ``"grouped"``).  The prefill step hands every input
of its batch but the cache to ``transformer.prefill``: the vlm family's
``embeds`` and ``positions`` and the audio family's ``frames`` too.

With ``mesh`` (a ``("model",)`` mesh: one tensor-parallel pod of any
family) ``params`` is the list of rank trees of
``launch.partition.shard_params`` and the cache the list of per-rank bf16
caches of ``transformer.init_cache(..., mesh=mesh)``; the batch's inputs
are replicated to every rank, the decode read is one
``flash_decode_sharded`` call a layer, and the outputs lie on rank 0's
device.  An int8 cache under a mesh is refused by ``init_cache``
(ROADMAP.md, queue 1, item 8.3).  The training step waits for the port
of the training stack.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models import transformer as T


def make_prefill_step(cfg, *, attn_impl: str = "kernel",
                      moe_impl: str = "dense", mesh=None):
    def prefill_step(params, batch: Dict):
        batch = dict(batch)
        cache = batch.pop("cache")
        return T.prefill(params, cfg, batch, cache, attn_impl=attn_impl,
                         moe_impl=moe_impl, mesh=mesh)

    return prefill_step


def make_serve_step(cfg, *, attn_impl: str = "kernel",
                    moe_impl: str = "dense", mesh=None):
    """One-token decode; returns the greedy token (B,) int32, not the
    logits, so the step's output footprint matches a real serving system."""

    def serve_step(params, tokens: torch.Tensor, cache):
        logits, cache = T.decode_step(params, cfg, tokens, cache,
                                      attn_impl=attn_impl, moe_impl=moe_impl,
                                      mesh=mesh)
        return logits[:, -1, :].argmax(dim=-1).to(torch.int32), cache

    return serve_step
