"""Step functions (the port of ``repro.launch.steps``), runnable on the
card:

  train_step(params, opt_state, batch) -> (params, opt_state, metrics)
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
(ROADMAP.md, queue 1, item 8.3).

The training step takes ``loss_fn`` and its gradients by autograd, then
one :func:`repro_torch.training.adamw_update`, and returns new trees, as
the reference does; its third value is the step's metrics (``loss``,
``ce``, ``aux``, ``grad_norm``, ``lr``) where the reference returns the
loss alone.  It runs the plain attention by default (the reference's
``"xla"``): the kernels have no backward, and their wrappers raise under
grad.  It takes no ``mesh`` (``transformer.forward`` refuses one).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models import transformer as T
from repro_torch.models.objective import loss_fn
from repro_torch.training import loop
from repro_torch.training.optimizer import AdamWConfig, AdamWState
from repro_torch.training.tree import tree_map

DRYRUN_OPT = AdamWConfig(lr=3e-4, schedule="cosine", warmup_steps=100,
                         total_steps=10_000)


def make_train_step(cfg, *, remat: bool = True, moe_impl: str = "dense",
                    opt_cfg: AdamWConfig = DRYRUN_OPT,
                    attn_impl: str = "torch"):
    """One AdamW step on ``loss_fn(params, cfg, batch)``: ``train_step(
    params, opt_state, batch) -> (params, opt_state, metrics)``; the batch
    goes to the parameters' device.  A leaf the loss does not reach gets
    a zero gradient, as the reference's does (so a path cut by a detached
    output would also read zero: hold the gradients against a reference,
    not only the loss)."""
    def loss(params, batch):
        return loss_fn(params, cfg, batch, attn_impl=attn_impl,
                       moe_impl=moe_impl, remat=remat)

    return loop.make_train_step(loss, opt_cfg)


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


def abstract_opt_state(abstract_params) -> AdamWState:
    """The AdamW state of ``abstract_params`` on the meta device: an int32
    step and fp32 moments shaped like the params (nothing allocated)."""
    def f32like():
        return tree_map(lambda leaf: torch.empty(
            tuple(leaf.shape), dtype=torch.float32, device="meta"),
            abstract_params)

    return AdamWState(step=torch.empty((), dtype=torch.int32, device="meta"),
                      mu=f32like(), nu=f32like())
