"""Shared cases of the LM training parity tests
(``tests/test_torch_train_lm*.py``): configurations smaller than
``.reduced()`` built the same way in both packages, the reference's
parameters converted by the bridge, batches made from a numpy seed, and
the reference's loss and gradients."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.models import objective as JO
from repro.models import transformer as JT
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.training.tree import leaves, unflatten

#: one arch per family
ARCHS = {"dense": "qwen2-1.5b", "moe": "qwen2-moe-a2.7b",
         "vlm": "qwen2-vl-7b", "ssm": "mamba2-130m", "hybrid": "zamba2-7b",
         "audio": "whisper-large-v3"}
B, S = 2, 16
#: fp32 tolerances: the loss, relative; every gradient leaf, its largest
#: absolute difference over its largest magnitude (two fp32 programs that
#: sum in different orders: ~1e-6 seen)
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4


def tiny(arch: str, cfg):
    """``cfg.reduced()`` cut further: 2 layers (the hybrid 3: one group of
    2 and a tail layer), d_model 64, 4/2 heads of 16, vocab 256, SSD
    chunks of 8 (two a sequence), the vlm's 4 patches, whisper's one
    encoder layer over 8 frames."""
    r = cfg.reduced()
    kw = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
              d_ff=128, vocab_size=256)
    if r.moe.enabled:
        kw["moe"] = dataclasses.replace(r.moe, expert_d_ff=64,
                                        shared_d_ff=64)
    if r.ssm.enabled:
        kw["ssm"] = dataclasses.replace(r.ssm, chunk_size=8)
    if r.hybrid.enabled:
        kw["n_layers"] = 3
    if r.rope_type == "mrope":
        kw["mrope_sections"] = (4, 2, 2)
        kw["frontend_tokens"] = 4
    if r.encoder.enabled:
        kw["encoder"] = dataclasses.replace(r.encoder, n_layers=1,
                                            n_frames=8)
    return dataclasses.replace(r, **kw)


def configs(family: str):
    """(the reference's config, the port's) of ``family``'s tiny case."""
    arch = ARCHS[family]
    return tiny(arch, jax_get_config(arch)), tiny(arch, get_config(arch))


def params(jcfg, seed: int = 0):
    """(the reference's params, the port's on the CPU: the same values)."""
    jp = jax_init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 "cpu")


def batch(cfg, seed: int = 1, mask: bool = True):
    """A numpy train batch of ``cfg``'s family: tokens and labels (B, S)
    with two labels < 0, a ``loss_mask`` (text positions only for the
    vlm) with two False; the vlm's patches (B, P, d) and (3, B, P + S)
    M-RoPE positions (patches on a 2 x 2 grid, then text); whisper's
    frames."""
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    out = {"tokens": tok[:, :-1], "labels": tok[:, 1:].copy()}
    out["labels"][0, 3] = out["labels"][1, 9] = -1
    if mask:
        m = np.ones((B, S), bool)
        m[1, 2] = m[0, 11] = False
        out["loss_mask"] = m
    if cfg.family == "vlm":
        p = cfg.frontend_tokens
        out["embeds"] = rng.randn(B, p, cfg.d_model).astype(np.float32)
        grid = np.stack([np.zeros(p), np.arange(p) // 2, np.arange(p) % 2])
        text = np.arange(S)[None] + 2
        pos = np.concatenate([grid, np.repeat(text, 3, 0)], 1)
        out["positions"] = np.broadcast_to(pos[:, None], (3, B, p + S)
                                           ).astype(np.int32).copy()
    if cfg.family == "audio":
        out["frames"] = rng.randn(B, cfg.encoder.n_frames,
                                  cfg.d_model).astype(np.float32)
    return out


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_torch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def jax_loss_and_grads(jcfg, jp, b, **kw):
    """The reference's (loss, aux dict, gradient leaves as numpy)."""
    (loss, aux), g = jax.value_and_grad(
        lambda p: JO.loss_fn(p, jcfg, to_jax(b), **kw), has_aux=True)(jp)
    return (float(loss), {k: float(v) for k, v in aux.items()},
            [np.asarray(x) for x in jax.tree_util.tree_leaves(g)])


def torch_loss_and_grads(loss_fn, cfg, tp, b, **kw):
    """The port's (loss, aux dict, gradient leaves as numpy), leaves in
    JAX's order."""
    flat = [t.detach().clone().requires_grad_(True) for t in leaves(tp)]
    loss, aux = loss_fn(unflatten(tp, flat), cfg, to_torch(b), **kw)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return (loss.item(), {k: v.item() for k, v in aux.items()},
            [np.zeros(f.shape, np.float32) if g is None else g.numpy()
             for f, g in zip(flat, grads)])


def grad_gaps(got, want):
    """Per leaf: max |got - want| / max(max |want|, 1e-12)."""
    assert len(got) == len(want)
    return [float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-12))
            for g, w in zip(got, want)]


#: forward logits: largest difference over the largest magnitude
LOGIT_RTOL = 1e-5


@functools.lru_cache(maxsize=None)
def reference(family: str):
    """Everything the parity tests of ``family`` compare against, computed
    once a process: the configs, both params, the batch, the reference's
    logits and aux, and its loss, aux dict and gradient leaves."""
    jcfg, cfg = configs(family)
    jp, tp = params(jcfg)
    b = batch(cfg)
    logits, aux = JT.forward(jp, jcfg, to_jax(b))
    loss, parts, grads = jax_loss_and_grads(jcfg, jp, b)
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, tp=tp, batch=b,
                logits=np.asarray(logits), aux=float(aux), loss=loss,
                parts=parts, grads=grads)


def rel_gap(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / max(np.abs(np.asarray(want)).max(), 1e-12))
