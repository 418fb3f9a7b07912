"""Model assembly in PyTorch: the dense and SSM families of
``repro.models.transformer``.

    dense : [norm -> GQA attn -> norm -> gated MLP] x L
    ssm   : [norm -> Mamba2] x L

Parameters keep the reference's pytree layout (layers stacked on a leading
axis), so a converted JAX tree (:mod:`repro_torch.bridge`) and a tree from
:func:`init_params` are interchangeable.

Public API:
  init_params(cfg, generator)                 -> params dict
  init_cache(cfg, batch, max_len, device)     -> cache dict
  prefill(params, cfg, batch, cache)          -> (last_logits, cache)
  decode_step(params, cfg, tokens, cache)     -> (logits, cache)

``prefill`` and ``decode_step`` update the cache they are given in place and
return it (the reference returns a new pytree).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models import ssm as S

Params = Dict[str, Any]
Cache = Dict[str, Any]
KVCache = L.KVCache

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


#: families this port serves
FAMILIES = ("dense", "ssm")


def _check_family(cfg) -> None:
    if cfg.family == "hybrid":
        raise NotImplementedError(
            "family 'hybrid' (zamba2) is not ported yet: it is the next "
            "slice (shared attention at head dim 112, the groups_ssm axis)")
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ported: {FAMILIES})")


# =========================================================================== #
# Init
# =========================================================================== #


def init_params(cfg, generator: torch.Generator) -> Params:
    """Random parameters with the reference's distributions, drawn from
    ``generator`` on its device (uniform dense weights, N(0, 0.02)
    embeddings, unit norm scales, zero biases)."""
    _check_family(cfg)
    dtype, dev, n = _dtype(cfg), generator.device, cfg.n_layers

    def norm(lead=()):
        return {"scale": torch.ones(lead + (cfg.d_model,), dtype=dtype,
                                    device=dev)}

    params: Params = {
        "embed": L.embed_init(generator, cfg.vocab_size, cfg.d_model, dtype),
        "final_norm": norm(),
    }
    if cfg.family == "ssm":
        params["layers"] = {"norm": norm((n,)),
                            "ssm": S.init_ssm(generator, cfg, n, dtype)}
    else:
        params["layers"] = {
            "attn_norm": norm((n,)),
            "attn": L.init_attention(generator, cfg, n, dtype),
            "mlp_norm": norm((n,)),
            "mlp": L.init_mlp(generator, cfg.d_model, cfg.d_ff, n, dtype),
        }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(generator, cfg.d_model,
                                         cfg.vocab_size, dtype)
    return params


def _unstack(tree, n: int) -> List[Any]:
    """Stacked layer tree -> list of n per-layer trees (views)."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


# =========================================================================== #
# Embedding / unembedding
# =========================================================================== #


def embed_tokens(params: Params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding lookup with ids clamped to [0, vocab - 1], as JAX's gather
    clamps an out-of-range index (torch would raise, or assert on the
    card)."""
    return params["embed"][tokens.long().clamp(0, cfg.vocab_size - 1)]


def embed_inputs(params: Params, cfg, batch: Dict):
    """Returns (hidden (B,S,d), positions (B,S))."""
    h = embed_tokens(params, cfg, batch["tokens"])
    b, s = h.shape[:2]
    pos = batch.get("positions")
    if pos is None:
        pos = torch.arange(s, device=h.device)[None, :].expand(b, s)
    return h, pos


def unembed(params: Params, cfg, h: torch.Tensor) -> torch.Tensor:
    h = L.apply_norm(cfg, params["final_norm"], h)
    if cfg.tie_embeddings:
        return h @ params["embed"].T
    return h @ params["lm_head"]


# =========================================================================== #
# Layer bodies
# =========================================================================== #


def _dense_body(cfg, attn_impl, lp: Params, x, cos_sin, cache=None,
                cur_index=None, active=None):
    h = L.apply_norm(cfg, lp["attn_norm"], x)
    attn_out, kv = L.attention_block(
        lp["attn"], cfg, h, cos_sin, cache=cache, cur_index=cur_index,
        attn_impl=attn_impl, active=active)
    x = x + attn_out
    h = L.apply_norm(cfg, lp["mlp_norm"], x)
    return x + L.mlp_block(lp["mlp"], cfg, h), kv


def _ssm_body(cfg, impl, lp: Params, x, state=None, active=None):
    """Prefill (``state is None``): returns (x + out, decode state).
    Decode: returns (x + out, new state); rows with ``active=False`` keep
    their state bit for bit."""
    h = L.apply_norm(cfg, lp["norm"], x)
    if state is None:
        out, new_state = S.ssm_forward(lp["ssm"], cfg, h, impl=impl,
                                       return_state=True)
        return x + out, new_state
    out, new_state = S.ssm_decode_step(lp["ssm"], cfg, h, state)
    if active is not None:
        new_state = {
            k: torch.where(active.reshape((-1,) + (1,) * (v.ndim - 1)), v,
                           state[k])
            for k, v in new_state.items()}
    return x + out, new_state


# =========================================================================== #
# KV / state caches
# =========================================================================== #


def init_cache(cfg, batch: int, max_len: int, device, dtype=None) -> Cache:
    """Slot cache: per-slot lengths ``len`` (B,) int32, and for the dense
    family K/V buffers (n_layers, B, max_len, KH, D), for the SSM family
    the recurrent states ``{"conv": (n_layers, B, CH, d_conv - 1), "ssm":
    (n_layers, B, H, P, N)}``."""
    _check_family(cfg)
    dtype = dtype or _dtype(cfg)
    cache: Cache = {"len": torch.zeros((batch,), dtype=torch.int32,
                                       device=device)}
    if cfg.family == "ssm":
        state = S.init_ssm_state(cfg, batch, dtype, device)
        cache["ssm"] = {k: v.new_zeros((cfg.n_layers,) + v.shape)
                        for k, v in state.items()}
        return cache
    if cfg.attention_type == "swa" and cfg.swa_window < max_len:
        raise NotImplementedError("ring (sliding-window) KV caches are not "
                                  "ported yet")
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    cache["kv"] = KVCache(torch.zeros(shape, dtype=dtype, device=device),
                          torch.zeros(shape, dtype=dtype, device=device))
    return cache


# =========================================================================== #
# Prefill
# =========================================================================== #


def prefill(params: Params, cfg, batch: Dict, cache: Cache, *,
            attn_impl: str = "kernel",
            last_index: Optional[torch.Tensor] = None):
    """Process the full (right-padded) prompt batch, set ``len`` to S, and
    return the logits (B, 1, V) at ``last_index`` (B,) — each row's true
    last position — or at the last position.  The dense family writes its
    K/V into rows ``[0, S)`` of every slot of ``cache``, the SSM family its
    decode states, in place.  ``attn_impl`` picks the kernels ("kernel") or
    the plain path ("torch") for attention and for the SSD scan alike."""
    _check_family(cfg)
    h, pos = embed_inputs(params, cfg, batch)
    s = h.shape[1]
    layers = _unstack(params["layers"], cfg.n_layers)
    if cfg.family == "ssm":
        states = cache["ssm"]
        for i, lp in enumerate(layers):
            h, st = _ssm_body(cfg, attn_impl, lp, h)
            for k, v in st.items():
                states[k][i] = v
    else:
        cos_sin = L.positional_cos_sin(cfg, pos)
        kvc = cache["kv"]
        for i, lp in enumerate(layers):
            h, (k, v) = _dense_body(cfg, attn_impl, lp, h, cos_sin)
            kvc.k[i, :, :s] = k
            kvc.v[i, :, :s] = v
    cache["len"] = torch.full((h.shape[0],), s, dtype=torch.int32,
                              device=h.device)
    if last_index is not None:
        rows = torch.arange(h.shape[0], device=h.device)
        hsel = h[rows, last_index.long()][:, None, :]
    else:
        hsel = h[:, -1:, :]
    return unembed(params, cfg, hsel), cache


# =========================================================================== #
# Decode step
# =========================================================================== #


def decode_step(params: Params, cfg, tokens: torch.Tensor, cache: Cache, *,
                attn_impl: str = "kernel",
                active: Optional[torch.Tensor] = None):
    """One-token step: tokens (B, 1) -> (logits (B, 1, V), cache).

    ``active`` (B,) bool: inactive rows (unoccupied or EOS-frozen slots) are
    computed but write no K/V (dense) or state (SSM) and keep their ``len``,
    so their cache stays bit-identical.  The SSM step is plain PyTorch
    whatever ``attn_impl`` is, as in the reference."""
    _check_family(cfg)
    cur = cache["len"]
    h = embed_tokens(params, cfg, tokens)
    layers = _unstack(params["layers"], cfg.n_layers)
    if cfg.family == "ssm":
        states = cache["ssm"]
        for i, lp in enumerate(layers):
            h, st = _ssm_body(cfg, attn_impl, lp, h,
                              state={k: v[i] for k, v in states.items()},
                              active=active)
            for k, v in st.items():
                states[k][i] = v
    else:
        cos_sin = L.positional_cos_sin(cfg, cur[:, None])
        kvc = cache["kv"]
        for i, lp in enumerate(layers):
            h, _ = _dense_body(cfg, attn_impl, lp, h, cos_sin,
                               cache=KVCache(kvc.k[i], kvc.v[i]),
                               cur_index=cur, active=active)
    if active is not None:
        cache["len"] = torch.where(active, cur + 1, cur)
    else:
        cache["len"] = cur + 1
    return unembed(params, cfg, h), cache
