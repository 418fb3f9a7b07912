"""Model assembly in PyTorch: the dense and SSM families of
``repro.models.transformer``.

    dense : [norm -> GQA attn -> norm -> gated MLP] x L
    ssm   : [norm -> Mamba2] x L

Parameters keep the reference's pytree layout (layers stacked on a leading
axis), so a converted JAX tree (:mod:`repro_torch.bridge`) and a tree from
:func:`init_params` are interchangeable.

Public API:
  init_params(cfg, generator)                 -> params dict
  init_cache(cfg, batch, max_len, device)     -> cache dict (kv_dtype="int8",
                                                 sliding_window= for a ring)
  prefill(params, cfg, batch, cache)          -> (last_logits, cache)
  prefill_chunk(params, cfg, batch, cache,
                start=, valid_len=)           -> (last_logits, cache)
  decode_step(params, cfg, tokens, cache)     -> (logits, cache)

``prefill``, ``prefill_chunk`` and ``decode_step`` update the cache they are
given in place and return it (the reference returns a new pytree).

Tensor parallelism (``mesh=``, a ``("model",)`` mesh of
:mod:`repro_torch.launch.mesh`; dense family): ``params`` is then the list
of per-rank trees from ``launch.partition.shard_params`` and ``cache`` the
list of per-rank caches from ``init_cache(..., mesh=mesh)``.  The dense
forward is one body over a list of ranks, a single device being one rank.
One process drives every rank, layer by layer, each rank with its share
of the heads and of the FFN (``launch.partition.local_config``); the
row-parallel partials (after ``wo``, after ``w_down``, the vocab-parallel
embedding) are summed in rank order on rank 0's device and copied back to
every rank, and the vocab-parallel logits are concatenated there, so two
runs agree bit for bit.  The decode read of all ranks is one
``ops.flash_decode_sharded`` call.  Prefill launches ``flash_attention``
on each rank's local heads: the reference downgrades prefill under a mesh
to XLA only because its Pallas prefill kernel has no ``shard_map``
wrapper, and computes the same function either way.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.launch import partition as P
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


def unembed(params: Params, cfg, h: torch.Tensor) -> torch.Tensor:
    h = L.apply_norm(cfg, params["final_norm"], h)
    if cfg.tie_embeddings:
        return h @ params["embed"].T
    return h @ params["lm_head"]


# =========================================================================== #
# Layer bodies
# =========================================================================== #


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


def kv_buffer_len(cfg, max_len: int) -> int:
    """Physical KV buffer length: ring-bounded for SWA configs."""
    if cfg.attention_type == "swa":
        return min(max_len, cfg.swa_window)
    return max_len


KV_DTYPES = (None, "int8")


def init_cache(cfg, batch: int, max_len: int, device=None, dtype=None, *,
               mesh=None, kv_dtype: Optional[str] = None,
               sliding_window: Optional[int] = None):
    """Slot cache: per-slot lengths ``len`` (B,) int32, and for the dense
    family K/V buffers (n_layers, B, buf, KH, D), for the SSM family the
    recurrent states ``{"conv": (n_layers, B, CH, d_conv - 1), "ssm":
    (n_layers, B, H, P, N)}``.  ``buf`` is :func:`kv_buffer_len`, cut to
    ``sliding_window`` when it is given; the buffer is a ring when ``buf <
    max_len``.  ``kv_dtype="int8"`` makes the K/V buffers int8 codes with
    fp32 scales (n_layers, B, buf); it does nothing for the SSM family, as
    in the reference.  With ``mesh``: one cache per rank on the rank's
    device, with the KV heads the rank's query heads read
    (``launch.partition.kv_head_range``), each with its own ``len``; an
    int8 cache under a mesh raises ``NotImplementedError``."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, got "
                         f"{kv_dtype!r}")
    if mesh is not None:
        if kv_dtype is not None:
            raise NotImplementedError(
                "an int8 KV cache under tensor parallelism is not ported "
                "(its per-token scale spans every rank's KV heads)")
        ranks = P.tp_ranks(mesh)
        lcfg = P.local_config(cfg, len(ranks))
        return [init_cache(lcfg, batch, max_len, d, dtype,
                           sliding_window=sliding_window) for d in ranks]
    _check_family(cfg)
    dtype = dtype or _dtype(cfg)
    cache: Cache = {"len": torch.zeros((batch,), dtype=torch.int32,
                                       device=device)}
    if cfg.family == "ssm":
        state = S.init_ssm_state(cfg, batch, dtype, device)
        cache["ssm"] = {k: v.new_zeros((cfg.n_layers,) + v.shape)
                        for k, v in state.items()}
        return cache
    buf = kv_buffer_len(cfg, max_len)
    if sliding_window is not None:
        buf = min(buf, sliding_window)
    shape = (cfg.n_layers, batch, buf, cfg.n_kv_heads, cfg.head_dim)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    if kv_dtype == "int8":
        cache["kv"] = KVCache(zeros(shape, torch.int8), zeros(shape, torch.int8),
                              buf < max_len, zeros(shape[:3], torch.float32),
                              zeros(shape[:3], torch.float32))
    else:
        cache["kv"] = KVCache(zeros(shape, dtype), zeros(shape, dtype),
                              buf < max_len)
    return cache


def _write_prompt(kvc: KVCache, i: int, k: torch.Tensor,
                  v: torch.Tensor) -> None:
    """Write a prompt's K/V (B, S, KH, D) into layer ``i`` of the cache, in
    place: rows [0, S), or in a ring the last ``min(S, L)`` tokens at rows
    ``pos % L``; an int8 cache takes their codes and scales.  The prompt's
    own attention read the fresh K/V, unquantized, as in the reference."""
    pairs = [(kvc.k, k), (kvc.v, v)]
    if kvc.quantized:
        (kq, ks), (vq, vs) = L.quantize_kv(k), L.quantize_kv(v)
        pairs = [(kvc.k, kq), (kvc.v, vq), (kvc.k_scale, ks),
                 (kvc.v_scale, vs)]
    s, buf = k.shape[1], kvc.k.shape[2]
    if kvc.ring:
        take = min(s, buf)
        slots = torch.arange(s - take, s, device=k.device) % buf
        for dst, src in pairs:
            dst[i][:, slots] = src[:, s - take:]
    else:
        for dst, src in pairs:
            dst[i, :, :s] = src


# =========================================================================== #
# Prefill
# =========================================================================== #


def prefill(params: Params, cfg, batch: Dict, cache: Cache, *,
            attn_impl: str = "kernel",
            last_index: Optional[torch.Tensor] = None, mesh=None):
    """Process the full (right-padded) prompt batch, set ``len`` to S, and
    return the logits (B, 1, V) at ``last_index`` (B,) — each row's true
    last position — or at the last position.  The dense family writes its
    K/V into rows ``[0, S)`` of every slot of ``cache`` (a ring keeps the
    last tokens, an int8 cache their codes), the SSM family its decode
    states, in place.  ``attn_impl`` picks the kernels ("kernel") or
    the plain path ("torch") for attention and for the SSD scan alike.
    With ``mesh``, see the module docstring; the logits lie on rank 0's
    device."""
    shards, caches, ranks, lcfg = _ranks(params, cfg, cache, mesh)
    hs = _embed(shards, cfg, batch["tokens"], ranks)
    b, s = hs[0].shape[:2]
    layers = [_unstack(p["layers"], cfg.n_layers) for p in shards]
    if cfg.family == "ssm":
        h, states = hs[0], caches[0]["ssm"]
        for i, lp in enumerate(layers[0]):
            h, st = _ssm_body(cfg, attn_impl, lp, h)
            for k, v in st.items():
                states[k][i] = v
        hs = [h]
    else:
        pos = batch.get("positions")
        if pos is None:
            pos = torch.arange(s, device=ranks[0])[None, :].expand(b, s)
        cos_sins = [L.positional_cos_sin(cfg, pos.to(d)) for d in ranks]
        for i in range(cfg.n_layers):
            lps = [per[i] for per in layers]
            parts = []
            for lp, h, cs, c in zip(lps, hs, cos_sins, caches):
                out, (k, v) = L.attention_block(
                    lp["attn"], lcfg, L.apply_norm(cfg, lp["attn_norm"], h),
                    cs, attn_impl=attn_impl)
                _write_prompt(c["kv"], i, k, v)
                parts.append(out)
            hs = _mlp(cfg, lcfg, lps, _add_sum(hs, parts))
    for c, d in zip(caches, ranks):
        c["len"] = torch.full((b,), s, dtype=torch.int32, device=d)
    if last_index is not None:
        hs = [h[torch.arange(b, device=h.device),
                last_index.to(h.device).long()][:, None, :] for h in hs]
    else:
        hs = [h[:, -1:, :] for h in hs]
    return _unembed(shards, cfg, hs), cache


#: families :func:`prefill_chunk` supports — attention-only stacks whose KV
#: writes are position-addressable (the reference's tuple; of these the
#: port has the dense family).  Recurrent state (ssm/hybrid) absorbs every
#: position it sees, so those families keep exact one-shot prefill.
CHUNKABLE_FAMILIES = ("dense", "moe", "vlm")


def prefill_chunk(params: Params, cfg, batch: Dict, cache: Cache, *,
                  attn_impl: str = "kernel", start, valid_len):
    """Process ONE prompt chunk against a partially filled cache.

    ``batch["tokens"]`` is (B, C): C chunk tokens (right-padded to a shape
    bucket), of which the first ``valid_len`` (B,) are real, starting at
    absolute position ``start`` (B,) = tokens already prefilled.  The
    chunk's K/V are written into rows ``[start, start + valid_len)`` of the
    cache, in place, and its queries attend over the whole buffer under a
    ``kv_len`` mask with the plain ``sdpa`` (``layers.attention_decode``),
    whatever ``attn_impl`` is, as in the reference.  Sets ``len`` to
    ``start + valid_len`` and returns the logits at the chunk's last valid
    position (B, 1, V): the caller samples the first output token from the
    final chunk's, as it does from one-shot prefill's.

    Only :data:`CHUNKABLE_FAMILIES` with dense unquantized KV caches are
    supported; callers fall back to one-shot prefill otherwise."""
    if cfg.family not in CHUNKABLE_FAMILIES:
        raise ValueError(
            f"prefill_chunk supports families {CHUNKABLE_FAMILIES}, "
            f"got {cfg.family!r} — use one-shot prefill")
    shards, caches, ranks, lcfg = _ranks(params, cfg, cache, None)
    tokens = batch["tokens"]
    b, c = tokens.shape
    dev = ranks[0]
    start = torch.as_tensor(start, dtype=torch.int32, device=dev).expand(b)
    valid = torch.as_tensor(valid_len, dtype=torch.int32,
                            device=dev).expand(b)
    pos = start.long()[:, None] + torch.arange(c, device=dev)[None, :]
    hs = _embed(shards, cfg, tokens, ranks)
    cos_sins = [L.positional_cos_sin(cfg, pos)]
    layers = _unstack(shards[0]["layers"], cfg.n_layers)
    kvc = caches[0]["kv"]
    for i, lp in enumerate(layers):
        parts = L.attention_decode(
            [lp["attn"]], lcfg, [L.apply_norm(cfg, lp["attn_norm"], hs[0])],
            cos_sins, [kvc.layer(i)], [start], attn_impl=attn_impl,
            valid_lens=[valid])
        hs = _mlp(cfg, lcfg, [lp], _add_sum(hs, parts))
    caches[0]["len"] = start + valid
    h = hs[0][torch.arange(b, device=dev), (valid - 1).long()][:, None, :]
    return _unembed(shards, cfg, [h]), cache


# =========================================================================== #
# Decode step
# =========================================================================== #


def decode_step(params: Params, cfg, tokens: torch.Tensor, cache: Cache, *,
                attn_impl: str = "kernel",
                active: Optional[torch.Tensor] = None, mesh=None):
    """One-token step: tokens (B, 1) -> (logits (B, 1, V), cache).

    ``active`` (B,) bool: inactive rows (unoccupied or EOS-frozen slots) are
    computed but write no K/V (dense) or state (SSM) and keep their ``len``,
    so their cache stays bit-identical.  The SSM step is plain PyTorch
    whatever ``attn_impl`` is, as in the reference.  With ``mesh``, see
    the module docstring; the logits lie on rank 0's device."""
    shards, caches, ranks, lcfg = _ranks(params, cfg, cache, mesh)
    curs = [c["len"] for c in caches]
    acts = [None if active is None else active.to(d) for d in ranks]
    hs = _embed(shards, cfg, tokens, ranks)
    layers = [_unstack(p["layers"], cfg.n_layers) for p in shards]
    if cfg.family == "ssm":
        h, states = hs[0], caches[0]["ssm"]
        for i, lp in enumerate(layers[0]):
            h, st = _ssm_body(cfg, attn_impl, lp, h,
                              state={k: v[i] for k, v in states.items()},
                              active=active)
            for k, v in st.items():
                states[k][i] = v
        hs = [h]
    else:
        cos_sins = [L.positional_cos_sin(cfg, cur[:, None]) for cur in curs]
        for i in range(cfg.n_layers):
            lps = [per[i] for per in layers]
            parts = L.attention_decode(
                [lp["attn"] for lp in lps], lcfg,
                [L.apply_norm(cfg, lp["attn_norm"], h)
                 for lp, h in zip(lps, hs)], cos_sins,
                [c["kv"].layer(i) for c in caches], curs,
                attn_impl=attn_impl, actives=acts)
            hs = _mlp(cfg, lcfg, lps, _add_sum(hs, parts))
    for c, cur, act in zip(caches, curs, acts):
        c["len"] = cur + 1 if act is None else torch.where(act, cur + 1, cur)
    return _unembed(shards, cfg, hs), cache


# =========================================================================== #
# Ranks (a single device is one rank)
# =========================================================================== #


def _ranks(params, cfg, cache, mesh):
    """(per-rank params, per-rank caches, rank devices, rank config): one
    rank on the params' device without ``mesh``."""
    _check_family(cfg)
    if mesh is None:
        return [params], [cache], [params["embed"].device], cfg
    ranks = P.tp_ranks(mesh)
    return params, cache, ranks, P.local_config(cfg, len(ranks))


def _all_reduce(parts: List[torch.Tensor]) -> List[torch.Tensor]:
    """Sum the ranks' partials in rank order on rank 0's device; returns a
    copy of the sum on every rank's device (ranks on one device share it),
    so the sum is the same on every rank and in every run."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    return [total.to(p.device) for p in parts]


def _add_sum(hs: List[torch.Tensor], parts: List[torch.Tensor]):
    """The residual stream plus the sum of the ranks' partials."""
    if len(parts) == 1:
        return [hs[0] + parts[0]]
    return [h + s for h, s in zip(hs, _all_reduce(parts))]


def _embed(shards: List[Params], cfg, tokens: torch.Tensor, ranks):
    """The embedded tokens on every rank, ids clamped to [0, vocab - 1] as
    :func:`embed_tokens` does.  Over several ranks the lookup is
    vocab-parallel: each rank looks up the ids in its vocab range (zeros
    elsewhere), and the ranks sum."""
    if len(shards) == 1:
        return [embed_tokens(shards[0], cfg, tokens.to(ranks[0]))]
    vl = cfg.vocab_size // len(shards)
    parts = []
    for r, (p, d) in enumerate(zip(shards, ranks)):
        ids = tokens.to(d).long().clamp(0, cfg.vocab_size - 1) - r * vl
        own = (ids >= 0) & (ids < vl)
        e = p["embed"][ids.clamp(0, vl - 1)]
        parts.append(torch.where(own[..., None], e, torch.zeros_like(e)))
    return _all_reduce(parts)


def _unembed(shards: List[Params], cfg, hs: List[torch.Tensor]):
    """Final norm and logits; over several ranks each rank's vocab range,
    concatenated in rank order on rank 0's device."""
    outs = [unembed(p, cfg, h) for p, h in zip(shards, hs)]
    if len(outs) == 1:
        return outs[0]
    return torch.cat([o.to(outs[0].device) for o in outs], dim=-1)


def _mlp(cfg, lcfg, lps: List[Params], hs: List[torch.Tensor]):
    """The residual stream after each rank's (column/row-parallel) MLP."""
    return _add_sum(hs, [
        L.mlp_block(lp["mlp"], lcfg, L.apply_norm(cfg, lp["mlp_norm"], h))
        for lp, h in zip(lps, hs)])
