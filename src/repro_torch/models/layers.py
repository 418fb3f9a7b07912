"""Transformer building blocks in PyTorch: the dense subset of
``repro.models.layers``.

Parameters keep the reference's layout: plain nested dicts of tensors,
weights ``(in, out)`` applied as ``x @ W``.  Attention dispatches to the
hand-written kernels (``attn_impl="kernel"``, through
:mod:`repro_torch.kernels.ops`) or to the plain PyTorch path
(``attn_impl="torch"``, the oracle).

Unlike the reference, KV caches are updated in place: a decode step writes
its row into the cache buffers it was given, which saves a copy of the
whole cache per layer and step.  The decode step and the chunk of a
chunked prefill take the ranks of a tensor-parallel layer together
(:func:`attention_decode`), one rank on a single device.  A cache may be a ring (sliding window) and may hold int8
codes with per-token fp32 scales, as in the reference.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.kernels.ref import reference_attention as sdpa

Params = Dict[str, torch.Tensor]
ATTN_IMPLS = ("kernel", "torch")


@dataclass
class KVCache:
    """K/V buffers (..., batch, buf_len, kv_heads, head_dim); a leading
    layer axis is present in the model cache and absent per layer.

    ``ring``: the buffer is a ring over the last ``buf_len`` positions
    (position p lives in row ``p % buf_len``).  Quantized mode (``k_scale``
    given): the buffers hold int8 codes with per-token fp32 scales
    ``k_scale``/``v_scale`` (..., batch, buf_len), written by
    :func:`quantize_kv` (one scale over a token's heads x dims)."""

    k: torch.Tensor
    v: torch.Tensor
    ring: bool = False
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def layer(self, i: int) -> "KVCache":
        """Layer ``i`` of a model cache (views)."""
        return KVCache(self.k[i], self.v[i], self.ring,
                       *(None if s is None else s[i]
                         for s in (self.k_scale, self.v_scale)))


def quantize_kv(x: torch.Tensor):
    """x (B, S, KH, D) -> (int8 codes, fp32 scales (B, S)): symmetric, one
    scale per token, ``max(amax / 127, 1e-8)`` over its heads x dims; codes
    are ``x / scale`` rounded half to even and clipped to +-127 (the
    reference divides, so the port does too)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=(-1, -2)) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None, None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """int8 codes (..., KH, D) x scales (...) -> ``dtype``, via fp32."""
    return ref.dequantize(q, scale).to(dtype)


def masked_row_write(buf: torch.Tensor, slot: torch.Tensor, val: torch.Tensor,
                     active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Write ``val`` (B, ...) into ``buf`` (B, L, ...) at per-row position
    ``slot`` (B,), in place.  Rows with ``active=False`` keep their previous
    value bit for bit, and so does a row whose ``slot`` lies past the
    buffer: the reference's scatter drops an out-of-range write.  Returns
    ``buf``."""
    rows = torch.arange(buf.shape[0], device=buf.device)
    in_range = slot < buf.shape[1]
    keep = in_range if active is None else active & in_range
    slot = slot.long().clamp(max=buf.shape[1] - 1)
    keep = keep.reshape((-1,) + (1,) * (val.ndim - 1))
    buf[rows, slot] = torch.where(keep, val, buf[rows, slot])
    return buf


def masked_span_write(buf: torch.Tensor, start: torch.Tensor,
                      val: torch.Tensor, valid_len: torch.Tensor
                      ) -> torch.Tensor:
    """Write ``val`` (B, C, ...) into ``buf`` (B, L, ...) at rows
    ``[start, start + valid_len)`` of each batch row, in place.  Positions
    at or past ``valid_len`` (chunk padding) or past the buffer are not
    written, so every other row keeps its content bit for bit: the
    reference drops them by an out-of-bounds scatter.  Returns ``buf``."""
    c = val.shape[1]
    span = torch.arange(c, device=buf.device)[None, :]
    idx = start.to(buf.device).long()[:, None] + span            # (B, C)
    ok = (span < valid_len.to(buf.device)[:, None]) & (idx < buf.shape[1])
    rows = torch.arange(val.shape[0], device=buf.device)[:, None]
    rows = rows.expand_as(idx)
    buf[rows[ok], idx[ok]] = val[ok]
    return buf


# --------------------------------------------------------------------------- #
# Initialisers (the reference's distributions, drawn from a torch.Generator)
# --------------------------------------------------------------------------- #


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype=torch.float32, *, lead: Tuple[int, ...] = ()):
    """Uniform(-1/sqrt(in), 1/sqrt(in)) weights of shape lead + (in, out)."""
    scale = 1.0 / math.sqrt(in_dim)
    w = torch.rand(lead + (in_dim, out_dim), generator=gen,
                   device=gen.device, dtype=torch.float32)
    return (w * (2 * scale) - scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype=torch.float32) -> torch.Tensor:
    """Normal(0, 0.02) embeddings."""
    e = torch.randn((vocab, dim), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (e * 0.02).to(dtype)


# --------------------------------------------------------------------------- #
# Norms
# --------------------------------------------------------------------------- #


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm computed in fp32 and cast back to ``x``'s dtype."""
    orig = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * p["scale"].float()).to(orig)


def init_layernorm(dim: int, dtype=torch.float32, *, lead: Tuple[int, ...] = (),
                   device=None) -> Params:
    """Unit scale and zero bias of shape lead + (dim,)."""
    return {"scale": torch.ones(lead + (dim,), dtype=dtype, device=device),
            "bias": torch.zeros(lead + (dim,), dtype=dtype, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in fp32 with the biased variance, as
    the reference's ``jnp.var``; cast back to ``x``'s dtype."""
    orig = x.dtype
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    x = (x - mean) * torch.rsqrt(var + eps)
    out = x * p["scale"].float() + p["bias"].float()
    return out.to(orig)


def apply_norm(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"norm {cfg.norm!r} is not ported yet")
    return rmsnorm(p, x, cfg.norm_eps)


# --------------------------------------------------------------------------- #
# Rotary position embeddings
# --------------------------------------------------------------------------- #


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), fp32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (..., seq) -> cos/sin of shape (..., seq, head_dim//2)."""
    inv = rope_freqs(head_dim, theta, positions.device)
    angles = positions[..., None].float() * inv
    return torch.cos(angles), torch.sin(angles)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D); cos/sin (B, S, D//2), fp32.  Rotate-half convention,
    computed in fp32 and cast back to ``x``'s dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.cat([o1, o2], dim=-1).to(x.dtype)


def positional_cos_sin(cfg, positions: torch.Tensor):
    if cfg.rope_type != "rope":
        raise NotImplementedError(f"rope_type {cfg.rope_type!r} is not "
                                  "ported yet")
    return rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)


# --------------------------------------------------------------------------- #
# Attention
# --------------------------------------------------------------------------- #


def init_attention(gen: torch.Generator, cfg, n_layers: int,
                   dtype=torch.float32) -> Params:
    d, hd = cfg.d_model, cfg.head_dim
    lead = (n_layers,)
    p: Params = {
        "wq": dense_init(gen, d, cfg.n_heads * hd, dtype, lead=lead),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, dtype, lead=lead),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, dtype, lead=lead),
        "wo": dense_init(gen, cfg.n_heads * hd, d, dtype, lead=lead),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                            ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros((n_layers, width * hd), dtype=dtype,
                                  device=gen.device)
    return p


def project_qkv(p: Params, cfg, x: torch.Tensor, cos_sin):
    """proj -> rope: x (B, S, d_model) -> q (B, S, H, D), k and v
    (B, S, KH, D)."""
    b, s, _ = x.shape
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kh, hd)
    v = v.reshape(b, s, kh, hd)
    if cos_sin is not None:
        cos, sin = cos_sin
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
    return q, k, v


def attention_block(p: Params, cfg, x: torch.Tensor, cos_sin, *,
                    attn_impl: str = "kernel"):
    """Prefill attention: proj -> rope -> full-sequence causal attention ->
    out proj.  Returns (out, (k, v)) for cache seeding.  The one-token
    decode step and the chunk of a chunked prefill, which attend over a
    cache, are :func:`attention_decode`."""
    _check_impl(attn_impl)
    b, s, _ = x.shape
    q, k, v = project_qkv(p, cfg, x, cos_sin)
    window = cfg.swa_window if cfg.attention_type == "swa" else None
    if attn_impl == "kernel":
        out = ops.flash_attention(q, k, v, window=window)
    else:
        out = sdpa(q, k, v, causal=True, window=window)
    return out.reshape(b, s, cfg.n_heads * cfg.head_dim) @ p["wo"], (k, v)


def attention_decode(ps: Sequence[Params], cfg, xs: Sequence[torch.Tensor],
                     cos_sins, caches: Sequence[KVCache],
                     curs: Sequence[torch.Tensor], *,
                     attn_impl: str = "kernel",
                     actives: Optional[Sequence] = None,
                     valid_lens: Optional[Sequence] = None
                     ) -> List[torch.Tensor]:
    """One-token decode attention of every tensor-parallel rank of a layer
    (a single device is one rank): for rank r, proj -> rope -> write the
    new K/V row into ``caches[r]`` (buffers (B, L, KHr, D)) in place at the
    per-slot position ``curs[r]`` (B,) (``curs[r] % L`` in a ring) ->
    attention over the cache -> out proj, with ``cfg`` the rank's config;
    x is (B, 1, d_model).  Rows whose ``actives[r]`` entry is False write
    nothing, so their cache stays bit for bit.  An int8 cache stores the
    row's codes and scales (:func:`quantize_kv`).

    Chunked prefill: x is (B, C>1, d_model), C fresh tokens starting at
    absolute position ``curs[r]`` (B,), of which the first
    ``valid_lens[r]`` (B,) are real (the rest is bucket padding).  The
    valid span's K/V are written into the cache by
    :func:`masked_span_write` and the chunk's queries attend over the
    whole buffer under a ``kv_len`` mask, with the plain ``sdpa`` whatever
    ``attn_impl`` is, as in the reference.  Ring and int8 caches raise
    ``ValueError``: a ring write is position-destructive, and an int8 read
    would dequantize the prefix while one-shot prefill attends the fresh
    K/V.

    Reads: the kernel path reads all ranks with one
    ``ops.flash_decode_sharded`` call (one rank: ``ops.flash_decode``, or
    ``ops.flash_decode_int8`` over an int8 cache, which dequantizes in
    fp32); the plain path dequantizes an int8 cache to q's dtype and calls
    ``sdpa``, as the reference does.  A ring is read plain whatever
    ``attn_impl`` is, as in the reference, which has no kernel for it.
    Returns each rank's (B, S, d_model) output (a partial sum when there
    are several ranks)."""
    _check_impl(attn_impl)
    if xs[0].shape[1] > 1:
        return _attention_chunk(ps, cfg, xs, cos_sins, caches, curs,
                                valid_lens)
    if caches[0].quantized and len(caches) > 1:
        raise NotImplementedError(
            "an int8 KV cache under tensor parallelism is not ported: the "
            "scale spans all KV heads of a token, so per-rank scales would "
            "compute another function")
    actives = actives or [None] * len(ps)
    qs = []
    for p, x, cs, c, cur, act in zip(ps, xs, cos_sins, caches, curs, actives):
        q, k, v = project_qkv(p, cfg, x, cs)
        slot = cur % c.k.shape[1] if c.ring else cur
        rows = [(c.k, k), (c.v, v)]
        if c.quantized:
            (kq, ksc), (vq, vsc) = quantize_kv(k), quantize_kv(v)
            rows = [(c.k, kq), (c.v, vq), (c.k_scale, ksc), (c.v_scale, vsc)]
        for buf, val in rows:
            masked_row_write(buf, slot, val[:, 0], act)
        qs.append(q)
    window = cfg.swa_window if cfg.attention_type == "swa" else None
    c0 = caches[0]
    if c0.ring or attn_impl == "torch":
        outs = [_plain_read(q, c, cur, window)
                for q, c, cur in zip(qs, caches, curs)]
    elif c0.quantized:
        outs = [ops.flash_decode_int8(qs[0], c0.k, c0.v, c0.k_scale,
                                      c0.v_scale, kv_len=curs[0] + 1,
                                      q_offset=curs[0], window=window)]
    elif len(qs) == 1:
        outs = [ops.flash_decode(qs[0], c0.k, c0.v, kv_len=curs[0] + 1,
                                 q_offset=curs[0], window=window)]
    else:
        outs = ops.flash_decode_sharded(
            qs, [c.k for c in caches], [c.v for c in caches],
            kv_len=curs[0] + 1, q_offset=curs[0], window=window)
    b = xs[0].shape[0]
    return [o.reshape(b, 1, cfg.n_heads * cfg.head_dim) @ p["wo"]
            for o, p in zip(outs, ps)]


def _attention_chunk(ps, cfg, xs, cos_sins, caches, curs, valid_lens):
    """The chunked-prefill branch of :func:`attention_decode`."""
    if caches[0].ring or caches[0].quantized:
        raise ValueError(
            "chunked prefill requires a dense unquantized KV cache "
            "(ring/SWA and int8 caches fall back to one-shot prefill)")
    b, s, _ = xs[0].shape
    window = cfg.swa_window if cfg.attention_type == "swa" else None
    outs = []
    for p, x, cs, c, cur, valid in zip(ps, xs, cos_sins, caches, curs,
                                       valid_lens):
        q, k, v = project_qkv(p, cfg, x, cs)
        masked_span_write(c.k, cur, k, valid)
        masked_span_write(c.v, cur, v, valid)
        out = sdpa(q, c.k, c.v, causal=True, q_offset=cur,
                   kv_len=cur + valid, window=window)
        outs.append(out.reshape(b, s, cfg.n_heads * cfg.head_dim) @ p["wo"])
    return outs


def _plain_read(q: torch.Tensor, c: KVCache, cur: torch.Tensor, window):
    """The reference's XLA read of one rank's cache after the write: an
    int8 cache dequantized to q's dtype; a ring attends with each row's
    absolute position, the largest p <= cur with p % L == row (rows not
    yet written get -1e9, which only a window masks, as in the
    reference)."""
    kread, vread = c.k, c.v
    if c.quantized:
        kread = dequantize_kv(c.k, c.k_scale, q.dtype)
        vread = dequantize_kv(c.v, c.v_scale, q.dtype)
    if not c.ring:
        return sdpa(q, kread, vread, causal=True, q_offset=cur,
                    kv_len=cur + 1, window=window)
    L = c.k.shape[1]
    idx = torch.arange(L, device=cur.device)[None, :]
    k_pos = idx + torch.div(cur.long()[:, None] - idx, L,
                            rounding_mode="floor") * L
    k_pos = torch.where(k_pos < 0, -1_000_000_000, k_pos)
    return sdpa(q, kread, vread, causal=True, q_offset=cur, window=window,
                ring_offset=k_pos)


def _check_impl(attn_impl: str) -> None:
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, "
                         f"got {attn_impl!r}")


# --------------------------------------------------------------------------- #
# MLP
# --------------------------------------------------------------------------- #


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, n_layers: int,
             dtype=torch.float32, *, gated: bool = True) -> Params:
    """``n_layers`` stacked MLPs: ``w_up``, ``w_down`` and, when ``gated``,
    ``w_gate`` (the encoder's MLP is not gated)."""
    lead = (n_layers,)
    p = {
        "w_up": dense_init(gen, d_model, d_ff, dtype, lead=lead),
        "w_down": dense_init(gen, d_ff, d_model, dtype, lead=lead),
    }
    if gated:
        p["w_gate"] = dense_init(gen, d_model, d_ff, dtype, lead=lead)
    return p


def mlp_block(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    """Gated SiLU MLP: (silu(x W_gate) * x W_up) W_down."""
    if cfg.activation != "silu" or "w_gate" not in p:
        raise NotImplementedError("only the gated SiLU MLP is ported yet")
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
