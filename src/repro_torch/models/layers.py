"""Transformer building blocks in PyTorch: the port of
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
from repro_torch.launch.mesh import collective
from repro_torch.ranks import ranked

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
    :func:`quantize_kv` (one scale over a token's heads x dims).

    A rank's piece of a cache a pod splits other than by head
    (:mod:`repro_torch.models.kv_split`) holds rows ``[row0, row0 +
    buf_len)`` of a buffer of ``total`` rows (``total`` 0: the whole
    buffer unsplit), of every KV head (the sequence-sharded layout) or of
    its rank's (the context-parallel one); the head-dim layout's piece
    holds every row and KV head, and dims ``[dim0, dim0 + D_r)`` of
    heads of ``dims`` dims."""

    k: torch.Tensor
    v: torch.Tensor
    ring: bool = False
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    row0: int = 0
    total: int = 0
    dim0: int = 0
    dims: int = 0

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def layer(self, i: int) -> "KVCache":
        """Layer ``i`` of a model cache (views)."""
        return KVCache(self.k[i], self.v[i], self.ring,
                       *(None if s is None else s[i]
                         for s in (self.k_scale, self.v_scale)),
                       self.row0, self.total, self.dim0, self.dims)


class KVShards(list):
    """One rank's KV cache in the context-parallel layout: its row
    ranges, one :class:`KVCache` a data index, in data order."""

    @property
    def quantized(self) -> bool:
        return self[0].quantized

    @property
    def ring(self) -> bool:
        return self[0].ring

    def layer(self, i: int) -> "KVShards":
        return KVShards(c.layer(i) for c in self)


def quantize_kv(x: torch.Tensor, amax: Optional[torch.Tensor] = None):
    """x (B, S, KH, D) -> (int8 codes, fp32 scales (B, S)): symmetric, one
    scale per token, ``max(amax / 127, 1e-8)`` over its heads x dims; codes
    are ``x / scale`` rounded half to even and clipped to +-127 (the
    reference divides, so the port does too).  ``amax`` (B, S) replaces
    the token's amax over ``x``'s heads (:func:`quantize_kv_shared`)."""
    xf = x.float()
    if amax is None:
        amax = xf.abs().amax(dim=(-1, -2))
    scale = torch.clamp(amax.to(xf.device) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None, None]), -127, 127)
    return q.to(torch.int8), scale


def quantize_kv_shared(xs: Sequence[torch.Tensor]):
    """:func:`quantize_kv` of one token's K (or V) split over the
    tensor-parallel ranks' KV heads, ``xs[r]`` (B, S, KHr, D) on rank r's
    device: each rank takes the amax over its heads, the ranks take one
    max of those (B, S) vectors in rank order on rank 0's device (a
    cross-rank all-reduce), and every rank quantizes with that shared
    amax.  The max is exact, so every rank's codes and its copy of the
    scales are the single-device cache's; a KV head that two ranks hold
    (replicated by need) changes no max, and a rank with no KV heads
    adds no amax.  Returns ``[(codes, scales)]`` a rank; one rank is
    :func:`quantize_kv`."""
    if len(xs) == 1:
        return [quantize_kv(xs[0])]
    amax = [x.float().abs().amax(dim=(-1, -2)) for x in xs if x.shape[-2]]
    top = amax[0]
    for a in amax[1:]:
        top = torch.maximum(top, a.to(top.device))
    collective("all-reduce", top.nbytes)
    return [quantize_kv(x, top) for x in xs]


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
                      val: torch.Tensor, valid_len: torch.Tensor,
                      row0: int = 0) -> torch.Tensor:
    """Write ``val`` (B, C, ...) into ``buf`` (B, L, ...) at rows
    ``[start, start + valid_len)`` of each batch row, in place.  Positions
    at or past ``valid_len`` (chunk padding) or past the buffer are not
    written, so every other row keeps its content bit for bit: the
    reference drops them by an out-of-bounds scatter.  ``row0``: ``buf``
    holds the rows from ``row0`` on of a buffer a pod splits, and takes
    only those.  Returns ``buf``."""
    c = val.shape[1]
    span = torch.arange(c, device=buf.device)[None, :]
    idx = start.to(buf.device).long()[:, None] + span - row0     # (B, C)
    ok = ((span < valid_len.to(buf.device)[:, None]) & (idx >= 0)
          & (idx < buf.shape[1]))
    rows = torch.arange(val.shape[0], device=buf.device)[:, None]
    rows = rows.expand_as(idx)
    buf[rows[ok], idx[ok]] = val[ok]
    return buf


# --------------------------------------------------------------------------- #
# Initialisers (the reference's distributions, drawn from a torch.Generator)
# --------------------------------------------------------------------------- #


class MetaGenerator:
    """Stands in for a ``torch.Generator`` on the meta device, which torch
    has not: the initialisers then draw nothing and allocate nothing
    (``transformer.abstract_params``)."""

    device = torch.device("meta")


def rng(gen):
    """The generator to draw from on ``gen.device`` (None on meta)."""
    return None if isinstance(gen, MetaGenerator) else gen


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype=torch.float32, *, lead: Tuple[int, ...] = ()):
    """Uniform(-1/sqrt(in), 1/sqrt(in)) weights of shape lead + (in, out).

    Drawn one (in, out) matrix at a time in fp32, scaled in place and cast
    into the ``dtype`` leaf, so the fp32 transient is one matrix, never
    the stacked leaf: qwen1.5-32b's ``w_gate`` (64, 5120, 27392) is 35.9 GB
    in fp32, as much again as its bf16 weights."""
    scale = 1.0 / math.sqrt(in_dim)
    out = torch.empty(lead + (in_dim, out_dim), dtype=dtype,
                      device=gen.device)
    for m in out.view(-1, in_dim, out_dim):
        w = torch.rand((in_dim, out_dim), generator=rng(gen), device=gen.device,
                       dtype=torch.float32)
        m.copy_(w.mul_(2 * scale).sub_(scale))
    return out


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype=torch.float32) -> torch.Tensor:
    """Normal(0, 0.02) embeddings."""
    e = torch.randn((vocab, dim), generator=rng(gen), device=gen.device,
                    dtype=torch.float32)
    return e.mul_(0.02).to(dtype)


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
    if cfg.norm == "layernorm":
        return layernorm(p, x, cfg.norm_eps)
    return rmsnorm(p, x, cfg.norm_eps)


def init_norm(cfg, dim: int, dtype=torch.float32, *,
              lead: Tuple[int, ...] = (), device=None) -> Params:
    """The norm ``cfg.norm`` names, of shape lead + (dim,): a unit scale,
    and a zero bias for LayerNorm."""
    if cfg.norm == "layernorm":
        return init_layernorm(dim, dtype, lead=lead, device=device)
    return {"scale": torch.ones(lead + (dim,), dtype=dtype, device=device)}


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


def mrope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                  sections: Tuple[int, int, int]):
    """M-RoPE (Qwen2-VL): positions (3, B, S) on the (temporal, height,
    width) axes; the rotary frequencies are cut into three bands of
    ``sections`` frequencies, each band taking the angles of its axis.
    Returns cos/sin of shape (B, S, head_dim // 2)."""
    half = head_dim // 2
    t, h, w = sections
    if t + h + w != half:
        raise ValueError(f"mrope sections {sections} do not cover the "
                         f"{half} rotary frequencies")
    inv = rope_freqs(head_dim, theta, positions.device)
    angles = positions[..., None].float() * inv         # (3, B, S, half)
    picked = torch.cat([angles[0, ..., :t], angles[1, ..., t:t + h],
                        angles[2, ..., t + h:]], dim=-1)
    return torch.cos(picked), torch.sin(picked)


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
    """positions (B, S), or (3, B, S) for M-RoPE -> (cos, sin), or None
    where the config has no rotary embedding (learned positions).  M-RoPE
    given (B, S) positions puts them on all three axes (text only)."""
    if cfg.rope_type == "rope":
        return rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    if cfg.rope_type == "mrope":
        if positions.ndim == 2:
            positions = positions[None].expand((3,) + positions.shape)
        return mrope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                             cfg.mrope_sections)
    return None


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
    (B, S, KH, D); ``cos_sin`` None applies no rotary embedding."""
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


def head_segments(cfg, heads=None):
    """The uniform GQA segments of one rank's heads
    (``kernels.ops.head_segments``): ``heads`` is the rank's (first query
    head, global group size), from ``launch.partition.rank_heads``; None
    (one device, or a rank whose shard is uniform) is one segment of all
    of ``cfg``'s heads."""
    if heads is None:
        return ops.head_segments(0, cfg.n_heads, 0, cfg.n_kv_heads)
    return ops.head_segments(heads[0], cfg.n_heads, heads[1])


def attention_block(p: Params, cfg, x: torch.Tensor, cos_sin, *,
                    attn_impl: str = "kernel", heads=None):
    """Prefill attention: proj -> rope -> full-sequence causal attention ->
    out proj.  Returns (out, (k, v)) for cache seeding.  ``cfg`` may be a
    tensor-parallel rank's, with ``heads`` its (first query head, group
    size): a rank whose heads cut a GQA group attends segment by segment
    (:func:`head_segments`), and a rank with no heads gives a zero
    partial.  The one-token decode step and the chunk of a chunked
    prefill, which attend over a cache, are :func:`attention_decode`."""
    _check_impl(attn_impl)
    b, s, _ = x.shape
    q, k, v = project_qkv(p, cfg, x, cos_sin)
    window = cfg.swa_window if cfg.attention_type == "swa" else None
    if attn_impl == "kernel":
        tp_heads = {} if heads is None else dict(head_start=heads[0],
                                                 group=heads[1])
        out = ops.flash_attention(q, k, v, window=window, **tp_heads)
    else:
        out = ref.over_segments(sdpa, q, k, v, head_segments(cfg, heads),
                                causal=True, window=window)
    return out.reshape(b, s, cfg.n_heads * cfg.head_dim) @ p["wo"], (k, v)


def attention_decode(ps: Sequence[Params], cfg, xs: Sequence[torch.Tensor],
                     cos_sins, caches: Sequence[KVCache],
                     curs: Sequence[torch.Tensor], *,
                     attn_impl: str = "kernel",
                     actives: Optional[Sequence] = None,
                     valid_lens: Optional[Sequence] = None,
                     heads: Optional[Sequence] = None
                     ) -> List[torch.Tensor]:
    """One-token decode attention of every tensor-parallel rank of a layer
    (a single device is one rank): for rank r, proj -> rope -> write the
    new K/V row into ``caches[r]`` (buffers (B, L, KHr, D)) in place at the
    per-slot position ``curs[r]`` (B,) (``curs[r] % L`` in a ring) ->
    attention over the cache -> out proj; x is (B, 1, d_model).  ``cfg``
    is the ranks' configs, one a rank (``launch.partition.local_configs``;
    one config serves every rank), and ``heads`` each rank's (first query
    head, group size) (``launch.partition.rank_heads``; None: every
    shard is uniform): a rank whose heads cut a GQA group reads segment by
    segment, and a rank with no heads writes and reads nothing and gives
    a zero partial.  Rows whose ``actives[r]`` entry is False write
    nothing, so their cache stays bit for bit.  An int8 cache stores the
    row's codes and scales, the scale shared by the ranks
    (:func:`quantize_kv_shared`).

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
    ``ops.flash_decode_sharded`` call, or over an int8 cache one
    ``ops.flash_decode_int8_sharded`` call (one rank:
    ``ops.flash_decode``, or ``ops.flash_decode_int8``, which dequantizes
    in fp32); the plain path dequantizes each rank's int8 cache to q's
    dtype and calls ``sdpa``, as the reference does.  A ring is read plain whatever
    ``attn_impl`` is, as in the reference, which has no kernel for it.
    Returns each rank's (B, S, d_model) output (a partial sum when there
    are several ranks)."""
    _check_impl(attn_impl)
    cfgs = list(cfg) if isinstance(cfg, (list, tuple)) else [cfg] * len(ps)
    heads = list(heads) if heads is not None else [None] * len(ps)
    segs = [head_segments(c, h) for c, h in zip(cfgs, heads)]
    if xs[0].shape[1] > 1:
        return _attention_chunk(ps, cfgs, xs, cos_sins, caches, curs,
                                valid_lens, segs)
    actives = actives or [None] * len(ps)
    qkvs = [project_qkv(p, c, x, cs)
            for p, c, x, cs in ranked(zip(ps, cfgs, xs, cos_sins))]
    c0 = caches[0]
    if c0.quantized:
        kqs = quantize_kv_shared([k for _, k, _ in qkvs])
        vqs = quantize_kv_shared([v for _, _, v in qkvs])
    qs = []
    for r, ((q, k, v), c, cur, act) in ranked(enumerate(zip(
            qkvs, caches, curs, actives))):
        slot = cur % c.k.shape[1] if c.ring else cur
        rows = [(c.k, k), (c.v, v)]
        if c.quantized:
            (kq, ksc), (vq, vsc) = kqs[r], vqs[r]
            rows = [(c.k, kq), (c.v, vq), (c.k_scale, ksc), (c.v_scale, vsc)]
        for buf, val in rows:
            masked_row_write(buf, slot, val[:, 0], act)
        qs.append(q)
    window = cfgs[0].swa_window if cfgs[0].attention_type == "swa" else None
    tp_heads = {} if heads[0] is None else dict(
        head_starts=[h[0] for h in heads], group=heads[0][1])
    if c0.ring or attn_impl == "torch":
        outs = [_plain_read(q, c, cur, window, sg)
                for q, c, cur, sg in ranked(zip(qs, caches, curs, segs))]
    elif c0.quantized and len(qs) == 1:
        outs = [ops.flash_decode_int8(qs[0], c0.k, c0.v, c0.k_scale,
                                      c0.v_scale, kv_len=curs[0] + 1,
                                      q_offset=curs[0], window=window)]
    elif c0.quantized:
        outs = ops.flash_decode_int8_sharded(
            qs, [c.k for c in caches], [c.v for c in caches],
            [c.k_scale for c in caches], [c.v_scale for c in caches],
            kv_len=curs[0] + 1, q_offset=curs[0], window=window, **tp_heads)
    elif len(qs) == 1:
        outs = [ops.flash_decode(qs[0], c0.k, c0.v, kv_len=curs[0] + 1,
                                 q_offset=curs[0], window=window)]
    else:
        outs = ops.flash_decode_sharded(
            qs, [c.k for c in caches], [c.v for c in caches],
            kv_len=curs[0] + 1, q_offset=curs[0], window=window, **tp_heads)
    b = xs[0].shape[0]
    return [o.reshape(b, 1, c.n_heads * c.head_dim) @ p["wo"]
            for o, c, p in ranked(zip(outs, cfgs, ps))]


def _attention_chunk(ps, cfgs, xs, cos_sins, caches, curs, valid_lens, segs):
    """The chunked-prefill branch of :func:`attention_decode`."""
    if caches[0].ring or caches[0].quantized:
        raise ValueError(
            "chunked prefill requires a dense unquantized KV cache "
            "(ring/SWA and int8 caches fall back to one-shot prefill)")
    b, s, _ = xs[0].shape
    window = cfgs[0].swa_window if cfgs[0].attention_type == "swa" else None
    outs = []
    for p, cfg, x, cs, c, cur, valid, sg in ranked(zip(
            ps, cfgs, xs, cos_sins, caches, curs, valid_lens, segs)):
        q, k, v = project_qkv(p, cfg, x, cs)
        masked_span_write(c.k, cur, k, valid)
        masked_span_write(c.v, cur, v, valid)
        out = ref.over_segments(sdpa, q, c.k, c.v, sg, causal=True,
                                q_offset=cur, kv_len=cur + valid,
                                window=window)
        outs.append(out.reshape(b, s, cfg.n_heads * cfg.head_dim) @ p["wo"])
    return outs


def _plain_read(q: torch.Tensor, c: KVCache, cur: torch.Tensor, window,
                segs=None):
    """The reference's XLA read of one rank's cache after the write, over
    each uniform GQA segment ``segs`` of its heads (default one): an int8
    cache dequantized to q's dtype; a ring attends with each row's
    absolute position, the largest p <= cur with p % L == row (rows not
    yet written get -1e9, which only a window masks, as in the
    reference)."""
    if segs is None:
        segs = [(0, q.shape[2], 0, c.k.shape[2])]
    kread, vread = c.k, c.v
    if c.quantized:
        kread = dequantize_kv(c.k, c.k_scale, q.dtype)
        vread = dequantize_kv(c.v, c.v_scale, q.dtype)
    if not c.ring:
        return ref.over_segments(sdpa, q, kread, vread, segs, causal=True,
                                 q_offset=cur, kv_len=cur + 1, window=window)
    L = c.k.shape[1]
    idx = torch.arange(L, device=cur.device)[None, :]
    k_pos = idx + torch.div(cur.long()[:, None] - idx, L,
                            rounding_mode="floor") * L
    k_pos = torch.where(k_pos < 0, -1_000_000_000, k_pos)
    return ref.over_segments(sdpa, q, kread, vread, segs, causal=True,
                             q_offset=cur, window=window, ring_offset=k_pos)


def init_cross_attention(gen: torch.Generator, cfg, n_layers: int,
                         dtype=torch.float32) -> Params:
    """``n_layers`` stacked cross-attention projections, d_model x
    d_model each, without biases."""
    d = cfg.d_model
    return {name: dense_init(gen, d, d, dtype, lead=(n_layers,))
            for name in ("wq", "wk", "wv", "wo")}


def cross_attention_block(p: Params, cfg, x: torch.Tensor,
                          enc_kv: Tuple[torch.Tensor, torch.Tensor]
                          ) -> torch.Tensor:
    """Decoder cross-attention over precomputed encoder K/V (B, Se, H,
    head_dim): plain attention with no mask, as in the reference.  ``cfg``
    may be a tensor-parallel rank's: H is then its query heads, ``p`` its
    columns of ``wq`` and rows of ``wo``, and the output its partial sum.
    The head dim is the stored ``head_dim`` (the reference's ``d_model //
    n_heads`` on one device), never ``d_model`` over a rank's heads."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k, v = enc_kv
    return sdpa(q, k, v, causal=False).reshape(b, s, h * hd) @ p["wo"]


def encode_cross_kv(p: Params, cfg, enc_out: torch.Tensor):
    """The encoder output (B, Se, d_model) -> cross-attention K and V (B,
    Se, H, head_dim), over a tensor-parallel rank's query heads when
    ``cfg`` and ``p`` are a rank's (:func:`cross_attention_block`)."""
    b, se, _ = enc_out.shape
    h, hd = cfg.n_heads, cfg.head_dim
    return ((enc_out @ p["wk"]).reshape(b, se, h, hd),
            (enc_out @ p["wv"]).reshape(b, se, h, hd))


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
    ``w_gate`` (the BGE encoder's and whisper's MLPs are not gated)."""
    lead = (n_layers,)
    p = {
        "w_up": dense_init(gen, d_model, d_ff, dtype, lead=lead),
        "w_down": dense_init(gen, d_ff, d_model, dtype, lead=lead),
    }
    if gated:
        p["w_gate"] = dense_init(gen, d_model, d_ff, dtype, lead=lead)
    return p


def _activation(cfg, x: torch.Tensor) -> torch.Tensor:
    """SiLU, or GELU in its tanh form: ``jax.nn.gelu``'s default."""
    if cfg.activation == "gelu":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def mlp_block(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    """Gated MLP (act(x W_gate) * x W_up) W_down when ``p`` has
    ``w_gate``, else act(x W_up) W_down; ``act`` is ``cfg.activation``."""
    if "w_gate" in p:
        return (_activation(cfg, x @ p["w_gate"]) * (x @ p["w_up"])) @ p[
            "w_down"]
    return _activation(cfg, x @ p["w_up"]) @ p["w_down"]
