"""KV caches whose rows a pod splits, read as split-KV across the ranks:
the reference's sequence-sharded cache (``kv_shard="seq"``, which its
default ``"auto"`` picks wherever the model axis does not divide the KV
heads) and its context-parallel cache (the KV sequence on "data", for a
decode whose global batch is under 16: long_500k).

**Sequence-sharded** (``transformer.init_cache(..., kv_shard="seq")``):
rank r of the pod holds every KV head over its rows ``[r0, r1)`` of the
buffer (``partition.split_range`` of the rows: the first ranks one row
more where the ranks do not divide them), and an int8
cache its scales (sites, B, rows) with them; ``len`` stays per slot on
every rank.  A ring of W rows keeps position p at buffer row ``p % W``,
which lies on the rank whose range holds that row.  The projections keep
the head layout: rank r computes its query heads and the KV heads they
read.  A write gathers every KV head of the new rows (the reference's
scattered ring-buffer writes: each rank sends its heads of a row to the
rank that owns the row, one all-to-all) and the owner writes them; an
int8 row is quantized whole, so its codes and scale are one device's.
The decode gathers every query head on every rank (an all-gather of
B x H x D), each rank computes the fp32 partial state (o, m, l) of all
heads over its rows, and each head's states are merged, in rank order,
on the rank that owns the head (an all-to-all of the states), whose
``wo`` partial then joins the usual sum.  A slot with no visible row on
a rank (``kv_len`` 0, or its rows all elsewhere) leaves that rank's
state empty (``l = 0``), which weighs nothing in the merge
(``ref.combine_partials``).

**Context-parallel** (``init_cache(..., context=(D, indices))``): each
rank keeps the head layout's KV heads, over one row range a data index
(``layers.KVShards``: ``indices`` are the data indices this process
holds, all D for a whole pod, the first alone for the dry run's program
of one data index).  The batch is replicated over the data axis, so the
projections and the MLP are the same computation on every data index:
one process runs them once, on the pod's ranks, and the data indices
run in step by construction.  Each data index writes the rows it owns
and computes its partial states over them; the states merge across the
data axis for each of the rank's heads (an all-reduce).

**The audio family's cross-attention K/V** (``cross_kv``) follows the
same rule in the sequence-sharded and head-dim layouts, as the
reference's ``cache_pspecs`` applies one rule to ``kv`` and
``cross_kv``: rank r holds every query head's K/V over its frames
``split_range(n_frames, tp, r)`` ("seq") or its dims of every head
("head_dim").  The prefill gathers the ranks' heads of the encoder K/V
and each rank writes its piece (:func:`write_cross`); a decode reads it
(:func:`cross_attention`) with every query head on every rank and each
rank's partial states over its frames merged by each head's owner, or
the head-dim partial scores summed before the softmax.  The reads are
plain, as the reference reads cross-attention in XLA; the
context-parallel layout keeps ``cross_kv`` in the head layout.

Kernels: a linear cache's decode reads each rank's rows with
``ops.flash_decode_partials`` (``ops.flash_decode_int8_partials`` over
int8 codes), every rank's splits side by side in one ``ops.Partials``
scratch, which one ``ops.flash_decode_combine`` merges.  A ring, the
chunk of a chunked prefill and ``attn_impl="torch"`` read plain
(``ref.attention_partials`` and ``ref.merge_partials``), as the
reference reads a ring under XLA.  Prefill attends over the prompt's
fresh K/V in the head layout (``flash_attention``), as before: only its
writes change.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels import ops, ref
from repro_torch.launch.mesh import collective
from repro_torch.models.layers import (KVCache, KVShards, dequantize_kv,
                                       masked_row_write, masked_span_write,
                                       project_qkv, quantize_kv,
                                       quantize_kv_shared)
from repro_torch.ranks import ranked


def split(c) -> bool:
    """Whether the rank cache ``c`` (a KVCache or KVShards) holds rows of
    a buffer a pod splits."""
    return isinstance(c, KVShards) or (isinstance(c, KVCache) and c.total > 0)


def kv_ranges(cfgs, heads) -> List[Tuple[int, int]]:
    """Each rank's KV heads ``[lo, hi)`` in the head layout
    (``partition.kv_head_range``), from its config and its (first query
    head, group size); one rank (``heads[0]`` None) holds them all."""
    if heads[0] is None:
        return [(0, cfgs[0].n_kv_heads)]
    out = []
    for c, (q0, g) in zip(cfgs, heads):
        lo = q0 // g
        out.append((lo, lo) if c.n_heads == 0
                   else (lo, (q0 + c.n_heads - 1) // g + 1))
    return out


def q_ranges(cfgs) -> List[Tuple[int, int]]:
    """Each rank's query heads ``[q0, q1)``, in rank order."""
    out, a = [], 0
    for c in cfgs:
        out.append((a, a + c.n_heads))
        a += c.n_heads
    return out


def gather_heads(xs: Sequence[torch.Tensor], ranges, device) -> torch.Tensor:
    """Every head of the ranks' pieces ``xs[r]`` (B, S, hi - lo, D) once,
    in order, on ``device``: a head two ranks hold (a GQA group cut by
    their boundary) is taken from the first."""
    pieces, nxt = [], 0
    for x, (lo, hi) in zip(xs, ranges):
        if hi > nxt:
            pieces.append(x[:, :, nxt - lo:hi - lo].to(device))
            nxt = hi
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=2)


def _pairs(c: KVCache, k, v, kq=None):
    """(buffer, rows) pairs of one write: K and V, or an int8 cache's
    codes and scales (``kq``: ((K codes, scales), (V codes, scales)))."""
    if not c.quantized:
        return [(c.k, k), (c.v, v)]
    (kc, ks), (vc, vs) = kq
    return [(c.k, kc), (c.v, vc), (c.k_scale, ks), (c.v_scale, vs)]


# --------------------------------------------------------------------------- #
# Writes
# --------------------------------------------------------------------------- #


def write_token(c: KVCache, cur: torch.Tensor, act, pairs) -> None:
    """Write each slot's new row (``pairs``: (buffer, rows (B, 1, ...)))
    at its position ``cur`` (B,) if this piece owns the row, in place;
    ``act`` (B,) False rows write nothing."""
    n = c.k.shape[1]
    cur = cur.to(c.k.device).long()
    local = (cur % c.total if c.ring else cur) - c.row0
    own = (local >= 0) & (local < n)
    if act is not None:
        own = own & act.to(own.device)
    slot = torch.where(own, local, torch.zeros_like(local))
    for buf, val in pairs:
        masked_row_write(buf, slot, val[:, 0].to(buf.device), own)


def write_prompt(c: KVCache, site: int, pairs) -> None:
    """Write the prompt rows (``pairs``: (buffer with a layer axis, rows
    (B, S, ...))) into layer ``site`` of this piece: rows ``[0, S)`` it
    owns, or in a ring the last ``min(S, W)`` tokens at rows ``p % W``
    it owns."""
    s, n = pairs[0][1].shape[1], c.k.shape[2]
    if c.ring:
        take = min(s, c.total)
        pos = [p for p in range(s - take, s)
               if c.row0 <= p % c.total < c.row0 + n]
        if not pos:
            return
        dev = c.k.device
        rows = torch.tensor([p % c.total - c.row0 for p in pos], device=dev)
        src = torch.tensor(pos, device=dev)
        for dst, val in pairs:
            dst[site][:, rows] = val.to(dev)[:, src]
        return
    lo, hi = c.row0, min(c.row0 + n, s)
    if hi > lo:
        for dst, val in pairs:
            dst[site, :, :hi - lo] = val[:, lo:hi].to(dst.device)


def write_prompts(kvcs, site: int, ks, vs, ranges) -> None:
    """:func:`write_prompt` of every rank's piece: the ranks' K/V ``ks[r]``
    / ``vs[r]`` (B, S, KHr, D) of their KV heads ``ranges[r]``; an int8
    cache quantizes the whole row (sequence-sharded) or takes the shared
    scales (context-parallel)."""
    if isinstance(kvcs[0], KVShards):
        kqs = (list(zip(quantize_kv_shared(ks), quantize_kv_shared(vs)))
               if kvcs[0].quantized else [None] * len(ks))
        for kvc, k, v, kq in ranked(zip(kvcs, ks, vs, kqs)):
            for c in kvc:
                write_prompt(c, site, _pairs(c, k, v, kq))
        return
    dev = ks[0].device
    k, v = gather_heads(ks, ranges, dev), gather_heads(vs, ranges, dev)
    if kvcs[0].dims:  # each rank its dims of every head
        cuts = [(c.dim0, c.dim0 + c.k.shape[-1]) for c in kvcs]
        kd = [k[..., a:b] for a, b in cuts]
        vd = [v[..., a:b] for a, b in cuts]
        kqs = (list(zip(quantize_kv_shared(kd), quantize_kv_shared(vd)))
               if kvcs[0].quantized else [None] * len(kvcs))
        collective("all-to-all", kd[0].nbytes + vd[0].nbytes)
        for c, kk, vv, kq in ranked(zip(kvcs, kd, vd, kqs)):
            write_prompt(c, site, _pairs(c, kk, vv, kq))
        return
    kq = (quantize_kv(k), quantize_kv(v)) if kvcs[0].quantized else None
    s = k.shape[1]
    pairs = _pairs(kvcs[0], k, v, kq)
    owned = min(kvcs[0].k.shape[2], s)
    collective("all-to-all", sum(t.nbytes for _, t in pairs) * owned
               / max(s, 1))
    for c in ranked(kvcs):
        write_prompt(c, site, _pairs(c, k, v, kq))


# --------------------------------------------------------------------------- #
# Reads
# --------------------------------------------------------------------------- #


def _ring_positions(c: KVCache, cur: torch.Tensor) -> torch.Tensor:
    """The absolute position of each of a ring piece's rows at slot
    positions ``cur`` (B,): the largest p <= cur with p % W == its buffer
    row (-1e9 for a row not yet written, which only a window masks)."""
    w = c.total
    j = c.row0 + torch.arange(c.k.shape[1], device=cur.device)[None, :]
    pos = j + torch.div(cur.long()[:, None] - j, w, rounding_mode="floor") * w
    return torch.where(pos < 0, -1_000_000_000, pos)


def plain_partials(q, c: KVCache, cur, kv_len, window, segs):
    """The plain (o, m, l) of q (B, Sq, H, D) at positions ``cur + i``
    over one piece ``c``, over each uniform GQA segment of its heads
    (``segs``), side by side along the heads; an int8 piece dequantized
    to q's dtype first, as the plain read does."""
    kread, vread = c.k, c.v
    if c.quantized:
        kread = dequantize_kv(c.k, c.k_scale, q.dtype)
        vread = dequantize_kv(c.v, c.v_scale, q.dtype)
    ring = _ring_positions(c, cur.to(q.device)) if c.ring else None
    parts = [ref.attention_partials(
        q[:, :, qa:qb], kread[:, :, ka:kb].to(q.device),
        vread[:, :, ka:kb].to(q.device), q_offset=cur, window=window,
        kv_len=None if c.ring else kv_len, row0=c.row0, ring_offset=ring)
        for qa, qb, ka, kb in segs]
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat(x, dim=2) for x in zip(*parts))


def _kernel_partials(q, pieces, cur, window, head_start, group, mark: bool):
    """Every piece's :func:`ops.flash_decode_partials` of q (B, 1, H, D),
    its splits after the previous pieces' in one scratch on q's device."""
    b, _, h, d = q.shape
    n = [ops.partial_splits(b, c.k.shape[1], q.device)[0] for c in pieces]
    part = ops.Partials(b, h, sum(n), d, q.device)
    off = 0
    for c, k in (ranked(zip(pieces, n)) if mark else zip(pieces, n)):
        kw = dict(kv_len=cur + 1, q_offset=cur, out=part, window=window,
                  row0=c.row0, split0=off, head_start=head_start,
                  group=group)
        qq = q.to(c.k.device)
        if c.quantized:
            ops.flash_decode_int8_partials(qq, c.k, c.v, c.k_scale,
                                           c.v_scale, **kw)
        else:
            ops.flash_decode_partials(qq, c.k, c.v, **kw)
        off += k
    return part


def read(q, pieces, cur, kv_len, window, *, kernel: bool, segs, head_start,
         group, out_ranges, mark: bool) -> List[torch.Tensor]:
    """q (B, Sq, H, D) over the pieces of one split cache, merged in their
    order; the result's heads in pieces ``out_ranges`` (the heads each
    rank owns), in q's dtype.  ``kernel``: the partials and combine
    kernels (a decode over linear pieces); else the plain states.
    ``mark``: the pieces are the pod's ranks (each piece's work counted
    for its rank); else the caller's rank holds them all."""
    if kernel:
        part = _kernel_partials(q, pieces, cur, window, head_start, group,
                                mark)
        outs = ops.flash_decode_combine(part.acc, part.ml, dtype=q.dtype,
                                        head_ranges=out_ranges)
        n_states = part.n_total
    else:
        states = [plain_partials(q, c, cur, kv_len, window, segs)
                  for c in (ranked(pieces) if mark else pieces)]
        outs = [ref.merge_partials([tuple(x[:, :, h0:h1] for x in st)
                                    for st in states], q.dtype)
                for h0, h1 in ranked(out_ranges)]
        n_states = len(states)
    b, sq, _, d = q.shape
    h0, h1 = out_ranges[0]
    nbytes = b * sq * (h1 - h0) * n_states * (d + 2) * 4
    if mark and len(pieces) > 1:  # each owner gathers its heads' states
        collective("all-to-all", nbytes)
    elif not mark and (len(pieces) > 1 or pieces[0].k.shape[1]
                       < pieces[0].total):  # merged across the data axis
        collective("all-reduce", b * sq * (h1 - h0) * (d + 2) * 4)
    return outs


def attend(qkvs, cfgs, caches, curs, heads, *, attn_impl: str, window,
           actives=None, valid_lens=None) -> List[torch.Tensor]:
    """The write and the read of one layer's decode step (or, with
    ``valid_lens``, one prefill chunk) over split caches: ``qkvs[r]`` rank
    r's (q, k, v) in the head layout, ``caches[r]`` its piece (one layer).
    Returns each rank's attention output (B, Sq, Hr, D)."""
    sq = qkvs[0][0].shape[1]
    chunk = valid_lens is not None
    if chunk and (caches[0].ring or caches[0].quantized):
        raise ValueError(
            "chunked prefill requires a dense unquantized KV cache "
            "(ring/SWA and int8 caches fall back to one-shot prefill)")
    kernel = attn_impl == "kernel" and not chunk and not caches[0].ring
    if not isinstance(caches[0], KVShards) and caches[0].dims:
        return _attend_head_dim(qkvs, cfgs, caches, curs, heads, window,
                                actives, valid_lens)
    if isinstance(caches[0], KVShards):
        return _attend_context(qkvs, cfgs, caches, curs, heads, kernel,
                               window, actives, valid_lens)
    kr = kv_ranges(cfgs, heads)
    qr = q_ranges(cfgs)
    dev = qkvs[0][0].device
    q = torch.cat([x[0].to(dev) for x in qkvs], dim=2)
    k = gather_heads([x[1] for x in qkvs], kr, dev)
    v = gather_heads([x[2] for x in qkvs], kr, dev)
    c0 = caches[0]
    kq = (quantize_kv(k), quantize_kv(v)) if c0.quantized else None
    pairs = _pairs(c0, k, v, kq)
    if len(caches) > 1:
        collective("all-to-all", sum(t.nbytes for _, t in pairs))
        collective("all-gather", q.nbytes)
    cur = curs[0]
    for r, c in ranked(enumerate(caches)):
        p = _pairs(c, k, v, kq)
        if chunk:
            for buf, val in p:
                masked_span_write(buf, cur, val.to(buf.device),
                                  valid_lens[r], c.row0)
        else:
            write_token(c, curs[r], None if actives is None else actives[r],
                        p)
    kv_len = cur + (valid_lens[0] if chunk else 1)
    outs = read(q, caches, cur, kv_len, window, kernel=kernel,
                segs=[(0, q.shape[2], 0, k.shape[2])], head_start=0,
                group=0, out_ranges=qr, mark=True)
    return [o.to(x[0].device) for o, x in zip(outs, qkvs)]


def _attend_head_dim(qkvs, cfgs, caches, curs, heads, window, actives,
                     valid_lens):
    """:func:`attend` over head-dim pieces: rank r holds dims ``[d0, d1)``
    of every KV head.  The scores are sums over the dims, so each rank's
    partial scores (B, H, Sq, L) over its dims are summed across the
    ranks (an all-reduce) before the softmax, which every rank takes;
    then each rank applies the weights to its dims of V, and the owner of
    each head gathers its dims (an all-to-all).  No kernel serves it (the
    softmax needs the whole sum first): plain on every device, as the
    reference lowers it through XLA."""
    chunk = valid_lens is not None
    kr = kv_ranges(cfgs, heads)
    dev = qkvs[0][0].device
    q = torch.cat([x[0].to(dev) for x in qkvs], dim=2)
    k = gather_heads([x[1] for x in qkvs], kr, dev)
    v = gather_heads([x[2] for x in qkvs], kr, dev)
    cuts = [(c.dim0, c.dim0 + c.k.shape[-1]) for c in caches]
    ks = [k[..., a:b] for a, b in cuts]
    vs = [v[..., a:b] for a, b in cuts]
    kqs = [None] * len(caches)
    if caches[0].quantized:
        kqs = list(zip(quantize_kv_shared(ks), quantize_kv_shared(vs)))
    b, sq, h, d = q.shape
    if len(caches) > 1:
        collective("all-to-all", (ks[0].nbytes + vs[0].nbytes))
        collective("all-gather", q[..., cuts[0][0]:cuts[0][1]].nbytes)
    cur = curs[0]
    scores = []
    for r, (c, kk, vv, kq) in ranked(enumerate(zip(caches, ks, vs, kqs))):
        for buf, val in _pairs(c, kk, vv, kq):
            if chunk:
                masked_span_write(buf, cur, val.to(buf.device),
                                  valid_lens[r])
            else:
                write_token(c, curs[r], None if actives is None
                            else actives[r], [(buf, val)])
        kread = (dequantize_kv(c.k, c.k_scale, q.dtype) if c.quantized
                 else c.k).float()
        kh = kread.shape[2]
        qq = q[..., cuts[r][0]:cuts[r][1]].to(c.k.device).float()
        # query head j reads KV head j // G: group the heads, no copy of K
        scores.append(torch.einsum(
            "bqkgd,blkd->bkgql", qq.reshape(b, sq, kh, h // kh, -1),
            kread).reshape(b, h, sq, -1))
    total = scores[0]
    for part in scores[1:]:
        total = total + part.to(total.device)
    if len(scores) > 1:
        collective("all-reduce", total.nbytes)
    c0 = caches[0]
    ring = _ring_positions(c0, cur.to(dev)) if c0.ring else None
    kv_len = None if c0.ring else cur + (valid_lens[0] if chunk else 1)
    mask = ref.visible(sq, c0.k.shape[1], q_offset=cur, kv_len=kv_len,
                       window=window, ring_offset=ring, device=dev)
    _, p = ref.softmax_state(total / math.sqrt(d), mask)
    p = p / p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    outs = []
    for c in ranked(caches):
        vread = (dequantize_kv(c.v, c.v_scale, q.dtype) if c.quantized
                 else c.v).float()
        kh = vread.shape[2]
        outs.append(torch.einsum(
            "bkgql,blkd->bqkgd",
            p.to(c.v.device).reshape(b, kh, h // kh, sq, -1),
            vread).reshape(b, sq, h, -1).to(dev))
    out = torch.cat(outs, dim=-1).to(q.dtype)
    qr = q_ranges(cfgs)
    if len(caches) > 1:
        collective("all-to-all", out[:, :, qr[0][0]:qr[0][1]].nbytes)
    return [out[:, :, q0:q1].to(x[0].device) for (q0, q1), x in zip(qr,
                                                                      qkvs)]


def _attend_context(qkvs, cfgs, caches, curs, heads, kernel, window,
                    actives, valid_lens):
    """:func:`attend` over context-parallel pieces (each rank's KVShards)."""
    chunk = valid_lens is not None
    kqs = [None] * len(qkvs)
    if caches[0].quantized:
        kqs = list(zip(quantize_kv_shared([x[1] for x in qkvs]),
                       quantize_kv_shared([x[2] for x in qkvs])))
    group = heads[0][1] if heads[0] is not None else 0
    outs = []
    for r, ((q, k, v), cfg, shards, kq) in ranked(enumerate(
            zip(qkvs, cfgs, caches, kqs))):
        cur = curs[r]
        for c in shards:
            p = _pairs(c, k, v, kq)
            if chunk:
                for buf, val in p:
                    masked_span_write(buf, cur, val.to(buf.device),
                                      valid_lens[r], c.row0)
            else:
                write_token(c, cur, None if actives is None else actives[r],
                            p)
        if cfg.n_heads == 0:
            outs.append(torch.empty_like(q))
            continue
        q0 = heads[r][0] if heads[r] is not None else 0
        segs = (ops.head_segments(q0, cfg.n_heads, group)
                if group else [(0, cfg.n_heads, 0, cfg.n_kv_heads)])
        kv_len = cur + (valid_lens[r] if chunk else 1)
        outs.append(read(q, list(shards), cur, kv_len, window, kernel=kernel,
                         segs=segs, head_start=q0, group=group,
                         out_ranges=[(0, cfg.n_heads)], mark=False)[0])
    return outs


def attention_decode(ps, cfgs, xs, cos_sins, caches, curs, *, attn_impl: str,
                     actives=None, valid_lens=None, heads=None
                     ) -> List[torch.Tensor]:
    """``layers.attention_decode`` over split caches (one layer's pieces,
    ``caches[r]`` rank r's): proj -> rope on each rank, then
    :func:`attend`, then each rank's ``wo`` partial (B, Sq, d_model)."""
    heads = list(heads) if heads is not None else [None] * len(ps)
    qkvs = [project_qkv(p, c, x, cs)
            for p, c, x, cs in ranked(zip(ps, cfgs, xs, cos_sins))]
    window = cfgs[0].swa_window if cfgs[0].attention_type == "swa" else None
    outs = attend(qkvs, cfgs, caches, curs, heads, attn_impl=attn_impl,
                  window=window, actives=actives, valid_lens=valid_lens)
    b, s = xs[0].shape[:2]
    return [o.reshape(b, s, c.n_heads * c.head_dim) @ p["wo"]
            for o, c, p in ranked(zip(outs, cfgs, ps))]


# --------------------------------------------------------------------------- #
# The audio family's cross-attention K/V
# --------------------------------------------------------------------------- #


def write_cross(caches, site: int, ks, vs, ranges) -> None:
    """The encoder K/V of the ranks' query heads ``ranges[r]``, ``ks[r]``
    / ``vs[r]`` (B, Se, Hr, D), into layer ``site`` of each rank's split
    ``cross_kv`` piece: its frames (rows ``[row0, row0 + F_r)``) or its
    dims of every head, after one all-to-all that brings each rank its
    piece."""
    dev = ks[0].device
    k, v = gather_heads(ks, ranges, dev), gather_heads(vs, ranges, dev)
    c0 = caches[0]
    if c0.dims:
        piece = k[..., c0.dim0:c0.dim0 + c0.k.shape[-1]]
    else:
        piece = k[:, c0.row0:c0.row0 + c0.k.shape[2]]
    if len(caches) > 1:
        collective("all-to-all", 2 * piece.nbytes)
    for c in ranked(caches):
        if c.dims:
            cut = (Ellipsis, slice(c.dim0, c.dim0 + c.k.shape[-1]))
        else:
            cut = (slice(None), slice(c.row0, c.row0 + c.k.shape[2]))
        c.k[site].copy_(k[cut])
        c.v[site].copy_(v[cut])


def cross_attention(ps, cfgs, xs, caches) -> List[torch.Tensor]:
    """``layers.cross_attention_block`` over a split ``cross_kv`` (one
    layer's pieces, ``caches[r]`` rank r's): each rank projects its query
    heads, the heads are gathered on every rank (an all-gather), the
    attention over all frames is taken from the pieces (:func:`read`'s
    plain states merged by each head's owner, or :func:`_cross_head_dim`),
    and each rank's heads go through its
    ``wo`` rows: the rank's partial (B, Sq, d_model), which the model
    sums.  No mask: every frame is visible."""
    b, s, _ = xs[0].shape
    hd = cfgs[0].head_dim
    qs = [(x @ p["wq"]).reshape(b, s, c.n_heads, hd)
          for p, c, x in ranked(zip(ps, cfgs, xs))]
    dev = qs[0].device
    q = torch.cat([t.to(dev) for t in qs], dim=2)
    qr = q_ranges(cfgs)
    if len(caches) > 1:
        collective("all-gather", q.nbytes)
    if caches[0].dims:
        outs = _cross_head_dim(q, caches, qr)
    else:  # every frame visible: a query past the last one
        h = q.shape[2]
        outs = read(q, caches, caches[0].total, None, None, kernel=False,
                    segs=[(0, h, 0, h)], head_start=0, group=0,
                    out_ranges=qr, mark=True)
    return [o.to(x.device).reshape(b, s, c.n_heads * hd) @ p["wo"]
            for o, c, p, x in ranked(zip(outs, cfgs, ps, xs))]


def _cross_head_dim(q, caches, qr) -> List[torch.Tensor]:
    """Every head of q over head-dim pieces: each rank's partial scores
    over its dims, summed across the ranks (an all-reduce) before the
    softmax, then each rank's dims of the weighted V, gathered by each
    head's owner (an all-to-all); each rank's heads ``qr[r]``."""
    b, sq, h, d = q.shape
    scores = []
    for c in ranked(caches):
        qq = q[..., c.dim0:c.dim0 + c.k.shape[-1]].to(c.k.device).float()
        scores.append(torch.einsum("bqhd,bkhd->bhqk", qq, c.k.float()))
    total = scores[0]
    for part in scores[1:]:
        total = total + part.to(total.device)
    if len(scores) > 1:
        collective("all-reduce", total.nbytes)
    p = torch.softmax(total / math.sqrt(d), dim=-1)
    outs = [torch.einsum("bhqk,bkhd->bqhd", p.to(c.v.device), c.v.float())
            .to(q.device) for c in ranked(caches)]
    out = torch.cat(outs, dim=-1).to(q.dtype)
    if len(caches) > 1:
        collective("all-to-all", out[:, :, qr[0][0]:qr[0][1]].nbytes)
    return [out[:, :, a:z] for a, z in qr]
