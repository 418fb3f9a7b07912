"""Plain PyTorch versions of the kernels (their oracles).

Attention: the arithmetic of ``repro.kernels.ref`` and
``repro.models.layers.sdpa``: scores in fp32, masked entries set to -1e30
before the softmax, rows with no unmasked key give 0, and the result is
cast back to the query's dtype.  The int8 decode dequantizes its K/V in
fp32 first, as ``repro.kernels.decode_attention._decode_kernel_int8``
does.  SSD scan: the arithmetic of the Pallas
kernel ``repro.kernels.ssm_scan._ssd_kernel``, in fp32.
On a CPU tensor the kernel wrappers in :mod:`repro_torch.kernels.ops` run
these; on the card ``chip_smoke.py`` holds each kernel against them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def reference_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, KH, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset=0,
    kv_len=None,
    ring_offset=None,
) -> torch.Tensor:
    """GQA attention with the reference masks.

    ``q_offset`` is the absolute position of ``q[:, 0]`` and ``kv_len`` the
    number of valid cache rows; each is an int or a (B,) tensor (decode slots
    sit at different depths).  ``window`` masks keys older than
    ``q_pos - window + 1``.  ``ring_offset``, for a ring buffer, holds the
    absolute position of each buffer row, (Skv,) or (B, Skv); the causal
    and window masks then read it in place of the row index (``kv_len``
    still masks by row index, as in the reference)."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    rep = h // kh
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    dev = q.device
    if isinstance(q_offset, torch.Tensor):
        q_offset = q_offset.to(dev).reshape(-1, 1)
    q_pos = (torch.arange(sq, device=dev)[None, :] + q_offset)[:, None, :, None]
    row = torch.arange(skv, device=dev)[None, None, None, :]
    k_pos = row
    if ring_offset is not None:
        k_pos = ring_offset.to(dev).reshape(-1, skv)[:, None, None, :]
    mask = torch.ones_like(s, dtype=torch.bool)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > (q_pos - window)
    if kv_len is not None:
        if isinstance(kv_len, torch.Tensor):
            kv_len = kv_len.to(dev).reshape(-1, 1, 1, 1)
        mask &= row < kv_len
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(dim=-1, keepdim=True), p, torch.zeros_like(p))
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Plain version of the prefill kernel (no ``kv_len`` mask)."""
    return reference_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)


def flash_decode(q, k, v, *, kv_len, q_offset,
                 window: Optional[int] = None) -> torch.Tensor:
    """Plain version of the decode kernel: q (B, 1, H, D) over the slot
    cache k/v (B, L, KH, D) with per-slot ``kv_len`` and ``q_offset``."""
    return reference_attention(q, k, v, causal=True, window=window,
                               q_offset=q_offset, kv_len=kv_len)


def dequantize(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 codes (..., L, KH, D) times per-token scales (..., L), in fp32."""
    return codes.float() * scale.float()[..., None, None]


def flash_decode_int8(q, k, v, k_scale, v_scale, *, kv_len, q_offset,
                      window: Optional[int] = None) -> torch.Tensor:
    """Plain version of the int8 decode kernel: :func:`flash_decode` over
    K/V dequantized in fp32 (``code * scale``), the result in q's dtype."""
    return flash_decode(q, dequantize(k, k_scale), dequantize(v, v_scale),
                        kv_len=kv_len, q_offset=q_offset, window=window)


def attention_partials(q, k, v, *, q_offset, kv_len=None,
                       window: Optional[int] = None, row0: int = 0,
                       ring_offset=None):
    """The partial softmax state of q (B, Sq, H, D) over some rows of a
    cache, k/v (B, R, KH, D) holding buffer rows ``[row0, row0 + R)``:
    row i sits at position ``row0 + i`` (or ``ring_offset`` (B, R), a
    ring's absolute positions), and the masks of
    :func:`reference_attention` read those positions (``kv_len`` the
    global row).  Returns ``(o, m, l)`` in fp32: ``m`` (B, Sq, H) the
    largest visible score (``NEG_INF`` where none is visible), ``l`` the
    sum of ``exp(s - m)`` over the visible rows (0 where none) and ``o``
    (B, Sq, H, D) that sum's weights times V, unnormalised.
    :func:`combine_partials` merges the states of several row ranges."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    rep = h // kh if kh else 1
    k = k.float().repeat_interleave(rep, dim=2)
    v = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) / math.sqrt(d)
    mask = visible(sq, skv, q_offset=q_offset, kv_len=kv_len, window=window,
                   row0=row0, ring_offset=ring_offset, device=q.device)
    m, p = softmax_state(s, mask)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return o, m.transpose(1, 2), p.sum(dim=-1).transpose(1, 2)


def visible(sq: int, skv: int, *, q_offset, kv_len=None,
            window: Optional[int] = None, row0: int = 0, ring_offset=None,
            device=None) -> torch.Tensor:
    """The mask (B or 1, 1, Sq, Skv) of :func:`attention_partials`: query
    i at position ``q_offset + i`` sees row j of a piece holding rows
    ``[row0, row0 + Skv)`` (position ``row0 + j``, or ``ring_offset``'s)
    within the causal, window and ``kv_len`` masks."""
    q_pos = (torch.arange(sq, device=device)[None, :]
             + torch.as_tensor(q_offset, device=device).reshape(-1, 1)
             )[:, None, :, None]
    row = row0 + torch.arange(skv, device=device)[None, None, None, :]
    k_pos = row if ring_offset is None else ring_offset.to(device).reshape(
        -1, skv)[:, None, None, :]
    mask = k_pos <= q_pos
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    if kv_len is not None:
        mask = mask & (row < torch.as_tensor(kv_len, device=device)
                       .reshape(-1, 1, 1, 1))
    return mask


def softmax_state(s: torch.Tensor, mask: torch.Tensor):
    """The fp32 scores ``s`` (..., Skv) under ``mask``: (m, the largest
    visible score, ``NEG_INF`` where none is visible; p = exp(s - m) at
    the visible keys, 0 elsewhere)."""
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1) if s.shape[-1] else torch.full(s.shape[:-1], NEG_INF,
                                                      device=s.device)
    return m, torch.where(mask, torch.exp(s - m[..., None]),
                          torch.zeros_like(s))


def combine_partials(acc: torch.Tensor, ml: torch.Tensor) -> torch.Tensor:
    """Merge partial softmax states along their split axis, in its order,
    as the decode kernel's combine pass does: ``acc`` (..., N, D) and
    ``ml`` (..., N, 2) the N states' (o) and (m, l).  ``out = sum acc_s e_s
    / max(sum l_s e_s, 1e-30)``, ``e_s = exp(m_s - max m)`` for a state that
    saw a key and 0 for one that saw none (``l_s = 0``: an empty split, a
    rank holding none of the visible rows), so that no such state makes a
    NaN, whatever its ``m``; where no state saw a key the result is 0.
    Returns (..., D) in fp32."""
    m, l = ml[..., 0], ml[..., 1]
    seen = l > 0
    top = torch.where(seen, m, torch.full_like(m, -math.inf)).amax(
        dim=-1, keepdim=True)
    e = torch.where(seen, torch.exp(m - top), torch.zeros_like(m))
    den = (l * e).sum(dim=-1).clamp(min=1e-30)
    return (acc * e[..., None]).sum(dim=-2) / den[..., None]


def merge_partials(parts, dtype) -> torch.Tensor:
    """:func:`combine_partials` of the :func:`attention_partials` states
    ``parts`` [(o, m, l)] of one query batch over several row ranges, in
    order, on the first state's device; the result in ``dtype``."""
    dev = parts[0][0].device
    acc = torch.stack([o.to(dev) for o, _, _ in parts], dim=-2)
    ml = torch.stack([torch.stack([m.to(dev), l.to(dev)], dim=-1)
                      for _, m, l in parts], dim=-2)
    return combine_partials(acc, ml).to(dtype)


def flash_decode_partials(q, k, v, *, kv_len, q_offset,
                          window: Optional[int] = None, row0: int = 0,
                          n_split: int = 1, s_len: Optional[int] = None,
                          k_scale=None, v_scale=None):
    """Plain version of the decode kernel's partials mode: q (B, 1, H, D)
    over k/v (B, R, KH, D), rows ``[row0, row0 + R)`` of the buffer, cut
    into ``n_split`` splits of ``s_len`` rows (default one split of all);
    each split's :func:`attention_partials` state.  With
    ``k_scale``/``v_scale`` (B, R) the cache is int8, dequantized in fp32
    first.  Returns ``acc`` (B, H, n_split, D) and ``ml`` (B, H, n_split,
    2), fp32."""
    if k_scale is not None:
        k, v = dequantize(k, k_scale), dequantize(v, v_scale)
    rows = k.shape[1]
    s_len = s_len or max(rows, 1)
    accs, mls = [], []
    for i in range(n_split):
        a, e = i * s_len, min((i + 1) * s_len, rows)
        o, m, l = attention_partials(q, k[:, a:e], v[:, a:e], kv_len=kv_len,
                                     q_offset=q_offset, window=window,
                                     row0=row0 + a)
        accs.append(o[:, 0])
        mls.append(torch.stack([m[:, 0], l[:, 0]], dim=-1))
    return torch.stack(accs, dim=2), torch.stack(mls, dim=2)


def flash_decode_int8_partials(q, k, v, k_scale, v_scale, *, kv_len,
                               q_offset, window: Optional[int] = None,
                               row0: int = 0, n_split: int = 1,
                               s_len: Optional[int] = None):
    """Plain version of the int8 decode kernel's partials mode:
    :func:`flash_decode_partials` over int8 codes and their (B, R)
    scales."""
    return flash_decode_partials(q, k, v, kv_len=kv_len, q_offset=q_offset,
                                 window=window, row0=row0, n_split=n_split,
                                 s_len=s_len, k_scale=k_scale,
                                 v_scale=v_scale)


def flash_decode_combine(acc, ml, *, dtype=torch.float32) -> torch.Tensor:
    """Plain version of the combine pass: :func:`combine_partials` of
    ``acc`` (B, H, N, D) and ``ml`` (B, H, N, 2), the output (B, 1, H, D)
    in ``dtype``."""
    return combine_partials(acc, ml)[:, None].to(dtype)


def flash_decode_split(q, k, v, *, kv_len, q_offset,
                       window: Optional[int] = None, n_split: int,
                       s_len: int, k_scale=None,
                       v_scale=None) -> torch.Tensor:
    """A plain model of the decode kernel's arithmetic (not a wrapper's
    plain version): the key axis cut into ``n_split`` splits of ``s_len``
    rows, each split's partial state (:func:`flash_decode_partials`: m_s, the
    max of its visible scores, -1e30 when it sees none; l_s = sum exp(s -
    m_s); acc_s = sum exp(s - m_s) v) in fp32, merged in the order of s as
    the combine pass does (:func:`combine_partials`).  With
    ``k_scale``/``v_scale`` the cache is int8 and is dequantized in fp32
    first.  Same arguments and result as :func:`flash_decode`."""
    acc, ml = flash_decode_partials(q, k, v, kv_len=kv_len,
                                    q_offset=q_offset, window=window,
                                    n_split=n_split, s_len=s_len,
                                    k_scale=k_scale, v_scale=v_scale)
    return combine_partials(acc, ml)[:, None].to(q.dtype)


def over_segments(fn, q, k, v, segments, *scales, **kw) -> torch.Tensor:
    """``fn`` over each uniform GQA segment ``(q_lo, q_hi, kv_lo, kv_hi)``
    of a tensor-parallel rank's heads (``kernels.ops.head_segments``):
    q's heads ``[q_lo, q_hi)`` over k's and v's ``[kv_lo, kv_hi)`` (with
    ``scales``, an int8 cache's (B, L) scales, passed whole), the outputs
    side by side along the heads.  No segments (a rank with no heads)
    give an empty output of q's shape."""
    if not segments:
        return torch.empty_like(q)
    outs = [fn(q[:, :, a:b], k[:, :, c:d], v[:, :, c:d], *scales, **kw)
            for a, b, c, d in segments]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)


def _whole(q, k):
    return [(0, q.shape[2], 0, k.shape[2])] if q.shape[2] else []


def flash_decode_sharded(qs, ks, vs, *, kv_len, q_offset,
                         window: Optional[int] = None, segments=None):
    """Plain version of the sharded decode: :func:`flash_decode` on each
    rank's shard of whole heads (q (B,1,Hr,D), k/v (B,L,KHr,D)), over
    each of its uniform GQA ``segments[r]`` (default: one of the whole
    shard); returns the per-rank outputs."""
    segments = segments or [_whole(q, k) for q, k in zip(qs, ks)]
    return [over_segments(flash_decode, q, k, v, sg, kv_len=kv_len,
                          q_offset=q_offset, window=window)
            for q, k, v, sg in zip(qs, ks, vs, segments)]


def flash_decode_int8_sharded(qs, ks, vs, k_scales, v_scales, *, kv_len,
                              q_offset, window: Optional[int] = None,
                              segments=None):
    """Plain version of the sharded int8 decode: :func:`flash_decode_int8`
    on each rank's int8 KV heads and its copy of the shared scales, over
    its uniform GQA ``segments[r]`` as :func:`flash_decode_sharded`;
    returns the per-rank outputs."""
    segments = segments or [_whole(q, k) for q, k in zip(qs, ks)]
    return [over_segments(flash_decode_int8, q, k, v, sg, ksc, vsc,
                          kv_len=kv_len, q_offset=q_offset, window=window)
            for q, k, v, ksc, vsc, sg in zip(qs, ks, vs, k_scales, v_scales,
                                             segments)]


def ssd_scan(x: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, *, chunk: int):
    """Plain version of the SSD-scan kernel: x (B,S,H,P) already multiplied
    by dt, a (B,S,H) fp32 log decay, Bm/Cm (B,S,H,N), ``S % chunk == 0``.

    Per (batch, head), chunk after chunk, with the (P, N) state carried in
    fp32 from zero: ``y = (C B^T o L) x + exp(a_cum) C h_in^T`` and
    ``h_out = exp(a_cum[-1]) h_in + (x o decay)^T B``, where ``a_cum`` is the
    chunk's running sum of ``a`` and ``L[t, s] = exp(a_cum[t] - a_cum[s])``
    for ``s <= t``, else 0.  ``a_cum`` is summed in fp64 and rounded to fp32
    (the kernel does the same), so that it does not depend on the order of
    the sum: at |a_cum| ~ 1e3 an fp32 sum in another order moves
    ``a_cum[t] - a_cum[s]`` by ~1e-4.  Returns (y (B,S,H,P), final state
    (B,H,P,N)), both in x's dtype."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    if s % chunk:
        raise ValueError(f"ssd_scan: S={s} is not a multiple of chunk={chunk}")
    nc = s // chunk
    xc = x.float().reshape(b, nc, chunk, h, p)
    bc = Bm.float().reshape(b, nc, chunk, h, n)
    cc = Cm.float().reshape(b, nc, chunk, h, n)
    a_cum = torch.cumsum(a.double().reshape(b, nc, chunk, h), dim=2).float()
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))[None, :, :, None]
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for z in range(nc):
        ac = a_cum[:, z]  # (B, c, H)
        seg = ac[:, :, None, :] - ac[:, None, :, :]  # (B, t, s, H)
        L = torch.where(tri, torch.exp(torch.where(tri, seg, 0.0)), 0.0)
        scores = torch.einsum("bthn,bshn->btsh", cc[:, z], bc[:, z]) * L
        y = torch.einsum("btsh,bshp->bthp", scores, xc[:, z])
        y = y + torch.exp(ac)[..., None] * torch.einsum(
            "bthn,bhpn->bthp", cc[:, z], state)
        decay = torch.exp(ac[:, -1:] - ac)  # (B, c, H)
        state = state * torch.exp(ac[:, -1])[..., None, None] + torch.einsum(
            "bshp,bshn->bhpn", xc[:, z] * decay[..., None], bc[:, z])
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(b, s, h, p)
    return y.to(x.dtype), state.to(x.dtype)


def ssd_scan_passes(x: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
                    Cm: torch.Tensor, *, chunk: int):
    """A plain model of the bf16 SSD kernel's three passes (not a wrapper's
    plain version), in fp32: (1) every chunk's end state from zero, ``s_z =
    (x o decay)^T B``, and its end decay ``e_z = exp(a_cum[-1])``, all
    chunks at once; (2) the carry, in order over the chunks only, ``h_0 =
    0``, ``h_z = e_{z-1} h_{z-1} + s_{z-1}``, the last one the final state;
    (3) every chunk's outputs at once, ``y = (C B^T o L) x + exp(a_cum) C
    h_z^T``.  ``a_cum`` is summed in fp64 and rounded to fp32, as in
    :func:`ssd_scan`.  Same arguments and result as :func:`ssd_scan`."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    if s % chunk:
        raise ValueError(f"ssd_scan: S={s} is not a multiple of chunk={chunk}")
    nc = s // chunk
    xc = x.float().reshape(b, nc, chunk, h, p)
    bc = Bm.float().reshape(b, nc, chunk, h, n)
    cc = Cm.float().reshape(b, nc, chunk, h, n)
    a_cum = torch.cumsum(a.double().reshape(b, nc, chunk, h), dim=2).float()
    # (1) chunk states from zero
    decay = torch.exp(a_cum[:, :, -1:] - a_cum)  # (B, nc, c, H)
    states = torch.einsum("bzshp,bzshn->bzhpn", xc * decay[..., None], bc)
    ends = torch.exp(a_cum[:, :, -1])  # (B, nc, H)
    # (2) the carry
    h_z = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    starts = []
    for z in range(nc):
        starts.append(h_z)
        h_z = h_z * ends[:, z, :, None, None] + states[:, z]
    h_in = torch.stack(starts, dim=1)  # (B, nc, H, P, N)
    # (3) outputs
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))[None, None, :, :, None]
    seg = a_cum[:, :, :, None, :] - a_cum[:, :, None, :, :]  # (B, nc, t, s, H)
    L = torch.where(tri, torch.exp(torch.where(tri, seg, 0.0)), 0.0)
    scores = torch.einsum("bzthn,bzshn->bztsh", cc, bc) * L
    y = torch.einsum("bztsh,bzshp->bzthp", scores, xc) + torch.exp(
        a_cum)[..., None] * torch.einsum("bzthn,bzhpn->bzthp", cc, h_in)
    return y.reshape(b, s, h, p).to(x.dtype), h_z.to(x.dtype)
