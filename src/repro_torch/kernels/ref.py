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


def flash_decode_split(q, k, v, *, kv_len, q_offset,
                       window: Optional[int] = None, n_split: int,
                       s_len: int, k_scale=None,
                       v_scale=None) -> torch.Tensor:
    """A plain model of the decode kernel's arithmetic (not a wrapper's
    plain version): the key axis cut into ``n_split`` splits of ``s_len``
    rows, each split's partial state (m_s, the max of its visible scores,
    -1e30 when it sees none; l_s = sum exp(s - m_s); acc_s = sum exp(s -
    m_s) v) in fp32, merged in the order of s as the combine pass does:
    ``out = sum acc_s e_s / max(sum l_s e_s, 1e-30)``, ``e_s = exp(m_s -
    max m)``.  With ``k_scale``/``v_scale`` the cache is int8 and is
    dequantized in fp32 first.  Same arguments and result as
    :func:`flash_decode`."""
    if k_scale is not None:
        k, v = dequantize(k, k_scale), dequantize(v, v_scale)
    b, _, h, d = q.shape
    L, kh = k.shape[1], k.shape[2]
    k = k.float().repeat_interleave(h // kh, dim=2)
    v = v.float().repeat_interleave(h // kh, dim=2)
    s = torch.einsum("bhd,blhd->bhl", q[:, 0].float(), k) / math.sqrt(d)
    row = torch.arange(L, device=q.device)[None, None, :]
    q_pos = torch.as_tensor(q_offset, device=q.device).reshape(-1, 1, 1)
    mask = (row < torch.as_tensor(kv_len, device=q.device).reshape(-1, 1, 1)
            ) & (row <= q_pos)
    if window is not None:
        mask &= row > q_pos - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    parts = []
    for i in range(n_split):
        a, e = i * s_len, min((i + 1) * s_len, L)
        m_s = s[..., a:e].max(dim=-1).values
        p = torch.where(mask[..., a:e], torch.exp(s[..., a:e] - m_s[..., None]),
                        torch.zeros_like(s[..., a:e]))
        parts.append((m_s, p.sum(-1),
                      torch.einsum("bhl,blhd->bhd", p, v[:, a:e])))
    top = torch.stack([m_s for m_s, _, _ in parts]).max(dim=0).values
    l = torch.zeros_like(top)
    o = torch.zeros((b, h, d), dtype=torch.float32, device=q.device)
    for m_s, l_s, acc_s in parts:
        e_s = torch.exp(m_s - top)
        l = l + l_s * e_s
        o = o + acc_s * e_s[..., None]
    return (o / l.clamp(min=1e-30)[..., None])[:, None].to(q.dtype)


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
