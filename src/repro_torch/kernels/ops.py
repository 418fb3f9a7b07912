"""Kernel wrappers: the hand-written CUDA kernels with their dispatch.

A wrapper given CPU tensors runs the kernel's plain PyTorch version
(:mod:`repro_torch.kernels.ref`).  Given CUDA tensors it checks them,
launches the kernel on the tensors' device and that device's current
stream, and adds one to its ``launches`` count, or raises: there is no
fallback from the kernel to the plain version.  The kernels have no
backward, as the reference's Pallas kernels have no ``custom_vjp``: a
wrapper raises ``NotImplementedError`` when autograd is on and a tensor
it is given requires grad, on either device (:func:`refuse_autograd`), so
a loss never trains through a kernel with silently zero gradients.  The
kernels are built from ``repro_torch/csrc`` at first use
(:mod:`repro_torch.kernels.build`).

Costs.  Each wrapper is also a ``torch.library`` custom op
(``torch.ops.repro_torch.<name>``) with a shape-only flop formula
registered with ``torch.utils.flop_counter``.  While a
``TorchDispatchMode`` is active (``FlopCounterMode``, the dry run's byte
counter), a wrapper calls its op: a counter then sees the kernel as one
op with its formula's flops and its operands' bytes, and not the plain
version's ops on the CPU nor nothing on the card, so the CPU, the card
and the meta device count the same work.  Under such a mode a wrapper
also takes ``meta`` tensors (the dry run), whose op only shapes its
outputs; outside one it refuses them, as any device but the CPU and the
card.  Outside a mode a wrapper launches directly.  The formulas count every key a mask may
leave visible, as a shape-only count must: the prefill's causal and
window pairs, the decode's buffer rows (up to the window), and for the
SSD scan each chunk's full c x c products and its state terms.
"""
from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build, ref
from repro_torch.ranks import ranked

#: head dims both attention kernels are built for (112: zamba2-7b)
HEAD_DIMS = (32, 64, 112, 128)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: most query heads per kv head the decode kernel is built for
MAX_GROUP = 16
#: keys per tile of the decode kernel (one per lane)
DECODE_TILE = 32
#: most key splits per slot: the fp32 partials, B*H*n_split*(D+2)*4 bytes,
#: stay small beside the cache (16 splits at decode_32k: 12.8 MB)
MAX_SPLITS = 16
#: fewest tiles per split: a shorter split does not pay for the combine pass
MIN_SPLIT_TILES = 4
#: blocks per SM the split aims for at one KV head
SPLIT_BLOCKS_PER_SM = 8


def decode_splits(b: int, L: int, n_sm: int):
    """How the decode kernel cuts the key axis: ``(n_split, s_len)``, split
    s covering rows ``[s * s_len, (s + 1) * s_len)``.  ``s_len`` is a
    multiple of :data:`DECODE_TILE`, the splits cover ``[0, L)`` once and
    none lies wholly past L.  Enough splits that ``b * n_split`` reaches
    ``SPLIT_BLOCKS_PER_SM`` blocks per SM even at one KV head, at most
    :data:`MAX_SPLITS`, each of at least :data:`MIN_SPLIT_TILES` tiles.

    A function of the slots, the buffer length and the SM count only:
    never of the heads, so each rank of a TP pod cuts its keys as the
    single-device kernel does (their outputs agree bit for bit), and never
    of the per-slot lengths, which live on the device."""
    tiles = -(-L // DECODE_TILE)
    want = -(-SPLIT_BLOCKS_PER_SM * n_sm // b)
    n = max(1, min(want, MAX_SPLITS, tiles // MIN_SPLIT_TILES))
    per = -(-tiles // n)
    return -(-tiles // per), per * DECODE_TILE


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_plan(b: int, L: int, device: torch.device):
    """:func:`decode_splits` on ``device``'s SM count."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    return decode_splits(b, L, _sm_count(index))


def _split_scratch(q: torch.Tensor, L: int, h: Optional[int] = None):
    """(n_split, s_len) of a decode launch of ``h`` of q's heads (default
    all) over L rows, and its fp32 partials (None when one split writes
    the output).  The caller holds the partials until the launch is
    queued."""
    b, _, hq, d = q.shape
    h = hq if h is None else h
    n_split, s_len = decode_plan(b, L, q.device)
    part = (None if n_split == 1 else
            torch.empty((b * h * n_split * (d + 2),), dtype=torch.float32,
                        device=q.device))
    return n_split, s_len, part


def refuse_autograd(name: str, *tensors) -> None:
    """Raise ``NotImplementedError`` when ``torch.is_grad_enabled()`` and
    any of ``tensors`` requires grad: the kernel writes its output through
    a raw pointer, so the output would carry no ``grad_fn``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the kernel has no backward (the reference's Pallas "
            "kernels have no custom_vjp either); call it under "
            "torch.no_grad(), or train through the plain path "
            "(attn_impl='torch')")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           kv_dtype: Optional[torch.dtype] = None, segments=None):
    """CUDA tensors the attention kernels take: k and v of ``kv_dtype``
    (by default q's dtype); q's heads over k's in uniform GQA
    ``segments`` (default: one segment of them all)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: tensors must be on cuda or cpu, got {q.device}")
    for t in (k, v):
        if t.device != q.device or t.dtype != (kv_dtype or q.dtype):
            raise ValueError(f"{name}: q, k, v must share a device, and k "
                             f"and v must be {kv_dtype or q.dtype}")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: dtype {q.dtype} not supported "
                         f"(float32 or bfloat16)")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: want q (B,S,H,D) and k == v (B,S,KH,D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    segments = segments or [(0, h, 0, k.shape[2])]
    if k.shape[0] != b or k.shape[3] != d or any(
            (qb - qa) % (kb - ka) for qa, qb, ka, kb in segments):
        raise ValueError(f"{name}: shapes {tuple(q.shape)} and "
                         f"{tuple(k.shape)} do not match for GQA")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name}: q, k, v must be contiguous")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"{name}: k and v must start on a 16-byte boundary "
                         "(the kernel reads them in 16-byte vectors)")


def _check_decode(name: str, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, kv_dtype: Optional[torch.dtype] = None,
                  segments=None):
    """:func:`_check`, and one query token per slot with at most
    ``MAX_GROUP`` query heads per KV head."""
    _check(name, q, k, v, kv_dtype, segments)
    if q.shape[1] != 1:
        raise ValueError(f"{name}: one query token per slot, got "
                         f"{q.shape[1]}")
    for qa, qb, ka, kb in segments or [(0, q.shape[2], 0, k.shape[2])]:
        if (qb - qa) // (kb - ka) > MAX_GROUP:
            raise ValueError(f"{name}: {(qb - qa) // (kb - ka)} query heads "
                             f"per kv head exceed {MAX_GROUP}")


def _slot_vector(x, b: int, device: torch.device) -> torch.Tensor:
    """Per-slot int32 (B,) vector on ``device`` from a tensor or an int."""
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.int32 or x.device != device:
            x = x.to(device=device, dtype=torch.int32)
        return x.expand(b).contiguous()
    return torch.full((b,), int(x), dtype=torch.int32, device=device)


def _launch(name: str, device: torch.device, fn, *args) -> None:
    """Call the launch function ``fn`` with ``device`` current: the CUDA
    runtime launches on the current device, which must be the one that
    holds the tensors and the stream."""
    with torch.cuda.device(device):
        err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def head_segments(q0: int, h: int, group: int,
                  kh: Optional[int] = None) -> List[Tuple[int, int, int, int]]:
    """A tensor-parallel rank's query heads as uniform GQA segments: the
    rank holds ``h`` query heads from global head ``q0`` on and the KV
    heads they read, ``[q0 // G, (q1 - 1) // G + 1)`` with ``G = group``
    (``launch.partition.kv_head_range``).  Returns ``(q_lo, q_hi, kv_lo,
    kv_hi)`` ranges local to the rank, in order: the trailing part of a
    group cut at ``q0`` (one KV head), the whole groups, and the leading
    part of a group cut at ``q1`` (one KV head); each segment reads its KV
    heads at one ratio, which the kernels take.  A rank inside one group,
    or whose range meets the group boundaries, is one segment; a rank
    with no heads has none.  ``group`` 0 means one segment of ``h`` query
    heads over ``kh`` KV heads (the shard is uniform as it is)."""
    if h == 0:
        return []
    if group == 0:
        return [(0, h, 0, kh)]
    segs, a, kv = [], 0, 0
    lead = (-q0) % group
    if lead:
        a = min(lead, h)
        segs.append((0, a, 0, 1))
        kv = 1
    whole = (h - a) // group
    if whole:
        segs.append((a, a + whole * group, kv, kv + whole))
        a, kv = a + whole * group, kv + whole
    if a < h:
        segs.append((a, h, kv, kv + 1))
    return segs


def _segments(name: str, q: torch.Tensor, k: torch.Tensor, q0: int,
              group: int) -> List[Tuple[int, int, int, int]]:
    """:func:`head_segments` of a shard q (B,S,H,D) over k (B,L,KH,D),
    checked against k's heads."""
    h, kh = q.shape[2], k.shape[2]
    segs = head_segments(q0, h, group, kh)
    if (segs[-1][3] if segs else 0) != kh or any(
            (b - a) % (d - c) for a, b, c, d in segs):
        raise ValueError(f"{name}: {h} query heads from head {q0} at group "
                         f"size {group} do not read {kh} KV heads in "
                         "uniform GQA segments")
    return segs


def _offset(t: torch.Tensor, heads: int) -> int:
    """The address of head ``heads`` of row 0 of a contiguous (..., H, D)
    tensor."""
    return t.data_ptr() + heads * t.shape[-1] * t.element_size()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: Optional[int] = None, q_offset: int = 0,
                    head_start: int = 0, group: int = 0) -> torch.Tensor:
    """Causal GQA attention: q (B,Sq,H,D) over k/v (B,Skv,KH,D); query row
    i sits at position ``q_offset + i``; ``window`` masks keys older than
    ``pos - window + 1``.  Returns (B,Sq,H,D) in q's dtype.  On the card a
    bf16 call runs the tensor-core body of the kernel and an fp32 call its
    CUDA-core body (``csrc/flash_attention.cu``).

    A tensor-parallel rank's heads: ``head_start`` is its first global
    query head and ``group`` the global group size ``G``; where its heads
    cut a group the kernel runs once per uniform segment
    (:func:`head_segments`) over strided views of q, k and v, each launch
    counted.  A shard with no heads launches nothing."""
    refuse_autograd("flash_attention", q, k, v)
    if q.shape[2] == 0:
        return torch.empty_like(q)
    if _costed(q):
        return torch.ops.repro_torch.flash_attention(
            q, k, v, int(window or 0), int(q_offset), int(head_start),
            int(group))
    return _flash_attention(q, k, v, window, q_offset, head_start, group)


def _flash_attention(q, k, v, window, q_offset, head_start=0, group=0):
    segs = _segments("flash_attention", q, k, head_start, group)
    if q.device.type == "cpu":
        return ref.over_segments(ref.flash_attention, q, k, v, segs,
                                 window=window, q_offset=q_offset)
    _check("flash_attention", q, k, v, segments=segs)
    if q.data_ptr() % 16:
        raise ValueError("flash_attention: q must start on a 16-byte "
                         "boundary (the kernel copies it in 16-byte vectors)")
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    for qa, qb, ka, kb in segs:
        _launch("flash_attention", q.device,
                build.load("flash_attention_launch"),
                _offset(q, qa), _offset(k, ka), _offset(v, ka),
                _offset(out, qa), b, sq, skv, qb - qa, kb - ka, h, kh, d,
                DTYPE_CODES[q.dtype], int(q_offset), int(window or 0),
                1.0 / math.sqrt(d), _stream(q.device))
        flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _decode_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_len, q_offset, window: Optional[int],
                   segments=None) -> Tuple[torch.Tensor, int]:
    """Check the CUDA tensors and launch the decode kernel once per
    uniform GQA segment (default one: all heads); returns (the output,
    the launches), uncounted."""
    segments = segments or [(0, q.shape[2], 0, k.shape[2])]
    _check_decode("flash_decode", q, k, v, segments=segments)
    b, _, h, d = q.shape
    L, kh = k.shape[1], k.shape[2]
    kv_len, q_offset = (_slot_vector(x, b, q.device)
                        for x in (kv_len, q_offset))
    out = torch.empty_like(q)
    for qa, qb, ka, kb in segments:
        n_split, s_len, part = _split_scratch(q, L, qb - qa)
        _launch("flash_decode", q.device, build.load("flash_decode_launch"),
                _offset(q, qa), _offset(k, ka), _offset(v, ka),
                kv_len.data_ptr(), q_offset.data_ptr(), _offset(out, qa),
                _ptr(part), b, L, qb - qa, kb - ka, h, kh, d,
                DTYPE_CODES[q.dtype], int(window or 0), 1.0 / math.sqrt(d),
                n_split, s_len, _stream(q.device))
    return out, len(segments)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 kv_len, q_offset,
                 window: Optional[int] = None) -> torch.Tensor:
    """One-token attention over the slot cache: q (B,1,H,D), k/v
    (B,L,KH,D); ``kv_len`` and ``q_offset`` are per-slot (B,) int32 vectors
    (or ints) that the kernel reads on the device.  Returns (B,1,H,D)."""
    refuse_autograd("flash_decode", q, k, v)
    if _costed(q):
        b = q.shape[0]
        return torch.ops.repro_torch.flash_decode(
            q, k, v, _slot_vector(kv_len, b, q.device),
            _slot_vector(q_offset, b, q.device), int(window or 0))
    return _flash_decode(q, k, v, kv_len, q_offset, window)


def _flash_decode(q, k, v, kv_len, q_offset, window):
    if q.device.type == "cpu":
        return ref.flash_decode(q, k, v, kv_len=kv_len, q_offset=q_offset,
                                window=window)
    out, _ = _decode_launch(q, k, v, kv_len, q_offset, window)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def flash_decode_sharded(qs: Sequence[torch.Tensor],
                         ks: Sequence[torch.Tensor],
                         vs: Sequence[torch.Tensor], *, kv_len, q_offset,
                         window: Optional[int] = None,
                         head_starts: Optional[Sequence[int]] = None,
                         group: int = 0) -> List[torch.Tensor]:
    """:func:`flash_decode` under tensor parallelism: ``qs[r]`` (B,1,Hr,D)
    and ``ks[r]``/``vs[r]`` (B,L,KHr,D) are rank r's contiguous range of
    whole query heads and of the KV heads they read, on rank r's device
    (ranks may share one); ``kv_len`` and ``q_offset`` are the per-slot
    vectors (or ints) every rank shares.  The shards may be unequal, and
    empty (a rank with no heads).  ``head_starts[r]`` is rank r's first
    global query head and ``group`` the global group size ``G``; without
    them each shard must read its KV heads at one ratio.

    The decode kernel runs on each shard's device over its local heads
    only: once per uniform GQA segment of the shard (:func:`head_segments`:
    one where the shard's heads meet the group boundaries, up to three
    where they cut a group; none for an empty shard), over strided views,
    each launch adding one to this wrapper's count (not to
    :func:`flash_decode`'s).  The kernel's blocks, one per (slot, KV head,
    key split), are independent, each query head's arithmetic is the same
    whatever the group size, and every launch cuts its keys as the
    single-device launch does (:func:`decode_splits` reads neither heads
    nor lengths), so no collective runs and the shards' outputs, side by
    side, are bit for bit the single-device kernel's.  Returns the
    per-rank outputs (B,1,Hr,D).  Raises ``ValueError`` when a shard's
    heads do not read its KV heads in uniform segments."""
    refuse_autograd("flash_decode_sharded", *qs, *ks, *vs)
    starts = _check_shards("flash_decode_sharded", qs, head_starts, ks, vs)
    if _costed(qs[0]):  # one op a rank, each counted for its rank
        b = qs[0].shape[0]
        kv, qo = (_slot_vector(x, b, qs[0].device) for x in (kv_len, q_offset))
        return [torch.ops.repro_torch.flash_decode_sharded(
            [q], [k], [v], kv, qo, int(window or 0), [q0], int(group))[0]
            for q, k, v, q0 in ranked(zip(qs, ks, vs, starts))]
    return _flash_decode_sharded(qs, ks, vs, kv_len, q_offset, window,
                                 starts, group)


def _check_shards(name: str, qs, head_starts, *rest) -> List[int]:
    """One q and one of each of ``rest`` per rank, and one first head per
    rank (default 0); returns the first heads."""
    tp = len(qs)
    if tp == 0 or any(len(r) != tp for r in rest):
        raise ValueError(f"{name}: want one q, k and v per rank, got "
                         f"{[len(qs)] + [len(r) for r in rest]}")
    starts = [0] * tp if head_starts is None else [int(x) for x in
                                                   head_starts]
    if len(starts) != tp:
        raise ValueError(f"{name}: want one first head per rank, got "
                         f"{len(starts)} for {tp} ranks")
    return starts


def _shard_segments(name, qs, ks, starts, group):
    return [_segments(name, q, k, q0, group)
            for q, k, q0 in zip(qs, ks, starts)]


def _flash_decode_sharded(qs, ks, vs, kv_len, q_offset, window,
                          head_starts=(), group=0):
    starts = list(head_starts) or [0] * len(qs)
    segs = _shard_segments("flash_decode_sharded", qs, ks, starts, group)
    if all(q.device.type == "cpu" for q in qs):
        return ref.flash_decode_sharded(qs, ks, vs, kv_len=kv_len,
                                        q_offset=q_offset, window=window,
                                        segments=segs)
    outs = []
    for q, k, v, sg in zip(qs, ks, vs, segs):
        if q.device.type != "cuda":
            raise ValueError("flash_decode_sharded: shards must all lie on "
                             f"cuda or all on cpu, got {q.device}")
        if not sg:
            outs.append(torch.empty_like(q))
            continue
        out, n = _decode_launch(q, k, v, kv_len, q_offset, window, sg)
        outs.append(out)
        flash_decode_sharded.launches += n
    return outs


flash_decode_sharded.launches = 0


def flash_decode_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      k_scale: torch.Tensor, v_scale: torch.Tensor, *,
                      kv_len, q_offset,
                      window: Optional[int] = None) -> torch.Tensor:
    """:func:`flash_decode` over an int8 cache: q (B,1,H,D) fp32 or bf16,
    k/v (B,L,KH,D) int8 codes, ``k_scale``/``v_scale`` (B,L) fp32 per-token
    scales (a key is ``code * scale``).  Returns (B,1,H,D) in q's dtype.
    Raises ``ValueError`` on other types or shapes, on any device."""
    refuse_autograd("flash_decode_int8", q, k_scale, v_scale)
    if k.dtype != torch.int8 or v.dtype != torch.int8:
        raise ValueError(f"flash_decode_int8: k and v must be int8, got "
                         f"{k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_decode_int8: want q (B,1,H,D) and k == v "
                         f"(B,L,KH,D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    for s in (k_scale, v_scale):
        if s.dtype != torch.float32 or tuple(s.shape) != tuple(k.shape[:2]):
            raise ValueError(f"flash_decode_int8: scales must be float32 "
                             f"(B,L) = {tuple(k.shape[:2])}, got {s.dtype} "
                             f"{tuple(s.shape)}")
    if _costed(q):
        b = q.shape[0]
        return torch.ops.repro_torch.flash_decode_int8(
            q, k, v, k_scale, v_scale, _slot_vector(kv_len, b, q.device),
            _slot_vector(q_offset, b, q.device), int(window or 0))
    return _flash_decode_int8(q, k, v, k_scale, v_scale, kv_len, q_offset,
                              window)


def _flash_decode_int8(q, k, v, k_scale, v_scale, kv_len, q_offset, window):
    if q.device.type == "cpu":
        return ref.flash_decode_int8(q, k, v, k_scale, v_scale, kv_len=kv_len,
                                     q_offset=q_offset, window=window)
    out, _ = _int8_launch(q, k, v, k_scale, v_scale, kv_len, q_offset,
                          window)
    flash_decode_int8.launches += 1
    return out


def _int8_launch(q, k, v, k_scale, v_scale, kv_len, q_offset, window,
                 segments=None) -> Tuple[torch.Tensor, int]:
    """Check the CUDA tensors and launch the int8 decode kernel once per
    uniform GQA segment (default one: all heads); returns (the output,
    the launches), uncounted."""
    segments = segments or [(0, q.shape[2], 0, k.shape[2])]
    _check_decode("flash_decode_int8", q, k, v, torch.int8, segments)
    if any(s.device != q.device or not s.is_contiguous()
           for s in (k_scale, v_scale)):
        raise ValueError("flash_decode_int8: the scales must be contiguous, "
                         "on q's device")
    b, _, h, d = q.shape
    L, kh = k.shape[1], k.shape[2]
    kv_len, q_offset = (_slot_vector(x, b, q.device)
                        for x in (kv_len, q_offset))
    out = torch.empty_like(q)
    for qa, qb, ka, kb in segments:
        n_split, s_len, part = _split_scratch(q, L, qb - qa)
        _launch("flash_decode_int8", q.device,
                build.load("flash_decode_int8_launch"),
                _offset(q, qa), _offset(k, ka), _offset(v, ka),
                k_scale.data_ptr(), v_scale.data_ptr(), kv_len.data_ptr(),
                q_offset.data_ptr(), _offset(out, qa), _ptr(part), b, L,
                qb - qa, kb - ka, h, kh, d, DTYPE_CODES[q.dtype],
                int(window or 0), 1.0 / math.sqrt(d), n_split, s_len,
                _stream(q.device))
    return out, len(segments)


flash_decode_int8.launches = 0


def flash_decode_int8_sharded(qs: Sequence[torch.Tensor],
                              ks: Sequence[torch.Tensor],
                              vs: Sequence[torch.Tensor],
                              k_scales: Sequence[torch.Tensor],
                              v_scales: Sequence[torch.Tensor], *, kv_len,
                              q_offset, window: Optional[int] = None,
                              head_starts: Optional[Sequence[int]] = None,
                              group: int = 0) -> List[torch.Tensor]:
    """:func:`flash_decode_int8` under tensor parallelism, as
    :func:`flash_decode_sharded` is :func:`flash_decode`'s: ``qs[r]``
    (B,1,Hr,D) and the int8 codes ``ks[r]``/``vs[r]`` (B,L,KHr,D) of
    rank r's heads, with ``k_scales[r]``/``v_scales[r]`` (B,L) its copy
    of the per-token scales, which every rank shares (the cache's writes
    take one cross-rank max, ``models.layers.quantize_kv_shared``).  The
    int8 kernel runs on each shard once per uniform GQA segment of its
    heads (``head_starts``, ``group``: :func:`flash_decode_sharded`), each
    launch adding one to this wrapper's count (not to
    :func:`flash_decode_int8`'s); its outputs side by side are the
    single-device kernel's, bit for bit.  Returns the per-rank outputs
    (B,1,Hr,D)."""
    refuse_autograd("flash_decode_int8_sharded", *qs, *k_scales, *v_scales)
    starts = _check_shards("flash_decode_int8_sharded", qs, head_starts, ks,
                           vs, k_scales, v_scales)
    if _costed(qs[0]):  # one op a rank, each counted for its rank
        b = qs[0].shape[0]
        kv, qo = (_slot_vector(x, b, qs[0].device) for x in (kv_len, q_offset))
        return [torch.ops.repro_torch.flash_decode_int8_sharded(
            [q], [k], [v], [ksc], [vsc], kv, qo, int(window or 0), [q0],
            int(group))[0]
            for q, k, v, ksc, vsc, q0 in ranked(zip(qs, ks, vs, k_scales,
                                                    v_scales, starts))]
    return _flash_decode_int8_sharded(qs, ks, vs, k_scales, v_scales, kv_len,
                                      q_offset, window, starts, group)


def _flash_decode_int8_sharded(qs, ks, vs, k_scales, v_scales, kv_len,
                               q_offset, window, head_starts=(), group=0):
    starts = list(head_starts) or [0] * len(qs)
    segs = _shard_segments("flash_decode_int8_sharded", qs, ks, starts,
                           group)
    if all(q.device.type == "cpu" for q in qs):
        return ref.flash_decode_int8_sharded(
            qs, ks, vs, k_scales, v_scales, kv_len=kv_len, q_offset=q_offset,
            window=window, segments=segs)
    outs = []
    for q, k, v, ksc, vsc, sg in zip(qs, ks, vs, k_scales, v_scales, segs):
        if q.device.type != "cuda":
            raise ValueError("flash_decode_int8_sharded: shards must all lie "
                             f"on cuda or all on cpu, got {q.device}")
        for t in (k, v):
            if t.dtype != torch.int8:
                raise ValueError("flash_decode_int8_sharded: k and v must be "
                                 f"int8, got {t.dtype}")
        if not sg:
            outs.append(torch.empty_like(q))
            continue
        out, n = _int8_launch(q, k, v, ksc, vsc, kv_len, q_offset, window,
                              sg)
        outs.append(out)
        flash_decode_int8_sharded.launches += n
    return outs


flash_decode_int8_sharded.launches = 0

# --------------------------------------------------------------------------- #
# The decode over a cache whose key axis a pod splits: partials and combine
# --------------------------------------------------------------------------- #

#: SMs of the H100 the port targets: the split plan of a partials launch
#: off the card (its plain version on the CPU, the dry run on ``meta``),
#: so that those cut the keys as the card does
H100_SMS = 132


def partial_splits(b: int, rows: int, device) -> Tuple[int, int]:
    """``(n_split, s_len)`` of a partials launch of ``b`` slots over
    ``rows`` cache rows: :func:`decode_plan` on the card,
    :func:`decode_splits` at :data:`H100_SMS` elsewhere; no splits for no
    rows (a rank that holds none)."""
    device = torch.device(device)
    if rows == 0:
        return 0, DECODE_TILE
    if device.type == "cuda":
        return decode_plan(b, rows, device)
    return decode_splits(b, rows, H100_SMS)


class Partials:
    """An fp32 scratch of attention partials: ``acc`` (B, heads, n_total,
    D) then ``ml`` (B, heads, n_total, 2) in one buffer, the layout of
    the decode kernel's splits.  The ranks of a pod write their splits
    into it side by side (:func:`flash_decode_partials`), and
    :func:`flash_decode_combine` merges them."""

    def __init__(self, b: int, heads: int, n_total: int, d: int, device):
        self.b, self.heads, self.n_total, self.d = b, heads, n_total, d
        self.buf = torch.empty((b * heads * n_total * (d + 2),),
                               dtype=torch.float32, device=device)
        n = b * heads * n_total * d
        self.acc = self.buf[:n].view(b, heads, n_total, d)
        self.ml = self.buf[n:].view(b, heads, n_total, 2)


def flash_decode_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, kv_len, q_offset, window: Optional[int] = None,
                          row0: int = 0, out: Optional[Partials] = None,
                          head0: int = 0, split0: int = 0,
                          head_start: int = 0, group: int = 0):
    """The decode kernel's partials mode over one rank's rows of a cache
    whose key axis a pod splits: q (B,1,H,D) over k/v (B,R,KH,D), which
    hold buffer rows ``[row0, row0 + R)`` (row i at position ``row0 +
    i``); ``kv_len`` and ``q_offset`` are the slots' global vectors (or
    ints).  The launch writes its :func:`partial_splits` splits, each
    split's fp32 (acc, m, l), into ``out`` (default a scratch of its own)
    at heads ``[head0, head0 + H)`` and splits ``[split0, split0 + n)``,
    and no output; a slot none of whose visible rows lie here gets empty
    splits (``l = 0``).  ``head_start`` and ``group`` cut a rank's heads
    into uniform GQA segments (:func:`flash_decode_sharded`), one launch
    each.  Returns the (acc, ml) views of ``out`` it wrote.

    Replaces the sequential key axis of
    ``src/repro/kernels/decode_attention.py::_decode_kernel``: where
    GSPMD splits the cache's sequence axis over "model" (``kv_shard=
    "seq"``) or over "data" (the context-parallel cache), the reference
    reads it under XLA; the port reads each rank's rows with this kernel.
    Bound on the card: bytes, as :func:`flash_decode` (the rank's rows of
    K and V once); the design is the decode kernel's, whose key splits
    already write fp32 partials and merge them in a second pass: here
    they go to a scratch that all ranks share, at their own offsets, so
    one :func:`flash_decode_combine` merges every rank's splits."""
    refuse_autograd("flash_decode_partials", q, k, v)
    return _partials(flash_decode_partials, q, k, v, None, None, kv_len,
                     q_offset, out, window, row0, head0, split0, head_start,
                     group)


def flash_decode_int8_partials(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, k_scale: torch.Tensor,
                               v_scale: torch.Tensor, *, kv_len, q_offset,
                               window: Optional[int] = None, row0: int = 0,
                               out: Optional[Partials] = None,
                               head0: int = 0, split0: int = 0,
                               head_start: int = 0, group: int = 0):
    """:func:`flash_decode_partials` over an int8 cache's rows: k/v
    (B,R,KH,D) int8 codes and their per-token fp32 scales (B,R), which
    the pod splits with the rows.  Replaces the sequential key axis of
    ``_decode_kernel_int8``, as :func:`flash_decode_partials` does
    ``_decode_kernel``'s; bound by bytes (D bytes a row and KV head, and
    two 4-byte scales a row)."""
    refuse_autograd("flash_decode_int8_partials", q, k_scale, v_scale)
    for t in (k, v):
        if t.dtype != torch.int8:
            raise ValueError("flash_decode_int8_partials: k and v must be "
                             f"int8, got {t.dtype}")
    return _partials(flash_decode_int8_partials, q, k, v, k_scale, v_scale,
                     kv_len, q_offset, out, window, row0, head0, split0,
                     head_start, group)


def _partials(fn, q, k, v, k_scale, v_scale, kv_len, q_offset, out, window,
              row0, head0, split0, head_start, group):
    b, _, h, d = q.shape
    n_split, s_len = partial_splits(b, k.shape[1], q.device)
    if out is None:
        out = Partials(b, h, n_split, d, q.device)
    dst = (slice(None), slice(head0, head0 + h),
           slice(split0, split0 + n_split))
    if n_split == 0 or h == 0:
        return out.acc[dst], out.ml[dst]
    if head0 + h > out.heads or split0 + n_split > out.n_total:
        raise ValueError(f"{fn.__name__}: heads [{head0}, {head0 + h}) and "
                         f"splits [{split0}, {split0 + n_split}) do not fit "
                         f"the scratch ({out.heads} heads, {out.n_total} "
                         "splits)")
    scales = [] if k_scale is None else [k_scale, v_scale]
    if _costed(q):
        op = (torch.ops.repro_torch.flash_decode_partials if k_scale is None
              else torch.ops.repro_torch.flash_decode_int8_partials)
        acc, ml = op(q, k, v, *scales, _slot_vector(kv_len, b, q.device),
                     _slot_vector(q_offset, b, q.device), int(window or 0),
                     int(row0), int(head_start), int(group))
        out.acc[dst].copy_(acc)
        out.ml[dst].copy_(ml)
        return out.acc[dst], out.ml[dst]
    segs = _segments(fn.__name__, q, k, head_start, group)
    if q.device.type == "cpu":
        for qa, qb, ka, kb in segs:
            acc, ml = ref.flash_decode_partials(
                q[:, :, qa:qb], k[:, :, ka:kb], v[:, :, ka:kb],
                kv_len=kv_len, q_offset=q_offset, window=window, row0=row0,
                n_split=n_split, s_len=s_len, k_scale=k_scale,
                v_scale=v_scale)
            sl = (slice(None), slice(head0 + qa, head0 + qb), dst[2])
            out.acc[sl] = acc
            out.ml[sl] = ml
        return out.acc[dst], out.ml[dst]
    _check_decode(fn.__name__, q, k, v, None if k_scale is None
                  else torch.int8, segs)
    if out.buf.device != q.device:
        raise ValueError(f"{fn.__name__}: the scratch must lie on q's "
                         f"device, got {out.buf.device} and {q.device}")
    if k_scale is not None and any(
            s.device != q.device or not s.is_contiguous()
            or s.dtype != torch.float32 or tuple(s.shape) != tuple(k.shape[:2])
            for s in scales):
        raise ValueError(f"{fn.__name__}: the scales must be contiguous "
                         f"float32 (B,R) = {tuple(k.shape[:2])} on q's device")
    kh = k.shape[2]
    kv_len, q_offset = (_slot_vector(x, b, q.device)
                        for x in (kv_len, q_offset))
    entry = ("flash_decode_partials_launch" if k_scale is None
             else "flash_decode_int8_partials_launch")
    for qa, qb, ka, kb in segs:
        _launch(fn.__name__, q.device, build.load(entry),
                _offset(q, qa), _offset(k, ka), _offset(v, ka),
                *[t.data_ptr() for t in scales], kv_len.data_ptr(),
                q_offset.data_ptr(), out.buf.data_ptr(), b, k.shape[1],
                qb - qa, kb - ka, h, kh, d, DTYPE_CODES[q.dtype],
                int(window or 0), 1.0 / math.sqrt(d), n_split, s_len,
                int(row0), out.heads, head0 + qa, split0, out.n_total,
                _stream(q.device))
        fn.launches += 1
    return out.acc[dst], out.ml[dst]


flash_decode_partials.launches = 0
flash_decode_int8_partials.launches = 0


def flash_decode_combine(acc: torch.Tensor, ml: torch.Tensor, *,
                         dtype: torch.dtype = torch.float32,
                         head_ranges: Optional[Sequence[Tuple[int, int]]]
                         = None):
    """Merge the splits of ``acc`` (B,H,N,D) and ``ml`` (B,H,N,2), fp32
    (a :class:`Partials` scratch: the ranks' :func:`flash_decode_partials`
    side by side in rank order), for each (slot, head), an empty split
    (``l = 0``, m whatever it is) left out of the max and weighing 0
    (``ref.combine_partials``): the decode's output (B,1,H,D) in
    ``dtype``, or with ``head_ranges`` its pieces over them, the heads
    each rank owns.  On the card one launch merges every head.  Replaces
    the reference's merge of a split cache's attention, which XLA emits
    as a reduction over the sharded axis; bound by bytes (the scratch
    read once, the output written once), small beside the partials."""
    refuse_autograd("flash_decode_combine", acc, ml)
    ranges = list(head_ranges or [(0, acc.shape[1])])
    if _costed(acc):  # a rank with no heads merges nothing
        b, _, _, d = acc.shape
        out = [torch.ops.repro_torch.flash_decode_combine(
            acc[:, h0:h1], ml[:, h0:h1], DTYPE_CODES[dtype]) if h1 > h0
            else acc.new_empty((b, 1, 0, d), dtype=dtype)
            for h0, h1 in ranked(ranges)]
    else:
        whole = _flash_decode_combine(acc, ml, dtype)
        out = [whole[:, :, h0:h1] for h0, h1 in ranges]
    return out if head_ranges is not None else out[0]


def _flash_decode_combine(acc, ml, dtype) -> torch.Tensor:
    if acc.device.type == "cpu":
        return ref.flash_decode_combine(acc, ml, dtype=dtype)
    b, heads, n_total, d = acc.shape
    buf = acc.reshape(-1)
    if not (acc.is_contiguous() and ml.is_contiguous()
            and ml.data_ptr() == acc.data_ptr() + acc.numel() * 4):
        part = Partials(b, heads, n_total, d, acc.device)
        part.acc.copy_(acc)
        part.ml.copy_(ml)
        buf = part.buf
    out = _combine_launch(buf, b, heads, n_total, d, dtype)
    flash_decode_combine.launches += 1
    return out


def _combine_launch(buf, b, heads, n_total, d, dtype) -> torch.Tensor:
    if dtype not in DTYPE_CODES or d not in HEAD_DIMS:
        raise ValueError(f"flash_decode_combine: dtype {dtype} / head dim {d} "
                         "not supported")
    out = torch.empty((b, 1, heads, d), dtype=dtype, device=buf.device)
    _launch("flash_decode_combine", buf.device,
            build.load("flash_decode_combine_launch"), buf.data_ptr(),
            out.data_ptr(), b, heads, heads, n_total, d, DTYPE_CODES[dtype],
            _stream(buf.device))
    return out


flash_decode_combine.launches = 0

#: (head dim P, state dim N) pairs the SSD-scan kernel is built for
SSD_SHAPES = ((32, 16), (32, 128), (64, 16), (64, 64), (64, 128))
#: longest chunk the SSD-scan kernel takes (its running sum of ``a`` is
#: held in shared memory)
SSD_MAX_CHUNK = 256


def ssd_workspace_floats(b: int, s: int, h: int, p: int, n: int,
                         chunk: int) -> int:
    """fp32 elements of the bf16 SSD kernel's workspace: each chunk's end
    state, (B, nc, H, P, N), then each chunk's end decay exp(a_cum[-1]),
    (B, nc, H), with ``nc = s // chunk``.  0 for one chunk: its end state
    is the final state, and no pass reads another's."""
    nc = s // chunk
    return 0 if nc == 1 else b * nc * h * (p * n + 1)


def ssd_scan(x: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, *, chunk: int = 256):
    """Chunked SSD scan (Mamba2): x (B,S,H,P) already multiplied by dt, a
    (B,S,H) fp32 log decay, Bm/Cm (B,S,H,N) in x's dtype, ``S % chunk ==
    0``.  Returns (y (B,S,H,P), final state (B,H,P,N)) in x's dtype.  On
    the card a bf16 call runs the kernel's tensor-core passes (two or three
    kernels, over an fp32 workspace of :func:`ssd_workspace_floats`) and
    an fp32 call its CUDA-core body; either counts one launch."""
    refuse_autograd("ssd_scan", x, a, Bm, Cm)
    if x.shape[2] == 0:  # a tensor-parallel rank with no SSM heads
        return (torch.empty_like(x),
                x.new_empty((x.shape[0], 0, x.shape[3], Bm.shape[-1])))
    if _costed(x):
        return torch.ops.repro_torch.ssd_scan(x, a, Bm, Cm, int(chunk))
    return _ssd_scan(x, a, Bm, Cm, chunk)


def _ssd_scan(x, a, Bm, Cm, chunk):
    if x.device.type == "cpu":
        return ref.ssd_scan(x, a, Bm, Cm, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: tensors must be on cuda or cpu, got "
                         f"{x.device}")
    for t in (a, Bm, Cm):
        if t.device != x.device:
            raise ValueError("ssd_scan: x, a, Bm, Cm must share a device")
    if x.dtype not in DTYPE_CODES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"ssd_scan: x, Bm, Cm must share a dtype of float32 "
                         f"or bfloat16, got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if a.dtype != torch.float32:
        raise ValueError(f"ssd_scan: a must be float32, got {a.dtype}")
    if x.ndim != 4 or Bm.ndim != 4 or Bm.shape != Cm.shape:
        raise ValueError(f"ssd_scan: want x (B,S,H,P) and Bm == Cm (B,S,H,N), "
                         f"got {tuple(x.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    if tuple(a.shape) != (b, s, h) or tuple(Bm.shape[:3]) != (b, s, h):
        raise ValueError(f"ssd_scan: shapes {tuple(x.shape)}, {tuple(a.shape)}"
                         f", {tuple(Bm.shape)} do not match")
    if (p, n) not in SSD_SHAPES:
        raise ValueError(f"ssd_scan: (head dim, state dim) {(p, n)} not in "
                         f"{SSD_SHAPES}")
    if not 1 <= chunk <= SSD_MAX_CHUNK or s % chunk:
        raise ValueError(f"ssd_scan: chunk {chunk} must lie in [1, "
                         f"{SSD_MAX_CHUNK}] and divide S={s}")
    if not all(t.is_contiguous() for t in (x, a, Bm, Cm)):
        raise ValueError("ssd_scan: x, a, Bm, Cm must be contiguous")
    if x.data_ptr() % 16 or Bm.data_ptr() % 16 or Cm.data_ptr() % 16:
        raise ValueError("ssd_scan: x, Bm and Cm must start on a 16-byte "
                         "boundary (the kernel reads them in 16-byte vectors)")
    y = torch.empty_like(x)
    final = torch.empty((b, h, p, n), dtype=x.dtype, device=x.device)
    floats = (ssd_workspace_floats(b, s, h, p, n, chunk)
              if x.dtype == torch.bfloat16 else 0)
    ws = (torch.empty((floats,), dtype=torch.float32, device=x.device)
          if floats else None)
    _launch("ssd_scan", x.device, build.load("ssd_scan_launch"),
            x.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            y.data_ptr(), final.data_ptr(), _ptr(ws), b, s, h, p, n,
            int(chunk), DTYPE_CODES[x.dtype], _stream(x.device))
    ssd_scan.launches += 1
    return y, final


ssd_scan.launches = 0

#: every kernel wrapper, by name
KERNELS = {"flash_attention": flash_attention, "flash_decode": flash_decode,
           "flash_decode_sharded": flash_decode_sharded,
           "flash_decode_int8": flash_decode_int8,
           "flash_decode_int8_sharded": flash_decode_int8_sharded,
           "flash_decode_partials": flash_decode_partials,
           "flash_decode_int8_partials": flash_decode_int8_partials,
           "flash_decode_combine": flash_decode_combine,
           "ssd_scan": ssd_scan}


# --------------------------------------------------------------------------- #
# The wrappers as custom ops, with their flop formulas (module docstring)
# --------------------------------------------------------------------------- #


def _costed(t: torch.Tensor) -> bool:
    """Call the custom op: a dispatch mode counts."""
    return _get_current_dispatch_mode() is not None


def _win(window: int) -> Optional[int]:
    return window or None


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        window: int, q_offset: int, head_start: int,
                        group: int) -> torch.Tensor:
    return _flash_attention(q, k, v, _win(window), q_offset, head_start,
                            group)


@_flash_attention_op.register_fake
def _(q, k, v, window, q_offset, head_start, group):
    return torch.empty_like(q)


@torch.library.custom_op("repro_torch::flash_decode", mutates_args=())
def _flash_decode_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, q_offset: torch.Tensor,
                     window: int) -> torch.Tensor:
    return _flash_decode(q, k, v, kv_len, q_offset, _win(window))


@_flash_decode_op.register_fake
def _(q, k, v, kv_len, q_offset, window):
    return torch.empty_like(q)


@torch.library.custom_op("repro_torch::flash_decode_sharded", mutates_args=())
def _flash_decode_sharded_op(qs: List[torch.Tensor], ks: List[torch.Tensor],
                             vs: List[torch.Tensor], kv_len: torch.Tensor,
                             q_offset: torch.Tensor, window: int,
                             head_starts: List[int],
                             group: int) -> List[torch.Tensor]:
    return _flash_decode_sharded(qs, ks, vs, kv_len, q_offset, _win(window),
                                 head_starts, group)


@_flash_decode_sharded_op.register_fake
def _(qs, ks, vs, kv_len, q_offset, window, head_starts, group):
    return [torch.empty_like(q) for q in qs]


@torch.library.custom_op("repro_torch::flash_decode_int8", mutates_args=())
def _flash_decode_int8_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          k_scale: torch.Tensor, v_scale: torch.Tensor,
                          kv_len: torch.Tensor, q_offset: torch.Tensor,
                          window: int) -> torch.Tensor:
    return _flash_decode_int8(q, k, v, k_scale, v_scale, kv_len, q_offset,
                              _win(window))


@_flash_decode_int8_op.register_fake
def _(q, k, v, k_scale, v_scale, kv_len, q_offset, window):
    return torch.empty_like(q)


@torch.library.custom_op("repro_torch::flash_decode_int8_sharded",
                         mutates_args=())
def _flash_decode_int8_sharded_op(
        qs: List[torch.Tensor], ks: List[torch.Tensor],
        vs: List[torch.Tensor], k_scales: List[torch.Tensor],
        v_scales: List[torch.Tensor], kv_len: torch.Tensor,
        q_offset: torch.Tensor, window: int, head_starts: List[int],
        group: int) -> List[torch.Tensor]:
    return _flash_decode_int8_sharded(qs, ks, vs, k_scales, v_scales, kv_len,
                                      q_offset, _win(window), head_starts,
                                      group)


@_flash_decode_int8_sharded_op.register_fake
def _(qs, ks, vs, k_scales, v_scales, kv_len, q_offset, window, head_starts,
      group):
    return [torch.empty_like(q) for q in qs]


def _partials_op(q, k, v, scales, kv_len, q_offset, window, row0,
                 head_start, group):
    """The partials launch as a function: its own scratch, its splits."""
    fn = flash_decode_partials if not scales else flash_decode_int8_partials
    acc, ml = _partials(fn, q, k, v, *(scales or [None, None]), kv_len,
                        q_offset, None, _win(window), row0, 0, 0, head_start,
                        group)
    return acc.clone(), ml.clone()


def _partials_fake(q, k):
    n_split, _ = partial_splits(q.shape[0], k.shape[1], q.device)
    b, _, h, d = q.shape
    return (q.new_empty((b, h, n_split, d), dtype=torch.float32),
            q.new_empty((b, h, n_split, 2), dtype=torch.float32))


@torch.library.custom_op("repro_torch::flash_decode_partials", mutates_args=())
def _flash_decode_partials_op(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, kv_len: torch.Tensor,
                              q_offset: torch.Tensor, window: int, row0: int,
                              head_start: int, group: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    return _partials_op(q, k, v, None, kv_len, q_offset, window, row0,
                        head_start, group)


@_flash_decode_partials_op.register_fake
def _(q, k, v, kv_len, q_offset, window, row0, head_start, group):
    return _partials_fake(q, k)


@torch.library.custom_op("repro_torch::flash_decode_int8_partials",
                         mutates_args=())
def _flash_decode_int8_partials_op(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        k_scale: torch.Tensor, v_scale: torch.Tensor, kv_len: torch.Tensor,
        q_offset: torch.Tensor, window: int, row0: int, head_start: int,
        group: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return _partials_op(q, k, v, [k_scale, v_scale], kv_len, q_offset, window,
                        row0, head_start, group)


@_flash_decode_int8_partials_op.register_fake
def _(q, k, v, k_scale, v_scale, kv_len, q_offset, window, row0, head_start,
      group):
    return _partials_fake(q, k)


@torch.library.custom_op("repro_torch::flash_decode_combine", mutates_args=())
def _flash_decode_combine_op(acc: torch.Tensor, ml: torch.Tensor,
                             dtype: int) -> torch.Tensor:
    dt = {c: t for t, c in DTYPE_CODES.items()}[dtype]
    return _flash_decode_combine(acc, ml, dt)


@_flash_decode_combine_op.register_fake
def _(acc, ml, dtype):
    b, heads, _, d = acc.shape
    dt = {c: t for t, c in DTYPE_CODES.items()}[dtype]
    return acc.new_empty((b, 1, heads, d), dtype=dt)


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=())
def _ssd_scan_op(x: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor, chunk: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    return _ssd_scan(x, a, Bm, Cm, chunk)


@_ssd_scan_op.register_fake
def _(x, a, Bm, Cm, chunk):
    b, _, h, p = x.shape
    return (torch.empty_like(x),
            x.new_empty((b, h, p, Bm.shape[-1])))


def attention_pairs(sq: int, skv: int, q_offset: int, window: int) -> int:
    """(query, key) pairs a causal prefill of ``sq`` queries at positions
    ``q_offset + i`` over ``skv`` keys may attend, within ``window``
    (0: none)."""
    pos = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(pos + 1, skv)
    lo = np.maximum(pos - window + 1, 0) if window else np.zeros_like(pos)
    return int(np.maximum(hi - lo, 0).sum())


def _decode_rows(L: int, window: int) -> int:
    return min(L, window) if window else L


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_attention_flops(q, k, v, window, q_offset, *args, out_shape=None,
                           **kwargs) -> int:
    # every query head once, however its shard's segments cut it
    b, sq, h, d = q
    return 4 * b * h * d * attention_pairs(sq, k[1], q_offset, window)


@register_flop_formula(torch.ops.repro_torch.flash_decode)
def _flash_decode_flops(q, k, v, kv_len, q_offset, window, *args,
                        out_shape=None, **kwargs) -> int:
    b, _, h, d = q
    return 4 * b * h * d * _decode_rows(k[1], window)


@register_flop_formula(torch.ops.repro_torch.flash_decode_int8)
def _flash_decode_int8_flops(q, k, v, k_scale, v_scale, kv_len, q_offset,
                             window, *args, out_shape=None, **kwargs) -> int:
    b, _, h, d = q
    return 4 * b * h * d * _decode_rows(k[1], window)


@register_flop_formula(torch.ops.repro_torch.flash_decode_sharded)
def _flash_decode_sharded_flops(qs, ks, vs, kv_len, q_offset, window, *args,
                                out_shape=None, **kwargs) -> int:
    # every rank's query heads once, however its segments cut them
    return sum(4 * q[0] * q[2] * q[3] * _decode_rows(k[1], window)
               for q, k in zip(qs, ks))


@register_flop_formula(torch.ops.repro_torch.flash_decode_int8_sharded)
def _flash_decode_int8_sharded_flops(qs, ks, vs, k_scales, v_scales, kv_len,
                                     q_offset, window, *args, out_shape=None,
                                     **kwargs) -> int:
    return sum(4 * q[0] * q[2] * q[3] * _decode_rows(k[1], window)
               for q, k in zip(qs, ks))


@register_flop_formula(torch.ops.repro_torch.flash_decode_partials)
def _flash_decode_partials_flops(q, k, v, kv_len, q_offset, window, *args,
                                 out_shape=None, **kwargs) -> int:
    b, _, h, d = q
    return 4 * b * h * d * _decode_rows(k[1], window)


@register_flop_formula(torch.ops.repro_torch.flash_decode_int8_partials)
def _flash_decode_int8_partials_flops(q, k, v, k_scale, v_scale, kv_len,
                                      q_offset, window, *args,
                                      out_shape=None, **kwargs) -> int:
    b, _, h, d = q
    return 4 * b * h * d * _decode_rows(k[1], window)


@register_flop_formula(torch.ops.repro_torch.flash_decode_combine)
def _flash_decode_combine_flops(acc, ml, dtype, *args, out_shape=None,
                                **kwargs) -> int:
    # one multiply-add a partial element (acc and l), one divide an output
    b, h, n, d = acc
    return 2 * b * h * n * (d + 1) + b * h * d


@register_flop_formula(torch.ops.repro_torch.ssd_scan)
def _ssd_scan_flops(x, a, Bm, Cm, chunk, *args, out_shape=None,
                    **kwargs) -> int:
    b, s, h, p = x
    n = Bm[-1]
    # per chunk: C B^T and its product with x (c x c each), the chunk's
    # state and the carried state's outputs (c x N x P each)
    return b * h * (s // chunk) * (2 * chunk * chunk * (n + p)
                                   + 4 * chunk * n * p)


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
