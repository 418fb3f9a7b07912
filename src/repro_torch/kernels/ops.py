"""Kernel wrappers: the hand-written CUDA kernels with their dispatch.

A wrapper given CPU tensors runs the kernel's plain PyTorch version
(:mod:`repro_torch.kernels.ref`).  Given CUDA tensors it checks them,
launches the kernel on the tensors' device and that device's current
stream, and adds one to its ``launches`` count, or raises: there is no
fallback from the kernel to the plain version.  The kernels are built from
``repro_torch/csrc`` at first use (:mod:`repro_torch.kernels.build`).
"""
from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence

import torch

from repro_torch.kernels import build, ref

HEAD_DIMS = (32, 64, 128)
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


def _split_scratch(q: torch.Tensor, L: int):
    """(n_split, s_len) of q's decode launch over L rows, and its fp32
    partials (None when one split writes the output).  The caller holds
    the partials until the launch is queued."""
    b, _, h, d = q.shape
    n_split, s_len = decode_plan(b, L, q.device)
    part = (None if n_split == 1 else
            torch.empty((b * h * n_split * (d + 2),), dtype=torch.float32,
                        device=q.device))
    return n_split, s_len, part


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           kv_dtype: Optional[torch.dtype] = None):
    """CUDA tensors the attention kernels take: k and v of ``kv_dtype``
    (by default q's dtype)."""
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
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
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
                  v: torch.Tensor, kv_dtype: Optional[torch.dtype] = None):
    """:func:`_check`, and one query token per slot with at most
    ``MAX_GROUP`` query heads per KV head."""
    _check(name, q, k, v, kv_dtype)
    h, kh = q.shape[2], k.shape[2]
    if q.shape[1] != 1:
        raise ValueError(f"{name}: one query token per slot, got "
                         f"{q.shape[1]}")
    if h // kh > MAX_GROUP:
        raise ValueError(f"{name}: {h // kh} query heads per kv head exceed "
                         f"{MAX_GROUP}")


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Causal GQA attention: q (B,Sq,H,D) over k/v (B,Skv,KH,D); query row
    i sits at position ``q_offset + i``; ``window`` masks keys older than
    ``pos - window + 1``.  Returns (B,Sq,H,D) in q's dtype.  On the card a
    bf16 call runs the tensor-core body of the kernel and an fp32 call its
    CUDA-core body (``csrc/flash_attention.cu``)."""
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, window=window, q_offset=q_offset)
    _check("flash_attention", q, k, v)
    if q.data_ptr() % 16:
        raise ValueError("flash_attention: q must start on a 16-byte "
                         "boundary (the kernel copies it in 16-byte vectors)")
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    _launch("flash_attention", q.device, build.load("flash_attention_launch"),
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, sq, skv, h, kh, d, DTYPE_CODES[q.dtype], int(q_offset),
            int(window or 0), 1.0 / math.sqrt(d), _stream(q.device))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _decode_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_len, q_offset, window: Optional[int]) -> torch.Tensor:
    """Check the CUDA tensors and launch the decode kernel (uncounted)."""
    _check_decode("flash_decode", q, k, v)
    b, _, h, d = q.shape
    L, kh = k.shape[1], k.shape[2]
    kv_len, q_offset = (_slot_vector(x, b, q.device)
                        for x in (kv_len, q_offset))
    out = torch.empty_like(q)
    n_split, s_len, part = _split_scratch(q, L)
    _launch("flash_decode", q.device, build.load("flash_decode_launch"),
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
            q_offset.data_ptr(), out.data_ptr(), _ptr(part), b, L, h, kh, d,
            DTYPE_CODES[q.dtype], int(window or 0), 1.0 / math.sqrt(d),
            n_split, s_len, _stream(q.device))
    return out


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 kv_len, q_offset,
                 window: Optional[int] = None) -> torch.Tensor:
    """One-token attention over the slot cache: q (B,1,H,D), k/v
    (B,L,KH,D); ``kv_len`` and ``q_offset`` are per-slot (B,) int32 vectors
    (or ints) that the kernel reads on the device.  Returns (B,1,H,D)."""
    if q.device.type == "cpu":
        return ref.flash_decode(q, k, v, kv_len=kv_len, q_offset=q_offset,
                                window=window)
    out = _decode_launch(q, k, v, kv_len, q_offset, window)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def flash_decode_sharded(qs: Sequence[torch.Tensor],
                         ks: Sequence[torch.Tensor],
                         vs: Sequence[torch.Tensor], *, kv_len, q_offset,
                         window: Optional[int] = None) -> List[torch.Tensor]:
    """:func:`flash_decode` under tensor parallelism: ``qs[r]`` (B,1,H/tp,D)
    and ``ks[r]``/``vs[r]`` (B,L,KHr,D) are rank r's contiguous ranges of
    whole query heads and of the KV heads they read, on rank r's device
    (ranks may share one); ``kv_len`` and ``q_offset`` are the per-slot
    vectors (or ints) every rank shares.

    The decode kernel runs once per shard on that shard's device, over its
    local heads only, and each launch adds one to this wrapper's count
    (not to :func:`flash_decode`'s).  The kernel's blocks, one per (slot,
    KV head, key split), are independent, each query head's arithmetic is
    the same whatever the group size, and every shard cuts its keys as
    the single-device launch does (:func:`decode_splits` reads neither
    heads nor lengths), so no collective runs and the shards' outputs,
    side by side, are bit for bit the single-device kernel's.
    Returns the per-rank outputs (B,1,H/tp,D).  Raises ``ValueError`` when
    the shards are not equal numbers of whole heads."""
    tp = len(qs)
    if tp == 0 or len(ks) != tp or len(vs) != tp:
        raise ValueError(f"flash_decode_sharded: want one q, k and v per "
                         f"rank, got {len(qs)}, {len(ks)}, {len(vs)}")
    hs = {q.shape[2] for q in qs}
    khs = {k.shape[2] for k in ks}
    if len(hs) != 1 or len(khs) != 1:
        raise ValueError(
            f"flash_decode_sharded: heads ({sorted(hs)} q / {sorted(khs)} kv "
            f"per rank) must divide the {tp} ranks into equal shards of "
            "whole heads")
    if all(q.device.type == "cpu" for q in qs):
        return ref.flash_decode_sharded(qs, ks, vs, kv_len=kv_len,
                                        q_offset=q_offset, window=window)
    outs = []
    for q, k, v in zip(qs, ks, vs):
        if q.device.type != "cuda":
            raise ValueError("flash_decode_sharded: shards must all lie on "
                             f"cuda or all on cpu, got {q.device}")
        outs.append(_decode_launch(q, k, v, kv_len, q_offset, window))
        flash_decode_sharded.launches += 1
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
    if q.device.type == "cpu":
        return ref.flash_decode_int8(q, k, v, k_scale, v_scale, kv_len=kv_len,
                                     q_offset=q_offset, window=window)
    _check_decode("flash_decode_int8", q, k, v, torch.int8)
    if any(s.device != q.device or not s.is_contiguous()
           for s in (k_scale, v_scale)):
        raise ValueError("flash_decode_int8: the scales must be contiguous, "
                         "on q's device")
    b, _, h, d = q.shape
    L, kh = k.shape[1], k.shape[2]
    kv_len, q_offset = (_slot_vector(x, b, q.device)
                        for x in (kv_len, q_offset))
    out = torch.empty_like(q)
    n_split, s_len, part = _split_scratch(q, L)
    _launch("flash_decode_int8", q.device,
            build.load("flash_decode_int8_launch"),
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), kv_len.data_ptr(), q_offset.data_ptr(),
            out.data_ptr(), _ptr(part), b, L, h, kh, d, DTYPE_CODES[q.dtype],
            int(window or 0), 1.0 / math.sqrt(d), n_split, s_len,
            _stream(q.device))
    flash_decode_int8.launches += 1
    return out


flash_decode_int8.launches = 0

#: (head dim P, state dim N) pairs the SSD-scan kernel is built for
SSD_SHAPES = ((32, 16), (32, 128), (64, 16), (64, 128))
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
           "flash_decode_int8": flash_decode_int8, "ssd_scan": ssd_scan}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
