#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. device: name, count, power limit, torch and CUDA versions;
  2. build: every kernel of ``src/repro_torch/csrc`` with nvcc, in parallel;
  3. kernels against their plain PyTorch versions at the served shapes,
     bf16 and fp32, with times (kernel, plain version, and PyTorch's
     ``scaled_dot_product_attention`` as the attention kernels' yardstick)
     and the bound; the sharded decode (``flash_decode_sharded``) at the
     shard shapes of a TP=2 and a TP=4 pod, also bit for bit against the
     single-device kernel;
  4. the served paths at full width: ``ElisServer`` -> ISRTF with the
     oracle predictor -> ``EngineExecutor`` ->
     ``InferenceEngine(attn_impl="kernel")`` serving a dozen requests to
     qwen2-1.5b (28 layers), then to mamba2-130m (24 layers), then to
     qwen2-1.5b on one tensor-parallel pod of 2 ranks (``dense-tp2``: on
     two cards when there are two, else both ranks on ``cuda:0``), bf16,
     random weights from a seed; each path's kernel launch counts are set
     to 0 just before it and read just after; one decode window of each is
     then profiled (device busy share, kernels);
  5. kernel path against plain path, per model: identical greedy tokens at
     full width with 2 layers in fp32 through evictions and recompute
     resumes, and agreeing first prefill logits at full width and depth in
     bf16; for ``dense-tp2``, the TP kernel engine against the
     single-device kernel engine and the plain engine, and a TP=4 kernel
     engine (each rank holding the one KV head it reads) against the
     single-device kernel engine (fp32 tokens), and the TP=2 kernel model
     against the single-device kernel model (bf16 logits).
The last lines are a JSON object of per-kernel numbers, the card's name and
power limit as ``nvidia-smi`` reports them, and the result line.
Needs one CUDA card; imports neither JAX nor the JAX package.

    python3 chip_smoke.py --planted-fault drop_first_tile

checks the checks instead: it builds the kernels from a copy of ``csrc``
with one deliberate fault (``PLANTED_FAULTS``) in a temporary directory,
runs phase 3's comparisons and phase 5's comparisons against it, and
prints how many of them caught the fault; ``drop_rank_partial`` instead
drops one rank's attention output from the TP model's sums, in memory,
and runs phase 5's TP comparisons.

    python3 chip_smoke.py --window-bench 24

times 24 decode windows of the dense cell's engine and prints them as one
JSON line; copied into the root of another checkout it times that
checkout's ``src``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
#: where the model runs (a CPU rehearsal of phases 4-5 may set "cpu")
DEVICE = "cuda"
#: the served paths' widths: qwen2-1.5b heads and the engine's slot cache
HEADS, KV_HEADS, HEAD_DIM, MAX_LEN = 12, 2, 128, 512
#: mamba2-130m's SSD widths: SSM heads, head dim, state dim
SSM_HEADS, SSM_HEAD_DIM, SSM_STATE = 24, 64, 128
#: published H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and
#: flop/s by operand type (bf16 on the tensor cores, fp32 outside them)
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
#: kernel vs plain version, (atol, rtol) in |kernel - plain| <= atol + rtol
#: * |plain|.  Both compute in fp32 from the same inputs, so in fp32 they
#: differ only by summation order (online vs full softmax).  In bf16 each
#: rounds its fp32 result to bf16, so they differ by at most one bf16 ulp,
#: which is at most 2^-7 of the value, plus the fp32 difference near 0.
#: The SSD scan's outputs are sums of up to chunk x N products whose size
#: follows the inputs', so its atol is taken relative to the output's
#: largest |plain value| (``max_err(scaled=True)``); its ``a_cum`` is
#: summed in fp64 on both sides (kernels/ref.py), so only the order of the
#: product sums differs.
TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-5, 2.0 ** -7)}
#: bf16 full-depth prefill logits, kernel engine vs plain engine.  On an
#: H100 the correct kernels gave a gap of 0.043 (|logit| <= 3.6), one-ulp
#: differences carried through 28 layers; the planted faults gave 0.137
#: (``bf16_accumulate``) and 5.06 (``drop_first_tile``).  The limit lies
#: between the correct reading and the nearest faulty one.
LOGIT_TOL_BF16 = 0.1
#: bf16 full-depth prefill logits of mamba2-130m: the kernel engine against
#: the same model with the kernel swapped for its plain version on the
#: kernel's own inputs.  The plain engine is no yardstick here: it casts
#: ``a`` to bf16 before its scan (as the reference's plain path does), so
#: it computes another function, and on an H100 it differed from the
#: correct kernel by 0.094 and from the ``drop_carried_state`` fault by
#: 0.090 (|logit| <= 2.6).  Against the plain scan the correct kernel gave
#: 0 and the fault 0.047; the limit lies between them.
SSM_LOGIT_TOL_BF16 = 0.02
#: bf16 full-depth prefill logits of qwen2-1.5b, the TP=2 kernel model
#: against the single-device kernel model.  They differ where the TP model
#: rounds each rank's row-parallel partial to bf16 before the sum (twice a
#: layer, 28 layers).  On an H100 (both ranks on one card) the correct
#: model gave 0.051 (|logit| <= 3.5), and the planted ``drop_rank_partial``
#: (one rank's attention output left out of every layer's sum) gave 4.98;
#: the limit lies between them.  fp32 greedy identity caught that fault too.
TP_LOGIT_TOL_BF16 = 0.1
#: ranks of the tensor-parallel cell
TP = 2
#: one-line faults for ``--planted-fault``: (source, regex, replacement)
PLANTED_FAULTS = {
    # skip the oldest 32-key tile of every row that sees more than 32 keys
    "drop_first_tile": [
        (src, r"for \(int t0 = lo; t0 < hi; t0 \+= kTile\)",
         "for (int t0 = hi - lo > kTile ? lo + kTile : lo; t0 < hi; "
         "t0 += kTile)") for src in ("decode_attention.cu",
                                     "flash_attention.cu")],
    # round the output accumulator to the input dtype after every key
    "bf16_accumulate": [
        (src,
         r"(acc(?:\[r\])?\[i\]) \+= (pj \* vs\[j \* D \+ lane \+ 32 \* i\]);",
         r"\1 = to_f(from_f<T>(\1 + \2));")
        for src in ("decode_attention.cu", "flash_attention.cu")],
    # drop the carried-state term exp(a_cum) C h_in of every query row; it
    # changes nothing when S <= chunk (the state carried in is zero)
    "drop_carried_state": [
        ("ssd_scan.cu",
         r"const float e = row < nq \? expf\(acum\[q0 \+ row\]\) : 0\.f;",
         "const float e = 0.f;")],
}


def log(msg: str = "") -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Device time of one ``fn()`` call: ``iters`` calls are captured in
    one CUDA graph, and CUDA events around its replay give the time of the
    back-to-back launches with no host work between them."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    return ms


def eager_ms(fn, iters: int, warmup: int = 3) -> float:
    """Time per call of ``fn()`` called eagerly back to back, from CUDA
    events: the device time, or the host's time to issue the call when
    the host is the slower of the two."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def tp_devices(tp: int = TP):
    """The ranks of a ``tp``-way pod: distinct cards when there are ``tp``
    of them, else every rank on the first card (or on ``DEVICE`` when it
    is the CPU)."""
    import torch
    if DEVICE == "cpu":
        return ["cpu"] * tp
    if torch.cuda.device_count() >= tp:
        return [f"cuda:{i}" for i in range(tp)]
    return ["cuda:0"] * tp


def synchronize_all() -> None:
    import torch
    if DEVICE != "cpu":
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def max_err(out, want, dtype_name: str, scaled: bool = False):
    """(max |out - want|, the largest share of the tolerance that an
    element uses: the check passes when it is at most 1).  ``out`` and
    ``want`` may be tuples of tensors; ``scaled`` takes atol relative to
    each output's largest |want| (the SSD scan)."""
    if isinstance(out, tuple):
        errs = [max_err(o, w, dtype_name, scaled) for o, w in zip(out, want)]
        return max(e[0] for e in errs), max(e[1] for e in errs)
    atol, rtol = TOL[dtype_name]
    if scaled:
        atol *= float(want.float().abs().max())
    diff = (out.float() - want.float()).abs()
    share = diff / (atol + rtol * want.float().abs())
    return float(diff.max()), float(share.max())


# --------------------------------------------------------------------------- #
# Phase 3: kernels against their plain versions
# --------------------------------------------------------------------------- #


def decode_case(B: int, dtype, gen):
    """flash_decode inputs at the served widths: the slot cache of
    ``MAX_LEN`` rows with ragged per-slot depths (1 and MAX_LEN included)."""
    import torch
    q = torch.randn((B, 1, HEADS, HEAD_DIM), generator=gen, device="cuda",
                    dtype=dtype)
    k = torch.randn((B, MAX_LEN, KV_HEADS, HEAD_DIM), generator=gen,
                    device="cuda", dtype=dtype)
    v = torch.randn((B, MAX_LEN, KV_HEADS, HEAD_DIM), generator=gen,
                    device="cuda", dtype=dtype)
    lens = [MAX_LEN] if B == 1 else [1, 200, 377, MAX_LEN][:B]
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, k, v, kv_len, kv_len - 1


def visible_keys(q_pos: int, kv_len: int, window) -> int:
    lo = 0 if window is None else max(q_pos - window + 1, 0)
    return max(min(kv_len, q_pos + 1) - lo, 0)


def bound(bytes_moved: float, flops: float, dtype_name: str):
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ssd_case(S: int, pad: int, dtype, gen):
    """ssd_scan inputs at mamba2-130m's widths (B=1): the model's
    ``x * dt``, ``a = dt * A``, B and C, with a trained Mamba2's long memory
    (dt in [1e-3, 0.1], A in [-16, -1]) so that the carried state and the
    far off-diagonal scores matter; the last ``pad`` positions are zero, as
    the model pads a prompt to a multiple of the chunk."""
    import math

    import torch
    shape = (1, S, SSM_HEADS)
    lo, hi = math.log(1e-3), math.log(0.1)
    dt = torch.exp(torch.rand(shape, generator=gen, device="cuda")
                   * (hi - lo) + lo)
    A = torch.rand((SSM_HEADS,), generator=gen, device="cuda") * 15 + 1
    x = torch.randn(shape + (SSM_HEAD_DIM,), generator=gen,
                    device="cuda") * dt[..., None]
    bm = torch.randn(shape + (SSM_STATE,), generator=gen, device="cuda") * 0.5
    cm = torch.randn(shape + (SSM_STATE,), generator=gen, device="cuda") * 0.5
    a = -dt * A
    if pad:
        for t in (x, a, bm, cm):
            t[:, S - pad:] = 0
    return x.to(dtype), a, bm.to(dtype), cm.to(dtype)


def ssd_work(S: int, chunk: int, es: int):
    """(bytes, flops) the scan needs at B=1 and mamba2-130m's widths: x, a,
    B, C read once, y and the final state written once; per head and chunk
    the causal scores (c(c+1)/2 pairs x 2N), their product with x (x 2P),
    and the carried-state term and state update (4cPN)."""
    H, P, N = SSM_HEADS, SSM_HEAD_DIM, SSM_STATE
    bytes_moved = (2 * S * H * P * es + 4 * S * H + 2 * S * H * N * es
                   + H * P * N * es)
    pairs = chunk * (chunk + 1) // 2
    flops = H * (S // chunk) * (2 * pairs * (N + P) + 4 * chunk * P * N)
    return bytes_moved, flops


def check_kernels(timed: bool = True):
    """Phase 3: every kernel against its plain version at the served
    shapes; with ``timed`` also the times of both and of the library call
    (where there is one).  Returns (rows, failures)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {"flash_decode": [], "flash_attention": [], "ssd_scan": [],
            "flash_decode_sharded": []}
    failures = []

    def record(name, row, run, plain, lib, iters, timed_fns=None,
               exact=False):
        """Check ``run()`` against ``plain()`` (and, with ``exact``, that
        ``row["bitwise"]`` holds); with ``timed``, time them (or the pair
        ``timed_fns`` in their place) and ``lib``."""
        out, want = run(), plain()
        synchronize_all()
        row["max_abs_err"], row["tol_share"] = max_err(
            out, want, row["dtype"], scaled=name == "ssd_scan")
        if exact and not row["bitwise"]:
            failures.append((name, "not bit for bit the single-device "
                             "kernel", row))
        t_run, t_plain = timed_fns or (run, plain)
        if timed:
            row.update(ms=cuda_ms(t_run, iters),
                       eager_ms=eager_ms(t_run, iters),
                       plain_ms=cuda_ms(t_plain, max(iters // 10, 5)),
                       library_ms=None if lib is None else cuda_ms(lib, iters))
        rows[name].append(row)
        if not row["tol_share"] <= 1.0:
            failures.append((name, row))

    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        es = dtype.itemsize
        for B in (1, 4):
            for window in (None, 64):
                q, k, v, kv_len, q_off = decode_case(B, dtype, gen)
                lens = kv_len.tolist()
                pos = torch.arange(MAX_LEN, device="cuda")
                keep = (pos[None] < kv_len[:, None]) & (pos[None] <= q_off[:, None])
                if window is not None:
                    keep &= pos[None] > q_off[:, None] - window
                mask = keep[:, None, None, :]
                qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
                n_keys = [visible_keys(l - 1, l, window) for l in lens]
                bytes_moved = (2 * q.numel() * es + 8 * B
                               + 2 * sum(n_keys) * KV_HEADS * HEAD_DIM * es)
                flops = 4 * HEADS * HEAD_DIM * sum(n_keys)
                b_ms, b_by = bound(bytes_moved, flops, dn)
                record("flash_decode", dict(
                    dtype=dn, B=B, L=MAX_LEN, kv_len=lens, window=window,
                    bound_ms=b_ms, bound_by=b_by),
                    lambda: ops.flash_decode(q, k, v, kv_len=kv_len,
                                             q_offset=q_off, window=window),
                    lambda: ref.flash_decode(q, k, v, kv_len=kv_len,
                                             q_offset=q_off, window=window),
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=mask, enable_gqa=True), 200)
                if B == 4 and window is None:
                    check_sharded(record, q, k, v, kv_len, q_off, n_keys,
                                  dn, es)
        for B in (1, 4):
            for S in (16, 128, 512):
                for window in (None, 64):
                    q = torch.randn((B, S, HEADS, HEAD_DIM), generator=gen,
                                    device="cuda", dtype=dtype)
                    k = torch.randn((B, S, KV_HEADS, HEAD_DIM), generator=gen,
                                    device="cuda", dtype=dtype)
                    v = torch.randn((B, S, KV_HEADS, HEAD_DIM), generator=gen,
                                    device="cuda", dtype=dtype)
                    qt, kt, vt = (x.transpose(1, 2).contiguous()
                                  for x in (q, k, v))
                    i = torch.arange(S, device="cuda")
                    m = (i[None] <= i[:, None]) & (
                        i[None] > i[:, None] - (window or S))
                    n_pairs = sum(visible_keys(p, S, window) for p in range(S))
                    bytes_moved = (2 * q.numel() + 2 * k.numel()) * es
                    flops = 4 * B * HEADS * HEAD_DIM * n_pairs
                    b_ms, b_by = bound(bytes_moved, flops, dn)
                    record("flash_attention", dict(
                        dtype=dn, B=B, S=S, window=window, bound_ms=b_ms,
                        bound_by=b_by),
                        lambda: ops.flash_attention(q, k, v, window=window),
                        lambda: ref.flash_attention(q, k, v, window=window),
                        (lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, is_causal=True, enable_gqa=True))
                        if window is None else
                        (lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, attn_mask=m, enable_gqa=True)), 50)
        # a one-chunk prompt (chunk = S = 137), two chunks (the carry), and
        # a 300-token prompt zero-padded to two 256-long chunks
        for S, chunk, pad in ((137, 137, 0), (512, 256, 0), (512, 256, 212)):
            x, a, bm, cm = ssd_case(S, pad, dtype, gen)
            b_ms, b_by = bound(*ssd_work(S, chunk, es), dn)
            record("ssd_scan", dict(dtype=dn, B=1, S=S, chunk=chunk, pad=pad,
                                    bound_ms=b_ms, bound_by=b_by),
                   lambda: ops.ssd_scan(x, a, bm, cm, chunk=chunk),
                   lambda: ref.ssd_scan(x, a, bm, cm, chunk=chunk), None, 20)
    for name, rs in rows.items():
        log(f"[kernels] {name}: kernel vs plain version on the card")
        for r in rs:
            atol, rtol = TOL[r["dtype"]]
            if name == "flash_decode_sharded":
                shape = (f"B={r['B']} L={r['L']} kv_len={r['kv_len']} "
                         f"{r['heads']} heads per rank x {r['tp']} ranks on "
                         f"one card, bitwise == single-device kernel: "
                         f"{r['bitwise']}; per call, all shards")
            elif name == "flash_decode":
                shape = (f"B={r['B']} L={r['L']} kv_len={r['kv_len']} "
                         f"window={r['window']}")
            elif name == "flash_attention":
                shape = f"B={r['B']} S={r['S']} window={r['window']}"
            else:
                shape = (f"B={r['B']} S={r['S']} chunk={r['chunk']} "
                         f"pad={r['pad']} H={SSM_HEADS} P={SSM_HEAD_DIM} "
                         f"N={SSM_STATE}")
            line = (f"  {r['dtype']:<8} {shape}: "
                    f"max_abs_err={r['max_abs_err']:.3e}, "
                    f"{r['tol_share']:.3f} of tol (atol {atol:g}"
                    f"{' x max|plain|' if name == 'ssd_scan' else ''} + rtol "
                    f"{rtol:g})")
            if timed:
                lib = ("no single PyTorch call" if r["library_ms"] is None
                       else f"sdpa {r['library_ms']:.4f} ms")
                line += (f"; kernel {r['ms']:.4f} ms (eager "
                         f"{r['eager_ms']:.4f}), plain {r['plain_ms']:.4f} "
                         f"ms, {lib}, bound {r['bound_ms']:.5f} ms "
                         f"({r['bound_by']})")
            log(line)
    return rows, failures


def check_sharded(record, q, k, v, kv_len, q_off, n_keys, dn, es):
    """``flash_decode_sharded`` at the shard shapes of a TP=2 and a TP=4 pod
    with all ranks on one card: the served decode inputs split into ``tp``
    contiguous query-head ranges, each with the KV heads it reads.  The
    stitched output must equal the single-device kernel bit for bit and lie
    within the tolerance of the plain version.  Times are per call, all
    shards: the wrapper, its plain version, and ``sdpa`` over the unsplit
    heads (one call computing the stitched function); the bound is that of
    the whole call (each shard reads its own KV heads' rows)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.launch.partition import kv_head_range

    heads = SimpleNamespace(n_heads=HEADS, n_kv_heads=KV_HEADS)
    keep = ((torch.arange(MAX_LEN, device=q.device)[None] < kv_len[:, None])
            [:, None, None, :])
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    for tp in (2, 4):
        ranges = [kv_head_range(heads, tp, r) for r in range(tp)]
        qs = [c.contiguous() for c in q.chunk(tp, dim=2)]
        ks, vs = ([x[:, :, lo:hi].contiguous() for lo, hi in ranges]
                  for x in (k, v))
        bitwise = bool(torch.equal(
            torch.cat(ops.flash_decode_sharded(qs, ks, vs, kv_len=kv_len,
                                               q_offset=q_off), dim=2),
            ops.flash_decode(q, k, v, kv_len=kv_len, q_offset=q_off)))
        kv_read = sum(hi - lo for lo, hi in ranges)
        bytes_moved = (2 * q.numel() * es + 8 * q.shape[0] * tp
                       + 2 * sum(n_keys) * kv_read * HEAD_DIM * es)
        b_ms, b_by = bound(bytes_moved, 4 * HEADS * HEAD_DIM * sum(n_keys),
                           dn)
        record("flash_decode_sharded", dict(
            dtype=dn, B=q.shape[0], L=MAX_LEN, kv_len=kv_len.tolist(), tp=tp,
            heads=f"{HEADS // tp}/{ranges[0][1] - ranges[0][0]}",
            bitwise=bitwise, bound_ms=b_ms, bound_by=b_by),
            lambda: torch.cat(ops.flash_decode_sharded(
                qs, ks, vs, kv_len=kv_len, q_offset=q_off), dim=2),
            lambda: torch.cat(ref.flash_decode_sharded(
                qs, ks, vs, kv_len=kv_len, q_offset=q_off), dim=2),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=keep, enable_gqa=True), 200,
            timed_fns=(lambda: ops.flash_decode_sharded(
                qs, ks, vs, kv_len=kv_len, q_offset=q_off),
                lambda: ref.flash_decode_sharded(
                    qs, ks, vs, kv_len=kv_len, q_offset=q_off)),
            exact=True)


# --------------------------------------------------------------------------- #
# Phase 4: the served path at full width
# --------------------------------------------------------------------------- #


def make_requests(n: int, seed: int, max_prompt: int = 200,
                  vocab: int = 8192):
    """``n`` requests: prompt ids in [8, vocab), prompt lengths
    8-``max_prompt``, true output lengths 8-64; half arrive at 0, half
    staggered."""
    import numpy as np

    from repro_torch.core import Request

    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.randint(8, max_prompt + 1))
        reqs.append(Request(
            prompt=f"request {i}",
            prompt_tokens=[int(t) for t in rng.randint(8, vocab, size=plen)],
            arrival_time=0.0 if i < n // 2 else 0.05 * (i - n // 2 + 1),
            request_id=i,
            true_output_len=int(rng.randint(8, 65))))
    return reqs


def tp_mesh(tp: int = TP):
    from repro_torch.launch import make_mesh
    return make_mesh((tp,), ("model",), devices=tp_devices(tp))


def serve(cfg, params, requests, *, attn_impl: str, mesh=None):
    """Drive the served path (serve.py's defaults) over ``requests`` on one
    engine (a TP pod with ``mesh``); returns (responses, executor, wall
    seconds)."""
    from repro_torch.core import (ElisServer, FrontendConfig,
                                  OraclePredictor, PreemptionConfig,
                                  SchedulerConfig)
    from repro_torch.engine import EngineConfig, EngineExecutor, InferenceEngine

    ecfg = EngineConfig(max_slots=4, max_len=MAX_LEN, max_output=32,
                        eos_id=-1, respect_job_max=True, attn_impl=attn_impl)
    engine = InferenceEngine(cfg, params, ecfg, device=DEVICE, mesh=mesh)
    executor = EngineExecutor({0: engine})
    server = ElisServer(
        FrontendConfig(
            n_nodes=1,
            scheduler=SchedulerConfig(policy="isrtf", window=8, batch_size=4),
            preemption=PreemptionConfig(enabled=True),
            observe_in_flight=False),
        OraclePredictor(), executor)
    for r in requests:
        server.submit(r)
    synchronize_all()
    t0 = time.perf_counter()
    responses = server.drain()
    synchronize_all()
    return responses, executor, time.perf_counter() - t0


def describe(cfg, mesh=None) -> str:
    if mesh is not None:
        return (f"{describe(cfg)}, tensor parallel over {len(mesh.ranks)} "
                f"ranks on "
                f"{', '.join(map(str, mesh.ranks))}"
                + (" (both ranks share one card: no interconnect is measured)"
                   if len(set(mesh.ranks)) == 1 else ""))
    if cfg.family == "ssm":
        s = cfg.ssm
        return (f"{cfg.arch_id}: {cfg.n_layers} layers, d_model "
                f"{cfg.d_model}, {cfg.ssm_n_heads} SSM heads of head dim "
                f"{s.head_dim}, d_state {s.d_state}, chunk {s.chunk_size}, "
                f"vocab {cfg.vocab_size}, {cfg.dtype}")
    return (f"{cfg.arch_id}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
            f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
            f"{cfg.vocab_size}, {cfg.dtype}")


def served_path(cfg, params, requests, mesh=None):
    """Serve ``requests`` through the kernel path (on one TP pod with
    ``mesh``) with every launch count set to 0 just before and read just
    after; check every request, and that the path's kernels ran as often
    as its dispatches say.  Returns the launch counts."""
    from repro_torch.core import summarize
    from repro_torch.kernels import ops

    ops.reset_launches()
    responses, executor, wall = serve(cfg, params, requests,
                                      attn_impl="kernel", mesh=mesh)
    launches = {name: fn.launches for name, fn in ops.KERNELS.items()}
    counters = executor.counters()
    want = {r.request_id: min(32, r.true_output_len) for r in requests}
    bad = [(r.request_id, r.status.value, r.n_tokens, want[r.request_id])
           for r in responses
           if not r.ok or r.n_tokens != want[r.request_id]]
    if len(responses) != len(requests) or bad:
        raise AssertionError(f"requests not served as expected: {bad}")
    if any(not 0 <= t < cfg.vocab_size for r in responses for t in r.tokens):
        raise AssertionError("a generated token lies outside the vocabulary")
    decode_steps = sum(rec["window"] for rec in executor.window_log)
    prefills = counters["prefill_dispatches"]
    tp = 1 if mesh is None else len(mesh.ranks)
    per = f"{cfg.n_layers} layers x " + (f"{tp} ranks x " if tp > 1 else "")
    if cfg.family == "ssm":
        want_launches = {"ssd_scan": (cfg.n_layers * prefills,
                                      f"{per}{prefills} prefill dispatches")}
    else:
        decode = "flash_decode" if mesh is None else "flash_decode_sharded"
        want_launches = {
            decode: (cfg.n_layers * tp * decode_steps,
                     f"{per}{decode_steps} decode steps"),
            "flash_attention": (cfg.n_layers * tp * prefills,
                                f"{per}{prefills} prefill dispatches")}
    for name in ops.KERNELS:
        if name not in want_launches and launches[name]:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 "on a path that does not run it")
    for name, (n, why) in want_launches.items():
        if launches[name] != n:
            raise AssertionError(f"{name} launched {launches[name]} times, "
                                 f"want {n} = {why}")
        if n <= 0:
            raise AssertionError(f"{name} was never launched on the path")
    n_tok = sum(r.n_tokens for r in responses)
    m = summarize(responses)
    log(f"[serve] {describe(cfg, mesh)}")
    log(f"[serve] {len(responses)}/{len(requests)} requests FINISHED with "
        f"the expected token counts; {n_tok} tokens in {wall:.3f} s wall = "
        f"{n_tok / wall:.1f} tokens/s; JCT mean {m['jct_mean']:.3f} s, p99 "
        f"{m['jct_p99']:.3f} s; queueing delay mean "
        f"{m['queuing_delay_mean']:.3f} s; TTFT mean {m['ttft_mean']:.3f} s; "
        f"preemptions {m['preemptions']}")
    log("[serve] launches: " + "; ".join(
        f"{name} {launches[name]} = {why}"
        for name, (_, why) in want_launches.items())
        + f" (all counts: {json.dumps(launches)})")
    log(f"[serve] engine counters: {json.dumps(counters)}")
    return launches


def profile_window(cfg, params, requests, mesh=None) -> None:
    """Where a steady decode window's time goes: one window of 8 steps at 4
    live slots under ``torch.profiler``; device busy time is the sum of the
    kernels' durations (one stream per card, so they do not overlap on one
    card; with ranks on two cards it is summed over both)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import Job
    from repro_torch.engine import EngineConfig, InferenceEngine

    eng = InferenceEngine(cfg, params, EngineConfig(
        max_slots=4, max_len=MAX_LEN, max_output=64, eos_id=-1),
        device=DEVICE, mesh=mesh)
    jobs = [Job(job_id=r.request_id, prompt="",
                prompt_tokens=list(r.prompt_tokens), arrival_time=0.0)
            for r in requests[:4]]
    eng.run_window(jobs, 8)  # prefill, and a first window as warm-up
    synchronize_all()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run_window(jobs, 8)
        synchronize_all()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values()) / 1e3
    cards = 1 if mesh is None else len(set(mesh.ranks))
    log(f"[profile] {cfg.arch_id}"
        f"{'' if mesh is None else f' TP={len(mesh.ranks)} on {cards} card(s)'}"
        ": one "
        f"decode window (8 steps, 4 slots, "
        f"{cfg.n_layers} layers) under torch.profiler: wall "
        f"{wall * 1e3:.2f} ms, device "
        f"busy {busy:.2f} ms ({100 * busy / (wall * 1e3):.1f}%), "
        f"{len(by_name)} kernel names")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile]   {us / 1e3:8.3f} ms {100 * us / 1e3 / busy:5.1f}% "
            f"of busy  {name[:90]}")


# --------------------------------------------------------------------------- #
# Phase 5: kernel path against plain path
# --------------------------------------------------------------------------- #


def greedy_streams(cfg, params, prompts, attn_impl: str, n_out: int,
                   mesh=None):
    """Serve ``prompts`` on one engine (a TP pod with ``mesh``) with a
    fixed schedule: each window runs the (at most 4) unfinished jobs with
    the fewest tokens, evicting the others, so jobs are preempted and
    re-admitted by recompute."""
    from repro_torch.core import Job
    from repro_torch.engine import EngineConfig, InferenceEngine

    eng = InferenceEngine(cfg, params, EngineConfig(
        max_slots=4, max_len=MAX_LEN, max_output=n_out, eos_id=-1,
        attn_impl=attn_impl), device=DEVICE, mesh=mesh)
    jobs = [Job(job_id=i, prompt="", prompt_tokens=p, arrival_time=0.0)
            for i, p in enumerate(prompts)]
    evictions = 0
    while True:
        live = [j for j in jobs if len(j.generated) < n_out]
        if not live:
            break
        batch = sorted(live, key=lambda j: (len(j.generated), j.job_id))[:4]
        for j in jobs:
            if eng.has_job(j.job_id) and j not in batch:
                eng.evict_job(j.job_id)
                evictions += 1
        toks, _ = eng.run_window(batch, 8)
        for j, t in zip(batch, toks):
            j.generated.extend(t)
    return [list(j.generated) for j in jobs], evictions


def greedy_parity(cfg, requests, meshes=()) -> bool:
    """fp32 greedy tokens of the kernel and plain engines at full width and
    2 layers, through evictions and recompute resumes: identical (and at
    least one eviction)?  With ``meshes``, the kernel engine of each TP pod
    against the single-device kernel engine, and the first pod's against
    the plain engine too."""
    import torch

    from repro_torch.models import transformer as T

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    params2 = T.init_params(
        cfg2, torch.Generator(device=DEVICE).manual_seed(SEED + 1))
    prompts = [list(r.prompt_tokens) for r in requests[:6]]
    runs = {"kernel engine": ("kernel", None), "plain engine": ("torch", None)}
    pairs = [] if meshes else [("kernel engine", "plain engine")]
    for m in meshes:
        name = f"TP={len(m.ranks)} kernel engine"
        runs[name] = ("kernel", m)
        pairs.append((name, "kernel engine"))
    if meshes:
        pairs.insert(1, (pairs[0][0], "plain engine"))
    streams = {name: greedy_streams(cfg2, params2, prompts, impl, 24, m)
               for name, (impl, m) in runs.items()}
    ok = True
    for name, other in pairs:
        (got, evictions), (want, _) = streams[name], streams[other]
        same = sum(a == b for g, w in zip(got, want) for a, b in zip(g, w))
        total = sum(len(w) for w in want)
        log(f"[parity] {cfg.arch_id} fp32, full width, 2 layers: {name} vs "
            f"{other} greedy tokens identical on {same}/{total} tokens of "
            f"{len(prompts)} requests ({evictions} evictions + recompute "
            f"resumes)")
        ok &= got == want and evictions > 0
    return ok


def prefill_logit_gap(cfg, params_bf16, requests, mesh=None):
    """max |kernel - plain| of the first prefill logits at full width and
    depth in bf16; with ``mesh``, max |TP kernel - single-device kernel|.
    Returns (gap, whether the kernel's logits are finite)."""
    import numpy as np
    import torch

    from repro_torch.launch import shard_params
    from repro_torch.models import transformer as T

    toks = np.zeros((4, 256), np.int32)
    last = np.zeros((4,), np.int32)
    for i, r in enumerate(requests[:4]):
        toks[i, : len(r.prompt_tokens)] = r.prompt_tokens
        last[i] = len(r.prompt_tokens) - 1
    runs = {"kernel": ("kernel", None), "plain": ("torch", None)}
    if mesh is not None:
        runs = {f"TP={len(mesh.ranks)} kernel": ("kernel", mesh),
                "kernel": runs["kernel"]}
    logits = {}
    for name, (impl, m) in runs.items():
        params = params_bf16 if m is None else shard_params(params_bf16, cfg,
                                                            m)
        out, _ = T.prefill(params, cfg,
                           {"tokens": torch.as_tensor(toks, device=DEVICE)},
                           T.init_cache(cfg, 4, MAX_LEN, DEVICE, mesh=m),
                           attn_impl=impl,
                           last_index=torch.as_tensor(last, device=DEVICE),
                           mesh=m)
        logits[name] = out.float()
        del params
    (got_name, got), (want_name, want) = logits.items()
    gap = float((got - want).abs().max())
    scale = float(want.abs().max())
    finite = bool(torch.isfinite(got).all())
    tol = LOGIT_TOL_BF16 if mesh is None else TP_LOGIT_TOL_BF16
    log(f"[parity] {cfg.arch_id} bf16, full width and depth: first prefill "
        f"logits {tuple(got.shape)}, max |{got_name} - {want_name}| = "
        f"{gap:.4e} (tol {tol}), max |logit| = {scale:.3f}, finite={finite}")
    return gap, finite


def ssm_prefill_logit_gaps(cfg, params_bf16, requests):
    """The SSM family prefills each prompt alone at its exact length: for
    the two longest prompts (two chunks) and the two shortest (one chunk),
    max |kernel - x| of the first prefill logits at full width and depth in
    bf16, where x is the plain engine ("plain") and the same model with the
    kernel swapped for its plain version on the kernel's own inputs
    ("plain_scan").  Returns (gaps, whether the kernel's logits are
    finite)."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer as T

    by_len = sorted(requests, key=lambda r: len(r.prompt_tokens))
    prompts = [r.prompt_tokens for r in by_len[:2] + by_len[-2:]]

    def first_logits(prompt, impl):
        out, _ = T.prefill(params_bf16, cfg,
                           {"tokens": torch.as_tensor([prompt],
                                                      device=DEVICE)},
                           T.init_cache(cfg, 1, MAX_LEN, DEVICE),
                           attn_impl=impl)
        return out.float()

    gaps = {"plain": 0.0, "plain_scan": 0.0}
    finite, scale = True, 0.0
    kernel = ops.ssd_scan
    for prompt in prompts:
        got = first_logits(prompt, "kernel")
        finite &= bool(torch.isfinite(got).all())
        scale = max(scale, float(got.abs().max()))
        gaps["plain"] = max(gaps["plain"], float(
            (got - first_logits(prompt, "torch")).abs().max()))
        ops.ssd_scan = ref.ssd_scan  # the model calls ops.ssd_scan
        try:
            want = first_logits(prompt, "kernel")
        finally:
            ops.ssd_scan = kernel
        gaps["plain_scan"] = max(gaps["plain_scan"], float(
            (got - want).abs().max()))
    log(f"[parity] {cfg.arch_id} bf16, full width and depth: first prefill "
        f"logits of prompts of {[len(p) for p in prompts]} tokens, max "
        f"|kernel - plain engine| = {gaps['plain']:.4e}, max |kernel - "
        f"plain scan on the kernel's inputs| = {gaps['plain_scan']:.4e} "
        f"(tol {SSM_LOGIT_TOL_BF16}), max |logit| = {scale:.3f}, "
        f"finite={finite}")
    return gaps, finite


def planted_fault(kind: str, models) -> dict:
    """Build the kernels from a temporary copy of ``csrc`` carrying the
    fault ``kind`` and run every comparison of phases 3 and 5 against it,
    for each (cfg, params, requests) of ``models``; returns how many of
    them caught the fault."""
    import tempfile

    from repro_torch.kernels import build

    work = Path(tempfile.mkdtemp(prefix="planted-fault-"))
    saved = build.CSRC, build.BUILD_DIR
    try:
        shutil.copytree(build.CSRC, work / "csrc")
        for src, pattern, repl in PLANTED_FAULTS[kind]:
            path = work / "csrc" / src
            text, n = re.subn(pattern, repl, path.read_text())
            if n == 0:
                raise AssertionError(f"{kind}: nothing to change in {src}")
            path.write_text(text)
        build.CSRC, build.BUILD_DIR = work / "csrc", work / "build"
        build._loaded.clear()
        build.build_all()
        log(f"[fault] {kind}: kernels built from a faulty copy of csrc")
        rows, failures = check_kernels(timed=False)
        caught = {}
        for name, rr in rows.items():
            for dn in TOL:
                rs = [r for r in rr if r["dtype"] == dn]
                caught[f"{name} {dn}"] = {
                    "caught": sum(not r["tol_share"] <= 1.0 for r in rs),
                    "cases": len(rs),
                    "tol_shares": [r["tol_share"] for r in rs]}
        served = {}
        for cfg, params, requests in models:
            greedy_same = greedy_parity(cfg, requests)
            if cfg.family == "ssm":
                gaps, finite = ssm_prefill_logit_gaps(cfg, params, requests)
                gap, tol = gaps["plain_scan"], SSM_LOGIT_TOL_BF16
            else:
                gap, finite = prefill_logit_gap(cfg, params, requests)
                gaps, tol = {"plain": gap}, LOGIT_TOL_BF16
            served[cfg.arch_id] = {
                "greedy_fp32_caught": not greedy_same,
                "logit_gaps_bf16": gaps, "logit_tol_bf16": tol,
                "logit_caught": not (finite and gap <= tol)}
    finally:
        build.CSRC, build.BUILD_DIR = saved
        build._loaded.clear()
        shutil.rmtree(work, ignore_errors=True)
    return {"planted_fault": kind, "kernel_checks": caught, **served}


def tp_planted_fault(cfg, params, requests) -> dict:
    """``drop_rank_partial``: leave the last rank's attention output (its
    ``wo`` partial) out of every layer's sum in the TP model, in prefill and
    decode, and run phase 5's TP=2 comparisons against it; returns whether
    each caught the fault."""
    import itertools

    import torch

    from repro_torch.models import layers as L

    block, decode = L.attention_block, L.attention_decode
    calls = itertools.count()

    def faulty_block(p, lcfg, *args, **kw):
        out, kv = block(p, lcfg, *args, **kw)
        # the TP prefill calls each layer's ranks in order
        if lcfg.n_heads < cfg.n_heads and next(calls) % TP == TP - 1:
            out = torch.zeros_like(out)
        return out, kv

    def faulty_decode(*args, **kw):
        outs = decode(*args, **kw)
        if len(outs) > 1:
            outs[-1] = torch.zeros_like(outs[-1])
        return outs

    L.attention_block, L.attention_decode = faulty_block, faulty_decode
    try:
        greedy_same = greedy_parity(cfg, requests, (tp_mesh(),))
        gap, finite = prefill_logit_gap(cfg, params, requests, tp_mesh())
    finally:
        L.attention_block, L.attention_decode = block, decode
    return {"planted_fault": "drop_rank_partial",
            "greedy_fp32_caught": not greedy_same,
            "logit_gap_bf16": gap, "logit_tol_bf16": TP_LOGIT_TOL_BF16,
            "logit_caught": not (finite and gap <= TP_LOGIT_TOL_BF16)}


def window_bench(cfg, params, n: int) -> None:
    """Host wall time of ``n`` steady decode windows (8 steps, 4 live
    slots) of the single-device kernel engine, devices synchronised around
    each, after one warm-up window: the time of the served dense path's
    Python body.  Runs unchanged against an older checkout of ``src`` (copy
    this script into its root), to compare two versions in one call."""
    import statistics

    from repro_torch.core import Job
    from repro_torch.engine import EngineConfig, InferenceEngine

    eng = InferenceEngine(cfg, params, EngineConfig(
        max_slots=4, max_len=MAX_LEN, max_output=8 * (n + 1), eos_id=-1),
        device=DEVICE)
    jobs = [Job(job_id=i, prompt="", prompt_tokens=list(range(8, 8 + plen)),
                arrival_time=0.0) for i, plen in enumerate((40, 90, 140, 190))]
    eng.run_window(jobs, 8)
    walls = []
    for _ in range(n):
        synchronize_all()
        t0 = time.perf_counter()
        eng.run_window(jobs, 8)
        synchronize_all()
        walls.append((time.perf_counter() - t0) * 1e3)
    log(json.dumps({"window_bench": str(ROOT), "windows": n, "steps": 8,
                    "slots": 4, "median_ms": statistics.median(walls),
                    "min_ms": min(walls), "ms": walls}))


# --------------------------------------------------------------------------- #


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--planted-fault", nargs="+",
                    choices=sorted(PLANTED_FAULTS) + ["drop_rank_partial"],
                    help="check the checks against these deliberate "
                         "kernel (or TP) faults instead of running the "
                         "smoke")
    ap.add_argument("--window-bench", type=int, metavar="N",
                    help="time N decode windows of the dense cell's engine "
                         "instead of running the smoke")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script needs an NVIDIA card")
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    log(f"[device] {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; nvidia-smi name, power.limit: {smi}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    models = [(get_config("qwen2-1.5b"), make_requests(12, SEED)),
              (get_config("mamba2-130m"),
               make_requests(12, SEED, max_prompt=400, vocab=50280))]

    def random_params(cfg):
        t0 = time.perf_counter()
        params = T.init_params(cfg, torch.Generator(device="cuda")
                               .manual_seed(SEED))
        torch.cuda.synchronize()
        log(f"[serve] {cfg.arch_id}: random {cfg.dtype} weights from seed "
            f"{SEED} in {time.perf_counter() - t0:.1f} s")
        return params

    if args.window_bench:
        build.build_all()
        window_bench(models[0][0], random_params(models[0][0]),
                     args.window_bench)
        return
    if args.planted_fault:
        with_params = [(cfg, random_params(cfg), reqs) for cfg, reqs in models]
        for kind in args.planted_fault:
            result = (tp_planted_fault(*with_params[0])
                      if kind == "drop_rank_partial"
                      else planted_fault(kind, with_params))
            print(json.dumps(result), flush=True)
        return

    t0 = time.perf_counter()
    build.build_all()
    log(f"[build] {', '.join(f'csrc/{n}.cu' for n in build.SOURCES)} -> "
        f"{build.BUILD_DIR.name}/ in {time.perf_counter() - t0:.1f} s")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    rows, failures = check_kernels()
    if failures:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{failures}")

    launches = {}
    # the served cells: each model on one engine, then qwen2-1.5b on one
    # tensor-parallel pod
    cells = [(cfg, requests, None) for cfg, requests in models]
    cells.append((models[0][0], models[0][1], tp_mesh()))
    for cfg, requests, mesh in cells:
        name = cfg.arch_id + ("" if mesh is None else f" TP={TP}")
        params = random_params(cfg)
        path = served_path(cfg, params, requests, mesh)
        for n, c in path.items():
            if c:
                launches.setdefault(n, c)
        profile_window(cfg, params, requests, mesh)
        if not greedy_parity(cfg, requests,
                             () if mesh is None else (mesh, tp_mesh(4))):
            raise AssertionError(f"{name}: fp32 greedy tokens differ "
                                 "between the kernel and plain engines, or "
                                 "no eviction was driven")
        if cfg.family == "ssm":
            gaps, finite = ssm_prefill_logit_gaps(cfg, params, requests)
            gap, tol = gaps["plain_scan"], SSM_LOGIT_TOL_BF16
        else:
            gap, finite = prefill_logit_gap(cfg, params, requests, mesh)
            tol = LOGIT_TOL_BF16 if mesh is None else TP_LOGIT_TOL_BF16
        if not finite or not gap <= tol:
            raise AssertionError(f"{name}: bf16 prefill logits disagree "
                                 "with the reference path")
        del params
        torch.cuda.empty_cache()

    served = {"flash_decode": dict(dtype="bfloat16", B=4, window=None),
              "flash_attention": dict(dtype="bfloat16", B=4, S=512,
                                      window=None),
              "ssd_scan": dict(dtype="bfloat16", S=512, chunk=256, pad=0),
              "flash_decode_sharded": dict(dtype="bfloat16", B=4, tp=TP)}
    meta = {
        "flash_decode_sharded": ("src/repro_torch/csrc/decode_attention.cu",
                                 "src/repro/kernels/decode_attention.py:244"),
        "flash_decode": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:35"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:28"),
        "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssm_scan.py:25"),
    }
    kernels = []
    for name, key in served.items():
        r = next(r for r in rows[name]
                 if all(r[k] == v for k, v in key.items()))
        kernels.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
