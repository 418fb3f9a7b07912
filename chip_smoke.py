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
     single-device kernel; the int8 decode (``flash_decode_int8``) at the
     served shape, at other head dims, group sizes and windows, and at one
     layer of the decode_32k cache (B=128, L=32768); the three decode
     wrappers also over a long, ragged cache (B=8, L=32768, kv_len 0 to
     L + 1), each row with the number of key splits its launch used;
     bf16 ``flash_attention`` also over one prompt of 32768 tokens and one
     layer of the prefill_32k shape (B=32 x 32768), checked on three
     slices of 256 query rows; each ``flash_attention`` row names the body
     of the kernel that ran, as the library's launcher recorded it (bf16:
     tensor-core, fp32: CUDA-core); ``ssd_scan`` at one and two chunks and
     a padded prompt, and in bf16 also one prompt of 8192 and one of 32768
     tokens (32 and 128 chunks), each row with the body that ran and the
     kernels the call launched (bf16: 2 or 3 tensor-core passes, fp32: 1),
     and one bf16 call of 32768 tokens profiled, its device time by pass;
  4. the served paths at full width: ``ElisServer`` -> ISRTF with the
     oracle predictor -> ``EngineExecutor`` ->
     ``InferenceEngine(attn_impl="kernel")`` serving a dozen requests to
     qwen2-1.5b (28 layers), then to mamba2-130m (24 layers), then to
     qwen2-1.5b on one tensor-parallel pod of 2 ranks (``dense-tp2``: on
     two cards when there are two, else both ranks on ``cuda:0``), bf16,
     random weights from a seed; each path's kernel launch counts are set
     to 0 just before it and read just after; one decode window of each is
     then profiled (device busy share, kernels); then the step entry points
     (``launch.steps``) of qwen2-1.5b over ``launch.shapes.input_specs``
     int8 caches: prefill and 32 serve steps over a 4 x 512 cache (launch
     counts reset before and read after), one step over the long_500k ring
     (no kernel), and last, after every earlier tensor is freed, 6 steps at
     decode_32k (B=128 over 32768 rows: a 61 GB int8 cache);
  5. kernel path against plain path, per model: identical greedy tokens at
     full width with 2 layers in fp32 through evictions and recompute
     resumes, and agreeing first prefill logits at full width and depth in
     bf16; for ``dense-tp2``, the TP kernel engine against the
     single-device kernel engine and the plain engine, and a TP=4 kernel
     engine (each rank holding the one KV head it reads) against the
     single-device kernel engine (fp32 tokens), and the TP=2 kernel model
     against the single-device kernel model (bf16 logits); for the int8
     step path, identical fp32 greedy tokens and agreeing bf16 decode
     logits;
  6. the serve CLI (``python -m repro_torch.launch.serve``, run in this
     process through ``main``) at full width, qwen2-1.5b in bf16 with 28
     layers: serve.py's defaults with ``--n 12``; then traffic that queues
     and preempts (``CLI_QUEUE``: 4 slots, 24 requests at 4 req/s, outputs
     up to 128 tokens) under ISRTF and FCFS on the same arrivals, in the
     order isrtf, fcfs, fcfs, isrtf (mean JCT of each, the ISRTF/FCFS
     ratio, preemptions, tokens/s); then the ISRTF run with
     ``--prefill-chunk 8 --preempt-policy swap``, and with
     ``--preempt-policy auto --probe-nodes 2``.  Every request must finish
     with ``min(true_output_len, max_output)`` tokens, ISRTF must preempt,
     the swap run must swap out, swap in and run prefill chunks, and each
     run's ``flash_attention`` and ``flash_decode`` launch counts (set to 0
     before it, read after) must be the engine's one-shot prefills and
     decode steps times 28 layers.  Beside it, one slot's cache is
     offloaded to the host and restored bit for bit at full width, its
     greedy stream equal to a resident engine's, and chunked prefill gives
     the fp32 greedy tokens of one-shot prefill at full width and 2
     layers;
  7. the BGE length predictor (``repro_torch.core.predictor``, fp32, no
     kernel of its own): a two-head predictor of full width (``BGE_BASE``,
     bge-base-en-v1.5, under two 8 x 1024 heads) against a CPU copy of
     its parameters on a pool of 5 (and each job alone: padding is inert;
     ids past the vocabulary), dispatch times for pools of 1, 8, 32 and
     128 at sequence bucket 512 against their flop bounds and for the
     CLI's small predictor at 32, 20 ``fit`` steps at 32 x 512 and one
     step against the CPU copy, then the CLI's predictor trained by
     ``examples/train_predictor.py``'s recipe (Table 2's metrics before and
     after) and checkpointed; then ISRTF served over ``CLI_QUEUE`` ranked
     by each: (a) the CLI with ``--predictor bge --predictor-ckpt
     --calibrate ema+conformal``, (b) an ``ElisServer`` ordered by the
     full-width predictor's ranking head (``RankedPredictor`` under
     ``ema+conformal``, online head updates).  Each run must finish every
     request with its expected token count, with predictor dispatches, at
     most ``n_shape_buckets`` distinct dispatch shapes, kernel launches as
     the engine's dispatches say, and (b) at least one online update; it
     prints the predictor's device time per dispatch and its share of the
     serving wall time.
The last lines are a JSON object of per-kernel numbers, the card's name and
power limit as ``nvidia-smi`` reports them, and the result line.
Needs one CUDA card; imports neither JAX nor the JAX package.

    python3 chip_smoke.py --planted-fault drop_first_tile

checks the checks instead: it builds the kernels from a copy of ``csrc``
with one deliberate fault (``PLANTED_FAULTS``) in a temporary directory,
runs phase 3's comparisons and phase 5's comparisons (the int8 ones too)
against it, and prints how many of them caught the fault
(``drop_v_scale``: the int8 decode ignores V's scales;
``combine_no_rescale``: the decode's combine pass sums the splits'
partial states without rescaling them to a common maximum;
``p_in_bf16``: the bf16 prefill multiplies P rounded to bf16 by V, as
library kernels do, and not its hi/lo split; ``ssd_operands_in_bf16``:
the bf16 SSD passes do the same with their three fp32 operands;
``carry_no_decay``: the SSD carry pass does not decay the carried state;
``drop_carried_state``: the SSD scan drops the carried-state term of its
outputs, in both bodies); ``drop_rank_partial`` instead
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
import gc
import json
import math
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
#: H100 the correct kernels gave a gap of 0.043 (|logit| <= 3.6) with the
#: CUDA-core prefill and 0.047 with the tensor-core one, one-ulp
#: differences carried through 28 layers; ``drop_first_tile`` gave 5.06
#: and 4.86.  ``bf16_accumulate`` gave 0.137 while the prefill rounded its
#: accumulator after every key, and 0.049 since it rounds after every
#: 64-key tile: the kernel rows of phase 3 catch it now, this gap does
#: not.  The limit lies between the correct reading and ``drop_first_tile``.
LOGIT_TOL_BF16 = 0.1
#: bf16 full-depth prefill logits of mamba2-130m: the kernel engine against
#: the same model with the kernel swapped for its plain version on the
#: kernel's own inputs.  The plain engine is no yardstick here: it casts
#: ``a`` to bf16 before its scan (as the reference's plain path does), so
#: it computes another function, and on an H100 it differed from the
#: correct kernel by 0.094 and from the ``drop_carried_state`` fault by
#: 0.090 (|logit| <= 2.6).  Against the plain scan, on an H100: the
#: correct kernel 0, ``drop_carried_state`` 0.047 and
#: ``ssd_operands_in_bf16`` 0.076; the limit lies between them.  A
#: tensor-core body whose fp32 operands were split in two bf16 parts and
#: whose diagonal term was summed on the tensor cores gave 0.047 too: with
#: these random weights y is nearly its diagonal term, and summed in
#: another order than the plain version's it flips y's rounding often
#: enough for 24 layers to carry it to the logits (ssd_scan.cu,
#: "Precision").
SSM_LOGIT_TOL_BF16 = 0.02
#: bf16 full-depth prefill logits of qwen2-1.5b, the TP=2 kernel model
#: against the single-device kernel model.  They differ where the TP model
#: rounds each rank's row-parallel partial to bf16 before the sum (twice a
#: layer, 28 layers).  On an H100 (both ranks on one card) the correct
#: model gave 0.051 (|logit| <= 3.5), and the planted ``drop_rank_partial``
#: (one rank's attention output left out of every layer's sum) gave 4.98;
#: the limit lies between them.  fp32 greedy identity caught that fault too.
TP_LOGIT_TOL_BF16 = 0.1
#: bf16 logits of the first decode step after prefill over an int8 cache
#: (full width and depth): the kernel path (dequantize in fp32) against the
#: plain path (dequantize to bf16, then sdpa, as the reference reads it).
#: On an H100 the correct kernel gave 0.047 (|logit| <= 4.1), and the
#: planted ``drop_v_scale`` 1.38; the limit lies between them.
INT8_LOGIT_TOL_BF16 = 0.1
#: ranks of the tensor-parallel cell
TP = 2
#: one-line faults for ``--planted-fault``: (source, regex, replacement)
PLANTED_FAULTS = {
    # the int8 decode ignores V's scales (V read as its raw codes)
    "drop_v_scale": [
        ("decode_attention.cu",
         r"(vv\[u\]\[i\] = vv\[u\]\[i\]) \* sv;", r"\1;")],
    # skip the oldest key tile of every row that sees more than one tile
    # (in the decode kernel: its scores masked in the split that holds it;
    # in the prefill kernel: the block's first tile, 32 keys in the fp32
    # body and 64 in the bf16 tensor-core body)
    "drop_first_tile": [
        ("decode_attention.cu",
         r"const bool valid = t0 \+ lane < t_end;",
         "const bool valid = t0 + lane < t_end && "
         "!(t0 == lo && hi - lo > kTile);"),
        ("flash_attention.cu",
         r"for \(int t0 = lo; t0 < hi; t0 \+= kTile\)",
         "for (int t0 = hi - lo > kTile ? lo + kTile : lo; t0 < hi; "
         "t0 += kTile)"),
        ("flash_attention.cu",
         r"const int first = lo;",
         "const int first = hi - lo > kKeys ? lo + kKeys : lo;")],
    # round the output accumulator to the input dtype after every key (a
    # no-op in the fp32 prefill body); in the bf16 tensor-core prefill
    # body, round the O accumulator fragments to bf16 after each tile's P V
    "bf16_accumulate": [
        (src,
         r"(acc\[[hr]\]\[i\]) \+= "
         r"(pj \* (?:vv\[u\]\[i\]|vs\[j \* D \+ lane \+ 32 \* i\]));",
         r"\1 = to_f(from_f<T>(\1 + \2));")
        for src in ("decode_attention.cu", "flash_attention.cu")] + [
        ("flash_attention.cu",
         r"(pv_tile<D, MT>\(o, s, kt \+ kKeys \* RS, lane\);)",
         r"\1 for (auto& om : o) for (auto& oc : om) for (float& x : oc) "
         r"x = __bfloat162float(__float2bfloat16(x));")],
    # the bf16 prefill's P V with P rounded to bf16, as library kernels
    # multiply it: only the hi part of the hi/lo split, the lo mmas dropped
    "p_in_bf16": [
        ("flash_attention.cu",
         r"\n *mma_bf16\(o\[mt\]\[c(?: \+ 1)?\], pl\[mt\], vf\[[02]\], "
         r"vf\[[13]\]\);", "")],
    # the decode's combine pass sums the splits' partial states without
    # rescaling each by exp(m_s - M)
    "combine_no_rescale": [
        ("decode_attention.cu",
         r"const float e_s = expf\(ml\[2 \* s\] - M\);",
         "const float e_s = 1.f;")],
    # drop the carried-state term exp(a_cum) C h_in of every query row, in
    # the fp32 body and in the bf16 output pass; it changes nothing when S
    # <= chunk (the state carried in is zero)
    "drop_carried_state": [
        ("ssd_scan.cu",
         r"const float e = row < nq \? expf\(acum\[q0 \+ row\]\) : 0\.f;",
         "const float e = 0.f;"),
        ("ssd_scan.cu",
         r"const float e_a = in_a \? expf\(ac_a\) : 0\.f, "
         r"e_b = in_b \? expf\(ac_b\) : 0\.f;",
         "const float e_a = 0.f, e_b = 0.f;")],
    # the bf16 SSD passes multiply their fp32 operands (x o decay, h_in and
    # the masked scores) rounded to bf16: the hi parts alone, the mid and
    # lo mmas dropped
    "ssd_operands_in_bf16": [
        ("ssd_scan.cu", r"\n *mma_bf16\([^;\n]*_(?:mid|lo)\b[^;\n]*\);", "")],
    # the bf16 carry pass adds each chunk's state to the carried one without
    # decaying the carried one by exp(a_cum[-1])
    "carry_no_decay": [
        ("ssd_scan.cu", r"hc\[j\] = hc\[j\] \* ez \+ sv\[j\];",
         "hc[j] = hc[j] + sv[j];")],
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


#: the long, ragged decode cases of phase 3: B slots over L rows (16 splits
#: of 2048 on an H100), kv_len 0, 1, within one tile, just past it, inside
#: a split, just past a split edge, L - 1 and L + 1; with and without a
#: window whose lower edge falls inside a split
LONG_B, LONG_L = 8, 32768
LONG_KV_LEN = [0, 1, 31, 33, 1000, 16385, 32767, 32769]
LONG_WINDOW = 3000


def long_decode_case(dtype, gen):
    """flash_decode inputs at the served widths over the long, ragged
    cache (``LONG_B`` x ``LONG_L``, ``LONG_KV_LEN``)."""
    import torch
    q = torch.randn((LONG_B, 1, HEADS, HEAD_DIM), generator=gen,
                    device="cuda", dtype=dtype)
    k, v = (torch.randn((LONG_B, LONG_L, KV_HEADS, HEAD_DIM), generator=gen,
                        device="cuda", dtype=dtype) for _ in range(2))
    kv_len = torch.tensor(LONG_KV_LEN, dtype=torch.int32, device="cuda")
    return q, k, v, kv_len, (kv_len - 1).clamp(0, LONG_L)


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


#: the SSD rows of phase 3, (S, chunk, pad), B=1 at mamba2-130m's widths: a
#: one-chunk prompt (chunk = S = 137), two chunks (the carry), a 300-token
#: prompt zero-padded to two 256-long chunks (the served bf16 row is the
#: second); in bf16 also two long prompts of 32 and 128 chunks
SSD_ROWS = [(137, 137, 0), (512, 256, 0), (512, 256, 212)]
SSD_LONG_ROWS = [(8192, 256, 0), (32768, 256, 0)]
#: the body of ``ssd_scan.cu`` each dtype must run
SSD_BODY = {"bfloat16": "tensor-core", "float32": "CUDA-core"}


def ssd_kernels(dtype_name: str, n_chunks: int) -> int:
    """Kernels one ``ssd_scan`` call launches: the fp32 body one; the bf16
    passes three (chunk states, carry, outputs), two for one chunk."""
    if dtype_name == "float32":
        return 1
    return 2 if n_chunks == 1 else 3


def ssd_launch():
    """(body, kernels) of the last ``ssd_scan`` launch, as the library
    recorded them."""
    from repro_torch.kernels import build

    body = build.load("ssd_scan_last_body")()
    if body not in (0, 1):
        raise AssertionError(f"ssd_scan: no body recorded ({body})")
    return (SSD_BODY["float32"] if body == 0 else SSD_BODY["bfloat16"],
            build.load("ssd_scan_last_kernels")())


def check_ssd(record, gen, dtype, timed) -> None:
    """``ssd_scan`` at the ``SSD_ROWS`` (and, in bf16, ``SSD_LONG_ROWS``)
    against its plain version, with ``ssd_case``'s long-memory inputs and
    ``ssd_work``'s bound; with ``timed``, one bf16 call of the longest row
    is also profiled, so its time splits by pass."""
    import torch

    from repro_torch.kernels import ops, ref

    dn = str(dtype).split(".")[1]
    long_rows = SSD_LONG_ROWS if dtype == torch.bfloat16 else []
    for S, chunk, pad in SSD_ROWS + long_rows:
        x, a, bm, cm = ssd_case(S, pad, dtype, gen)
        b_ms, b_by = bound(*ssd_work(S, chunk, dtype.itemsize), dn)
        record("ssd_scan", dict(dtype=dn, B=1, S=S, chunk=chunk, pad=pad,
                                bound_ms=b_ms, bound_by=b_by),
               lambda: ops.ssd_scan(x, a, bm, cm, chunk=chunk),
               lambda: ref.ssd_scan(x, a, bm, cm, chunk=chunk), None,
               20 if S <= 512 else 5)
        if timed and long_rows and (S, chunk, pad) == long_rows[-1]:
            profiled(f"ssd_scan bf16 B=1 S={S} chunk={chunk}, one call",
                     lambda: ops.ssd_scan(x, a, bm, cm, chunk=chunk))
        del x, a, bm, cm
    torch.cuda.empty_cache()


def check_kernels(timed: bool = True):
    """Phase 3: every kernel against its plain version at the served
    shapes; with ``timed`` also the times of both and of the library call
    (where there is one).  Returns (rows, failures)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {"flash_decode": [], "flash_attention": [], "ssd_scan": [],
            "flash_decode_sharded": [], "flash_decode_int8": []}
    failures = []

    def record(name, row, run, plain, lib, iters, timed_fns=None,
               exact=False):
        """Check ``run()`` against ``plain()`` (and, with ``exact``, that
        ``row["bitwise"]`` holds); with ``timed``, time them (or the pair
        ``timed_fns`` in their place) and ``lib``."""
        out = run()
        if name == "ssd_scan":
            row["body"], row["kernels"] = ssd_launch()
        want = plain()
        synchronize_all()
        if name == "flash_attention":
            row["body"] = prefill_body()
            if not row["body"].startswith(PREFILL_BODY[row["dtype"]]):
                failures.append((name, f"{row['dtype']} ran the "
                                 f"{row['body']} body", row))
        if name == "ssd_scan" and (
                row["body"] != SSD_BODY[row["dtype"]] or row["kernels"]
                != ssd_kernels(row["dtype"], row["S"] // row["chunk"])):
            failures.append((name, f"{row['dtype']} ran the {row['body']} "
                             f"body in {row['kernels']} kernels", row))
        row["max_abs_err"], row["tol_share"] = max_err(
            out, want, row["dtype"], scaled=name == "ssd_scan")
        if exact and not row["bitwise"]:
            failures.append((name, "not bit for bit the single-device "
                             "kernel", row))
        t_run, t_plain = timed_fns or (run, plain)
        if timed:
            row.update(ms=cuda_ms(t_run, iters),
                       eager_ms=eager_ms(t_run, iters),
                       plain_ms=None if t_plain is None
                       else cuda_ms(t_plain, max(iters // 10, 5)),
                       library_ms=None if lib is None else cuda_ms(lib, iters))
        rows[name].append(row)
        if not row["tol_share"] <= 1.0:
            failures.append((name, row))

    def dense_decode(q, k, v, kv_len, q_off, window, iters, sharded):
        """``flash_decode`` against its plain version (and, with
        ``sharded``, ``flash_decode_sharded`` at TP=2 and TP=4)."""
        B, L = k.shape[:2]
        lens = kv_len.tolist()
        pos = torch.arange(L, device="cuda")
        keep = (pos[None] < kv_len[:, None]) & (pos[None] <= q_off[:, None])
        if window is not None:
            keep &= pos[None] > q_off[:, None] - window
        mask = keep[:, None, None, :]
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        n_keys = [visible_keys(o, min(n, L), window)
                  for o, n in zip(q_off.tolist(), lens)]
        bytes_moved = (2 * q.numel() * es + 8 * B
                       + 2 * sum(n_keys) * KV_HEADS * HEAD_DIM * es)
        flops = 4 * HEADS * HEAD_DIM * sum(n_keys)
        b_ms, b_by = bound(bytes_moved, flops, dn)
        record("flash_decode", dict(
            dtype=dn, B=B, L=L, kv_len=lens, window=window,
            n_split=ops.decode_plan(B, L, q.device)[0], bound_ms=b_ms,
            bound_by=b_by),
            lambda: ops.flash_decode(q, k, v, kv_len=kv_len,
                                     q_offset=q_off, window=window),
            lambda: ref.flash_decode(q, k, v, kv_len=kv_len,
                                     q_offset=q_off, window=window),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True), iters)
        if sharded:
            check_sharded(record, q, k, v, kv_len, q_off, n_keys, dn, es,
                          iters)

    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        es = dtype.itemsize
        for B in (1, 4):
            for window in (None, 64):
                dense_decode(*decode_case(B, dtype, gen), window, 200,
                             B == 4 and window is None)
        # a long, ragged cache: many splits per slot, empty ones among them
        for window in (None, LONG_WINDOW):
            dense_decode(*long_decode_case(dtype, gen), window, 20,
                         window is None)
        torch.cuda.empty_cache()
        check_int8(record, gen, dtype)
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
                        dtype=dn, B=B, S=S, window=window,
                        bound_ms=b_ms, bound_by=b_by, note=""),
                        lambda: ops.flash_attention(q, k, v, window=window),
                        lambda: ref.flash_attention(q, k, v, window=window),
                        (lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, is_causal=True, enable_gqa=True))
                        if window is None else
                        (lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, attn_mask=m, enable_gqa=True)), 50)
        if dtype == torch.bfloat16:
            check_long_prefill(record, gen)
            if timed:
                check_row_tiles(gen, failures)
        check_ssd(record, gen, dtype, timed)
    for name, rs in rows.items():
        log(f"[kernels] {name}: kernel vs plain version on the card")
        for r in rs:
            atol, rtol = TOL[r["dtype"]]
            if name == "flash_decode_sharded":
                shape = (f"B={r['B']} L={r['L']} kv_len={r['kv_len']} "
                         f"n_split={r['n_split']} "
                         f"{r['heads']} heads per rank x {r['tp']} ranks on "
                         f"one card, bitwise == single-device kernel: "
                         f"{r['bitwise']}; per call, all shards")
            elif name == "flash_decode":
                shape = (f"B={r['B']} L={r['L']} kv_len={r['kv_len']} "
                         f"window={r['window']} n_split={r['n_split']}")
            elif name == "flash_decode_int8":
                shape = (f"B={r['B']} L={r['L']} kv_len={r['kv_len']} "
                         f"{r['heads']} heads D={r['D']} "
                         f"window={r['window']} n_split={r['n_split']}"
                         f"{r['note']}")
            elif name == "flash_attention":
                shape = (f"B={r['B']} S={r['S']} window={r['window']} "
                         f"[{r['body']}]{r['note']}")
            else:
                shape = (f"B={r['B']} S={r['S']} chunk={r['chunk']} "
                         f"pad={r['pad']} H={SSM_HEADS} P={SSM_HEAD_DIM} "
                         f"N={SSM_STATE} [{r['body']}, {r['kernels']} "
                         f"kernels]")
            line = (f"  {r['dtype']:<8} {shape}: "
                    f"max_abs_err={r['max_abs_err']:.3e}, "
                    f"{r['tol_share']:.3f} of tol (atol {atol:g}"
                    f"{' x max|plain|' if name == 'ssd_scan' else ''} + rtol "
                    f"{rtol:g})")
            if timed:
                lib = ("no single PyTorch call" if r["library_ms"] is None
                       else f"{r.get('library', 'sdpa')} "
                            f"{r['library_ms']:.4f} ms")
                plain = ("" if r["plain_ms"] is None
                         else f"plain {r['plain_ms']:.4f} ms, ")
                line += (f"; kernel {r['ms']:.4f} ms (eager "
                         f"{r['eager_ms']:.4f}), {plain}{lib}, bound "
                         f"{r['bound_ms']:.5f} ms ({r['bound_by']})")
            log(line)
    return rows, failures


#: the body of ``flash_attention.cu`` each dtype must run
PREFILL_BODY = {"bfloat16": "tensor-core", "float32": "CUDA-core"}
#: the long prefill rows of phase 3, (B, S), bf16, causal, at the served
#: heads: one prompt of 32768 tokens, and one layer of the reference's
#: prefill_32k shape (B=32 x 32768)
LONG_PREFILL = [(1, 32768), (32, 32768)]
#: query rows of each slice on which a long row is checked: the first, a
#: middle and the last LONG_SLICE rows.  The plain version over a whole
#: long prompt cannot run (its fp32 scores would take 51 GB at B=1), so it
#: runs over each slice's queries and the keys they may see (rows [a, b)
#: of the output over keys [0, b) at query offset a: the same rows), in
#: groups of LONG_CHECK_BATCH batch rows
LONG_SLICE, LONG_CHECK_BATCH = 256, 4
#: shapes (B, S), bf16, causal, at the served heads, at which phase 3 times
#: each instance of the prefill's tensor-core body, 1 and 2 row tiles a
#: warp: the launcher picks 2 when its grid of 128-row blocks makes
#: kMinWaves = 2 waves of 2 blocks on every SM (flash_attention.cu), i.e.
#: at least 528 blocks on 132 SMs: 192 at the served shape, 768 and 3072
#: at one prompt of 8192 and of 32768 tokens
ROW_TILE_SHAPES = [(4, 512), (1, 8192), (1, 32768)]


def prefill_body() -> str:
    """The body of ``flash_attention.cu`` that its last launch ran, as the
    library's launcher recorded it: "tensor-core" (with 1 or 2 row tiles
    a warp) or "CUDA-core"."""
    from repro_torch.kernels import build

    body = build.load("flash_attention_last_body")()
    if body not in (0, 1, 2):
        raise AssertionError(f"flash_attention: no body recorded ({body})")
    return ("CUDA-core" if body == 0 else
            f"tensor-core, {body} row tile{'s' * (body > 1)} a warp")


def long_slices(S: int):
    """The first, a middle and the last ``LONG_SLICE`` query rows of a
    prompt of S tokens, as [a, b) ranges."""
    mid = S // 2 - LONG_SLICE // 2
    return [(0, LONG_SLICE), (mid, mid + LONG_SLICE), (S - LONG_SLICE, S)]


def plain_slices(q, k, v, slices):
    """The plain causal prefill's output on the query rows of ``slices``,
    concatenated: rows [a, b) over keys [0, b) at query offset a, in
    groups of ``LONG_CHECK_BATCH`` batch rows."""
    import torch

    from repro_torch.kernels import ref

    B = q.shape[0]
    return torch.cat([torch.cat([
        ref.flash_attention(q[i:i + LONG_CHECK_BATCH, a:b],
                            k[i:i + LONG_CHECK_BATCH, :b],
                            v[i:i + LONG_CHECK_BATCH, :b], q_offset=a)
        for i in range(0, B, LONG_CHECK_BATCH)], dim=0)
        for a, b in slices], dim=1)


def check_row_tiles(gen, failures) -> None:
    """bf16 causal ``flash_attention`` at each ``ROW_TILE_SHAPES`` shape
    with each instance of its tensor-core body, 1 and 2 row tiles a warp
    (forced through ``flash_attention_row_tiles``), beside the instance the
    launcher picks by grid size: each instance's output checked on
    ``long_slices`` against the plain version, and its device time, both
    logged; a disagreement or the wrong instance is added to
    ``failures``."""
    import torch

    from repro_torch.kernels import build, ops

    force = build.load("flash_attention_row_tiles")
    last_body = build.load("flash_attention_last_body")
    for B, S in ROW_TILE_SHAPES:
        q = torch.randn((B, S, HEADS, HEAD_DIM), generator=gen,
                        device="cuda", dtype=torch.bfloat16)
        k, v = (torch.randn((B, S, KV_HEADS, HEAD_DIM), generator=gen,
                            device="cuda", dtype=torch.bfloat16)
                for _ in range(2))
        slices = long_slices(S)
        want = plain_slices(q, k, v, slices)
        ops.flash_attention(q, k, v)
        torch.cuda.synchronize()
        row = dict(B=B, S=S, picked=last_body(), ms={}, tol_share={})
        try:
            for mt in (1, 2):
                if force(mt) != 0:
                    raise RuntimeError("flash_attention_row_tiles refused "
                                       f"{mt}")
                out = ops.flash_attention(q, k, v)
                torch.cuda.synchronize()
                if last_body() != mt:
                    failures.append(("flash_attention", f"forced {mt} row "
                                     f"tiles a warp, ran {last_body()}",
                                     row))
                got = torch.cat([out[:, a:b] for a, b in slices], dim=1)
                row["tol_share"][mt] = max_err(got, want, "bfloat16")[1]
                if not row["tol_share"][mt] <= 1.0:
                    failures.append(("flash_attention", f"{mt} row tiles "
                                     "a warp", row))
                row["ms"][mt] = cuda_ms(lambda: ops.flash_attention(q, k, v),
                                        50 if S <= 512 else 5)
        finally:
            force(0)
        log(f"[kernels] flash_attention bf16 B={B} S={S} causal, by row "
            f"tiles a warp (the launcher picks {row['picked']}): "
            + ", ".join(f"{mt}: {row['ms'][mt]:.4f} ms, "
                        f"{row['tol_share'][mt]:.3f} of tol"
                        for mt in (1, 2)))
        del q, k, v, want
        torch.cuda.empty_cache()


def check_long_prefill(record, gen) -> None:
    """bf16 ``flash_attention`` at the ``LONG_PREFILL`` shapes: the kernel
    over the whole prompt, checked on three slices of ``LONG_SLICE`` query
    rows against the plain version; the kernel and ``sdpa`` (causal, GQA)
    timed over the whole prompt with few iterations; the plain version is
    not timed."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    for B, S in LONG_PREFILL:
        q = torch.randn((B, S, HEADS, HEAD_DIM), generator=gen,
                        device="cuda", dtype=torch.bfloat16)
        k, v = (torch.randn((B, S, KV_HEADS, HEAD_DIM), generator=gen,
                            device="cuda", dtype=torch.bfloat16)
                for _ in range(2))
        slices = long_slices(S)

        def run():
            out = ops.flash_attention(q, k, v)
            return torch.cat([out[:, a:b] for a, b in slices], dim=1)

        def plain():
            return plain_slices(q, k, v, slices)

        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        bytes_moved = (2 * q.numel() + 2 * k.numel()) * q.element_size()
        flops = 4 * B * HEADS * HEAD_DIM * (S * (S + 1) // 2)
        b_ms, b_by = bound(bytes_moved, flops, "bfloat16")
        record("flash_attention", dict(
            dtype="bfloat16", B=B, S=S, window=None,
            bound_ms=b_ms, bound_by=b_by,
            note=f"; checked on query rows {slices}; plain not timed"),
            run, plain,
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True),
            2 if B > 1 else 5,
            timed_fns=(lambda: ops.flash_attention(q, k, v), None))
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()


def check_sharded(record, q, k, v, kv_len, q_off, n_keys, dn, es, iters):
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
    L = k.shape[1]
    keep = ((torch.arange(L, device=q.device)[None] < kv_len[:, None])
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
            dtype=dn, B=q.shape[0], L=L, kv_len=kv_len.tolist(), tp=tp,
            heads=f"{HEADS // tp}/{ranges[0][1] - ranges[0][0]}",
            n_split=ops.decode_plan(q.shape[0], L, q.device)[0],
            bitwise=bitwise, bound_ms=b_ms, bound_by=b_by),
            lambda: torch.cat(ops.flash_decode_sharded(
                qs, ks, vs, kv_len=kv_len, q_offset=q_off), dim=2),
            lambda: torch.cat(ref.flash_decode_sharded(
                qs, ks, vs, kv_len=kv_len, q_offset=q_off), dim=2),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=keep, enable_gqa=True), iters,
            timed_fns=(lambda: ops.flash_decode_sharded(
                qs, ks, vs, kv_len=kv_len, q_offset=q_off),
                lambda: ref.flash_decode_sharded(
                    qs, ks, vs, kv_len=kv_len, q_offset=q_off)),
            exact=True)


#: int8 decode cases of phase 3: (B, L, heads, KV heads, head dim, kv_len
#: per slot, window); the first is the served shape; kv_len 0 and L + 1 (a
#: step at len == L) are among them
INT8_CASES = [
    (4, MAX_LEN, HEADS, KV_HEADS, HEAD_DIM, [1, 200, 377, MAX_LEN], None),
    (4, MAX_LEN, HEADS, KV_HEADS, HEAD_DIM, [1, 200, 377, MAX_LEN], 64),
    (4, MAX_LEN, 4, 4, 32, [0, 17, 300, MAX_LEN + 1], None),
    (4, MAX_LEN, 16, 1, 64, [5, 129, MAX_LEN + 1, MAX_LEN], 100),
    (LONG_B, LONG_L, HEADS, KV_HEADS, HEAD_DIM, LONG_KV_LEN, None),
    (LONG_B, LONG_L, HEADS, KV_HEADS, HEAD_DIM, LONG_KV_LEN, LONG_WINDOW),
]
#: slots of the decode_32k layer compared with (and timed against) the
#: plain version: a full layer's K and V dequantized would take 8.6 GB
#: in fp32
SUB_BATCH = 8


def int8_kv(B: int, L: int, kh: int, d: int, gen):
    """Random int8 K/V codes (B, L, KH, D) in [-127, 127] and positive fp32
    scales (B, L), filled in place on the card."""
    import torch
    k, v = (torch.empty((B, L, kh, d), dtype=torch.int8, device="cuda")
            .random_(-127, 128, generator=gen) for _ in range(2))
    ks, vs = (torch.empty((B, L), device="cuda").uniform_(
        0.005, 0.025, generator=gen) for _ in range(2))
    return k, v, ks, vs


def int8_bytes(q, kh: int, d: int, n_keys: int) -> float:
    """Bytes a flash_decode_int8 call must move: q read and out written,
    the two per-slot vectors, and per visible key its K and V codes and
    its two fp32 scales."""
    return (2 * q.numel() * q.element_size() + 8 * q.shape[0]
            + n_keys * (2 * kh * d + 8))


def check_int8(record, gen, dtype) -> None:
    """``flash_decode_int8`` against its plain version (dequantize in fp32,
    then the plain decode) in ``INT8_CASES``, and at one layer of the
    ``decode_32k`` cache (B=128, L=32768, every slot at depth 32767): the
    full batch for the kernel's and the library call's times, checked on
    its first ``SUB_BATCH`` slots, and the sub-batch alone for kernel,
    plain and library times on the same inputs.  The library call is
    ``sdpa`` (GQA) over K/V already dequantized to bf16, the dequantize
    left out of its time: PyTorch has no single call over int8 K/V."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.launch.shapes import SHAPES

    dn = str(dtype).split(".")[1]

    def case(q, k, v, ks, vs, kv_len, q_off, window, note, iters):
        B, L, kh, d = k.shape
        lens = kv_len.tolist()
        n_keys = sum(visible_keys(o, min(n, L), window)
                     for o, n in zip(q_off.tolist(), lens))
        b_ms, b_by = bound(int8_bytes(q, kh, d, n_keys),
                           4 * q.shape[2] * d * n_keys, dn)
        pos = torch.arange(L, device="cuda")
        keep = (pos[None] < kv_len[:, None]) & (pos[None] <= q_off[:, None])
        if window is not None:
            keep &= pos[None] > q_off[:, None] - window
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (ref.dequantize(c, s).to(torch.bfloat16).transpose(1, 2)
                  .contiguous() for c, s in ((k, ks), (v, vs)))
        kw = dict(kv_len=kv_len, q_offset=q_off, window=window)
        row = dict(dtype=dn, B=B, L=L, kv_len=lens, heads=f"{q.shape[2]}/"
                   f"{kh}", D=d, window=window, note=note,
                   n_split=ops.decode_plan(B, L, q.device)[0], bound_ms=b_ms,
                   bound_by=b_by, library="sdpa over bf16-dequantized K/V "
                   "(dequantize not timed)")
        record("flash_decode_int8", row,
               lambda: ops.flash_decode_int8(q, k, v, ks, vs, **kw),
               lambda: ref.flash_decode_int8(q, k, v, ks, vs, **kw),
               lambda: F.scaled_dot_product_attention(
                   qt.to(torch.bfloat16), kt, vt, attn_mask=keep[:, None,
                                                                 None, :],
                   enable_gqa=True), iters)

    for B, L, h, kh, d, lens, window in INT8_CASES:
        q = torch.randn((B, 1, h, d), generator=gen, device="cuda",
                        dtype=dtype)
        k, v, ks, vs = int8_kv(B, L, kh, d, gen)
        kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
        case(q, k, v, ks, vs, kv_len, (kv_len - 1).clamp(0, L), window, "",
             200 if L == MAX_LEN else 20)
        del q, k, v, ks, vs
    # one layer of the decode_32k cache
    shape = SHAPES["decode_32k"]
    B, L = shape.global_batch, shape.seq_len
    q = torch.randn((B, 1, HEADS, HEAD_DIM), generator=gen, device="cuda",
                    dtype=dtype)
    k, v, ks, vs = int8_kv(B, L, KV_HEADS, HEAD_DIM, gen)
    kv_len = torch.full((B,), L, dtype=torch.int32, device="cuda")
    q_off = kv_len - 1
    n_keys = B * L
    b_ms, b_by = bound(int8_bytes(q, KV_HEADS, HEAD_DIM, n_keys),
                       4 * HEADS * HEAD_DIM * n_keys, dn)
    n = SUB_BATCH
    kw = dict(kv_len=kv_len, q_offset=q_off)
    sub = dict(kv_len=kv_len[:n], q_offset=q_off[:n])
    # the library call over the whole layer: K/V dequantized to bf16 in
    # (B, KH, L, D), 4.3 GB, slot group by slot group (not timed), freed
    # just after; every key is visible, so sdpa needs no mask
    qt = q.transpose(1, 2).to(torch.bfloat16).contiguous()
    kt, vt = (torch.empty((B, KV_HEADS, L, HEAD_DIM), dtype=torch.bfloat16,
                          device="cuda") for _ in range(2))
    for i in range(0, B, n):
        for dst, c, sc in ((kt, k, ks), (vt, v, vs)):
            dst[i:i + n] = ref.dequantize(c[i:i + n], sc[i:i + n]).to(
                torch.bfloat16).transpose(1, 2)
    record("flash_decode_int8", dict(
        dtype=dn, B=B, L=L, kv_len=f"{L} x {B}", heads=f"{HEADS}/{KV_HEADS}",
        D=HEAD_DIM, window=None, n_split=ops.decode_plan(B, L, q.device)[0],
        bound_ms=b_ms, bound_by=b_by,
        note=f" (decode_32k layer; checked on its first {n} slots; plain "
             f"timed on the {n}-slot row)",
        library="sdpa over the whole layer's bf16-dequantized K/V "
                "(dequantize not timed)"),
        lambda: ops.flash_decode_int8(q, k, v, ks, vs, **kw)[:n],
        lambda: ref.flash_decode_int8(q[:n], k[:n], v[:n], ks[:n], vs[:n],
                                      **sub),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True),
        20, timed_fns=(
            lambda: ops.flash_decode_int8(q, k, v, ks, vs, **kw), None))
    del qt, kt, vt
    torch.cuda.empty_cache()
    case(q[:n], k[:n], v[:n], ks[:n], vs[:n], kv_len[:n], q_off[:n], None,
         f" (decode_32k, first {n} slots)", 20)
    del q, k, v, ks, vs
    torch.cuda.empty_cache()


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


def check_launches(launches, want) -> None:
    """Every count in ``want`` (name -> (count, why)) as stated and above
    0, and every other kernel not launched."""
    for name, n in launches.items():
        if name not in want and n:
            raise AssertionError(f"{name} launched {n} times on a path that "
                                 "does not run it")
    for name, (n, why) in want.items():
        if launches[name] != n:
            raise AssertionError(f"{name} launched {launches[name]} times, "
                                 f"want {n} = {why}")
        if n <= 0:
            raise AssertionError(f"{name} was never launched on the path")


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
    check_launches(launches, want_launches)
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
    live slots under ``torch.profiler`` (:func:`profiled`)."""
    from repro_torch.core import Job
    from repro_torch.engine import EngineConfig, InferenceEngine

    eng = InferenceEngine(cfg, params, EngineConfig(
        max_slots=4, max_len=MAX_LEN, max_output=64, eos_id=-1),
        device=DEVICE, mesh=mesh)
    jobs = [Job(job_id=r.request_id, prompt="",
                prompt_tokens=list(r.prompt_tokens), arrival_time=0.0)
            for r in requests[:4]]
    eng.run_window(jobs, 8)  # prefill, and a first window as warm-up
    cards = 1 if mesh is None else len(set(mesh.ranks))
    profiled(f"{cfg.arch_id}"
             f"{'' if mesh is None else f' TP={len(mesh.ranks)} on {cards} card(s)'}"
             f": one decode window (8 steps, 4 slots, {cfg.n_layers} layers)",
             lambda: eng.run_window(jobs, 8))


def profiled(what: str, fn) -> None:
    """Run ``fn()`` once under ``torch.profiler`` and log its host wall
    time, the device's busy time (the sum of the kernels' durations: one
    stream per card, so they do not overlap on one card; with ranks on two
    cards it is summed over both) and the kernels that took most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    synchronize_all()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        synchronize_all()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values()) / 1e3
    log(f"[profile] {what} under torch.profiler: wall {wall * 1e3:.2f} ms, "
        f"device busy {busy:.2f} ms ({100 * busy / (wall * 1e3):.1f}%), "
        f"{len(by_name)} kernel names")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    # the eight longest, and every other kernel of the port's sources (the
    # decode's combine pass among them)
    shown = ranked[:8] + [(n, us) for n, us in ranked[8:]
                          if "(anonymous namespace)::" in n]
    for name, us in shown:
        log(f"[profile]   {us / 1e3:8.3f} ms {100 * us / 1e3 / busy:5.1f}% "
            f"of busy  {name[:90]}")


# --------------------------------------------------------------------------- #
# Phases 4-5 for the step entry points (launch/steps.py) over int8 caches
# --------------------------------------------------------------------------- #

#: the small int8 step path: B slots of a cache of MAX_LEN rows, prompts of
#: PROMPT ids (the reference's prefill_step takes no last_index, so the
#: prompts share one length), STEPS greedy serve steps
STEP_SLOTS, STEP_PROMPT, STEPS = 4, 128, 32


def step_prompts():
    """``STEP_SLOTS`` prompts of ``STEP_PROMPT`` ids, cut from the served
    cells' requests."""
    prompts = [r.prompt_tokens[:STEP_PROMPT] for r in make_requests(64, SEED)
               if len(r.prompt_tokens) >= STEP_PROMPT][:STEP_SLOTS]
    if len(prompts) < STEP_SLOTS:
        raise AssertionError("too few requests with long enough prompts")
    return prompts


def small_cache(cfg, kv_dtype="int8"):
    """An input_specs cache of ``STEP_SLOTS`` x ``MAX_LEN`` rows."""
    from repro_torch.launch.shapes import InputShape, input_specs
    shape = InputShape("serve_512", MAX_LEN, STEP_SLOTS, "decode")
    return input_specs(cfg, shape, kv_dtype=kv_dtype, device=DEVICE)["cache"]


def run_steps(cfg, params, attn_impl: str, n_steps: int = STEPS):
    """``make_prefill_step`` over the prompts into a fresh int8 cache, then
    ``n_steps`` greedy ``make_serve_step`` steps; returns (tokens (B, 1 +
    n_steps), host wall seconds of each step, devices synchronised)."""
    import torch

    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    prompts = torch.as_tensor(step_prompts(), device=DEVICE)
    logits, cache = make_prefill_step(cfg, attn_impl=attn_impl)(
        params, {"tokens": prompts, "cache": small_cache(cfg)})
    tok = logits[:, -1].argmax(-1).to(torch.int32)
    serve = make_serve_step(cfg, attn_impl=attn_impl)
    toks, walls = [tok], []
    for _ in range(n_steps):
        synchronize_all()
        t0 = time.perf_counter()
        tok, cache = serve(params, tok[:, None], cache)
        synchronize_all()
        walls.append(time.perf_counter() - t0)
        toks.append(tok)
    return torch.stack(toks, dim=1), walls


def int8_step_path(cfg, params) -> int:
    """Phase 4, small cache: prefill and ``STEPS`` serve steps through the
    kernels with every launch count set to 0 just before and read just
    after.  Returns ``flash_decode_int8``'s count."""
    import statistics

    from repro_torch.kernels import ops

    ops.reset_launches()
    toks, walls = run_steps(cfg, params, "kernel")
    launches = {name: fn.launches for name, fn in ops.KERNELS.items()}
    n = cfg.n_layers
    check_launches(launches, {
        "flash_attention": (n, f"{n} layers x 1 prefill"),
        "flash_decode_int8": (n * STEPS, f"{n} layers x {STEPS} steps")})
    if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError("a generated token lies outside the vocabulary")
    med = statistics.median(walls) * 1e3
    log(f"[int8] make_prefill_step + make_serve_step over an input_specs "
        f"int8 cache ({STEP_SLOTS} slots x {MAX_LEN} rows), "
        f"{describe(cfg)}: {STEP_SLOTS} prompts of {STEP_PROMPT} ids, "
        f"{STEPS} greedy steps; step wall median {med:.2f} ms (min "
        f"{min(walls) * 1e3:.2f}), {STEP_SLOTS / (med / 1e3):.1f} tokens/s")
    log(f"[int8] launches: flash_attention {launches['flash_attention']} = "
        f"{n} x 1 prefill; flash_decode_int8 "
        f"{launches['flash_decode_int8']} = {n} x {STEPS} steps; "
        f"flash_decode {launches['flash_decode']} (all counts: "
        f"{json.dumps(launches)})")
    return launches["flash_decode_int8"]


def fill_int8(kv, gen, length: int, lens) -> None:
    """Fill an int8 cache layer by layer, in place: codes in [-127, 127],
    scales in [0.005, 0.025], and every slot's ``len`` set to ``length``."""
    for i in range(kv.k.shape[0]):
        for codes in (kv.k[i], kv.v[i]):
            codes.random_(-127, 128, generator=gen)
        for scale in (kv.k_scale[i], kv.v_scale[i]):
            scale.uniform_(0.005, 0.025, generator=gen)
    lens.fill_(length)


def ring_step(cfg, params) -> None:
    """Phase 4, ring cache: one ``make_serve_step`` at long_500k (B=1, an
    int8 ring of 8192 rows, filled, at position 524287): read plain, as the
    reference reads a ring, so no decode kernel launches."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.shapes import SHAPES, input_specs
    from repro_torch.launch.steps import make_serve_step

    shape = SHAPES["long_500k"]
    specs = input_specs(cfg, shape, kv_dtype="int8", device=DEVICE)
    cache = specs["cache"]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    fill_int8(cache["kv"], gen, shape.seq_len - 1, cache["len"])
    tokens = torch.randint(8, cfg.vocab_size, (shape.global_batch, 1),
                           generator=gen, device=DEVICE, dtype=torch.int32)
    ops.reset_launches()
    tok, cache = make_serve_step(cfg)(params, tokens, cache)
    synchronize_all()
    launches = {name: fn.launches for name, fn in ops.KERNELS.items()}
    if any(launches.values()):
        raise AssertionError(f"the ring step launched a kernel: {launches}")
    if not (0 <= int(tok[0]) < cfg.vocab_size and cache["kv"].ring):
        raise AssertionError("long_500k ring step: bad token or cache")
    log(f"[int8] long_500k: make_serve_step over an int8 ring of "
        f"{cache['kv'].k.shape[2]} rows (B={shape.global_batch}, position "
        f"{shape.seq_len - 1}): token {int(tok[0])}; read plain as in the "
        f"reference, no decode kernel launched ({json.dumps(launches)})")


def int8_greedy_parity(cfg) -> bool:
    """Phase 5: fp32 greedy tokens of the small int8 step path at full
    width and 2 layers, kernel path against plain path: identical?"""
    import torch

    from repro_torch.models import transformer as T

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    params2 = T.init_params(
        cfg2, torch.Generator(device=DEVICE).manual_seed(SEED + 1))
    got, _ = run_steps(cfg2, params2, "kernel")
    want, _ = run_steps(cfg2, params2, "torch")
    same = int((got == want).sum())
    log(f"[parity] {cfg.arch_id} fp32, full width, 2 layers, int8 cache: "
        f"step functions' greedy tokens, kernel path vs plain path, "
        f"identical on {same}/{want.numel()} tokens ({STEP_SLOTS} slots x "
        f"{1 + STEPS})")
    return bool(torch.equal(got, want))


def int8_logit_gaps(cfg, params):
    """Phase 5, bf16 at full width and depth: the prompts prefilled into an
    int8 cache through the kernels, then one decode step over copies of
    that cache through the kernel path and the plain path.  Returns
    (max |kernel - plain| of the step's logits, max |int8 kernel - the same
    step over a bf16 cache| (quantization error, reported only), whether
    the kernel's logits are finite)."""
    import copy

    import torch

    from repro_torch.models import transformer as T

    prompts = torch.as_tensor(step_prompts(), device=DEVICE)

    def step_logits(kv_dtype, impls):
        logits, cache = T.prefill(params, cfg, {"tokens": prompts},
                                  small_cache(cfg, kv_dtype))
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
        return [T.decode_step(params, cfg, tok, copy.deepcopy(cache),
                              attn_impl=impl)[0].float() for impl in impls]

    kernel, plain = step_logits("int8", ("kernel", "torch"))
    (dense,) = step_logits(None, ("kernel",))
    gap = float((kernel - plain).abs().max())
    quant = float((kernel - dense).abs().max())
    finite = bool(torch.isfinite(kernel).all())
    log(f"[parity] {cfg.arch_id} bf16, full width and depth, int8 cache: "
        f"first decode step's logits {tuple(kernel.shape)}, max |kernel - "
        f"plain| = {gap:.4e} (tol {INT8_LOGIT_TOL_BF16}), max |logit| = "
        f"{float(plain.abs().max()):.3f}, finite={finite}; reported, not "
        f"checked: max |int8 kernel - bf16 cache kernel| = {quant:.4e} "
        f"(quantization error)")
    return gap, quant, finite


def decode_32k_steps(cfg) -> None:
    """Phase 4, large cache: ``make_serve_step`` at decode_32k (B=128,
    L=32768) over an int8 cache built by ``input_specs`` on the card and
    filled in place, every slot at depth 32767: one warm-up step and 5
    timed ones (devices synchronised; median), with their launches, the
    cache's bytes, the peak memory and the step's bound.  The bf16 cache
    this shape would need is computed, never allocated."""
    import statistics

    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.shapes import SHAPES, input_specs
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import transformer as T

    free, total = torch.cuda.mem_get_info()
    log(f"[int8] decode_32k: device memory free {free / 1e9:.2f} of "
        f"{total / 1e9:.2f} GB before its weights and cache")
    torch.cuda.reset_peak_memory_stats()
    params = T.init_params(cfg, torch.Generator(device=DEVICE)
                           .manual_seed(SEED))
    shape = SHAPES["decode_32k"]
    cache = input_specs(cfg, shape, kv_dtype="int8", device=DEVICE)["cache"]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    fill_int8(cache["kv"], gen, shape.seq_len - 1, cache["len"])
    tok = torch.randint(8, cfg.vocab_size, (shape.global_batch,),
                        generator=gen, device=DEVICE, dtype=torch.int32)
    kv = cache["kv"]
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in (kv.k, kv.v, kv.k_scale, kv.v_scale))
    param_bytes = sum(t.numel() * t.element_size() for t in
                      _tensors(params))
    bf16_cache = 2 * kv.k.numel() * 2
    serve = make_serve_step(cfg)
    ops.reset_launches()
    walls = []
    for i in range(6):
        synchronize_all()
        t0 = time.perf_counter()
        tok, cache = serve(params, tok[:, None], cache)
        synchronize_all()
        if i:
            walls.append(time.perf_counter() - t0)
    launches = {name: fn.launches for name, fn in ops.KERNELS.items()}
    n = cfg.n_layers
    check_launches(launches, {"flash_decode_int8": (
        6 * n, f"{n} layers x 6 steps")})
    if not bool(((tok >= 0) & (tok < cfg.vocab_size)).all()):
        raise AssertionError("decode_32k: a token lies outside the vocabulary")
    peak = torch.cuda.max_memory_allocated()
    step_bound = (cache_bytes + param_bytes) / HBM_BYTES_S * 1e3
    log(f"[int8] decode_32k: make_serve_step, B={shape.global_batch}, int8 "
        f"cache of {shape.seq_len} rows ({cache_bytes / 1e9:.2f} GB: codes "
        f"and fp32 scales), every slot at depth {shape.seq_len - 1}, "
        f"{describe(cfg)} ({param_bytes / 1e9:.2f} GB of weights): step "
        f"wall median {statistics.median(walls) * 1e3:.2f} ms over 5 "
        f"(min {min(walls) * 1e3:.2f}; after 1 warm-up); bound "
        f"{step_bound:.2f} ms (cache and weights read once at 3.35 TB/s)")
    log(f"[int8] decode_32k: flash_decode_int8 {launches['flash_decode_int8']}"
        f" = {n} x 6 steps; peak memory allocated {peak / 1e9:.2f} GB; a "
        f"bf16 cache of this shape would need {bf16_cache / 1e9:.1f} GB "
        f"(computed, not allocated)")
    profiled(f"decode_32k: one make_serve_step (B={shape.global_batch})",
             lambda: serve(params, tok[:, None], cache))


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree


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
        t0 = time.perf_counter()
        build.build_all()
        log(f"[fault] {kind}: kernels built from a faulty copy of csrc in "
            f"{time.perf_counter() - t0:.1f} s")
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
            if cfg.family == "dense":
                gap8, _, finite8 = int8_logit_gaps(cfg, params)
                served[cfg.arch_id].update(
                    int8_greedy_fp32_caught=not int8_greedy_parity(cfg),
                    int8_logit_gap_bf16=gap8,
                    int8_logit_tol_bf16=INT8_LOGIT_TOL_BF16,
                    int8_logit_caught=not (finite8
                                           and gap8 <= INT8_LOGIT_TOL_BF16))
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


# --------------------------------------------------------------------------- #
# Phase 6: the serve CLI (launch/serve.py) at full width
# --------------------------------------------------------------------------- #

#: traffic that queues and preempts on one card: 24 requests at 4 req/s
#: (Gamma arrivals) with outputs up to 128 tokens, against 4 slots that
#: serve far fewer requests a second at full width
CLI_QUEUE = ["--slots", "4", "--window", "8", "--n", "24", "--rate", "4",
             "--max-output", "128", "--seed", "0"]
#: the runs of phase 6, in order: serve.py's defaults, then ISRTF and FCFS
#: on the same arrivals (isrtf, fcfs, fcfs, isrtf), then ISRTF with chunked
#: prefill and swap preemption, and with the ``auto`` break-even after a
#: live probe of the node's token cost
CLI_RUNS = [
    ("defaults", ["--n", "12"]),
    ("isrtf", CLI_QUEUE + ["--policy", "isrtf"]),
    ("fcfs", CLI_QUEUE + ["--policy", "fcfs"]),
    ("fcfs", CLI_QUEUE + ["--policy", "fcfs"]),
    ("isrtf", CLI_QUEUE + ["--policy", "isrtf"]),
    ("isrtf chunk+swap", CLI_QUEUE + ["--policy", "isrtf",
                                      "--prefill-chunk", "8",
                                      "--preempt-policy", "swap"]),
    ("isrtf auto+probe", CLI_QUEUE + ["--policy", "isrtf",
                                      "--preempt-policy", "auto",
                                      "--probe-nodes", "2"]),
]


def cli_run(name: str, argv, predictor_probe=None):
    """Run ``repro_torch.launch.serve.main(argv)`` in this process with
    every launch count set to 0 just before and read just after; check
    it as :func:`check_served` does.  ``predictor_probe``, when given, is
    called on the predictor the CLI builds, before it serves.  Returns the
    run's numbers."""
    import contextlib
    import io

    from repro_torch.kernels import ops
    from repro_torch.launch import serve as cli

    argv = list(argv) + ["--device", DEVICE]
    args = cli._parser().parse_args(argv)
    want_tokens = {r.request_id: min(r.true_output_len, args.max_output)
                   for r in cli.load_requests(args)[0]}
    out, err = io.StringIO(), io.StringIO()
    build_predictor = cli.build_predictor
    if predictor_probe is not None:
        def probed(*a):
            pred = build_predictor(*a)
            predictor_probe(pred)
            return pred
        cli.build_predictor = probed
    ops.reset_launches()
    synchronize_all()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            responses, executor = cli.main(argv)
    finally:
        cli.build_predictor = build_predictor
    synchronize_all()
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in ops.KERNELS.items()}
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("{")]
    if len(lines) != len(want_tokens):
        raise AssertionError(f"serve CLI run {name!r}: {len(lines)} request "
                             f"lines, want {len(want_tokens)}")
    probe_windows = probe_steps = 0
    if args.probe_nodes:
        per = (args.probe_nodes + 1) * len({1, min(2, args.slots)})
        probe_windows = per * len(cli.PROBE_WINDOWS)
        probe_steps = per * sum(cli.PROBE_WINDOWS)
    run = check_served(name, responses, executor, want_tokens, launches,
                       wall, probe_windows, probe_steps)
    log(f"[cli]   (python -m repro_torch.launch.serve {' '.join(argv)})")
    for ln in err.getvalue().splitlines():
        log(f"[cli]   {ln}")
    del responses, executor
    gc.collect()
    if DEVICE != "cpu":
        import torch
        torch.cuda.empty_cache()
    return run


def check_served(name, responses, executor, want_tokens, launches, wall,
                 probe_windows=0, probe_steps=0) -> dict:
    """Check one served run: every request finished with
    ``min(true_output_len, max_output)`` tokens (``want_tokens``) and the
    kernels ran as often as the engine's dispatches say (a chunk of a
    chunked prefill launches nothing: it attends with the plain ``sdpa``,
    as the reference does).  Logs and returns the run's numbers."""
    from repro_torch.core import summarize

    bad = [(r.request_id, r.status.value, r.n_tokens,
            want_tokens.get(r.request_id)) for r in responses
           if not r.ok or r.n_tokens != want_tokens.get(r.request_id)]
    if bad or len(responses) != len(want_tokens):
        raise AssertionError(f"serve run {name!r}: requests not served "
                             f"as expected: {bad}")
    # a window decodes iff it emits tokens (every decoding job emits at
    # least one); the others only ran a prefill chunk
    decoding = [rec for rec in executor.window_log if rec["tokens"] > 0]
    steps = sum(rec["window"] for rec in decoding)
    counters = executor.counters()
    if counters["decode_dispatches"] != len(decoding) + probe_windows:
        raise AssertionError(
            f"serve run {name!r}: {counters['decode_dispatches']} decode "
            f"dispatches, but {len(decoding)} windows emitted tokens and "
            f"{probe_windows} probe windows ran")
    n_layers = executor.engines[0].model_cfg.n_layers
    prefills = counters["prefill_dispatches"]
    want = {"flash_decode": (n_layers * (steps + probe_steps),
                             f"{n_layers} layers x {steps + probe_steps} "
                             "decode steps"
                             + (f" ({probe_steps} of them probes)"
                                if probe_steps else ""))}
    if prefills:  # a chunked run admits every job, resumes too, by chunks
        want["flash_attention"] = (n_layers * prefills,
                                   f"{n_layers} layers x {prefills} "
                                   "one-shot prefill dispatches")
    check_launches(launches, want)
    m = summarize(responses)
    n_tok = sum(r.n_tokens for r in responses)
    busy = sum(rec["duration_s"] for rec in executor.window_log)
    run = {"name": name, "jct_mean": m["jct_mean"], "jct_p99": m["jct_p99"],
           "queue_mean": m["queuing_delay_mean"],
           "preemptions": m["preemptions"], "tokens": n_tok,
           "tokens_s": n_tok / m["makespan"], "wall_s": wall,
           "launches": launches, "counters": counters}
    log(f"[cli] {name}: {len(responses)}/{len(want_tokens)} requests "
        f"FINISHED with the expected token counts; JCT mean "
        f"{m['jct_mean']:.3f} s, p99 {m['jct_p99']:.3f} s; queueing delay "
        f"mean {m['queuing_delay_mean']:.3f} s; preemptions "
        f"{m['preemptions']}; {n_tok} tokens over a {m['makespan']:.3f} s "
        f"serving makespan = {run['tokens_s']:.1f} tokens/s "
        f"({n_tok / busy:.1f} over the {busy:.3f} s of windows); swapouts "
        f"{counters['swapouts']}, swapins {counters['swapins']}, chunk "
        f"dispatches {counters['chunk_dispatches']}, resume prefill tokens "
        f"{counters['resume_context_tokens']}; flash_decode "
        f"{launches['flash_decode']}, flash_attention "
        f"{launches['flash_attention']}; {wall:.1f} s wall")
    return run


def serve_cli_phase() -> dict:
    """Phase 6: drive ``repro_torch.launch.serve.main`` through
    :data:`CLI_RUNS` and check what they must show: ISRTF preempts, the
    swap run swaps out and in and runs prefill chunks; print ISRTF's and
    FCFS's mean JCT and their ratio.  Returns the phase's launch counts,
    summed over its runs, and the ISRTF runs' mean JCTs."""
    runs = [cli_run(name, argv) for name, argv in CLI_RUNS]
    by = {}
    for r in runs:
        by.setdefault(r["name"], []).append(r)
    isrtf = [r["jct_mean"] for r in by["isrtf"]]
    fcfs = [r["jct_mean"] for r in by["fcfs"]]
    ratio = (sum(isrtf) / len(isrtf)) / (sum(fcfs) / len(fcfs))
    log(f"[cli] same arrivals ({' '.join(CLI_QUEUE)}), in the order isrtf, "
        f"fcfs, fcfs, isrtf: ISRTF mean JCT {isrtf} s, FCFS {fcfs} s; "
        f"ISRTF/FCFS = {ratio:.4f}; ISRTF preemptions "
        f"{[r['preemptions'] for r in by['isrtf']]}, tokens/s "
        f"{[round(r['tokens_s'], 1) for r in by['isrtf']]} (FCFS "
        f"{[round(r['tokens_s'], 1) for r in by['fcfs']]})")
    if not all(r["preemptions"] > 0 for r in by["isrtf"]):
        raise AssertionError("serve CLI: ISRTF never preempted: the "
                             "traffic does not queue")
    swap = by["isrtf chunk+swap"][0]["counters"]
    if not (swap["swapouts"] > 0 and swap["swapins"] > 0
            and swap["chunk_dispatches"] > 0):
        raise AssertionError(f"serve CLI: the chunk+swap run did not swap "
                             f"out, swap in and chunk: {swap}")
    total = {}
    for r in runs:
        for n, c in r["launches"].items():
            total[n] = total.get(n, 0) + c
    if not (total["flash_decode"] > 0 and total["flash_attention"] > 0):
        raise AssertionError(f"serve CLI: a kernel never launched: {total}")
    log(f"[cli] launches over the phase: {json.dumps(total)}")
    return {"launches": total, "isrtf_jct": isrtf}


# --------------------------------------------------------------------------- #
# Phase 7: the BGE length predictor, its training, ISRTF ranked by it
# --------------------------------------------------------------------------- #

#: the full-width predictor's encoder (None: ``BGE_BASE``, bge-base-en-v1.5;
#: a CPU rehearsal may give a smaller ``EncoderArchConfig``)
PREDICTOR_ENCODER = None
#: pools timed at sequence bucket 512 (the full width's max_len)
PREDICTOR_POOLS = (1, 8, 32, 128)
#: fit steps of the full-width predictor at 32 x 512
FULL_FIT_STEPS = 20
#: the CLI predictor's training: examples/train_predictor.py's recipe
CLI_FIT = dict(requests=1200, max_len=192, max_steps=6, batch=32,
               steps=600)
#: card against CPU, the full-width predictor's means and rank scores:
#: both are fp32 (TF32 off), so they differ by order of summation through
#: 12 post-LN layers and 8 FC layers, amplified by the heads' exp; 1e-3 of
#: a prediction is a tenth of a token at ~100 tokens, far below the 50-token
#: window that ISRTF's ranking resolves
PREDICTOR_RTOL = 1e-3


class DispatchTimer:
    """Times every dispatch of a BGE predictor: CUDA events around its
    kernels (the device time) and the host clock around the whole call,
    which returns host numbers (what a scheduling window waits for); and
    the distinct dispatch shapes.  Its share of a run's wall time counts
    the online head updates too, where a ranked adapter makes them."""

    def __init__(self, pred):
        import torch

        self.device_ms, self.wall_ms, self.shapes = [], [], set()
        #: host time of the ranked adapter's online head updates
        self.update_ms = []
        apply, predict = pred._apply, pred.predict

        def timed_apply(params, tokens, mask):
            self.shapes.add(tokens.shape)
            if DEVICE == "cpu":
                return apply(params, tokens, mask)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = apply(params, tokens, mask)
            end.record()
            self._events = (start, end)
            return out

        def timed_predict(jobs):
            t0 = time.perf_counter()
            out = predict(jobs)
            self.wall_ms.append((time.perf_counter() - t0) * 1e3)
            if DEVICE != "cpu":
                start, end = self._events
                end.synchronize()
                self.device_ms.append(start.elapsed_time(end))
            return out

        pred._apply, pred.predict = timed_apply, timed_predict

    def summary(self, wall_s: float) -> dict:
        import statistics

        dev = self.device_ms or [float("nan")]
        return {"dispatches": len(self.wall_ms),
                "device_ms_median": statistics.median(dev),
                "device_ms_mean": sum(dev) / len(dev),
                "wall_ms_mean": sum(self.wall_ms) / max(len(self.wall_ms), 1),
                "updates": len(self.update_ms),
                "update_ms_mean": (sum(self.update_ms)
                                   / max(len(self.update_ms), 1)),
                "share_of_wall": (sum(self.wall_ms) + sum(self.update_ms))
                / 1e3 / wall_s,
                "shapes": sorted(self.shapes)}


def predictor_flops(cfg, batch: int, seq: int) -> float:
    """Flops of one dispatch over a (batch, seq) bucket: the encoder's
    projections, attention products and MLP per token, and the heads per
    row (multiply-adds count two)."""
    e = cfg.encoder
    per_token = e.n_layers * (2 * (4 * e.d_model ** 2 + 2 * e.d_model * e.d_ff)
                              + 2 * 2 * seq * e.d_model)
    heads = 2 if cfg.ranking is not None else 1
    head = 2 * (2 * e.d_model * cfg.fc_hidden
                + (cfg.n_fc_layers - 2) * cfg.fc_hidden ** 2
                + cfg.fc_hidden)
    return batch * seq * per_token + heads * batch * head


def event_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    """Median time of ``fn()`` (which returns host data) over ``reps``
    calls: CUDA events on the card, the host clock in a CPU rehearsal."""
    import statistics

    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if DEVICE == "cpu":
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
            continue
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def predictor_jobs(n: int, lengths, vocab: int, seed: int):
    """``n`` jobs whose inputs are ``lengths`` ids long in all (prompt and
    generated split in two), with generated ids past ``vocab`` (the
    engine's qwen2-1.5b ids reach 151935)."""
    import numpy as np

    from repro_torch.core import Job

    rng = np.random.RandomState(seed)
    jobs = []
    for i in range(n):
        total = int(lengths[i % len(lengths)])
        p = max(total // 2, 1)
        j = Job(job_id=i, prompt="", arrival_time=0.0,
                prompt_tokens=rng.randint(8, vocab, size=p).tolist())
        j.generated = rng.randint(8, 151936, size=max(total - p - 2, 0)
                                  ).tolist()
        jobs.append(j)
    return jobs


def predictor_parity(pred, cpu) -> dict:
    """The full-width predictor on the card against its CPU copy: a pool
    of 5 (batch bucket 8) and each job alone; ids past the vocabulary."""
    import numpy as np

    jobs = predictor_jobs(5, (24, 90, 150, 300, 510), 30522, SEED)
    got = pred.predict(jobs)
    want = cpu.predict(jobs)
    alone = [pred.predict([j])[0] for j in jobs]
    vals = lambda ps: np.array([[p.mean, p.rank_score] for p in ps])
    g, w, a = vals(got), vals(want), vals(alone)
    if not np.isfinite(g).all():
        raise AssertionError(f"predictor: non-finite predictions {g}")
    err = float(np.max(np.abs(g - w) / np.abs(w)))
    err_alone = float(np.max(np.abs(a - g) / np.abs(g)))
    log(f"[predictor] full width, card vs CPU: pool of 5 (batch bucket 8, "
        f"seq bucket 512), means {g[:, 0].round(3).tolist()}, rank scores "
        f"{g[:, 1].round(3).tolist()}; max relative error {err:.3e} "
        f"(limit {PREDICTOR_RTOL}); each job alone vs in the pool "
        f"{err_alone:.3e}")
    if not (err <= PREDICTOR_RTOL and err_alone <= PREDICTOR_RTOL):
        raise AssertionError("predictor: the card disagrees with the CPU "
                             "or padding is not inert")
    return {"max_rel_err": err, "alone_rel_err": err_alone}


def predictor_dispatch_times(pred, small) -> list:
    """Full-width dispatches over pools at sequence bucket 512, each
    against its flop bound (fp32 on the CUDA cores), and the CLI's small
    predictor at a pool of 32."""
    rows = []
    for p, n in [(pred, n) for n in PREDICTOR_POOLS] + [(small, 32)]:
        ml = p.cfg.max_len
        lists = [[8 + (i * 7 + t) % 30000 for t in range(ml)]
                 for i in range(n)]
        ms = event_ms(lambda: p.predict_tokens_ranked(lists)
                      if p.cfg.ranking is not None
                      else p.predict_tokens(lists))
        flops = predictor_flops(p.cfg, n, ml)
        bound = flops / PEAK_FLOPS["float32"] * 1e3
        rows.append({"pool": n, "seq": ml, "d_model": p.cfg.encoder.d_model,
                     "ms": ms, "bound_ms": bound, "tflop": flops / 1e12})
        log(f"[predictor] dispatch, d_model {p.cfg.encoder.d_model} x "
            f"{p.cfg.encoder.n_layers} layers, pool {n} x seq {ml}: "
            f"{ms:.3f} ms (median of 5, CUDA events around the call) "
            f"against a bound of {bound:.3f} ms ({flops / 1e12:.3f} TFLOP "
            f"at {PEAK_FLOPS['float32'] / 1e12:.0f} TFLOP/s)")
    return rows


def fit_step_parity(pred, cpu, samples) -> None:
    """One training step at a reduced batch on the card and on the CPU
    from the same parameters: loss and parameters allclose."""
    import numpy as np

    from repro_torch.data import pad_batch
    from repro_torch.training import AdamWConfig, adamw_init, make_train_step
    from repro_torch.training.tree import leaves

    opt = AdamWConfig(lr=pred.cfg.lr, warmup_steps=1, total_steps=10)
    batch = pad_batch(samples[:2], pred.cfg.max_len)
    out = []
    for p in (pred, cpu):
        step = make_train_step(p.loss_fn, opt)
        params, _, m = step(p.params, adamw_init(p.params), batch)
        out.append(([t.detach().cpu().numpy() for t in leaves(params)],
                    {k: float(v) for k, v in m.items()}))
    (gp, gm), (wp, wm) = out
    # from a zero state one AdamW step moves every trainable element by lr
    # times the sign of its gradient (plus decay), so an element whose
    # gradient is at rounding level may step either way: 2 lr apart
    atol = 2.0 * opt.lr
    perr = max(float(np.max(np.abs(a - b))) for a, b in zip(gp, wp))
    lerr = abs(gm["loss"] - wm["loss"]) / abs(wm["loss"])
    log(f"[predictor] one fit step at 2 x {pred.cfg.max_len}, card vs CPU: "
        f"loss {gm['loss']:.6f} vs {wm['loss']:.6f} (relative {lerr:.2e}), "
        f"grad norm {gm['grad_norm']:.6f} vs {wm['grad_norm']:.6f}, "
        f"params max |diff| {perr:.3e} (limit {atol:.1e})")
    if not (lerr <= 1e-4 and perr <= atol):
        raise AssertionError("predictor: a training step on the card "
                             "disagrees with the CPU")


def train_cli_predictor(small, ckpt_dir: str) -> dict:
    """The CLI's predictor trained on the card by
    examples/train_predictor.py's recipe and checkpointed; Table 2's
    metrics (and Kendall-tau) on the test split before and after."""
    from repro_torch.data import make_predictor_dataset
    from repro_torch.training import save_checkpoint

    c = CLI_FIT
    train, val, test = make_predictor_dataset(
        c["requests"], seed=0, max_len=c["max_len"], max_steps=c["max_steps"])
    before = small.evaluate(test)
    t0 = time.perf_counter()
    hist = small.fit(train, num_steps=c["steps"], batch_size=c["batch"])
    fit_s = time.perf_counter() - t0
    after = small.evaluate(test)
    last = hist[c["steps"] - 1]
    step_ms = ((last["wall_s"] - hist[0]["wall_s"]) / (c["steps"] - 1)
               * 1e3)
    path = save_checkpoint(ckpt_dir, c["steps"], small.params,
                           metadata={"metrics": after})
    fmt = lambda m: ", ".join(f"{k} {v:.4f}" for k, v in m.items())
    log(f"[predictor] CLI predictor ({len(train)} train / {len(val)} val / "
        f"{len(test)} test samples): {c['steps']} steps at {c['batch']} x "
        f"{c['max_len']} in {fit_s:.1f} s ({step_ms:.2f} ms a step); test "
        f"before: {fmt(before)}; after: {fmt(after)}; loss "
        f"{hist[0]['loss']:.4f} -> {last['loss']:.4f}; checkpoint {path}")
    if not (after["mae"] < before["mae"]):
        raise AssertionError("predictor: training did not lower the MAE")
    return {"before": before, "after": after, "step_ms": step_ms}


def ranked_server_run(pred) -> dict:
    """(b): an ``ElisServer`` of full-width qwen2-1.5b (bf16, the kernels)
    over ``CLI_QUEUE``'s traffic, ISRTF ordered by the ranking head of the
    full-width two-head predictor (ranked adapter, ``ema+conformal``)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import (ElisServer, FrontendConfig,
                                  PreemptionConfig, SchedulerConfig,
                                  make_predictor)
    from repro_torch.engine import EngineConfig, EngineExecutor, InferenceEngine
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as cli
    from repro_torch.models import transformer as T

    args = cli._parser().parse_args(CLI_QUEUE + ["--device", DEVICE])
    requests = cli.load_requests(args)[0]
    want_tokens = {r.request_id: min(r.true_output_len, args.max_output)
                   for r in requests}
    cfg = get_config("qwen2-1.5b")
    if DEVICE == "cpu":
        cfg = cfg.reduced()
    params = T.init_params(cfg, torch.Generator(DEVICE).manual_seed(0))
    engine = InferenceEngine(cfg, params, EngineConfig(
        max_slots=args.slots, max_len=512, max_output=args.max_output,
        eos_id=-1, respect_job_max=True, attn_impl="kernel"), device=DEVICE)
    executor = EngineExecutor({0: engine})
    timer = DispatchTimer(pred)
    ranked = make_predictor("ranked", bge=pred, calibration="ema+conformal")
    adapter = ranked.base.base
    update = adapter._update_heads

    def timed_update():
        t0 = time.perf_counter()
        update()
        synchronize_all()
        timer.update_ms.append((time.perf_counter() - t0) * 1e3)
    adapter._update_heads = timed_update
    server = ElisServer(FrontendConfig(
        n_nodes=1,
        scheduler=SchedulerConfig(policy="isrtf", window=args.window,
                                  batch_size=args.slots,
                                  rank_by="rank_score"),
        preemption=PreemptionConfig(enabled=True),
        observe_in_flight=False), ranked, executor)
    for r in requests:
        server.submit(r)
    ops.reset_launches()
    synchronize_all()
    t0 = time.perf_counter()
    responses = server.drain()
    synchronize_all()
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in ops.KERNELS.items()}
    run = check_served("isrtf, full-width two-head predictor, rank_score",
                       responses, executor, want_tokens, launches, wall)
    run["predictor"] = timer.summary(wall)
    run["n_updates"] = adapter.n_updates
    run["max_pool"] = len(requests)
    del responses, executor, engine, params, server
    return run


def predictor_phase(oracle_isrtf_jct) -> dict:
    """Phase 7: the BGE predictor at full width (card against CPU,
    dispatch times, training), the CLI's predictor trained and restored
    by ``--predictor-ckpt``, and ISRTF served ranked by each."""
    import torch

    from repro_torch.core import BGEPredictor, PredictorConfig, RankingConfig
    from repro_torch.data import make_predictor_dataset, n_shape_buckets
    from repro_torch.launch import serve as cli
    from repro_torch.models import encoder as E
    from repro_torch.training.tree import leaves, tree_map

    t_phase = time.perf_counter()
    enc = PREDICTOR_ENCODER or E.BGE_BASE
    cfg = PredictorConfig(encoder=enc, max_len=enc.max_len,
                          ranking=RankingConfig())
    pred = BGEPredictor(cfg, seed=SEED, device=DEVICE)
    cpu = BGEPredictor(cfg, seed=SEED, device="cpu")
    cpu.params = tree_map(lambda t: t.cpu(), pred.params)
    n_params = sum(t.numel() for t in leaves(pred.params))
    log(f"[predictor] two-head BGE predictor: encoder d_model {enc.d_model}, "
        f"{enc.n_heads} heads, {enc.n_layers} layers, d_ff {enc.d_ff}, vocab "
        f"{enc.vocab_size}, max_len {cfg.max_len}; heads {cfg.n_fc_layers} x "
        f"{cfg.fc_hidden}; {n_params / 1e6:.1f} M parameters, fp32, seed "
        f"{SEED}")
    out = {"parity": predictor_parity(pred, cpu)}
    small = cli.build_predictor(SimpleNamespace(
        predictor="bge", predictor_ckpt=None, calibrate="none"), DEVICE)
    out["dispatch"] = predictor_dispatch_times(pred, small)

    train, _, _ = make_predictor_dataset(600, seed=0, max_len=cfg.max_len)
    fit_step_parity(pred, cpu, train)
    del cpu
    gc.collect()
    hist = pred.fit(train, num_steps=FULL_FIT_STEPS, batch_size=32)
    last = hist[FULL_FIT_STEPS - 1]
    step_ms = (last["wall_s"] - hist[0]["wall_s"]) / (FULL_FIT_STEPS - 1) * 1e3
    bound = 3 * predictor_flops(cfg, 32, cfg.max_len) / PEAK_FLOPS[
        "float32"] * 1e3
    log(f"[predictor] full-width fit: {FULL_FIT_STEPS} steps at 32 x "
        f"{cfg.max_len}, {step_ms:.2f} ms a step (host clock between the "
        f"logged steps, which read the loss) against a bound of "
        f"{bound:.2f} ms (3x the forward's flops); loss {hist[0]['loss']:.4f}"
        f" -> {last['loss']:.4f}")
    if not all(math.isfinite(h["loss"]) for h in hist.values()):
        raise AssertionError("predictor: a fit loss is not finite")
    out["fit_step_ms"], out["fit_bound_ms"] = step_ms, bound

    ckpt = ROOT / "build" / "predictor_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    ckpt.mkdir(parents=True)
    out["cli_training"] = train_cli_predictor(small, str(ckpt))
    del small

    # (a) the CLI: ISRTF ranked by the trained CLI predictor, restored
    timers = []
    run_a = cli_run("isrtf bge+ckpt ema+conformal",
                    CLI_QUEUE + ["--policy", "isrtf", "--predictor", "bge",
                                 "--predictor-ckpt", str(ckpt),
                                 "--calibrate", "ema+conformal"],
                    predictor_probe=lambda p: timers.append(
                        DispatchTimer(p.base.base)))
    run_a["predictor"] = timers[0].summary(run_a["wall_s"])
    run_a["max_pool"] = int(CLI_QUEUE[CLI_QUEUE.index("--n") + 1])
    # (b) an ElisServer ranked by the full-width two-head predictor
    run_b = ranked_server_run(pred)
    if run_b["n_updates"] <= 0:
        raise AssertionError("predictor: the ranked adapter never updated "
                             "its heads online")
    oracle = sum(oracle_isrtf_jct) / len(oracle_isrtf_jct)
    for run, p in ((run_a, 192), (run_b, cfg.max_len)):
        s = run["predictor"]
        bound = n_shape_buckets(run["max_pool"], p)
        if not (s["dispatches"] > 0 and len(s["shapes"]) <= bound):
            raise AssertionError(f"predictor: {run['name']}: "
                                 f"{s['dispatches']} dispatches, shapes "
                                 f"{s['shapes']} (bound {bound})")
        log(f"[predictor] {run['name']}: JCT mean {run['jct_mean']:.3f} s, "
            f"p99 {run['jct_p99']:.3f} s, {run['tokens_s']:.1f} tokens/s, "
            f"preemptions {run['preemptions']}; predictor: "
            f"{s['dispatches']} dispatches over {len(s['shapes'])} shapes "
            f"(bound {bound}): {s['shapes']}, device time "
            f"{s['device_ms_median']:.3f} ms median ({s['device_ms_mean']:.3f}"
            f" mean) a dispatch, {s['wall_ms_mean']:.3f} ms on the host "
            f"clock; {s['updates']} online head updates of "
            f"{s['update_ms_mean']:.1f} ms; {100 * s['share_of_wall']:.2f}% "
            f"of the {run['wall_s']:.1f} s serving wall; mean JCT / phase "
            f"6's oracle ISRTF runs' "
            f"{run['jct_mean'] / oracle:.4f}")
    log(f"[predictor] (b) online head updates: {run_b['n_updates']}")
    out["runs"] = [run_a, run_b]
    del pred
    gc.collect()
    if DEVICE != "cpu":
        torch.cuda.empty_cache()
    log(f"[predictor] phase 7 in {time.perf_counter() - t_phase:.1f} s")
    return out


def swap_roundtrip(cfg, params, requests) -> None:
    """One slot's cache offloaded to the host and restored, at full width:
    bit for bit, and the greedy streams of both jobs equal to those of an
    engine that keeps the job resident over the same schedule (the job
    sits out one window either way)."""
    import torch

    from repro_torch.core import Job
    from repro_torch.engine import EngineConfig, InferenceEngine
    from repro_torch.engine.engine import _gather_slots

    prompts = [list(r.prompt_tokens) for r in requests[:2]]
    streams = []
    for swap in (True, False):
        eng = InferenceEngine(cfg, params, EngineConfig(
            max_slots=2, max_len=MAX_LEN, max_output=64, eos_id=-1),
            device=DEVICE)
        jobs = [Job(job_id=i, prompt="", prompt_tokens=p, arrival_time=0.0)
                for i, p in enumerate(prompts)]

        def window(batch):
            toks, _ = eng.run_window(batch, 8)
            for j, t in zip(batch, toks):
                j.generated.extend(t)

        def slot_leaves():
            idx = torch.tensor([eng.slot_of[0]], device=eng.device)
            sub = _gather_slots(eng.cache, idx)
            return [sub["len"], sub["kv"].k, sub["kv"].v]

        window(jobs)
        if swap:
            before = [t.clone() for t in slot_leaves()]
            if not eng.offload_job(0):
                raise AssertionError("swap round trip: offload refused")
        window(jobs[1:])
        if swap:
            eng.restore_job(jobs[0])
            same = all(torch.equal(a, b)
                       for a, b in zip(slot_leaves(), before))
            n_bytes = sum(t.numel() * t.element_size() for t in before)
            if not same:
                raise AssertionError("swap round trip: the restored slot "
                                     "differs from the offloaded one")
        window(jobs)
        window(jobs)
        streams.append([list(j.generated) for j in jobs])
        del eng
    if streams[0] != streams[1]:
        raise AssertionError(f"swap round trip: streams differ from the "
                             f"resident engine's: {streams}")
    log(f"[swap] {cfg.arch_id} {cfg.dtype}, full width: one slot's cache "
        f"({n_bytes / 1e6:.1f} MB, {MAX_LEN} rows) offloaded to the host and "
        f"restored bit for bit; greedy streams of both jobs identical to a "
        f"resident engine's over the same schedule "
        f"({sum(map(len, streams[0]))} tokens)")


def chunk_parity(cfg, requests) -> None:
    """fp32 greedy tokens at full width and 2 layers: chunked prefill (8
    tokens a window, plain ``sdpa``) against one-shot prefill
    (``flash_attention``), identical on every token."""
    import torch

    from repro_torch.core import Job
    from repro_torch.engine import EngineConfig, InferenceEngine
    from repro_torch.models import transformer as T

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    params2 = T.init_params(
        cfg2, torch.Generator(device=DEVICE).manual_seed(SEED + 1))
    prompts = [list(r.prompt_tokens)[:40] for r in requests[:4]]
    streams = []
    for chunk in (None, 8):
        eng = InferenceEngine(cfg2, params2, EngineConfig(
            max_slots=4, max_len=MAX_LEN, max_output=64, eos_id=-1),
            device=DEVICE)
        jobs = [Job(job_id=i, prompt="", prompt_tokens=p, arrival_time=0.0)
                for i, p in enumerate(prompts)]
        while any(len(j.generated) < 16 for j in jobs):
            toks, _ = eng.run_window(jobs, 8, prefill_chunk=chunk)
            for j, t in zip(jobs, toks):
                j.generated.extend(t)
        streams.append([j.generated[:16] for j in jobs])
        chunks = eng.num_chunk_dispatches
    same = sum(a == b for g, w in zip(*streams) for a, b in zip(g, w))
    log(f"[parity] {cfg.arch_id} fp32, full width, 2 layers: chunked "
        f"prefill (chunk 8, {chunks} chunk dispatches) vs one-shot prefill "
        f"greedy tokens identical on {same}/{16 * len(prompts)} tokens")
    if streams[0] != streams[1]:
        raise AssertionError("chunked prefill: fp32 greedy tokens differ "
                             "from one-shot prefill's")


def build_report() -> None:
    """Log ptxas's registers and spills of every kernel instance, by
    kernel (demangled with ``c++filt`` where the machine has it)."""
    from repro_torch.kernels import build

    for name in build.SOURCES:
        entry, lines = "?", []
        for line in build.build_log(name).splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = m.group(1)
            elif "registers" in line or "spill" in line:
                lines.append((entry, line.strip()))
        names = sorted({e for e, _ in lines})
        if shutil.which("c++filt") and names:
            out = subprocess.run(["c++filt"], input="\n".join(names),
                                 capture_output=True, text=True).stdout
            demangled = dict(zip(names, out.splitlines()))
        else:
            demangled = {}
        for entry, line in lines:
            short = re.sub(r"\(anonymous namespace\)::", "",
                           demangled.get(entry, entry)).split("(")[0]
            log(f"[build] {name}: {short}: {line}")


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
    build_report()

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

    # phase 6: the serve CLI at full width (it makes its own weights)
    t0 = time.perf_counter()
    cfg, requests = models[0]
    params = random_params(cfg)
    swap_roundtrip(cfg, params, requests)
    del params
    chunk_parity(cfg, requests)
    cli_phase = serve_cli_phase()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[cli] phase 6 in {time.perf_counter() - t0:.1f} s")

    # phase 7: the BGE predictor, its training, ISRTF ranked by it
    predictor_phase(cli_phase["isrtf_jct"])
    gc.collect()
    torch.cuda.empty_cache()

    # the step entry points over int8 caches (launch/steps.py), qwen2-1.5b
    params = random_params(cfg)
    launches["flash_decode_int8"] = int8_step_path(cfg, params)
    ring_step(cfg, params)
    if not int8_greedy_parity(cfg):
        raise AssertionError("int8 step path: fp32 greedy tokens differ "
                             "between the kernel and plain paths")
    gap, _, finite = int8_logit_gaps(cfg, params)
    if not finite or not gap <= INT8_LOGIT_TOL_BF16:
        raise AssertionError("int8 step path: bf16 decode logits of the "
                             "kernel path disagree with the plain path")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    decode_32k_steps(cfg)

    served = {"flash_decode": dict(dtype="bfloat16", B=4, window=None),
              "flash_decode_int8": dict(dtype="bfloat16", B=4, D=HEAD_DIM,
                                        window=None, note=""),
              "flash_attention": dict(dtype="bfloat16", B=4, S=512,
                                      window=None),
              "ssd_scan": dict(dtype="bfloat16", S=512, chunk=256, pad=0),
              "flash_decode_sharded": dict(dtype="bfloat16", B=4, tp=TP)}
    meta = {
        "flash_decode_sharded": ("src/repro_torch/csrc/decode_attention.cu",
                                 "src/repro/kernels/decode_attention.py:244"),
        "flash_decode": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:35"),
        "flash_decode_int8": ("src/repro_torch/csrc/decode_attention.cu",
                              "src/repro/kernels/decode_attention.py:81"),
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
