"""Datasets for the response-length predictor, and the shape
buckets shared by the predictor's and the engine's dispatches.

A numpy-only copy of ``repro.data.dataset``.  Mirrors the paper's §4.2
construction: each (prompt, answer) pair yields *step samples* — one per
50-token iteration window — whose input is ``[CLS] prompt [SEP]
answer[:k*50]`` and whose label is the *remaining* length ``len(answer) -
k*50``.  Outlier removal (IQR on log-length) and the 6:2:2 split follow the
paper.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Sequence

import numpy as np

from repro_torch.data.tokenizer import CLS_ID, PAD_ID, SEP_ID
from repro_torch.data.workload import Request, WorkloadGenerator

WINDOW = 50  # tokens per scheduling iteration (paper §4.1)


@dataclass
class StepSample:
    tokens: List[int]
    remaining: int
    step: int  # iteration index (0 = prompt only)
    request_id: int


def build_step_samples(requests: Sequence[Request], *, max_steps: int = 8,
                       max_len: int = 512) -> List[StepSample]:
    out: List[StepSample] = []
    for r in requests:
        total = r.true_output_len
        n_steps = min(max_steps, total // WINDOW + 1)
        for k in range(n_steps):
            consumed = k * WINDOW
            remaining = total - consumed
            if remaining <= 0:
                break
            toks = clip_step_input(r.prompt_tokens,
                                   r.output_tokens[:consumed], max_len)
            out.append(
                StepSample(tokens=toks, remaining=remaining,
                           step=k, request_id=r.request_id)
            )
    return out


def clip_step_input(prompt_tokens, generated, max_len: int) -> List[int]:
    """[CLS] prompt [SEP] <most-recent output tokens that fit>.

    Keeps the *tail* of the partial output — the recent tokens carry the
    completion signal (closing phase) that iterative prediction exploits."""
    head = [CLS_ID] + list(prompt_tokens) + [SEP_ID]
    room = max(max_len - len(head), 0)
    return (head + list(generated)[-room:])[:max_len]


def iqr_filter(samples: List[StepSample]) -> List[StepSample]:
    """Paper: remove outliers via IQR on log-transformed lengths."""
    logs = np.log([s.remaining for s in samples])
    q1, q3 = np.percentile(logs, [25, 75])
    iqr = q3 - q1
    lo, hi = q1 - 1.5 * iqr, q3 + 1.5 * iqr
    return [s for s, l in zip(samples, logs) if lo <= l <= hi]


def split_622(samples: List[StepSample], seed: int = 0):
    rng = np.random.RandomState(seed)
    idx = rng.permutation(len(samples))
    n = len(samples)
    a, b = int(0.6 * n), int(0.8 * n)
    pick = lambda ids: [samples[i] for i in ids]
    return pick(idx[:a]), pick(idx[a:b]), pick(idx[b:])

#: smallest sequence bucket — shorter inputs all share one compiled shape
MIN_SEQ_BUCKET = 32


def batch_bucket(n: int) -> int:
    """Smallest power of two >= ``n`` (>= 1) — the padded batch size.

    Bucketing the batch dimension means a jitted apply compiles once per
    bucket instead of once per distinct pool size (an XLA retrace storm
    when the pool grows one job at a time)."""
    return 1 << max(n - 1, 0).bit_length()


def seq_bucket(n: int, max_len: int, min_bucket: int = MIN_SEQ_BUCKET) -> int:
    """Padded sequence length: the power-of-two ladder
    ``min_bucket, 2*min_bucket, ... , max_len`` (capped at ``max_len``)."""
    return min(batch_bucket(max(n, min_bucket)), max_len)


def n_shape_buckets(max_batch: int, max_len: int,
                    min_bucket: int = MIN_SEQ_BUCKET) -> int:
    """Upper bound on distinct (batch, seq) shapes the bucketing can emit
    for pools up to ``max_batch`` — the recompile-storm guard bound."""
    batches = {batch_bucket(b) for b in range(1, max(max_batch, 1) + 1)}
    seqs = {seq_bucket(s, max_len, min_bucket)
            for s in range(1, max(max_len, 1) + 1)}
    return len(batches) * len(seqs)


def pad_batch(samples: Sequence[StepSample], max_len: int) -> Dict[str, np.ndarray]:
    b = len(samples)
    tokens = np.full((b, max_len), PAD_ID, np.int32)
    mask = np.zeros((b, max_len), bool)
    labels = np.zeros((b,), np.float32)
    steps = np.zeros((b,), np.int32)
    for i, s in enumerate(samples):
        t = s.tokens[:max_len]
        tokens[i, : len(t)] = t
        mask[i, : len(t)] = True
        labels[i] = s.remaining
        steps[i] = s.step
    return {"tokens": tokens, "mask": mask, "labels": labels, "steps": steps}


def batch_iterator(samples: List[StepSample], batch_size: int, max_len: int,
                   seed: int = 0, loop: bool = True) -> Iterator[Dict]:
    rng = np.random.RandomState(seed)
    while True:
        order = rng.permutation(len(samples))
        for i in range(0, len(samples) - batch_size + 1, batch_size):
            chunk = [samples[j] for j in order[i : i + batch_size]]
            yield pad_batch(chunk, max_len)
        if not loop:
            return


def make_predictor_dataset(n_requests: int = 2000, *, seed: int = 0,
                           max_len: int = 256, max_steps: int = 8):
    """End-to-end: workload -> step samples -> IQR filter -> 6:2:2 split."""
    gen = WorkloadGenerator(seed=seed)
    reqs = gen.sample_requests(n_requests)
    samples = iqr_filter(build_step_samples(reqs, max_steps=max_steps,
                                            max_len=max_len))
    return split_622(samples, seed=seed)
