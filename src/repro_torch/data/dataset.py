"""Shape buckets shared by the engine's prefill and decode dispatches.

A copy of the bucket ladder in ``repro.data.dataset`` (the predictor's
dataset builders are not part of this slice).
"""
from __future__ import annotations

WINDOW = 50  # tokens per scheduling iteration (paper §4.1)

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
