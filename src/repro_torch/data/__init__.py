from repro_torch.data.dataset import (
    MIN_SEQ_BUCKET,
    WINDOW,
    batch_bucket,
    n_shape_buckets,
    seq_bucket,
)
from repro_torch.data.tokenizer import EOS_ID, PAD_ID, HashTokenizer

__all__ = [
    "EOS_ID",
    "HashTokenizer",
    "MIN_SEQ_BUCKET",
    "PAD_ID",
    "WINDOW",
    "batch_bucket",
    "n_shape_buckets",
    "seq_bucket",
]
