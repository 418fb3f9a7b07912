"""Deterministic word-hash tokenizer.

No external vocabulary files exist offline, so we use a stable-hash word
tokenizer: every whitespace-separated word maps to a fixed id in
``[N_SPECIAL, vocab)`` via FNV-1a.  Deterministic across runs/processes
(unlike Python's ``hash``), collision rate is acceptable at vocab 8k for the
synthetic workload, and it round-trips token *ids* (not text) which is all the
predictor and engine need.
"""
from __future__ import annotations

from typing import List, Sequence

PAD_ID = 0
CLS_ID = 1
SEP_ID = 2
UNK_ID = 3
BOS_ID = 4
EOS_ID = 5
N_SPECIAL = 8


def _fnv1a(word: str) -> int:
    h = 0xCBF29CE484222325
    for ch in word.encode("utf-8"):
        h ^= ch
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


class HashTokenizer:
    def __init__(self, vocab_size: int = 8192):
        if vocab_size <= N_SPECIAL:
            raise ValueError("vocab too small")
        self.vocab_size = vocab_size

    def token_id(self, word: str) -> int:
        return N_SPECIAL + _fnv1a(word.lower()) % (self.vocab_size - N_SPECIAL)

    def encode(self, text: str, *, add_cls: bool = False) -> List[int]:
        ids = [self.token_id(w) for w in text.split()]
        return ([CLS_ID] + ids) if add_cls else ids

    def encode_pair(self, prompt: str, partial: Sequence[int]) -> List[int]:
        """[CLS] prompt [SEP] partial-output-token-ids — the iterative
        predictor's input format."""
        return [CLS_ID] + self.encode(prompt) + [SEP_ID] + list(partial)
