"""The rank a piece of work belongs to.

One process drives every rank of a pod, so the model's loops over a
pod's ranks and the kernel wrappers' launches a rank go through
:func:`ranked`, which marks the rank whose work runs.  Nothing reads the
mark but a counter that charges each op to its rank (the dry run,
``launch.dryrun``); the mark changes nothing a step computes.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional

_RANK: List[Optional[int]] = [None]


def current_rank() -> Optional[int]:
    """The index of the rank whose work runs now (:func:`ranked`), or None
    outside every rank loop."""
    return _RANK[0]


def set_rank(rank: Optional[int]) -> None:
    """Mark ``rank`` current (the dry run's backward hooks)."""
    _RANK[0] = rank


def ranked(items):
    """Yield ``items``, one a rank in rank order, marking rank ``i``
    current while the caller handles item ``i``; the mark before the loop
    is restored after it."""
    prev = _RANK[0]
    try:
        for i, item in enumerate(items):
            _RANK[0] = i
            yield item
    finally:
        _RANK[0] = prev


@contextlib.contextmanager
def on_rank(rank: Optional[int]):
    """Mark ``rank`` current while the block runs (None: no rank's loop,
    work the pod's rank 0 does)."""
    prev = _RANK[0]
    _RANK[0] = rank
    try:
        yield
    finally:
        _RANK[0] = prev
