"""The four assigned input shapes and per-(arch, shape) inputs: the port of
``repro.launch.shapes``.

``input_specs(cfg, shape)`` returns every model input of one (arch, shape)
pair as tensors on ``device``: on ``meta`` (the default, the counterpart of
JAX's ``ShapeDtypeStruct``) they have shapes and dtypes and allocate
nothing; on a real device they are zeros.  Decode shapes feed
``serve_step`` (ONE token + a KV cache of seq_len), prefill shapes the
prompt pass, train shapes the training step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as T

#: long_500k carve-in window for pure full-attention archs
LONG_CONTEXT_WINDOW = 8192


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, InputShape] = {
    s.name: s
    for s in [
        InputShape("train_4k", 4_096, 256, "train"),
        InputShape("prefill_32k", 32_768, 32, "prefill"),
        InputShape("decode_32k", 32_768, 128, "decode"),
        InputShape("long_500k", 524_288, 1, "decode"),
    ]
}


def supported(cfg, shape: InputShape) -> bool:
    """The one skip: an arch whose long-context mode is unsupported."""
    return not (shape.name == "long_500k"
                and cfg.long_context_mode == "unsupported")


def _decoder_seq(cfg, seq_len: int) -> int:
    """The decoder's sequence length (capped for the audio family, which
    the port does not serve yet)."""
    if cfg.family == "audio":
        return min(seq_len, cfg.max_position_embeddings)
    return seq_len


def _window(cfg, shape: InputShape) -> Optional[int]:
    """Sliding-window carve-in: only for long_500k on full-attention archs."""
    if shape.name == "long_500k" and cfg.long_context_mode == "sliding_window":
        return LONG_CONTEXT_WINDOW
    return None


def input_specs(cfg, shape: InputShape, *, kv_dtype: Optional[str] = None,
                device="meta") -> Dict:
    """Inputs of one (arch, shape) pair on ``device`` ("meta", "cpu" or
    "cuda"): ``tokens`` (and ``labels`` for train), and for prefill and
    decode the ``cache`` of ``transformer.init_cache`` (a ring of
    :data:`LONG_CONTEXT_WINDOW` rows for long_500k on sliding-window archs;
    ``kv_dtype="int8"`` for the quantized cache).  Raises
    ``NotImplementedError`` for the families the port does not serve."""
    if cfg.family not in T.FAMILIES:
        raise NotImplementedError(
            f"input_specs: family {cfg.family!r} is not ported yet "
            f"(ported: {T.FAMILIES})")
    dev = torch.device(device)
    if dev.type != "meta":
        dev = resolve_device(device)
    b = shape.global_batch
    s = _decoder_seq(cfg, shape.seq_len)

    def tokens(n):
        return torch.zeros((b, n), dtype=torch.int32, device=dev)

    if shape.kind == "train":
        return {"tokens": tokens(s), "labels": tokens(s)}
    if shape.kind == "prefill":
        return {"tokens": tokens(s),
                "cache": T.init_cache(cfg, b, s, dev, kv_dtype=kv_dtype,
                                      sliding_window=_window(cfg, shape))}
    return {"tokens": tokens(1),
            "cache": T.init_cache(cfg, b, shape.seq_len, dev,
                                  kv_dtype=kv_dtype,
                                  sliding_window=_window(cfg, shape))}
