"""The model zoo in PyTorch: every family of the assigned archs (layers
and model assembly) and the training objectives."""
from repro_torch.models.transformer import (
    decode_step,
    embed_inputs,
    forward,
    init_cache,
    init_params,
    prefill,
)
from repro_torch.models.objective import cross_entropy, loss_fn

__all__ = [
    "cross_entropy",
    "decode_step",
    "embed_inputs",
    "forward",
    "init_cache",
    "init_params",
    "loss_fn",
    "prefill",
]
