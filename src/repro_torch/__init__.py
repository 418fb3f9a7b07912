"""PyTorch/CUDA port of the ELIS serving stack.

Module paths mirror ``repro`` (``repro_torch.core.frontend`` is the
counterpart of ``repro.core.frontend``).  The package imports ``torch`` and
never ``jax`` or ``repro``: host-side modules it needs are kept as copies.
Attention on the served path runs through hand-written CUDA kernels for
Hopper (``repro_torch/csrc``), each with a plain PyTorch version beside it.
"""
