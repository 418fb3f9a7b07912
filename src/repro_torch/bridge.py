"""Bridge from the JAX reference's parameters and caches to the port's.

The JAX side hands over numpy arrays (``np.asarray`` of each leaf), so this
module needs neither JAX nor ``repro``.  The layout is kept as it is:
weights ``(in, out)`` used as ``x @ W``, layers stacked on a leading axis,
the same nested dict keys.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.layers import KVCache


def _tensor(a, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own (JAX's comes from ml_dtypes):
        # move the raw bits and reinterpret them
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    else:
        # a private copy: JAX's host arrays are read-only
        t = torch.from_numpy(np.array(a, copy=True, order="C"))
    t = t.to(device)
    return t if dtype is None else t.to(dtype)


#: SSM parameter leaves the reference always keeps in fp32
#: (``repro.models.ssm.init_ssm``): casting them would change the SSM's
#: arithmetic
FP32_LEAVES = ("A_log", "dt_bias", "D")


def params_from_numpy(tree, device="cuda", dtype: Optional[torch.dtype] = None):
    """A nested dict/list of numpy arrays (a JAX parameter pytree after
    ``np.asarray`` of each leaf) -> the same structure of tensors on
    ``device``, cast to ``dtype`` when it is given; the leaves named in
    :data:`FP32_LEAVES` become fp32 whatever ``dtype`` is."""
    dev = resolve_device(device)

    def conv(x, name=None):
        if isinstance(x, dict):
            return {k: conv(v, k) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return _tensor(x, dev, torch.float32 if name in FP32_LEAVES else dtype)

    return conv(tree)


def params_to_numpy(tree) -> Any:
    """Tensors -> numpy arrays, same structure.  bfloat16 leaves come back
    as float32, which holds every bfloat16 value exactly."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def cache_from_numpy(length, k, v, *, k_scale=None, v_scale=None,
                     ring: bool = False, device="cuda",
                     dtype: Optional[torch.dtype] = None):
    """A JAX decode cache (its ``len`` vector and the dense ``KVCache``
    buffers (n_layers, B, L, KH, D), as numpy arrays, with its ``ring``
    flag) -> the port's cache dict.  With ``k_scale``/``v_scale`` (n_layers,
    B, L) the cache is int8: its codes stay int8 and its scales fp32
    whatever ``dtype`` is."""
    dev = resolve_device(device)
    if k_scale is None:
        kv = KVCache(_tensor(k, dev, dtype), _tensor(v, dev, dtype), ring)
    else:
        kv = KVCache(_tensor(k, dev, torch.int8), _tensor(v, dev, torch.int8),
                     ring, _tensor(k_scale, dev, torch.float32),
                     _tensor(v_scale, dev, torch.float32))
    return {"len": _tensor(length, dev, torch.int32), "kv": kv}


def cache_to_numpy(cache) -> Dict[str, Any]:
    """The port's dense cache dict -> numpy arrays ``len``, ``k``, ``v``
    (and ``k_scale``, ``v_scale`` when it is int8), the keyword arguments
    of :func:`cache_from_numpy` less ``ring``; bfloat16 buffers come back
    as float32."""
    kv = cache["kv"]
    out = {"length": cache["len"], "k": kv.k, "v": kv.v}
    if kv.quantized:
        out.update(k_scale=kv.k_scale, v_scale=kv.v_scale)
    return params_to_numpy(out)


def ssm_cache_from_numpy(length, conv, ssm, *, device="cuda",
                         dtype: Optional[torch.dtype] = None):
    """A JAX SSM-family decode cache (its ``len`` vector and the stacked
    states ``conv`` (n_layers, B, CH, d_conv - 1) and ``ssm`` (n_layers, B,
    H, P, N), as numpy arrays) -> the port's cache dict."""
    dev = resolve_device(device)
    return {"len": _tensor(length, dev, torch.int32),
            "ssm": {"conv": _tensor(conv, dev, dtype),
                    "ssm": _tensor(ssm, dev, dtype)}}
