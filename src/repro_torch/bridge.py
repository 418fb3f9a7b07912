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
    """The port's dense, vlm, hybrid or audio cache dict -> numpy arrays
    ``length``, ``k``, ``v`` (and ``k_scale``, ``v_scale`` when it is
    int8; the hybrid's ``groups_ssm`` and ``tail_ssm`` dicts; the audio
    family's ``cross_k`` and ``cross_v``), the keyword arguments of
    :func:`cache_from_numpy`, :func:`hybrid_cache_from_numpy` or
    :func:`audio_cache_from_numpy` less ``ring``; bfloat16 buffers come
    back as float32."""
    kv = cache["kv"]
    out = {"length": cache["len"]}
    for name in ("groups_ssm", "tail_ssm"):
        if name in cache:
            out[name] = cache[name]
    out.update(k=kv.k, v=kv.v)
    if kv.quantized:
        out.update(k_scale=kv.k_scale, v_scale=kv.v_scale)
    if "cross_kv" in cache:
        out.update(cross_k=cache["cross_kv"].k, cross_v=cache["cross_kv"].v)
    return params_to_numpy(out)


def audio_cache_from_numpy(length, k, v, cross_k, cross_v, *, k_scale=None,
                           v_scale=None, device="cuda",
                           dtype: Optional[torch.dtype] = None):
    """A JAX audio-family decode cache (its ``len`` vector, the
    self-attention ``KVCache`` buffers (n_layers, B, L, KH, D), with
    ``k_scale``/``v_scale`` for an int8 cache, and the ``cross_kv``
    buffers ``cross_k``/``cross_v`` (n_layers, B, n_frames, H, d_model //
    H), as numpy arrays) -> the port's cache dict."""
    dev = resolve_device(device)
    cache = cache_from_numpy(length, k, v, k_scale=k_scale, v_scale=v_scale,
                             device=dev, dtype=dtype)
    cache["cross_kv"] = KVCache(_tensor(cross_k, dev, dtype),
                                _tensor(cross_v, dev, dtype))
    return cache


def hybrid_cache_from_numpy(length, groups_ssm, k, v, *, tail_ssm=None,
                            k_scale=None, v_scale=None, ring: bool = False,
                            device="cuda",
                            dtype: Optional[torch.dtype] = None):
    """A JAX hybrid-family decode cache (its ``len`` vector; the states
    ``groups_ssm`` and ``tail_ssm``, dicts of ``conv`` and ``ssm`` stacked
    (n_groups, inner, B, ...) and (tail, B, ...); and the ``KVCache``
    buffers (n_groups, B, L, KH, D), with ``k_scale``/``v_scale`` for an
    int8 cache, as numpy arrays, and its ``ring`` flag) -> the port's
    cache dict.  A config without tail layers has no ``tail_ssm``."""
    dev = resolve_device(device)
    cache = {"len": _tensor(length, dev, torch.int32)}
    for name, states in (("groups_ssm", groups_ssm), ("tail_ssm", tail_ssm)):
        if states is not None:
            cache[name] = {s: _tensor(a, dev, dtype)
                           for s, a in states.items()}
    cache["kv"] = cache_from_numpy(length, k, v, k_scale=k_scale,
                                   v_scale=v_scale, ring=ring, device=dev,
                                   dtype=dtype)["kv"]
    return cache


def ssm_cache_from_numpy(length, conv, ssm, *, device="cuda",
                         dtype: Optional[torch.dtype] = None):
    """A JAX SSM-family decode cache (its ``len`` vector and the stacked
    states ``conv`` (n_layers, B, CH, d_conv - 1) and ``ssm`` (n_layers, B,
    H, P, N), as numpy arrays) -> the port's cache dict."""
    dev = resolve_device(device)
    return {"len": _tensor(length, dev, torch.int32),
            "ssm": {"conv": _tensor(conv, dev, dtype),
                    "ssm": _tensor(ssm, dev, dtype)}}
