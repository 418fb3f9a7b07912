"""Tensor-parallel partition rules — the dense subset of
``repro.launch.partition``.

The reference hands partition specs to GSPMD, which splits the arrays and
inserts the collectives.  The port splits the parameter tree itself into
one tree per rank (:func:`shard_params`), and the model sums the
row-parallel partials itself (:mod:`repro_torch.models.transformer`).
The rules are the reference's: vocab, heads and the FFN hidden axis on
"model", norms replicated.  Shards are contiguous ranges of whole heads,
so each rank's K/V slice is a contiguous tensor that the decode kernel
takes as it is.

Each rank holds the KV heads its own query heads read, a contiguous range:
its share of them when the rank count divides ``n_kv_heads``, or the one
KV head of its query heads when ``n_kv_heads`` divides the rank count
(qwen2-1.5b's 2 KV heads over 4 ranks: ranks 0-1 hold KV head 0, ranks 2-3
KV head 1).  Either way a rank's query heads read its KV heads at one
ratio, so the decode and prefill kernels serve every rank as they are.
The reference replicates KV in the second layout (``sanitize_specs``) and
falls back to XLA; the port serves it through the kernels.  A layout where
neither count divides the other is refused.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

#: leaf name -> (logical ndim, spec tail); leading stacked (layer) axes are
#: replicated.  "model" marks the axis split across ranks.
_PARAM_RULES: Dict[str, Tuple[int, Tuple]] = {
    "embed": (2, ("model", None)),        # (vocab, d)
    "lm_head": (2, (None, "model")),      # (d, vocab)
    "wq": (2, (None, "model")),
    "wk": (2, (None, "model")),
    "wv": (2, (None, "model")),
    "wo": (2, ("model", None)),
    "bq": (1, ("model",)),
    "bk": (1, ("model",)),
    "bv": (1, ("model",)),
    "w_gate": (2, (None, "model")),
    "w_up": (2, (None, "model")),
    "w_down": (2, ("model", None)),
    "scale": (1, (None,)),
}
#: leaves split by KV head: each rank takes its kv_head_range
_KV_LEAVES = ("wk", "wv", "bk", "bv")

#: families the tensor-parallel path serves
TP_FAMILIES = ("dense",)


def tp_ranks(mesh) -> List[torch.device]:
    """The ranks of a single-axis ``("model",)`` mesh (one TP pod), in
    order; raises ``ValueError`` for any other mesh."""
    if tuple(mesh.axis_names) != ("model",):
        raise ValueError(f"a TP pod needs the single mesh axis ('model',), "
                         f"got {tuple(mesh.axis_names)} — split the mesh "
                         "into pods with launch.mesh.pod_meshes")
    return mesh.ranks


def check_family(cfg) -> None:
    if cfg.family not in TP_FAMILIES:
        raise NotImplementedError(
            f"tensor parallelism of family {cfg.family!r} is not ported "
            "(ROADMAP.md, queue 1 item 5: the SSM in_proj packs z/x/B/C/dt "
            "into one column block, so column-sharding it needs its own "
            "design)")


def _layout_reason(cfg, tp: int) -> Optional[str]:
    """Why the query and KV heads of ``cfg`` cannot be laid out over ``tp``
    ranks, or ``None``."""
    h, kh = cfg.n_heads, cfg.n_kv_heads
    if h % tp or (kh % tp and tp % kh):
        return (f"layout: heads ({h} q / {kh} kv) do not divide the 'model' "
                f"axis (size {tp}) — and the axis size is no multiple of the "
                "KV heads, so a rank's query heads cannot read one range of "
                "KV heads at one ratio; the port serves no such layout")
    return None


def kv_head_range(cfg, tp: int, rank: int) -> Tuple[int, int]:
    """The KV heads ``[lo, hi)`` that rank ``rank``'s query heads read (on
    one device, global query head ``j`` reads KV head ``j // (H / KH)``)."""
    kh = cfg.n_kv_heads
    if kh % tp == 0:
        n = kh // tp
        return rank * n, (rank + 1) * n
    g = rank // (tp // kh)
    return g, g + 1


def local_config(cfg, tp: int):
    """The config one rank computes with: its share of the query heads and
    of the FFN hidden axis, and the KV heads it reads
    (:func:`kv_head_range`).  ``head_dim`` is a stored field, so it is
    unchanged.  Raises ``ValueError`` for a layout the port does not
    serve."""
    check_family(cfg)
    reason = _layout_reason(cfg, tp)
    if reason is not None:
        raise ValueError(reason)
    for what, n in (("d_ff", cfg.d_ff), ("vocab_size", cfg.vocab_size)):
        if n % tp:
            raise ValueError(f"{what}={n} does not divide over {tp} ranks")
    lo, hi = kv_head_range(cfg, tp, 0)
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp,
                               n_kv_heads=hi - lo, d_ff=cfg.d_ff // tp)


def _split_axis(names: Tuple[str, ...], leaf: torch.Tensor) -> Optional[int]:
    """The axis of ``leaf`` split across ranks, or None (replicated)."""
    name = names[-1]
    if name not in _PARAM_RULES:
        raise KeyError(f"no partition rule for param path {names}")
    ndim, tail = _PARAM_RULES[name]
    if "model" not in tail:
        return None
    return leaf.ndim - ndim + tail.index("model")


def shard_params(params: Dict[str, Any], cfg, mesh) -> List[Dict[str, Any]]:
    """The port's parameter tree (from ``init_params`` or the bridge, on
    any device) -> one tree per rank of the ``("model",)`` mesh, on that
    rank's device.  A split leaf becomes ``tp`` contiguous equal pieces;
    a replicated leaf is copied to each rank's device (ranks on one device
    share it).  Raises ``KeyError`` for a leaf with no rule."""
    ranks = tp_ranks(mesh)
    tp = len(ranks)
    local_config(cfg, tp)  # family and divisibility checks

    def split(tree, names):
        if isinstance(tree, dict):
            per = {k: split(v, names + (k,)) for k, v in tree.items()}
            return [{k: per[k][r] for k in tree} for r in range(tp)]
        axis = _split_axis(names, tree)
        if axis is None:
            return [tree.to(d) for d in ranks]
        n = tree.shape[axis] // tp
        spans = [(r * n, n) for r in range(tp)]
        if names[-1] in _KV_LEAVES:
            hd = tree.shape[axis] // cfg.n_kv_heads
            spans = [(lo * hd, (hi - lo) * hd) for lo, hi in
                     (kv_head_range(cfg, tp, r) for r in range(tp))]
        return [tree.narrow(axis, start, size).contiguous().to(d)
                for (start, size), d in zip(spans, ranks)]

    return split(params, ())


def kernel_decode_support(cfg, mesh) -> Optional[str]:
    """Why the sharded decode kernel (``ops.flash_decode_sharded``) can NOT
    serve (cfg, mesh), or ``None`` when it can — the port of
    ``pallas_decode_support``, with its reasons and their category
    prefixes:

    * ``mesh:`` — not a single ``("model",)`` axis;
    * ``family:`` — the SSM decode is a recurrent step with no attention
      read, or the config has no KV heads;
    * ``layout:`` — neither head count divides the other's share of the
      "model" axis (:func:`local_config` refuses the layout).

    It differs from the reference in one case: where the rank count is a
    multiple of ``n_kv_heads`` (qwen2-1.5b at TP=4), each rank holds the
    one KV head its query heads read and the kernel serves it, where the
    reference replicates KV and falls back to XLA.
    """
    axes = tuple(mesh.axis_names)
    if axes != ("model",):
        return (f"mesh: axes {axes} — the sharded decode wrapper supports "
                "single-axis ('model',) TP meshes only")
    tp = int(np.shape(mesh.devices)[0])
    if cfg.family == "ssm":
        return ("family: ssm decode is a recurrent step with no attention "
                "read — there is no decode kernel to shard")
    if cfg.n_kv_heads <= 0:
        return "family: config has no KV attention heads"
    return _layout_reason(cfg, tp)
