"""Tensor-parallel partition rules — the port of ``repro.launch.partition``
for every family the port serves.

The reference hands partition specs to GSPMD, which splits the arrays and
inserts the collectives.  The port splits the parameter tree itself into
one tree per rank (:func:`shard_params`), and the model sums the
row-parallel partials itself (:mod:`repro_torch.models.transformer`).
The rules are the reference's: vocab, heads and the FFN hidden axis on
"model", norms replicated.  Shards are contiguous ranges of whole heads,
so each rank's K/V slice is a contiguous tensor that the decode kernel
takes as it is.

The MoE family follows the reference's baseline "tensor" scheme
(``_MOE_RULES``, which its ``engine_shardings`` uses): each routed
expert's hidden axis is on "model", and the router, the shared path's
sigmoid gate and the experts' own axis are replicated; the shared path's
MLP takes the dense rules.  The reference's other scheme,
``moe_scheme="expert"`` (experts on "model"), is an experiment its engine
never selects, so it is not ported.

The SSM family (and the hybrid's Mamba2 layers) split by SSM head.  The
reference's GSPMD layout is contiguous and its program global: GSPMD
reshards as it needs.  The port splits by hand, so each rank gets a
layout it computes with alone (:func:`ssm_widths`):

* ``in_proj`` packs ``[z | x | B | C | dt]`` into one column block; rank
  ``r``'s piece is ``[z_r | x_r | B | C | dt_r]``, where ``z_r``, ``x_r``
  and ``dt_r`` are the columns of its heads (a contiguous range of whole
  heads), and ``B`` / ``C`` are replicated with one group (both served
  archs) or the rank's own groups when the groups divide over the ranks;
* ``conv_w`` / ``conv_b`` cover the conv channels ``[x | B | C]``, so rank
  ``r`` takes ``[x_r | B | C]`` by the same rule;
* ``A_log``, ``dt_bias``, ``D``, the gated norm's ``norm`` and
  ``out_proj`` (row-parallel) split by head.  The layer's pre-norm
  (``scale``) is replicated.

The gated norm spans the whole inner width, so the model sums the ranks'
sums of squares before it normalises (:mod:`repro_torch.models.ssm`).
The hybrid's shared attention block takes the dense rules.

The vlm family is the dense stack; its stub patch embeddings and 3-D
M-RoPE positions are inputs, replicated on every rank as the reference's
``batch_pspecs`` replicates them.  The audio family's encoder layers take
the dense rules, and its learned positions (``pos_embed``, ``enc_pos``)
and LayerNorm biases (``bias``) are replicated.  Its cross-attention
(under ``cross``) projects d_model onto all H query heads for Q, K and V
alike, so ``wq``, ``wk`` and ``wv`` there split by query head (a rank's
cross K/V are its own query heads'), and ``wo`` by rows; the KV-head
split of the self-attention's ``wk`` / ``wv`` would be wrong there
wherever KH != H, with shapes that still fit.

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
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

#: leaf name -> (logical ndim, spec tail); leading stacked (layer) axes are
#: replicated.  "model" marks the axis split across ranks.
_PARAM_RULES: Dict[str, Tuple[int, Tuple]] = {
    "embed": (2, ("model", None)),        # (vocab, d)
    "lm_head": (2, (None, "model")),      # (d, vocab)
    "pos_embed": (2, (None, None)),       # learned decoder positions
    "enc_pos": (2, (None, None)),         # learned encoder positions
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
    "router": (2, (None, None)),          # MoE router (d, experts)
    "gate": (2, (None, None)),            # shared-expert sigmoid gate (d, 1)
    "scale": (1, (None,)),
    "bias": (1, (None,)),                 # LayerNorm bias
    "A_log": (1, ("model",)),
    "dt_bias": (1, ("model",)),
    "D": (1, ("model",)),
    "norm": (1, ("model",)),              # ssm gated-norm weight (d_inner,)
    "out_proj": (2, ("model", None)),
}
#: the SSM leaves whose "model" axis packs several column blocks: name ->
#: that axis, counted from the end; each rank takes :func:`ssm_columns`
_PACKED_RULES: Dict[str, int] = {"in_proj": -1, "conv_w": -2, "conv_b": -1}
#: the routed experts' leaves (a leading expert axis, replicated): under
#: "moe" and outside "shared" these rules take the place of
#: :data:`_PARAM_RULES`
_MOE_RULES: Dict[str, Tuple[int, Tuple]] = {
    "w_gate": (3, (None, None, "model")),
    "w_up": (3, (None, None, "model")),
    "w_down": (3, (None, "model", None)),
}
#: leaves split by KV head: each rank takes its kv_head_range (outside
#: ``cross``, whose K/V projections are over the query heads)
_KV_LEAVES = ("wk", "wv", "bk", "bv")

#: families the tensor-parallel path serves
TP_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def tp_ranks(mesh) -> List[torch.device]:
    """The ranks of a single-axis ``("model",)`` mesh (one TP pod), in
    order; raises ``ValueError`` for any other mesh."""
    if tuple(mesh.axis_names) != ("model",):
        raise ValueError(f"a TP pod needs the single mesh axis ('model',), "
                         f"got {tuple(mesh.axis_names)} — split the mesh "
                         "into pods with launch.mesh.pod_meshes")
    return mesh.ranks


def check_family(cfg) -> None:
    """Raise ``NotImplementedError`` for a family with no TP design."""
    if cfg.family not in TP_FAMILIES:
        raise NotImplementedError(
            f"tensor parallelism of family {cfg.family!r}: no TP design "
            f"(the port's TP families: {TP_FAMILIES})")


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


class SSMWidths(NamedTuple):
    """What one rank of a ``tp``-way pod computes of a Mamba2 block."""

    #: its SSM heads, a contiguous range of whole heads
    n_heads: int
    #: ``n_heads * head_dim``: its columns of z, x and y
    d_inner: int
    #: its B/C groups: all of them when replicated (one group)
    n_groups: int


def ssm_widths(cfg, tp: int = 1) -> SSMWidths:
    """The SSM widths one of ``tp`` ranks computes with (``tp=1``: the whole
    block).  ``ssm_d_inner`` and ``ssm_n_heads`` are properties of
    ``d_model``, which stays whole on every rank, so a rank's config keeps
    the full ones, and every SSM function takes the rank's from here.
    Raises ``ValueError`` naming the layout when the heads do not divide
    over the ranks, or there are several groups that do not."""
    nh, g = cfg.ssm_n_heads, cfg.ssm.n_groups
    if nh % tp:
        raise ValueError(f"layout: {nh} SSM heads do not divide over the "
                         f"'model' axis (size {tp})")
    if g > 1 and g % tp:
        raise ValueError(
            f"layout: {g} SSM groups over the 'model' axis (size {tp}) — B "
            "and C are replicated only with one group and split only when "
            "the groups divide over the ranks; the port serves no other "
            "layout")
    h = nh // tp
    return SSMWidths(h, h * cfg.ssm.head_dim, 1 if g == 1 else g // tp)


def ssm_columns(cfg, tp: int, rank: int, conv: bool = False) -> torch.Tensor:
    """The columns of the packed ``in_proj`` (``[z | x | B | C | dt]``), or
    with ``conv`` of the conv channels (``[x | B | C]``), that rank
    ``rank`` of ``tp`` holds, in the order of its piece: its heads' z, x
    and dt columns, and B and C whole (one group) or its own groups."""
    w = ssm_widths(cfg, tp)
    di, n = cfg.ssm_d_inner, cfg.ssm.d_state
    gn, gw = cfg.ssm.n_groups * n, w.n_groups * n
    g0 = 0 if cfg.ssm.n_groups == 1 else rank * gw
    heads = (rank * w.d_inner, w.d_inner)
    # each block's width, and the (start, size) of the rank's piece of it
    blocks = [(di, heads), (gn, (g0, gw)), (gn, (g0, gw))]  # x, B, C
    if not conv:
        blocks = ([(di, heads)] + blocks
                  + [(cfg.ssm_n_heads, (rank * w.n_heads, w.n_heads))])
    cols, off = [], 0
    for width, (start, size) in blocks:
        cols.append(torch.arange(off + start, off + start + size))
        off += width
    return torch.cat(cols)


def local_config(cfg, tp: int):
    """The config one rank computes with: its share of the query heads, of
    the FFN hidden axis and of the MoE experts' and shared path's hidden
    axes, and the KV heads it reads (:func:`kv_head_range`).
    ``head_dim`` is a stored field, so it is unchanged; so are the SSM
    widths, which :func:`ssm_widths` gives per rank (checked here).
    Raises ``ValueError`` for a layout the port does not serve, or a width
    that does not divide over ``tp`` ranks."""
    check_family(cfg)
    # the SSM family has no attention heads to lay out
    reason = None if cfg.attn_free else _layout_reason(cfg, tp)
    if reason is not None:
        raise ValueError(reason)
    if cfg.ssm.enabled:
        ssm_widths(cfg, tp)
    m = cfg.moe  # widths 0 outside the MoE family
    for what, n in (("d_ff", cfg.d_ff), ("vocab_size", cfg.vocab_size),
                    ("moe.expert_d_ff", m.expert_d_ff),
                    ("moe.shared_d_ff", m.shared_d_ff)):
        if n % tp:
            raise ValueError(
                f"{what}={n} does not divide over {tp} ranks"
                + (" (ROADMAP.md, queue 1, item 8.4: the reference "
                   "replicates such a leaf)" if what == "vocab_size" else ""))
    lo, hi = kv_head_range(cfg, tp, 0)
    moe = dataclasses.replace(m, expert_d_ff=m.expert_d_ff // tp,
                              shared_d_ff=m.shared_d_ff // tp)
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp,
                               n_kv_heads=hi - lo, d_ff=cfg.d_ff // tp,
                               moe=moe)


def _split_axis(names: Tuple[str, ...], leaf: torch.Tensor) -> Optional[int]:
    """The axis of ``leaf`` split across ranks, or None (replicated).  The
    table is chosen from the whole path, as the reference's
    ``param_pspecs`` chooses it: a routed expert's ``w_gate`` is 3-D and
    split on its last axis, the shared path's 2-D one by the dense
    rule."""
    name = names[-1]
    in_moe = "moe" in names and "shared" not in names
    table = _MOE_RULES if in_moe and name in _MOE_RULES else _PARAM_RULES
    if name not in table:
        raise KeyError(f"no partition rule for param path {names}")
    ndim, tail = table[name]
    if "model" not in tail:
        return None
    return leaf.ndim - ndim + tail.index("model")


def shard_params(params: Dict[str, Any], cfg, mesh) -> List[Dict[str, Any]]:
    """The port's parameter tree (from ``init_params`` or the bridge, on
    any device) -> one tree per rank of the ``("model",)`` mesh, on that
    rank's device.  A split leaf becomes ``tp`` contiguous equal pieces
    (a packed SSM leaf the columns of :func:`ssm_columns`, in the JAX
    layout still); a replicated leaf is copied to each rank's device
    (ranks on one device share it).  Raises ``KeyError`` for a leaf with
    no rule."""
    ranks = tp_ranks(mesh)
    tp = len(ranks)
    local_config(cfg, tp)  # family and divisibility checks

    def split(tree, names):
        if isinstance(tree, dict):
            per = {k: split(v, names + (k,)) for k, v in tree.items()}
            return [{k: per[k][r] for k in tree} for r in range(tp)]
        if names[-1] in _PACKED_RULES:
            axis = tree.ndim + _PACKED_RULES[names[-1]]
            conv = names[-1] != "in_proj"
            return [tree.index_select(axis, ssm_columns(cfg, tp, r, conv)
                                      .to(tree.device)).to(d)
                    for r, d in enumerate(ranks)]
        axis = _split_axis(names, tree)
        if axis is None:
            return [tree.to(d) for d in ranks]
        n = tree.shape[axis] // tp
        spans = [(r * n, n) for r in range(tp)]
        if names[-1] in _KV_LEAVES and "cross" not in names:
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
