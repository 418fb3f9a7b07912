"""Tensor-parallel partition rules — the port of ``repro.launch.partition``
for every family the port serves.

The reference hands partition specs to GSPMD, which splits the arrays and
inserts the collectives.  The port splits the parameter tree itself into
one tree per rank (:func:`shard_params`), and the model sums the
row-parallel partials itself (:mod:`repro_torch.models.transformer`).
The rules are the reference's: vocab, heads and the FFN hidden axis on
"model", norms replicated.  Every split axis is cut the same way, for any
rank count (:func:`split_range`): rank ``r`` holds a contiguous range of
whole units (query heads, SSM heads, FFN or expert columns, vocab rows),
the first ``n % tp`` ranks one unit more than the others, so where the
ranks divide the axis every rank holds ``n / tp`` and where they do not
the pieces differ by one unit, or a rank holds none (qwen2-1.5b's 12
heads over 16 ranks).  GSPMD instead replicates a leaf whose width the
axis does not divide (``sanitize_specs``), or splits its columns
mid-head; the port keeps whole heads, so each rank's K/V slice is a
contiguous tensor that the decode kernel takes as it is.

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

Each rank holds the KV heads its own query heads read, a contiguous range
(:func:`kv_head_range`): its query heads ``[q0, q1)`` read KV heads
``[q0 // G, (q1 - 1) // G + 1)``, ``G = H / KH``.  Ranks share a KV head
where a GQA group crosses their boundary (qwen2-1.5b's 2 KV heads over 4
ranks; llama3.2-3b's 24 / 8 heads over 3 ranks: KV ``[0, 3)``, ``[2, 6)``,
``[5, 8)``).  A rank whose query heads cut a group reads its KV heads at
two or three ratios, so the attention kernels launch it as uniform
segments (``kernels.ops.head_segments``, each rank's first head and ``G``
from :func:`rank_heads`).  The reference replicates KV where the heads do
not divide (``sanitize_specs``) and falls back to XLA; the port serves
every such layout through the kernels.  The one layout refused is several
SSM groups that do not divide over the ranks (no arch has it).

The reference's spec functions are here too (:class:`P`,
:func:`param_pspecs`, :func:`cache_pspecs`, :func:`batch_pspecs`,
:func:`opt_pspecs`, :func:`sanitize_specs`, :func:`local_shape`).  They
describe layouts and place nothing: the dry run reads them for the
batch rows a data index holds and for the ZeRO-1 slices of the AdamW
moments.  Where the port has its own per-rank layout (the functions
above), that layout is what runs, and the dry run's record says so.  The
reference's ``shardings`` and ``engine_shardings`` have no counterpart: a
JAX ``NamedSharding`` places arrays, which :func:`shard_params` and
``transformer.init_cache(mesh=)`` do here.
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


class P(tuple):
    """A partition spec: per dimension an axis name, a tuple of axis
    names, or None (replicated) — the reference's ``PartitionSpec`` read
    as a tuple."""

    def __new__(cls, *entries):
        # a one-name tuple is that name, as JAX normalises it
        return super().__new__(cls, (e[0] if isinstance(e, tuple)
                                     and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


#: the reference's rules for the leaves :data:`_PACKED_RULES` splits by
#: columns
_SPEC_RULES = {**_PARAM_RULES, "in_proj": (2, (None, "model")),
               "conv_w": (2, ("model", None)), "conv_b": (1, ("model",))}


def _map_specs(fn, tree, names=()):
    """``fn(names, leaf)`` over a parameter or cache tree: dicts by key,
    a ``KVCache`` by its buffers (``k``, ``v``, ``k_scale``, ``v_scale``;
    absent scales stay None)."""
    from repro_torch.models.layers import KVCache
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v, names + (k,)) for k, v in tree.items()}
    if isinstance(tree, KVCache):
        return KVCache(*(None if t is None else fn(names + (f,), t)
                         for f, t in (("k", tree.k), ("v", tree.v))),
                       tree.ring,
                       *(None if t is None else fn(names + (f,), t)
                         for f, t in (("k_scale", tree.k_scale),
                                      ("v_scale", tree.v_scale))))
    return fn(names, tree)


def _zip_specs(fn, specs, tree):
    """``fn(spec, leaf)`` over a spec tree and the tree it describes."""
    from repro_torch.models.layers import KVCache
    if isinstance(specs, P):
        return fn(specs, tree)
    if isinstance(specs, dict):
        return {k: _zip_specs(fn, v, tree[k]) for k, v in specs.items()}
    if isinstance(specs, KVCache):
        return KVCache(*(None if s is None else _zip_specs(fn, s, t)
                         for s, t in ((specs.k, tree.k), (specs.v, tree.v))),
                       specs.ring,
                       *(None if s is None else _zip_specs(fn, s, t)
                         for s, t in ((specs.k_scale, tree.k_scale),
                                      (specs.v_scale, tree.v_scale))))
    raise TypeError(f"not a spec tree: {type(specs)}")


def param_pspecs(cfg, abstract_params=None) -> Any:
    """The reference's spec tree of ``init_params(cfg)`` (its baseline
    ``moe_scheme="tensor"``); ``abstract_params`` defaults to
    ``transformer.abstract_params(cfg)``."""
    if abstract_params is None:
        from repro_torch.models.transformer import abstract_params as ap
        abstract_params = ap(cfg)

    def spec_for(names, leaf):
        name = names[-1]
        in_moe = "moe" in names and "shared" not in names
        table = _MOE_RULES if in_moe and name in _MOE_RULES else _SPEC_RULES
        if name not in table:
            raise KeyError(f"no partition rule for param path {names}")
        ndim, tail = table[name]
        pad = leaf.ndim - ndim
        assert pad >= 0, (names, leaf.ndim, ndim)
        return P(*((None,) * pad + tuple(tail)))

    return _map_specs(spec_for, abstract_params)


#: the ``kv_shard`` choices of :func:`cache_pspecs`
KV_SHARDS = ("auto", "seq", "head_dim", "heads")


def cache_pspecs(cfg, abstract_cache, batch_ax, *,
                 context_parallel: bool = False, model_size: int = 16,
                 kv_shard: str = "auto") -> Any:
    """The reference's spec tree of a decode cache: the batch on
    ``batch_ax``, KV heads on "model" (``kv_shard="heads"``, or "auto"
    when ``n_kv_heads`` divides ``model_size``), else the sequence axis
    ("seq", or "auto" otherwise) or the head dim ("head_dim");
    ``context_parallel`` puts the sequence axis on "data" and replicates
    the batch.  The int8 scales (sites, B, L) are replicated across
    "model" unless the sequence axis is sharded."""
    if kv_shard not in KV_SHARDS:
        raise ValueError(f"kv_shard must be one of {KV_SHARDS}")
    heads_fit = cfg.n_kv_heads > 0 and cfg.n_kv_heads % model_size == 0
    seq = kv_shard == "seq" or (kv_shard == "auto" and not heads_fit)

    def spec_for(names, leaf):
        name = names[-1]
        if name == "len":
            return P() if context_parallel else P(batch_ax)
        if len(names) >= 2 and names[-2] in ("kv", "cross_kv"):
            if leaf.ndim == 3:  # int8 scales (sites, B, L)
                if context_parallel:
                    return P(None, None, "data")
                return P(None, batch_ax, "model" if seq else None)
            if context_parallel:
                return P(None, None, "data", "model", None)
            if kv_shard == "head_dim":
                return P(None, batch_ax, None, None, "model")
            if seq:
                return P(None, batch_ax, "model", None, None)
            return P(None, batch_ax, None, "model", None)
        bax = None if context_parallel else batch_ax
        if name == "conv":  # (..., B, CH, k)
            return P(*((None,) * (leaf.ndim - 3)), bax, "model", None)
        if name == "ssm":  # (..., B, H, P, N)
            return P(*((None,) * (leaf.ndim - 4)), bax, "model", None, None)
        raise KeyError(f"no partition rule for cache path {names}")

    return _map_specs(spec_for, abstract_cache)


def kv_layout(cfg, model_size: int, kv_shard: str = "auto") -> str:
    """The cache layout the port lays out for ``kv_shard`` over
    ``model_size`` ranks, as :func:`cache_pspecs` picks it: "heads" (each
    rank its query heads' KV heads, :func:`kv_head_range`), "seq" (every
    KV head over a range of the buffer's rows, :func:`split_range`) or
    "head_dim" (a range of every head's dims).  "auto" is "heads" where
    the ranks divide ``n_kv_heads``, else "seq"; one rank, and a config
    with no KV heads, are "heads".  A rank's range of rows or dims is a
    :func:`split_range`: each rank's decode cuts its own rows into key
    splits (``kernels.ops.partial_splits``), so a range need not be a
    whole number of the kernel's 32-row tiles."""
    if kv_shard not in KV_SHARDS:
        raise ValueError(f"kv_shard must be one of {KV_SHARDS}")
    if model_size == 1 or cfg.n_kv_heads <= 0:
        return "heads"
    if kv_shard == "auto":
        return "heads" if cfg.n_kv_heads % model_size == 0 else "seq"
    return kv_shard


def batch_pspecs(batch_abstract, batch_ax) -> Any:
    """Specs of the token, label, ``embeds``, ``frames`` and
    ``positions`` inputs: the batch axis on ``batch_ax``."""
    def spec_for(names, leaf):
        name = names[-1]
        if name == "positions":  # (3, B, S)
            return P(None, batch_ax, None)
        if name in ("embeds", "frames"):  # (B, S, d)
            return P(batch_ax, None, None)
        return P(batch_ax, None)  # tokens / labels (B, S)

    return _map_specs(spec_for, batch_abstract)


def _axis_product(sizes, ax) -> int:
    n = 1
    for a in (ax if isinstance(ax, tuple) else (ax,)):
        n *= sizes[a]
    return n


def opt_pspecs(mesh, param_spec_tree, abstract_params):
    """ZeRO-1: each moment's spec with the ("pod", "data") axes on the
    first dimension its param spec leaves unsharded and the data degree
    divides.  The parameters stay TP-only."""
    sizes = dict(zip(mesh.axis_names, np.shape(mesh.devices)))
    dax = tuple(a for a in ("pod", "data") if a in sizes)
    ddeg = _axis_product(sizes, dax) if dax else 1

    def fix(spec, leaf):
        entries = list(spec) + [None] * (leaf.ndim - len(spec))
        for dim, ax in enumerate(entries if dax else ()):
            if ax is None and leaf.shape[dim] % ddeg == 0 and leaf.shape[dim] > 0:
                entries[dim] = dax if len(dax) > 1 else dax[0]
                break
        return P(*entries)

    return _zip_specs(fix, param_spec_tree, abstract_params)


def sanitize_specs(mesh, spec_tree, abstract_tree):
    """Replicate every spec entry whose dimension the mesh axes' size does
    not divide (e.g. 2 KV heads over a 16-way "model" axis)."""
    sizes = dict(zip(mesh.axis_names, np.shape(mesh.devices)))

    def fix(spec, leaf):
        return P(*(None if ax is None
                   or leaf.shape[dim] % _axis_product(sizes, ax) else ax
                   for dim, ax in enumerate(spec)))

    return _zip_specs(fix, spec_tree, abstract_tree)


def local_shape(mesh, spec, leaf) -> Tuple[int, ...]:
    """The shape of one device's shard of ``leaf`` under ``spec``."""
    sizes = dict(zip(mesh.axis_names, np.shape(mesh.devices)))
    shape = list(leaf.shape)
    for dim, ax in enumerate(spec):
        if ax is not None:
            shape[dim] //= _axis_product(sizes, ax)
    return tuple(shape)


def data_dim(spec) -> Optional[int]:
    """The dimension a ZeRO-1 spec (:func:`opt_pspecs`) puts the data
    axes on, or None."""
    for dim, ax in enumerate(spec):
        axes = ax if isinstance(ax, tuple) else (ax,)
        if ax is not None and ("data" in axes or "pod" in axes):
            return dim
    return None


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


def layout_reason(cfg, tp: int) -> Optional[str]:
    """Why the port has no per-rank layout of ``cfg`` over ``tp`` ranks,
    or None.  Every head count and width now splits over any rank count
    (:func:`split_range`); what is left is several SSM groups that do not
    divide over the ranks, which no served arch has."""
    try:
        for rank in range(tp):
            local_config(cfg, tp, rank)
    except (ValueError, NotImplementedError) as e:
        return str(e)
    return None


def split_range(n: int, tp: int, rank: int) -> Tuple[int, int]:
    """The units ``[lo, hi)`` rank ``rank`` of ``tp`` holds of an axis of
    ``n`` whole units (heads, FFN columns, vocab rows): a contiguous range,
    the first ``n % tp`` ranks one unit more than the others.  Where ``tp``
    divides ``n`` every rank holds ``n / tp``; a rank may hold none."""
    base, extra = divmod(n, tp)
    lo = rank * base + min(rank, extra)
    return lo, lo + base + (rank < extra)


def head_range(cfg, tp: int, rank: int) -> Tuple[int, int]:
    """The query heads ``[q0, q1)`` of rank ``rank`` (:func:`split_range`)."""
    return split_range(cfg.n_heads, tp, rank)


def kv_head_range(cfg, tp: int, rank: int) -> Tuple[int, int]:
    """The KV heads ``[lo, hi)`` that rank ``rank``'s query heads read: on
    one device query head ``j`` reads KV head ``j // G``, ``G = H / KH``,
    so ranks ``[q0, q1)`` read ``[q0 // G, (q1 - 1) // G + 1)``.  Two ranks
    share a KV head where a group crosses their boundary; a rank with no
    query heads reads none (an empty range)."""
    q0, q1 = head_range(cfg, tp, rank)
    g = cfg.n_heads // cfg.n_kv_heads
    if q0 == q1:
        lo = min(q0 // g, cfg.n_kv_heads)
        return lo, lo
    return q0 // g, (q1 - 1) // g + 1


def rank_heads(cfg, tp: int) -> List[Tuple[int, int]]:
    """Each rank's (first query head, group size ``G``): what the attention
    kernels take to launch a rank whose heads cut a GQA group as uniform
    segments (``kernels.ops.head_segments``)."""
    g = cfg.n_heads // cfg.n_kv_heads if cfg.n_kv_heads else 1
    return [(head_range(cfg, tp, r)[0], g) for r in range(tp)]


class SSMWidths(NamedTuple):
    """What one rank of a ``tp``-way pod computes of a Mamba2 block."""

    #: its SSM heads, a contiguous range of whole heads
    n_heads: int
    #: ``n_heads * head_dim``: its columns of z, x and y
    d_inner: int
    #: its B/C groups: all of them when replicated (one group)
    n_groups: int


def ssm_head_range(cfg, tp: int, rank: int) -> Tuple[int, int]:
    """The SSM heads ``[h0, h1)`` of rank ``rank`` (:func:`split_range`);
    raises ``ValueError`` naming the layout where there are several B/C
    groups that do not divide over the ranks."""
    g = cfg.ssm.n_groups
    if g > 1 and g % tp:
        raise ValueError(
            f"layout: {g} SSM groups over the 'model' axis (size {tp}) — B "
            "and C are replicated only with one group and split only when "
            "the groups divide over the ranks; the port serves no other "
            "layout")
    return split_range(cfg.ssm_n_heads, tp, rank)


def ssm_widths(cfg, tp: int = 1, rank: int = 0) -> SSMWidths:
    """The SSM widths rank ``rank`` of ``tp`` computes with (``tp=1``: the
    whole block).  ``ssm_d_inner`` and ``ssm_n_heads`` are properties of
    ``d_model``, which stays whole on every rank, so a rank's config keeps
    the full ones, and every SSM function takes the rank's from here.
    Raises ``ValueError`` naming the layout where there are several
    groups that do not divide over the ranks."""
    h0, h1 = ssm_head_range(cfg, tp, rank)
    g = cfg.ssm.n_groups
    h = h1 - h0
    return SSMWidths(h, h * cfg.ssm.head_dim, 1 if g == 1 else g // tp)


def ssm_columns(cfg, tp: int, rank: int, conv: bool = False) -> torch.Tensor:
    """The columns of the packed ``in_proj`` (``[z | x | B | C | dt]``), or
    with ``conv`` of the conv channels (``[x | B | C]``), that rank
    ``rank`` of ``tp`` holds, in the order of its piece: its heads' z, x
    and dt columns, and B and C whole (one group) or its own groups."""
    w = ssm_widths(cfg, tp, rank)
    h0, _ = ssm_head_range(cfg, tp, rank)
    di, n = cfg.ssm_d_inner, cfg.ssm.d_state
    gn, gw = cfg.ssm.n_groups * n, w.n_groups * n
    g0 = 0 if cfg.ssm.n_groups == 1 else rank * gw
    heads = (h0 * cfg.ssm.head_dim, w.d_inner)
    # each block's width, and the (start, size) of the rank's piece of it
    blocks = [(di, heads), (gn, (g0, gw)), (gn, (g0, gw))]  # x, B, C
    if not conv:
        blocks = ([(di, heads)] + blocks
                  + [(cfg.ssm_n_heads, (h0, w.n_heads))])
    cols, off = [], 0
    for width, (start, size) in blocks:
        cols.append(torch.arange(off + start, off + start + size))
        off += width
    return torch.cat(cols)


def local_config(cfg, tp: int, rank: int = 0):
    """The config rank ``rank`` of ``tp`` computes with: its query heads,
    the KV heads they read (:func:`kv_head_range`), and its columns of the
    FFN hidden axis and of the MoE experts' and shared path's hidden axes,
    each a :func:`split_range` (equal shares where ``tp`` divides, else the
    first ranks one more).  ``head_dim`` is a stored field, so it is
    unchanged; so are ``vocab_size`` (the ids a rank clamps; its rows are
    :func:`vocab_range`) and the SSM widths, which :func:`ssm_widths` gives
    per rank (checked here).  Raises ``ValueError`` for a layout the port
    does not serve (several SSM groups that do not divide)."""
    check_family(cfg)
    if cfg.ssm.enabled:
        ssm_widths(cfg, tp, rank)

    def share(n):
        lo, hi = split_range(n, tp, rank)
        return hi - lo

    m = cfg.moe  # widths 0 outside the MoE family
    moe = dataclasses.replace(m, expert_d_ff=share(m.expert_d_ff),
                              shared_d_ff=share(m.shared_d_ff))
    heads = {}
    if not cfg.attn_free:  # the SSM family has no attention heads
        q0, q1 = head_range(cfg, tp, rank)
        k0, k1 = kv_head_range(cfg, tp, rank)
        heads = dict(n_heads=q1 - q0, n_kv_heads=k1 - k0)
    return dataclasses.replace(cfg, d_ff=share(cfg.d_ff), moe=moe, **heads)


def local_configs(cfg, tp: int) -> List[Any]:
    """Every rank's :func:`local_config`, in rank order."""
    return [local_config(cfg, tp, r) for r in range(tp)]


def vocab_range(cfg, tp: int, rank: int) -> Tuple[int, int]:
    """The vocab rows ``[lo, hi)`` of the embedding (and columns of
    ``lm_head``) that rank ``rank`` holds (:func:`split_range`)."""
    return split_range(cfg.vocab_size, tp, rank)


def split_axis(names: Tuple[str, ...], leaf: torch.Tensor) -> Optional[int]:
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


def _axis_ranges(names: Tuple[str, ...], cfg, tp: int):
    """(the unsplit width of a split leaf's axis, each rank's ``[lo, hi)``
    of it): its units' :func:`split_range` (query heads, KV heads by
    :func:`kv_head_range`, FFN or expert columns, vocab rows, SSM heads)
    times the width of a unit (``head_dim`` for attention heads, the SSM
    ``head_dim`` for ``norm`` and ``out_proj``, else 1)."""
    name = names[-1]
    if name in _KV_LEAVES and "cross" not in names:
        n, unit = cfg.n_kv_heads, cfg.head_dim
        ranges = [kv_head_range(cfg, tp, r) for r in range(tp)]
        return n * unit, [(lo * unit, hi * unit) for lo, hi in ranges]
    if name in ("wq", "wk", "wv", "wo", "bq"):
        n, unit = cfg.n_heads, cfg.head_dim
    elif name in ("w_gate", "w_up", "w_down"):
        m = cfg.moe
        n = (m.shared_d_ff if "shared" in names else m.expert_d_ff
             if "moe" in names else cfg.d_ff)
        unit = 1
    elif name in ("embed", "lm_head"):
        n, unit = cfg.vocab_size, 1
    elif name in ("A_log", "dt_bias", "D", "norm", "out_proj"):
        n = cfg.ssm_n_heads
        unit = 1 if name in ("A_log", "dt_bias", "D") else cfg.ssm.head_dim
        ranges = [ssm_head_range(cfg, tp, r) for r in range(tp)]
        return n * unit, [(lo * unit, hi * unit) for lo, hi in ranges]
    else:
        raise KeyError(f"no split rule for param path {names}")
    return n * unit, [tuple(x * unit for x in split_range(n, tp, r))
                      for r in range(tp)]


def _pieces(names: Tuple[str, ...], leaf: torch.Tensor, cfg,
            tp: int) -> Optional[Tuple[int, List[torch.Tensor]]]:
    """(axis, each rank's indices along it) of a split leaf, or None for
    a replicated one: each rank's contiguous range of whole units
    (:func:`_axis_ranges`; ranks may hold unequal pieces, or none), a
    packed SSM leaf's :func:`ssm_columns`, a KV leaf's
    :func:`kv_head_range` columns (two ranks may hold the same ones)."""
    if names[-1] in _PACKED_RULES:
        conv = names[-1] != "in_proj"
        return (leaf.ndim + _PACKED_RULES[names[-1]],
                [ssm_columns(cfg, tp, r, conv) for r in range(tp)])
    axis = split_axis(names, leaf)
    if axis is None:
        return None
    _, ranges = _axis_ranges(names, cfg, tp)
    return axis, [torch.arange(lo, hi) for lo, hi in ranges]


def replicated(names: Tuple[str, ...], leaf: torch.Tensor) -> bool:
    """Every rank holds the leaf at ``names`` whole."""
    return names[-1] not in _PACKED_RULES and split_axis(names, leaf) is None


def shard_params(params: Dict[str, Any], cfg, mesh) -> List[Dict[str, Any]]:
    """The port's parameter tree (from ``init_params`` or the bridge, on
    any device) -> one tree per rank of the ``("model",)`` mesh, on that
    rank's device.  A split leaf becomes each rank's contiguous range of
    whole units (:func:`_axis_ranges`: equal pieces where the ranks divide
    the axis; a packed SSM leaf the columns of :func:`ssm_columns`, in the
    JAX layout still); a replicated leaf is copied to each rank's device
    (ranks on one device share it).  Raises ``KeyError`` for a leaf with
    no rule."""
    ranks = tp_ranks(mesh)
    tp = len(ranks)
    reason = layout_reason(cfg, tp)  # family and layout checks
    if reason is not None:
        raise ValueError(reason)

    def split(tree, names):
        if isinstance(tree, dict):
            per = {k: split(v, names + (k,)) for k, v in tree.items()}
            return [{k: per[k][r] for k in tree} for r in range(tp)]
        pieces = _pieces(names, tree, cfg, tp)
        if pieces is None:
            return [tree.to(d) for d in ranks]
        axis, idx = pieces
        if names[-1] not in _PACKED_RULES:  # contiguous: narrow, no gather
            # an empty piece gets a storage of its own, so that it keeps
            # no view of the whole leaf alive
            return [tree.narrow(axis, int(i[0]), len(i)).contiguous().to(d)
                    if len(i) else tree.new_empty(
                        tree.shape[:axis] + (0,) + tree.shape[axis + 1:],
                        device=d)
                    for i, d in zip(idx, ranks)]
        return [tree.index_select(axis, i.to(tree.device)).to(d)
                for i, d in zip(idx, ranks)]

    return split(params, ())


def gather_shards(shards: List[Dict[str, Any]], cfg, mesh, *,
                  add: bool = False) -> Dict[str, Any]:
    """The inverse of :func:`shard_params`: the rank trees -> one tree on
    rank 0's device.  With ``add`` the pieces that ranks share are summed
    (the gradients of a pod: a replicated leaf's, and a KV head's that two
    ranks hold, are the sums of the ranks' partials); without it a shared
    piece is taken from the first rank that holds it."""
    ranks = tp_ranks(mesh)
    tp, dev = len(ranks), ranks[0]

    def join(trees, names):
        if isinstance(trees[0], dict):
            return {k: join([t[k] for t in trees], names + (k,))
                    for k in trees[0]}
        parts = [t.to(dev) for t in trees]
        shape = list(parts[0].shape)
        pieces = _pieces(names, parts[0], cfg, 1)  # the axis, if split
        if pieces is None:
            if not add:
                return parts[0]
            total = parts[0]
            for t in parts[1:]:
                total = total + t
            return total
        axis = pieces[0]
        shape[axis] = _global_width(names, parts[0], cfg, tp, axis)
        _, idx = _pieces(names, torch.empty(shape, device="meta"), cfg, tp)
        out = parts[0].new_zeros(shape)
        for i, t in zip(idx, parts):
            i = i.to(dev)
            if add:
                out.index_add_(axis, i, t)
            else:
                out.index_copy_(axis, i, t)
        return out

    return join(shards, ())


def _global_width(names, piece: torch.Tensor, cfg, tp: int, axis: int) -> int:
    """The unsplit width along ``axis`` of a leaf whose rank piece is
    ``piece``."""
    if names[-1] in _PACKED_RULES:
        conv = cfg.ssm_d_inner + 2 * cfg.ssm.n_groups * cfg.ssm.d_state
        return conv + (cfg.ssm_d_inner + cfg.ssm_n_heads
                       if names[-1] == "in_proj" else 0)
    return _axis_ranges(names, cfg, tp)[0]


def kernel_decode_support(cfg, mesh) -> Optional[str]:
    """Why the sharded decode kernel (``ops.flash_decode_sharded``) can NOT
    serve (cfg, mesh), or ``None`` when it can — the port of
    ``pallas_decode_support``, with its reasons and their category
    prefixes:

    * ``mesh:`` — not a single ``("model",)`` axis;
    * ``family:`` — the SSM decode is a recurrent step with no attention
      read, or the config has no KV heads.

    It has no ``layout:`` reason: every head layout splits into ranks of
    whole query heads, each holding the KV heads they read
    (:func:`kv_head_range`), and a rank whose heads cut a GQA group is
    launched as uniform segments (``kernels.ops.head_segments``).  Where
    the reference replicates KV or the heads do not divide, and falls back
    to XLA, the port serves the layout through the kernels.
    """
    axes = tuple(mesh.axis_names)
    if axes != ("model",):
        return (f"mesh: axes {axes} — the sharded decode wrapper supports "
                "single-axis ('model',) TP meshes only")
    if cfg.family == "ssm":
        return ("family: ssm decode is a recurrent step with no attention "
                "read — there is no decode kernel to shard")
    if cfg.n_kv_heads <= 0:
        return "family: config has no KV attention heads"
    return None
