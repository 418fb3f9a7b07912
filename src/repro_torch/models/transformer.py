"""Model assembly in PyTorch: every family of
``repro.models.transformer``.

    dense / vlm : [norm -> GQA attn -> norm -> gated MLP] x L
    moe         : [norm -> GQA attn -> norm -> MoE FFN] x L
    ssm         : [norm -> Mamba2] x L
    hybrid      : n_groups groups of (attn_every x [norm -> Mamba2]), each
                  followed by ONE weight-shared attention + MLP block, then
                  the tail Mamba2 layers (zamba2-7b: 13 groups of 6, 3 tail
                  layers)
    audio       : an encoder stack over stub frame embeddings, then a
                  decoder of [norm -> self attn -> norm -> cross attn ->
                  norm -> MLP] x L, learned positions, LayerNorm, GELU

The vlm family is the dense stack with M-RoPE; its prefill may prepend
stub patch embeddings (``batch["embeds"]``, (B, P, d_model)) to the token
embeddings and take (3, B, S) positions (``batch["positions"]``); without
them, and in every decode step, its (B, S) positions go on all three
M-RoPE axes, as in the reference.  The audio family's prefill runs the
encoder over ``batch["frames"]`` (B, n_frames, d_model) with plain
attention, as the reference does, writes each decoder layer's cross K/V
into the cache (``cross_kv``), and its decoder self-attention runs the
kernels; its self-attention cache holds at most ``max_position_embeddings``
(448) rows, and a decode step clamps its learned position there.

Parameters keep the reference's pytree layout (layers stacked on a leading
axis; the hybrid's ``groups`` on two, (n_groups, inner), with ``tail`` and
the unstacked ``shared_attn``), so a converted JAX tree
(:mod:`repro_torch.bridge`) and a tree from :func:`init_params` are
interchangeable.  The hybrid cache holds ``groups_ssm`` (states stacked
(n_groups, inner, B, ...)), ``tail_ssm`` (tail, B, ...) and one K/V site
per group (``kv``: (n_groups, B, buf, KH, D)), a ring once ``max_len``
exceeds ``swa_window``.

Public API:
  init_params(cfg, generator)                 -> params dict
  abstract_params(cfg)                        -> params on the meta device
  abstract_cache(cfg, batch, max_len)         -> a cache on the meta device
  embed_inputs(params, cfg, batch)            -> (hidden, positions)
  forward(params, cfg, batch, attn_impl=,
          moe_impl=, remat=, mesh=)           -> (logits, aux_loss)
  init_cache(cfg, batch, max_len, device)     -> cache dict (kv_dtype="int8",
                                                 sliding_window= for a ring)
  prefill(params, cfg, batch, cache)          -> (last_logits, cache)
  prefill_chunk(params, cfg, batch, cache,
                start=, valid_len=, mesh=)    -> (last_logits, cache)
  decode_step(params, cfg, tokens, cache)     -> (logits, cache)

The MoE family runs the MoE block (``models.moe.moe_partials``) where the
dense family runs its MLP, with the reference's ``moe_impl`` defaults:
``"dense"`` in ``forward``, ``prefill`` and ``prefill_chunk``,
``"grouped"`` in ``decode_step``.  ``forward`` returns the router's aux
loss summed over layers; ``prefill``, ``prefill_chunk`` and
``decode_step`` drop it, as the reference's do.

``prefill``, ``prefill_chunk`` and ``decode_step`` update the cache they are
given in place and return it (the reference returns a new pytree).

Tensor parallelism (``mesh=``, a ``("model",)`` mesh of
:mod:`repro_torch.launch.mesh`; every family):
``params`` is then the list of per-rank trees from
``launch.partition.shard_params`` and ``cache`` the list of per-rank
caches from ``init_cache(..., mesh=mesh)``.  The forward is one body
over a list of ranks, a single device being one rank.  One process
drives every rank, layer by layer, each rank with its share of the heads
and of the FFN or the experts' hidden axes
(``launch.partition.local_config``, one config a rank: the shares differ
by a unit where the ranks do not divide an axis, and a rank may hold no
heads), or of the SSM heads (``launch.partition.ssm_widths``); the
row-parallel partials (after
``wo``, after ``w_down``, the MoE block or the Mamba2 block's
``out_proj``, the audio family's cross-attention ``wo`` and its
encoder's ``wo`` and ``w_down``, the vocab-parallel embedding) are
summed in rank order on rank 0's device and copied back to every rank,
and the vocab-parallel logits are concatenated there, so two runs agree
bit for bit.  The
Mamba2 block's gated norm sums the ranks' sums of squares the same way
before any rank normalises (``models.ssm.gated_partials``).  The MoE
router runs once a layer, on rank 0, and every rank gets its routing;
where ``shard_params(..., moe_scheme="expert")`` gave each rank whole
experts, each rank computes the routed tokens of its own experts only
(``models.moe.moe_partials`` reads the scheme off the shards).
The decode read of all ranks is one ``ops.flash_decode_sharded`` call
(the hybrid's shared block included), given each rank's first query
head and the group size so that a rank whose heads cut a GQA group runs
as uniform segments (``launch.partition.rank_heads``); the SSM decode
step stays plain
on every rank.  Prefill launches ``flash_attention`` and ``ssd_scan`` on
each rank's local heads: the reference downgrades prefill under a mesh
to XLA only because its Pallas kernels have no ``shard_map`` wrapper,
and computes the same function either way.  ``prefill_chunk`` runs every
rank's heads over its own cache, with the same sums.  The vlm family's
patch embeddings and (3, B, S) positions are replicated, as the
reference's ``batch_pspecs`` replicates them: every rank prepends the
same patches and rotates its heads by the same M-RoPE angles.  The audio
family's encoder runs each rank's heads and FFN columns (plain, as on
one device), each rank adds its own replicated learned positions, writes
its query heads' cross K/V into its own ``cross_kv`` and reads them
there.  An int8 cache under a mesh holds each rank's KV heads' codes and
a copy of the per-token scales that is the same on every rank: each
write takes one cross-rank max of the ranks' amaxes
(``layers.quantize_kv_shared``), and the decode read is one
``ops.flash_decode_int8_sharded`` call a layer.  A cache the pod
splits other than by head (``init_cache(kv_shard="seq")``, every KV
head over a range of rows a rank; ``kv_shard="head_dim"``, a range of
every head's dims; ``context=``, the context-parallel cache's row ranges
a data index) keeps the projections' head layout and is written and
read by :mod:`repro_torch.models.kv_split`: split-KV across the ranks
(``ops.flash_decode_partials`` and ``ops.flash_decode_combine``) or the
head-dim scores summed before the softmax.  ``forward(mesh=)``
runs the same rank bodies over the full sequence with no cache, for
training: the sums above are tensor ops, so autograd runs through them.

Each place where the ranks exchange data records one collective with
:func:`repro_torch.launch.mesh.collective` (the dry run counts them): a
sum of partials an all-reduce (and, when its result is differentiated,
one more for the gradient the ranks' copies gather), the gated norm's
sum of squares and the int8 writes' max an all-reduce, the MoE routing
sent from rank 0 a collective-permute, and the vocab-parallel logits
gathered on rank 0 an all-gather.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional

import torch
import torch.utils.checkpoint

from repro_torch.launch import partition as P
from repro_torch.launch.mesh import collective
from repro_torch.models import kv_split
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.ranks import current_rank, on_rank, ranked

Params = Dict[str, Any]
Cache = Dict[str, Any]
KVCache = L.KVCache

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


#: families this port serves
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def hybrid_layout(cfg):
    """(n_groups, inner_per_group, n_tail) for the hybrid family."""
    every = cfg.hybrid.attn_every
    n_groups = cfg.n_layers // every
    return n_groups, every, cfg.n_layers - n_groups * every


def _check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ported: {FAMILIES})")


# =========================================================================== #
# Init
# =========================================================================== #


def init_params(cfg, generator: torch.Generator) -> Params:
    """Random parameters with the reference's distributions, drawn from
    ``generator`` on its device (uniform dense weights, N(0, 0.02)
    embeddings, unit norm scales, zero biases)."""
    _check_family(cfg)
    dtype, dev, n = _dtype(cfg), generator.device, cfg.n_layers

    def norm(lead=()):
        return L.init_norm(cfg, cfg.d_model, dtype, lead=lead, device=dev)

    def ssm_layers(lead):
        ssm = S.init_ssm(generator, cfg, math.prod(lead), dtype)
        return {"norm": norm(lead),
                "ssm": {k: v.reshape(lead + v.shape[1:])
                        for k, v in ssm.items()}}

    def dense_layers(n, cross: bool = False):
        p = {"attn_norm": norm((n,)),
             "attn": L.init_attention(generator, cfg, n, dtype),
             "mlp_norm": norm((n,))}
        if cross:
            p["cross_norm"] = norm((n,))
            p["cross"] = L.init_cross_attention(generator, cfg, n, dtype)
        if cfg.moe.enabled:
            p["moe"] = M.init_moe(generator, cfg, n, dtype)
        else:
            p["mlp"] = L.init_mlp(generator, cfg.d_model, cfg.d_ff, n, dtype,
                                  gated=cfg.gated_mlp)
        return p

    params: Params = {
        "embed": L.embed_init(generator, cfg.vocab_size, cfg.d_model, dtype),
        "final_norm": norm(),
    }
    if cfg.family == "ssm":
        params["layers"] = ssm_layers((n,))
    elif cfg.family == "hybrid":
        n_groups, inner, tail = hybrid_layout(cfg)
        params["groups"] = ssm_layers((n_groups, inner))
        if tail:
            params["tail"] = ssm_layers((tail,))
        # one layer, unstacked: the same weights after every group
        params["shared_attn"] = _unstack(dense_layers(1), 1)[0]
    elif cfg.family == "audio":
        params["enc_pos"] = L.embed_init(generator, cfg.encoder.n_frames,
                                         cfg.d_model, dtype)
        params["pos_embed"] = L.embed_init(
            generator, cfg.max_position_embeddings, cfg.d_model, dtype)
        params["enc_layers"] = dense_layers(cfg.encoder.n_layers)
        params["enc_final_norm"] = norm()
        params["layers"] = dense_layers(n, cross=True)
    else:
        params["layers"] = dense_layers(n)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(generator, cfg.d_model,
                                         cfg.vocab_size, dtype)
    return params


def abstract_params(cfg) -> Params:
    """``init_params(cfg)``'s tree on the meta device: every leaf's shape
    and dtype, nothing drawn or allocated (the reference's
    ``jax.eval_shape`` of its ``init_params``)."""
    return init_params(cfg, L.MetaGenerator())


def abstract_cache(cfg, batch: int, max_len: int,
                   sliding_window: Optional[int] = None,
                   kv_dtype: Optional[str] = None) -> Cache:
    """:func:`init_cache` on the meta device (nothing allocated)."""
    return init_cache(cfg, batch, max_len, torch.device("meta"),
                      kv_dtype=kv_dtype, sliding_window=sliding_window)


def _unstack(tree, n: int) -> List[Any]:
    """Stacked layer tree -> list of n per-layer trees (views)."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


# =========================================================================== #
# Embedding / unembedding
# =========================================================================== #


def embed_tokens(params: Params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding lookup with ids clamped to [0, vocab - 1], as JAX's gather
    clamps an out-of-range index (torch would raise, or assert on the
    card)."""
    return params["embed"][tokens.long().clamp(0, cfg.vocab_size - 1)]


def learned_positions(params: Params, cfg, pos: torch.Tensor):
    """The learned position embeddings of ``pos``, clamped to [0,
    max_position_embeddings - 1] as JAX's gather clamps."""
    return params["pos_embed"][
        pos.long().clamp(0, cfg.max_position_embeddings - 1)]


def encode_audio(params: Params, cfg, frames: torch.Tensor, *, mesh=None):
    """The whisper encoder over stub frame embeddings (B, n_frames, d):
    the frames in the model's dtype plus ``enc_pos``, then [norm -> plain
    bidirectional attention -> norm -> MLP] per encoder layer (no rotary,
    no kernel, as in the reference), then the final norm.  With ``mesh``,
    ``params`` is the list of rank trees: each rank runs its heads and
    FFN columns, the ranks' partials after ``wo`` and ``w_down`` are
    summed (module docstring), and the result is the list of each rank's
    copy of the output."""
    shards, _, _, lcfgs = _ranks(params, cfg, None, mesh)
    outs = _encode(shards, cfg, lcfgs, frames)
    return outs if mesh is not None else outs[0]


def _encode(shards: List[Params], cfg, lcfgs, frames: torch.Tensor):
    """:func:`encode_audio` on every rank (``lcfgs`` the rank configs)."""
    hs = [_frames_in(p, cfg, frames) for p in shards]
    layers = [_unstack(p["enc_layers"], cfg.encoder.n_layers) for p in shards]
    for lps in zip(*layers):
        hs = _enc_layer(cfg, lcfgs, list(lps), hs)
    return [L.apply_norm(cfg, p["enc_final_norm"], h)
            for p, h in ranked(zip(shards, hs))]


def _frames_in(p: Params, cfg, frames: torch.Tensor) -> torch.Tensor:
    """The encoder's input: the frames in the model's dtype plus
    ``enc_pos``."""
    return (frames.to(p["enc_pos"].device, _dtype(cfg))
            + p["enc_pos"][None, :frames.shape[1]])


def _enc_layer(cfg, lcfgs, lps: List[Params], hs: List[torch.Tensor]):
    """One encoder layer on every rank: plain bidirectional attention over
    each rank's uniform GQA segments, the ranks' ``wo`` partials summed,
    then the MLP."""
    b, s, _ = hs[0].shape
    parts = []
    heads = _heads(cfg, lcfgs) or [None]
    for lp, h, lc, hd0 in ranked(zip(lps, hs, lcfgs, heads)):
        a = lp["attn"]
        nh, kh, hd = lc.n_heads, lc.n_kv_heads, lc.head_dim
        x = L.apply_norm(cfg, lp["attn_norm"], h)
        out = L.ref.over_segments(
            L.sdpa, (x @ a["wq"]).reshape(b, s, nh, hd),
            (x @ a["wk"]).reshape(b, s, kh, hd),
            (x @ a["wv"]).reshape(b, s, kh, hd), L.head_segments(lc, hd0),
            causal=False)
        parts.append(out.reshape(b, s, nh * hd) @ a["wo"])
    return _mlp(cfg, lcfgs, lps, _add_sum(hs, parts), "dense")


def unembed(params: Params, cfg, h: torch.Tensor) -> torch.Tensor:
    h = L.apply_norm(cfg, params["final_norm"], h)
    if cfg.tie_embeddings:
        return h @ params["embed"].T
    return h @ params["lm_head"]


# =========================================================================== #
# Forward (training / full sequence)
# =========================================================================== #


def embed_inputs(params: Params, cfg, batch: Dict):
    """(hidden (B, S, d_model), positions (B, S) or (3, B, S)) of a
    full-sequence batch: the tokens embedded (ids clamped,
    :func:`embed_tokens`), the vlm's stub ``batch["embeds"]`` prepended,
    ``batch["positions"]`` when given (else 0..S-1 on every row), and the
    learned positions added where the config has them."""
    dev = params["embed"].device
    h = embed_tokens(params, cfg, batch["tokens"].to(dev))
    embeds = batch.get("embeds")
    if cfg.frontend == "vision_stub" and embeds is not None:
        h = torch.cat([embeds.to(dev, h.dtype), h], 1)
    b, s = h.shape[:2]
    pos = batch.get("positions")
    pos = (torch.arange(s, device=dev)[None, :].expand(b, s) if pos is None
           else pos.to(dev))
    if cfg.rope_type == "learned":
        h = h + learned_positions(params, cfg, pos)
    return h, pos


def forward(params: Params, cfg, batch: Dict, *, attn_impl: str = "torch",
            moe_impl: str = "dense", remat: bool = False, mesh=None):
    """Teacher-forced full-sequence forward of every family: (logits (B,
    S, V), aux) with S the batch's positions (the vlm's patches and text),
    and ``aux`` the sum over MoE layers of the router's load-balance loss
    (fp32; 0 for the other families, the hybrid's shared block included,
    as in the reference).  No cache is read or written.

    ``attn_impl="torch"`` (the default, the reference's ``"xla"``) runs
    the plain attention and SSD scan, which autograd differentiates;
    ``"kernel"`` runs ``flash_attention`` and ``ssd_scan``, which have no
    backward: an evaluation forward under ``torch.no_grad()`` (under grad
    the wrappers raise, :func:`repro_torch.kernels.ops.refuse_autograd`).
    The audio family's encoder and cross-attention are plain either way.
    ``remat=True`` recomputes each layer body in the backward pass
    (``torch.utils.checkpoint``), the encoder's too, and for the hybrid
    each inner SSM layer and each group, as the reference's
    ``jax.checkpoint`` does.  With ``mesh`` (a ``("model",)`` mesh)
    ``params`` is the list of rank trees of ``launch.partition
    .shard_params``: every rank runs its share of each layer and the
    ranks sum their partials (module docstring), remat per layer over
    the ranks' bodies; the logits and ``aux`` lie on rank 0's device, and
    autograd reaches every rank's leaves."""
    if mesh is not None:
        return _forward_ranks(params, cfg, batch, attn_impl, moe_impl, remat,
                              mesh)
    _check_family(cfg)
    run = _checkpointed if remat else (lambda fn, *args: fn(*args))
    h, pos = embed_inputs(params, cfg, batch)
    cos_sin = L.positional_cos_sin(cfg, pos)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.family == "ssm":
        for lp in _unstack(params["layers"], cfg.n_layers):
            h = run(_ssm_layer, cfg, attn_impl, lp, h)
    elif cfg.family == "hybrid":
        groups, tails, shared = _hybrid_layers(params, cfg)

        def group(x, lps):
            for lp in lps:
                x = run(_ssm_layer, cfg, attn_impl, lp, x)
            return _dense_layer(cfg, attn_impl, moe_impl, shared, x,
                                cos_sin)[0]

        for lps in groups:
            h = run(group, h, lps)
        for lp in tails:
            h = run(_ssm_layer, cfg, attn_impl, lp, h)
    elif cfg.family == "audio":
        enc = _frames_in(params, cfg, batch["frames"])
        for lp in _unstack(params["enc_layers"], cfg.encoder.n_layers):
            enc = run(lambda x, lp: _enc_layer(cfg, [cfg], [lp], [x])[0],
                      enc, lp)
        enc = L.apply_norm(cfg, params["enc_final_norm"], enc)
        for lp in _unstack(params["layers"], cfg.n_layers):
            h = run(_audio_layer, cfg, attn_impl, lp, h, enc)
    else:
        for lp in _unstack(params["layers"], cfg.n_layers):
            h, a = run(_dense_layer, cfg, attn_impl, moe_impl, lp, h,
                       cos_sin)
            aux = aux + a
    return unembed(params, cfg, h), aux


def _forward_ranks(params, cfg, batch: Dict, attn_impl: str, moe_impl: str,
                   remat: bool, mesh):
    """:func:`forward` over the ranks of ``mesh``: the prefill's rank
    bodies with no cache."""
    shards, _, ranks, lcfgs = _ranks(params, cfg, None, mesh)
    run = _checkpointed if remat else (lambda fn, *args: fn(*args))
    hs, pos = _embed_batch(shards, cfg, batch, ranks)
    cos_sins = None if cfg.family == "ssm" else _rank_cos_sins(cfg, pos,
                                                               ranks)
    zero = torch.zeros((), dtype=torch.float32, device=ranks[0])
    auxs = [zero]

    def ssm_layer(*hs, lps):
        return tuple(_ssm_body(cfg, attn_impl, list(lps), list(hs))[0])

    def attn_layer(*hs, lps, mlp=True):
        aux = []
        out = _attn_prefill(cfg, lcfgs, list(lps), list(hs), cos_sins, None,
                            0, attn_impl, moe_impl, mlp=mlp, aux=aux)
        return (*out, sum(aux) if aux else zero)

    if cfg.family == "ssm":
        for lps in zip(*[_unstack(p["layers"], cfg.n_layers)
                         for p in shards]):
            hs = run(functools.partial(ssm_layer, lps=lps), *hs)
    elif cfg.family == "hybrid":
        per = [_hybrid_layers(p, cfg) for p in shards]

        def group(*hs, g):
            for lps in zip(*[q[0][g] for q in per]):
                hs = run(functools.partial(ssm_layer, lps=lps), *hs)
            return attn_layer(*hs, lps=[q[2] for q in per])[:-1]

        for g in range(len(per[0][0])):
            hs = run(functools.partial(group, g=g), *hs)
        for lps in zip(*[q[1] for q in per]):
            hs = run(functools.partial(ssm_layer, lps=lps), *hs)
    elif cfg.family == "audio":
        enc = [_frames_in(p, cfg, batch["frames"]) for p in shards]
        for lps in zip(*[_unstack(p["enc_layers"], cfg.encoder.n_layers)
                         for p in shards]):
            enc = run(lambda *e, lps=lps: tuple(
                _enc_layer(cfg, lcfgs, list(lps), list(e))), *enc)
        enc = [L.apply_norm(cfg, p["enc_final_norm"], e)
               for p, e in ranked(zip(shards, enc))]
        n = len(shards)

        def dec_layer(*args, lps):
            hs, encs = list(args[:n]), args[n:]
            hs = attn_layer(*hs, lps=lps, mlp=False)[:-1]
            crosses = [L.encode_cross_kv(lp["cross"], lc, e)
                       for lp, lc, e in ranked(zip(lps, lcfgs, encs))]
            return tuple(_cross_mlp(cfg, lcfgs, list(lps), list(hs), crosses,
                                    moe_impl))

        for lps in zip(*[_unstack(p["layers"], cfg.n_layers)
                         for p in shards]):
            hs = run(functools.partial(dec_layer, lps=lps), *hs, *enc)
    else:
        for lps in zip(*[_unstack(p["layers"], cfg.n_layers)
                         for p in shards]):
            *hs, aux = run(functools.partial(attn_layer, lps=lps), *hs)
            auxs.append(aux)
    aux = auxs[0]
    for a in auxs[1:]:
        aux = aux + a.to(aux.device)
    return _unembed(shards, cfg, list(hs)), aux


def _checkpointed(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass.  The
    recomputation runs under the rank mark the forward ran under
    (``ranks.current_rank``), and it stops once it has what the backward
    needs, possibly inside a loop over the ranks: the mark the backward
    had is restored after it."""
    rank = current_rank()

    def run(*a):
        with on_rank(rank):
            return fn(*a)

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)


def _dense_layer(cfg, attn_impl: str, moe_impl: str, lp: Params,
                 x: torch.Tensor, cos_sin):
    """One attention + MLP (or MoE) layer over the full sequence: (the
    residual stream, the layer's aux loss)."""
    out, _ = L.attention_block(lp["attn"], cfg,
                               L.apply_norm(cfg, lp["attn_norm"], x), cos_sin,
                               attn_impl=attn_impl)
    x = x + out
    h = L.apply_norm(cfg, lp["mlp_norm"], x)
    if cfg.moe.enabled:
        out, aux = M.moe_block(lp["moe"], cfg, h, impl=moe_impl)
        return x + out, aux
    return (x + L.mlp_block(lp["mlp"], cfg, h),
            torch.zeros((), dtype=torch.float32, device=x.device))


def _ssm_layer(cfg, impl: str, lp: Params, x: torch.Tensor) -> torch.Tensor:
    """One Mamba2 layer over the full sequence."""
    return x + S.ssm_forward(lp["ssm"], cfg, L.apply_norm(cfg, lp["norm"], x),
                             impl=impl)[0]


def _audio_layer(cfg, attn_impl: str, lp: Params, x: torch.Tensor,
                 enc_out: torch.Tensor) -> torch.Tensor:
    """One whisper decoder layer over the full sequence: causal self
    attention, cross-attention over ``enc_out``, the MLP."""
    out, _ = L.attention_block(lp["attn"], cfg,
                               L.apply_norm(cfg, lp["attn_norm"], x), None,
                               attn_impl=attn_impl)
    x = x + out
    x = x + L.cross_attention_block(
        lp["cross"], cfg, L.apply_norm(cfg, lp["cross_norm"], x),
        L.encode_cross_kv(lp["cross"], cfg, enc_out))
    return x + L.mlp_block(lp["mlp"], cfg, L.apply_norm(cfg, lp["mlp_norm"], x))


# =========================================================================== #
# Layer bodies
# =========================================================================== #


def _hybrid_layers(params: Params, cfg):
    """The hybrid's per-layer trees (views): a list per group, the tail
    list, and the shared block."""
    n_groups, inner, tail = hybrid_layout(cfg)
    groups = [_unstack(g, inner) for g in _unstack(params["groups"], n_groups)]
    tails = _unstack(params["tail"], tail) if tail else []
    return groups, tails, params["shared_attn"]


def _group_states(caches, g: int) -> List[Dict]:
    """Each rank's state stacks of hybrid group ``g`` (views)."""
    return [{k: v[g] for k, v in c["groups_ssm"].items()} for c in caches]


def _ssm_layers(cfg, impl, layers, hs, states, decode: bool = False,
                actives=None):
    """Run the SSM layers in order over the residual streams ``hs``, one a
    rank: ``layers[r]`` is rank r's list of layer trees, ``states[r]`` maps
    each state name to rank r's stack (layer i at index i, views allowed):
    a prefill writes each layer's decode state there, a decode step reads
    it and writes the new one, in place."""
    for i, lps in enumerate(zip(*layers)):
        olds = ([{k: v[i] for k, v in st.items()} for st in states]
                if decode else None)
        hs, news = _ssm_body(cfg, impl, list(lps), hs, olds, actives)
        for st, new in ranked(zip(states, news)):
            for k, v in new.items():
                st[k][i] = v
    return hs


def _ssm_body(cfg, impl, lps: List[Params], hs, states=None, actives=None):
    """One SSM layer on every rank.  Prefill (``states is None``): returns
    (the residual streams plus the block's output, each rank's decode
    state).  Decode: returns (the streams, each rank's new state); rows
    with ``active=False`` keep their state bit for bit."""
    xs = [L.apply_norm(cfg, lp["norm"], h) for lp, h in ranked(zip(lps, hs))]
    ps = [lp["ssm"] for lp in lps]
    if states is None:
        parts, news = S.ssm_partials(ps, cfg, xs, impl=impl)
        return _add_sum(hs, parts), news
    parts, news = S.ssm_decode_partials(ps, cfg, xs, states)
    if actives is not None and actives[0] is not None:
        news = [{k: torch.where(act.reshape((-1,) + (1,) * (v.ndim - 1)), v,
                                old[k])
                 for k, v in new.items()}
                for new, old, act in ranked(zip(news, states, actives))]
    return _add_sum(hs, parts), news


# =========================================================================== #
# KV / state caches
# =========================================================================== #


def kv_buffer_len(cfg, max_len: int) -> int:
    """Physical KV buffer length: ring-bounded for SWA configs."""
    if cfg.attention_type == "swa":
        return min(max_len, cfg.swa_window)
    return max_len


KV_DTYPES = (None, "int8")


def init_cache(cfg, batch: int, max_len: int, device=None, dtype=None, *,
               mesh=None, kv_dtype: Optional[str] = None,
               sliding_window: Optional[int] = None, kv_shard: str = "heads",
               context=None):
    """Slot cache: per-slot lengths ``len`` (B,) int32, and for the dense
    family K/V buffers (n_layers, B, buf, KH, D), for the SSM family the
    recurrent states ``{"conv": (n_layers, B, CH, d_conv - 1), "ssm":
    (n_layers, B, H, P, N)}``, for the hybrid family the states
    ``groups_ssm`` (n_groups, inner, B, ...) and ``tail_ssm`` (tail, B,
    ...) and K/V buffers over its n_groups attention sites.  ``buf`` is
    :func:`kv_buffer_len`, cut to ``sliding_window`` when it is given; the
    buffer is a ring when ``buf < max_len``.  The audio family's K/V
    buffers have ``min(max_len, max_position_embeddings)`` rows, never a
    ring, and beside them ``cross_kv``: the cross-attention K/V (n_layers,
    B, n_frames, H, head_dim) that its prefill writes.
    ``kv_dtype="int8"`` makes
    the K/V buffers int8 codes with fp32 scales (sites, B, buf); it does
    nothing for the SSM family, as in the reference.  With ``mesh``: one
    cache per rank on the rank's device, with the KV heads the rank's
    query heads read (``launch.partition.kv_head_range``) and the SSM
    states of its conv channels and heads (``conv`` (..., B, CH_r, d_conv
    - 1), ``ssm`` (..., B, H_r, P, N); ``launch.partition.ssm_widths``),
    and, for the audio family, the cross K/V of its query heads, each
    with its own ``len``; an int8 cache holds each rank's KV heads' codes
    and its own copy of the per-token scales (sites, B, buf), which the
    writes keep equal on every rank (module docstring).

    ``kv_shard`` (with ``mesh``; ``launch.partition.kv_layout``): "heads"
    is the layout above; "seq" (or "auto" where the ranks do not divide
    the KV heads) gives rank r every KV head over its rows ``[r0, r1)`` of
    the buffer (``launch.partition.split_range``), the int8 scales with the
    rows; a ring's position p lies at buffer row ``p % buf``, on the rank
    whose range holds that row (``models.kv_split``).  "head_dim" gives
    rank r dims ``[d0, d1)`` of every KV head's rows
    (``launch.partition.split_range`` of ``head_dim``: whole dims, the
    first ranks one more where the ranks do not divide it).  ``context=(D,
    indices)``: the context-parallel cache, the head layout's KV heads
    over D row ranges, of which each rank holds those of the data
    ``indices`` (``layers.KVShards``).  The audio family's ``cross_kv``
    follows the same rule, as the reference's ``cache_pspecs`` does:
    under "seq" rank r holds every query head's K/V over its frames
    ``split_range(n_frames, tp, r)``, under "head_dim" its dims of every
    head (``models.kv_split``); the context-parallel cache keeps it in
    the head layout, over the rank's query heads."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, got "
                         f"{kv_dtype!r}")
    if mesh is not None:
        ranks = P.tp_ranks(mesh)
        tp = len(ranks)
        layout = P.kv_layout(cfg, tp, kv_shard)
        return [_rank_cache(P.local_config(cfg, tp, r), batch, max_len, d,
                            dtype, kv_dtype, sliding_window, tp, r,
                            rows=_rows(layout, context, tp, r),
                            kv_heads=(cfg.n_kv_heads if layout != "heads"
                                      else None),
                            q_heads=cfg.n_heads,
                            dims=(P.split_range(cfg.head_dim, tp, r)
                                  if layout == "head_dim" else None))
                for r, d in enumerate(ranks)]
    if context is not None:
        return _rank_cache(cfg, batch, max_len, device, dtype, kv_dtype,
                           sliding_window, 1, rows=_rows("heads", context))
    _check_family(cfg)
    return _rank_cache(cfg, batch, max_len, device, dtype, kv_dtype,
                       sliding_window, 1)


def _rows(layout: str, context, tp: int = 1, rank: int = 0):
    """The row pieces a rank holds, as (piece, of how many) pairs: one of
    ``tp`` in the sequence-sharded layout, its data indices of D in the
    context-parallel one, None for the whole buffer."""
    if context is not None:
        n, idx = context
        return [(i, n) for i in idx]
    return [(rank, tp)] if layout == "seq" else None


def _rank_cache(cfg, batch, max_len, device, dtype, kv_dtype, sliding_window,
                tp: int, rank: int = 0, rows=None,
                kv_heads: Optional[int] = None, dims=None,
                q_heads: Optional[int] = None) -> Cache:
    """The cache of rank ``rank`` of ``tp`` (:func:`init_cache`); ``cfg``
    is the rank's config, its SSM states over the rank's conv channels and
    heads.  ``rows``: the row pieces it holds (:func:`_rows`);
    ``kv_heads``: every KV head (the sequence-sharded and head-dim
    layouts); ``dims``: the head dims ``[d0, d1)`` it holds; ``q_heads``:
    every query head, whose cross K/V the audio family's rank holds over
    its frames or dims in those two layouts."""
    dtype = dtype or _dtype(cfg)
    cache: Cache = {"len": torch.zeros((batch,), dtype=torch.int32,
                                       device=device)}
    n_sites = cfg.n_layers
    if cfg.family in ("ssm", "hybrid"):
        state = S.init_ssm_state(cfg, batch, dtype, device, tp, rank)

        def stacked(lead):
            return {k: v.new_zeros(lead + v.shape) for k, v in state.items()}

        if cfg.family == "ssm":
            cache["ssm"] = stacked((cfg.n_layers,))
            return cache
        n_sites, inner, tail = hybrid_layout(cfg)
        cache["groups_ssm"] = stacked((n_sites, inner))
        if tail:
            cache["tail_ssm"] = stacked((tail,))
    buf = kv_buffer_len(cfg, max_len)
    if sliding_window is not None:
        buf = min(buf, sliding_window)
    ring = buf < max_len
    if cfg.family == "audio":
        buf, ring = min(max_len, cfg.max_position_embeddings), False

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    def kv(row0: int, n: int) -> KVCache:
        d0, d1 = dims or (0, cfg.head_dim)
        shape = (n_sites, batch, n, kv_heads or cfg.n_kv_heads, d1 - d0)
        where = dict(row0=row0, total=buf if rows or dims else 0, dim0=d0,
                     dims=cfg.head_dim if dims else 0)
        if kv_dtype == "int8":
            return KVCache(zeros(shape, torch.int8), zeros(shape, torch.int8),
                           ring, zeros(shape[:3], torch.float32),
                           zeros(shape[:3], torch.float32), **where)
        return KVCache(zeros(shape, dtype), zeros(shape, dtype), ring,
                       **where)

    if rows is None:
        cache["kv"] = kv(0, buf)
    else:
        pieces = [kv(r0, r1 - r0) for r0, r1 in
                  (P.split_range(buf, n, i) for i, n in rows)]
        cache["kv"] = pieces[0] if kv_heads is not None else L.KVShards(
            pieces)
    if cfg.family == "audio":
        nf = cfg.encoder.n_frames
        where, heads = {}, cfg.n_heads
        if kv_heads is not None and dims:  # every head, the rank's dims
            where = dict(dim0=dims[0], dims=cfg.head_dim, total=nf)
            heads = q_heads
        elif kv_heads is not None:  # every head, the rank's frames
            f0, f1 = P.split_range(nf, rows[0][1], rows[0][0])
            where = dict(row0=f0, total=nf)
            heads, nf = q_heads, f1 - f0
        d0, d1 = dims or (0, cfg.head_dim)
        cross = (cfg.n_layers, batch, nf, heads, d1 - d0)
        cache["cross_kv"] = KVCache(zeros(cross, dtype), zeros(cross, dtype),
                                    **where)
    return cache


def _write_prompts(kvcs: List[KVCache], i: int, ks: List[torch.Tensor],
                   vs: List[torch.Tensor], ranges=None) -> None:
    """Write each rank's prompt K/V (B, S, KHr, D) into layer ``i`` of its
    cache, in place (:func:`_write_prompt`); an int8 cache takes their
    codes under the scales the ranks share (``layers.quantize_kv_shared``).
    The prompt's own attention read the fresh K/V, unquantized, as in the
    reference.  A cache whose rows the pod splits takes its rows where
    their owners lie (``kv_split.write_prompts``; ``ranges``: each rank's
    KV heads)."""
    if kv_split.split(kvcs[0]):
        kv_split.write_prompts(kvcs, i, ks, vs, ranges)
        return
    if not kvcs[0].quantized:
        for kvc, k, v in ranked(zip(kvcs, ks, vs)):
            _write_prompt(kvc, i, [(kvc.k, k), (kvc.v, v)])
        return
    for kvc, (kq, ksc), (vq, vsc) in ranked(zip(
            kvcs, L.quantize_kv_shared(ks), L.quantize_kv_shared(vs))):
        _write_prompt(kvc, i, [(kvc.k, kq), (kvc.v, vq), (kvc.k_scale, ksc),
                               (kvc.v_scale, vsc)])


def _write_prompt(kvc: KVCache, i: int, pairs) -> None:
    """Write each (buffer, prompt rows (B, S, ...)) pair of ``pairs`` into
    layer ``i`` of the cache ``kvc``, in place: rows [0, S), or in a ring
    the last ``min(S, L)`` tokens at rows ``pos % L``."""
    k = pairs[0][1]
    s, buf = k.shape[1], kvc.k.shape[2]
    if kvc.ring:
        take = min(s, buf)
        slots = torch.arange(s - take, s, device=k.device) % buf
        for dst, src in pairs:
            dst[i][:, slots] = src[:, s - take:]
    else:
        for dst, src in pairs:
            dst[i, :, :s] = src


# =========================================================================== #
# Prefill
# =========================================================================== #


#: the most rows of the flattened (B * S) prompt batch that one-shot
#: :func:`prefill` runs through a layer's dense MLP at once: a longer batch
#: runs the norm and the MLP chunk by chunk into one buffer (:func:`_mlp`),
#: which changes no sum, since both act on each row alone.  Sized for
#: qwen2-1.5b's prefill_32k step (B=32 x 32768 = 2**20 rows) on one 80 GB
#: card: the gate, up and product transients of 2**18 rows are 3 x 2**18 x
#: 8960 bf16 = 14.1 GB, where the whole batch's 56.4 GB put the step's
#: peak at 89.2 GB.  A batch of at most 2**18 rows (one prompt of 32768
#: tokens, every served window) runs in one piece.
PREFILL_MLP_ROWS = 1 << 18


def prefill(params: Params, cfg, batch: Dict, cache: Cache, *,
            attn_impl: str = "kernel", moe_impl: str = "dense",
            last_index: Optional[torch.Tensor] = None, mesh=None):
    """Process the full (right-padded) prompt batch, set ``len`` to S, and
    return the logits (B, 1, V) at ``last_index`` (B,) — each row's true
    last position — or at the last position.  The dense family writes its
    K/V into rows ``[0, S)`` of every slot of ``cache`` (a ring keeps the
    last tokens, an int8 cache their codes), the SSM family its decode
    states, the hybrid family both (one K/V site per group), in place.
    ``attn_impl`` picks the kernels ("kernel") or the plain path ("torch")
    for attention and for the SSD scan alike.  The vlm family reads
    ``batch["embeds"]`` and ``batch["positions"]`` when they are given,
    the audio family ``batch["frames"]`` (module docstring).  With
    ``mesh``, see the module docstring; the logits lie on rank 0's
    device."""
    shards, caches, ranks, lcfgs = _ranks(params, cfg, cache, mesh)
    hs, pos = _embed_batch(shards, cfg, batch, ranks)
    b, s = hs[0].shape[:2]
    if cfg.family != "ssm":
        cos_sins = _rank_cos_sins(cfg, pos, ranks)
    if cfg.family == "ssm":
        hs = _ssm_layers(cfg, attn_impl,
                         [_unstack(p["layers"], cfg.n_layers)
                          for p in shards], hs, [c["ssm"] for c in caches])
    elif cfg.family == "hybrid":
        per = [_hybrid_layers(p, cfg) for p in shards]
        for g in range(len(per[0][0])):
            hs = _ssm_layers(cfg, attn_impl, [q[0][g] for q in per], hs,
                             _group_states(caches, g))
            hs = _attn_prefill(cfg, lcfgs, [q[2] for q in per], hs, cos_sins,
                               caches, g, attn_impl, moe_impl,
                               rows=PREFILL_MLP_ROWS)
        if per[0][1]:
            hs = _ssm_layers(cfg, attn_impl, [q[1] for q in per], hs,
                             [c["tail_ssm"] for c in caches])
    elif cfg.family == "audio":
        enc_outs = _encode(shards, cfg, lcfgs, batch["frames"])
        layers = [_unstack(p["layers"], cfg.n_layers) for p in shards]
        for i in range(cfg.n_layers):
            lps = [per[i] for per in layers]
            hs = _attn_prefill(cfg, lcfgs, lps, hs, cos_sins, caches, i,
                               attn_impl, moe_impl, mlp=False)
            crosses = [L.encode_cross_kv(lp["cross"], lc, enc_out)
                       for lp, lc, enc_out in ranked(zip(lps, lcfgs,
                                                         enc_outs))]
            xkv = [c["cross_kv"] for c in caches]
            if kv_split.split(xkv[0]):  # each rank its frames or dims
                kv_split.write_cross(xkv, i, [k for k, _ in crosses],
                                     [v for _, v in crosses],
                                     kv_split.q_ranges(lcfgs))
            else:
                for c, (ck, cv) in ranked(zip(xkv, crosses)):
                    c.k[i].copy_(ck)
                    c.v[i].copy_(cv)
            hs = _cross_mlp(cfg, lcfgs, lps, hs, crosses, moe_impl,
                            rows=PREFILL_MLP_ROWS)
    else:
        layers = [_unstack(p["layers"], cfg.n_layers) for p in shards]
        for i in range(cfg.n_layers):
            hs = _attn_prefill(cfg, lcfgs, [per[i] for per in layers], hs,
                               cos_sins, caches, i, attn_impl, moe_impl,
                               rows=PREFILL_MLP_ROWS)
    for c, d in zip(caches, ranks):
        c["len"] = torch.full((b,), s, dtype=torch.int32, device=d)
    if last_index is not None:
        hs = [h[torch.arange(b, device=h.device),
                last_index.to(h.device).long()][:, None, :] for h in hs]
    else:
        hs = [h[:, -1:, :] for h in hs]
    return _unembed(shards, cfg, hs), cache


#: families :func:`prefill_chunk` supports — attention-only stacks whose KV
#: writes are position-addressable (the reference's tuple).  Recurrent
#: state (ssm/hybrid) absorbs every position it sees, and the audio family
#: carries encoder cross-K/V seeded by the one-shot path; both keep exact
#: one-shot prefill.
CHUNKABLE_FAMILIES = ("dense", "moe", "vlm")


def prefill_chunk(params: Params, cfg, batch: Dict, cache: Cache, *,
                  attn_impl: str = "kernel", moe_impl: str = "dense",
                  start, valid_len, mesh=None):
    """Process ONE prompt chunk against a partially filled cache.

    ``batch["tokens"]`` is (B, C): C chunk tokens (right-padded to a shape
    bucket), of which the first ``valid_len`` (B,) are real, starting at
    absolute position ``start`` (B,) = tokens already prefilled.  The
    chunk's K/V are written into rows ``[start, start + valid_len)`` of the
    cache, in place, and its queries attend over the whole buffer under a
    ``kv_len`` mask with the plain ``sdpa`` (``layers.attention_decode``),
    whatever ``attn_impl`` is, as in the reference.  Sets ``len`` to
    ``start + valid_len`` and returns the logits at the chunk's last valid
    position (B, 1, V): the caller samples the first output token from the
    final chunk's, as it does from one-shot prefill's.

    Only :data:`CHUNKABLE_FAMILIES` with dense unquantized KV caches are
    supported; callers fall back to one-shot prefill otherwise.  With
    ``mesh``, see the module docstring: every rank writes its own KV heads'
    span and reads its own cache; the logits lie on rank 0's device."""
    if cfg.family not in CHUNKABLE_FAMILIES:
        raise ValueError(
            f"prefill_chunk supports families {CHUNKABLE_FAMILIES}, "
            f"got {cfg.family!r} — use one-shot prefill")
    shards, caches, ranks, lcfgs = _ranks(params, cfg, cache, mesh)
    tokens = batch["tokens"]
    b, c = tokens.shape
    starts = [torch.as_tensor(start, dtype=torch.int32, device=d).expand(b)
              for d in ranks]
    valids = [torch.as_tensor(valid_len, dtype=torch.int32,
                              device=d).expand(b) for d in ranks]
    hs = _embed(shards, cfg, tokens, ranks)
    cos_sins = [L.positional_cos_sin(
        cfg, st.long()[:, None] + torch.arange(c, device=d)[None, :])
        for st, d in zip(starts, ranks)]
    layers = [_unstack(p["layers"], cfg.n_layers) for p in shards]
    for i in range(cfg.n_layers):
        hs = _attn_decode(cfg, lcfgs, [per[i] for per in layers], hs,
                          cos_sins, caches, i, starts, None, attn_impl,
                          moe_impl, valid_lens=valids)
    for cc, st, v in zip(caches, starts, valids):
        cc["len"] = st + v
    hs = [h[torch.arange(b, device=h.device), (v - 1).long()][:, None, :]
          for h, v in ranked(zip(hs, valids))]
    return _unembed(shards, cfg, hs), cache


# =========================================================================== #
# Decode step
# =========================================================================== #


def decode_step(params: Params, cfg, tokens: torch.Tensor, cache: Cache, *,
                attn_impl: str = "kernel", moe_impl: str = "grouped",
                active: Optional[torch.Tensor] = None, mesh=None):
    """One-token step: tokens (B, 1) -> (logits (B, 1, V), cache).

    ``active`` (B,) bool: inactive rows (unoccupied or EOS-frozen slots) are
    computed but write no K/V (dense) or state (SSM) and keep their ``len``,
    so their cache stays bit-identical.  The SSM step is plain PyTorch
    whatever ``attn_impl`` is, as in the reference; the hybrid's shared
    block reads its site of the cache as the dense family does.  Every
    row's position is its ``len`` (on all three M-RoPE axes for the vlm
    family; clamped to the last learned position for the audio family,
    whose cross-attention reads the ``cross_kv`` its prefill wrote, with
    plain attention).  With ``mesh``, see the module docstring; the logits
    lie on rank 0's device."""
    shards, caches, ranks, lcfgs = _ranks(params, cfg, cache, mesh)
    curs = [c["len"] for c in caches]
    acts = [None if active is None else active.to(d) for d in ranks]
    hs = _embed(shards, cfg, tokens, ranks)
    if cfg.rope_type == "learned":
        hs = [h + learned_positions(p, cfg, cur)[:, None, :]
              for p, h, cur in ranked(zip(shards, hs, curs))]
    if cfg.family != "ssm":
        cos_sins = [L.positional_cos_sin(cfg, cur[:, None]) for cur in curs]
    if cfg.family == "ssm":
        hs = _ssm_layers(cfg, attn_impl,
                         [_unstack(p["layers"], cfg.n_layers)
                          for p in shards], hs, [c["ssm"] for c in caches],
                         True, acts)
    elif cfg.family == "hybrid":
        per = [_hybrid_layers(p, cfg) for p in shards]
        for g in range(len(per[0][0])):
            hs = _ssm_layers(cfg, attn_impl, [q[0][g] for q in per], hs,
                             _group_states(caches, g), True, acts)
            hs = _attn_decode(cfg, lcfgs, [q[2] for q in per], hs, cos_sins,
                              caches, g, curs, acts, attn_impl, moe_impl)
        if per[0][1]:
            hs = _ssm_layers(cfg, attn_impl, [q[1] for q in per], hs,
                             [c["tail_ssm"] for c in caches], True, acts)
    elif cfg.family == "audio":
        layers = [_unstack(p["layers"], cfg.n_layers) for p in shards]
        for i in range(cfg.n_layers):
            lps = [per[i] for per in layers]
            hs = _attn_decode(cfg, lcfgs, lps, hs, cos_sins, caches, i, curs,
                              acts, attn_impl, moe_impl, mlp=False)
            hs = _cross_mlp(cfg, lcfgs, lps, hs,
                            [c["cross_kv"].layer(i) for c in caches],
                            moe_impl)
    else:
        layers = [_unstack(p["layers"], cfg.n_layers) for p in shards]
        for i in range(cfg.n_layers):
            hs = _attn_decode(cfg, lcfgs, [per[i] for per in layers], hs,
                              cos_sins, caches, i, curs, acts, attn_impl,
                              moe_impl)
    for c, cur, act in zip(caches, curs, acts):
        c["len"] = cur + 1 if act is None else torch.where(act, cur + 1, cur)
    return _unembed(shards, cfg, hs), cache


# =========================================================================== #
# Ranks (a single device is one rank)
# =========================================================================== #


def _ranks(params, cfg, cache, mesh):
    """(per-rank params, per-rank caches, rank devices, rank configs): one
    rank on the params' device without ``mesh``."""
    _check_family(cfg)
    if mesh is None:
        return [params], [cache], [params["embed"].device], [cfg]
    ranks = P.tp_ranks(mesh)
    return params, cache, ranks, P.local_configs(cfg, len(ranks))


def _heads(cfg, lcfgs):
    """Each rank's (first query head, group size) for the attention
    kernels' segments (``launch.partition.rank_heads``), None on one
    device."""
    return None if len(lcfgs) == 1 else P.rank_heads(cfg, len(lcfgs))


def _all_reduce(parts: List[torch.Tensor]) -> List[torch.Tensor]:
    """Sum the ranks' partials in rank order on rank 0's device; returns a
    copy of the sum on every rank's device (ranks on one device share it),
    so the sum is the same on every rank and in every run.  Records one
    all-reduce, and when the sum is differentiated one more for the
    gradient its copies gather (module docstring)."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    if len(parts) > 1:
        collective("all-reduce", total.nbytes)
        if total.requires_grad:
            total.register_hook(
                lambda g: collective("all-reduce", g.nbytes))
    return [total.to(p.device) for p in parts]


def _add_sum(hs: List[torch.Tensor], parts: List[torch.Tensor]):
    """The residual stream plus the sum of the ranks' partials."""
    if len(parts) == 1:
        return [hs[0] + parts[0]]
    return [h + s for h, s in ranked(zip(hs, _all_reduce(parts)))]


def _rank_cos_sins(cfg, pos: torch.Tensor, ranks):
    """Every rank's rotary cos/sin of the prompt positions ``pos`` ((B, S),
    or (3, B, S) for M-RoPE), replicated as the reference's
    ``batch_pspecs`` replicates them: each rank rotates its heads by the
    same angles."""
    return [L.positional_cos_sin(cfg, pos.to(d)) for d in ranks]


def _embed_batch(shards: List[Params], cfg, batch: Dict, ranks):
    """Every rank's embedded prompt batch and the positions ((B, S), or
    the vlm's (3, B, S) when given): the tokens (:func:`_embed`), the
    vlm's stub ``embeds`` prepended, the learned positions added."""
    hs = _embed(shards, cfg, batch["tokens"], ranks)
    embeds = batch.get("embeds")
    if cfg.frontend == "vision_stub" and embeds is not None:
        hs = [torch.cat([embeds.to(h.device, h.dtype), h], 1) for h in hs]
    b, s = hs[0].shape[:2]
    pos = batch.get("positions")
    if pos is None:
        pos = torch.arange(s, device=ranks[0])[None, :].expand(b, s)
    if cfg.rope_type == "learned":
        hs = [h + learned_positions(p, cfg, pos.to(h.device))
              for p, h in ranked(zip(shards, hs))]
    return hs, pos


def _embed(shards: List[Params], cfg, tokens: torch.Tensor, ranks):
    """The embedded tokens on every rank, ids clamped to [0, vocab - 1] as
    :func:`embed_tokens` does.  Over several ranks the lookup is
    vocab-parallel: each rank looks up the ids in its vocab range
    (``launch.partition.vocab_range``, unequal where the ranks do not
    divide the vocab; zeros elsewhere), and the ranks sum."""
    if len(shards) == 1:
        return [embed_tokens(shards[0], cfg, tokens.to(ranks[0]))]
    parts = []
    for r, (p, d) in ranked(enumerate(zip(shards, ranks))):
        lo, hi = P.vocab_range(cfg, len(shards), r)
        ids = tokens.to(d).long().clamp(0, cfg.vocab_size - 1) - lo
        own = (ids >= 0) & (ids < hi - lo)
        e = p["embed"][ids.clamp(0, hi - lo - 1)]
        parts.append(torch.where(own[..., None], e, torch.zeros_like(e)))
    return _all_reduce(parts)


def _unembed(shards: List[Params], cfg, hs: List[torch.Tensor]):
    """Final norm and logits; over several ranks each rank's vocab range
    (unequal where the ranks do not divide the vocab), concatenated in
    rank order on rank 0's device."""
    outs = [unembed(p, cfg, h) for p, h in ranked(zip(shards, hs))]
    if len(outs) == 1:
        return outs[0]
    logits = torch.cat([o.to(outs[0].device) for o in outs], dim=-1)
    collective("all-gather", logits.nbytes)
    return logits


def _attn_prefill(cfg, lcfgs, lps: List[Params], hs: List[torch.Tensor],
                  cos_sins, caches, site: int, attn_impl: str,
                  moe_impl: str, mlp: bool = True,
                  aux: Optional[List] = None,
                  rows: Optional[int] = None) -> List[torch.Tensor]:
    """One attention layer's prefill on every rank (``lps[r]``, ``hs[r]``):
    attention, its K/V written into site ``site`` of each rank's cache
    (none when ``caches`` is None), then the MLP unless ``mlp`` is False
    (``aux``, ``rows``: :func:`_mlp`'s).  Returns the residual stream."""
    parts, ks, vs = [], [], []
    heads = _heads(cfg, lcfgs) or [None]
    for lp, lc, h, cs, hd in ranked(zip(lps, lcfgs, hs, cos_sins, heads)):
        out, (k, v) = L.attention_block(
            lp["attn"], lc, L.apply_norm(cfg, lp["attn_norm"], h), cs,
            attn_impl=attn_impl, heads=hd)
        parts.append(out)
        ks.append(k)
        vs.append(v)
    if caches is not None:
        _write_prompts([c["kv"] for c in caches], site, ks, vs,
                       kv_split.kv_ranges(lcfgs, _heads(cfg, lcfgs) or [None]))
    hs = _add_sum(hs, parts)
    return _mlp(cfg, lcfgs, lps, hs, moe_impl, aux, rows) if mlp else hs


def _attn_decode(cfg, lcfgs, lps: List[Params], hs: List[torch.Tensor],
                 cos_sins, caches, site: int, curs, acts, attn_impl: str,
                 moe_impl: str, mlp: bool = True,
                 valid_lens=None) -> List[torch.Tensor]:
    """One attention layer's decode step (or, with ``valid_lens``, one
    prefill chunk) on every rank over site ``site`` of the caches, then
    the MLP unless ``mlp`` is False.  Returns the residual stream."""
    kvs = [c["kv"].layer(site) for c in caches]
    fn = kv_split.attention_decode if kv_split.split(kvs[0]) else \
        L.attention_decode
    parts = fn(
        [lp["attn"] for lp in lps], lcfgs,
        [L.apply_norm(cfg, lp["attn_norm"], h)
         for lp, h in ranked(zip(lps, hs))],
        cos_sins, kvs, curs,
        attn_impl=attn_impl, actives=acts, valid_lens=valid_lens,
        heads=_heads(cfg, lcfgs))
    hs = _add_sum(hs, parts)
    return _mlp(cfg, lcfgs, lps, hs, moe_impl) if mlp else hs


def _cross_mlp(cfg, lcfgs, lps: List[Params], hs: List[torch.Tensor],
               crosses, moe_impl: str,
               rows: Optional[int] = None) -> List[torch.Tensor]:
    """An audio decoder layer after its self-attention, on every rank:
    cross-attention of each rank's query heads over its encoder K/V
    ``crosses[r]`` (``ck``, ``cv``, or one layer of its ``cross_kv``: a
    split one read by ``kv_split.cross_attention``), the ranks' ``wo``
    partials summed before the MLP, then the MLP (``rows``: :func:`_mlp`'s).
    Returns the residual streams."""
    xs = [L.apply_norm(cfg, lp["cross_norm"], h)
          for lp, h in ranked(zip(lps, hs))]
    if isinstance(crosses[0], KVCache) and kv_split.split(crosses[0]):
        parts = kv_split.cross_attention([lp["cross"] for lp in lps], lcfgs,
                                         xs, crosses)
    else:
        parts = [L.cross_attention_block(
            lp["cross"], lc, x, (kv.k, kv.v) if isinstance(kv, KVCache)
            else kv) for lp, lc, x, kv in ranked(zip(lps, lcfgs, xs,
                                                      crosses))]
    hs = _add_sum(hs, parts)
    return _mlp(cfg, lcfgs, lps, hs, moe_impl, rows=rows)


def _mlp(cfg, lcfgs, lps: List[Params], hs: List[torch.Tensor],
         moe_impl: str, aux: Optional[List] = None,
         rows: Optional[int] = None):
    """The residual stream after each rank's (column/row-parallel) MLP,
    or after each rank's MoE block, whose aux loss is appended to ``aux``
    when it is a list (else dropped).  ``rows``: a dense MLP over more
    rows of (B * S) than that runs chunk by chunk (:func:`_in_rows`), each
    rank's whole partial built before the ranks' one sum
    (:data:`PREFILL_MLP_ROWS`); None runs it in one piece, as does the
    MoE block always."""
    if cfg.moe.enabled:
        kw = {} if aux is None else {"aux_out": aux}
        return _add_sum(hs, M.moe_partials(
            [lp["moe"] for lp in lps], lcfgs[0],
            [L.apply_norm(cfg, lp["mlp_norm"], h)
             for lp, h in ranked(zip(lps, hs))],
            impl=moe_impl, **kw))

    def partial(lp, lc, x):
        return L.mlp_block(lp["mlp"], lc, L.apply_norm(cfg, lp["mlp_norm"], x))

    chunked = rows is not None and hs[0].numel() > rows * hs[0].shape[-1]
    return _add_sum(hs, [
        _in_rows(functools.partial(partial, lp, lc), h, rows) if chunked
        else partial(lp, lc, h) for lp, lc, h in ranked(zip(lps, lcfgs, hs))])


def _in_rows(fn, x: torch.Tensor, rows: int) -> torch.Tensor:
    """``fn`` (d -> d, acting on each row alone) of ``x`` (..., d), run
    over chunks of at most ``rows`` rows of its flattened leading axes
    into one buffer: only one chunk's transients are alive at a time."""
    flat = x.reshape(-1, x.shape[-1])
    out = torch.empty_like(flat)
    for a in range(0, flat.shape[0], rows):
        out[a:a + rows] = fn(flat[a:a + rows])
    return out.view_as(x)
