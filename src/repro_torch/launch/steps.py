"""Step functions (the port of ``repro.launch.steps``), runnable on the
card:

  train_step(params, opt_state, batch) -> (params, opt_state, metrics)
  prefill_step(params, batch_with_cache) -> (logits, cache)
  serve_step(params, tokens, cache) -> (next_token, cache)   # ONE new token

They take the caches of :func:`repro_torch.launch.shapes.input_specs`,
int8 and ring caches included, and update them in place (the reference
returns new ones).  ``attn_impl="kernel"`` runs the hand-written kernels
(prefill through ``flash_attention``, decode over an int8 linear cache
through ``flash_decode_int8``, over a dense one through
``flash_decode``); ``"torch"`` the plain path.  ``moe_impl`` picks the MoE
block of both steps, ``"dense"`` by default as in the reference (the
engine's decode runs ``"grouped"``).  The prefill step hands every input
of its batch but the cache to ``transformer.prefill``: the vlm family's
``embeds`` and ``positions`` and the audio family's ``frames`` too.

With ``mesh`` (a ``("model",)`` mesh: one tensor-parallel pod of any
family) ``params`` is the list of rank trees of
``launch.partition.shard_params`` and the cache the list of per-rank
caches of ``transformer.init_cache(..., mesh=mesh)``, bf16 or int8; the
batch's inputs are replicated to every rank, the decode read is one
``flash_decode_sharded`` (or ``flash_decode_int8_sharded``) call a
layer, and the outputs lie on rank 0's device.

A mesh with data axes beside "model" (``("data", "model")`` or
``("pod", "data", "model")``) is cut into pods by
``launch.mesh.pod_meshes``; ``params`` is then one list of rank trees a
pod (:func:`shard_pods`) and a cache one list of rank caches a pod
(:func:`init_pod_caches`).  The batch rows are split over the pods as
``batch_pspecs`` under ``batch_axes(mesh)`` says, contiguous and in pod
order, or every pod takes every row where ``sanitize_specs`` replicates
a batch the pods do not divide (:func:`pod_rows`); the outputs come back
in batch order on the first pod's rank 0.

The training step takes ``loss_fn`` and its gradients by autograd, then
one :func:`repro_torch.training.adamw_update`, and returns new trees, as
the reference does; its third value is the step's metrics (``loss``,
``ce``, ``aux``, ``grad_norm``, ``lr``) where the reference returns the
loss alone.  It runs the plain attention by default (the reference's
``"xla"``): the kernels have no backward, and their wrappers raise under
grad.  With ``mesh`` it is ZeRO-1 (:func:`make_train_step`).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch.launch import partition as PT
from repro_torch.launch.mesh import batch_axes, collective, pod_meshes
from repro_torch.models import transformer as T
from repro_torch.models.objective import loss_fn
from repro_torch.ranks import on_rank, ranked
from repro_torch.training import loop
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_leaf, clip_by_global_norm,
                                            schedule_lr)
from repro_torch.training.tree import leaves, tree_map, unflatten

DRYRUN_OPT = AdamWConfig(lr=3e-4, schedule="cosine", warmup_steps=100,
                         total_steps=10_000)


def make_train_step(cfg, *, remat: bool = True, moe_impl: str = "dense",
                    opt_cfg: AdamWConfig = DRYRUN_OPT,
                    attn_impl: str = "torch", mesh=None,
                    data_index: Optional[int] = None,
                    params_data_sharded: bool = False):
    """One AdamW step on ``loss_fn(params, cfg, batch)``: ``train_step(
    params, opt_state, batch) -> (params, opt_state, metrics)``; the batch
    goes to the parameters' device.  A leaf the loss does not reach gets
    a zero gradient, as the reference's does (so a path cut by a detached
    output would also read zero: hold the gradients against a reference,
    not only the loss).

    With ``mesh`` the step is ZeRO-1, as the reference's dry run lays it
    out: ``params`` as :func:`shard_pods` gives them (TP-only, the same in
    every pod), ``opt_state`` from :func:`zero1_init`.  Each pod takes its
    rows of the batch (:func:`pod_rows`) and the gradients of its ranks
    by autograd through ``loss_fn(mesh=pod)``; they are gathered into the
    whole tree (``partition.gather_shards``, the pieces ranks share
    summed) and summed over the pods, each pod's loss weighted by its
    share of the batch's labelled tokens, so the sum is the gradient of
    the whole batch's loss (the MoE aux loss excepted: each pod takes its
    own tokens' aux, as data-parallel trainers do, where the reference's
    one program takes the whole batch's).  The clip norm is that sum's.
    Then each data index updates its slice of every rank's leaf and of
    its AdamW moments along the dimension ``opt_pspecs`` gives the data
    axes (the whole leaf where the data degree divides no free
    dimension), and the slices are gathered back into every pod.
    Returns the new params in the same layout.

    ``data_index`` (the dry run's program, on the meta device) runs one
    data index alone: the batch is its rows, its pod's gradients stand
    for the sum, it updates its own slices, and the gather joins copies
    of them, so the shapes, flops, bytes and collectives are its pod's;
    ``params`` and the state's moments may then hold that pod alone.

    ``params_data_sharded`` (ZeRO-3, the reference's ``opt_pspecs``
    applied to the parameters themselves): ``params`` are
    :func:`zero3_shard`'s, each data index holding its ZeRO-1 slice of
    every rank's leaf.  The step all-gathers them into the pods' rank
    trees (:func:`zero3_gather`), takes the gradients and their
    reduce-scatter as ZeRO-1 does, and returns each data index's
    updated slices, which it does not gather back."""
    def loss(params, batch, pod=None):
        return loss_fn(params, cfg, batch, attn_impl=attn_impl,
                       moe_impl=moe_impl, remat=remat, mesh=pod)

    if mesh is None:
        return loop.make_train_step(loss, opt_cfg)
    pods, nested = _pod_list(mesh)
    dims: List = []

    def train_step(params, opt_state: AdamWState, batch: Dict):
        pparams = params if nested else [params]
        if params_data_sharded:
            pparams = zero3_gather(pparams, cfg, mesh)
        mus, nus = ((opt_state.mu, opt_state.nu) if nested
                    else ([opt_state.mu], [opt_state.nu]))
        if data_index is None:
            rows = pod_rows(mesh, batch["tokens"].shape[0])
            which = range(len(pods))
        else:  # the batch is that data index's rows
            rows, which = [slice(None)] * len(pods), [data_index]
        if rows[0] != rows[-1]:
            counts = [_labelled(_take(batch, r)) for r in rows]
            weights = [c / sum(counts) for c in counts]
        else:
            weights = [1.0 / len(rows)] * len(rows)
        if data_index is not None:
            weights = [1.0] * len(rows)
        grads, metrics = None, []
        for i in which:
            g, m = _pod_grads(loss, cfg, pods[i], pparams[i],
                              _take(batch, rows[i]), weights[i])
            grads = g if grads is None else tree_map(
                lambda a, b: a + b.to(a.device), grads, g)
            metrics.append((m, weights[i]))
        if len(pods) > 1:  # ZeRO-1's gradient sum: one device's slice
            tp = len(pparams[which[0]])
            for names, leaf in _named_leaves(grads):
                collective("reduce-scatter", leaf.nbytes / len(pods) / (
                    1 if PT.replicated(names, leaf) else tp))
        grads, gnorm = clip_by_global_norm(grads, opt_cfg.clip_norm)
        step = opt_state.step + 1
        lr = schedule_lr(opt_cfg, step)
        scheme = PT.shard_scheme(pparams[which[0]], cfg)
        if not dims:
            dims.extend(_zero1_dims(cfg, mesh, grads, scheme))
        new_params, mu, nu = _zero1_update(cfg, opt_cfg, pods, pparams,
                                           grads, mus, nus, step, lr, dims,
                                           which, not params_data_sharded,
                                           scheme)
        out = {k: sum(m[k] * w for m, w in metrics)
               for k in ("loss", "ce", "aux")}
        out.update(grad_norm=gnorm, lr=lr)
        state = AdamWState(step=step, mu=mu if nested else mu[0],
                           nu=nu if nested else nu[0])
        return (new_params if nested else new_params[0]), state, out

    return train_step


def _pod_list(mesh):
    """(the ``("model",)`` pods of ``mesh``, whether params are one list a
    pod): a ``("model",)`` mesh is one pod whose params are its rank
    list."""
    if tuple(mesh.axis_names) == ("model",):
        return [mesh], False
    return pod_meshes(mesh), True


def shard_pods(params, cfg, mesh, *, moe_scheme: str = "tensor"):
    """``params`` laid out for ``mesh``: the rank trees of
    ``partition.shard_params`` (under ``moe_scheme``) for a ``("model",)``
    mesh, else one such list a pod (TP-only, the same in every pod, as the
    reference's ``param_pspecs`` replicates them over the data axes).  The
    steps read the scheme off the trees (``partition.shard_scheme``)."""
    pods, nested = _pod_list(mesh)
    out = [PT.shard_params(params, cfg, pod, moe_scheme=moe_scheme)
           for pod in pods]
    return out if nested else out[0]


def pod_rows(mesh, batch_size: int) -> List[slice]:
    """Each pod's batch rows: ``batch_pspecs`` puts the batch on
    ``batch_axes(mesh)``, contiguous equal slices in pod order, and where
    ``sanitize_specs`` replicates it (the pods do not divide the batch)
    every pod takes every row."""
    pods, _ = _pod_list(mesh)
    n = len(pods)
    if n == 1:
        return [slice(0, batch_size)]
    tok = {"tokens": torch.empty((batch_size, 1), device="meta")}
    spec = PT.sanitize_specs(
        mesh, PT.batch_pspecs(tok, batch_axes(mesh)), tok)["tokens"]
    if spec[0] is None:
        return [slice(0, batch_size)] * n
    per = batch_size // n
    return [slice(i * per, (i + 1) * per) for i in range(n)]


def _take(batch: Dict, rows: slice) -> Dict:
    """A batch's rows (``positions`` (3, B, S) on its second axis)."""
    return {k: (v[:, rows] if k == "positions" else v[rows])
            for k, v in batch.items()}


def _labelled(batch: Dict) -> int:
    """The labelled tokens of a training batch, as ``cross_entropy``
    counts them."""
    mask = batch["labels"] >= 0
    if "loss_mask" in batch:
        lm = batch["loss_mask"].to(torch.bool)
        mask = mask[:, mask.shape[1] - lm.shape[1]:] & lm
    return max(int(mask.sum()), 1)


def _pod_grads(loss, cfg, pod, ranks, batch, weight: float):
    """One pod's gradients of its ``weight``-ed loss, gathered into the
    whole tree on its rank 0 (the pieces ranks share summed, one
    all-reduce a replicated leaf), and its metrics."""
    flat = [[p.detach().requires_grad_(True) for p in leaves(r)]
            for r in ranks]
    total, inner = loss([unflatten(r, f) for r, f in zip(ranks, flat)],
                        batch, pod)
    every = [p for f in flat for p in f]
    with on_rank(None):  # the backward marks its nodes' ranks as it runs
        grads = torch.autograd.grad(total * weight, every,
                                    allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(every, grads))
    rank_grads = [unflatten(r, [next(it) for _ in f])
                  for r, f in zip(ranks, flat)]
    if len(ranks) > 1:
        for names, leaf in _named_leaves(rank_grads[0]):
            if PT.replicated(names, leaf):
                collective("all-reduce", leaf.nbytes)
    metrics = {"loss": total.detach(),
               **{k: v.detach() for k, v in inner.items()}}
    return PT.gather_shards(rank_grads, cfg, pod, add=True), metrics


def _named_leaves(tree, names=()):
    """(path, leaf) pairs in :func:`leaves`' order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], names + (k,))
    else:
        yield names, tree


def _zero1_dims(cfg, mesh, whole,
                moe_scheme: str = "tensor") -> List[Optional[int]]:
    """Each leaf's ZeRO-1 dimension (``partition.data_dim`` of
    ``opt_pspecs`` over ``param_pspecs`` under the rank trees'
    ``moe_scheme``), in :func:`leaves`' order.  The reference sanitizes
    the specs first, which frees a "model" dimension the axis does not
    divide for the data axes; the port splits every "model" dimension
    (the expert axis under the expert scheme too), unevenly where the
    axis does not divide it, so such a dimension stays the rank's and the
    moments take the next free one.  Where the axis divides every width
    the two agree."""
    abstract = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device="meta"), whole)
    pspec = PT.param_pspecs(cfg, abstract, moe_scheme=moe_scheme)
    mspec = PT.opt_pspecs(mesh, pspec, abstract)
    return [PT.data_dim(sp) for _, sp in _named_leaves(mspec)]


def zero1_init(params, cfg, mesh) -> AdamWState:
    """ZeRO-1 AdamW state of ``params`` as :func:`shard_pods` lays them
    out on ``mesh``: zero fp32 moments of each data index's slice of each
    rank's leaf (``opt_pspecs``' dimension; the whole leaf where the data
    degree divides no free dimension), one list of rank trees a pod (the
    rank list itself for a ``("model",)`` mesh)."""
    pods, nested = _pod_list(mesh)
    pparams = params if nested else [params]
    dims = _zero1_dims(cfg, mesh, PT.gather_shards(pparams[0], cfg, pods[0]),
                       PT.shard_scheme(pparams[0], cfg))
    n = len(pods)

    def moments():
        return [[unflatten(r, [torch.zeros(_slice_shape(p.shape, d, n),
                                           dtype=torch.float32,
                                           device=p.device)
                               for p, d in zip(leaves(r), dims)])
                 for r in ranks] for ranks in pparams]

    mu, nu = moments(), moments()
    step = torch.zeros((), dtype=torch.int32,
                       device=leaves(pparams[0][0])[0].device)
    return AdamWState(step=step, mu=mu if nested else mu[0],
                      nu=nu if nested else nu[0])


def zero3_shard(params, cfg, mesh):
    """``params`` as :func:`shard_pods` lays them out, cut for ZeRO-3:
    data index i keeps its slice of every rank's leaf along the leaf's
    ZeRO-1 dimension (the whole leaf where there is none), one list of
    rank trees a pod."""
    pods, nested = _pod_list(mesh)
    pparams = params if nested else [params]
    dims = _zero1_dims(cfg, mesh, T.abstract_params(cfg),
                       PT.shard_scheme(pparams[0], cfg))
    n = len(pods)
    out = [[unflatten(rank, [p[_cut(d, i, n, _size(p, d))].clone()
                             for p, d in zip(leaves(rank), dims)])
            for rank in ranks] for i, ranks in enumerate(pparams)]
    return out if nested else out[0]


def zero3_gather(slices, cfg, mesh):
    """The pods' rank trees from :func:`zero3_shard`'s slices: each rank
    leaf joined over the data indices along its ZeRO-1 dimension, one
    all-gather a rank leaf.  ``slices`` may hold the first data index
    alone (the dry run's program of one data index): copies of its
    slices then stand in for the others'."""
    pods, _ = _pod_list(mesh)
    n = len(pods)
    dims = _zero1_dims(cfg, mesh, T.abstract_params(cfg),
                       PT.shard_scheme(slices[0], cfg))
    out = []
    for i, ranks in enumerate(slices):
        trees = []
        for r, rank in ranked(enumerate(ranks)):
            own = [leaves(slices[j][r] if j < len(slices) else rank)
                   for j in range(n)]
            joined = []
            for k, (leaf, d) in enumerate(zip(leaves(rank), dims)):
                if d is None:
                    joined.append(leaf)
                    continue
                joined.append(torch.cat([o[k].to(leaf.device) for o in own],
                                        dim=d))
                if i == 0:
                    collective("all-gather", joined[-1].nbytes)
            trees.append(unflatten(rank, joined))
        out.append(trees)
    return out


def zero1_gather(moments, params, cfg, mesh):
    """One tree of ZeRO-1 moments laid out as :func:`zero1_init` lays them
    (``params`` as :func:`shard_pods` does) joined into the whole tree one
    device's AdamW state holds: each rank's slices joined over the data
    indices along their ZeRO-1 dimension, then the ranks gathered on the
    first pod's rank 0 (``partition.gather_shards``)."""
    pods, nested = _pod_list(mesh)
    per_pod = moments if nested else [moments]
    ranks = params[0] if nested else params
    dims = _zero1_dims(cfg, mesh, PT.gather_shards(ranks, cfg, pods[0]),
                       PT.shard_scheme(ranks, cfg))
    joined = []
    for r, rank in enumerate(ranks):
        own = [leaves(m[r]) for m in per_pod]
        joined.append(unflatten(rank, [
            own[0][k] if d is None else torch.cat(
                [o[k].to(own[0][k].device) for o in own], dim=d)
            for k, d in enumerate(dims)]))
    return PT.gather_shards(joined, cfg, pods[0])


def _slice_shape(shape, dim: Optional[int], n: int):
    shape = list(shape)
    if dim is not None:
        shape[dim] //= n
    return tuple(shape)


def _cut(dim: Optional[int], i: int, n: int, size: int):
    """The index of data index ``i``'s slice along ``dim`` (all of it when
    ``dim`` is None)."""
    if dim is None:
        return (slice(None),)
    per = size // n
    return (slice(None),) * dim + (slice(i * per, (i + 1) * per),)


def _zero1_update(cfg, opt_cfg, pods, pparams, grads, mus, nus, step, lr,
                  dims, which, gather: bool = True,
                  moe_scheme: str = "tensor"):
    """The data indices ``which`` update their slices of every rank's
    leaves and moments (the gradients laid out as the params, under
    ``moe_scheme``); the slices are then gathered back into every pod
    (one all-gather a rank leaf when there are several pods), or with
    ``gather`` False (ZeRO-3) kept as each data index's params.  Returns
    (params, mu, nu) in the pods' layout."""
    n = len(pods)
    slices, new_mu, new_nu = {}, list(mus), list(nus)
    for i in which:
        rank_grads = PT.shard_params(grads, cfg, pods[i],
                                     moe_scheme=moe_scheme)
        pm, pn = [], []
        for r, rank in ranked(enumerate(pparams[i])):
            upd = [adamw_leaf(opt_cfg, step, lr, p[_cut(d, i, n, _size(p, d))],
                              g[_cut(d, i, n, _size(g, d))], m, v)
                   for p, g, m, v, d in zip(leaves(rank),
                                            leaves(rank_grads[r]),
                                            leaves(mus[i][r]),
                                            leaves(nus[i][r]), dims)]
            slices[i, r] = [u[0] for u in upd]
            pm.append(unflatten(rank, [u[1] for u in upd]))
            pn.append(unflatten(rank, [u[2] for u in upd]))
        new_mu[i], new_nu[i] = pm, pn
    if not gather:
        return ([[unflatten(rank, slices[i, r])
                  for r, rank in enumerate(ranks)]
                 for i, ranks in enumerate(pparams) if i in which],
                new_mu, new_nu)
    out = []
    for i, ranks in enumerate(pparams):
        trees = []
        for r, rank in ranked(enumerate(ranks)):
            own = [slices.get((j, r), slices[which[0], r]) for j in range(n)]
            joined = []
            for k, (p, d) in enumerate(zip(leaves(rank), dims)):
                if d is None:
                    joined.append(own[0][k].to(p.device))
                else:
                    joined.append(torch.cat([o[k].to(p.device) for o in own],
                                            dim=d))
                if n > 1 and i == which[0]:
                    collective("all-gather", p.nbytes)
            trees.append(unflatten(rank, joined))
        out.append(trees)
    return out, new_mu, new_nu


def _size(t: torch.Tensor, dim: Optional[int]) -> int:
    return 0 if dim is None else t.shape[dim]


def make_prefill_step(cfg, *, attn_impl: str = "kernel",
                      moe_impl: str = "dense", mesh=None):
    """The prompt pass: ``prefill_step(params, batch_with_cache) ->
    (logits, cache)``, over any cache layout of ``init_pod_caches``."""
    def prefill_step(params, batch: Dict):
        batch = dict(batch)
        cache = batch.pop("cache")
        if mesh is None or not _pod_list(mesh)[1]:
            return T.prefill(params, cfg, batch, cache, attn_impl=attn_impl,
                             moe_impl=moe_impl, mesh=mesh)
        rows = pod_rows(mesh, batch["tokens"].shape[0])
        outs = [T.prefill(p, cfg, _take(batch, r), c, attn_impl=attn_impl,
                          moe_impl=moe_impl, mesh=pod)[0]
                for pod, p, c, r in zip(pod_meshes(mesh), params, cache,
                                        rows)]
        return _gather_rows(outs, rows), cache

    return prefill_step


def make_serve_step(cfg, *, attn_impl: str = "kernel",
                    moe_impl: str = "dense", mesh=None):
    """One-token decode; returns the greedy token (B,) int32, not the
    logits, so the step's output footprint matches a real serving system.

    The cache says the layout: one cache a pod of ``mesh`` runs each pod
    over its rows (:func:`pod_rows`); :func:`init_pod_caches`'
    context-parallel cache (the reference's for a decode whose global
    batch is under 16), one rank list whose ranks hold every row of the
    batch and each data index's range of the KV rows, runs the data
    indices in step.  Their projections and MLP are one computation over
    the replicated batch, so the step runs them once, on the first pod's
    ranks, and merges the data indices' attention over their rows layer
    by layer (``models.kv_split``); ``params`` are :func:`shard_pods`'
    and the token lies on the first pod's rank 0."""

    def one_pod(params, tokens, cache, pod):
        logits, cache = T.decode_step(params, cfg, tokens, cache,
                                      attn_impl=attn_impl, moe_impl=moe_impl,
                                      mesh=pod)
        return logits[:, -1, :].argmax(dim=-1).to(torch.int32), cache

    def serve_step(params, tokens: torch.Tensor, cache):
        if mesh is None or not _pod_list(mesh)[1]:
            return one_pod(params, tokens, cache, mesh)
        if isinstance(cache[0], dict):  # one rank list: context-parallel
            return one_pod(params[0], tokens, cache, pod_meshes(mesh)[0])
        rows = pod_rows(mesh, tokens.shape[0])
        outs = [one_pod(p, tokens[r], c, pod)[0]
                for pod, p, c, r in zip(pod_meshes(mesh), params, cache,
                                        rows)]
        return _gather_rows(outs, rows), cache

    return serve_step


def init_pod_caches(cfg, batch: int, max_len: int, mesh, *,
                    context_parallel: bool = False, **kw):
    """One ``transformer.init_cache(..., mesh=pod)`` a pod of ``mesh``, of
    the rows :func:`pod_rows` gives it (``kw``: ``dtype``, ``kv_dtype``,
    ``sliding_window``, ``kv_shard``); the rank list itself for a
    ``("model",)`` mesh.  ``context_parallel``: the context-parallel
    cache instead, one rank list over the first pod's ranks holding every
    row of the batch and the KV rows of all of the mesh's data indices
    (``transformer.init_cache(context=)``), which
    :func:`make_serve_step` runs in step."""
    pods, nested = _pod_list(mesh)
    if context_parallel:
        return T.init_cache(cfg, batch, max_len, mesh=pods[0],
                            context=(len(pods), range(len(pods))), **kw)
    out = [T.init_cache(cfg, len(range(batch)[r]), max_len, mesh=pod, **kw)
           for pod, r in zip(pods, pod_rows(mesh, batch))]
    return out if nested else out[0]


def _gather_rows(outs: List[torch.Tensor], rows: List[slice]):
    """The pods' outputs in batch order on the first pod's rank 0 (pod 0's
    alone when every pod took every row); one all-gather."""
    if rows[0] == rows[-1]:
        return outs[0]
    out = torch.cat([o.to(outs[0].device) for o in outs])
    collective("all-gather", out.nbytes)
    return out


def abstract_opt_state(abstract_params) -> AdamWState:
    """The AdamW state of ``abstract_params`` on the meta device: an int32
    step and fp32 moments shaped like the params (nothing allocated)."""
    def f32like():
        return tree_map(lambda leaf: torch.empty(
            tuple(leaf.shape), dtype=torch.float32, device="meta"),
            abstract_params)

    return AdamWState(step=torch.empty((), dtype=torch.int32, device="meta"),
                      mu=f32like(), nu=f32like())
