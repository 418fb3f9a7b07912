"""Mixture-of-Experts FFN (Mixtral / Qwen2-MoE style) in PyTorch: the port
of ``repro.models.moe``.

The reference has no Pallas kernel here: its expert sums are XLA einsums,
so the port's are PyTorch matmuls.  Two paths, as in the reference:
  * ``moe_block_dense`` — every expert computes every token, weighted by a
    ``(tokens, experts)`` combine matrix that is 0 for unrouted experts.
    Prefill runs it.
  * ``moe_block_grouped`` — each token gathers its top-k experts' weights
    and computes only those; cheaper on small decode batches.  Decode runs
    it.  Its shapes are static and it reads nothing back to the host, so a
    decode window stays free of host syncs.

What the reference's numerics hang on, kept here: the router product is
taken in x's dtype and then cast to fp32; the top k are chosen by a stable
descending sort, so equal probabilities put the lower expert index first,
as ``jax.lax.top_k`` does (bf16 logits over 60 experts tie often, and
``torch.topk`` promises no order); ``norm_topk_prob`` divides by the sum
clipped at 1e-9; ``combine`` is built in x's dtype, and the grouped path
casts the routing weights to the experts' output dtype before it sums over
k; the shared path (qwen2-moe) is gated by a sigmoid of x.

Tensor parallelism (:func:`moe_partials`): under the reference's
baseline "tensor" scheme (``launch.partition``) each rank holds a slice of
every expert's hidden axis and of the shared path's; under its "expert"
scheme each rank holds whole experts (``partition.expert_range``) and its
slice of the shared path's hidden axis.  Either way the router runs once
and its routing is copied to every rank, and each rank's output is a
partial that the model sums over the ranks.

Parameters (stacked over layers by :func:`init_moe`): ``router`` (d, E),
``w_gate`` / ``w_up`` (E, d, f), ``w_down`` (E, f, d), and with shared
experts ``shared.{w_gate, w_up, w_down, gate}``.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.launch import partition
from repro_torch.launch.mesh import collective
from repro_torch.models.layers import dense_init
from repro_torch.ranks import ranked

Params = Dict[str, torch.Tensor]
MOE_IMPLS = ("dense", "grouped")


def init_moe(gen: torch.Generator, cfg, n_layers: int,
             dtype=torch.float32) -> Params:
    """The reference's distributions, stacked over ``n_layers``: uniform
    router and shared weights (``dense_init``), expert weights uniform in
    +-1/sqrt(fan-in).  Every leaf is drawn one matrix at a time, so the
    fp32 transient is one (in, out) matrix (qwen2-moe's stacked experts
    are 8.3 GB a leaf in fp32)."""
    m, d = cfg.moe, cfg.d_model
    lead, e = (n_layers,), m.num_experts
    p: Params = {
        "router": dense_init(gen, d, e, dtype, lead=lead),
        "w_gate": dense_init(gen, d, m.expert_d_ff, dtype, lead=lead + (e,)),
        "w_up": dense_init(gen, d, m.expert_d_ff, dtype, lead=lead + (e,)),
        "w_down": dense_init(gen, m.expert_d_ff, d, dtype, lead=lead + (e,)),
    }
    if m.num_shared_experts:
        p["shared"] = {
            "w_gate": dense_init(gen, d, m.shared_d_ff, dtype, lead=lead),
            "w_up": dense_init(gen, d, m.shared_d_ff, dtype, lead=lead),
            "w_down": dense_init(gen, m.shared_d_ff, d, dtype, lead=lead),
            # qwen2-moe gates the shared path with a sigmoid scalar gate
            "gate": dense_init(gen, d, 1, dtype, lead=lead),
        }
    return p


def top_k(probs: torch.Tensor, k: int):
    """The k largest entries of each row and their indices, largest first;
    equal values keep ascending index order, as ``jax.lax.top_k``."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def router_probs(p: Params, cfg, x: torch.Tensor):
    """x (T, d) -> (probs (T, E), topk_weights (T, K), topk_idx (T, K))."""
    m = cfg.moe
    logits = (x @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    topk_w, topk_i = top_k(probs, m.top_k)
    if m.norm_topk_prob:
        topk_w = topk_w / torch.clamp(topk_w.sum(-1, keepdim=True), min=1e-9)
    return probs, topk_w, topk_i


def load_balance_loss(probs: torch.Tensor, topk_i: torch.Tensor,
                      num_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * P_e (counts by
    ``index_add_``: no host sync)."""
    t = probs.shape[0]
    flat = topk_i.reshape(-1)
    counts = torch.zeros((num_experts,), dtype=torch.float32,
                         device=probs.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32,
                            device=probs.device))
    frac_tokens = counts / max(t * topk_i.shape[-1], 1)
    frac_probs = probs.mean(dim=0)
    return num_experts * torch.sum(frac_tokens * frac_probs)


class Routing(NamedTuple):
    """One routing of T tokens: the router's ``probs`` (T, E) and
    ``topk_w`` (T, K) in fp32, ``topk_i`` (T, K), and for the dense path
    ``combine`` (T, E) in x's dtype (None for the grouped path)."""

    probs: torch.Tensor
    topk_w: torch.Tensor
    topk_i: torch.Tensor
    combine: Optional[torch.Tensor] = None

    def to(self, device) -> "Routing":
        return Routing(*(None if t is None else t.to(device) for t in self))


def route(p: Params, cfg, xt: torch.Tensor, *, dense: bool) -> Routing:
    """Route the tokens xt (T, d): :func:`router_probs`, and with ``dense``
    the combine matrix (combine[t, e] = routing weight of expert e for
    token t, 0 if unrouted), built in x's dtype."""
    probs, topk_w, topk_i = router_probs(p, cfg, xt)
    combine = None
    if dense:
        combine = torch.zeros((xt.shape[0], cfg.moe.num_experts),
                              dtype=xt.dtype, device=xt.device).scatter_(
            1, topk_i, topk_w.to(xt.dtype))
    return Routing(probs, topk_w, topk_i, combine)


def _shared(p: Params, x: torch.Tensor) -> torch.Tensor:
    """The shared-expert path, gated by sigmoid(x @ gate).  Over a shard of
    its hidden axis it is the shard's partial: the gate multiplies a sum
    of partials, so the ranks' gated partials sum to the whole."""
    sp = p["shared"]
    sh = (F.silu(x @ sp["w_gate"]) * (x @ sp["w_up"])) @ sp["w_down"]
    return torch.sigmoid(x @ sp["gate"]) * sh


def _dense_experts(p: Params, xt: torch.Tensor,
                   combine: torch.Tensor) -> torch.Tensor:
    """Every expert on every token, weighted by ``combine``: xt (T, d) ->
    (T, d).  The expert products are batched over experts (E, T, f); the
    down projection contracts experts and hidden dims in one product, as
    the reference's ``einsum("tef,efd,te->td")``."""
    e, d = p["w_gate"].shape[0], xt.shape[1]
    xe = xt.expand(e, xt.shape[0], d)
    h = F.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    h = h * combine.T[:, :, None]                       # (E, T, f)
    e, t, f = h.shape
    return h.transpose(0, 1).reshape(t, e * f) @ p["w_down"].reshape(e * f, d)


def _grouped_experts(p: Params, xt: torch.Tensor, topk_w: torch.Tensor,
                     topk_i: torch.Tensor) -> torch.Tensor:
    """Each token's K experts only: their weights are gathered (advanced
    indexing: static shapes, no host sync), as the reference's per-token
    ``vmap``.  xt (T, d) -> (T, d)."""
    t, k = topk_i.shape
    idx = topk_i.reshape(-1)

    def gather(w):
        return w[idx].reshape((t, k) + w.shape[1:])

    xv = xt[:, None, None, :]                           # (T, 1, 1, d)
    h = (F.silu(torch.matmul(xv, gather(p["w_gate"])))
         * torch.matmul(xv, gather(p["w_up"])))        # (T, K, 1, f)
    y = torch.matmul(h, gather(p["w_down"]))[:, :, 0]  # (T, K, d)
    return torch.sum(y * topk_w[:, :, None].to(y.dtype), dim=1)


def _own_experts(routing: Routing, e0: int, e1: int) -> Routing:
    """``routing`` restricted to the experts ``[e0, e1)`` a rank holds,
    indexed from ``e0``: the combine matrix's columns of those experts, or
    the top-k slots whose expert lies there, every other slot pointing at
    the rank's first expert with weight 0 (a rank gathers no other rank's
    weights).  A rank with no expert keeps no column and no slot weight."""
    if routing.combine is not None:
        return routing._replace(combine=routing.combine[:, e0:e1])
    local = routing.topk_i - e0
    own = (local >= 0) & (local < e1 - e0)
    return routing._replace(
        topk_w=torch.where(own, routing.topk_w,
                           torch.zeros_like(routing.topk_w)),
        topk_i=torch.where(own, local, torch.zeros_like(local)))


def _routed(p: Params, x: torch.Tensor, routing: Routing) -> torch.Tensor:
    """The expert sum under ``routing`` (the dense path when it carries a
    ``combine``), plus the shared path's: x (B, S, d) -> (B, S, d), over
    ``p``'s slice of the hidden axes or its experts (a rank's partial when
    ``p`` is a shard; no expert term for a rank that holds none)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    if p["w_gate"].shape[0] == 0:  # a rank that holds no expert
        out = xt.new_zeros(xt.shape)
    elif routing.combine is not None:
        out = _dense_experts(p, xt, routing.combine)
    else:
        out = _grouped_experts(p, xt, routing.topk_w, routing.topk_i)
    out = out.reshape(b, s, d)
    if "shared" in p:
        out = out + _shared(p, x)
    return out


def moe_block_dense(p: Params, cfg, x: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense-dispatch MoE.  x (B, S, d) -> (out, aux_loss)."""
    routing = route(p, cfg, x.reshape(-1, x.shape[-1]), dense=True)
    aux = load_balance_loss(routing.probs, routing.topk_i,
                            cfg.moe.num_experts)
    return _routed(p, x, routing), aux


def moe_block_grouped(p: Params, cfg, x: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather-based top-k MoE for small batches (the decode path); the same
    function as the dense path."""
    routing = route(p, cfg, x.reshape(-1, x.shape[-1]), dense=False)
    aux = load_balance_loss(routing.probs, routing.topk_i,
                            cfg.moe.num_experts)
    return _routed(p, x, routing), aux


def moe_partials(ps: Sequence[Params], cfg, xs: Sequence[torch.Tensor], *,
                 impl: str = "dense",
                 aux_out: Optional[List] = None) -> List[torch.Tensor]:
    """The MoE block on every tensor-parallel rank (a single device is one
    rank), its aux loss dropped: rank r's output (``ps[r]``, ``xs[r]``;
    every rank holds the same x), a partial that the ranks sum.  A rank
    that holds every expert (the "tensor" scheme) computes them over its
    slice of the hidden axes; a rank that holds fewer (the "expert"
    scheme, :func:`_held_experts`) computes its whole experts only: the
    dense path the combine matrix's columns of its experts, the grouped
    path the top-k slots whose expert it holds, every other slot weighing
    0.  The router runs once, on rank 0's copy of x, and every rank gets that routing on its
    device: the ranks must add partials of the same experts, and two
    routers could order a near-tie differently (bf16 probabilities over 60
    experts tie often); over several ranks that send is recorded as one
    collective-permute.  With ``aux_out`` (a list) the routing's
    load-balance loss is appended to it, on rank 0's device."""
    _check_impl(impl)
    x0 = xs[0]
    routing = route(ps[0], cfg, x0.reshape(-1, x0.shape[-1]),
                    dense=impl == "dense")
    if aux_out is not None:
        aux_out.append(load_balance_loss(routing.probs, routing.topk_i,
                                         cfg.moe.num_experts))
    if len(ps) > 1:
        collective("collective-permute",
                   sum(t.nbytes for t in routing if t is not None))
    outs = []
    for r, (p, x) in ranked(enumerate(zip(ps, xs))):
        mine = routing.to(x.device)
        held = _held_experts(p, cfg, len(ps), r)
        if held is not None:
            mine = _own_experts(mine, *held)
        outs.append(_routed(p, x, mine))
    return outs


def _held_experts(p: Params, cfg, tp: int, rank: int):
    """None where rank ``rank``'s shard ``p`` holds every routed expert
    (one device, or the "tensor" scheme), else the experts ``[e0, e1)``
    it holds whole (the "expert" scheme, :func:`rank_experts`); raises
    ``ValueError`` where the shard's count is not that range's."""
    n = p["w_gate"].shape[0]
    if n == cfg.moe.num_experts:
        return None
    e0, e1 = rank_experts(cfg, tp, rank)
    if n != e1 - e0:
        raise ValueError(f"rank {rank} of {tp} holds {n} of "
                         f"{cfg.moe.num_experts} experts, not the "
                         f"{e1 - e0} of partition.expert_range")
    return e0, e1


def rank_experts(cfg, tp: int, rank: int):
    """The experts ``[e0, e1)`` whose routing rank ``rank`` of ``tp``
    computes under the expert scheme: the ones it holds
    (``partition.expert_range``).  Apart from the layout so that a check
    can shift what a rank computes and not what it holds
    (``chip_smoke.py``'s planted expert range)."""
    return partition.expert_range(cfg, tp, rank)


def _check_impl(impl: str) -> None:
    if impl not in MOE_IMPLS:
        raise ValueError(f"moe impl must be one of {MOE_IMPLS}, got "
                         f"{impl!r}")


def moe_block(p: Params, cfg, x: torch.Tensor, *, impl: str = "dense"):
    _check_impl(impl)
    if impl == "grouped":
        return moe_block_grouped(p, cfg, x)
    return moe_block_dense(p, cfg, x)
