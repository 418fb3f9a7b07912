"""Mamba2 (State Space Duality) block in PyTorch: the port of
``repro.models.ssm``.

Block structure (Mamba2):
    u -> in_proj -> [z | x | B | C | dt]
    (x,B,C) -> causal depthwise conv1d -> silu
    y = SSD(x * dt, dt * A, B, C) + D * x
    out = out_proj( RMSNorm(y) * silu(z) )    # gated norm

The full-sequence SSD runs through the hand-written scan kernel
(``impl="kernel"``, :func:`repro_torch.kernels.ops.ssd_scan`, its plain
version on CPU tensors) or through the chunked einsum form
(``impl="torch"``, :func:`ssd_chunked`, the reference's ``"xla"`` path).
Decode is the per-token recurrence in plain PyTorch, as in the reference.
Every dtype cast of the reference is kept: ``dt`` and ``A`` in fp32, the
state in the model dtype.

State for decode:
    conv: (B, conv_ch, d_conv - 1)   last raw conv inputs
    ssm:  (B, n_heads, head_dim, d_state)

Tensor parallelism (:func:`ssm_partials`, :func:`ssm_decode_partials`):
each rank holds the leaves of a contiguous range of whole SSM heads, the
first ranks one head more where the ranks do not divide the heads
(``launch.partition``: its z, x and dt columns of ``in_proj``, B and C
whole with one group, its heads' ``A_log`` / ``dt_bias`` / ``D`` /
``norm`` rows and ``out_proj``'s rows) and its heads' state, and scans
its own heads (``conv_ch`` and ``n_heads`` above are then the rank's).
The gated norm's mean spans the whole inner width, so the ranks' sums of
squares are summed before any rank normalises (:func:`gated_partials`),
and each rank returns its partial of ``out_proj``, which the model sums
in rank order.  One device is one rank: the whole block, its norm the
reference's mean.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.launch.mesh import collective
from repro_torch.launch.partition import SSMWidths, ssm_widths
from repro_torch.models.layers import ATTN_IMPLS, dense_init, rng
from repro_torch.ranks import ranked

Params = Dict[str, torch.Tensor]


def conv_channels(cfg, tp: int = 1, rank: int = 0) -> int:
    """Conv channels ``[x | B | C]`` of rank ``rank`` of ``tp``."""
    w = ssm_widths(cfg, tp, rank)
    return w.d_inner + 2 * w.n_groups * cfg.ssm.d_state


def init_ssm(gen: torch.Generator, cfg, n_layers: int,
             dtype=torch.float32) -> Params:
    """The reference's distributions, stacked over ``n_layers``: uniform
    projections, N(0, 0.1) conv weights, zero conv bias, ``A_log =
    log(U(a_init_range))``, zero ``dt_bias``, unit ``D`` and norm scale.
    ``A_log``, ``dt_bias`` and ``D`` are fp32 whatever ``dtype`` is, as in
    the reference."""
    s, d, di, nh = cfg.ssm, cfg.d_model, cfg.ssm_d_inner, cfg.ssm_n_heads
    dev, lead = gen.device, (n_layers,)
    proj_out = 2 * di + 2 * s.n_groups * s.d_state + nh  # z, x, B, C, dt
    lo, hi = s.a_init_range
    a = torch.rand(lead + (nh,), generator=rng(gen), device=dev) * (hi - lo) + lo
    conv_w = torch.randn(lead + (conv_channels(cfg), s.d_conv), generator=rng(gen),
                         device=dev) * 0.1
    return {
        "in_proj": dense_init(gen, d, proj_out, dtype, lead=lead),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros(lead + (conv_channels(cfg),), dtype=dtype,
                              device=dev),
        "A_log": torch.log(a),
        "dt_bias": torch.zeros(lead + (nh,), dtype=torch.float32, device=dev),
        "D": torch.ones(lead + (nh,), dtype=torch.float32, device=dev),
        "norm": torch.ones(lead + (di,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, di, d, dtype, lead=lead),
    }


# --------------------------------------------------------------------------- #
# SSD chunked scan (the plain path)
# --------------------------------------------------------------------------- #


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., c) -> (..., c, c) with out[t, s] = sum_{s < r <= t} a[r]
    (lower-triangular; -inf above the diagonal)."""
    c = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    out = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=a.device))
    return out.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,H,P) already multiplied by dt, a (B,S,H) log decay per step,
    Bm/Cm (B,S,H,N), ``S % chunk == 0``.  Returns (y (B,S,H,P), final state
    (B,H,P,N)); the inter-chunk carry is the reference's vectorised
    (nc+1)^2 decay matrix, not a sequential scan."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    if s % chunk:
        raise ValueError(f"S={s} is not a multiple of chunk={chunk}")
    nc = s // chunk

    def tochunk(t):
        return t.reshape(b, nc, chunk, *t.shape[2:])

    xc, ac, bc, cc = map(tochunk, (x, a, Bm, Cm))
    ac = ac.movedim(-1, 2)  # (B, nc, H, c)
    a_cum = torch.cumsum(ac, dim=-1)  # (B, nc, H, c)

    # intra-chunk (diagonal) term
    L = torch.exp(_segsum(ac))  # (B, nc, H, c, c)
    y_diag = torch.einsum("bzthn,bzshn,bzhts,bzshp->bzthp", cc, bc, L, xc)

    # states at the end of each chunk
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)  # (B, nc, H, c)
    states = torch.einsum("bzshn,bzhs,bzshp->bzhpn", bc, decay_states, xc)

    # inter-chunk carry from a zero initial state
    chunk_log_decay = a_cum[..., -1]  # (B, nc, H)
    cum = torch.cumsum(chunk_log_decay, dim=1)  # (B, nc, H)
    cum0 = F.pad(cum, (0, 0, 1, 0))  # (B, nc+1, H): cum before z
    expo = cum0[:, :, None, :] - cum0[:, None, 1:, :]  # (B, nc+1, nc, H)
    zi = torch.arange(nc + 1, device=x.device)[:, None]
    wi = torch.arange(nc, device=x.device)[None, :]
    valid = (wi < zi)[None, :, :, None]
    M = torch.where(valid, torch.exp(torch.where(valid, expo, 0.0)), 0.0)
    all_prev = torch.einsum("bzwh,bwhpn->bzhpn", M.to(states.dtype), states)
    # the zero initial state's term (exp(cum0) * 0) is left out
    prev_states = all_prev[:, :nc]  # state at the START of each chunk
    final_state = all_prev[:, nc]

    # inter-chunk (off-diagonal) contribution
    state_decay_out = torch.exp(a_cum)  # (B, nc, H, c)
    y_off = torch.einsum("bzthn,bzhpn,bzht->bzthp", cc, prev_states,
                         state_decay_out)
    y = (y_diag + y_off).reshape(b, s, h, p)
    return y, final_state


# --------------------------------------------------------------------------- #
# Block forward / decode
# --------------------------------------------------------------------------- #


def _rank_widths(cfg, tp: int) -> List[SSMWidths]:
    """Every rank's :func:`ssm_widths` (unequal where the ranks do not
    divide the heads)."""
    return [ssm_widths(cfg, tp, r) for r in range(tp)]


def _split_proj(cfg, w: SSMWidths, proj: torch.Tensor):
    gn = w.n_groups * cfg.ssm.d_state
    return torch.split(proj, [w.d_inner, w.d_inner, gn, gn, w.n_heads],
                       dim=-1)


def _causal_conv(p: Params, seq: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, CH): the reference's unrolled k-tap
    sum (out[t] = sum_j w[j] * x[t + j - (k - 1)]), not a cuDNN conv."""
    w = p["conv_w"]  # (CH, K)
    k = w.shape[-1]
    s = seq.shape[1]
    pad = F.pad(seq, (0, 0, k - 1, 0))
    out = sum(pad[:, j: j + s, :] * w[:, j][None, None, :] for j in range(k))
    return out + p["conv_b"][None, None, :]


def _heads(cfg, w: SSMWidths, xin, bm, cm):
    """x, B and C of the (B, S) tokens by head: (B, S, H, P) and (B, S, H,
    N), each head reading its group's B and C."""
    lead = xin.shape[:-1]
    n, rep = cfg.ssm.d_state, w.n_heads // w.n_groups
    xh = xin.reshape(lead + (w.n_heads, cfg.ssm.head_dim))
    bmh = bm.reshape(lead + (w.n_groups, n)).repeat_interleave(rep, dim=-2)
    cmh = cm.reshape(lead + (w.n_groups, n)).repeat_interleave(rep, dim=-2)
    return xh, bmh, cmh


def gated_partials(ps: List[Params], cfg, ys: List[torch.Tensor],
                   zs: List[torch.Tensor]) -> List[torch.Tensor]:
    """``out_proj(RMSNorm(y) * silu(z))`` of each rank's heads: the ranks'
    partials, which the caller sums.  The norm's mean spans the whole
    ``d_inner``: over several ranks each rank's fp32 sum of squares (B, S,
    1) is summed in rank order on rank 0's device and divided by the full
    width before any rank normalises.  One rank takes the mean itself, as
    the reference does."""
    yfs = [y.float() for y in ys]
    if len(ys) == 1:
        var = [yfs[0].square().mean(dim=-1, keepdim=True)]
    else:
        sums = [yf.square().sum(dim=-1, keepdim=True)
                for yf in ranked(yfs)]
        total = sums[0]
        for part in sums[1:]:
            total = total + part.to(total.device)
        collective("all-reduce", total.nbytes)
        if total.requires_grad:
            total.register_hook(
                lambda g: collective("all-reduce", g.nbytes))
        var = [(total / cfg.ssm_d_inner).to(yf.device) for yf in yfs]
    outs = []
    for p, y, yf, z, v in ranked(zip(ps, ys, yfs, zs, var)):
        yn = yf * torch.rsqrt(v + 1e-5) * p["norm"].float()
        out = (yn * F.silu(z.float())).to(y.dtype)
        outs.append(out @ p["out_proj"])
    return outs


def _forward_heads(p: Params, cfg, w: SSMWidths, x: torch.Tensor, impl):
    """One rank's heads over the full sequence: (y (B, S, d_inner_r), z,
    decode state)."""
    b, s, _ = x.shape
    proj = x @ p["in_proj"]
    z, xin, bm, cm, dt = _split_proj(cfg, w, proj)
    conv_in = torch.cat([xin, bm, cm], dim=-1)
    tail = cfg.ssm.d_conv - 1
    if s >= tail:
        conv_tail = conv_in[:, s - tail:, :].transpose(1, 2)
    else:
        conv_tail = F.pad(conv_in.transpose(1, 2), (tail - s, 0))
    conv_out = F.silu(_causal_conv(p, conv_in))
    gn = w.n_groups * cfg.ssm.d_state
    xin, bm, cm = torch.split(conv_out, [w.d_inner, gn, gn], dim=-1)
    xh, bmh, cmh = _heads(cfg, w, xin, bm, cm)

    dt = F.softplus(dt.float() + p["dt_bias"])  # (B, S, H)
    A = -torch.exp(p["A_log"])  # (H,) negative
    a_log = dt * A[None, None, :]
    x_dt = xh * dt[..., None].to(xh.dtype)

    chunk = min(cfg.ssm.chunk_size, s)
    pad = (-s) % chunk
    if pad:
        x_dt = F.pad(x_dt, (0, 0, 0, 0, 0, pad))
        a_log = F.pad(a_log, (0, 0, 0, pad))
        bmh = F.pad(bmh, (0, 0, 0, 0, 0, pad))
        cmh = F.pad(cmh, (0, 0, 0, 0, 0, pad))
    if impl == "kernel":
        y, final_state = ops.ssd_scan(x_dt.contiguous(), a_log.float(),
                                      bmh.contiguous(), cmh.contiguous(),
                                      chunk=chunk)
    else:
        y, final_state = ssd_chunked(x_dt, a_log.to(x_dt.dtype), bmh, cmh,
                                     chunk)
    if pad:
        y = y[:, :s]
    y = y + xh * p["D"][None, None, :, None].to(xh.dtype)
    return y.reshape(b, s, w.d_inner), z, {"conv": conv_tail,
                                            "ssm": final_state}


def ssm_partials(ps: List[Params], cfg, xs: List[torch.Tensor], *,
                 impl: str = "kernel"):
    """The full-sequence Mamba2 block over the ranks of a pod (one rank:
    the whole block): ``ps[r]`` holds rank r's leaves
    (``launch.partition.shard_params``) and ``xs[r]`` (B, S, d_model) its
    copy of the input.  Each rank scans its own heads
    (``launch.partition.ssm_widths``).  Returns (the ranks' output
    partials (B, S, d_model), which sum to the block's output; each rank's
    decode state ``{"conv", "ssm"}``)."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"impl must be one of {ATTN_IMPLS}, got {impl!r}")
    heads = [_forward_heads(p, cfg, w, x, impl)
             for p, w, x in ranked(zip(ps, _rank_widths(cfg, len(ps)), xs))]
    outs = gated_partials(ps, cfg, [h[0] for h in heads],
                          [h[1] for h in heads])
    return outs, [h[2] for h in heads]


def ssm_forward(p: Params, cfg, x: torch.Tensor, *, impl: str = "kernel",
                return_state: bool = False):
    """Full-sequence Mamba2 block: x (B, S, d_model) -> (B, S, d_model).

    The chunk is ``min(chunk_size, S)`` and the sequence is zero-padded to a
    multiple of it, as in the reference (a 137-token prompt is one 137-long
    chunk, a 300-token one two 256-long chunks).  With ``return_state`` the
    second value is the decode state ``{"conv", "ssm"}``; otherwise it is
    the final SSM state."""
    (out,), (state,) = ssm_partials([p], cfg, [x], impl=impl)
    return out, state if return_state else state["ssm"]


def init_ssm_state(cfg, batch: int, dtype, device, tp: int = 1,
                   rank: int = 0) -> Dict[str, torch.Tensor]:
    """Zero decode state of rank ``rank`` of ``tp``: ``conv`` (B, CH_r,
    d_conv - 1) over its conv channels, ``ssm`` (B, H_r, P, N) over its
    heads."""
    w = ssm_widths(cfg, tp, rank)
    return {
        "conv": torch.zeros((batch, conv_channels(cfg, tp, rank),
                             cfg.ssm.d_conv - 1), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, w.n_heads, cfg.ssm.head_dim,
                            cfg.ssm.d_state), dtype=dtype, device=device),
    }


def _decode_heads(p: Params, cfg, w: SSMWidths, x: torch.Tensor,
                  state: Dict):
    """One rank's heads, one token: (y (B, 1, d_inner_r), z, new state)."""
    b = x.shape[0]
    proj = x[:, 0, :] @ p["in_proj"]  # (B, proj)
    z, xin, bm, cm, dt = _split_proj(cfg, w, proj)

    conv_in = torch.cat([xin, bm, cm], dim=-1)  # (B, CH)
    conv_hist = torch.cat([state["conv"], conv_in[:, :, None]], dim=-1)
    conv_out = torch.einsum("bck,ck->bc", conv_hist, p["conv_w"]) + p["conv_b"]
    conv_out = F.silu(conv_out)
    new_conv_state = conv_hist[:, :, 1:]

    gn = w.n_groups * cfg.ssm.d_state
    xin, bm, cm = torch.split(conv_out, [w.d_inner, gn, gn], dim=-1)
    xh, bmh, cmh = _heads(cfg, w, xin, bm, cm)

    dt = F.softplus(dt.float() + p["dt_bias"])  # (B, H)
    A = -torch.exp(p["A_log"])
    da = torch.exp(dt * A[None, :])  # (B, H)

    h = state["ssm"]
    h = h * da[:, :, None, None].to(h.dtype) + torch.einsum(
        "bhp,bhn,bh->bhpn", xh, bmh, dt.to(xh.dtype))
    y = torch.einsum("bhpn,bhn->bhp", h, cmh)
    y = y + xh * p["D"][None, :, None].to(xh.dtype)
    return (y.reshape(b, 1, w.d_inner), z[:, None, :],
            {"conv": new_conv_state, "ssm": h})


def ssm_decode_partials(ps: List[Params], cfg, xs: List[torch.Tensor],
                        states: List[Dict]):
    """Single-token recurrent step over the ranks of a pod (as
    :func:`ssm_partials`): x (B, 1, d_model) and each rank's state.
    Returns (the ranks' output partials, each rank's new state) and leaves
    ``states`` as they were."""
    heads = [_decode_heads(p, cfg, w, x, st)
             for p, w, x, st in ranked(zip(ps, _rank_widths(cfg, len(ps)),
                                           xs, states))]
    outs = gated_partials(ps, cfg, [h[0] for h in heads],
                          [h[1] for h in heads])
    return outs, [h[2] for h in heads]


def ssm_decode_step(p: Params, cfg, x: torch.Tensor, state: Dict):
    """Single-token recurrent step.  x (B, 1, d_model); returns (out, new
    state) and leaves ``state`` as it was."""
    (out,), (new,) = ssm_decode_partials([p], cfg, [x], [state])
    return out, new
