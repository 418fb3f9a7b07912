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
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import ATTN_IMPLS, dense_init

Params = Dict[str, torch.Tensor]


def conv_channels(cfg) -> int:
    return cfg.ssm_d_inner + 2 * cfg.ssm.n_groups * cfg.ssm.d_state


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
    a = torch.rand(lead + (nh,), generator=gen, device=dev) * (hi - lo) + lo
    conv_w = torch.randn(lead + (conv_channels(cfg), s.d_conv), generator=gen,
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


def _split_proj(cfg, proj: torch.Tensor):
    di, g, n = cfg.ssm_d_inner, cfg.ssm.n_groups, cfg.ssm.d_state
    return torch.split(proj, [di, di, g * n, g * n, cfg.ssm_n_heads], dim=-1)


def _causal_conv(p: Params, seq: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, CH): the reference's unrolled k-tap
    sum (out[t] = sum_j w[j] * x[t + j - (k - 1)]), not a cuDNN conv."""
    w = p["conv_w"]  # (CH, K)
    k = w.shape[-1]
    s = seq.shape[1]
    pad = F.pad(seq, (0, 0, k - 1, 0))
    out = sum(pad[:, j: j + s, :] * w[:, j][None, None, :] for j in range(k))
    return out + p["conv_b"][None, None, :]


def _heads(cfg, xin, bm, cm):
    b, s, _ = xin.shape
    nh, hd = cfg.ssm_n_heads, cfg.ssm.head_dim
    g, n = cfg.ssm.n_groups, cfg.ssm.d_state
    rep = nh // g
    xh = xin.reshape(b, s, nh, hd)
    bmh = bm.reshape(b, s, g, n).repeat_interleave(rep, dim=2)
    cmh = cm.reshape(b, s, g, n).repeat_interleave(rep, dim=2)
    return xh, bmh, cmh


def _gated_out(p: Params, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    yf = y.float()
    var = yf.square().mean(dim=-1, keepdim=True)
    yn = yf * torch.rsqrt(var + 1e-5) * p["norm"].float()
    out = (yn * F.silu(z.float())).to(y.dtype)
    return out @ p["out_proj"]


def ssm_forward(p: Params, cfg, x: torch.Tensor, *, impl: str = "kernel",
                return_state: bool = False):
    """Full-sequence Mamba2 block: x (B, S, d_model) -> (B, S, d_model).

    The chunk is ``min(chunk_size, S)`` and the sequence is zero-padded to a
    multiple of it, as in the reference (a 137-token prompt is one 137-long
    chunk, a 300-token one two 256-long chunks).  With ``return_state`` the
    second value is the decode state ``{"conv", "ssm"}``; otherwise it is
    the final SSM state."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"impl must be one of {ATTN_IMPLS}, got {impl!r}")
    b, s, _ = x.shape
    proj = x @ p["in_proj"]
    z, xin, bm, cm, dt = _split_proj(cfg, proj)
    conv_in = torch.cat([xin, bm, cm], dim=-1)
    tail = cfg.ssm.d_conv - 1
    if s >= tail:
        conv_tail = conv_in[:, s - tail:, :].transpose(1, 2)
    else:
        conv_tail = F.pad(conv_in.transpose(1, 2), (tail - s, 0))
    conv_out = F.silu(_causal_conv(p, conv_in))
    di = cfg.ssm_d_inner
    gn = cfg.ssm.n_groups * cfg.ssm.d_state
    xin, bm, cm = torch.split(conv_out, [di, gn, gn], dim=-1)
    xh, bmh, cmh = _heads(cfg, xin, bm, cm)

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
    y = y.reshape(b, s, di)
    out = _gated_out(p, y, z)
    if return_state:
        return out, {"conv": conv_tail, "ssm": final_state}
    return out, final_state


def init_ssm_state(cfg, batch: int, dtype, device) -> Dict[str, torch.Tensor]:
    return {
        "conv": torch.zeros((batch, conv_channels(cfg), cfg.ssm.d_conv - 1),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.ssm_n_heads, cfg.ssm.head_dim,
                            cfg.ssm.d_state), dtype=dtype, device=device),
    }


def ssm_decode_step(p: Params, cfg, x: torch.Tensor, state: Dict):
    """Single-token recurrent step.  x (B, 1, d_model); returns (out, new
    state) and leaves ``state`` as it was."""
    b = x.shape[0]
    proj = x[:, 0, :] @ p["in_proj"]  # (B, proj)
    z, xin, bm, cm, dt = _split_proj(cfg, proj)

    conv_in = torch.cat([xin, bm, cm], dim=-1)  # (B, CH)
    conv_hist = torch.cat([state["conv"], conv_in[:, :, None]], dim=-1)
    conv_out = torch.einsum("bck,ck->bc", conv_hist, p["conv_w"]) + p["conv_b"]
    conv_out = F.silu(conv_out)
    new_conv_state = conv_hist[:, :, 1:]

    di = cfg.ssm_d_inner
    gn = cfg.ssm.n_groups * cfg.ssm.d_state
    xin, bm, cm = torch.split(conv_out, [di, gn, gn], dim=-1)
    nh, hd = cfg.ssm_n_heads, cfg.ssm.head_dim
    g, n = cfg.ssm.n_groups, cfg.ssm.d_state
    xh = xin.reshape(b, nh, hd)
    bmh = bm.reshape(b, g, n).repeat_interleave(nh // g, dim=1)
    cmh = cm.reshape(b, g, n).repeat_interleave(nh // g, dim=1)

    dt = F.softplus(dt.float() + p["dt_bias"])  # (B, H)
    A = -torch.exp(p["A_log"])
    da = torch.exp(dt * A[None, :])  # (B, H)

    h = state["ssm"]
    h = h * da[:, :, None, None].to(h.dtype) + torch.einsum(
        "bhp,bhn,bh->bhpn", xh, bmh, dt.to(xh.dtype))
    y = torch.einsum("bhpn,bhn->bhp", h, cmh)
    y = y + xh * p["D"][None, :, None].to(xh.dtype)
    y = y.reshape(b, 1, di)
    out = _gated_out(p, y, z[:, None, :])
    return out, {"conv": new_conv_state, "ssm": h}
