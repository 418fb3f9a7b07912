"""BGE-style bidirectional transformer encoder (the predictor backbone).

The port of ``repro.models.encoder``: token + learned position embeddings,
post-LN encoder layers (MHA, GELU MLP), CLS token at position 0, mean
pooling over valid tokens.  Parameters keep the reference's layout (weights
``(in, out)``, the layers stacked on a leading axis), so a JAX encoder's
parameters carry across through :mod:`repro_torch.bridge` unchanged.

The attention is plain PyTorch, as the reference's is plain XLA (two
products and a masked softmax): no kernel of the reference computes it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L


@dataclass(frozen=True)
class EncoderArchConfig:
    vocab_size: int = 8192
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 4
    d_ff: int = 512
    max_len: int = 512
    dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


#: full-size variant matching bge-base-en-v1.5
BGE_BASE = EncoderArchConfig(
    vocab_size=30522, d_model=768, n_heads=12, n_layers=12, d_ff=3072,
    max_len=512,
)


def init_encoder(gen: torch.Generator, cfg: EncoderArchConfig) -> Dict:
    """Random encoder parameters with the reference's distributions, drawn
    from ``gen`` on its device."""
    dtype = getattr(torch, cfg.dtype)
    d, n, dev = cfg.d_model, cfg.n_layers, gen.device
    lead = (n,)
    return {
        "embed": L.embed_init(gen, cfg.vocab_size, d, dtype),
        "pos": L.embed_init(gen, cfg.max_len, d, dtype),
        "layers": {
            "wq": L.dense_init(gen, d, d, dtype, lead=lead),
            "wk": L.dense_init(gen, d, d, dtype, lead=lead),
            "wv": L.dense_init(gen, d, d, dtype, lead=lead),
            "wo": L.dense_init(gen, d, d, dtype, lead=lead),
            "attn_norm": L.init_layernorm(d, dtype, lead=lead, device=dev),
            "mlp": L.init_mlp(gen, d, cfg.d_ff, n, dtype, gated=False),
            "mlp_norm": L.init_layernorm(d, dtype, lead=lead, device=dev),
        },
        "final_norm": L.init_layernorm(d, dtype, device=dev),
    }


def encode(params: Dict, cfg: EncoderArchConfig, tokens: torch.Tensor,
           mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) integer, mask (B, S) bool ->
    (cls (B, d), mean_pooled (B, d)).

    Ids past the vocabulary read its last row, as JAX's clamping gather
    does (the engine's generated ids come from a larger vocabulary).  A
    padded row (mask all False) stays finite: masked scores are -1e30, not
    -inf, as in the reference."""
    b, s = tokens.shape
    ids = tokens.long().clamp(0, cfg.vocab_size - 1)
    h = params["embed"][ids] + params["pos"][None, :s]
    lp_all = params["layers"]
    nh, hd = cfg.n_heads, cfg.head_dim
    scale = math.sqrt(hd)
    keep = mask[:, None, None, :]
    for i in range(cfg.n_layers):
        lp = {k: (v[i] if torch.is_tensor(v) else {kk: vv[i]
                                                  for kk, vv in v.items()})
              for k, v in lp_all.items()}
        q = (h @ lp["wq"]).reshape(b, s, nh, hd)
        k = (h @ lp["wk"]).reshape(b, s, nh, hd)
        v = (h @ lp["wv"]).reshape(b, s, nh, hd)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / scale
        scores = scores.masked_fill(~keep, -1e30)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, -1)
        h = L.layernorm(lp["attn_norm"], h + out @ lp["wo"])  # post-LN
        mlp_out = F.gelu(h @ lp["mlp"]["w_up"],
                         approximate="tanh") @ lp["mlp"]["w_down"]
        h = L.layernorm(lp["mlp_norm"], h + mlp_out)
    h = L.layernorm(params["final_norm"], h)
    cls = h[:, 0, :]
    m = mask[..., None].to(h.dtype)
    mean = (h * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
    return cls, mean
