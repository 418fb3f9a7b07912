"""Model configuration for the PyTorch port (every family of the
reference: dense, MoE, SSM, hybrid, vlm and audio).

A copy of ``repro.configs.base``: :class:`ModelConfig` keeps the fields
the families read, with the same defaults, the same ``head_dim`` rule, the
same ``reduced()`` sizes and the same analytic ``param_count``, so a
reference config and its port describe identical parameter shapes.  The
vlm and audio families' modality frontends are stubs, as in the
reference: the model takes precomputed patch or frame embeddings.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration."""

    num_experts: int = 0
    top_k: int = 0
    #: experts always active regardless of routing (qwen2-moe "shared" experts)
    num_shared_experts: int = 0
    #: FFN hidden dim of each routed expert (may differ from dense d_ff)
    expert_d_ff: int = 0
    #: FFN hidden dim of the shared-expert path (qwen2-moe: shared = 4x expert)
    shared_d_ff: int = 0
    #: weight of the load-balancing auxiliary loss (Switch-style)
    router_aux_weight: float = 0.01
    #: normalise top-k router weights to sum to 1 (mixtral: True)
    norm_topk_prob: bool = True

    @property
    def enabled(self) -> bool:
        return self.num_experts > 0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block configuration."""

    d_state: int = 0
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256
    #: A init range (discretised negative real eigenvalues)
    a_init_range: Tuple[float, float] = (1.0, 16.0)

    @property
    def enabled(self) -> bool:
        return self.d_state > 0


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style hybrid: Mamba2 backbone + shared attention block.

    Every ``attn_every`` backbone layers, one *shared* (weight-tied)
    attention block is applied (arXiv:2411.15242).  ``n_shared_blocks``
    counts the shared blocks in ``param_count``, as in the reference,
    whose model builds one."""

    attn_every: int = 0
    n_shared_blocks: int = 1

    @property
    def enabled(self) -> bool:
        return self.attn_every > 0


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder tower for encoder-decoder (whisper) architectures."""

    n_layers: int = 0
    #: number of positions the (stubbed) conv frontend produces per sample
    n_frames: int = 0

    @property
    def enabled(self) -> bool:
        return self.n_layers > 0


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description of a dense or MoE decoder, a Mamba2 stack,
    a Mamba2 stack with a shared attention block (hybrid), a dense decoder
    over stub patch embeddings (vlm) or an encoder-decoder over stub frame
    embeddings (audio)."""

    arch_id: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    source: str = ""  # citation of the public config

    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-5
    activation: str = "silu"  # silu (gated) | gelu (whisper's plain MLP)
    gated_mlp: bool = True

    rope_type: str = "rope"  # rope | mrope | learned
    rope_theta: float = 10000.0
    #: M-RoPE section split (temporal, height, width) for qwen2-vl
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    max_position_embeddings: int = 131072

    attention_type: str = "full"  # full | swa
    swa_window: int = 4096
    long_context_mode: str = "sliding_window"

    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    hybrid: HybridConfig = field(default_factory=HybridConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)

    #: modality frontend stub: none | vision_stub | audio_stub
    frontend: str = "none"
    #: number of stub embeddings injected per request (patches / frames)
    frontend_tokens: int = 0

    dtype: str = "bfloat16"

    def __post_init__(self):
        # an attention-free config (n_heads=0) keeps head_dim 0
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def d_head_total(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm.expand * self.d_model if self.ssm.enabled else 0

    @property
    def ssm_n_heads(self) -> int:
        return self.ssm_d_inner // self.ssm.head_dim if self.ssm.enabled else 0

    def param_count(self) -> int:
        """Analytic total parameter count (embedding included once if
        tied), as the reference counts it.  Its MoE count keeps the
        reference's quirk: the shared path counts ``num_shared_experts``
        MLPs of width ``shared_d_ff``, while ``init_moe`` builds one (for
        qwen2-moe-a2.7b 16.807 B counted, 14.316 B built)."""
        d = self.d_model
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.family in ("dense", "moe", "vlm", "audio", "hybrid"):
            attn = (d * self.n_heads * self.head_dim
                    + 2 * d * self.n_kv_heads * self.head_dim
                    + self.n_heads * self.head_dim * d)
            if self.qkv_bias:
                attn += (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
        else:
            attn = 0
        if self.moe.enabled:
            e = self.moe
            ffn = e.num_experts * 3 * d * e.expert_d_ff
            ffn += e.num_shared_experts * 3 * d * e.shared_d_ff
            ffn += d * e.num_experts  # router
        elif self.d_ff:
            ffn = (3 if self.gated_mlp else 2) * d * self.d_ff
        else:
            ffn = 0
        norms = 2 * d
        if self.family in ("ssm", "hybrid") and self.ssm.enabled:
            di, nh = self.ssm_d_inner, self.ssm_n_heads
            g = self.ssm.n_groups * self.ssm.d_state
            ssm = d * (2 * di + 2 * g + nh)  # in_proj (z,x,B,C,dt)
            ssm += (di + 2 * g) * self.ssm.d_conv  # conv1d
            ssm += 2 * nh + di  # A_log, dt_bias, skip D
            ssm += di * d  # out_proj
        else:
            ssm = 0
        if self.family == "hybrid" and self.hybrid.enabled:
            # backbone layers are SSM; the shared blocks are counted once
            shared = self.hybrid.n_shared_blocks * (
                attn + (3 if self.gated_mlp else 2) * d * self.d_ff + 2 * d)
            body = self.n_layers * (ssm + norms) + shared
        elif self.family == "ssm":
            body = self.n_layers * (ssm + norms)
        else:
            body = self.n_layers * (attn + ffn + norms)
        enc = 0
        if self.encoder.enabled:
            enc = self.encoder.n_layers * (4 * d * d + 2 * d * self.d_ff
                                           + 2 * d)
            # the decoder's cross-attention
            body += self.n_layers * (4 * d * d + d)
        return emb + body + enc + d  # final norm

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top_k + shared experts)."""
        if not self.moe.enabled:
            return self.param_count()
        e = self.moe
        full_ffn = e.num_experts * 3 * self.d_model * e.expert_d_ff
        act_ffn = e.top_k * 3 * self.d_model * e.expert_d_ff
        return self.param_count() - self.n_layers * (full_ffn - act_ffn)

    def reduced(self) -> "ModelConfig":
        """Smoke-scale variant of the same family for CPU tests (the same
        sizes as ``repro.configs.base.ModelConfig.reduced``)."""
        d_model = min(self.d_model, 128)
        n_heads = min(self.n_heads, 4) or 4
        head_dim = max(d_model // n_heads, 16)
        n_kv = max(1, min(self.n_kv_heads, 2)) if self.n_kv_heads else 0
        kw: Dict = dict(
            arch_id=self.arch_id + "-reduced",
            n_layers=min(self.n_layers, 2),
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            max_position_embeddings=2048,
            swa_window=64,
            frontend_tokens=min(self.frontend_tokens, 8),
            dtype="float32",
        )
        if self.moe.enabled:
            kw["moe"] = replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 4),
                top_k=min(self.moe.top_k, 2),
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                expert_d_ff=min(self.moe.expert_d_ff, 128),
                shared_d_ff=min(self.moe.shared_d_ff, 128),
            )
        if self.ssm.enabled:
            kw["ssm"] = replace(
                self.ssm, d_state=min(self.ssm.d_state, 16), head_dim=32,
                chunk_size=32,
            )
        if self.hybrid.enabled:
            kw["n_layers"] = 4
            kw["hybrid"] = replace(self.hybrid, attn_every=2)
        if self.encoder.enabled:
            kw["encoder"] = replace(self.encoder, n_layers=2, n_frames=16)
        if self.rope_type == "mrope":
            kw["mrope_sections"] = _mrope_sections_for(head_dim)
        return replace(self, **kw)


def _mrope_sections_for(head_dim: int) -> Tuple[int, int, int]:
    """(temporal, height, width) bands over the ``head_dim // 2`` rotary
    frequencies of a reduced M-RoPE config."""
    half = head_dim // 2
    t = half // 2
    h = (half - t) // 2
    return (t, h, half - t - h)


# --------------------------------------------------------------------------- #
# Registry
# --------------------------------------------------------------------------- #
_REGISTRY: Dict[str, ModelConfig] = {}


def register(config: ModelConfig) -> ModelConfig:
    if config.arch_id in _REGISTRY:
        raise ValueError(f"duplicate arch_id {config.arch_id!r}")
    _REGISTRY[config.arch_id] = config
    return config


def get_config(arch_id: str) -> ModelConfig:
    _ensure_loaded()
    try:
        return _REGISTRY[arch_id]
    except KeyError:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(_REGISTRY)}"
        ) from None


def list_archs() -> Tuple[str, ...]:
    _ensure_loaded()
    return tuple(sorted(_REGISTRY))


_LOADED = False


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    # import every per-arch module for its registration side effect
    from repro_torch.configs import (  # noqa: F401
        llama3_2_3b,
        mamba2_130m,
        mixtral_8x7b,
        qwen1_5_32b,
        qwen2_1_5b,
        qwen2_moe_a2_7b,
        qwen2_vl_7b,
        whisper_large_v3,
        yi_6b,
        zamba2_7b,
    )
