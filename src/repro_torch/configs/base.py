"""Model configuration for the PyTorch port (dense and SSM families).

A trimmed copy of ``repro.configs.base``: :class:`ModelConfig` keeps the
fields the dense decoder and the Mamba2 stack read, with the same defaults,
the same ``head_dim`` rule and the same ``reduced()`` sizes, so a reference
config and its port describe identical parameter shapes.  The MoE, hybrid
and encoder sub-configs arrive with the slices that port those families.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Tuple


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
class ModelConfig:
    """Architecture description of a dense decoder or a Mamba2 stack."""

    arch_id: str
    family: str  # dense | ssm (the families this port serves so far)
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
    norm: str = "rmsnorm"
    norm_eps: float = 1e-5
    activation: str = "silu"
    gated_mlp: bool = True

    rope_type: str = "rope"
    rope_theta: float = 10000.0
    max_position_embeddings: int = 131072

    attention_type: str = "full"  # full | swa
    swa_window: int = 4096
    long_context_mode: str = "sliding_window"

    ssm: SSMConfig = field(default_factory=SSMConfig)

    dtype: str = "bfloat16"

    def __post_init__(self):
        # an attention-free config (n_heads=0) keeps head_dim 0
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm.expand * self.d_model if self.ssm.enabled else 0

    @property
    def ssm_n_heads(self) -> int:
        return self.ssm_d_inner // self.ssm.head_dim if self.ssm.enabled else 0

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
            dtype="float32",
        )
        if self.ssm.enabled:
            kw["ssm"] = replace(
                self.ssm, d_state=min(self.ssm.d_state, 16), head_dim=32,
                chunk_size=32,
            )
        return replace(self, **kw)


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
    from repro_torch.configs import mamba2_130m, qwen2_1_5b  # noqa: F401
