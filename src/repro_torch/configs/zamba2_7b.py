"""Zamba2-7B [arXiv:2411.15242] — hybrid: Mamba2 backbone + shared attention.

81 Mamba2 layers, d_model 3584, ssm_state 64; a *shared* (weight-tied)
attention+MLP block (32 heads, kv=32, head dim 112, d_ff 14336, SWA 4096) is
applied after every 6 backbone layers (13 invocations + 3 tail layers).
"""
from repro_torch.configs.base import (HybridConfig, ModelConfig, SSMConfig,
                                      register)

CONFIG = register(
    ModelConfig(
        arch_id="zamba2-7b",
        family="hybrid",
        source="arXiv:2411.15242",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        d_ff=14336,
        vocab_size=32000,
        head_dim=112,
        rope_theta=10000.0,
        attention_type="swa",
        swa_window=4096,
        long_context_mode="native",
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=1,
                      chunk_size=256),
        hybrid=HybridConfig(attn_every=6, n_shared_blocks=1),
        max_position_embeddings=1 << 20,
    )
)
