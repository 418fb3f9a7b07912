"""Mamba2-130M [arXiv:2405.21060] — attention-free SSM with SSD.

24L, d_model 768, d_state 128, expand 2, head_dim 64, vocab 50280.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(
    ModelConfig(
        arch_id="mamba2-130m",
        family="ssm",
        source="arXiv:2405.21060",
        n_layers=24,
        d_model=768,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        tie_embeddings=True,
        rope_type="none",
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                      chunk_size=256),
        long_context_mode="native",
        max_position_embeddings=1 << 20,
    )
)
