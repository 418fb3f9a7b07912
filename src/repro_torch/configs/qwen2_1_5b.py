"""Qwen2-1.5B [arXiv:2407.10671] — dense GQA with QKV bias.

28L, d_model 1536, 12 heads (GQA kv=2), d_ff 8960, vocab 151936.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        arch_id="qwen2-1.5b",
        family="dense",
        source="arXiv:2407.10671",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        d_ff=8960,
        vocab_size=151936,
        qkv_bias=True,
        tie_embeddings=True,
        rope_theta=1_000_000.0,
        attention_type="full",
        long_context_mode="sliding_window",
        max_position_embeddings=32768,
    )
)
