"""Qwen1.5-32B [hf:Qwen/Qwen1.5 family] — large dense decoder with QKV bias.

64L, d_model 5120, 40 heads (GQA kv=40 => MHA-width KV), d_ff 27392,
vocab 152064.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        arch_id="qwen1.5-32b",
        family="dense",
        source="hf:Qwen/Qwen1.5-0.5B (scaled per assignment)",
        n_layers=64,
        d_model=5120,
        n_heads=40,
        n_kv_heads=40,
        d_ff=27392,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        attention_type="full",
        long_context_mode="sliding_window",
        max_position_embeddings=32768,
    )
)
