"""Llama-3.2-3B [hf:meta-llama/Llama-3.2-1B family] — small llama3 dense GQA.

28L, d_model 3072, 24 heads (GQA kv=8), d_ff 8192, vocab 128256.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        arch_id="llama3.2-3b",
        family="dense",
        source="hf:meta-llama/Llama-3.2-1B",
        n_layers=28,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=128256,
        tie_embeddings=True,
        rope_theta=500_000.0,
        attention_type="full",
        long_context_mode="sliding_window",
        max_position_embeddings=131072,
    )
)
