"""Yi-6B [arXiv:2403.04652] — llama-architecture dense decoder with GQA.

32L, d_model 4096, 32 heads (GQA kv=4), d_ff 11008, vocab 64000.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        arch_id="yi-6b",
        family="dense",
        source="arXiv:2403.04652",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=4,
        d_ff=11008,
        vocab_size=64000,
        rope_theta=5_000_000.0,
        attention_type="full",
        long_context_mode="sliding_window",
        max_position_embeddings=4096,
    )
)
