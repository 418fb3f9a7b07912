"""Mixtral-8x7B [arXiv:2401.04088] — sparse MoE, 8 experts top-2, SWA.

32L, d_model 4096, 32 heads (GQA kv=8), expert d_ff 14336, vocab 32000.
Sliding-window attention (4096) makes long_500k decode native.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(
    ModelConfig(
        arch_id="mixtral-8x7b",
        family="moe",
        source="arXiv:2401.04088",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=32000,
        rope_theta=1_000_000.0,
        attention_type="swa",
        swa_window=4096,
        long_context_mode="native",
        moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=14336,
                      norm_topk_prob=True),
        max_position_embeddings=32768,
    )
)
