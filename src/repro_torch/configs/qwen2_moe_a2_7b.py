"""Qwen2-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B] — 60 routed experts top-4
plus 4 shared experts.

24L, d_model 2048, 16 heads (GQA kv=16), routed expert d_ff 1408,
shared-expert path d_ff 4*1408=5632, vocab 151936, QKV bias.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(
    ModelConfig(
        arch_id="qwen2-moe-a2.7b",
        family="moe",
        source="hf:Qwen/Qwen1.5-MoE-A2.7B",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab_size=151936,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        attention_type="full",
        long_context_mode="sliding_window",
        moe=MoEConfig(
            num_experts=60,
            top_k=4,
            num_shared_experts=4,
            expert_d_ff=1408,
            shared_d_ff=5632,
            norm_topk_prob=False,
        ),
        max_position_embeddings=32768,
    )
)
