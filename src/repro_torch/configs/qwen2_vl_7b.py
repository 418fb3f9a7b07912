"""Qwen2-VL-7B language backbone [arXiv:2409.12191].

VLM: the ViT vision encoder and projector are a stub, as in the reference:
``input_specs`` provides pre-projected patch embeddings of shape
``(batch, frontend_tokens, d_model)``, which the model prepends to the
text embeddings.  The transformer backbone is exact: 28L, d_model 3584, 28
heads (GQA kv=4), d_ff 18944, vocab 152064, M-RoPE with sections
(16, 24, 24) over the 64 rotary frequencies.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        arch_id="qwen2-vl-7b",
        family="vlm",
        source="arXiv:2409.12191",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        d_ff=18944,
        vocab_size=152064,
        qkv_bias=True,
        rope_type="mrope",
        rope_theta=1_000_000.0,
        mrope_sections=(16, 24, 24),
        frontend="vision_stub",
        frontend_tokens=256,
        attention_type="full",
        long_context_mode="sliding_window",
        max_position_embeddings=32768,
    )
)
