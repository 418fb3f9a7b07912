"""Whisper-large-v3 [arXiv:2212.04356] — encoder-decoder audio backbone.

Decoder: 32L, d_model 1280, 20 heads (MHA: kv=20), d_ff 5120, vocab 51866,
learned positions, LayerNorm + GELU (non-gated MLP).  Encoder: 32L over
1500 frame positions.  The mel-spectrogram and conv frontend are a stub,
as in the reference: ``input_specs`` provides precomputed frame embeddings
``(batch, 1500, d_model)``.

long_500k is skipped for this arch: its decoder positions are bounded at
448.
"""
from repro_torch.configs.base import EncoderConfig, ModelConfig, register

CONFIG = register(
    ModelConfig(
        arch_id="whisper-large-v3",
        family="audio",
        source="arXiv:2212.04356",
        n_layers=32,
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,
        d_ff=5120,
        vocab_size=51866,
        norm="layernorm",
        activation="gelu",
        gated_mlp=False,
        rope_type="learned",
        tie_embeddings=True,
        attention_type="full",
        long_context_mode="unsupported",
        encoder=EncoderConfig(n_layers=32, n_frames=1500),
        frontend="audio_stub",
        frontend_tokens=1500,
        max_position_embeddings=448,
    )
)
