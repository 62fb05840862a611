"""Whisper-base — encoder-decoder transformer, conv audio frontend stubbed
with precomputed frame embeddings [arXiv:2212.04356; unverified]."""

from repro_torch.configs.base import AttentionKind, EncDecConfig, Family, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family=Family.AUDIO,
    n_layers=6,                       # decoder layers
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    attention=AttentionKind.GQA,
    mlp_gated=False,                  # whisper uses standard GELU MLP
    rope_theta=0.0,                   # whisper uses learned/sinusoidal pos
    tie_embeddings=True,
    encdec=EncDecConfig(
        n_encoder_layers=6,
        encoder_seq=1500,             # 30s of 20ms mel frames after conv stem
        frontend="audio_stub",
    ),
    source="arXiv:2212.04356; unverified",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="whisper-base-reduced",
        family=Family.AUDIO,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=160,
        attention=AttentionKind.GQA,
        rope_theta=0.0,
        tie_embeddings=True,
        encdec=EncDecConfig(n_encoder_layers=2, encoder_seq=24, frontend="audio_stub"),
    )
