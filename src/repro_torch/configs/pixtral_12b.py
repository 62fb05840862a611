"""Pixtral-12B — VLM: pixtral-ViT frontend (stubbed as precomputed patch
embeddings) + Mistral-NeMo-style decoder backbone
[hf:mistralai/Pixtral-12B-2409; unverified]."""

from repro_torch.configs.base import AttentionKind, Family, ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family=Family.VLM,
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=131072,
    attention=AttentionKind.GQA,
    d_head=128,
    rope_theta=1e9,                   # mistral-nemo long-theta rope
    n_frontend_tokens=1024,           # 1024 image-patch embeddings per sample
    source="hf:mistralai/Pixtral-12B-2409; unverified",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b-reduced",
        family=Family.VLM,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=144,
        attention=AttentionKind.GQA,
        d_head=16,
        n_frontend_tokens=8,
    )
