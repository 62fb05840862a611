"""Mistral-Large-123B — dense GQA decoder
[hf:mistralai/Mistral-Large-Instruct-2407; unverified]."""

from repro_torch.configs.base import AttentionKind, Family, ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family=Family.DENSE,
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=28672,
    vocab=32768,
    attention=AttentionKind.GQA,
    d_head=128,
    rope_theta=1e6,
    source="hf:mistralai/Mistral-Large-Instruct-2407; unverified",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-123b-reduced",
        family=Family.DENSE,
        n_layers=2,
        d_model=96,
        n_heads=6,
        n_kv_heads=2,
        d_ff=224,
        vocab=128,
        attention=AttentionKind.GQA,
        d_head=16,
        rope_theta=1e6,
    )
