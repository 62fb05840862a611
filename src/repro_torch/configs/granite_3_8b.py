"""Granite-3 8B — dense GQA decoder [hf:ibm-granite/granite-3.0-2b-base; hf]."""

from repro_torch.configs.base import AttentionKind, Family, ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family=Family.DENSE,
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12800,
    vocab=49155,
    attention=AttentionKind.GQA,
    rope_theta=1e4,
    source="hf:ibm-granite/granite-3.0-2b-base; hf",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b-reduced",
        family=Family.DENSE,
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=160,
        vocab=131,
        attention=AttentionKind.GQA,
    )
