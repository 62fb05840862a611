"""DeepSeek-67B — dense llama-arch GQA decoder [arXiv:2401.02954; hf]."""

from repro_torch.configs.base import AttentionKind, Family, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family=Family.DENSE,
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=102400,
    attention=AttentionKind.GQA,
    rope_theta=1e4,
    source="arXiv:2401.02954; hf",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-67b-reduced",
        family=Family.DENSE,
        n_layers=3,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=172,
        vocab=128,
        attention=AttentionKind.GQA,
    )
