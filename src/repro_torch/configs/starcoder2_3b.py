"""StarCoder2-3B — dense GQA+RoPE decoder [arXiv:2402.19173; hf]."""

from repro_torch.configs.base import AttentionKind, Family, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family=Family.DENSE,
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab=49152,
    attention=AttentionKind.GQA,
    mlp_gated=False,                  # starcoder2 uses c_fc/c_proj GELU MLP
    rope_theta=1e5,
    source="arXiv:2402.19173; hf",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b-reduced",
        family=Family.DENSE,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=128,
        attention=AttentionKind.GQA,
        rope_theta=1e5,
    )
