"""Mamba2-1.3B — attention-free SSM with state-space duality (SSD)
[arXiv:2405.21060; unverified]."""

from repro_torch.configs.base import AttentionKind, Family, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family=Family.SSM,
    n_layers=48,
    d_model=2048,
    n_heads=0,                        # attention-free
    n_kv_heads=0,
    d_ff=0,                           # no separate FFN; SSD block includes MLP-ish expand
    vocab=50280,
    attention=AttentionKind.NONE,
    tie_embeddings=True,
    ssm=SSMConfig(
        d_state=128,
        expand=2,
        headdim=64,
        n_groups=1,
        conv_kernel=4,
        chunk_size=256,
    ),
    source="arXiv:2405.21060; unverified",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b-reduced",
        family=Family.SSM,
        n_layers=2,
        d_model=64,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab=128,
        attention=AttentionKind.NONE,
        tie_embeddings=True,
        ssm=SSMConfig(d_state=16, expand=2, headdim=16, conv_kernel=4, chunk_size=16),
    )
