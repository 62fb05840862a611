"""RecurrentGemma-2B — Griffin: RG-LRU recurrent blocks + local attention,
2:1 interleave [arXiv:2402.19427; hf]."""

from repro_torch.configs.base import AttentionKind, Family, HybridConfig, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family=Family.HYBRID,
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,                     # MQA in the local-attention layers
    d_ff=7680,
    vocab=256000,
    attention=AttentionKind.LOCAL,
    d_head=256,
    window=2048,
    tie_embeddings=True,
    hybrid=HybridConfig(
        pattern=("recurrent", "recurrent", "local_attn"),
        lru_width=2560,
        conv_width=4,
        window=2048,
    ),
    source="arXiv:2402.19427; hf",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b-reduced",
        family=Family.HYBRID,
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_ff=192,
        vocab=160,
        attention=AttentionKind.LOCAL,
        d_head=16,
        window=16,
        tie_embeddings=True,
        hybrid=HybridConfig(
            pattern=("recurrent", "recurrent", "local_attn"),
            lru_width=64,
            conv_width=4,
            window=16,
        ),
    )
