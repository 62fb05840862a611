"""DeepSeekMoE-16B — fine-grained MoE, 2 shared + 64 routed top-6
[arXiv:2401.06066; hf]."""

from repro_torch.configs.base import AttentionKind, Family, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family=Family.MOE,
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,                       # first dense layer hidden dim
    vocab=102400,
    attention=AttentionKind.GQA,
    rope_theta=1e4,
    moe=MoEConfig(
        n_experts=64,
        top_k=6,
        n_shared=2,
        d_ff_expert=1408,
        capacity_factor=1.25,
        router="softmax",
        aux_loss_weight=0.001,
        first_dense=1,                # layer 0 dense in DeepSeekMoE
    ),
    source="arXiv:2401.06066; hf",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b-reduced",
        family=Family.MOE,
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=192,
        vocab=128,
        attention=AttentionKind.GQA,
        moe=MoEConfig(
            n_experts=8,
            top_k=2,
            n_shared=2,
            d_ff_expert=48,
            router="softmax",
            first_dense=1,
        ),
    )
