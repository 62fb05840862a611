"""DeepSeek-V3 671B — MLA + fine-grained MoE (1 shared + 256 routed, top-8),
aux-loss-free sigmoid routing, MTP head [arXiv:2412.19437; hf]."""

from repro_torch.configs.base import AttentionKind, Family, MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family=Family.MOE,
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,                       # dense layers' hidden dim
    vocab=129280,
    attention=AttentionKind.MLA,
    d_head=128,
    rope_theta=1e4,
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        n_experts=256,
        top_k=8,
        n_shared=1,
        d_ff_expert=2048,
        capacity_factor=1.25,
        router="sigmoid",             # aux-loss-free bias routing
        first_dense=3,                # first 3 layers are dense in DS-V3
    ),
    mtp_depth=1,
    source="arXiv:2412.19437; hf",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b-reduced",
        family=Family.MOE,
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=160,
        attention=AttentionKind.MLA,
        d_head=16,
        mla=MLAConfig(
            q_lora_rank=32,
            kv_lora_rank=16,
            qk_nope_head_dim=16,
            qk_rope_head_dim=8,
            v_head_dim=16,
        ),
        moe=MoEConfig(
            n_experts=8,
            top_k=2,
            n_shared=1,
            d_ff_expert=32,
            router="sigmoid",
            first_dense=1,
        ),
        mtp_depth=1,
    )
