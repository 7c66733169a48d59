"""granite-moe-3b-a800m [moe] 32L d1536 24H (GQA kv=8) expert d_ff=512,
MoE 40 experts top-8, vocab=49155. [hf:ibm-granite/granite-3.0-3b-a800m]"""
from .base import BlockDesc, ModelConfig, MoEConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe",
        n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
        head_dim=64, d_ff=512, vocab_size=49155,
        group_layout=(BlockDesc(mixer="gqa", ffn="moe"),),
        moe=MoEConfig(n_experts=40, top_k=8, d_ff_expert=512),
        rope_theta=1e4, sub_quadratic=False,
    )
