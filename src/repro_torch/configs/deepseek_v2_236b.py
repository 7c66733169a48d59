"""deepseek-v2-236b [moe] 60L d5120 128H, MLA (kv_lora=512), MoE 160
routed top-6 + 2 shared, expert d_ff=1536, vocab=102400.
[arXiv:2405.04434]

Simplification against the published checkpoint, as in the JAX
package: every layer is MoE (the real model has one dense first layer).
"""
from .base import BlockDesc, MLAConfig, ModelConfig, MoEConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b", family="moe",
        n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
        head_dim=128, d_ff=1536, vocab_size=102400,
        group_layout=(BlockDesc(mixer="mla", ffn="moe"),),
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        moe=MoEConfig(n_experts=160, top_k=6, d_ff_expert=1536,
                      n_shared=2),
        rope_theta=1e4, sub_quadratic=False,
    )
