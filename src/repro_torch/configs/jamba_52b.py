"""jamba-v0.1-52b [hybrid] 32L d4096 32H (GQA kv=8) d_ff=14336
vocab=65536 — Mamba:attn 7:1 interleave, MoE 16 experts top-2 on every
other layer. [arXiv:2403.19887]"""
from .base import BlockDesc, ModelConfig, MoEConfig


def make_config() -> ModelConfig:
    # period-8 group: attention at index 4 (1:7 ratio), MoE on odd layers
    layout = tuple(
        BlockDesc(mixer=("gqa" if i == 4 else "mamba"),
                  ffn=("moe" if i % 2 == 1 else "swiglu"))
        for i in range(8))
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        head_dim=128, d_ff=14336, vocab_size=65536,
        group_layout=layout,
        moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336),
        mamba_d_state=16, mamba_expand=2, mamba_conv=4,
        rope_theta=1e6,
        sub_quadratic=True,      # mamba-dominant: long_500k applies
    )
