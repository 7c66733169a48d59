"""rwkv6-1.6b [ssm] "Finch" 24L d2048 attn-free, d_ff=7168 vocab=65536 —
data-dependent decay linear attention. [arXiv:2404.05892]"""
from .base import BlockDesc, ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b", family="ssm",
        n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
        head_dim=64, d_ff=7168, vocab_size=65536,
        group_layout=(BlockDesc(mixer="rwkv6", ffn="rwkv_cm"),),
        rwkv_head_dim=64,
        sub_quadratic=True,          # O(1) state: long_500k applies
    )
