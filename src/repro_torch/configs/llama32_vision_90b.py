"""llama-3.2-vision-90b [vlm] 100L d8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — gated cross-attn image layers every 5th layer; the vision
frontend is not modelled: the caller gives the patch embeddings as
``memory`` (B, n_img_tokens, d_model).
[hf:meta-llama/Llama-3.2-90B-Vision]"""
from .base import BlockDesc, ModelConfig


def make_config() -> ModelConfig:
    self_blk = BlockDesc(mixer="gqa", ffn="swiglu")
    cross_blk = BlockDesc(mixer="cross", ffn="swiglu", gated=True)
    return ModelConfig(
        name="llama-3.2-vision-90b", family="vlm",
        n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8,
        head_dim=128, d_ff=28672, vocab_size=128256,
        group_layout=(cross_blk, self_blk, self_blk, self_blk, self_blk),
        n_img_tokens=1601,          # one vision tile of 1601 patches
        rope_theta=5e5, sub_quadratic=False,
    )
