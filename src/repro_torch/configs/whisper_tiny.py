"""whisper-tiny [audio] enc-dec 4+4L d384 6H d_ff=1536 vocab=51865 —
conv frontend is not modelled: the caller gives precomputed frame
embeddings as ``frames`` (B, n_frames, d_model). [arXiv:2212.04356]"""
from .base import BlockDesc, ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny", family="audio",
        n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
        head_dim=64, d_ff=1536, vocab_size=51865,
        enc_layers=4, audio_frames=True,
        group_layout=(BlockDesc(mixer="gqa", ffn="gelu", cross=True),),
        rope_theta=1e4, sub_quadratic=False,
    )
