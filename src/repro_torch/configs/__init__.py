"""Configurations the port serves: the paper's FCM job
(:mod:`fcm_brainweb`) and the language-model architectures the port
runs, by name through :func:`get_config`. The JAX package's other four
(deepseek-v2-236b, rwkv6-1.6b, whisper-tiny, llama-3.2-vision-90b) need
MLA, RWKV6, the encoder or cross-attention, which the port has not
yet."""
from . import (base, fcm_brainweb, granite_moe_3b, jamba_52b,  # noqa: F401
               llama32_1b, llama32_3b, mistral_large_123b, mistral_nemo_12b)
from .base import (SHAPES, BlockDesc, MLAConfig, ModelConfig,  # noqa: F401
                   MoEConfig, ShapeConfig, applicable_shapes)

_REGISTRY = {
    "mistral-nemo-12b": mistral_nemo_12b.make_config,
    "mistral-large-123b": mistral_large_123b.make_config,
    "llama3.2-3b": llama32_3b.make_config,
    "llama3.2-1b": llama32_1b.make_config,
    "granite-moe-3b-a800m": granite_moe_3b.make_config,
    "jamba-v0.1-52b": jamba_52b.make_config,
}


def list_archs():
    return sorted(_REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; the port runs "
                       f"{list_archs()} (MLA, RWKV6, the encoder and "
                       f"cross-attention wait for a later slice)")
    return _REGISTRY[name]()
