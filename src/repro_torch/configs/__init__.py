"""Configurations the port serves: the paper's FCM job
(:mod:`fcm_brainweb`) and the JAX package's ten language-model
architectures, by name through :func:`get_config`."""
from . import (base, deepseek_v2_236b, fcm_brainweb,  # noqa: F401
               granite_moe_3b, jamba_52b, llama32_1b, llama32_3b,
               llama32_vision_90b, mistral_large_123b, mistral_nemo_12b,
               rwkv6_1b6, whisper_tiny)
from .base import (SHAPES, BlockDesc, MLAConfig, ModelConfig,  # noqa: F401
                   MoEConfig, ShapeConfig, applicable_shapes)

_REGISTRY = {
    "mistral-nemo-12b": mistral_nemo_12b.make_config,
    "mistral-large-123b": mistral_large_123b.make_config,
    "llama3.2-3b": llama32_3b.make_config,
    "llama3.2-1b": llama32_1b.make_config,
    "rwkv6-1.6b": rwkv6_1b6.make_config,
    "deepseek-v2-236b": deepseek_v2_236b.make_config,
    "granite-moe-3b-a800m": granite_moe_3b.make_config,
    "whisper-tiny": whisper_tiny.make_config,
    "llama-3.2-vision-90b": llama32_vision_90b.make_config,
    "jamba-v0.1-52b": jamba_52b.make_config,
}


def list_archs():
    return sorted(_REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {list_archs()}")
    return _REGISTRY[name]()
