"""Configurations the port serves: the paper's FCM job
(:mod:`fcm_brainweb`) and the language-model architectures the port
runs, by name through :func:`get_config` (jamba-v0.1-52b so far; the
JAX package's other archs need modules the port has not yet)."""
from . import base, fcm_brainweb, jamba_52b  # noqa: F401
from .base import (SHAPES, BlockDesc, MLAConfig, ModelConfig,  # noqa: F401
                   MoEConfig, ShapeConfig, applicable_shapes)

_REGISTRY = {
    "jamba-v0.1-52b": jamba_52b.make_config,
}


def list_archs():
    return sorted(_REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; the port runs "
                       f"{list_archs()}")
    return _REGISTRY[name]()
