"""Deterministic sharded data pipeline for LM training.

Synthetic token streams (no external datasets) that are
*stateless*: batch contents are a pure function of (seed, step, global
position), so (a) every host generates exactly its own shard with zero
coordination, (b) restart/elastic re-mesh reproduces the identical
stream from the checkpointed step — data-parallel determinism is what
makes checkpoint/restart byte-reproducible.

The "language" is a Zipf-distributed token process with local n-gram
structure (next-token depends on previous token), so models actually
reduce loss on it — used by examples/torch_train_lm.py.

The port's own copy of the JAX package's pipeline: numpy only, the same
draws bit for bit. ``frames`` and ``image_embeds`` stay float32 numpy
arrays; the launcher moves every array to the device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from ..configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    zipf_a: float = 1.3
    mix: float = 0.7        # weight of the n-gram component


def _rng_for(seed: int, step: int, host: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed, step, host]))


def make_batch(cfg: ModelConfig, shape: ShapeConfig, step: int,
               dcfg: DataConfig = DataConfig(), host: int = 0,
               n_hosts: int = 1) -> Dict[str, np.ndarray]:
    """The host-local shard of the global batch for ``step``."""
    assert shape.global_batch % n_hosts == 0
    b = shape.global_batch // n_hosts
    s = shape.seq_len
    rng = _rng_for(dcfg.seed, step, host)
    v = cfg.vocab_size
    base = rng.zipf(dcfg.zipf_a, size=(b, s)).astype(np.int64) % v
    # first-order structure: with prob `mix`, token t = f(token_{t-1})
    shift = (base * 2654435761 + 12345) % v
    prev = np.roll(shift, 1, axis=1)
    gate = rng.random((b, s)) < dcfg.mix
    tokens = np.where(gate, prev, base).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = 0
    out = {"tokens": tokens, "labels": labels}
    if cfg.is_encdec:
        out["frames"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    if cfg.n_img_tokens:
        out["image_embeds"] = rng.standard_normal(
            (b, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    return out


def batches(cfg: ModelConfig, shape: ShapeConfig, start_step: int = 0,
            dcfg: DataConfig = DataConfig(), host: int = 0,
            n_hosts: int = 1) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield make_batch(cfg, shape, step, dcfg, host, n_hosts)
        step += 1
