"""Carry the JAX package's state across to the port, as numpy.

FCM has no weights: its state is the configuration, the problem arrays
(rows, weights, init centers) and the serving engine's histogram LRU.
These helpers take and give plain numpy and Python values, so neither
side imports the other.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from .core.fcm import FCMConfig
from .core.solver import FCMProblem

#: one LRU entry: (exact histogram key bytes, centers (c,), normalized
#: histogram (n_bins,))
CacheEntry = Tuple[bytes, np.ndarray, np.ndarray]


def config_from_numpy(fields: Dict[str, Any]) -> FCMConfig:
    """An :class:`FCMConfig` from a dict of the JAX config's fields
    (``dataclasses.asdict`` of ``repro.core.fcm.FCMConfig``); unknown
    keys raise."""
    known = {f.name for f in dataclasses.fields(FCMConfig)}
    extra = set(fields) - known
    if extra:
        raise ValueError(f"FCMConfig has no fields {sorted(extra)}")
    return FCMConfig(**fields)


def problem_from_numpy(features, weights=None, init=None, c: int = 4,
                       m: float = 2.0, device=None) -> FCMProblem:
    """A flat :class:`FCMProblem` from numpy rows ``(K,)`` / ``(K, D)``,
    optional ``(K,)`` weights and ``(c,)`` / ``(c, D)`` init centers,
    held as float32 on ``device`` (``None`` = the card)."""
    return FCMProblem(features=np.asarray(features),
                      weights=None if weights is None
                      else np.asarray(weights),
                      init=None if init is None else np.asarray(init),
                      c=int(c), m=float(m), device=device)


def cache_from_numpy(entries: Iterable[CacheEntry], engine=None
                     ) -> "collections.OrderedDict[bytes, Tuple[np.ndarray, np.ndarray]]":
    """The engine's LRU (oldest first) from ``(key, centers, normalized
    hist)`` entries, e.g. ``[(k, np.asarray(v), np.asarray(h)) for k,
    (v, h) in jax_engine._cache.items()]``. With ``engine`` given, the
    LRU replaces that engine's."""
    cache: "collections.OrderedDict[bytes, Tuple[np.ndarray, np.ndarray]]" \
        = collections.OrderedDict()
    for key, centers, hist in entries:
        cache[bytes(key)] = (np.asarray(centers, np.float32),
                             np.asarray(hist, np.float32))
    if engine is not None:
        while len(cache) > engine.cache_size:
            cache.popitem(last=False)
        engine._cache = cache
    return cache


def cache_to_numpy(engine) -> List[CacheEntry]:
    """The engine's LRU as ``(key, centers, normalized hist)`` entries,
    oldest first."""
    return [(k, np.array(v), np.array(h))
            for k, (v, h) in engine._cache.items()]
