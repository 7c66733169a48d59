"""Carry the JAX package's state across to the port, as numpy.

FCM has no weights: its state is the configuration (plain, FCM_S or
superpixel), the problem arrays (rows or pixel grids, weights, init
centers), the staged path's initial membership,
the serving engine's histogram LRU, and a solve's result. The language
models have parameters (:func:`lm_params_from_numpy`) and decode caches
(:func:`lm_cache_from_numpy`). These helpers
take and give plain numpy and Python values, so neither side imports
the other.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

import torch

from . import _device as DV
from .core.fcm import FCMConfig, FCMResult
from .core.solver import FCMProblem
from .core.spatial import SpatialFCMConfig
from .superpixel.pipeline import SuperpixelFCMConfig

#: one LRU entry: (exact histogram key bytes, centers (c,), normalized
#: histogram (n_bins,))
CacheEntry = Tuple[bytes, np.ndarray, np.ndarray]


def config_from_numpy(fields: Dict[str, Any]) -> FCMConfig:
    """An :class:`FCMConfig` from a dict of the JAX config's fields
    (``dataclasses.asdict`` of ``repro.core.fcm.FCMConfig``), a
    :class:`~repro_torch.core.spatial.SpatialFCMConfig` when the dict
    carries the FCM_S fields (``alpha``, ``neighbors``) of
    ``repro.core.spatial.SpatialFCMConfig``, or a
    :class:`~repro_torch.superpixel.pipeline.SuperpixelFCMConfig` when
    it carries the SLIC fields of ``repro.superpixel.pipeline.
    SuperpixelFCMConfig``; unknown keys raise."""
    classes = (FCMConfig, SpatialFCMConfig, SuperpixelFCMConfig)
    for cls in classes:
        if set(fields) <= {f.name for f in dataclasses.fields(cls)}:
            return cls(**fields)
    known = {f.name for cls in classes for f in dataclasses.fields(cls)}
    raise ValueError(f"no config has the fields "
                     f"{sorted(set(fields) - known)}")


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


def membership_from_numpy(u0, device=None) -> torch.Tensor:
    """A ``(c, N)`` membership (the staged path's ``u0``, e.g. one
    ``np.asarray`` of a JAX ``random_membership`` draw) as float32 on
    ``device`` (``None`` = the card)."""
    u = np.asarray(u0)
    if u.ndim != 2:
        raise ValueError(f"a membership is (c, N), got {u.shape}")
    return DV.as_f32(u, DV.resolve_device(device))


def result_to_numpy(result: FCMResult) -> Dict[str, Optional[np.ndarray]]:
    """A solve's ``centers``, ``labels`` and ``membership`` (``None``
    unless kept) as numpy arrays; its other fields are Python values
    already."""
    return {name: None if t is None else t.detach().cpu().numpy()
            for name, t in (("centers", result.centers),
                            ("labels", result.labels),
                            ("membership", result.membership))}


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


def _unstack(tree, n: int, dev: torch.device, what: str):
    """A JAX tree stacked on a leading axis of ``n`` as a list of ``n``
    trees of tensors on ``dev``."""
    def conv(a, g):
        if isinstance(a, dict):
            return {k: conv(v, g) for k, v in a.items()}
        arr = np.asarray(a)
        if arr.shape[:1] != (n,):
            raise ValueError(f"a {what} leaf of shape {arr.shape} does not "
                             f"lead with {n}")
        return torch.from_numpy(np.array(arr[g])).to(dev)

    return [conv(tree, g) for g in range(n)]


def lm_params_from_numpy(tree, cfg, device=None):
    """The port's language-model parameters from the JAX package's
    parameter pytree as numpy arrays (e.g. ``jax.tree.map(np.asarray,
    params)``): the same nested dicts with every leaf's dtype and layout
    kept, except that ``tree["groups"]``, stacked on a leading
    ``n_groups`` axis for the JAX package's scan, becomes a list of
    ``cfg.n_groups`` group dicts, and an encoder-decoder model's
    ``tree["enc_groups"]`` a list of ``cfg.enc_layers``. Leaves land on
    ``device`` (``None`` = the card)."""
    dev = DV.resolve_device(device)
    stacked = {"groups": (cfg.n_groups, "cfg.n_groups"),
               "enc_groups": (cfg.enc_layers, "cfg.enc_layers")}

    def conv(a):
        if isinstance(a, dict):
            return {k: conv(v) for k, v in a.items()}
        return torch.from_numpy(np.array(a)).to(dev)

    out = {}
    for k, v in tree.items():
        if k in stacked:
            n, name = stacked[k]
            out[k] = _unstack(v, n, dev, f"params[{k!r}] ({name})")
        else:
            out[k] = conv(v)
    return out


def lm_cache_from_numpy(tree, cfg, device=None):
    """The port's decode cache (:func:`repro_torch.models.lm.init_cache`'s
    list, one ``{"b0": block cache, ...}`` a group) from the JAX package's
    cache pytree as numpy arrays, stacked on a leading ``n_groups`` axis:
    every leaf a block holds (GQA's k / v, MLA's c_kv / k_rope, Mamba's
    conv / ssm, RWKV6's x_prev / wkv and cm_prev, cross_kv's k / v).
    Leaves keep their dtype and land on ``device`` (``None`` = the
    card)."""
    return _unstack(tree, cfg.n_groups, DV.resolve_device(device),
                    "cache (cfg.n_groups)")
