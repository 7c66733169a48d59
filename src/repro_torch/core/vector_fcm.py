"""Weighted FCM over vector features (the multi-channel face of the
solver): any surjection pixels -> K groups with per-group mean features
and pixel counts is a weighted FCM over ``(K, D)`` rows, and the
superpixel subsystem (:mod:`repro_torch.superpixel`) supplies one. The
fixed point is :func:`repro_torch.core.solver.weighted_center_step`
under :func:`repro_torch.core.solver.solve` on a
:func:`~repro_torch.core.solver.vector_problem`; this module keeps the
JAX package's names for its pieces.
"""
from __future__ import annotations

import torch

from .. import _device as DV
from . import fcm as F
from . import solver as SV


def weighted_vector_center_step(feats: torch.Tensor, w: torch.Tensor,
                                v: torch.Tensor, m: float) -> torch.Tensor:
    """One fused v -> v' step over weighted feature rows; alias of
    :func:`repro_torch.core.solver.weighted_center_step`."""
    return SV.weighted_center_step(feats, w, v, m)


def weighted_support(feats: torch.Tensor, w: torch.Tensor):
    """Per-dimension (lo, hi) over rows with nonzero weight; see
    :func:`repro_torch.core.solver.weighted_support`."""
    return SV.weighted_support(feats, w)


def weighted_linspace_centers(feats: torch.Tensor, w: torch.Tensor,
                              c: int) -> torch.Tensor:
    """Per-dimension linspace init over the weighted support; (c, D)."""
    lo, hi = SV.weighted_support(feats, w)
    return SV.linspace_from_support(lo, hi, c)


def fit_vector_fcm(feats, weights=None, cfg: F.FCMConfig = F.FCMConfig(),
                   v0=None, keep_membership: bool = False,
                   device=None) -> F.FCMResult:
    """DEPRECATED alias — use
    ``solver.solve(solver.vector_problem(feats, weights, cfg))``.

    Weighted FCM over (K, D) feature rows (weights default to 1) on the
    plain loop, as the JAX package's adapter runs it; ``labels`` are
    per-row nearest centers. On ``device`` (``None`` = the card)."""
    SV.warn_deprecated("fit_vector_fcm",
                       "solver.solve(vector_problem(feats, weights, cfg))")
    feats = F._as_2d(DV.as_f32(feats, DV.resolve_device(device)))
    problem = SV.vector_problem(feats, weights, cfg, v0=v0,
                                device=feats.device)
    return SV.solve(problem, cfg, backend="reference",
                    keep_membership=keep_membership)


def fit_vector_batched(feats, weights, cfg: F.FCMConfig = F.FCMConfig(),
                       device=None) -> SV.BatchedFCMResult:
    """DEPRECATED alias — use ``solver.solve_batched`` on a
    ``solver.batch_problems(feats, weights, cfg=cfg)`` stack: (B, K, D)
    rows with (B, K) weights, each lane an independent problem. On
    ``device`` (``None`` = the card)."""
    SV.warn_deprecated("fit_vector_batched",
                       "solver.solve_batched(batch_problems(feats, weights))")
    return SV.solve_batched(SV.batch_problems(feats, weights, cfg=cfg,
                                              device=device), cfg)
