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
