"""Superpixel compression pipeline: N pixels -> K superpixels -> FCM.

The multi-channel analogue of the histogram route. For grayscale,
``core/histogram.py`` compresses N pixels to 256 (value, count) pairs;
for vector features no histogram exists, but a SLIC over-segmentation
plays the same role: K compact superpixels with mean features and
pixel counts are a weighted (K, D) FCM problem, and the per-iteration
cost drops from O(N c D) to O(K c D).

Pipeline: :func:`compress` (SLIC -> features/weights/label_map), then
:func:`repro_torch.core.solver.solve` on a
:func:`~repro_torch.core.solver.vector_problem` over the superpixel
rows, then a gather broadcasts each superpixel's cluster back through
the label map to full resolution.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..core import fcm as F
from ..core import solver as SV
from . import slic as SL


@dataclasses.dataclass(frozen=True)
class SuperpixelFCMConfig(F.FCMConfig):
    """FCM hyper-parameters plus the SLIC compression knobs."""
    n_segments: int = 256
    compactness: float = 10.0
    slic_iters: int = 10
    slic_tol: float = 0.25

    def slic_params(self) -> SL.SLICParams:
        return SL.SLICParams(n_segments=self.n_segments,
                             compactness=self.compactness,
                             max_iters=self.slic_iters, tol=self.slic_tol)


@dataclasses.dataclass
class SuperpixelCompression:
    """The compressed payload: everything FCM needs, nothing per-pixel.
    ``weights`` may contain zeros (superpixels that lost every pixel);
    zero-weight rows are inert in the weighted fit and unreachable
    through ``label_map``."""
    features: torch.Tensor     # (K, D) mean feature per superpixel
    weights: torch.Tensor      # (K,) pixel counts
    label_map: torch.Tensor    # (H, W) int32 pixel -> superpixel id
    gy: int
    gx: int
    slic_iters: int


def compress(img, cfg: SuperpixelFCMConfig = SuperpixelFCMConfig(),
             device=None) -> SuperpixelCompression:
    """SLIC-compress an (H, W) or (H, W, D) image on ``device`` (``None``
    = the card) to (features, weights, label_map). The superpixel mean
    features are the SLIC center rows' feature part (the update step
    maintains them)."""
    res = SL.fit_slic(img, cfg.slic_params(), device=device)
    n_feat = res.centers.shape[1] - 2
    return SuperpixelCompression(
        features=res.centers[:, :n_feat].contiguous(), weights=res.counts,
        label_map=res.labels, gy=res.gy, gx=res.gx, slic_iters=res.n_iters)


def broadcast_labels(sp_labels: torch.Tensor,
                     label_map: torch.Tensor) -> torch.Tensor:
    """Per-superpixel cluster ids (K,) -> per-pixel labels (H, W) via one
    gather through the superpixel map."""
    return sp_labels.to(torch.int32)[label_map.long()]


def fit_superpixel(img, cfg: SuperpixelFCMConfig = SuperpixelFCMConfig(),
                   comp: Optional[SuperpixelCompression] = None,
                   device=None) -> Tuple[F.FCMResult, SuperpixelCompression]:
    """End-to-end superpixel-compressed FCM segmentation on ``device``
    (``None`` = the card; a given ``comp`` is solved where it lies).

    Returns the :class:`~repro_torch.core.fcm.FCMResult` with
    full-resolution (H, W) labels plus the compression it rode on."""
    if comp is None:
        comp = compress(img, cfg, device=device)
    res = SV.solve(SV.vector_problem(comp.features, comp.weights, cfg,
                                     device=comp.features.device), cfg)
    labels = broadcast_labels(res.labels, comp.label_map)
    return F.FCMResult(centers=res.centers, labels=labels,
                       n_iters=res.n_iters, final_delta=res.final_delta,
                       membership=res.membership, converged=res.converged,
                       healthy=res.healthy), comp
