"""Histogram-compressed FCM: 8-bit images have at most 256 distinct
intensities, so FCM over pixels is weighted FCM over (value, count)
pairs. One O(N) binning pass (the binning kernel on the card) replaces
the per-iteration O(N*c) traffic with O(256*c) arithmetic.
"""
from __future__ import annotations

import torch

from ..kernels import ops as kops
from . import fcm as F


def intensity_histogram(x: torch.Tensor, n_bins: int = 256,
                        clip: bool = False) -> torch.Tensor:
    """Counts per integer intensity of ``x`` (float-valued but integral),
    as an ``(n_bins,)`` float32 tensor on ``x``'s device.

    Binning clamps to [0, n_bins). Unless ``clip=True``, out-of-range
    values or a [0, 1]-normalized-looking float image raise
    ``ValueError`` first: such an image would pile every pixel into bins
    0/1 and the fit would segment garbage.
    """
    if not clip:
        lo = float(x.min())
        hi = float(x.max())
        if lo < 0.0 or hi > n_bins - 1:
            raise ValueError(
                f"intensity_histogram: values in [{lo:g}, {hi:g}] fall "
                f"outside the bin range [0, {n_bins - 1}]; rescale the "
                f"image or pass clip=True to clamp deliberately")
        if (n_bins > 2 and 0.0 < hi <= 1.0 and x.is_floating_point()
                and bool((x != torch.round(x)).any())):
            # integral float data in {0, 1} (a binary mask cast to float)
            # is legitimate; only fractional values betray a normalized
            # image
            raise ValueError(
                f"intensity_histogram: float values span [{lo:g}, {hi:g}] "
                f"— this looks like a [0, 1]-normalized image, which "
                f"would collapse into bins 0/1 of {n_bins}; multiply by "
                f"{n_bins - 1} first or pass clip=True to bin as-is")
    return kops.histogram_counts(x.reshape(-1), n_bins)


def weighted_center_step(vals: torch.Tensor, w: torch.Tensor,
                         v: torch.Tensor, m: float) -> torch.Tensor:
    """Fused v -> v' step over (value, weight) pairs — the scalar face of
    :func:`repro_torch.core.solver.weighted_center_step`."""
    from . import solver as SV
    out = SV.weighted_center_step(vals, w, F._as_2d(v), m)
    return out[:, 0] if v.dim() == 1 else out
