"""Batched multi-image FCM: any 8-bit image reduces to a fixed
``(n_bins,)`` weight vector, so B independent fits become one batched
weighted fixed point. The batched solve itself lives in
:func:`repro_torch.core.solver.flat_batched_solve`."""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import _device as DV
from . import histogram as H


def hist_rows(hists: torch.Tensor) -> torch.Tensor:
    """(B, n_bins) histograms -> the (B, n_bins) scalar bin-value rows
    they weigh (the batched histogram problem's features)."""
    b, n_bins = hists.shape
    vals = torch.arange(n_bins, dtype=torch.float32, device=hists.device)
    return vals[None, :].expand(b, n_bins)


def histograms_of(imgs: Sequence[np.ndarray], n_bins: int = 256,
                  device=None) -> torch.Tensor:
    """Stack per-image intensity histograms into (B, n_bins) float32 on
    ``device`` (``None`` = the card; binned there by the binning
    kernel)."""
    dev = DV.resolve_device(device)
    return torch.stack([H.intensity_histogram(
        DV.as_f32(np.asarray(im).ravel(), dev), n_bins) for im in imgs])
