"""Batched multi-image FCM: any 8-bit image reduces to a fixed
``(n_bins,)`` weight vector, so B independent fits become one batched
weighted fixed point. The batched solve itself lives in
:func:`repro_torch.core.solver.flat_batched_solve`."""
from __future__ import annotations

import torch


def hist_rows(hists: torch.Tensor) -> torch.Tensor:
    """(B, n_bins) histograms -> the (B, n_bins) scalar bin-value rows
    they weigh (the batched histogram problem's features)."""
    b, n_bins = hists.shape
    vals = torch.arange(n_bins, dtype=torch.float32, device=hists.device)
    return vals[None, :].expand(b, n_bins)
