"""A frozen, vectorised copy of the port's BrainWeb-like phantom.

The same anatomy as ``repro_torch/data/phantom.py`` (background, a CSF
rim with ventricles, a grey-matter ribbon, a two-lobed white-matter
core, each class a constant T1-like mean), with Gaussian noise and
salt-and-pepper impulses; the benchmark keeps its own copy so that a
change to the program cannot move its inputs. Whole volumes are drawn
in a few PyTorch calls on the run's device from a seeded
``torch.Generator``, so a pool of BrainWeb-size volumes takes a fraction
of a second on the card. The noise is drawn volume-wide, so the pixels
are not those of the port's per-slice seeds; the statistics are.

Classes: 0 background, 1 CSF, 2 GM, 3 WM.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _ellipse(yy, xx, cy, cx, ry, rx):
    return ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0


def slice_positions(depth: int, lo: float, hi: float) -> np.ndarray:
    """Axial positions of a ``depth``-slice stack over [lo, hi), as the
    port's volume stacks them (``lo + (hi - lo) * z / depth``)."""
    return lo + (hi - lo) * np.arange(depth, dtype=np.float64) / depth


def labels_volume(height: int, width: int, positions: Sequence[float],
                  scale: float = 1.0,
                  device: torch.device = torch.device("cpu")
                  ) -> torch.Tensor:
    """The noise-free anatomy of every slice: int8 (D, H, W) classes.
    A slice's anatomy scales with its position (0.75 + 0.5 * pos), and
    the whole head with ``scale``."""
    h, w = height, width
    f64 = dict(dtype=torch.float64, device=device)
    yy = torch.arange(h, **f64)[None, :, None]
    xx = torch.arange(w, **f64)[None, None, :]
    s = (scale * (0.75 + 0.5 * torch.as_tensor(
        np.asarray(positions, np.float64), **f64)))[:, None, None]
    cy, cx = h / 2.0, w / 2.0
    lab = torch.zeros((len(s), h, w), dtype=torch.int8, device=device)
    lab[_ellipse(yy, xx, cy, cx, 0.46 * h * s, 0.42 * w * s)] = 1
    gm = _ellipse(yy, xx, cy, cx, 0.42 * h * s, 0.38 * w * s)
    lab[gm] = 2
    wm = (_ellipse(yy, xx, cy, cx - 0.10 * w, 0.30 * h * s, 0.20 * w * s)
          | _ellipse(yy, xx, cy, cx + 0.10 * w, 0.30 * h * s, 0.20 * w * s))
    lab[wm & gm] = 3
    vent = (_ellipse(yy, xx, cy - 0.02 * h, cx - 0.08 * w, 0.09 * h * s,
                     0.035 * w * s)
            | _ellipse(yy, xx, cy - 0.02 * h, cx + 0.08 * w, 0.09 * h * s,
                       0.035 * w * s))
    lab[vent] = 1
    return lab


def noisy_volume(labels: torch.Tensor, class_means: Sequence[float],
                 sigma: float, impulse: float,
                 gen: torch.Generator) -> torch.Tensor:
    """uint8 (D, H, W) intensities of ``labels``, on their device: each
    class's mean plus Gaussian noise of ``sigma`` (a quarter of it,
    about 0, in the skull-stripped background), clipped to [0, 255] and
    truncated to uint8; then, per slice, ``round(impulse * H * W)``
    pixels drawn without replacement set to 255 or 0, half and half."""
    dev = labels.device
    lab = labels.long()
    means = torch.as_tensor(list(class_means), dtype=torch.float32,
                            device=dev)
    sd = torch.where(lab == 0, 0.25 * sigma, sigma).float()
    noise = torch.randn(lab.shape, generator=gen, device=dev)
    img = torch.where(lab == 0, 0.0, means[lab]) + sd * noise
    vol = img.clamp_(0, 255).to(torch.uint8)
    if impulse > 0:
        d = vol.shape[0]
        n = vol[0].numel()
        k = int(round(impulse * n))
        if k:
            idx = torch.rand((d, n), generator=gen, device=dev).topk(
                k, dim=1).indices
            salt = torch.rand((d, k), generator=gen, device=dev) < 0.5
            vals = torch.where(salt, 255, 0).to(torch.uint8)
            vol.view(d, n).scatter_(1, idx, vals)
    return vol
