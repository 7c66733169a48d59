"""SLIC superpixels in PyTorch (grid-seeded local k-means, gSLICr-style).

SLIC over-segments an image into K compact clusters by k-means in the
joint (feature, position) space, each pixel competing only among the
<= 9 centers of its own and the adjacent cells of a (gy, gx) seed grid,
so an iteration is O(N), not O(N K). The assignment and the center
update form one ``centers -> centers'`` fixed point, run by the solver
core's :func:`repro_torch.core.solver.while_centers`.

Distance (squared, per candidate center k):

    d2 = ||f_i - f_k||^2 + (compactness / S)^2 * ||p_i - p_k||^2

with ``S = sqrt(sy * sx)`` the seed-grid interval.

The assignment is registered in :mod:`repro_torch.kernels.ops` under
kind ``"slic_assign"``: on the card the SLIC kernel
(``csrc/slic_assign.cu``), on the CPU :func:`assign_ref`, its plain
version. Both add the distance terms in the same order and keep the
first minimum, so they agree bit for bit. The JAX package's
``use_pallas``, ``block_rows`` and ``interpret`` parameters (and
``auto_block_rows``) choose the TPU kernel's tiling and have no
counterpart here; :func:`fit_slic` takes ``device=`` like every entry
point of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .. import _device as DV
from ..core import solver as SV
from ..kernels import ops as kops

_BIG = 3.4e38


@dataclasses.dataclass(frozen=True)
class SLICParams:
    """``n_segments`` is the *target* K; the actual K = gy * gx comes
    from :func:`grid_shape` and matches the image aspect. ``tol`` is the
    max center movement (joint feature/pixel units) that counts as
    converged."""
    n_segments: int = 256
    compactness: float = 10.0
    max_iters: int = 10
    tol: float = 0.25


@dataclasses.dataclass
class SLICResult:
    labels: torch.Tensor       # (H, W) int32 superpixel ids in [0, K)
    centers: torch.Tensor      # (K, D+2) rows [features..., y, x]
    counts: torch.Tensor       # (K,) pixels per superpixel (may be 0)
    gy: int
    gx: int
    n_iters: int
    final_delta: float


def _as_hwd(img: torch.Tensor) -> torch.Tensor:
    """Promote (H, W) grayscale to (H, W, 1), as float32."""
    img = img.to(torch.float32)
    if img.dim() == 2:
        img = img[:, :, None]
    if img.dim() != 3:
        raise ValueError(f"SLIC needs (H, W) or (H, W, D) input, "
                         f"got shape {tuple(img.shape)}")
    return img


def _coords(h: int, w: int, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each pixel's row and column as float32, (H, W) each."""
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    return yy.expand(h, w), xx.expand(h, w)


def grid_shape(h: int, w: int, n_segments: int) -> Tuple[int, int]:
    """Seed-grid dims (gy, gx) with roughly square cells and
    gy * gx ~ n_segments."""
    step = max((h * w / max(n_segments, 1)) ** 0.5, 1.0)
    return max(int(round(h / step)), 1), max(int(round(w / step)), 1)


def spatial_weight(h: int, w: int, gy: int, gx: int,
                   compactness: float) -> float:
    """(compactness / S)^2 for the joint distance, S the grid interval."""
    s2 = (h / gy) * (w / gx)
    return float(compactness) ** 2 / s2


def seed_centers(img: torch.Tensor, gy: int, gx: int) -> torch.Tensor:
    """Grid seeding: one center per cell at the cell-center pixel,
    features sampled there. Returns (gy*gx, D+2) rows [feat..., y, x]."""
    img = _as_hwd(img)
    h, w, _ = img.shape
    dev = img.device
    # float32 cell centres, truncated, as the reference computes them
    ys = torch.clamp(((torch.arange(gy, dtype=torch.float32, device=dev)
                       + 0.5) * (h / gy)).to(torch.int32), 0, h - 1)
    xs = torch.clamp(((torch.arange(gx, dtype=torch.float32, device=dev)
                       + 0.5) * (w / gx)).to(torch.int32), 0, w - 1)
    yy, xx = torch.meshgrid(ys.long(), xs.long(), indexing="ij")
    feats = img[yy, xx]                              # (gy, gx, D)
    pos = torch.stack([yy.to(torch.float32), xx.to(torch.float32)], dim=-1)
    return torch.cat([feats, pos], dim=-1).reshape(gy * gx, -1)


def assign_ref(img: torch.Tensor, centers: torch.Tensor, gy: int, gx: int,
               sw: float) -> torch.Tensor:
    """The plain assignment: each pixel's label is the argmin of the
    joint distance over the <= 9 centers of its 3x3 grid-cell
    neighbourhood (a running strict-< minimum in candidate order, so
    ties keep the lowest index). The cell coordinates multiply by the
    float32 reciprocal of the cell size, as the kernel does. Returns
    (H, W) int32 on ``img``'s device."""
    img = _as_hwd(img)
    h, w, d = img.shape
    dev = img.device
    grid = centers.to(torch.float32).reshape(gy, gx, d + 2)
    yy, xx = _coords(h, w, dev)
    inv_sy = float(np.float32(1.0 / (h / gy)))
    inv_sx = float(np.float32(1.0 / (w / gx)))
    pcy = torch.clamp((yy * inv_sy).to(torch.int32), 0, gy - 1)
    pcx = torch.clamp((xx * inv_sx).to(torch.int32), 0, gx - 1)
    best_d = torch.full((h, w), _BIG, dtype=torch.float32, device=dev)
    best_k = torch.zeros((h, w), dtype=torch.int32, device=dev)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            cyc = torch.clamp(pcy + dy, 0, gy - 1)
            cxc = torch.clamp(pcx + dx, 0, gx - 1)
            cand = grid[cyc.long(), cxc.long()]      # (H, W, D+2)
            d2 = torch.zeros((h, w), dtype=torch.float32, device=dev)
            for ch in range(d):                      # same order as kernel
                e = img[..., ch] - cand[..., ch]
                d2 = d2 + e * e
            ey = yy - cand[..., d]
            d2 = d2 + sw * (ey * ey)
            ex = xx - cand[..., d + 1]
            d2 = d2 + sw * (ex * ex)
            better = d2 < best_d
            best_d = torch.where(better, d2, best_d)
            best_k = torch.where(better, cyc * gx + cxc, best_k)
    return best_k


def update_centers(img: torch.Tensor, labels: torch.Tensor,
                   old: torch.Tensor):
    """Segment-sum center update: each superpixel's new row is the mean
    [feature..., y, x] of its pixels; empty superpixels keep their old
    row. Returns (centers (K, D+2), counts (K,)).

    The pixels are stably sorted by label and each superpixel's rows
    summed by ``segment_reduce`` in pixel order, with no atomics, so the
    sums repeat bit for bit on the card for any features (a scatter-add
    with float atomics would not, once sums stop being exact integers)
    and on the CPU add in the order of the JAX package's scatter-add."""
    img = _as_hwd(img)
    h, w, d = img.shape
    k = old.shape[0]
    yy, xx = _coords(h, w, img.device)
    fp = torch.cat([img, yy[..., None], xx[..., None]],
                   dim=-1).reshape(-1, d + 2)
    lab = labels.reshape(-1)        # int32: half the radix passes of int64
    order = torch.sort(lab, stable=True).indices
    lengths = torch.bincount(lab, minlength=k)
    sums = torch.segment_reduce(fp[order], "sum", lengths=lengths, axis=0,
                                unsafe=True)
    cnt = lengths.to(torch.float32)
    new = torch.where(cnt[:, None] > 0,
                      sums / torch.clamp(cnt, min=1.0)[:, None], old)
    return new, cnt


def fit_slic(img, params: SLICParams = SLICParams(),
             device=None) -> SLICResult:
    """Run SLIC to convergence (or ``max_iters``) on a 2-D grayscale or
    (H, W, D) multi-channel image, on ``device`` (``None`` = the card).
    The assignment is the registry's pick for the device (the SLIC
    kernel on the card): ``n_iters`` assignments in the loop and one for
    the final labels."""
    dev = DV.resolve_device(device)
    img = _as_hwd(DV.as_f32(img, dev))
    h, w, _ = img.shape
    gy, gx = grid_shape(h, w, params.n_segments)
    sw = spatial_weight(h, w, gy, gx, params.compactness)
    v0 = seed_centers(img, gy, gx)
    assign = kops.select_step("slic_assign", platform=dev.type).build(
        gy=gy, gx=gx, sw=sw)

    def step(v):
        return update_centers(img, assign(img, v), v)[0]

    v, delta, it = SV.while_centers(step, v0, params.tol, params.max_iters)
    labels = assign(img, v)
    _, counts = update_centers(img, labels, v)
    return SLICResult(labels=labels, centers=v, counts=counts, gy=gy, gx=gx,
                      n_iters=int(it), final_delta=float(delta))
