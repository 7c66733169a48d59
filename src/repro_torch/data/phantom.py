"""Synthetic digital brain phantom (BrainWeb-like) + metrics.

The paper segments the BrainWeb simulated brain phantom (Collins et al.
1998) into WM / GM / CSF / background. That dataset is not
redistributable, so this module synthesizes axial-slice-like images with
the same statistical structure: four piecewise-constant tissue classes
arranged as nested regions (background, CSF rim + ventricles, GM ribbon,
WM core) with additive Gaussian noise — plus exact ground-truth masks,
which is what the paper's DSC evaluation (Fig. 6/7) requires.

Classes: 0=background, 1=CSF, 2=GM, 3=WM.

The port keeps its own copy of the JAX package's phantom module (it is
plain numpy), so both packages draw identical phantoms from one seed.
"""
from __future__ import annotations

import numpy as np

N_CLASSES = 4
CLASS_NAMES = ("background", "CSF", "GM", "WM")
# Mean intensities roughly matching a T1 BrainWeb slice.
CLASS_MEANS = np.array([0.0, 52.0, 106.0, 168.0])
# Per-class (T1, T2, PD)-like channel means for the multi-modal phantom:
# CSF is dark on T1 but bright on T2/PD, WM the other way around — the
# contrast inversion that makes multi-channel clustering genuinely
# multi-dimensional (no single channel separates all four classes).
CLASS_MEANS_MULTI = np.array([
    [0.0, 0.0, 0.0],          # background
    [52.0, 230.0, 190.0],     # CSF
    [106.0, 120.0, 150.0],    # GM
    [168.0, 70.0, 110.0],     # WM
])
# A colorized-atlas-style RGB rendering of the same anatomy.
CLASS_MEANS_RGB = np.array([
    [0.0, 0.0, 0.0],          # background: black
    [50.0, 80.0, 200.0],      # CSF: blue
    [110.0, 200.0, 110.0],    # GM: green
    [230.0, 170.0, 60.0],     # WM: amber
])


def _ellipse(h, w, cy, cx, ry, rx, yy=None, xx=None):
    if yy is None:
        yy, xx = np.mgrid[0:h, 0:w]
    return ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0


def phantom_labels(height: int, width: int, slice_pos: float = 0.5):
    """The noise-free anatomy: int32 (H, W) class labels shared by every
    phantom flavor (grayscale, RGB, multi-modal).

    ``slice_pos`` in [0, 1] scales the anatomy like moving through axial
    slices (the paper shows the 91st/96th/101st/111th slices).
    """
    h, w = height, width
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = h / 2.0, w / 2.0
    scale = 0.75 + 0.5 * slice_pos          # anatomy grows/shrinks by slice

    labels = np.zeros((h, w), np.int32)
    # head outline: CSF-filled skull interior (skull itself stripped, as in
    # the paper's preprocessing)
    head = _ellipse(h, w, cy, cx, 0.46 * h * scale, 0.42 * w * scale, yy, xx)
    labels[head] = 1
    # GM ribbon
    gm = _ellipse(h, w, cy, cx, 0.42 * h * scale, 0.38 * w * scale, yy, xx)
    labels[gm] = 2
    # WM core (two lobes for a non-convex boundary)
    wm = (_ellipse(h, w, cy, cx - 0.10 * w, 0.30 * h * scale,
                   0.20 * w * scale, yy, xx)
          | _ellipse(h, w, cy, cx + 0.10 * w, 0.30 * h * scale,
                     0.20 * w * scale, yy, xx))
    labels[wm & gm] = 3
    # lateral ventricles: CSF pockets inside WM
    vent = (_ellipse(h, w, cy - 0.02 * h, cx - 0.08 * w, 0.09 * h * scale,
                     0.035 * w * scale, yy, xx)
            | _ellipse(h, w, cy - 0.02 * h, cx + 0.08 * w, 0.09 * h * scale,
                       0.035 * w * scale, yy, xx))
    labels[vent] = 1
    return labels


def phantom_slice(height: int = 217, width: int = 181,
                  slice_pos: float = 0.5, noise: float = 4.0,
                  seed: int = 0):
    """Returns (image uint8 (H, W), labels int32 (H, W))."""
    rng = np.random.default_rng(seed)
    h, w = height, width
    labels = phantom_labels(h, w, slice_pos)
    img = CLASS_MEANS[labels] + rng.normal(0.0, noise, size=(h, w))
    img = np.clip(img, 0, 255)
    # background stays exactly 0 outside the head (skull-stripped)
    img[labels == 0] = np.clip(
        rng.normal(0.0, noise * 0.25, size=(h, w)), 0, 255)[labels == 0]
    return img.astype(np.uint8), labels


def phantom_slice_channels(height: int = 217, width: int = 181,
                           slice_pos: float = 0.5, noise: float = 4.0,
                           seed: int = 0,
                           class_means: np.ndarray = CLASS_MEANS_MULTI):
    """Multi-channel phantom: (image uint8 (H, W, D), labels (H, W)).

    ``class_means`` is a (n_classes, D) table of per-class channel means
    (:data:`CLASS_MEANS_MULTI` for T1/T2/PD-like stacks,
    :data:`CLASS_MEANS_RGB` for the colorized rendering). Noise is
    i.i.d. per channel; background gets the same reduced-noise
    skull-stripped treatment as the grayscale phantom.
    """
    rng = np.random.default_rng(seed)
    h, w = height, width
    means = np.asarray(class_means, np.float64)
    d = means.shape[1]
    labels = phantom_labels(h, w, slice_pos)
    img = means[labels] + rng.normal(0.0, noise, size=(h, w, d))
    img = np.clip(img, 0, 255)
    bg = np.clip(rng.normal(0.0, noise * 0.25, size=(h, w, d)), 0, 255)
    img[labels == 0] = bg[labels == 0]
    return img.astype(np.uint8), labels


def phantom_slice_rgb(height: int = 217, width: int = 181,
                      slice_pos: float = 0.5, noise: float = 4.0,
                      seed: int = 0):
    """RGB phantom: (image uint8 (H, W, 3), labels (H, W))."""
    return phantom_slice_channels(height, width, slice_pos, noise, seed,
                                  class_means=CLASS_MEANS_RGB)


def add_impulse_noise(img: np.ndarray, frac: float = 0.05, seed: int = 0,
                      salt: int = 255, pepper: int = 0) -> np.ndarray:
    """Salt-and-pepper corruption: a ``frac`` fraction of pixels is
    replaced by ``salt`` or ``pepper`` (50/50). Returns a copy."""
    rng = np.random.default_rng(seed)
    out = np.array(img, copy=True)
    n = out.size
    k = int(round(frac * n))
    if k == 0:
        return out
    idx = rng.choice(n, size=k, replace=False)
    vals = np.where(rng.random(k) < 0.5, salt, pepper).astype(out.dtype)
    out.reshape(-1)[idx] = vals
    return out


# (gaussian sigma, salt-and-pepper fraction) sweep for the noise-
# robustness benchmark; the last level is the headline noisy-MRI case.
NOISE_LEVELS = ((4.0, 0.0), (8.0, 0.02), (12.0, 0.05), (16.0, 0.10))


def noisy_phantom_slice(height: int = 217, width: int = 181,
                        slice_pos: float = 0.5, noise: float = 12.0,
                        impulse: float = 0.05, seed: int = 0):
    """The noisy-MRI workload: a phantom slice with heavier Gaussian
    noise plus salt-and-pepper impulse corruption, and exact ground
    truth. Returns (image uint8 (H, W), labels int32 (H, W))."""
    img, labels = phantom_slice(height, width, slice_pos, noise, seed)
    return add_impulse_noise(img, impulse, seed=seed + 1), labels


def noisy_phantom_volume(depth: int = 8, height: int = 64, width: int = 64,
                         noise: float = 12.0, impulse: float = 0.05,
                         seed: int = 0):
    """A small noisy volume (stacked noisy slices with drifting anatomy)
    for the 3-D 6-neighbor spatial path. Returns (uint8 (D, H, W),
    int32 (D, H, W))."""
    imgs, labs = [], []
    for z in range(depth):
        im, la = noisy_phantom_slice(height, width,
                                     slice_pos=0.3 + 0.4 * z / max(depth, 1),
                                     noise=noise, impulse=impulse,
                                     seed=seed + z)
        imgs.append(im)
        labs.append(la)
    return np.stack(imgs), np.stack(labs)


def phantom_of_bytes(n_bytes: int, noise: float = 4.0, seed: int = 0):
    """A phantom whose uint8 image is exactly ``n_bytes`` (paper Table 3
    scales the dataset from 20 KB to 1 MB; 1 byte per pixel)."""
    width = 256
    height = max(n_bytes // width, 8)
    img, lab = phantom_slice(height, width, 0.5, noise, seed)
    img = img.ravel()[:n_bytes // width * width]
    lab = lab.ravel()[:img.size]
    return img, lab


def dice(pred_mask: np.ndarray, gt_mask: np.ndarray) -> float:
    """Dice Similarity Coefficient (paper Eq. 5)."""
    pred = np.asarray(pred_mask, bool)
    gt = np.asarray(gt_mask, bool)
    s = pred.sum() + gt.sum()
    if s == 0:
        return 1.0
    return 2.0 * np.logical_and(pred, gt).sum() / s


def dice_per_class(pred_labels, gt_labels, n_classes: int = N_CLASSES):
    """DSC per tissue class after matching predicted clusters to classes
    by mean intensity rank (FCM labels are permutation-arbitrary)."""
    return [dice(pred_labels == k, gt_labels == k) for k in range(n_classes)]


def match_labels_to_classes(labels, centers):
    """Relabel FCM clusters so cluster rank by center intensity matches
    class rank (background < CSF < GM < WM)."""
    order = np.argsort(np.asarray(centers).ravel())
    remap = np.empty_like(order)
    remap[order] = np.arange(len(order))
    return remap[np.asarray(labels)]


def match_labels_to_means(labels, centers, class_means):
    """Vector-feature analogue of :func:`match_labels_to_classes`: map
    each cluster to the class whose (D,)-mean row is nearest to the
    cluster's (D,) center. Intensity *rank* is meaningless for
    multi-modal contrast (CSF is dark on T1 but bright on T2), so the
    scalar matcher mis-ranks those; nearest-mean matching is
    contrast-agnostic. Non-injective maps are allowed (a degenerate fit
    may merge classes — DSC then punishes it)."""
    centers = np.asarray(centers, np.float64)
    if centers.ndim == 1:                    # scalar centers: (c,) -> (c, 1)
        centers = centers[:, None]
    means = np.asarray(class_means, np.float64)
    d2 = ((centers[:, None, :] - means[None, :, :]) ** 2).sum(-1)
    remap = np.argmin(d2, axis=1).astype(np.int64)
    return remap[np.asarray(labels)]
