"""Batched multi-image FCM: any 8-bit image reduces to a fixed
``(n_bins,)`` weight vector, so B independent fits become one batched
weighted fixed point. The batched solve itself lives in
:func:`repro_torch.core.solver.flat_batched_solve`; this module keeps
the JAX package's entry points over it:

* :func:`fit_batched` and :func:`fit_batched_pixels`, deprecated thin
  adapters over :func:`repro_torch.core.solver.solve_batched`;
* :func:`build_sharded_batched_fit` / :func:`fit_batched_sharded`, the
  batch axis split over a :class:`~repro_torch.core.distributed.Mesh`.
  Lanes are independent images, so no shard waits on another: where
  :mod:`repro_torch.core.distributed` sums partials every iteration
  because it splits the pixels of one image, this splits images, and
  each shard runs its lanes' whole solve on its own device (the
  resident whole-solve kernel on a card, the masked plain loop on the
  CPU).

**Why the batch-sharded results are bit-equal** to one device's: a
lane's arithmetic and its reduction order come from its own rows alone,
never from the number of lanes beside it or from the card
(``fcm_centers.batched_plan``, ``fcm_resident.streamed_plan``; the
resident kernel gives a lane one block whatever B is), so a lane solved
in a shard of B / size lanes takes the same steps, in the same order, as
in the whole bucket. The paper's two-level reduction stays inside each
lane; only whole lanes are distributed.
"""
from __future__ import annotations

from functools import lru_cache
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from .. import _device as DV
from ..kernels import ops as kops
from . import distributed as DD
from . import fcm as F
from . import histogram as H
from . import solver as SV


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


def _lane_labels(xs: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(B, N) scalar rows and (B, c) centers -> (B, N) nearest-center
    labels (the plain ``labels_from_centers``, lane by lane)."""
    return F.labels_from_centers(xs[..., None], centers[..., None])


# ---------------------------------------------------------------------------
# Deprecated adapters
# ---------------------------------------------------------------------------

def fit_batched(imgs_or_hists: Union[torch.Tensor, np.ndarray, Sequence],
                cfg: F.FCMConfig = F.FCMConfig(), n_bins: int = 256,
                compute_labels: bool = True,
                device=None) -> SV.BatchedFCMResult:
    """DEPRECATED alias — use ``solver.solve_batched`` on a
    ``batch_problems(hist_rows(hists), hists, cfg=cfg)`` stack.

    Batched histogram-compressed FCM. ``imgs_or_hists`` is a ``(B,
    n_bins)`` array of histograms, or a sequence of images (any shapes,
    each flattened and histogrammed on ingest, and then labelled per
    pixel). On ``device`` (``None`` = the card)."""
    SV.warn_deprecated("fit_batched",
                       "solver.solve_batched(batch_problems(...))")
    dev = DV.resolve_device(device)
    imgs: Optional[List[np.ndarray]] = None
    if (isinstance(imgs_or_hists, (torch.Tensor, np.ndarray))
            and imgs_or_hists.ndim == 2
            and imgs_or_hists.shape[1] == n_bins):
        hists = DV.as_f32(imgs_or_hists, dev)
    else:
        imgs = [np.asarray(im) for im in imgs_or_hists]
        hists = histograms_of(imgs, n_bins, device=dev)
    res = SV.solve_batched(
        SV.batch_problems(hist_rows(hists), hists, cfg=cfg, device=dev), cfg)
    if imgs is not None and compute_labels:
        # an n_bins-entry table per image: every bin labelled once, then
        # gathered over the pixels
        luts = _lane_labels(hist_rows(hists), res.centers).cpu().numpy()
        res.labels = [luts[i][np.clip(im.astype(np.int64), 0, n_bins - 1)]
                      for i, im in enumerate(imgs)]
    return res


def fit_batched_pixels(xs, cfg: F.FCMConfig = F.FCMConfig(),
                       compute_labels: bool = True,
                       device=None) -> SV.BatchedFCMResult:
    """DEPRECATED alias — use ``solver.solve_batched`` on a
    ``batch_problems(xs, cfg=cfg)`` stack.

    Batched FCM over a same-shape pixel batch ``(B, N)`` (or (B, H, W),
    flattened), for float data that does not quantize to bins. On
    ``device`` (``None`` = the card)."""
    SV.warn_deprecated("fit_batched_pixels",
                       "solver.solve_batched(batch_problems(xs))")
    dev = DV.resolve_device(device)
    xs = DV.as_f32(xs, dev)
    xs = xs.reshape(xs.shape[0], -1)
    res = SV.solve_batched(SV.batch_problems(xs, cfg=cfg, device=dev), cfg)
    if compute_labels:
        res.labels = list(_lane_labels(xs, res.centers).cpu().numpy())
    return res


# ---------------------------------------------------------------------------
# The batch axis split over a mesh
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def build_sharded_batched_fit(mesh: DD.Mesh,
                              cfg: F.FCMConfig = F.FCMConfig(),
                              max_iters: Optional[int] = None):
    """Returns ``fn(hists (B, n_bins), active (B,)) -> (centers (B, c),
    delta (B,), iters (B,))`` on the mesh's lead device, cached on
    ``(mesh, cfg, max_iters)`` as the JAX package's is. B must divide by
    ``mesh.size``; each shard solves its lanes on its own device with no
    exchange between shards. On a card the shard's lanes take the
    resident whole-solve kernel, which runs every lane (padding lanes
    too, dropped by the caller); on the CPU the per-lane-masked plain
    loop, where ``active=False`` lanes start frozen."""
    c, m, eps = cfg.n_clusters, cfg.m, cfg.eps
    mi = cfg.max_iters if max_iters is None else max_iters

    def local_fit(hists, active):
        n_bins = hists.shape[1]
        impl = kops.select_step("flat", platform=hists.device.type,
                                batched=True, n_rows=n_bins, c=c).name
        v, delta, iters, _ = SV.flat_batched_solve(
            hist_rows(hists)[..., None], hists, c, m, eps, mi, impl=impl,
            active=None if impl.startswith("resident") else active)
        return v[..., 0], delta, iters

    mapped = DD.shard_map(local_fit, mesh=mesh)

    def fn(hists, active):
        outs = mapped(hists, active)
        return tuple(torch.cat([o[i].to(mesh.lead) for o in outs])
                     for i in range(3))

    return fn


def fit_batched_sharded(hists, mesh: DD.Mesh,
                        cfg: F.FCMConfig = F.FCMConfig()
                        ) -> SV.BatchedFCMResult:
    """Pads the batch of ``(B, n_bins)`` histograms to the mesh size
    (padding lanes are uniform histograms, masked inactive where the
    plain loop runs, and dropped on return), shards it, fits. Results on
    the mesh's lead device; ``total_iters`` is the largest real lane's
    iteration count."""
    hists = DV.as_f32(hists, mesh.lead)
    b = hists.shape[0]
    n_pad = (-b) % mesh.size
    active = torch.ones((b,), dtype=torch.bool, device=mesh.lead)
    if n_pad:
        hists = torch.cat([hists, torch.ones((n_pad, hists.shape[1]),
                                             dtype=torch.float32,
                                             device=mesh.lead)])
        active = torch.cat([active, torch.zeros((n_pad,), dtype=torch.bool,
                                                device=mesh.lead)])
    v, delta, iters = build_sharded_batched_fit(mesh, cfg)(hists, active)
    n_iters = iters[:b].cpu().numpy()
    return SV.BatchedFCMResult(centers=v[:b], n_iters=n_iters,
                               final_delta=delta[:b].cpu().numpy(),
                               total_iters=int(n_iters.max()) if b else 0)
