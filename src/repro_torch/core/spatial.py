"""Spatially-regularized Fuzzy C-Means (FCM_S, Ahmed-style), the plain
PyTorch math.

Plain FCM on pixels ignores where a pixel lies, so an impulse-noise
pixel lands in whichever cluster its corrupted intensity is nearest to.
FCM_S adds a neighborhood penalty to the objective,

    J = sum_ji u_ji^m [ d2_ji + (alpha/|N_i|) sum_{r in N_i} d2_jr ]

which changes the two update equations to

    u_ji  ∝ (d2_ji + alpha * mean_{r in N_i} d2_jr)^(-1/(m-1))      (Eq. 4')
    v_j   = sum_i u_ji^m (x_i + alpha * xbar_i)
            / ((1 + alpha) sum_i u_ji^m)                            (Eq. 3')

with ``xbar_i`` the mean intensity of pixel i's neighborhood. Border
pixels use their true (smaller) neighborhoods: |N_i| is per pixel.
Neighborhoods are 4- or 8-connected for 2-D slices, 6-connected for 3-D
volumes. With ``alpha = 0`` every formula is plain FCM, bit for bit.

These are the plain versions the solver's ``"reference"`` stencil step
runs, and the math the stencil kernels (``kernels/fcm_spatial.py``,
``kernels/fcm_stencil.py``) follow term by term. Every function takes
one grid ``(H, W)`` / ``(D, H, W)`` with centers ``(c,)``, or with
``batched=True`` a stack of same-shape lanes ``(B, *grid)`` with
centers ``(B, c)``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from . import fcm as F

OFFSETS_2D_4 = ((-1, 0), (1, 0), (0, -1), (0, 1))
OFFSETS_2D_8 = OFFSETS_2D_4 + ((-1, -1), (-1, 1), (1, -1), (1, 1))
OFFSETS_3D_6 = ((-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
                (0, 0, -1), (0, 0, 1))


@dataclasses.dataclass(frozen=True)
class SpatialFCMConfig(F.FCMConfig):
    """FCM_S hyper-parameters on top of the plain-FCM set.

    ``alpha`` weighs the neighborhood term (0 = plain FCM); ``neighbors``
    is the 2-D stencil arity (4 or 8); 3-D volumes always use the
    6-connected stencil.
    """
    alpha: float = 1.0
    neighbors: int = 4


def neighbor_offsets(ndim: int, neighbors: int) -> Tuple[Tuple[int, ...], ...]:
    """The symmetric stencil offset set for a grid rank and arity, in
    the order every stencil sum runs."""
    if ndim == 2:
        if neighbors == 4:
            return OFFSETS_2D_4
        if neighbors == 8:
            return OFFSETS_2D_8
        raise ValueError(f"2-D neighborhoods are 4 or 8, got {neighbors}")
    if ndim == 3:
        if neighbors != 6:
            raise ValueError(f"3-D neighborhoods are 6-connected, "
                             f"got {neighbors}")
        return OFFSETS_3D_6
    raise ValueError(f"expected a 2-D image or 3-D volume, rank {ndim}")


def _shift(a: torch.Tensor, off: Tuple[int, ...]) -> torch.Tensor:
    """Zero-filled shift of the trailing ``len(off)`` axes:
    ``out[i] = a[i - off]``, 0 where ``i - off`` leaves the grid."""
    out = torch.zeros_like(a)
    lead = a.dim() - len(off)
    dst = [slice(None)] * lead
    src = [slice(None)] * lead
    for ax, o in enumerate(off):
        n = a.shape[lead + ax]
        if abs(o) >= n:
            return out
        dst.append(slice(o, n) if o >= 0 else slice(0, n + o))
        src.append(slice(0, n - o) if o >= 0 else slice(-o, n))
    out[tuple(dst)] = a[tuple(src)]
    return out


def _grid_ndim(img: torch.Tensor, batched: bool) -> int:
    return img.dim() - (1 if batched else 0)


def neighbor_mean(img: torch.Tensor, neighbors: int, batched: bool = False):
    """The iteration-invariant stencil fields: ``(cnt, xbar)``, each
    pixel's in-grid neighbor count (at least 1) and its neighborhood mean
    intensity, shaped like ``img``."""
    img = img.to(torch.float32)
    w = torch.ones_like(img)
    cnt = torch.zeros_like(img)
    sx = torch.zeros_like(img)
    for off in neighbor_offsets(_grid_ndim(img, batched), neighbors):
        ws = _shift(w, off)
        cnt = cnt + ws
        sx = sx + ws * _shift(img, off)
    cnt = torch.clamp(cnt, min=1.0)
    return cnt, sx / cnt


def neighbor_fields(img: torch.Tensor, v: torch.Tensor, neighbors: int,
                    batched: bool = False):
    """The three stencil fields of FCM_S, by shifted arrays.

    Returns ``(d2, nb_d2_mean, xbar)``: the plain squared distances
    ``(c, *grid)``, the per-pixel neighborhood mean of the per-cluster
    squared distances (same shape) and the neighborhood mean intensity
    ``grid`` (with ``batched=True`` a leading lane axis on each). Borders
    average over the in-grid neighbors only."""
    img = img.to(torch.float32)
    v = v.to(torch.float32)
    ndim = _grid_ndim(img, batched)
    cax = 1 if batched else 0              # the cluster axis of d2
    vb = v.reshape(v.shape + (1,) * ndim)
    w = torch.ones_like(img)
    nb_d2 = torch.zeros(vb.shape[:cax + 1] + img.shape[cax:],
                        dtype=torch.float32, device=img.device)
    for off in neighbor_offsets(ndim, neighbors):
        xs = _shift(img, off).unsqueeze(cax)
        nb_d2 = nb_d2 + _shift(w, off).unsqueeze(cax) * (vb - xs) ** 2
    cnt, xbar = neighbor_mean(img, neighbors, batched)
    d2 = (vb - img.unsqueeze(cax)) ** 2
    return d2, nb_d2 / cnt.unsqueeze(cax), xbar


def spatial_membership(img: torch.Tensor, v: torch.Tensor, m: float = 2.0,
                       alpha: float = 1.0, neighbors: int = 4,
                       batched: bool = False) -> torch.Tensor:
    """Eq. 4' memberships from the spatially-effective distances;
    shape ``(c, *grid)`` (``(B, c, *grid)`` batched)."""
    d2, nb, _ = neighbor_fields(img, v, neighbors, batched)
    d2e = d2 + alpha * nb
    lead = 2 if batched else 1             # (B,) c or c
    flat = d2e.reshape(d2e.shape[:lead] + (-1,))
    return F.membership_from_d2(flat, m).reshape(d2e.shape)


def spatial_center_step(img: torch.Tensor, v: torch.Tensor, m: float = 2.0,
                        alpha: float = 1.0, neighbors: int = 4,
                        batched: bool = False) -> torch.Tensor:
    """One fused ``v -> v'`` FCM_S iteration: Eq. 3' as plain Eq. 3 on
    the effective pixels ``(x + alpha * xbar) / (1 + alpha)``, through
    :func:`repro_torch.core.fcm.update_centers` (so ``alpha = 0`` is
    the plain fused step). ``(c,)`` centers, ``(B, c)`` batched."""
    d2, nb, xbar = neighbor_fields(img, v, neighbors, batched)
    x_eff = (img.to(torch.float32) + alpha * xbar) / (1.0 + alpha)
    if not batched:
        c = v.shape[0]
        u = F.membership_from_d2((d2 + alpha * nb).reshape(c, -1), m)
        return F.update_centers(x_eff.reshape(-1), u, m)
    b, c = v.shape
    u = F.membership_from_d2((d2 + alpha * nb).reshape(b, c, -1), m)
    um = u ** m
    num = (um * x_eff.reshape(b, 1, -1)).sum(dim=-1)
    return num / torch.clamp(um.sum(dim=-1), min=F._D2_FLOOR)


# ---------------------------------------------------------------------------
# Deprecated adapter over the solver
# ---------------------------------------------------------------------------

def fit_spatial(img, cfg: SpatialFCMConfig = SpatialFCMConfig(),
                use_pallas: bool = False, v0=None,
                keep_membership: bool = False, device=None) -> F.FCMResult:
    """DEPRECATED alias — use
    ``solver.solve(solver.spatial_problem(img, cfg))``.

    FCM_S over a 2-D image or 3-D volume; ``labels`` (and ``membership``
    when kept) keep the grid's shape. ``use_pallas=True`` runs the
    stencil kernels on a card (``backend="auto"``, the counterpart of
    the JAX package's ``"pallas"``), else the plain loop. The JAX
    adapter's ``block_rows`` and ``interpret`` tune its Pallas kernel and
    have no counterpart here. On ``device`` (``None`` = the card)."""
    from .. import _device as DV
    from . import solver as SV
    SV.warn_deprecated("fit_spatial",
                       "solver.solve(spatial_problem(img, cfg))")
    img = DV.as_f32(img, DV.resolve_device(device))
    if img.dim() not in (2, 3):
        raise ValueError(f"fit_spatial needs (H, W) or (D, H, W) input, "
                         f"got shape {tuple(img.shape)}")
    return SV.solve(SV.spatial_problem(img, cfg, v0=v0, device=img.device),
                    cfg, backend="auto" if use_pallas else "reference",
                    keep_membership=keep_membership)
