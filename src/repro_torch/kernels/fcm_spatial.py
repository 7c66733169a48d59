"""One FCM_S step over a bucket of same-shape lanes: the Eq. 3' partial
sums ``num_j = sum_i u_ji^m (x_i + alpha * xbar_i)`` and ``den_j = sum_i
u_ji^m`` of every lane, with ``u`` the Eq. 4' membership on the
stencil-effective distances. The caller forms ``v' = num / max((1 +
alpha) den, 1e-12)``.

Two CUDA kernels (``csrc/fcm_spatial.cu``), each with its plain PyTorch
version beside it:

* :func:`spatial_partials_2d`, 4 or 8 neighbors over ``(B, H, W)``
  lanes (replaces ``repro/kernels/fcm_spatial.py::
  spatial_partials_pallas_2d``);
* :func:`spatial_partials_3d`, 6 neighbors over ``(B, D, H, W)`` lanes
  (replaces ``spatial_partials_pallas_3d``).

One thread a pixel; a block stages a 32 x 8 tile of one slice and its
one-pixel halo (and, in 3-D, the same tile of the slices above and
below) in shared memory, reduces it to per-block partials, and a second
launch folds each lane's partials in a fixed order: no float atomics,
and a lane's bits depend on its own shape and values only. The grid is
unpadded: each block masks its edge by coordinates, where the TPU
kernels pad to (8, 128) tiles and carry a validity sheet.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import _build
from .fcm_membership import MAX_C, exponent

#: the tile one block covers (csrc/fcm_spatial.cu): the partials scratch
#: holds one (2c,) row per tile and lane
TILE_W, TILE_H = 32, 8


def spatial_partials_plain(x: torch.Tensor, v: torch.Tensor, m: float,
                           alpha: float, neighbors: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of both kernels: ``x`` ``(B, *grid)``,
    ``v`` ``(B, c)`` -> ``(num (B, c), den (B, c))``, the TPU kernels'
    form of Eq. 3' (``x + alpha * xbar`` summed; the ``1 + alpha``
    divisor is the caller's)."""
    from repro_torch.core import fcm as F
    from repro_torch.core import spatial as SP
    b, c = v.shape
    d2, nb, xbar = SP.neighbor_fields(x, v, neighbors, batched=True)
    u = F.membership_from_d2((d2 + alpha * nb).reshape(b, c, -1), m)
    um = u ** m
    xe = (x.to(torch.float32) + alpha * xbar).reshape(b, 1, -1)
    return (um * xe).sum(dim=-1), um.sum(dim=-1)


def _checked(what: str, x: torch.Tensor, v: torch.Tensor, rank: int) -> bool:
    """Shape, device, type and bound checks; True when the kernel runs (a
    CUDA tensor), False for the plain version (a CPU tensor)."""
    if x.dim() != rank or v.dim() != 2 or v.shape[0] != x.shape[0]:
        raise ValueError(f"{what} takes x of rank {rank} with a leading "
                         f"lane axis and v (B, c), got {tuple(x.shape)} "
                         f"and {tuple(v.shape)}")
    if x.device != v.device:
        raise ValueError(f"pixels on {x.device}, centers on {v.device}")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {x.device}")
    if x.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"the {what} kernel takes float32 inputs")
    if not (x.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"the {what} kernel needs contiguous inputs")
    b, c = v.shape
    if not (1 <= c <= MAX_C and 1 <= b <= 65535 and x.numel() > 0):
        raise ValueError(f"the {what} kernel takes 1 <= c <= {MAX_C}, 1 <= "
                         f"B <= 65535 and a non-empty grid, got c={c}, "
                         f"x {tuple(x.shape)}")
    return True


def _buffers(x: torch.Tensor, c: int, depth: int, h: int, w: int):
    """The per-tile partials scratch and the (B, 2c) output: each lane's
    c numerators, then its c denominators."""
    b = x.shape[0]
    n_tiles = depth * -(-h // TILE_H) * -(-w // TILE_W)
    part = torch.empty((b, n_tiles, 2 * c), dtype=torch.float32,
                       device=x.device)
    out = torch.empty((b, 2 * c), dtype=torch.float32, device=x.device)
    return part, out


def spatial_partials_2d(x: torch.Tensor, v: torch.Tensor, m: float,
                        alpha: float, neighbors: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` (B, H, W) lanes, ``v`` (B, c) centers, 4 or 8 neighbors ->
    ``(num (B, c), den (B, c))``. A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel (and its fold) or raises."""
    if neighbors not in (4, 8):
        raise ValueError(f"2-D neighborhoods are 4 or 8, got {neighbors}")
    if not _checked("spatial_partials_2d", x, v, 3):
        return spatial_partials_plain(x, v, m, alpha, neighbors)
    b, h, w = x.shape
    c = v.shape[1]
    part, out = _buffers(x, c, 1, h, w)
    _build.check(_build.library().fcm_spatial_partials_2d(
        x.data_ptr(), v.data_ptr(), b, h, w, c, neighbors,
        float(np.float32(alpha)), float(np.float32(m)), exponent(m),
        part.data_ptr(), out.data_ptr(), _build.stream_of(x)),
        "fcm_spatial_partials_2d")
    spatial_partials_2d.launches += 1
    return out[:, :c], out[:, c:]


def spatial_partials_3d(x: torch.Tensor, v: torch.Tensor, m: float,
                        alpha: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` (B, D, H, W) lanes, ``v`` (B, c) centers, the 6-connected
    stencil -> ``(num (B, c), den (B, c))``. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (and its fold) or
    raises."""
    if not _checked("spatial_partials_3d", x, v, 4):
        return spatial_partials_plain(x, v, m, alpha, 6)
    b, depth, h, w = x.shape
    c = v.shape[1]
    part, out = _buffers(x, c, depth, h, w)
    _build.check(_build.library().fcm_spatial_partials_3d(
        x.data_ptr(), v.data_ptr(), b, depth, h, w, c,
        float(np.float32(alpha)), float(np.float32(m)), exponent(m),
        part.data_ptr(), out.data_ptr(), _build.stream_of(x)),
        "fcm_spatial_partials_3d")
    spatial_partials_3d.launches += 1
    return out[:, :c], out[:, c:]


#: kernel launches (each a reduction and its fold) since the counts were
#: last set to 0
spatial_partials_2d.launches = 0
spatial_partials_3d.launches = 0
