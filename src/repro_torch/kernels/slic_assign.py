"""SLIC assignment: ``img`` (H, W, D) + ``centers`` (K, D+2) rows
``[features..., y, x]`` on a ``(gy, gx)`` seed grid -> (H, W) int32
labels, each pixel the argmin of the joint feature + ``sw``-weighted
spatial squared distance over the centers of its 3x3 grid-cell
neighbourhood.

The CUDA kernel (``csrc/slic_assign.cu``) replaces the TPU's
``repro/kernels/slic_assign.py::slic_assign_pallas``: a block owns a
``TILE_W`` x ``TILE_H`` tile of the image, one thread a pixel, stages the
center rows its pixels can name (the cell window of
:func:`tile_cell_window`) in shared memory, and each thread scores
its nine candidates in :func:`repro_torch.superpixel.slic.assign_ref`'s
order, which is its plain version.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from . import _build

#: shared memory a block may use on Hopper; a tile's center window must
#: fit
MAX_CENTER_BYTES = 232448
#: the pixels one block covers, one thread each
TILE_W, TILE_H = 32, 8
#: cells a window may span along an axis beyond floor((t - 1) * inv):
#: a neighbour cell each side, and one each for the float32 rule's
#: truncation and rounding at the tile's two ends
WINDOW_SLACK = 5


def cell_reciprocals(h: int, w: int, gy: int, gx: int) -> Tuple[float, float]:
    """The float32 reciprocals of the cell sizes, as assign_ref forms them:
    a Python float, rounded once to float32."""
    return (float(np.float32(1.0 / (h / gy))),
            float(np.float32(1.0 / (w / gx))))


def cell_of(p: int, inv: float, g: int) -> int:
    """The cell of pixel coordinate ``p``: ``(int)(p * inv)`` in float32,
    clipped to ``[0, g)``, the kernel's and assign_ref's rule."""
    return min(max(int(np.float32(p) * np.float32(inv)), 0), g - 1)


def tile_cell_window(h: int, w: int, gy: int, gx: int, ty: int,
                     tx: int) -> Tuple[int, int, int, int]:
    """``(cy0, cy1, cx0, cx1)``, inclusive: the grid cells whose centers
    the pixels of tile ``(ty, tx)`` can name, the host twin of the
    kernel's window. The cell rule is monotone in y and x, so the tile's
    first and last pixels bound every pixel's cell; one neighbour cell
    each side, clipped to the grid."""
    inv_sy, inv_sx = cell_reciprocals(h, w, gy, gx)
    y0, x0 = ty * TILE_H, tx * TILE_W
    y1, x1 = min(y0 + TILE_H, h) - 1, min(x0 + TILE_W, w) - 1
    return (max(cell_of(y0, inv_sy, gy) - 1, 0),
            min(cell_of(y1, inv_sy, gy) + 1, gy - 1),
            max(cell_of(x0, inv_sx, gx) - 1, 0),
            min(cell_of(x1, inv_sx, gx) + 1, gx - 1))


def window_span(t: int, inv: float, g: int) -> int:
    """The most cells a tile of ``t`` pixels can name along an axis of
    ``g`` cells with reciprocal ``inv``: what a block's shared memory is
    sized for."""
    return min(g, math.floor((t - 1) * inv) + WINDOW_SLACK)


def smem_bytes(h: int, w: int, d: int, gy: int, gx: int) -> int:
    """Shared memory a block takes: the largest center window, float32
    (``h``, ``w`` set the cell reciprocals)."""
    inv_sy, inv_sx = cell_reciprocals(h, w, gy, gx)
    return 4 * (window_span(TILE_H, inv_sy, gy)
                * window_span(TILE_W, inv_sx, gx) * (d + 2))


@functools.lru_cache(maxsize=256)
def _launch_params(h: int, w: int, d: int, gy: int, gx: int):
    """The cell reciprocals and the shared memory a block takes, worked
    out once a shape: SLIC's host loop launches the kernel about eleven
    times a request at one shape."""
    return (*cell_reciprocals(h, w, gy, gx), smem_bytes(h, w, d, gy, gx))


def slic_assign_plain(img, centers, gy: int, gx: int, sw: float):
    """The plain PyTorch version, :func:`repro_torch.superpixel.slic.
    assign_ref`. Same contract as :func:`slic_assign`."""
    from repro_torch.superpixel import slic as SL
    return SL.assign_ref(img, centers, gy, gx, sw)


def slic_assign(img: torch.Tensor, centers: torch.Tensor, gy: int, gx: int,
                sw: float) -> torch.Tensor:
    """img (H, W, D) float32, centers (gy * gx, D + 2) float32 -> (H, W)
    int32. A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel or raises."""
    if img.dim() != 3 or centers.dim() != 2:
        raise ValueError(f"slic_assign takes img (H, W, D) and centers (K, "
                         f"D + 2), got {tuple(img.shape)} and "
                         f"{tuple(centers.shape)}")
    h, w, d = img.shape
    if tuple(centers.shape) != (gy * gx, d + 2):
        raise ValueError(f"centers must be (gy * gx, D + 2) = "
                         f"{(gy * gx, d + 2)}, got {tuple(centers.shape)}")
    if img.device != centers.device:
        raise ValueError(f"img on {img.device}, centers on {centers.device}")
    if img.device.type == "cpu":
        return slic_assign_plain(img, centers, gy, gx, sw)
    if img.device.type != "cuda":
        raise ValueError(f"slic_assign runs on cpu or cuda, not "
                         f"{img.device}")
    if img.dtype != torch.float32 or centers.dtype != torch.float32:
        raise TypeError("the SLIC kernel takes float32 inputs")
    if not (img.is_contiguous() and centers.is_contiguous()):
        raise ValueError("the SLIC kernel needs contiguous inputs")
    out = torch.empty((h, w), dtype=torch.int32, device=img.device)
    if h and w:
        inv_sy, inv_sx, need = _launch_params(h, w, d, gy, gx)
        if need > MAX_CENTER_BYTES or h > 65535 * TILE_H:
            raise ValueError(f"the SLIC kernel holds a tile's center window "
                             f"in shared memory: needs {need} "
                             f"B <= {MAX_CENTER_BYTES} and H <= "
                             f"{65535 * TILE_H}, got H={h}, W={w}, D={d}, "
                             f"K={gy * gx}")
        with _build.on_device(img):
            _build.check(_build.library().slic_assign(
                img.data_ptr(), h, w, d, centers.data_ptr(), gy, gx, inv_sy,
                inv_sx, float(np.float32(sw)), out.data_ptr(),
                _build.stream_of(img)), "slic_assign")
        slic_assign.launches += 1
    return out


#: kernel launches since the count was last set to 0
slic_assign.launches = 0
