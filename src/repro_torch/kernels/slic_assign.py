"""SLIC assignment: ``img`` (H, W, D) + ``centers`` (K, D+2) rows
``[features..., y, x]`` on a ``(gy, gx)`` seed grid -> (H, W) int32
labels, each pixel the argmin of the joint feature + ``sw``-weighted
spatial squared distance over the centers of its 3x3 grid-cell
neighbourhood.

The CUDA kernel (``csrc/slic_assign.cu``) replaces the TPU's
``repro/kernels/slic_assign.py::slic_assign_pallas``: one thread per
pixel scores its nine candidates against the center table held in
shared memory, in :func:`repro_torch.superpixel.slic.assign_ref`'s
order, which is its plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build

#: shared memory a block may use on Hopper; the center table must fit
MAX_CENTER_BYTES = 232448


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
    if centers.numel() * 4 > MAX_CENTER_BYTES:
        raise ValueError(f"the SLIC kernel holds the center table in shared "
                         f"memory: K (D + 2) * 4 B <= {MAX_CENTER_BYTES}, "
                         f"got K={gy * gx}, D={d}")
    out = torch.empty((h, w), dtype=torch.int32, device=img.device)
    if h and w:
        # The cell reciprocals as assign_ref forms them: a Python float,
        # rounded once to float32.
        inv_sy = float(np.float32(1.0 / (h / gy)))
        inv_sx = float(np.float32(1.0 / (w / gx)))
        _build.check(_build.library().slic_assign(
            img.data_ptr(), h, w, d, centers.data_ptr(), gy, gx, inv_sy,
            inv_sx, float(np.float32(sw)), out.data_ptr(),
            _build.stream_of(img)), "slic_assign")
        slic_assign.launches += 1
    return out


#: kernel launches since the count was last set to 0
slic_assign.launches = 0
