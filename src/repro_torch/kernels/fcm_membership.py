"""Eq. 4 membership: ``(N,)`` scalar pixels + ``(c,)`` centers -> ``(c,
N)`` float32 memberships, cluster-major.

The CUDA kernel (``csrc/fcm_membership.cu``) replaces the TPU's
per-pixel membership kernel (``repro/kernels/fcm_membership.py::
membership_pallas``), the paper's one-kernel membership phase: one
thread per pixel, the centers in shared memory, each cluster's row of
``u`` written coalesced. The staged solve launches it once an
iteration.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build

#: clusters the kernel takes (a pixel's memberships live in registers)
MAX_C = 32


def exponent(m: float) -> float:
    """The Eq. 4 exponent ``-1/(m-1)`` as the float32 the kernels take:
    the Python float the plain version uses, rounded once."""
    return float(np.float32(-1.0 / (m - 1.0)))


def membership_plain(x: torch.Tensor, v: torch.Tensor,
                     m: float) -> torch.Tensor:
    """The plain PyTorch version:
    :func:`repro_torch.core.fcm.update_membership`."""
    from repro_torch.core import fcm as F
    return F.update_membership(x, v, m)


def membership(x: torch.Tensor, v: torch.Tensor, m: float) -> torch.Tensor:
    """``(N,)`` pixels and ``(c,)`` centers, float32 -> ``(c, N)``
    float32. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    if x.dim() != 1 or v.dim() != 1:
        raise ValueError(f"membership takes (N,) scalar pixels and (c,) "
                         f"centers, got {tuple(x.shape)} and "
                         f"{tuple(v.shape)}")
    if x.device != v.device:
        raise ValueError(f"pixels on {x.device}, centers on {v.device}")
    if x.device.type == "cpu":
        return membership_plain(x, v, m)
    if x.device.type != "cuda":
        raise ValueError(f"membership runs on cpu or cuda, not {x.device}")
    if x.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError("the membership kernel takes float32 inputs")
    if not (x.is_contiguous() and v.is_contiguous()):
        raise ValueError("the membership kernel needs contiguous inputs")
    n, c = x.shape[0], v.shape[0]
    if not 1 <= c <= MAX_C:
        raise ValueError(f"the membership kernel takes 1 <= c <= {MAX_C}, "
                         f"got c={c}")
    u = torch.empty((c, n), dtype=torch.float32, device=x.device)
    if n:
        with _build.on_device(x):
            _build.check(_build.library().fcm_membership(
                x.data_ptr(), n, v.data_ptr(), c, float(np.float32(m)),
                exponent(m), u.data_ptr(), _build.stream_of(x)),
                "fcm_membership")
        membership.launches += 1
    return u


#: kernel launches since the count was last set to 0
membership.launches = 0
