"""Whole-solve FCM_S: every lane's complete Eq. 4' / Eq. 3' fixed point in
one launch.

The CUDA kernel (``csrc/fcm_stencil.cu``) replaces the TPU's
VMEM-resident stencil whole-solve (``repro/kernels/fcm_resident.py::
resident_stencil_solve_pallas``): one thread-block cluster of at most 8
blocks a lane, each block re-reading its band of pixels and their
neighbors from device memory every iteration and the blocks' partial
sums meeting through distributed shared memory, until ``max|v' - v| <
tol`` or ``max_iters``. Each lane stops at its own convergence point, so
its trajectory is a solo solve's, and its bits do not depend on the
other lanes of the launch.

A lane uses at most 8 SMs, so one large lane leaves the card mostly
idle; past :data:`STENCIL_MAX_PIXELS` the solver and the spatial route
run the per-iteration step kernels of :mod:`.fcm_spatial` instead, which
spread one lane over every SM.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build
from .fcm_membership import exponent

#: what the kernel admits a lane (csrc/fcm_stencil.cu)
MAX_PIXELS = 1 << 20
MAX_C = 8

#: The dispatch bound: lanes of at most this many pixels take the
#: whole-solve under backend "auto" and in the spatial route; larger
#: lanes take the step kernels. Set from chip_smoke.py phase 7's sweep
#: of both paths at B=1 on noisy 2-D images, 18 iterations each (NVIDIA
#: H100 80GB HBM3, 700.00 W): whole-solve 0.794 / 2.399 / 8.154 ms
#: against the step kernels' host loop 4.186 / 4.228 / 4.232 ms at 2^16
#: / 2^18 / 2^20 pixels. A single lane runs on 8 SMs, so the whole-solve
#: grows with the pixels while the step path is host-bound.
STENCIL_MAX_PIXELS = 1 << 18


def stencil_solve_plain(x: torch.Tensor, v0: torch.Tensor, tol: torch.Tensor,
                        m: float, alpha: float, neighbors: int,
                        max_iters: int):
    """The plain PyTorch version: the per-lane-masked loop over the
    reference form of Eq. 3' (``v = sum u^m x_eff / max(sum u^m,
    1e-12)``, ``x_eff = (x + alpha * xbar) / (1 + alpha)`` hoisted out of
    the loop as the TPU kernel hoists it). Same contract as
    :func:`stencil_solve`."""
    from repro_torch.core import fcm as F
    from repro_torch.core import solver as SV
    from repro_torch.core import spatial as SP
    b, c = v0.shape
    x = x.to(torch.float32)
    _, xbar = SP.neighbor_mean(x, neighbors, batched=True)
    x_eff = ((x + alpha * xbar) / (1.0 + alpha)).reshape(b, 1, -1)

    def step(v):
        d2, nb, _ = SP.neighbor_fields(x, v, neighbors, batched=True)
        um = F.membership_from_d2((d2 + alpha * nb).reshape(b, c, -1),
                                  m) ** m
        return (um * x_eff).sum(dim=-1) / torch.clamp(
            um.sum(dim=-1), min=F._D2_FLOOR)

    v, delta, iters, _ = SV.masked_while_centers(step, v0, tol, max_iters)
    return v, delta, iters


def stencil_solve(x: torch.Tensor, v0: torch.Tensor, tol: torch.Tensor,
                  m: float, alpha: float, neighbors: int, max_iters: int):
    """``x`` (B, H, W) lanes with 4 or 8 neighbors, or (B, D, H, W) with
    6; ``v0`` (B, c) init centers; ``tol`` (B,) stop tolerances; all
    float32 -> ``(v (B, c), delta (B,), iters (B,) int32)``. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    if not ((x.dim() == 3 and neighbors in (4, 8))
            or (x.dim() == 4 and neighbors == 6)):
        raise ValueError(f"stencil_solve takes (B, H, W) lanes with 4 or 8 "
                         f"neighbors or (B, D, H, W) with 6, got "
                         f"{tuple(x.shape)} and {neighbors}")
    b = x.shape[0]
    if v0.dim() != 2 or v0.shape[0] != b or tuple(tol.shape) != (b,):
        raise ValueError(f"stencil_solve takes v0 (B, c) and tol (B,), got "
                         f"{tuple(v0.shape)} and {tuple(tol.shape)}")
    if len({t.device for t in (x, v0, tol)}) != 1:
        raise ValueError("stencil_solve inputs must share one device")
    if x.device.type == "cpu":
        return stencil_solve_plain(x, v0, tol, m, alpha, neighbors,
                                   max_iters)
    if x.device.type != "cuda":
        raise ValueError(f"stencil_solve runs on cpu or cuda, not "
                         f"{x.device}")
    if any(t.dtype != torch.float32 for t in (x, v0, tol)):
        raise TypeError("the stencil whole-solve takes float32 inputs")
    if not all(t.is_contiguous() for t in (x, v0, tol)):
        raise ValueError("the stencil whole-solve needs contiguous inputs")
    depth, h, w = (1,) * (4 - x.dim()) + tuple(x.shape[1:])
    c = v0.shape[1]
    n = depth * h * w
    if not (1 <= n <= MAX_PIXELS and 1 <= c <= MAX_C and b <= 65535):
        raise ValueError(
            f"the stencil whole-solve holds pixels <= {MAX_PIXELS}, c <= "
            f"{MAX_C} a lane and 65535 lanes; got pixels={n}, c={c}, B={b}")
    v = torch.empty((b, c), dtype=torch.float32, device=x.device)
    delta = torch.empty((b,), dtype=torch.float32, device=x.device)
    iters = torch.empty((b,), dtype=torch.int32, device=x.device)
    if b:
        _build.check(_build.library().fcm_stencil_solve(
            x.data_ptr(), v0.data_ptr(), tol.data_ptr(), b, depth, h, w, c,
            neighbors, float(np.float32(alpha)),
            float(np.float32(1.0 + alpha)), float(np.float32(m)),
            exponent(m), int(max_iters), v.data_ptr(), delta.data_ptr(),
            iters.data_ptr(), _build.stream_of(x)), "fcm_stencil_solve")
        stencil_solve.launches += 1
    return v, delta, iters


#: kernel launches since the count was last set to 0
stencil_solve.launches = 0
