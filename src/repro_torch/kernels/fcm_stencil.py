"""Whole-solve FCM_S: every lane's complete Eq. 4' / Eq. 3' fixed point in
one launch.

The CUDA kernel (``csrc/fcm_stencil.cu``) replaces the TPU's
VMEM-resident stencil whole-solve (``repro/kernels/fcm_resident.py::
resident_stencil_solve_pallas``): one thread-block cluster of at most 8
blocks a lane, the blocks' partial sums meeting through distributed
shared memory, until ``max|v' - v| < tol`` or ``max_iters``. Where a
lane's bands of rows (planes) and their halos fit the blocks' shared
memory, the lane is held there for the whole solve (with its
iteration-invariant ``x_eff`` where that fits too); else each block
re-reads its band from device memory every iteration. :func:`stencil_plan`
picks the cluster size and the form from the lane's grid alone. Each
lane stops at its own convergence point, so its trajectory is a solo
solve's, and its bits do not depend on the other lanes of the launch.

A lane uses at most 8 SMs, so one large lane leaves the card mostly
idle; past :data:`STENCIL_MAX_PIXELS` the solver and the spatial route
run the per-iteration step kernels of :mod:`.fcm_spatial` instead, which
spread one lane over every SM.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _build
from .fcm_membership import exponent

#: what the kernel admits a lane (csrc/fcm_stencil.cu)
MAX_PIXELS = 1 << 20
MAX_C = 8
#: the lanes one launch takes (they sit on gridDim.y)
MAX_LANES = 65535
#: the most blocks a lane's cluster holds (the portable cluster size)
MAX_CLUSTER = 8
#: the shared memory a block of the on-chip form may take for its band:
#: the H100's 227 KB opt-in less 2 KB for the kernel's static arrays
SMEM_BUDGET = 227 * 1024 - 2048
#: a lane's cluster takes a block for each this many pixels (up to
#: MAX_CLUSTER), in either form, and on chip never fewer than fit
PIXELS_PER_BLOCK = 4096
#: the kernel's forms: every iteration re-reads the band from device
#: memory; the band and its halo held in shared memory, x_eff recomputed
#: each iteration; x_eff held there too
OFF_CHIP, ON_CHIP_X, ON_CHIP_X_EFF = 0, 1, 2


class StencilPlan(NamedTuple):
    """A lane's cluster size, form and on-chip shared memory a block."""
    ranks: int
    form: int
    smem_bytes: int


def onchip_bytes(depth: int, h: int, w: int, neighbors: int, ranks: int,
                 form: int) -> int:
    """Shared memory a block of a lane's cluster takes in ``form``: x of
    its band of rows (planes for 6 neighbors) and one halo row (plane) on
    each side, then in :data:`ON_CHIP_X_EFF` x_eff of the band; 0 off
    chip. The layout of ``csrc/fcm_stencil.cu``'s on-chip kernel."""
    if form == OFF_CHIP:
        return 0
    unit, n_units = (h * w, depth) if neighbors == 6 else (w, h)
    per = -(-n_units // ranks)
    return 4 * unit * (per + 2 + (per if form == ON_CHIP_X_EFF else 0))


def stencil_plan(depth: int, h: int, w: int, neighbors: int) -> StencilPlan:
    """The kernel's plan for a lane's grid, from the grid alone (never the
    batch, so a lane's bits are the same in any bucket). On chip with
    x_eff held if some cluster of at most :data:`MAX_CLUSTER` blocks (at
    most one a row or plane) has bands that fit :data:`SMEM_BUDGET`, else
    on chip with x alone if one fits so, else off chip. Either way a
    block for each :data:`PIXELS_PER_BLOCK` pixels, up to the cluster's
    top, and on chip never fewer blocks than fit."""
    if min(depth, h, w) < 1:
        raise ValueError(f"stencil_plan takes a non-empty grid, got "
                         f"{(depth, h, w)}")
    n = depth * h * w
    top = min(MAX_CLUSTER, depth if neighbors == 6 else h)
    for form in (ON_CHIP_X_EFF, ON_CHIP_X):
        fits = [r for r in range(1, top + 1) if onchip_bytes(
            depth, h, w, neighbors, r, form) <= SMEM_BUDGET]
        if fits:
            ranks = max(fits[0], min(top, -(-n // PIXELS_PER_BLOCK)))
            return StencilPlan(ranks, form, onchip_bytes(
                depth, h, w, neighbors, ranks, form))
    return StencilPlan(min(MAX_CLUSTER, -(-n // PIXELS_PER_BLOCK)),
                       OFF_CHIP, 0)

#: The dispatch bound: lanes of at most this many pixels take the
#: whole-solve under backend "auto" and in the spatial route; larger
#: lanes take the step kernels. Set from chip_smoke.py phase 7's sweep
#: of both paths at B=1 on noisy 2-D images, 18 iterations each, and held
#: by it (NVIDIA H100 80GB HBM3, 700.00 W): whole-solve
#: 1.056 / 1.788 / 9.465 ms against the step kernels' host loop 4.584 /
#: 3.980 / 4.407 ms at 2^16 / 2^18 / 2^20 pixels. A single lane runs on at
#: most 8 SMs, and 2^20 pixels fit no cluster's shared memory, so the
#: whole-solve grows with the pixels while the step path is host-bound.
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


def _checked(x: torch.Tensor, v0: torch.Tensor, tol: torch.Tensor,
             neighbors: int) -> bool:
    """Shapes, devices and types of :func:`stencil_solve`; True when the
    kernel runs (a CUDA tensor), False for the plain version (a CPU
    tensor)."""
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
        return False
    if x.device.type != "cuda":
        raise ValueError(f"stencil_solve runs on cpu or cuda, not "
                         f"{x.device}")
    if any(t.dtype != torch.float32 for t in (x, v0, tol)):
        raise TypeError("the stencil whole-solve takes float32 inputs")
    if not all(t.is_contiguous() for t in (x, v0, tol)):
        raise ValueError("the stencil whole-solve needs contiguous inputs")
    return True


def stencil_solve(x: torch.Tensor, v0: torch.Tensor, tol: torch.Tensor,
                  m: float, alpha: float, neighbors: int, max_iters: int):
    """``x`` (B, H, W) lanes with 4 or 8 neighbors, or (B, D, H, W) with
    6; ``v0`` (B, c) init centers; ``tol`` (B,) stop tolerances; all
    float32 -> ``(v (B, c), delta (B,), iters (B,) int32)``. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or
    raises. The kernel's lanes sit on ``gridDim.y``, so a bucket of more
    than :data:`MAX_LANES` lanes takes one launch a chunk of lanes; a
    lane's bits are its own, so the chunks do not change them."""
    if not _checked(x, v0, tol, neighbors):
        return stencil_solve_plain(x, v0, tol, m, alpha, neighbors,
                                   max_iters)
    b = x.shape[0]
    depth, h, w = (1,) * (4 - x.dim()) + tuple(x.shape[1:])
    c = v0.shape[1]
    n = depth * h * w
    if not (1 <= n <= MAX_PIXELS and 1 <= c <= MAX_C):
        raise ValueError(
            f"the stencil whole-solve holds pixels <= {MAX_PIXELS} and c <= "
            f"{MAX_C} a lane; got pixels={n}, c={c}")
    v = torch.empty((b, c), dtype=torch.float32, device=x.device)
    delta = torch.empty((b,), dtype=torch.float32, device=x.device)
    iters = torch.empty((b,), dtype=torch.int32, device=x.device)
    if b:
        plan = stencil_plan(depth, h, w, neighbors)
        lib = _build.library()
        for i0, i1 in _build.lane_chunks(b, MAX_LANES):
            with _build.on_device(x):
                _build.check(lib.fcm_stencil_solve(
                    x[i0:i1].data_ptr(), v0[i0:i1].data_ptr(),
                    tol[i0:i1].data_ptr(), i1 - i0, depth, h, w, c,
                    neighbors, float(np.float32(alpha)),
                    float(np.float32(1.0 + alpha)), float(np.float32(m)),
                    exponent(m), int(max_iters), plan.ranks, plan.form,
                    v[i0:i1].data_ptr(), delta[i0:i1].data_ptr(),
                    iters[i0:i1].data_ptr(), _build.stream_of(x)),
                    "fcm_stencil_solve")
            stencil_solve.launches += 1
    return v, delta, iters


#: kernel launches since the count was last set to 0: one a chunk of at
#: most MAX_LANES lanes, so one a call below 65536 lanes
stencil_solve.launches = 0
