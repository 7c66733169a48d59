"""Whole-solve weighted FCM: every lane's complete fixed point in one
launch.

The CUDA kernel (``csrc/fcm_resident.cu``) replaces the TPU's
VMEM-resident whole-solve (``repro/kernels/fcm_resident.py::
resident_solve_pallas``): one block per lane holds the lane's rows in
registers and iterates the weighted Eq. 4 -> Eq. 3 step until
``max|v' - v| < tol`` or ``max_iters``, with no launch and no trip to
device memory between iterations. Each lane stops at its own
convergence point, so its trajectory is a solo solve's.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build

#: Bounds of one lane (see the derivation in csrc/fcm_resident.cu): rows
#: stay in registers, 256 threads x 4 rows each.
MAX_ROWS = 1024
MAX_C = 8
MAX_FEAT = 8


def resident_solve_plain(x, w, v0, tol, m: float, max_iters: int):
    """The plain PyTorch version: the per-lane-masked reference loop
    (:func:`repro_torch.core.solver.masked_while_centers` over the
    batched weighted center step). Same contract as
    :func:`resident_solve`."""
    from repro_torch.core import solver as SV
    b, _, d = x.shape
    c = v0.shape[1]

    def step(vflat):
        return SV.weighted_center_step(x, w, vflat.reshape(b, c, d),
                                       m).reshape(b, c * d)

    v, delta, iters, _ = SV.masked_while_centers(
        step, v0.reshape(b, c * d), tol, max_iters)
    return v.reshape(b, c, d), delta, iters


def resident_solve(x: torch.Tensor, w: torch.Tensor, v0: torch.Tensor,
                   tol: torch.Tensor, m: float, max_iters: int):
    """x (B, K, D) rows, w (B, K) weights, v0 (B, c, D) init centers,
    tol (B,) stop tolerances, all float32 -> (v (B, c, D), delta (B,),
    iters (B,) int32). A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises."""
    if x.dim() != 3 or w.dim() != 2 or v0.dim() != 3 or tol.dim() != 1:
        raise ValueError("resident_solve takes x (B, K, D), w (B, K), "
                         "v0 (B, c, D), tol (B,)")
    b, k, d = x.shape
    c = v0.shape[1]
    if (tuple(w.shape) != (b, k) or tuple(v0.shape) != (b, c, d)
            or tuple(tol.shape) != (b,)):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, v0 {tuple(v0.shape)}, tol "
                         f"{tuple(tol.shape)}")
    if len({t.device for t in (x, w, v0, tol)}) != 1:
        raise ValueError("resident_solve inputs must share one device")
    if x.device.type == "cpu":
        return resident_solve_plain(x, w, v0, tol, m, max_iters)
    if x.device.type != "cuda":
        raise ValueError(f"resident_solve runs on cpu or cuda, not "
                         f"{x.device}")
    if any(t.dtype != torch.float32 for t in (x, w, v0, tol)):
        raise TypeError("the whole-solve kernel takes float32 inputs")
    if not all(t.is_contiguous() for t in (x, w, v0, tol)):
        raise ValueError("the whole-solve kernel needs contiguous inputs")
    if not (1 <= k <= MAX_ROWS and 1 <= c <= MAX_C and 1 <= d <= MAX_FEAT):
        raise ValueError(
            f"flat/resident holds rows <= {MAX_ROWS}, c <= {MAX_C}, "
            f"D <= {MAX_FEAT} a lane; got rows={k}, c={c}, D={d} (larger "
            f"flat problems need the HBM-streamed whole-solve, "
            f"resident_streamed, which is not ported yet)")
    v = torch.empty((b, c, d), dtype=torch.float32, device=x.device)
    delta = torch.empty((b,), dtype=torch.float32, device=x.device)
    iters = torch.empty((b,), dtype=torch.int32, device=x.device)
    if b:
        # The exponents as float32, computed as the reference does: the
        # Python float -1/(m-1), then rounded once.
        m32 = float(np.float32(m))
        expo = float(np.float32(-1.0 / (m - 1.0)))
        _build.check(_build.library().fcm_resident_solve(
            x.data_ptr(), w.data_ptr(), v0.data_ptr(), tol.data_ptr(), b, k,
            d, c, m32, expo, int(max_iters), v.data_ptr(), delta.data_ptr(),
            iters.data_ptr(), _build.stream_of(x)), "fcm_resident_solve")
        resident_solve.launches += 1
    return v, delta, iters


#: kernel launches since the count was last set to 0
resident_solve.launches = 0
