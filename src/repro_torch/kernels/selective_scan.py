"""The Mamba selective scan: for u, dt (B, S, di), B_t, C_t (B, S, ds)
and A (di, ds), float32,

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) * B_t,   h_0 = 0,
    y_t = <h_t, C_t>  (over ds)                   -> y (B, S, di).

:func:`selective_scan` launches the CUDA kernel (``csrc/selective_scan.cu``,
replacing ``repro/kernels/selective_scan.py::selective_scan_pallas``) on
CUDA tensors and runs :func:`selective_scan_ref`, the plain recurrence,
on CPU tensors. The kernel takes any S and di (the TPU kernel's
``S % seq_blk`` and ``di % di_tile`` are VMEM tilings) and d_state <= 32.
"""
from __future__ import annotations

import torch

from . import _build

#: the largest d_state the kernel takes (one state element a lane of a
#: group of at most one warp)
MAX_STATE = 32


def selective_scan_ref(u, dt, bmat, cmat, a):
    """The plain PyTorch version: the recurrence of
    :func:`repro_torch.models.ssm._ssm_scan`, one position at a time,
    with zero initial state and no skip term (differentiable: the
    Mamba layer's backward runs through it)."""
    from repro_torch.models.ssm import _ssm_scan
    b, _, di = u.shape
    h0 = torch.zeros((b, di, bmat.shape[-1]), dtype=torch.float32,
                     device=u.device)
    y, _ = _ssm_scan(u, dt, bmat, cmat, a,
                     torch.zeros((di,), dtype=torch.float32,
                                 device=u.device), h0)
    return y


def selective_scan(u, dt, bmat, cmat, a):
    """``u``, ``dt`` (B, S, di), ``bmat``, ``cmat`` (B, S, ds), ``a``
    (di, ds), float32 -> ``y`` (B, S, di) float32. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises."""
    if u.dim() != 3 or bmat.dim() != 3 or a.dim() != 2:
        raise ValueError("selective_scan takes u, dt (B, S, di), bmat, "
                         "cmat (B, S, ds), a (di, ds)")
    b, s, di = u.shape
    ds = a.shape[1]
    if (tuple(dt.shape) != (b, s, di) or tuple(bmat.shape) != (b, s, ds)
            or tuple(cmat.shape) != (b, s, ds) or a.shape[0] != di):
        raise ValueError(f"shape mismatch: u {tuple(u.shape)}, dt "
                         f"{tuple(dt.shape)}, bmat {tuple(bmat.shape)}, "
                         f"cmat {tuple(cmat.shape)}, a {tuple(a.shape)}")
    ins = (u, dt, bmat, cmat, a)
    if len({t.device for t in ins}) != 1:
        raise ValueError("selective_scan inputs must share one device")
    if u.device.type == "cpu":
        return selective_scan_ref(u, dt, bmat, cmat, a)
    if u.device.type != "cuda":
        raise ValueError(f"selective_scan runs on cpu or cuda, not "
                         f"{u.device}")
    if any(t.dtype != torch.float32 for t in ins):
        raise TypeError("the selective-scan kernel takes float32 inputs")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("the selective-scan kernel needs contiguous inputs")
    if not 1 <= ds <= MAX_STATE or not 1 <= b <= 65535:
        raise ValueError(f"the selective-scan kernel takes 1 <= d_state <= "
                         f"{MAX_STATE} and 1 <= B <= 65535, got d_state="
                         f"{ds}, B={b}")
    y = torch.empty((b, s, di), dtype=torch.float32, device=u.device)
    if s == 0 or di == 0:
        return y
    _build.check(_build.library().selective_scan_f32(
        u.data_ptr(), dt.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
        a.data_ptr(), b, s, di, ds, y.data_ptr(), _build.stream_of(u)),
        "selective_scan_f32")
    selective_scan.launches += 1
    return y


#: kernel launches since the count was last set to 0
selective_scan.launches = 0
