"""The Mamba selective scan: for u, dt (B, S, di), B_t, C_t (B, S, ds)
and A (di, ds), float32,

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) * B_t,   h_0 = 0,
    y_t = <h_t, C_t>  (over ds)                   -> y (B, S, di).

:func:`selective_scan` launches the CUDA kernels (``csrc/selective_scan.cu``,
replacing ``repro/kernels/selective_scan.py::selective_scan_pallas``) on
CUDA tensors and runs :func:`selective_scan_ref`, the plain recurrence,
on CPU tensors. The kernels take any S and di (the TPU kernel's
``S % seq_blk`` and ``di % di_tile`` are VMEM tilings) and d_state <= 32.

The kernels run a chunked scan: S is cut into chunks of
:func:`chunk_len` positions, each walked from zero state (one launch),
the chunks' end states carried across in order (a second), and each
chunk walked again from its carried-in state to write y (a third); one
chunk takes the last launch alone. A call is one count of
``selective_scan.launches`` whatever its number of CUDA launches.

With ``return_state=True`` the call also returns the end state h_S,
(B, di, ds) float32 (the layout of the Mamba state's ``"ssm"`` and of
``repro_torch.models.ssm._ssm_scan``'s ``h_final``): the last launch's
threads of the last chunk store it after their walk, so prefill takes the
kernel with no launch added and ``y`` keeps its bits.
"""
from __future__ import annotations

import torch

from ..analysis import op_cost
from . import _build

#: the largest d_state the kernel takes (the state vector of one thread)
MAX_STATE = 32
#: the fewest positions a chunk holds (the carry costs a chunk's
#: d_state loads and stores, worth it only over enough positions)
MIN_CHUNK = 32
#: the threads of the two walks an SM should be offered: enough chunks
#: that B * d_inner * chunks reaches this times the SM count
THREADS_PER_SM = 2048
#: the most chunks a launch's grid takes (its y dimension)
MAX_CHUNKS = 65535


def chunk_len(b: int, s: int, di: int, sm_count: int) -> int:
    """Positions a chunk of the scan, from the shape and the card's SM
    count alone (never the values, so a shape's bits are fixed on a
    card): enough chunks that ``b * di * chunks`` threads offer every SM
    :data:`THREADS_PER_SM`, at least :data:`MIN_CHUNK` positions each,
    at most ``s``."""
    if min(b, s, di, sm_count) < 1:
        raise ValueError(f"chunk_len takes positive sizes, got b={b}, "
                         f"s={s}, di={di}, sm_count={sm_count}")
    want = -(-sm_count * THREADS_PER_SM // (b * di))
    chunk = max(MIN_CHUNK, -(-s // want), -(-s // MAX_CHUNKS))
    return min(s, chunk)


def workspace_shapes(b: int, s: int, di: int, ds: int, chunk: int):
    """The kernels' workspace for a chunk length: ``((b, n_c - 1, ds,
    di), (b, n_c - 1, di))`` float32 (end states, dt sums), ``None``
    when the scan is one chunk."""
    n_c = -(-s // chunk)
    if n_c == 1:
        return None
    return (b, n_c - 1, ds, di), (b, n_c - 1, di)


def selective_scan_ref(u, dt, bmat, cmat, a, return_state: bool = False):
    """The plain PyTorch version: the recurrence of
    :func:`repro_torch.models.ssm._ssm_scan`, one position at a time,
    with zero initial state and no skip term (differentiable: the
    Mamba layer's backward runs through it). With ``return_state``:
    ``(y, h_final)``."""
    from repro_torch.models.ssm import _ssm_scan
    b, _, di = u.shape
    h0 = torch.zeros((b, di, bmat.shape[-1]), dtype=torch.float32,
                     device=u.device)
    y, h = _ssm_scan(u, dt, bmat, cmat, a,
                     torch.zeros((di,), dtype=torch.float32,
                                 device=u.device), h0)
    return (y, h) if return_state else y


def selective_scan(u, dt, bmat, cmat, a, return_state: bool = False):
    """``u``, ``dt`` (B, S, di), ``bmat``, ``cmat`` (B, S, ds), ``a``
    (di, ds), float32 -> ``y`` (B, S, di) float32, or ``(y, h_final)``
    with ``return_state`` (``h_final`` (B, di, ds) float32, zero when S
    is 0). A CPU tensor takes the plain version; a CUDA tensor launches
    the kernels or raises."""
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
        return selective_scan_ref(u, dt, bmat, cmat, a, return_state)
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
    h = (torch.empty((b, di, ds), dtype=torch.float32, device=u.device)
         if return_state else None)
    if s == 0 or di == 0:
        if h is not None:
            h.zero_()
        return (y, h) if return_state else y
    chunk = chunk_len(b, s, di, torch.cuda.get_device_properties(
        u.device).multi_processor_count)
    shapes = workspace_shapes(b, s, di, ds, chunk)
    hws, dws = (None, None) if shapes is None else (
        torch.empty(sh, dtype=torch.float32, device=u.device)
        for sh in shapes)
    if op_cost.kernel_io(ins, (y, h)):
        return (y, h) if return_state else y    # fake tensors: no launch
    with _build.on_device(u):
        _build.check(_build.library().selective_scan_f32(
            u.data_ptr(), dt.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
            a.data_ptr(), b, s, di, ds, chunk,
            None if hws is None else hws.data_ptr(),
            None if dws is None else dws.data_ptr(), y.data_ptr(),
            None if h is None else h.data_ptr(),
            _build.stream_of(u)), "selective_scan_f32")
    selective_scan.launches += 1
    return (y, h) if return_state else y


#: wrapper calls that launched the kernels since the count was last set
#: to 0
selective_scan.launches = 0
