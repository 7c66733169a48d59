"""Eq. 3 center partial sums over ``(N,)`` scalar pixels: ``num_j =
sum_i u_ji^m w_i x_i`` and ``den_j = sum_i u_ji^m w_i``.

Two CUDA kernels (``csrc/fcm_centers.cu``), each with its plain PyTorch
version beside it:

* :func:`center_partials` from a materialized ``(c, N)`` membership
  (replaces ``repro/kernels/fcm_centers.py::center_partials_pallas``,
  the paper's staged reduction);
* :func:`fused_partials` from the centers, the Eq. 4 membership computed
  in registers and reduced at once, so the ``(c, N)`` array never exists
  (replaces ``repro/kernels/fcm_centers.py::fused_partials_pallas``; one
  call an iteration of ``backend="fused"``): the batched form's D = 1
  kernel at B = 1, unit weights (``w is None``) a compile-time case.
* :func:`fused_partials_batched`, the same over a bucket of lanes of
  vector rows, ``x`` (B, N, D) and ``w`` (B, N): the batched flat step
  of lanes past the whole-solve kernels' bounds (c > 8, rows > 2^20 or
  D > 16), once an iteration under the solver's per-lane-masked loop.

Each block reduces its share of the pixels to per-block partials in a
scratch buffer, which the last block to finish folds in a fixed order,
in one launch (in the fused forms the last block of each lane,
:func:`batched_plan` giving a lane its blocks from its own shape).
No float atomics, so a run repeats bit for bit. ``w`` is the optional per-pixel weight (histogram counts);
``None`` means 1 and is not read.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..analysis import op_cost
from . import _build
from .fcm_membership import MAX_C, exponent

#: threads a block; the block count is ceil(N / THREADS), at most
#: MAX_BLOCKS (then each thread strides over several pixels). It depends
#: only on N, so the summation order does too.
THREADS = 256
MAX_BLOCKS = 1024
#: pixels a thread of :func:`center_partials` takes at a time (one
#: 16-byte load of x and of each u row), and the quads a thread takes:
#: 125 blocks at the 1000 KB image, so the last block's fold is one
#: round of loads (PERF.md, PR 20)
QUAD = 4
QUADS_PER_THREAD = 8


def center_blocks(n: int) -> int:
    """:func:`center_partials`' block count for N pixels:
    ``ceil(N / (QUAD * QUADS_PER_THREAD * THREADS))`` blocks, at most
    :data:`MAX_BLOCKS` (past that, each thread strides over more
    quads). It depends on N alone."""
    return max(1, min(-(-n // (QUAD * QUADS_PER_THREAD * THREADS)),
                      MAX_BLOCKS))


#: the batched form's most blocks a (lane, feature chunk); past that its
#: threads stride over more tiles
BATCHED_MAX_BLOCKS = 1024
#: the chunked form (D > 1) gives a thread about this / (tier * D) rows
CHUNK_WORK = 192


def batched_tier(c: int, d: int) -> int:
    """The cluster tier :func:`fused_partials_batched` takes for (c, D):
    at D = 1 the D = 1 form's 4, 8, 12, 16, 32 (12 for the pixel route's
    twelve-class bucket), else the shared 4, 8, 16, 32."""
    if not 1 <= c <= MAX_C or d < 1:
        raise ValueError(f"no batched tier holds c={c}, D={d}")
    if d == 1 and 8 < c <= 12:
        return 12
    return next(t for t in (4, 8, 16, 32) if c <= t)


class BatchedPlan(NamedTuple):
    """How :func:`fused_partials_batched` cuts a bucket of B lanes of N
    rows of D features at c clusters."""
    tier: int             # the kernel's cluster tier
    dch: int              # features a block's chunk takes (1 at D = 1)
    chunks: int           # feature chunks a lane: ceil(D / dch)
    rows_per_thread: int  # rows a thread takes in a tile
    tile: int             # rows a block takes at a time
    blocks: int           # blocks a (lane, chunk)
    grid: int             # blocks launched: B * chunks * blocks
    part_floats: int      # the partials scratch, one row a block


def batched_plan(b: int, n: int, d: int, c: int,
                 weighted: bool = True) -> BatchedPlan:
    """The batched fused kernel's plan (and, at one lane of scalar rows,
    the scalar fused partials'). A lane's chunks, tiles and blocks, and
    so its reduction order, come from its N, D and c (and whether weights
    are read) alone, never from B or the card. At D = 1 a thread takes 8
    rows at c <= 8, except 4 with weights at c <= 4, and 4 past c = 8,
    from per-block stamps on the card (PERF.md): the 1000 KB
    image's 500 unit-weight blocks sit on the card at once, a bucket of
    BrainWeb slices at c = 12 fills it and a lone lane of 2^20 rows
    spreads over it; wider rows take about ``CHUNK_WORK / (tier * D)``
    rows a thread and chunks of 4
    features (2 past c = 8). A lane takes a block for each tile, at most
    :data:`BATCHED_MAX_BLOCKS` a chunk."""
    if min(b, n, d) < 1:
        raise ValueError(f"batched_plan takes positive sizes, got b={b}, "
                         f"n={n}, d={d}")
    tier = batched_tier(c, d)
    if d == 1:
        dch = 1
        rpt = 4 * ((1 if weighted else 2) if tier <= 4 else 2 if tier <= 8
                   else 1)
    else:
        dch, rpt = (4 if tier <= 8 else 2), max(1, CHUNK_WORK // (tier * d))
    chunks = -(-d // dch)
    tile = THREADS * rpt
    blocks = min(-(-n // tile), BATCHED_MAX_BLOCKS)
    grid = b * chunks * blocks
    return BatchedPlan(tier, dch, chunks, rpt, tile, blocks, grid,
                       grid * (c * dch + c))


#: the scalar fused partials give a lane one row a thread where the
#: tier's rows would leave it fewer blocks than an H100 has SMs
SPREAD_BLOCKS = 132


def scalar_plan(n: int, c: int, weighted: bool, m: float) -> BatchedPlan:
    """The plan of :func:`fused_partials`, one lane of N scalar rows: the
    batched form's (:func:`batched_plan`), except that a lane whose tier
    rows would leave fewer than :data:`SPREAD_BLOCKS` blocks, or whose m
    is not 2 (eight ``powf`` a row at c = 4, whose latency wants more
    threads in flight), takes one row a thread in blocks of
    :data:`THREADS` rows, at most :data:`BATCHED_MAX_BLOCKS` (past that
    threads stride). It depends on N, c, whether weights are read and
    whether m == 2, never on the values."""
    plan = batched_plan(1, n, 1, c, weighted)
    if plan.blocks >= SPREAD_BLOCKS and m == 2.0:
        return plan
    blocks = min(-(-n // THREADS), BATCHED_MAX_BLOCKS)
    return plan._replace(rows_per_thread=1, tile=THREADS, blocks=blocks,
                         grid=blocks, part_floats=blocks * 2 * c)


def center_partials_plain(x: torch.Tensor, u: torch.Tensor, m: float,
                          w: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`center_partials`."""
    um = u ** m
    if w is not None:
        um = um * w
    return (um * x).sum(dim=-1), um.sum(dim=-1)


def fused_partials_plain(x: torch.Tensor, w: Optional[torch.Tensor],
                         v: torch.Tensor, m: float
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`fused_partials`: the
    membership of :func:`repro_torch.core.fcm.update_membership`, then
    :func:`center_partials_plain`."""
    from repro_torch.core import fcm as F
    return center_partials_plain(x, F.update_membership(x, v, m), m, w)


def fused_partials_batched_plain(x: torch.Tensor, w: torch.Tensor,
                                 v: torch.Tensor, m: float
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`fused_partials_batched`: the
    sums of :func:`repro_torch.core.solver.weighted_center_step`, in its
    order, before the division."""
    from repro_torch.core import fcm as F
    um = (F.update_membership(x, v, m) ** m) * w[:, None, :]   # (B, c, N)
    num = (um[..., None] * x[:, None, :, :]).sum(dim=-2)
    return num, um.sum(dim=-1)


def _checked(what: str, x: torch.Tensor, w: Optional[torch.Tensor],
             others, c: int) -> bool:
    """Validate the common arguments; True when the kernel runs (a CUDA
    tensor), False for the plain version (a CPU tensor)."""
    if x.dim() != 1:
        raise ValueError(f"{what} takes (N,) scalar pixels, got "
                         f"{tuple(x.shape)}")
    if w is not None and tuple(w.shape) != tuple(x.shape):
        raise ValueError(f"{what}: weights {tuple(w.shape)} do not match "
                         f"pixels {tuple(x.shape)}")
    tensors = [x, *others] + ([] if w is None else [w])
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{what} inputs must share one device")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {x.device}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"the {what} kernel takes float32 inputs")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"the {what} kernel needs contiguous inputs")
    if not 1 <= c <= MAX_C:
        raise ValueError(f"the {what} kernel takes 1 <= c <= {MAX_C}, got "
                         f"c={c}")
    return True


def _zeros(x: torch.Tensor, c: int):
    """The sums over no pixels."""
    return (torch.zeros((c,), dtype=torch.float32, device=x.device),
            torch.zeros((c,), dtype=torch.float32, device=x.device))


def _outputs(x: torch.Tensor, c: int, n_blocks: int):
    part = torch.empty((n_blocks, 2 * c), dtype=torch.float32,
                       device=x.device)
    num = torch.empty((c,), dtype=torch.float32, device=x.device)
    den = torch.empty((c,), dtype=torch.float32, device=x.device)
    return n_blocks, part, num, den


def center_partials(x: torch.Tensor, u: torch.Tensor, m: float,
                    w: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` (N,), ``u`` (c, N), optional ``w`` (N,), float32 -> ``(num
    (c,), den (c,))``. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel (one launch, its fold included) or
    raises."""
    if u.dim() != 2 or u.shape[1] != x.shape[-1]:
        raise ValueError(f"center_partials takes u (c, N) for x (N,), got "
                         f"{tuple(u.shape)} and {tuple(x.shape)}")
    c = u.shape[0]
    if not _checked("center_partials", x, w, [u], c):
        return center_partials_plain(x, u, m, w)
    n = x.shape[0]
    if n == 0:
        return _zeros(x, c)
    n_blocks, part, num, den = _outputs(x, c, center_blocks(n))
    with _build.on_device(x):
        _build.check(_build.library().fcm_center_partials(
            x.data_ptr(), u.data_ptr(), None if w is None else w.data_ptr(),
            n, c, float(np.float32(m)), part.data_ptr(), n_blocks,
            _build.zeroed_ints(x, 1).data_ptr(), num.data_ptr(),
            den.data_ptr(), _build.stream_of(x)), "fcm_center_partials")
    center_partials.launches += 1
    return num, den


def fused_partials(x: torch.Tensor, w: Optional[torch.Tensor],
                   v: torch.Tensor, m: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` (N,), ``w`` (N,) or ``None``, ``v`` (c,), float32 ->
    ``(num (c,), den (c,))``. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel (one launch, its fold included;
    :func:`scalar_plan`) or raises."""
    if v.dim() != 1:
        raise ValueError(f"fused_partials takes (c,) centers, got "
                         f"{tuple(v.shape)}")
    c = v.shape[0]
    if not _checked("fused_partials", x, w, [v], c):
        return fused_partials_plain(x, w, v, m)
    n = x.shape[0]
    if n == 0:
        return _zeros(x, c)
    plan = scalar_plan(n, c, w is not None, m)
    _, part, num, den = _outputs(x, c, plan.blocks)
    if op_cost.kernel_io((x, w, v), (num, den)):
        return num, den             # fake tensors: nothing to launch
    with _build.on_device(x):
        _build.check(_build.library().fcm_fused_partials(
            x.data_ptr(), None if w is None else w.data_ptr(), n,
            v.data_ptr(), c, float(np.float32(m)), exponent(m), plan.blocks,
            plan.rows_per_thread, part.data_ptr(),
            _build.zeroed_ints(x, 1).data_ptr(), num.data_ptr(),
            den.data_ptr(), _build.stream_of(x)), "fcm_fused_partials")
    fused_partials.launches += 1
    return num, den


def _batched_checked(x: torch.Tensor, w: torch.Tensor, v: torch.Tensor
                     ) -> bool:
    """Shapes, devices and types of :func:`fused_partials_batched`; True
    when the kernel runs (a CUDA tensor), False for the plain version (a
    CPU tensor)."""
    if x.dim() != 3 or w.dim() != 2 or v.dim() != 3:
        raise ValueError("fused_partials_batched takes x (B, N, D), w (B, "
                         "N), v (B, c, D)")
    b, n, d = x.shape
    c = v.shape[1]
    if tuple(w.shape) != (b, n) or tuple(v.shape) != (b, c, d):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, v {tuple(v.shape)}")
    if len({t.device for t in (x, w, v)}) != 1:
        raise ValueError("fused_partials_batched inputs must share one "
                         "device")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"fused_partials_batched runs on cpu or cuda, not "
                         f"{x.device}")
    if any(t.dtype != torch.float32 for t in (x, w, v)):
        raise TypeError("the fused_partials_batched kernel takes float32 "
                        "inputs")
    if not all(t.is_contiguous() for t in (x, w, v)):
        raise ValueError("the fused_partials_batched kernel needs "
                         "contiguous inputs")
    if not 1 <= c <= MAX_C:
        raise ValueError(f"the fused_partials_batched kernel takes 1 <= c "
                         f"<= {MAX_C}, got c={c}")
    return True


def fused_partials_batched(x: torch.Tensor, w: torch.Tensor,
                           v: torch.Tensor, m: float
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` (B, N, D), ``w`` (B, N), ``v`` (B, c, D), float32 -> ``(num
    (B, c, D), den (B, c))``, for a bucket of any number of lanes. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel
    (one launch, its fold included) or raises."""
    if not _batched_checked(x, w, v):
        return fused_partials_batched_plain(x, w, v, m)
    b, n, d = x.shape
    c = v.shape[1]
    num = torch.empty((b, c, d), dtype=torch.float32, device=x.device)
    den = torch.empty((b, c), dtype=torch.float32, device=x.device)
    if b == 0 or n == 0 or d == 0:
        return num.zero_(), den.zero_()
    plan = batched_plan(b, n, d, c)
    part = torch.empty((plan.part_floats,), dtype=torch.float32,
                       device=x.device)
    with _build.on_device(x):
        _build.check(_build.library().fcm_fused_partials_batched(
            x.data_ptr(), w.data_ptr(), b, n, d, v.data_ptr(), c,
            float(np.float32(m)), exponent(m), plan.blocks,
            plan.rows_per_thread, part.data_ptr(),
            _build.zeroed_ints(x, b).data_ptr(), num.data_ptr(),
            den.data_ptr(), _build.stream_of(x)),
            "fcm_fused_partials_batched")
    fused_partials_batched.launches += 1
    return num, den


#: kernel launches since the counts were last set to 0 (one a call, the
#: fold included)
center_partials.launches = 0
fused_partials.launches = 0
fused_partials_batched.launches = 0
