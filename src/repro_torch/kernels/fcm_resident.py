"""Whole-solve weighted FCM: every lane's complete fixed point in one
launch.

Two CUDA kernels, one contract:

- ``csrc/fcm_resident.cu`` replaces the TPU's VMEM-resident whole-solve
  (``repro/kernels/fcm_resident.py::resident_solve_pallas``): one block
  per lane holds the lane's rows and centers in registers (up to 1024
  rows), one barrier an iteration, in the form :func:`resident_plan`
  picks.
- ``csrc/fcm_streamed.cu`` replaces its HBM-streamed twin
  (``resident_streamed_solve_pallas``): a cooperative launch in which
  each lane takes a group of blocks (:func:`streamed_plan`), re-reads
  its rows from device memory (and L2) on every iteration and reduces
  across its blocks through partials in device memory behind a per-lane
  counter (up to 2^20 rows).

Each iterates the weighted Eq. 4 -> Eq. 3 step until ``max|v' - v| <
tol`` or ``max_iters``, with no launch between iterations. Each lane
stops at its own convergence point, so its trajectory is a solo solve's.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _build

#: Bounds of one lane (see the derivation in csrc/fcm_resident.cu): rows
#: stay in registers, 256 threads x at most 4 rows each.
MAX_ROWS = 1024
MAX_C = 8
MAX_FEAT = 8
#: threads a block (a lane) and the most rows a thread of the resident
#: kernel
THREADS = 256
ROWS_PER_THREAD = 4


class ResidentPlan(NamedTuple):
    """The resident kernel's launch for lanes of K rows: one block of
    :data:`THREADS` threads a lane."""
    tier: bool              # c == 4, D == 1, m == 2 compiled in
    rows_per_thread: int    # most rows a thread holds


def resident_plan(k: int, c: int, d: int, m: float) -> ResidentPlan:
    """The resident kernel's form, from the shape alone: the tier (c, D
    and m compiled in, one reciprocal for a row's divisions) for the
    paper's c == 4, D == 1, m == 2 (the histogram route), run-time
    bodies otherwise; 8 warps a lane (faster than 4 in both forms on the
    histogram bucket, PERF.md), so a thread holds at most
    :data:`ROWS_PER_THREAD` rows."""
    if not (1 <= k <= MAX_ROWS and 1 <= c <= MAX_C and 1 <= d <= MAX_FEAT):
        raise ValueError(f"resident_plan holds 1 <= rows <= {MAX_ROWS}, "
                         f"c <= {MAX_C}, D <= {MAX_FEAT}; got rows={k}, "
                         f"c={c}, D={d}")
    tier = c == 4 and d == 1 and float(np.float32(m)) == 2.0
    return ResidentPlan(tier, -(-k // THREADS))


#: Bounds of one lane of the streamed kernel (csrc/fcm_streamed.cu): the
#: row bound is a wall-clock choice covering the paper's 1000 KB image;
#: D <= 16 is the pixel route's own ingest bound.
STREAM_MAX_ROWS = 1 << 20
STREAM_MAX_C = 8
STREAM_MAX_FEAT = 16
#: threads a block of the streamed kernel, and the most blocks a lane takes
#: (one an SM on any card of at least 128 SMs, whatever the occupancy)
STREAM_THREADS = 256
STREAM_MAX_RANKS = 128


def stream_feat_tier(d: int) -> int:
    """The feature tier the streamed kernel is instantiated for."""
    return 1 if d <= 1 else 3 if d <= 3 else 8 if d <= 8 else 16


def stream_rows_per_block(d: int) -> int:
    """Rows a block of the streamed kernel takes, by feature tier: about
    the same float work a block, and at D = 1 few enough blocks that a
    64-lane bucket of BrainWeb slices (39 277 rows) is resident at once."""
    return {1: 5120, 3: 2048, 8: 1024, 16: 512}[stream_feat_tier(d)]


def stream_min_blocks(c: int, d: int) -> int:
    """The blocks an SM the (c, D) tier's ``__launch_bounds__`` asks for,
    from the sums a thread keeps in registers: the occupancy the plan
    may assume."""
    sums = (4 if c <= 4 else 8) * (stream_feat_tier(d) + 1)
    return 4 if sums <= 16 else 2 if sums <= 36 else 1


class StreamedPlan(NamedTuple):
    """The streamed kernel's launch for a bucket of B lanes of K rows."""
    ranks: int              # blocks a lane, from K and the feature tier
    threads: int            # threads a block
    rows_per_thread: int    # most rows a thread takes an iteration
    lanes_per_round: int    # lanes whose blocks are resident together
    rounds: int             # turns a group of blocks takes through lanes
    grid: int               # blocks launched: lanes_per_round * ranks


def streamed_plan(b: int, k: int, d: int, sm_count: int,
                  blocks_per_sm: int) -> StreamedPlan:
    """The streamed kernel's plan. A lane's block count, and with it the
    slices of its rows and its reduction order, comes from its rows and
    feature tier alone: a block for each :func:`stream_rows_per_block`
    rows, at most :data:`STREAM_MAX_RANKS`. The grid is as many whole
    lanes' groups of blocks as the card holds at once (``sm_count *
    blocks_per_sm``, the occupancy the library reports) and at most B;
    a bucket past that runs in rounds inside the launch, each group
    taking every ``lanes_per_round``-th lane."""
    if min(b, k, d, sm_count, blocks_per_sm) < 1:
        raise ValueError(f"streamed_plan takes positive sizes, got b={b}, "
                         f"k={k}, d={d}, sm_count={sm_count}, "
                         f"blocks_per_sm={blocks_per_sm}")
    ranks = min(STREAM_MAX_RANKS, -(-k // stream_rows_per_block(d)))
    resident = sm_count * blocks_per_sm
    if ranks > resident:
        raise ValueError(f"a lane of {k} rows takes {ranks} blocks, more "
                         f"than the {resident} the card holds at once")
    lanes = min(b, resident // ranks)
    per = -(-k // ranks)
    return StreamedPlan(ranks, STREAM_THREADS, -(-per // STREAM_THREADS),
                        lanes, -(-b // lanes), lanes * ranks)


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


#: The streamed kernel's plain version is the same per-lane-masked loop:
#: the two kernels differ in where the rows live, not in what they compute.
resident_streamed_solve_plain = resident_solve_plain


def _check_inputs(what, x, w, v0, tol):
    """Shapes and devices of the shared contract; returns (B, K, D, c)."""
    if x.dim() != 3 or w.dim() != 2 or v0.dim() != 3 or tol.dim() != 1:
        raise ValueError(f"{what} takes x (B, K, D), w (B, K), v0 (B, c, "
                         f"D), tol (B,)")
    b, k, d = x.shape
    c = v0.shape[1]
    if (tuple(w.shape) != (b, k) or tuple(v0.shape) != (b, c, d)
            or tuple(tol.shape) != (b,)):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, v0 {tuple(v0.shape)}, tol "
                         f"{tuple(tol.shape)}")
    if len({t.device for t in (x, w, v0, tol)}) != 1:
        raise ValueError(f"{what} inputs must share one device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {x.device}")
    if x.device.type == "cuda":
        if any(t.dtype != torch.float32 for t in (x, w, v0, tol)):
            raise TypeError("the whole-solve kernels take float32 inputs")
        if not all(t.is_contiguous() for t in (x, w, v0, tol)):
            raise ValueError("the whole-solve kernels need contiguous inputs")
    return b, k, d, c


def _on_card(x) -> bool:
    """True when the kernel runs: the inputs lie on a CUDA device (the
    shared checks have admitted only cpu and cuda)."""
    return x.device.type == "cuda"


def _exponents(m):
    """m and the exponent -1/(m-1) as float32, computed as the reference
    does: the Python float -1/(m-1), then rounded once."""
    return float(np.float32(m)), float(np.float32(-1.0 / (m - 1.0)))


def _outputs(x, b, c, d):
    return (torch.empty((b, c, d), dtype=torch.float32, device=x.device),
            torch.empty((b,), dtype=torch.float32, device=x.device),
            torch.empty((b,), dtype=torch.int32, device=x.device))


#: (device, c, D, m == 2) -> (SM count, blocks an SM) of the streamed
#: kernel, asked of the card once
_occupancy = {}


def streamed_occupancy(device, c: int, d: int, m: float):
    """The SM count of ``device`` and the blocks an SM the streamed kernel
    that c, D and m launch holds there
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    m32 = float(np.float32(m))
    key = (device, c, d, m32 == 2.0)
    if key not in _occupancy:
        with _build.on_device(device):
            blocks = _build.library().fcm_streamed_blocks_per_sm(c, d, m32)
        if blocks < 1:
            raise _build.KernelLaunchError(
                f"fcm_streamed_blocks_per_sm: CUDA error {-blocks}")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _occupancy[key] = (sms, blocks)
    return _occupancy[key]


def _launch_streamed(x, w, v0, tol, m, max_iters, b, k, d, c):
    v, delta, iters = _outputs(x, b, c, d)
    if not b:
        return v, delta, iters
    plan = streamed_plan(b, k, d, *streamed_occupancy(x.device, c, d, m))
    part = torch.empty((b * 2 * plan.ranks * c * (d + 1),),
                       dtype=torch.float32, device=x.device)
    sync = _build.zeroed_ints(x, 2 * b)
    with _build.on_device(x):
        _build.check(_build.library().fcm_streamed_solve(
            x.data_ptr(), w.data_ptr(), v0.data_ptr(), tol.data_ptr(), b, k,
            d, c, *_exponents(m), int(max_iters), plan.ranks,
            plan.lanes_per_round, part.data_ptr(), sync.data_ptr(),
            v.data_ptr(), delta.data_ptr(), iters.data_ptr(),
            _build.stream_of(x)), "fcm_streamed_solve")
    resident_streamed_solve.launches += 1
    return v, delta, iters


def resident_solve(x: torch.Tensor, w: torch.Tensor, v0: torch.Tensor,
                   tol: torch.Tensor, m: float, max_iters: int):
    """x (B, K, D) rows, w (B, K) weights, v0 (B, c, D) init centers,
    tol (B,) stop tolerances, all float32 -> (v (B, c, D), delta (B,),
    iters (B,) int32), for a bucket of any number of lanes (one launch).
    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    b, k, d, c = _check_inputs("resident_solve", x, w, v0, tol)
    if not _on_card(x):
        return resident_solve_plain(x, w, v0, tol, m, max_iters)
    if not (1 <= k <= MAX_ROWS and 1 <= c <= MAX_C and 1 <= d <= MAX_FEAT):
        raise ValueError(
            f"flat/resident holds rows <= {MAX_ROWS}, c <= {MAX_C}, "
            f"D <= {MAX_FEAT} a lane; got rows={k}, c={c}, D={d} (larger "
            f"flat problems take the HBM-streamed whole-solve, "
            f"resident_streamed_solve)")
    return _launch_resident(x, w, v0, tol, m, max_iters,
                            resident_plan(k, c, d, m))


def _launch_resident(x, w, v0, tol, m, max_iters, plan: ResidentPlan):
    """One launch of the resident kernel in ``plan``'s form (the checks
    of :func:`resident_solve` done)."""
    b, k, d = x.shape
    c = v0.shape[1]
    v, delta, iters = _outputs(x, b, c, d)
    if b:
        with _build.on_device(x):
            _build.check(_build.library().fcm_resident_solve(
                x.data_ptr(), w.data_ptr(), v0.data_ptr(), tol.data_ptr(), b,
                k, d, c, *_exponents(m), int(max_iters), int(plan.tier),
                v.data_ptr(), delta.data_ptr(), iters.data_ptr(),
                _build.stream_of(x)), "fcm_resident_solve")
        resident_solve.launches += 1
    return v, delta, iters


#: kernel launches since the count was last set to 0
resident_solve.launches = 0


def resident_streamed_solve(x: torch.Tensor, w: torch.Tensor,
                            v0: torch.Tensor, tol: torch.Tensor, m: float,
                            max_iters: int):
    """The HBM-streamed whole-solve, same contract as
    :func:`resident_solve` for lanes of up to :data:`STREAM_MAX_ROWS`
    rows, ``c <= STREAM_MAX_C`` and ``D <= STREAM_MAX_FEAT``, and a
    bucket of any number of lanes (one launch: lanes past what the card
    holds at once are taken in rounds). A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    b, k, d, c = _check_inputs("resident_streamed_solve", x, w, v0, tol)
    if not _on_card(x):
        return resident_streamed_solve_plain(x, w, v0, tol, m, max_iters)
    if not (1 <= k <= STREAM_MAX_ROWS and 1 <= c <= STREAM_MAX_C
            and 1 <= d <= STREAM_MAX_FEAT):
        raise ValueError(
            f"flat/resident_streamed holds rows <= {STREAM_MAX_ROWS}, c <= "
            f"{STREAM_MAX_C}, D <= {STREAM_MAX_FEAT} a lane; got rows={k}, "
            f"c={c}, D={d}")
    return _launch_streamed(x, w, v0, tol, m, max_iters, b, k, d, c)


#: kernel launches since the count was last set to 0
resident_streamed_solve.launches = 0
