"""One FCM_S step over a bucket of same-shape lanes: the Eq. 3' partial
sums ``num_j = sum_i u_ji^m (x_i + alpha * xbar_i)`` and ``den_j = sum_i
u_ji^m`` of every lane, with ``u`` the Eq. 4' membership on the
stencil-effective distances. The caller forms ``v' = num / max((1 +
alpha) den, 1e-12)``.

Two CUDA kernels (``csrc/fcm_spatial.cu``), each with its plain PyTorch
version beside it:

* :func:`spatial_partials_2d`, 4 or 8 neighbors over ``(B, H, W)``
  lanes (replaces ``repro/kernels/fcm_spatial.py::
  spatial_partials_pallas_2d``);
* :func:`spatial_partials_3d`, 6 neighbors over ``(B, D, H, W)`` lanes
  (replaces ``spatial_partials_pallas_3d``).

In 2-D, a warp marches a strip of 32 columns over a run of 1-8 rows
along y (:func:`spatial2d_plan`), a thread holding its column's rows
y - 1, y, y + 1 in registers, the left and right neighbors from warp
shuffles; a block takes 16 such tasks, and the last block of each lane
to finish folds the lane's partial rows, so a call is one launch. In
3-D, a block marches a 32 x 8 column of the volume along z over a run of
planes (:func:`spatial3d_plan`), holding each column's z - 1, z, z + 1
values in registers and one plane's tile and halo in shared memory, and
leaves one partial row a run, which a second launch folds. Either way
no float atomics, and a lane's bits depend on its own shape and values
only. The grid is unpadded: each block masks its edge by coordinates,
where the TPU kernels pad to (8, 128) tiles and carry a validity sheet.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import _build
from .fcm_membership import MAX_C, exponent

#: the 2-D march (csrc/fcm_spatial.cu): a warp task's strip of columns
#: (one thread a column), the tasks (warps) a block, and the most rows a
#: task marches
STRIP_W, STRIP_WARPS, MAX_WARP_ROWS = 32, 16, 8
#: a lane's warps the 2-D plan aims at: a warp marches the most rows (a
#: power of two) that still leave this many warps, so a lone image keeps
#: about 27 warps on each of an H100's 132 SMs
MARCH_WARPS = 3600
#: the 3-D step's lanes sit on gridDim.z: one launch a chunk of this many
MAX_LANES_3D = 65535
#: the columns one block of the 3-D march covers, one thread a column
MARCH_W, MARCH_H = 32, 8
#: planes a block of the 3-D march walks (the last run of a lane may be
#: shorter)
Z_RUN = 16
#: shared memory of the march's staged tiles: two planes of the tile with
#: their one-pixel halo, float32
MARCH_TILE_BYTES = 2 * (MARCH_H + 2) * (MARCH_W + 2) * 4


class Spatial3dPlan(NamedTuple):
    """How the 3-D march cuts a (depth, h, w) lane: ``tile`` (w, h)
    columns a block, runs of ``z`` planes, ``runs`` of them, ``tiles`` a
    plane, ``rows`` partial rows a lane (one a block: tiles * runs) and
    the staged tiles' shared memory a block."""
    tile: Tuple[int, int]
    z: int
    runs: int
    tiles: int
    rows: int
    smem_bytes: int


class Spatial2dPlan(NamedTuple):
    """How the 2-D march cuts an (h, w) lane: a warp's task is ``tile``
    (32 columns, ``run`` rows); the lane has ``strips`` of columns by
    ``runs`` of rows, ``tasks`` in all, strips fastest; a block takes
    ``warps`` consecutive tasks, ``blocks`` a lane, each leaving one
    partial row (``rows``)."""
    tile: Tuple[int, int]
    run: int
    warps: int
    strips: int
    runs: int
    tasks: int
    blocks: int
    rows: int


def spatial2d_plan(h: int, w: int) -> Spatial2dPlan:
    """The 2-D march's plan for one lane, from its shape alone (never the
    bucket or the card), so a lane's bits do not depend on either: warp
    tasks of 32 columns by the most rows, up to 8 and a power of two, that
    leave the lane :data:`MARCH_WARPS` tasks, 16 tasks a block. The
    1000 KB image (4000 x 256): 8 rows a task, 8 strips by 500 runs, 250
    blocks; a 217 x 181 slice: 1 row a task, 82 blocks."""
    if min(h, w) < 1:
        raise ValueError(f"an empty image has no plan: {(h, w)}")
    run = MAX_WARP_ROWS
    while run > 1 and h * w < run * STRIP_W * MARCH_WARPS:
        run //= 2
    strips, runs = -(-w // STRIP_W), -(-h // run)
    blocks = -(-strips * runs // STRIP_WARPS)
    return Spatial2dPlan((STRIP_W, run), run, STRIP_WARPS, strips, runs,
                         strips * runs, blocks, blocks)


def spatial3d_plan(depth: int, h: int, w: int) -> Spatial3dPlan:
    """The 3-D march's plan for one lane, from its shape alone (never
    the bucket or the card), so a lane's bits do not depend on either."""
    if min(depth, h, w) < 1:
        raise ValueError(f"an empty volume has no plan: {(depth, h, w)}")
    z = min(Z_RUN, depth)
    runs = -(-depth // z)
    tiles = -(-h // MARCH_H) * -(-w // MARCH_W)
    return Spatial3dPlan((MARCH_W, MARCH_H), z, runs, tiles, tiles * runs,
                         MARCH_TILE_BYTES)


def spatial_partials_plain(x: torch.Tensor, v: torch.Tensor, m: float,
                           alpha: float, neighbors: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of both kernels: ``x`` ``(B, *grid)``,
    ``v`` ``(B, c)`` -> ``(num (B, c), den (B, c))``, the TPU kernels'
    form of Eq. 3' (``x + alpha * xbar`` summed; the ``1 + alpha``
    divisor is the caller's)."""
    from repro_torch.core import fcm as F
    from repro_torch.core import spatial as SP
    b, c = v.shape
    d2, nb, xbar = SP.neighbor_fields(x, v, neighbors, batched=True)
    u = F.membership_from_d2((d2 + alpha * nb).reshape(b, c, -1), m)
    um = u ** m
    xe = (x.to(torch.float32) + alpha * xbar).reshape(b, 1, -1)
    return (um * xe).sum(dim=-1), um.sum(dim=-1)


def _checked(what: str, x: torch.Tensor, v: torch.Tensor, rank: int) -> bool:
    """Shape, device, type and bound checks; True when the kernel runs (a
    CUDA tensor), False for the plain version (a CPU tensor)."""
    if x.dim() != rank or v.dim() != 2 or v.shape[0] != x.shape[0]:
        raise ValueError(f"{what} takes x of rank {rank} with a leading "
                         f"lane axis and v (B, c), got {tuple(x.shape)} "
                         f"and {tuple(v.shape)}")
    if x.device != v.device:
        raise ValueError(f"pixels on {x.device}, centers on {v.device}")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {x.device}")
    if x.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"the {what} kernel takes float32 inputs")
    if not (x.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"the {what} kernel needs contiguous inputs")
    c = v.shape[1]
    if not (1 <= c <= MAX_C and x.numel() > 0):
        raise ValueError(f"the {what} kernel takes 1 <= c <= {MAX_C} and a "
                         f"non-empty grid, got c={c}, x {tuple(x.shape)}")
    return True


def _buffers(x: torch.Tensor, c: int, n_rows: int):
    """The partials scratch, ``n_rows`` (2c,) rows a lane, and the (B, 2c)
    output: each lane's c numerators, then its c denominators."""
    b = x.shape[0]
    part = torch.empty((b, n_rows, 2 * c), dtype=torch.float32,
                       device=x.device)
    out = torch.empty((b, 2 * c), dtype=torch.float32, device=x.device)
    return part, out


def spatial_partials_2d(x: torch.Tensor, v: torch.Tensor, m: float,
                        alpha: float, neighbors: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` (B, H, W) lanes, ``v`` (B, c) centers, 4 or 8 neighbors ->
    ``(num (B, c), den (B, c))``, for a bucket of any number of lanes. A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (one launch, its fold included) or raises."""
    if neighbors not in (4, 8):
        raise ValueError(f"2-D neighborhoods are 4 or 8, got {neighbors}")
    if not _checked("spatial_partials_2d", x, v, 3):
        return spatial_partials_plain(x, v, m, alpha, neighbors)
    b, h, w = x.shape
    c = v.shape[1]
    plan = spatial2d_plan(h, w)
    part, out = _buffers(x, c, plan.rows)
    with _build.on_device(x):
        _build.check(_build.library().fcm_spatial_partials_2d(
            x.data_ptr(), v.data_ptr(), b, h, w, c, neighbors,
            float(np.float32(alpha)), float(np.float32(m)), exponent(m),
            plan.run, part.data_ptr(), _build.zeroed_ints(x, b).data_ptr(),
            out.data_ptr(), _build.stream_of(x)), "fcm_spatial_partials_2d")
    spatial_partials_2d.launches += 1
    return out[:, :c], out[:, c:]


def spatial_partials_3d(x: torch.Tensor, v: torch.Tensor, m: float,
                        alpha: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` (B, D, H, W) lanes, ``v`` (B, c) centers, the 6-connected
    stencil -> ``(num (B, c), den (B, c))``. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (and its fold) or raises.
    The lanes sit on ``gridDim.z``, so a bucket of more than
    :data:`MAX_LANES_3D` lanes takes one library call a chunk of lanes; a
    lane's bits are its own, so the chunks do not change them."""
    if not _checked("spatial_partials_3d", x, v, 4):
        return spatial_partials_plain(x, v, m, alpha, 6)
    b, depth, h, w = x.shape
    c = v.shape[1]
    plan = spatial3d_plan(depth, h, w)
    n0 = min(b, MAX_LANES_3D)         # the scratch serves every chunk
    part, out = _buffers(x[:n0], c, plan.rows)
    if n0 < b:
        out = torch.empty((b, 2 * c), dtype=torch.float32, device=x.device)
    lib = _build.library()
    for i0, i1 in _build.lane_chunks(b, MAX_LANES_3D):
        with _build.on_device(x):
            _build.check(lib.fcm_spatial_partials_3d(
                x[i0:i1].data_ptr(), v[i0:i1].data_ptr(), i1 - i0, depth, h,
                w, c, float(np.float32(alpha)), float(np.float32(m)),
                exponent(m), plan.z, part.data_ptr(), out[i0:i1].data_ptr(),
                _build.stream_of(x)), "fcm_spatial_partials_3d")
        spatial_partials_3d.launches += 1
    return out[:, :c], out[:, c:]


#: library calls since the counts were last set to 0: the 2-D step one
#: launch a call (its fold included); the 3-D step a march and its fold a
#: chunk of at most MAX_LANES_3D lanes, so one a call below 65536 lanes
spatial_partials_2d.launches = 0
spatial_partials_3d.launches = 0
