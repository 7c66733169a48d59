"""Hard labels from centers: ``(B, N)`` scalar pixels + ``(B, c)``
centers -> ``(B, N)`` int32 argmin-distance labels, ties to the lowest
index.

The CUDA kernel (``csrc/defuzzify.cu``) replaces the TPU's fused label
kernel (``repro/kernels/defuzzify.py::labels_pallas``): the ``(c, N)``
distance matrix never reaches device memory. One launch labels a bucket
of any number of lanes: (lane, segment) blocks on a 1-D grid from
:func:`labels_plan`, 16-byte pixel words, uint8 pixels through a
per-block 256-entry label table.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..analysis import op_cost
from . import _build

#: centers per lane the kernel stages in shared memory (48 KB)
MAX_C = 12288
#: threads a block, and the pixels of one lane a block labels: 16 a
#: thread, one 16-byte word of uint8 pixels or four of int32 / float32
THREADS = 256
BLOCK_PIXELS = 4096

_DTYPES = {torch.float32: "labels_f32", torch.uint8: "labels_u8",
           torch.int32: "labels_i32"}


class LabelsPlan(NamedTuple):
    """The labels kernel's launch for a bucket of B lanes of N pixels."""
    segs: int               # blocks a lane
    words_per_thread: int   # 16-byte pixel words a thread loads
    grid: int               # blocks launched: B * segs


def labels_plan(b: int, n: int, itemsize: int) -> LabelsPlan:
    """The labels kernel's plan, from the shape alone: a block for each
    :data:`BLOCK_PIXELS` pixels of a lane (the main path's 64 x 39 277
    bucket is 640 blocks, one wave on an H100), each thread 16 pixels,
    in ``16 // itemsize``-pixel words."""
    if min(b, n) < 1 or itemsize not in (1, 4):
        raise ValueError(f"labels_plan takes positive sizes and 1- or "
                         f"4-byte pixels, got b={b}, n={n}, "
                         f"itemsize={itemsize}")
    segs = -(-n // BLOCK_PIXELS)
    return LabelsPlan(segs, itemsize, b * segs)


def labels_plain(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the full ``(B, c, N)`` distances and
    ``torch.argmin``, which returns the first minimum."""
    d2 = (v.to(torch.float32)[:, :, None]
          - x.to(torch.float32)[:, None, :]) ** 2
    return torch.argmin(d2, dim=1).to(torch.int32)


def _checked(x: torch.Tensor, v: torch.Tensor) -> bool:
    """Validate the arguments; True when the kernel runs (a CUDA tensor),
    False for the plain version (a CPU tensor)."""
    if x.dim() != 2 or v.dim() != 2 or v.shape[0] != x.shape[0]:
        raise ValueError(f"labels takes (B, N) pixels and (B, c) centers, "
                         f"got {tuple(x.shape)} and {tuple(v.shape)}")
    if x.device != v.device:
        raise ValueError(f"pixels on {x.device}, centers on {v.device}")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"labels runs on cpu or cuda, not {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"the labels kernel takes {list(_DTYPES)}, got "
                        f"{x.dtype}")
    if v.dtype != torch.float32:
        raise TypeError(f"centers must be float32, got {v.dtype}")
    if not (x.is_contiguous() and v.is_contiguous()):
        raise ValueError("the labels kernel needs contiguous inputs")
    if not 1 <= v.shape[1] <= MAX_C:
        raise ValueError(f"labels kernel: 1 <= c <= {MAX_C}, got "
                         f"c={v.shape[1]}")
    return True


def labels(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``(B, N)`` float32 / uint8 / int32 pixels + ``(B, c)`` float32
    centers -> ``(B, N)`` int32 labels, for a bucket of any number of
    lanes. A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel (one launch) or raises."""
    if not _checked(x, v):
        return labels_plain(x, v)
    b, n = x.shape
    c = v.shape[1]
    out = torch.empty((b, n), dtype=torch.int32, device=x.device)
    if b and n and not op_cost.kernel_io((x, v), (out,)):
        plan = labels_plan(b, n, x.element_size())
        fn = getattr(_build.library(), _DTYPES[x.dtype])
        with _build.on_device(x):
            _build.check(fn(x.data_ptr(), b, n, v.data_ptr(), c, plan.segs,
                            out.data_ptr(), _build.stream_of(x)), "labels")
        labels.launches += 1
    return out


#: kernel launches since the count was last set to 0
labels.launches = 0
