"""Hard labels from centers: ``(B, N)`` scalar pixels + ``(B, c)``
centers -> ``(B, N)`` int32 argmin-distance labels, ties to the lowest
index.

The CUDA kernel (``csrc/defuzzify.cu``) replaces the TPU's fused label
kernel (``repro/kernels/defuzzify.py::labels_pallas``): the ``(c, N)``
distance matrix never reaches device memory.
"""
from __future__ import annotations

import torch

from . import _build

#: gridDim.y carries the lane index, so a call launches once a chunk of
#: at most this many lanes (:func:`_build.lane_chunks`); a lane's labels
#: are its own, so the chunks change no bit.
MAX_LANES = 65535
#: centers per lane the kernel stages in shared memory (48 KB)
MAX_C = 12288

_DTYPES = {torch.float32: "labels_f32", torch.uint8: "labels_u8",
           torch.int32: "labels_i32"}


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
    the kernel (once a chunk of :data:`MAX_LANES` lanes) or raises."""
    if not _checked(x, v):
        return labels_plain(x, v)
    b, n = x.shape
    c = v.shape[1]
    out = torch.empty((b, n), dtype=torch.int32, device=x.device)
    if b and n:
        fn = getattr(_build.library(), _DTYPES[x.dtype])
        for i0, i1 in _build.lane_chunks(b, MAX_LANES):
            _build.check(fn(x[i0:].data_ptr(), i1 - i0, n, v[i0:].data_ptr(),
                            c, out[i0:].data_ptr(), _build.stream_of(x)),
                         "labels")
            labels.launches += 1
    return out


#: kernel launches since the count was last set to 0
labels.launches = 0
