"""Ingest binning: ``(B, N)`` pixels -> ``(B, n_bins)`` float32 counts.

The CUDA kernel (``csrc/histogram_bin.cu``) replaces the TPU's one-pass
comparison binning (``repro/kernels/histogram_bin.py``). Bin semantics
are ``clip(int(x), 0, n_bins - 1)``; counts are integers, so the kernel,
the plain version and ``np.bincount`` agree bit for bit up to 2**24
pixels a lane.
"""
from __future__ import annotations

import torch

from . import _build

#: Dynamic shared memory a block may take without opting in (48 KB)
#: bounds the histogram the kernel keeps per block.
MAX_BINS = 12288
#: Pixels one block bins: a 217x181 slice is 5 blocks, 1 000 000 pixels
#: 123; each block flushes at most n_bins global atomics.
PER_BLOCK = 8192
#: gridDim.y carries the lane index.
MAX_LANES = 65535


def histogram_bin_plain(px: torch.Tensor, n_bins: int = 256) -> torch.Tensor:
    """The plain PyTorch version: truncate, clamp, scatter-add ones."""
    idx = px.to(torch.int64).clamp_(0, n_bins - 1)
    counts = torch.zeros((px.shape[0], n_bins), dtype=torch.int64,
                         device=px.device)
    counts.scatter_add_(1, idx, torch.ones_like(idx))
    return counts.to(torch.float32)


def histogram_bin(px: torch.Tensor, n_bins: int = 256) -> torch.Tensor:
    """``(B, N)`` uint8 or int32 pixels -> ``(B, n_bins)`` float32 counts.
    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    if px.dim() != 2:
        raise ValueError(f"histogram_bin takes (B, N) pixels, got "
                         f"{tuple(px.shape)}")
    if not 1 <= n_bins <= MAX_BINS:
        raise ValueError(f"n_bins must be in [1, {MAX_BINS}], got {n_bins}")
    if px.device.type == "cpu":
        return histogram_bin_plain(px, n_bins)
    if px.device.type != "cuda":
        raise ValueError(f"histogram_bin runs on cpu or cuda, not "
                         f"{px.device}")
    if px.dtype not in (torch.uint8, torch.int32):
        raise TypeError(f"the binning kernel takes uint8 or int32 pixels, "
                        f"got {px.dtype}")
    if not px.is_contiguous():
        raise ValueError("the binning kernel needs contiguous pixels")
    b, n = px.shape
    if b > MAX_LANES:
        raise ValueError(f"at most {MAX_LANES} lanes a launch, got {b}")
    counts = torch.zeros((b, n_bins), dtype=torch.int32, device=px.device)
    if b and n:
        lib = _build.library()
        fn = (lib.histogram_bin_u8 if px.dtype == torch.uint8
              else lib.histogram_bin_i32)
        _build.check(fn(px.data_ptr(), b, n, n_bins, PER_BLOCK,
                        counts.data_ptr(), _build.stream_of(px)),
                     "histogram_bin")
        histogram_bin.launches += 1
    return counts.to(torch.float32)


#: kernel launches since the count was last set to 0
histogram_bin.launches = 0
