"""Ingest binning: ``(B, N)`` pixels -> ``(B, n_bins)`` float32 counts.

The CUDA kernel (``csrc/histogram_bin.cu``) replaces the TPU's one-pass
comparison binning (``repro/kernels/histogram_bin.py``): one launch of
(lane, chunk) blocks on a 1-D grid, :func:`bin_blocks` a lane, each
block counting in private byte counters (one for each bin and thread,
64 KB of shared memory) up to 256 bins, shared atomics past them; a
lane's blocks form one cluster up to :data:`MAX_CLUSTER` blocks, else
its last block folds their integer histograms; the kernel writes the
float32 counts. Bin semantics are ``clip(int(x), 0, n_bins - 1)``;
counts are integers, so the kernel, the plain version and
``np.bincount`` agree bit for bit up to 2**24 pixels a lane.
"""
from __future__ import annotations

import torch

from . import _build

#: the most bins: past 256 a block keeps its histogram in 4 bytes of
#: shared memory a bin, 48 KB here (the kernel opts in to shared memory
#: past 48 KB on each device it runs on)
MAX_BINS = 12288
#: threads a block, 16-byte words a thread loads before it bins, and so
#: the bytes of a lane one block takes (20 KB: 20 480 uint8 or 5120 int32
#: pixels; a 217x181 uint8 slice is 2 blocks, so the route's bucket of 64
#: puts one block on each of 128 SMs; the 1000 KB image is 51)
THREADS = 256
WORDS = 5
BLOCK_BYTES = 16 * WORDS * THREADS
#: a lane of 2 to MAX_CLUSTER blocks runs as one thread block cluster
#: (its first block adds the blocks' histograms from their shared
#: memory); a longer lane's last block folds the blocks' rows
MAX_CLUSTER = 8


def bin_blocks(n: int, itemsize: int) -> int:
    """Blocks the kernel gives a lane of ``n`` pixels of ``itemsize``
    bytes: enough :data:`BLOCK_BYTES` spans of aligned 16-byte words to
    cover the lane at any alignment of its first byte. It depends on N
    and the pixel type alone."""
    return -(-(n * itemsize + 15) // BLOCK_BYTES)


def histogram_bin_plain(px: torch.Tensor, n_bins: int = 256) -> torch.Tensor:
    """The plain PyTorch version: truncate, clamp, scatter-add ones."""
    idx = px.to(torch.int64).clamp_(0, n_bins - 1)
    counts = torch.zeros((px.shape[0], n_bins), dtype=torch.int64,
                         device=px.device)
    counts.scatter_add_(1, idx, torch.ones_like(idx))
    return counts.to(torch.float32)


def _checked(px: torch.Tensor, n_bins: int) -> bool:
    """Validate the arguments; True when the kernel runs (a CUDA tensor),
    False for the plain version (a CPU tensor)."""
    if px.dim() != 2:
        raise ValueError(f"histogram_bin takes (B, N) pixels, got "
                         f"{tuple(px.shape)}")
    if not 1 <= n_bins <= MAX_BINS:
        raise ValueError(f"n_bins must be in [1, {MAX_BINS}], got {n_bins}")
    if px.device.type == "cpu":
        return False
    if px.device.type != "cuda":
        raise ValueError(f"histogram_bin runs on cpu or cuda, not "
                         f"{px.device}")
    if px.dtype not in (torch.uint8, torch.int32):
        raise TypeError(f"the binning kernel takes uint8 or int32 pixels, "
                        f"got {px.dtype}")
    if not px.is_contiguous():
        raise ValueError("the binning kernel needs contiguous pixels")
    return True


def histogram_bin(px: torch.Tensor, n_bins: int = 256) -> torch.Tensor:
    """``(B, N)`` uint8 or int32 pixels -> ``(B, n_bins)`` float32 counts,
    for a bucket of any number of lanes. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (one launch, which writes
    the float32 counts itself) or raises."""
    if not _checked(px, n_bins):
        return histogram_bin_plain(px, n_bins)
    b, n = px.shape
    if b == 0 or n == 0:
        return torch.zeros((b, n_bins), dtype=torch.float32, device=px.device)
    blocks = bin_blocks(n, px.element_size())
    out = torch.empty((b, n_bins), dtype=torch.float32, device=px.device)
    part = torch.empty((b * blocks * (-(-n_bins // 4) * 4)
                        if blocks > MAX_CLUSTER else 0,), dtype=torch.int32,
                       device=px.device)
    fn = (_build.library().histogram_bin_u8 if px.dtype == torch.uint8
          else _build.library().histogram_bin_i32)
    with _build.on_device(px):
        _build.check(fn(px.data_ptr(), b, n, n_bins, blocks,
                        part.data_ptr(), _build.zeroed_ints(px, b).data_ptr(),
                        out.data_ptr(), _build.stream_of(px)),
                     "histogram_bin")
    histogram_bin.launches += 1
    return out


#: kernel launches since the count was last set to 0
histogram_bin.launches = 0
