"""Device resolution shared by the port's entry points.

Every entry point runs on the card unless the caller names another
device; asked for nothing on a machine without a card, it raises rather
than land on the CPU unnoticed.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means the card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the port runs on 'cuda' or 'cpu', got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch versions on the CPU")
    return dev


def as_f32(x, device: torch.device) -> torch.Tensor:
    """``x`` (numpy array, tensor or scalar) as float32 on ``device``.
    numpy float64 inputs become float32 explicitly here, before any
    arithmetic touches them."""
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()        # torch.as_tensor cannot wrap read-only memory
    return torch.as_tensor(x).to(device=device, dtype=torch.float32)
