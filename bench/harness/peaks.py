"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W): float32 outside the tensor cores and HBM3 bandwidth.
A roofline share is stated against these, with the card's power limit
read beside it."""
from __future__ import annotations

import subprocess
from typing import Optional

FP32_FLOPS = 67e12          # FLOP/s, float32 without tensor cores
HBM_BYTES = 3.35e12         # B/s


def roofline_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two
    bounds."""
    return max(flops / FP32_FLOPS, nbytes / HBM_BYTES)


def power_limit_w() -> Optional[float]:
    """The card's power limit as nvidia-smi reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
