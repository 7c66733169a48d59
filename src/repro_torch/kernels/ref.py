"""The JAX package's kernel oracles (``repro/kernels/ref.py``) under
their names, each the port's plain PyTorch version of its kernel.

All take grayscale pixels ``x`` (N,), cluster-major memberships ``u``
(c, N) and optional validity weights ``w`` (N,), as tensors or numpy
arrays (float32 on the tensor's device, or the CPU for numpy).
"""
from __future__ import annotations

import torch

from .fcm_centers import center_partials_plain, fused_partials_plain
from .fcm_membership import membership_plain
from .selective_scan import selective_scan_ref  # noqa: F401  (the oracle)


def _f32(t):
    return None if t is None else torch.as_tensor(t, dtype=torch.float32)


def membership_ref(x, v, m):
    """Eq. 4; (c, N) float32."""
    return membership_plain(_f32(x), _f32(v), m)


def center_partials_ref(x, u, m, w=None):
    """Summed numerator and denominator of Eq. 3: num (c,), den (c,)."""
    return center_partials_plain(_f32(x), _f32(u), m, _f32(w))


def fused_partials_ref(x, v, m, w=None):
    """Eq. 4 substituted into Eq. 3's partial sums: num (c,), den (c,)."""
    return fused_partials_plain(_f32(x), _f32(w), _f32(v), m)


def fused_step_ref(x, v, m, w=None):
    """One fused v -> v' center iteration."""
    num, den = fused_partials_ref(x, v, m, w)
    return num / torch.clamp(den, min=1e-12)
