"""Fuzzy C-Means core in PyTorch: the elementary math every variant shares.

Layout convention, as in the JAX package: memberships are
**cluster-major**, ``u[j, i]`` = degree of row ``i`` in cluster ``j``,
shape ``(c, N)``. Features ``x`` are ``(N,)`` (grayscale) or ``(N, F)``;
centers ``(c,)`` or ``(c, F)`` correspondingly. The functions also
broadcast over leading batch dimensions when given explicit ``(..., N,
F)`` / ``(..., c, F)`` layouts, which is how the batched solver uses
them.

The exponents are the reference's: ``-1/(m-1)`` and ``m`` as Python
floats. With ``m == 2`` they are ``-1`` and ``2``, which ``torch.pow``
computes exactly as ``1 / d`` and ``u * u`` (the same special cases XLA
takes), so the plain versions, the CUDA kernel and the JAX package
agree up to summation order.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_D2_FLOOR = 1e-12  # distance clamp before the negative power; exact zeros
                   # are handled separately with a one-hot membership.


@dataclasses.dataclass(frozen=True)
class FCMConfig:
    """Hyper-parameters; defaults follow the paper (c=4, m=2, eps=0.005)."""
    n_clusters: int = 4
    m: float = 2.0
    eps: float = 5e-3
    max_iters: int = 300
    seed: int = 0
    # 'membership' is the paper's ||u_new - u_old||_inf < eps test;
    # 'centers' the device-resident equivalent the fused paths use.
    convergence: str = "membership"


def _as_2d(x: torch.Tensor) -> torch.Tensor:
    return x[:, None] if x.dim() == 1 else x


def pairwise_d2(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distances, shape (c, N)."""
    x2 = _as_2d(x)            # (..., N, F)
    v2 = _as_2d(v)            # (..., c, F)
    return ((v2[..., :, None, :] - x2[..., None, :, :]) ** 2).sum(-1)


def membership_from_d2(d2: torch.Tensor, m: float) -> torch.Tensor:
    """Eq. 4: u_ji = d_ji^(-2/(m-1)) / sum_k d_ki^(-2/(m-1)); (c, N).
    Rows whose distance to some center is exactly 0 split their mass
    evenly over those centers."""
    p = torch.clamp(d2, min=_D2_FLOOR) ** (-1.0 / (m - 1.0))
    u = p / p.sum(dim=-2, keepdim=True)
    zero = d2 <= 0.0
    any_zero = zero.any(dim=-2, keepdim=True)
    u_zero = zero.to(u.dtype) / zero.sum(dim=-2, keepdim=True).clamp(
        min=1).to(u.dtype)
    return torch.where(any_zero, u_zero, u)


def update_membership(x: torch.Tensor, v: torch.Tensor,
                      m: float) -> torch.Tensor:
    """Eq. 4 from pixels + centers; (c, N)."""
    return membership_from_d2(pairwise_d2(x, v), m)


def update_centers(x: torch.Tensor, u: torch.Tensor,
                   m: float) -> torch.Tensor:
    """Eq. 3: v_j = sum_i u_ji^m x_i / sum_i u_ji^m. Shape matches x's
    feature layout: (c,) for (N,) input, (c, F) for (N, F)."""
    um = u ** m
    num = (um[:, :, None] * _as_2d(x)[None, :, :]).sum(dim=1)
    v = num / torch.clamp(um.sum(dim=1)[:, None], min=_D2_FLOOR)
    return v[:, 0] if x.dim() == 1 else v


def labels_from_centers(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """argmin distance == argmax membership for any m > 1; ties go to
    the lowest index (``torch.argmin`` returns the first minimum)."""
    return torch.argmin(pairwise_d2(x, v), dim=-2).to(torch.int32)


def linspace_centers(x: torch.Tensor, c: int) -> torch.Tensor:
    """Deterministic center init: c points evenly spaced in [min, max]."""
    x2 = _as_2d(x)
    lo = x2.min(dim=0).values
    hi = x2.max(dim=0).values
    frac = (torch.arange(c, dtype=x2.dtype, device=x2.device) + 0.5) / c
    v = lo[None, :] + frac[:, None] * (hi - lo)[None, :]
    return v[:, 0] if x.dim() == 1 else v


@dataclasses.dataclass
class FCMResult:
    centers: torch.Tensor          # (c,) or (c, F)
    labels: torch.Tensor           # (N,) int32
    n_iters: int
    final_delta: float
    membership: Optional[torch.Tensor] = None   # (c, N) if kept
    #: False when the solve exhausted max_iters without meeting its
    #: center-movement tolerance.
    converged: bool = True
    #: False when the returned centers contain NaN/Inf.
    healthy: bool = True
