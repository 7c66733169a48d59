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


def center_terms(x: torch.Tensor, u: torch.Tensor, m: float):
    """Per-pixel numerator/denominator terms of Eq. 3 (the paper's first
    CUDA kernel), not yet summed: ``(num_terms (c, N, F), den_terms (c,
    N))``."""
    um = u ** m
    return um[:, :, None] * _as_2d(x)[None, :, :], um


def objective(x: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
              m: float) -> torch.Tensor:
    """Eq. 1: J = sum_ij u_ji^m d_ji^2."""
    return ((u ** m) * pairwise_d2(x, v)).sum()


def defuzzify(u: torch.Tensor) -> torch.Tensor:
    """Maximal-membership hard assignment, ``(N,)`` int32; ties go to
    the lowest index (``torch.argmax`` returns the first maximum)."""
    return torch.argmax(u, dim=0).to(torch.int32)


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


def random_membership(generator: torch.Generator, c: int, n: int,
                      device=None) -> torch.Tensor:
    """Paper Step 2: random memberships in [1e-3, 1), each pixel's
    column normalized to sum to 1; ``(c, n)`` float32. Drawn from
    ``generator``, a CPU :class:`torch.Generator`, on the CPU and then
    moved to ``device``, so a run on the card and one on the CPU with
    the same seed start from the same ``u``. (``jax.random``'s bits
    differ; to start both packages alike, pass one ``u0`` to both.)"""
    u = torch.empty((c, n), dtype=torch.float32).uniform_(
        1e-3, 1.0, generator=generator)
    u = u / u.sum(dim=0, keepdim=True)
    return u if device is None else u.to(device)


# --- the paper's staged pipeline, one plain PyTorch op per paper kernel -----

def _stage_terms(x, u, m):
    # CUDA kernel #1: heavy per-pixel math, results materialized.
    return center_terms(x, u, m)


def _stage_reduce_num(num_terms):
    # CUDA kernel #2: tree-reduce the numerator (per cluster).
    return num_terms.sum(dim=1)


def _stage_reduce_den(den_terms):
    # CUDA kernel #3: tree-reduce the denominator (per cluster).
    return den_terms.sum(dim=1)


def _stage_combine(num, den):
    # CUDA kernel #4 (one thread in the paper): the final division.
    return num / torch.clamp(den[:, None], min=_D2_FLOOR)


def _stage_membership(x, v, m):
    # The one-kernel membership phase (paper section 4.3).
    return update_membership(x, v, m)


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


# --- deprecated adapters (the JAX package's fit_* names) --------------------

def fused_center_step(x: torch.Tensor, v: torch.Tensor,
                      m: float) -> torch.Tensor:
    """One ``v -> v'`` step with Eq. 4 substituted into Eq. 3 (the
    unit-weight scalar case of
    :func:`repro_torch.core.solver.weighted_center_step`)."""
    return update_centers(x, update_membership(x, v, m), m)


def fit_baseline(x, cfg: FCMConfig = FCMConfig(), u0=None,
                 device=None) -> FCMResult:
    """DEPRECATED alias for the paper's staged pipeline — use
    ``solver.solve(solver.pixel_problem(x, cfg), backend="staged")``.

    The membership kept between stages, the convergence test read on the
    host each iteration; on the card the stages are the center-partials
    and membership kernels, on the CPU their plain versions, so the JAX
    adapter's ``use_pallas`` switch has no counterpart. On ``device``
    (``None`` = the card)."""
    from . import solver as SV
    SV.warn_deprecated("fit_baseline",
                       "solver.solve(pixel_problem(x), backend='staged')")
    return SV.solve_staged(SV.pixel_problem(x, cfg, device=device),
                           eps=cfg.eps, max_iters=cfg.max_iters,
                           seed=cfg.seed, u0=u0, keep_membership=True)


def fit_fused(x, cfg: FCMConfig = FCMConfig(), v0=None,
              keep_membership: bool = False, device=None) -> FCMResult:
    """DEPRECATED alias for the center fixed point — use
    ``solver.solve(solver.pixel_problem(x, cfg))``. Runs the plain loop
    (``backend="reference"``), as the JAX package's adapter does. On
    ``device`` (``None`` = the card)."""
    from . import solver as SV
    SV.warn_deprecated("fit_fused", "solver.solve(pixel_problem(x, cfg))")
    return SV.solve(SV.pixel_problem(x, cfg, v0=v0, device=device), cfg,
                    backend="reference", keep_membership=keep_membership)
