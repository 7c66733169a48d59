"""The weighted-feature FCM solver core (flat problems).

Every FCM variant iterates ``v -> step(v)``, where ``step`` substitutes
the Eq. 4 membership into the Eq. 3 weighted center update over a set of
(feature row, weight) pairs: pixels weigh 1, histogram bins weigh their
counts. :class:`FCMProblem` names the rows, :func:`solve` runs one
problem and :func:`solve_batched` a stacked batch, each lane stopping at
its own convergence point.

Backends: ``"auto"`` (the registry's pick: the whole-solve kernel on the
card, the plain loop on the CPU), ``"reference"`` (the plain loop, on
whichever device the problem lives) and ``"resident"`` (the whole-solve
kernel; on the CPU its plain version). Stencil (FCM_S) problems, the
staged and sequential backends, the HBM-streamed whole-solve and
per-lane salvage are not ported yet.

Every entry point runs on the card unless the caller passes
``device="cpu"``; with no card and no device named, it raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from .. import _device as DV
from ..kernels import ops as kops
from . import fcm as F
from . import histogram as H

_D2_FLOOR = 1e-12
_BIG = 3.4e38

BACKENDS = ("auto", "reference", "resident")


def _record_telemetry(kind: str, impl: str, n_iters: int,
                      final_delta: Optional[float] = None,
                      lane_iters=None) -> None:
    """Convergence telemetry into the process-wide obs registry:
    solver.solves/solver.lanes counters, the solver.iters histogram (per
    lane for batched solves) and the solver.last_final_delta gauge."""
    from repro_torch import obs
    reg = obs.default_registry()
    reg.counter("solver.solves", kind=kind, impl=impl).inc()
    h = reg.histogram("solver.iters", edges=obs.ITER_EDGES, kind=kind)
    if lane_iters is not None:
        reg.counter("solver.lanes", kind=kind, impl=impl).inc(
            len(lane_iters))
        for it in lane_iters:
            h.record(int(it))
    else:
        reg.counter("solver.lanes", kind=kind, impl=impl).inc(1)
        h.record(int(n_iters))
    if final_delta is not None and not np.isnan(final_delta):
        reg.gauge("solver.last_final_delta", kind=kind).set(
            float(final_delta))


# ---------------------------------------------------------------------------
# Problem specification
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FCMProblem:
    """One weighted-feature flat FCM problem (or a stacked batch).

    ``features`` is ``(K,)`` / ``(K, D)`` rows; with ``batch=True`` a
    leading lane axis is added everywhere and lanes are independent
    problems. ``weights`` are per-row multiplicities (``None`` = 1).
    ``init`` overrides the weighted-support linspace ``v0``. Every array
    is held as float32 on ``device`` (``None`` = the card).
    """
    features: Any
    weights: Any = None
    c: int = 4
    m: float = 2.0
    init: Any = None
    batch: bool = False
    device: Any = None

    def __post_init__(self):
        dev = DV.resolve_device(self.device)
        object.__setattr__(self, "device", dev)
        feats = DV.as_f32(self.features, dev)
        object.__setattr__(self, "features", feats)
        for name in ("weights", "init"):
            val = getattr(self, name)
            if val is not None:
                object.__setattr__(self, name, DV.as_f32(val, dev))
        lead = 1 if self.batch else 0
        if feats.dim() - lead not in (1, 2):
            raise ValueError(
                f"flat problems need (K,) or (K, D) feature rows"
                f"{' per lane' if self.batch else ''}, got shape "
                f"{tuple(feats.shape)}")

    @property
    def scalar(self) -> bool:
        """True when centers should come back featureless, shape (c,)."""
        return self.features.dim() - (1 if self.batch else 0) == 1

    @property
    def n_feat(self) -> int:
        return 1 if self.scalar else self.features.shape[-1]

    @property
    def n_rows(self) -> int:
        """Rows per lane, what the kernels' bounds are checked against."""
        return int(self.features.shape[1 if self.batch else 0])

    def rows(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Canonical ``(K, D)`` rows + ``(K,)`` weights (with
        ``batch=True`` a leading lane axis on both)."""
        feats = self.features
        if self.scalar:
            feats = feats[..., None]
        w = self.weights
        if w is None:
            w = torch.ones(feats.shape[:-1], dtype=torch.float32,
                           device=feats.device)
        return feats, w


def _cfg_c_m(cfg, c, m):
    if cfg is not None:
        c = cfg.n_clusters if c is None else c
        m = cfg.m if m is None else m
    return (4 if c is None else int(c)), (2.0 if m is None else float(m))


def pixel_problem(x, cfg: Optional[F.FCMConfig] = None, *,
                  c: Optional[int] = None, m: Optional[float] = None,
                  v0=None, device=None) -> FCMProblem:
    """Uncompressed pixels: ``x`` is ``(N,)`` grayscale or ``(N, D)``
    feature rows, every row weighing 1."""
    c, m = _cfg_c_m(cfg, c, m)
    return FCMProblem(features=x, c=c, m=m, init=v0, device=device)


def histogram_problem(x=None, cfg: Optional[F.FCMConfig] = None, *,
                      hist=None, n_bins: int = 256,
                      c: Optional[int] = None, m: Optional[float] = None,
                      v0=None, device=None) -> FCMProblem:
    """Histogram-compressed scalar FCM: ``n_bins`` (value, count) rows.
    Pass pixels ``x`` (binned here, by the binning kernel on the card)
    or a prebuilt ``hist``."""
    c, m = _cfg_c_m(cfg, c, m)
    dev = DV.resolve_device(device)
    if hist is None:
        if x is None:
            raise ValueError("histogram_problem needs pixels x or a hist")
        hist = H.intensity_histogram(DV.as_f32(x, dev), n_bins)
    vals = torch.arange(n_bins, dtype=torch.float32, device=dev)
    return FCMProblem(features=vals, weights=hist, c=c, m=m, init=v0,
                      device=dev)


def batch_problems(features, weights=None, *,
                   cfg: Optional[F.FCMConfig] = None,
                   c: Optional[int] = None, m: Optional[float] = None,
                   device=None) -> FCMProblem:
    """Stack same-shape independent flat problems along a leading lane
    axis: ``(B, K[, D])`` rows (+ ``(B, K)`` weights)."""
    c, m = _cfg_c_m(cfg, c, m)
    return FCMProblem(features=features, weights=weights, c=c, m=m,
                      batch=True, device=device)


# ---------------------------------------------------------------------------
# The canonical center update and convergence loops
# ---------------------------------------------------------------------------

def weighted_center_step(feats: torch.Tensor, w: torch.Tensor,
                         v: torch.Tensor, m: float) -> torch.Tensor:
    """THE core update: one fused ``v -> v'`` step of weighted FCM.
    ``feats`` ``(K,)`` or ``(K, D)``, ``w`` ``(K,)`` (zero rows are
    inert), ``v`` ``(c, D)`` -> ``(c, D)``; leading batch dimensions
    broadcast when ``feats`` is given as ``(..., K, D)``.

    The numerator is a broadcast multiply and sum, not a matmul, as in
    the reference: the reduction order stays that of
    :func:`repro_torch.core.fcm.update_centers`."""
    feats2 = F._as_2d(feats)
    u = F.update_membership(feats2, v, m)                 # (..., c, K)
    um = (u ** m) * w[..., None, :]
    num = (um[..., :, :, None] * feats2[..., None, :, :]).sum(dim=-2)
    den = torch.clamp(um.sum(dim=-1)[..., None], min=_D2_FLOOR)
    return num / den


def while_centers(step, v0, tol, max_iters):
    """Center fixed point: iterate ``v -> step(v)`` until
    ``max|v' - v| < tol`` or ``max_iters``. Returns ``(v, delta, it)``
    with ``delta`` a 0-dim tensor and ``it`` an int."""
    v = v0
    delta = torch.tensor(float("inf"), dtype=torch.float32, device=v.device)
    it = 0
    while bool(delta >= tol) and it < max_iters:
        v_new = step(v)
        delta = (v_new - v).abs().max()
        v = v_new
        it += 1
    return v, delta, it


def masked_while_centers(step, v0, tol, max_iters, active=None):
    """Per-lane-masked batched fixed point: run ``v' = step(v)``
    (``(B, cd) -> (B, cd)``) until every lane's ``max|v' - v| < tol[b]``
    or ``max_iters``. Converged lanes freeze (centers verbatim,
    iteration counters stop), so each lane's trajectory is a solo
    :func:`while_centers` run. ``active`` (B,) bool names the real
    lanes: inactive lanes start frozen with ``v0``, 0 iterations and a
    0.0 residual.

    Returns ``(v, delta (B,), iters (B,) int32, total_it)``."""
    b = v0.shape[0]
    dev = v0.device
    tol = torch.as_tensor(tol, dtype=torch.float32, device=dev)
    if active is None:
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        delta = torch.full((b,), float("inf"), dtype=torch.float32,
                           device=dev)
    else:
        done = ~torch.as_tensor(active, dtype=torch.bool, device=dev)
        delta = torch.where(done, 0.0, float("inf")).to(torch.float32)
    iters = torch.zeros((b,), dtype=torch.int32, device=dev)
    v = v0
    it = 0
    while not bool(done.all()) and it < max_iters:
        v_new = torch.where(done[:, None], v, step(v))
        d = (v_new - v).abs().max(dim=1).values
        delta = torch.where(done, delta, d)
        iters = iters + (~done).to(torch.int32)
        done = done | (d < tol)
        v = v_new
        it += 1
    return v, delta, iters, it


# ---------------------------------------------------------------------------
# Init + tolerance from the weighted feature support
# ---------------------------------------------------------------------------

def weighted_support(feats2: torch.Tensor, w: torch.Tensor):
    """Per-dimension (lo, hi) over rows with nonzero weight — zero
    histogram bins and batch padding stretch neither the init nor the
    tolerance. ``(..., K, D)``, ``(..., K)`` -> ``(..., D)`` x2."""
    active = (w > 0)[..., None]
    lo = torch.where(active, feats2, _BIG).min(dim=-2).values
    hi = torch.where(active, feats2, -_BIG).max(dim=-2).values
    return lo, hi


def linspace_from_support(lo: torch.Tensor, hi: torch.Tensor,
                          c: int) -> torch.Tensor:
    """lo/hi (..., D) -> per-dimension linspace centers (..., c, D)."""
    frac = (torch.arange(c, dtype=lo.dtype, device=lo.device) + 0.5) / c
    return lo[..., None, :] + frac[:, None] * (hi - lo)[..., None, :]


def _tol_from_range(rng, eps):
    """Center-movement tolerance: the membership test at eps corresponds
    to a center test at ~eps * data-range (Lipschitz); scaled by 0.1."""
    return eps * torch.where(rng > 0, rng, 1.0) * 0.1


def lane_tolerances(problem: FCMProblem, eps: float) -> np.ndarray:
    """Per-lane center-movement tolerances the batched solve derives
    (same float32 arithmetic), so a post-solve pass can decide per lane
    whether ``final_delta`` met the stop test."""
    feats, w = problem.rows()
    lo, hi = weighted_support(feats, w)
    return _tol_from_range((hi - lo).max(dim=-1).values,
                           eps).cpu().numpy()


def _single_init(problem: FCMProblem, eps: float, tol: Optional[float]):
    """(v0 (c, D), tol) for one problem."""
    flat, w = problem.rows()
    lo, hi = weighted_support(flat, w)
    if problem.init is not None:
        v0 = F._as_2d(problem.init)
    else:
        v0 = linspace_from_support(lo, hi, problem.c)
    if tol is None:
        # The batched per-lane formula, so a lane matches its solo solve.
        tol = float(_tol_from_range((hi - lo).max(), eps))
    return v0, tol


# ---------------------------------------------------------------------------
# The batched flat solve
# ---------------------------------------------------------------------------

def flat_batched_solve(feats, w, c, m, eps, max_iters,
                       impl: str = "reference", active=None):
    """Batched flat solve: feats (B, K, D), w (B, K) -> (v (B, c, D),
    delta (B,), iters (B,) int32, total). ``impl="reference"`` is the
    per-lane-masked plain loop; ``"resident"`` runs every lane's
    complete loop inside one whole-solve kernel launch (its plain
    version on the CPU). ``total`` is the loop's trip count, the
    largest lane's iterations. ``active`` is the real-lane mask of
    :func:`masked_while_centers` (reference impl only)."""
    b, _, d = feats.shape
    lo, hi = weighted_support(feats, w)                      # (B, D) each
    v0 = linspace_from_support(lo, hi, c)                    # (B, c, D)
    tol = _tol_from_range((hi - lo).max(dim=1).values, eps)

    if impl == "resident":
        if active is not None:
            raise ValueError("active lane masks are supported by the "
                             "reference impl only (the whole-solve "
                             "kernel runs every lane)")
        x, wt = kops.tile_rows_batched(feats, w)
        solve_fn = kops.build_step("flat", "resident", x=x, w=wt, m=m,
                                   max_iters=max_iters)
        v, delta, iters = solve_fn(v0, tol)
        return v, delta, iters, iters.max()

    def flat_step(vflat):
        return weighted_center_step(feats, w, vflat.reshape(b, c, d),
                                    m).reshape(b, c * d)

    v, delta, iters, it = masked_while_centers(
        flat_step, v0.reshape(b, c * d), tol, max_iters, active=active)
    return v.reshape(b, c, d), delta, iters, it


# ---------------------------------------------------------------------------
# solve / solve_batched
# ---------------------------------------------------------------------------

def _resolve(cfg, eps, max_iters):
    if eps is None:
        eps = cfg.eps if cfg is not None else F.FCMConfig.eps
    if max_iters is None:
        max_iters = cfg.max_iters if cfg is not None \
            else F.FCMConfig.max_iters
    return float(eps), int(max_iters)


def _on_device(problem: FCMProblem, device) -> FCMProblem:
    if device is None or DV.resolve_device(device) == problem.device:
        return problem
    return dataclasses.replace(problem, device=DV.resolve_device(device))


def _select_impl(problem: FCMProblem, backend: str,
                 batch: bool = False) -> str:
    """Registry dispatch on the problem's device and shape."""
    prefer = {"auto": None, "reference": "reference",
              "resident": "resident"}[backend]
    return kops.select_step(
        "flat", prefer=prefer, platform=problem.device.type,
        n_feat=problem.n_feat, batched=batch, n_rows=problem.n_rows,
        c=problem.c).name


def solve(problem: FCMProblem, cfg: Optional[F.FCMConfig] = None, *,
          eps: Optional[float] = None, max_iters: Optional[int] = None,
          tol: Optional[float] = None, backend: str = "auto",
          keep_membership: bool = False, device=None) -> F.FCMResult:
    """Solve one :class:`FCMProblem` to convergence on the problem's
    device (or ``device``). The center-movement tolerance is ``eps *
    feature-range * 0.1`` unless an absolute ``tol`` is given. Labels
    come back per row."""
    if problem.batch:
        raise ValueError("solve() takes a single problem; use "
                         "solve_batched() for batch=True problems")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; the port has "
                         f"{BACKENDS}")
    problem = _on_device(problem, device)
    eps, max_iters = _resolve(cfg, eps, max_iters)
    impl = _select_impl(problem, backend)
    v0, tol = _single_init(problem, eps, tol)
    c, m = problem.c, problem.m
    feats2, w = problem.rows()

    if impl == "resident":
        x, wt = kops.tile_rows_batched(feats2[None], w[None])
        solve_fn = kops.build_step("flat", "resident", x=x, w=wt, m=m,
                                   max_iters=max_iters)
        v, delta, iters = solve_fn(
            v0[None].contiguous(),
            torch.tensor([tol], dtype=torch.float32, device=x.device))
        v, delta, it = v[0], delta[0], int(iters[0])
    else:
        step = kops.build_step("flat", "reference", feats=feats2, weights=w,
                               m=m)
        v, delta, it = while_centers(step, v0, tol, max_iters)
    labels = kops.defuzzify_labels(feats2, v)
    u = F.update_membership(feats2, v, m) if keep_membership else None
    centers = v[:, 0] if problem.scalar else v
    final_delta = float(delta)
    _record_telemetry("flat", impl, it, final_delta)
    return F.FCMResult(centers=centers, labels=labels, n_iters=it,
                       final_delta=final_delta, membership=u,
                       converged=bool(final_delta < tol),
                       healthy=bool(torch.isfinite(centers).all()))


@dataclasses.dataclass
class BatchedFCMResult:
    """Per-lane results of a batched solve (+ per-lane health flags)."""
    centers: torch.Tensor         # (B, c) scalar or (B, c, D)
    n_iters: np.ndarray           # (B,) int32, per-lane iteration counts
    final_delta: np.ndarray       # (B,) float32, per-lane last center move
    total_iters: int              # the largest lane's iteration count
    #: (B,) bool — lane met its center-movement tolerance.
    converged: Optional[np.ndarray] = None
    #: (B,) bool — lane's centers are all finite.
    healthy: Optional[np.ndarray] = None


def solve_batched(problem: FCMProblem, cfg: Optional[F.FCMConfig] = None, *,
                  eps: Optional[float] = None,
                  max_iters: Optional[int] = None,
                  backend: str = "auto", device=None) -> BatchedFCMResult:
    """Solve a stacked batch of independent problems (``batch=True``) on
    the problem's device (or ``device``): one whole-solve kernel launch
    on the card, the per-lane-masked plain loop on the CPU. Each lane
    freezes at its own convergence point, so its trajectory is what
    :func:`solve` gives it alone. Every lane gets ``converged`` and
    ``healthy`` flags."""
    if not problem.batch:
        raise ValueError("solve_batched() needs a batch=True problem "
                         "(see batch_problems())")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; the port has "
                         f"{BACKENDS}")
    problem = _on_device(problem, device)
    eps, max_iters = _resolve(cfg, eps, max_iters)
    impl = _select_impl(problem, backend, batch=True)
    feats, w = problem.rows()
    v, delta, iters, total = flat_batched_solve(
        feats, w, problem.c, problem.m, eps, max_iters, impl=impl)
    if problem.scalar:
        v = v[..., 0]
    n_iters = iters.cpu().numpy()
    final_delta = delta.cpu().numpy()
    cen = v.cpu().numpy()
    b = cen.shape[0]
    lane_tol = lane_tolerances(problem, eps)
    healthy = np.isfinite(cen.reshape(b, -1)).all(axis=1)
    converged = (final_delta < lane_tol) & np.isfinite(final_delta)
    total = int(total)
    _record_telemetry("flat", impl, total, float(np.nanmax(final_delta)),
                      lane_iters=n_iters)
    return BatchedFCMResult(centers=v, n_iters=n_iters,
                            final_delta=final_delta, total_iters=total,
                            converged=converged, healthy=healthy)
