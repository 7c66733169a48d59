"""The FCM solver core: weighted-feature (flat) and stencil (FCM_S)
problems.

Every FCM variant iterates ``v -> step(v)``, where ``step`` substitutes
the Eq. 4 membership into the Eq. 3 weighted center update over a set of
(feature row, weight) pairs: pixels weigh 1, histogram bins weigh their
counts. FCM_S problems keep the pixel grid, and their step is Eq. 4' /
Eq. 3' over each pixel's neighborhood (:mod:`repro_torch.core.spatial`).
:class:`FCMProblem` names the rows or the grid, :func:`solve` runs one
problem and :func:`solve_batched` a stacked batch, each lane stopping at
its own convergence point.

Backends:

- ``"auto"``: the registry's pick. On the card the whole-solve kernel
  when the problem fits it (<= 1024 rows), else the HBM-streamed
  whole-solve (<= 2^20 rows, c <= 8, D <= 16), else the fused kernel
  for scalar rows and the batched fused kernel for vector rows or
  batched lanes (any rows and D, c <= 32); the plain loop on the CPU.
- ``"reference"``: the plain loop, on whichever device the problem
  lives.
- ``"resident"``: the whole-solve kernels, routed by size (resident,
  else streamed); on the CPU the plain loop.
- ``"fused"``: the fused-partials kernel once an iteration, the host
  loop testing center movement (the JAX package's ``"pallas"``).
- ``"staged"``: the paper's pipeline, center-partials kernel then
  membership kernel each iteration, ``max|u' - u| < eps`` read on the
  host (:func:`solve_staged`).
- ``"sequential"``: the paper's single-core numpy comparator on the
  host (:mod:`repro_torch.core.sequential`).

Stencil (FCM_S) problems take ``auto`` (on the card the stencil
whole-solve up to ``fcm_stencil.STENCIL_MAX_PIXELS`` pixels, c <= 8,
else the step kernels under the host loop, c <= 32), ``reference``,
``resident`` (the whole-solve; on the CPU the plain loop) and ``fused``
(the step kernels). :func:`solve_batched` re-solves poisoned lanes, and
lanes a kernel left unconverged, on the plain loop (``salvage=True``).

Every entry point runs on the card unless the caller passes
``device="cpu"``; with no card and no device named, it raises.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Optional, Tuple

import numpy as np
import torch

from .. import _device as DV
from .. import faults as FI
from ..kernels import ops as kops
from . import fcm as F
from . import histogram as H
from . import spatial as SP

_D2_FLOOR = 1e-12
_BIG = 3.4e38

BACKENDS = ("auto", "reference", "resident", "fused", "staged",
            "sequential")


def warn_deprecated(old: str, new: str) -> None:
    """The deprecation warning of the legacy ``fit_*`` adapters, as the
    JAX package words it (``stacklevel=3``: the adapter's caller)."""
    warnings.warn(
        f"{old} is deprecated; build an FCMProblem and call {new} "
        f"(see README 'Migrating from the fit_* zoo')",
        DeprecationWarning, stacklevel=3)


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
class StencilSpec:
    """FCM_S neighborhood regularization: ``alpha`` weighs the
    neighborhood penalty (0 is plain FCM); ``neighbors`` is the stencil
    arity, 4 or 8 for 2-D images, 6 for 3-D volumes."""
    alpha: float = 1.0
    neighbors: int = 4


@dataclasses.dataclass(frozen=True)
class FCMProblem:
    """One FCM problem (or a stacked batch of them).

    ``features`` is ``(K,)`` / ``(K, D)`` weighted rows for flat
    problems, or the pixel grid ``(H, W)`` / ``(D, H, W)`` when
    ``stencil`` is set (FCM_S needs positions). With ``batch=True`` a
    leading lane axis is added everywhere and lanes are independent
    problems. ``weights`` are per-row multiplicities (``None`` = 1;
    stencil problems take none). ``init`` overrides the weighted-support
    linspace ``v0``. Every array is held as float32 on ``device``
    (``None`` = the card).
    """
    features: Any
    weights: Any = None
    c: int = 4
    m: float = 2.0
    init: Any = None
    batch: bool = False
    device: Any = None
    stencil: Optional[StencilSpec] = None

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
        ndim = feats.dim() - lead
        if self.stencil is not None:
            if self.weights is not None:
                raise ValueError("stencil problems take no row weights "
                                 "(every grid pixel weighs 1)")
            if ndim not in (2, 3):
                raise ValueError(
                    f"stencil problems need a (H, W) or (D, H, W) pixel "
                    f"grid{' per lane' if self.batch else ''}, got shape "
                    f"{tuple(feats.shape)}")
            ok = (4, 8) if ndim == 2 else (6,)
            if self.stencil.neighbors not in ok:
                raise ValueError(
                    f"{ndim}-D neighborhoods are "
                    f"{' or '.join(map(str, ok))}-connected, got "
                    f"{self.stencil.neighbors}")
        elif ndim not in (1, 2):
            raise ValueError(
                f"flat problems need (K,) or (K, D) feature rows"
                f"{' per lane' if self.batch else ''}, got shape "
                f"{tuple(feats.shape)}")

    @property
    def scalar(self) -> bool:
        """True when centers should come back featureless, shape (c,)."""
        return (self.stencil is not None
                or self.features.dim() - (1 if self.batch else 0) == 1)

    @property
    def n_feat(self) -> int:
        return 1 if self.scalar else self.features.shape[-1]

    @property
    def n_rows(self) -> int:
        """Rows per lane, what the kernels' bounds are checked against:
        the per-lane pixel count of a stencil problem."""
        lead = 1 if self.batch else 0
        if self.stencil is not None:
            return int(np.prod(self.features.shape[lead:]))
        return int(self.features.shape[lead])

    def rows(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Canonical ``(K, D)`` rows + ``(K,)`` weights (with
        ``batch=True`` a leading lane axis on both) of a flat problem."""
        if self.stencil is not None:
            raise ValueError("stencil problems have no flat rows")
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


def vector_problem(feats, weights=None, cfg: Optional[F.FCMConfig] = None,
                   *, c: Optional[int] = None, m: Optional[float] = None,
                   v0=None, device=None) -> FCMProblem:
    """Weighted vector rows (the superpixel-compression payload)."""
    c, m = _cfg_c_m(cfg, c, m)
    return FCMProblem(features=feats, weights=weights, c=c, m=m, init=v0,
                      device=device)


def spatial_problem(img, cfg=None, *, alpha: Optional[float] = None,
                    neighbors: Optional[int] = None,
                    c: Optional[int] = None, m: Optional[float] = None,
                    v0=None, device=None) -> FCMProblem:
    """FCM_S over a 2-D image or 3-D volume. ``cfg`` may be a
    :class:`repro_torch.core.spatial.SpatialFCMConfig` (supplies
    alpha/neighbors too); 3-D volumes always use the 6-stencil."""
    c, m = _cfg_c_m(cfg, c, m)
    if alpha is None:
        alpha = getattr(cfg, "alpha", 1.0)
    if neighbors is None:
        neighbors = getattr(cfg, "neighbors", 4)
    dev = DV.resolve_device(device)
    img = DV.as_f32(img, dev)
    if img.dim() == 3:
        neighbors = 6
    return FCMProblem(features=img, c=c, m=m, init=v0, device=dev,
                      stencil=StencilSpec(alpha=float(alpha),
                                          neighbors=int(neighbors)))


def batch_problems(features, weights=None, *, stencil=None,
                   cfg: Optional[F.FCMConfig] = None,
                   c: Optional[int] = None, m: Optional[float] = None,
                   device=None) -> FCMProblem:
    """Stack same-shape independent problems along a leading lane axis:
    flat ``(B, K[, D])`` rows (+ ``(B, K)`` weights) or stencil ``(B, H,
    W)`` / ``(B, D, H, W)`` grids."""
    c, m = _cfg_c_m(cfg, c, m)
    return FCMProblem(features=features, weights=weights, c=c, m=m,
                      batch=True, device=device, stencil=stencil)


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
    if problem.stencil is not None:
        return stencil_lane_init(problem.features, problem.c,
                                 eps)[1].cpu().numpy()
    feats, w = problem.rows()
    lo, hi = weighted_support(feats, w)
    return _tol_from_range((hi - lo).max(dim=-1).values,
                           eps).cpu().numpy()


def _single_init(problem: FCMProblem, eps: float, tol: Optional[float]):
    """(v0 (c, D), tol) for one problem."""
    if problem.stencil is not None:
        flat = problem.features.reshape(-1, 1)
        w = torch.ones((flat.shape[0],), dtype=torch.float32,
                       device=flat.device)
    else:
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
    per-lane-masked plain loop; ``"fused_batched"`` the same loop with
    the batched fused-partials kernel as its step (its plain version on
    the CPU); ``"resident"`` / ``"resident_streamed"`` run every lane's
    complete loop inside one whole-solve kernel launch (rows held in
    registers vs re-read from device memory; their plain version on the
    CPU). ``total`` is the loop's trip count, the largest lane's
    iterations. ``active`` is the real-lane mask of
    :func:`masked_while_centers` (the looped impls only)."""
    b, _, d = feats.shape
    lo, hi = weighted_support(feats, w)                      # (B, D) each
    v0 = linspace_from_support(lo, hi, c)                    # (B, c, D)
    tol = _tol_from_range((hi - lo).max(dim=1).values, eps)

    if impl in ("resident", "resident_streamed"):
        if active is not None:
            raise ValueError("active lane masks are supported by the "
                             "reference impl only (the whole-solve "
                             "kernels run every lane)")
        x, wt = kops.tile_rows_batched(feats, w)
        solve_fn = kops.build_step("flat", impl, x=x, w=wt, m=m,
                                   max_iters=max_iters)
        v, delta, iters = solve_fn(v0, tol)
        return v, delta, iters, iters.max()

    if impl == "fused_batched":
        flat_step = kops.build_step("flat", impl, feats=feats, weights=w,
                                    m=m)
    else:
        def flat_step(vflat):
            return weighted_center_step(feats, w, vflat.reshape(b, c, d),
                                        m).reshape(b, c * d)

    v, delta, iters, it = masked_while_centers(
        flat_step, v0.reshape(b, c * d), tol, max_iters, active=active)
    return v.reshape(b, c, d), delta, iters, it


def stencil_lane_init(imgs: torch.Tensor, c: int, eps: float):
    """Each lane's init centers and stop tolerance from its intensity
    range: imgs (B, *grid) -> (v0 (B, c), tol (B,))."""
    flat = imgs.reshape(imgs.shape[0], -1, 1)
    lo, hi = flat.min(dim=1).values, flat.max(dim=1).values   # (B, 1)
    return (linspace_from_support(lo, hi, c)[..., 0],
            _tol_from_range((hi - lo)[:, 0], eps))


def stencil_batched_solve(imgs, c, m, alpha, neighbors, eps, max_iters,
                          impl: str = "reference"):
    """Batched FCM_S solve: imgs (B, *grid) -> (v (B, c), delta (B,),
    iters (B,) int32, total), each lane from its own range's init (see
    :func:`stencil_loop`)."""
    v0, tol = stencil_lane_init(imgs, c, eps)
    return stencil_loop(imgs, v0, tol, m, alpha, neighbors, max_iters, impl)


def stencil_loop(imgs, v0, tol, m, alpha, neighbors, max_iters,
                 impl: str = "reference"):
    """FCM_S fixed point of every lane of imgs (B, *grid) from v0 (B, c)
    to tol (B,). ``impl``: ``"reference"`` runs the plain stencil step
    under the per-lane-masked loop; ``"fused"`` the step kernels under
    the same loop, one launch an iteration for the whole bucket (their
    plain version on the CPU); ``"resident"`` every lane's complete fixed
    point inside one whole-solve launch (its plain version on the CPU).
    Returns ``(v, delta, iters, total)``, ``total`` the largest lane's
    iterations."""
    if impl == "resident":
        solve_fn = kops.build_step("stencil", "resident", x=imgs, m=m,
                                   alpha=alpha, neighbors=neighbors,
                                   max_iters=max_iters)
        v, delta, iters = solve_fn(v0, tol)
        return v, delta, iters, iters.max()
    step = kops.build_step("stencil", impl, x=imgs, m=m, alpha=alpha,
                           neighbors=neighbors)
    return masked_while_centers(step, v0, tol, max_iters)


# ---------------------------------------------------------------------------
# solve / solve_batched
# ---------------------------------------------------------------------------

def _resolve(cfg, eps, max_iters, seed=0):
    if eps is None:
        eps = cfg.eps if cfg is not None else F.FCMConfig.eps
    if max_iters is None:
        max_iters = cfg.max_iters if cfg is not None \
            else F.FCMConfig.max_iters
    if seed is None:
        seed = cfg.seed if cfg is not None else F.FCMConfig.seed
    return float(eps), int(max_iters), int(seed)


def _on_device(problem: FCMProblem, device) -> FCMProblem:
    if device is None or DV.resolve_device(device) == problem.device:
        return problem
    return dataclasses.replace(problem, device=DV.resolve_device(device))


def _select_impl(problem: FCMProblem, backend: str,
                 batch: bool = False) -> str:
    """Registry dispatch on the problem's device and shape.
    ``backend="resident"`` routes a flat problem by size: the
    whole-solve kernel when the rows fit its bounds, the HBM-streamed
    one beyond them."""
    prefer = {"auto": None, "reference": "reference",
              "resident": "resident", "fused": "fused"}[backend]
    kind = "flat" if problem.stencil is None else "stencil"
    if (kind == "flat" and backend == "resident"
            and not kops.step_impl("flat", "resident").fits(
                problem.n_feat, problem.n_rows, problem.c)):
        prefer = "resident_streamed"
    return kops.select_step(
        kind, prefer=prefer, platform=problem.device.type,
        n_feat=problem.n_feat, batched=batch, n_rows=problem.n_rows,
        c=problem.c).name


def solve(problem: FCMProblem, cfg: Optional[F.FCMConfig] = None, *,
          eps: Optional[float] = None, max_iters: Optional[int] = None,
          tol: Optional[float] = None, backend: str = "auto",
          keep_membership: bool = False, u0=None,
          seed: Optional[int] = None, device=None) -> F.FCMResult:
    """Solve one :class:`FCMProblem` to convergence on the problem's
    device (or ``device``). The center-movement tolerance is ``eps *
    feature-range * 0.1`` unless an absolute ``tol`` is given (``tol=-1``
    forces exactly ``max_iters`` iterations). ``seed`` and ``u0`` (a
    ``(c, N)`` initial membership) only matter for the
    membership-initialized ``staged`` and ``sequential`` backends, which
    stop on ``max|u' - u| < eps``. Labels come back per row, or shaped
    like the grid for a stencil problem."""
    if problem.batch:
        raise ValueError("solve() takes a single problem; use "
                         "solve_batched() for batch=True problems")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; the port has "
                         f"{BACKENDS}")
    problem = _on_device(problem, device)
    eps, max_iters, seed = _resolve(cfg, eps, max_iters, seed)

    if backend == "sequential":
        res = _solve_sequential(problem, eps, max_iters, seed, u0)
        _record_telemetry("flat", "sequential", res.n_iters,
                          res.final_delta)
        return res
    if backend == "staged":
        res = solve_staged(problem, eps=eps, max_iters=max_iters,
                           seed=seed, u0=u0,
                           keep_membership=keep_membership)
        _record_telemetry("flat", "staged", res.n_iters, res.final_delta)
        return res

    impl = _select_impl(problem, backend)
    v0, tol = _single_init(problem, eps, tol)
    if problem.stencil is not None:
        return _solve_stencil(problem, impl, v0[:, 0], tol, max_iters,
                              keep_membership)
    c, m = problem.c, problem.m
    feats2, w = problem.rows()

    if impl in ("resident", "resident_streamed"):
        x, wt = kops.tile_rows_batched(feats2[None], w[None])
        solve_fn = kops.build_step("flat", impl, x=x, w=wt, m=m,
                                   max_iters=max_iters)
        v, delta, iters = solve_fn(
            v0[None].contiguous(),
            torch.tensor([tol], dtype=torch.float32, device=x.device))
        v, delta, it = v[0], delta[0], int(iters[0])
    elif impl == "fused":
        # Scalar rows as they are; unit weights are not read at all.
        step = kops.build_step("flat", "fused",
                               x=problem.features.contiguous(),
                               w=problem.weights, m=m)
        v, delta, it = while_centers(step, v0, tol, max_iters)
    elif impl == "fused_batched":
        lane_step = kops.build_step("flat", impl, feats=feats2[None],
                                    weights=w[None], m=m)
        v, delta, it = while_centers(
            lambda v_: lane_step(v_.reshape(1, -1)).reshape(v_.shape), v0,
            tol, max_iters)
    else:
        step = kops.build_step("flat", "reference", feats=feats2, weights=w,
                               m=m)
        v, delta, it = while_centers(step, v0, tol, max_iters)
    labels = kops.defuzzify_labels(feats2, v)
    u = _final_membership(problem, feats2, v) if keep_membership else None
    centers = v[:, 0] if problem.scalar else v
    final_delta = float(delta)
    _record_telemetry("flat", impl, it, final_delta)
    return F.FCMResult(centers=centers, labels=labels, n_iters=it,
                       final_delta=final_delta, membership=u,
                       converged=bool(final_delta < tol),
                       healthy=bool(torch.isfinite(centers).all()))


def _solve_stencil(problem: FCMProblem, impl: str, v0: torch.Tensor,
                   tol: float, max_iters: int,
                   keep_membership: bool) -> F.FCMResult:
    """One FCM_S problem through ``impl`` from ``v0`` (c,); labels are
    the argmax of the final Eq. 4' membership, grid-shaped."""
    img = problem.features
    m = problem.m
    alpha, neighbors = problem.stencil.alpha, problem.stencil.neighbors
    v, delta, iters, _ = stencil_loop(
        img[None].contiguous(), v0[None],
        torch.tensor([tol], dtype=torch.float32, device=img.device), m,
        alpha, neighbors, max_iters, impl)
    v, delta, it = v[0], delta[0], int(iters[0])
    u = SP.spatial_membership(img, v, m, alpha, neighbors)
    labels = F.defuzzify(u.reshape(problem.c, -1)).reshape(img.shape)
    final_delta = float(delta)
    _record_telemetry("stencil", impl, it, final_delta)
    return F.FCMResult(centers=v, labels=labels, n_iters=it,
                       final_delta=final_delta,
                       membership=u if keep_membership else None,
                       converged=bool(final_delta < tol),
                       healthy=bool(torch.isfinite(v).all()))


def _final_membership(problem: FCMProblem, feats2: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """Eq. 4 at the final centers, ``(c, N)``: the membership kernel for
    scalar rows (its plain version on the CPU); vector rows, which no
    kernel takes yet, the plain math."""
    if problem.scalar:
        return kops.membership(problem.features, v[:, 0], problem.m)
    return F.update_membership(feats2, v, problem.m)


@dataclasses.dataclass
class BatchedFCMResult:
    """Per-lane results of a batched solve (+ per-lane health flags)."""
    centers: torch.Tensor         # (B, c) scalar or (B, c, D)
    n_iters: np.ndarray           # (B,) int32, per-lane iteration counts
    final_delta: np.ndarray       # (B,) float32, per-lane last center move
    total_iters: int              # the largest lane's iteration count
    #: (B,) bool — lane met its center-movement tolerance.
    converged: Optional[np.ndarray] = None
    #: (B,) bool — lane's centers are all finite (after salvage).
    healthy: Optional[np.ndarray] = None
    #: (B,) bool — lane was re-solved on the plain loop after the primary
    #: impl left it poisoned or (a kernel impl) unconverged.
    salvaged: Optional[np.ndarray] = None
    #: per-lane labels, where a deprecated ``fit_*`` adapter computes them
    labels: Optional[list] = None


def _salvage_lanes(problem: FCMProblem, idx: np.ndarray, eps: float,
                   max_iters: int):
    """The lanes ``idx`` of a batched problem alone on the plain
    per-lane-masked loop: ``(v, delta, iters, total)``."""
    sel = torch.as_tensor(idx, device=problem.device)
    if problem.stencil is not None:
        return stencil_batched_solve(
            problem.features[sel], problem.c, problem.m,
            problem.stencil.alpha, problem.stencil.neighbors, eps,
            max_iters)
    feats, w = problem.rows()
    v, delta, iters, total = flat_batched_solve(
        feats[sel], w[sel], problem.c, problem.m, eps, max_iters)
    return (v[..., 0] if problem.scalar else v), delta, iters, total


def solve_batched(problem: FCMProblem, cfg: Optional[F.FCMConfig] = None, *,
                  eps: Optional[float] = None,
                  max_iters: Optional[int] = None,
                  backend: str = "auto", device=None,
                  salvage: bool = True) -> BatchedFCMResult:
    """Solve a stacked batch of independent problems (``batch=True``) on
    the problem's device (or ``device``): one whole-solve kernel launch
    on the card (resident or streamed, by lane size; past their bounds
    the batched fused kernel, and for stencil lanes past the
    whole-solve's pixel bound the step kernels, once an iteration), the
    per-lane-masked plain loop on the CPU. Each lane freezes at its own
    convergence point, so its trajectory is what :func:`solve` gives it
    alone. Every lane gets ``converged`` and ``healthy`` flags.

    With ``salvage=True`` (the default), as in the JAX package, lanes
    with non-finite centers, and lanes a kernel impl left unconverged,
    are re-solved together on the plain per-lane-masked loop and
    scattered back (``salvaged``, and the ``solver.salvaged_lanes``
    counter); the other lanes' centers are untouched. An unconverged
    lane of the plain loop is not re-solved: the same math would only
    exhaust ``max_iters`` again."""
    if not problem.batch:
        raise ValueError("solve_batched() needs a batch=True problem "
                         "(see batch_problems())")
    if backend not in ("auto", "reference", "resident"):
        raise ValueError(f"batched solves run the reference or resident "
                         f"steps only; got backend={backend!r}")
    problem = _on_device(problem, device)
    eps, max_iters, _ = _resolve(cfg, eps, max_iters)
    impl = _select_impl(problem, backend, batch=True)
    kind = "flat" if problem.stencil is None else "stencil"
    if kind == "stencil":
        v, delta, iters, total = stencil_batched_solve(
            problem.features, problem.c, problem.m, problem.stencil.alpha,
            problem.stencil.neighbors, eps, max_iters, impl=impl)
    else:
        feats, w = problem.rows()
        v, delta, iters, total = flat_batched_solve(
            feats, w, problem.c, problem.m, eps, max_iters, impl=impl)
        if problem.scalar:
            v = v[..., 0]
    inj = FI.get()
    if inj is not None:
        v = inj.corrupt("solve_batched", v)
    n_iters = iters.cpu().numpy()
    final_delta = delta.cpu().numpy()
    cen = v.cpu().numpy()
    b = cen.shape[0]
    lane_tol = lane_tolerances(problem, eps)
    healthy = np.isfinite(cen.reshape(b, -1)).all(axis=1)
    converged = (final_delta < lane_tol) & np.isfinite(final_delta)
    total = int(total)

    salvaged = np.zeros(b, dtype=bool)
    bad = ~healthy if impl == "reference" else ~(healthy & converged)
    if salvage and bad.any():
        idx = np.nonzero(bad)[0]
        v2, d2, i2, t2 = _salvage_lanes(problem, idx, eps, max_iters)
        sel = torch.as_tensor(idx, device=v.device)
        v = v.clone()
        v[sel] = v2
        n_iters = n_iters.copy()
        n_iters[idx] = i2.cpu().numpy()
        final_delta = final_delta.copy()
        final_delta[idx] = d2.cpu().numpy()
        total = max(total, int(t2))
        healthy = np.isfinite(v.cpu().numpy().reshape(b, -1)).all(axis=1)
        converged = (final_delta < lane_tol) & np.isfinite(final_delta)
        salvaged[idx] = True
        from repro_torch import obs
        obs.default_registry().counter("solver.salvaged_lanes",
                                       kind=kind).inc(len(idx))

    _record_telemetry(kind, impl, total, float(np.nanmax(final_delta)),
                      lane_iters=n_iters)
    return BatchedFCMResult(centers=v, n_iters=n_iters,
                            final_delta=final_delta, total_iters=total,
                            converged=converged, healthy=healthy,
                            salvaged=salvaged)


# ---------------------------------------------------------------------------
# Host-loop backends: the paper's staged pipeline + the sequential CPU floor
# ---------------------------------------------------------------------------

def solve_staged(problem: FCMProblem, *, eps: float = 5e-3,
                 max_iters: int = 300, seed: int = 0, u0=None,
                 keep_membership: bool = False) -> F.FCMResult:
    """The paper's pipeline: the membership array materialized between
    stages, random membership init (``seed``, or ``u0`` (c, N)), and the
    convergence test ``max|u' - u| < eps`` read on the host each
    iteration (the paper copies the membership back). For scalar rows
    each iteration is the center-partials kernel, the division, then the
    membership kernel (their plain versions on the CPU); vector rows run
    the plain stages on the CPU and raise on the card, where the staged
    kernels take scalar rows only. Labels are the argmax of the final
    membership."""
    if problem.weights is not None or problem.stencil is not None:
        raise ValueError("backend='staged' reproduces the paper's "
                         "unweighted pixel pipeline only")
    x = problem.features
    dev = x.device
    if dev.type == "cuda" and not problem.scalar:
        raise ValueError(
            f"the staged kernels (membership, center_partials) take "
            f"scalar rows (D = 1) only, got D={problem.n_feat} on the card")
    n = x.shape[0]
    c, m = problem.c, problem.m
    if u0 is None:
        u = F.random_membership(torch.Generator().manual_seed(int(seed)),
                                c, n, dev)
    else:
        u = DV.as_f32(u0, dev)
        if tuple(u.shape) != (c, n):
            raise ValueError(f"u0 must be (c, N) = {(c, n)}, got "
                             f"{tuple(u.shape)}")
    n_iters = 0
    delta = float("inf")
    v = None
    for it in range(max_iters):
        if problem.scalar:
            num, den = kops.center_partials(x, u, m)
            v = F._stage_combine(num, den)[:, 0]
            u_new = kops.membership(x, v, m)
        else:
            num_terms, den_terms = F._stage_terms(x, u, m)
            v = F._stage_combine(F._stage_reduce_num(num_terms),
                                 F._stage_reduce_den(den_terms))
            u_new = F._stage_membership(x, v, m)
        # Host round trip, as in the paper's block diagram.
        delta = float((u_new - u).abs().max())
        u = u_new
        n_iters = it + 1
        if delta < eps:
            break
    if v is None:
        # max_iters=0: centers from the initial membership, so the result
        # is still well-defined.
        v = F.update_centers(x, u, m)
    return F.FCMResult(centers=v, labels=F.defuzzify(u), n_iters=n_iters,
                       final_delta=delta,
                       membership=u if keep_membership else None,
                       converged=bool(delta < eps),
                       healthy=bool(torch.isfinite(v).all()))


def _solve_sequential(problem: FCMProblem, eps: float, max_iters: int,
                      seed: int, u0) -> F.FCMResult:
    """The paper's CPU comparison floor: single-core numpy on the host
    whatever the problem's device (:mod:`repro_torch.core.sequential`);
    the result's tensors come back on the problem's device."""
    from . import sequential as S
    if (problem.weights is not None or not problem.scalar
            or problem.stencil is not None):
        raise ValueError("backend='sequential' is the scalar unweighted "
                         "CPU baseline only")
    if isinstance(u0, torch.Tensor):
        u0 = u0.cpu().numpy()
    v, labels, it = S.fcm_sequential_numpy(
        problem.features.cpu().numpy(), c=problem.c, m=problem.m, eps=eps,
        max_iters=max_iters, seed=seed, u0=u0)
    dev = problem.device
    # The comparator reports no residual (final_delta=NaN), so converged
    # is inferred from the iteration budget.
    return F.FCMResult(
        centers=torch.from_numpy(v.astype(np.float32)).to(dev),
        labels=torch.from_numpy(labels).to(dev), n_iters=int(it),
        final_delta=float("nan"), converged=bool(int(it) < max_iters),
        healthy=bool(np.isfinite(v).all()))
