"""Public wrappers around the port's kernels, plus the step dispatch
registry the solver core routes through.

The registry maps a step *kind* (``"flat"`` weighted-row update or
whole-solve, ``"stencil"`` FCM_S update or whole-solve, ``"bin"`` ingest
binning, ``"labels"`` defuzzify, ``"slic_assign"`` the SLIC assignment,
``"selscan"`` the Mamba selective scan)
to its implementations
(``"reference"`` plain PyTorch, a kernel on the card), and
:func:`select_step` picks one by platform and problem shape. The
platform is a device type, taken from the tensors the caller holds:
``"cuda"`` where the JAX package says ``"tpu"``; the port's ``"fused"``
is the JAX package's ``"pallas"`` flat or stencil step.

On the card no step silently runs its plain version: when no kernel
admits a problem, :func:`select_step` raises, unless the caller asked
for ``"reference"`` by name. One case is not a kernel missing: hard
labels of vector rows (D > 1). The JAX package has no TPU kernel for
them (its ``labels_pallas`` takes scalar rows only) and runs its plain
``labels_from_centers`` on every platform, so the port runs the plain
version on the card too, on the rows' own device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from .. import faults as FI
from . import defuzzify as KD
from . import fcm_centers as KC
from . import fcm_membership as KM
from . import fcm_resident as KR
from . import fcm_spatial as KSP
from . import fcm_stencil as KST
from . import histogram_bin as KB
from . import selective_scan as KSS
from . import slic_assign as KS

_D2_FLOOR = 1e-12


def tile_rows_batched(feats: torch.Tensor, w: torch.Tensor):
    """The whole-solve kernel's layout for ``(B, K, D)`` feature rows and
    ``(B, K)`` weights: contiguous float32, rows unpadded. (The TPU's
    ``(B, D, R, 128)`` lane tiling has no counterpart: the kernel masks
    rows past K itself.)"""
    return (feats.to(torch.float32).contiguous(),
            w.to(torch.float32).contiguous())


def histogram_counts(px: torch.Tensor, n_bins: int = 256) -> torch.Tensor:
    """Intensity binning: ``(N,)`` or ``(B, N)`` pixel values ->
    ``(n_bins,)`` / ``(B, n_bins)`` float32 counts, with the bin of
    ``x`` being ``clip(int(x), 0, n_bins - 1)``. On the card float
    pixels are clamped and truncated to int32 first (the same bins for
    every finite value), so every dtype reaches the kernel."""
    squeeze = px.dim() == 1
    if squeeze:
        px = px[None]
    if px.device.type == "cuda" and px.dtype not in (torch.uint8,
                                                     torch.int32):
        px = px.clamp(0, n_bins - 1).to(torch.int32)
    h = KB.histogram_bin(px.contiguous(), n_bins)
    return h[0] if squeeze else h


def defuzzify_labels(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Hard labels straight from centers: ``x`` (N,) or (N, D), ``v``
    (c,) or (c, D) -> (N,) int32. The labels kernel on the card for
    scalar features, the plain version on the CPU and for vector
    features (no TPU kernel labels those; see the module docstring)."""
    if x.dim() == 2 and x.shape[-1] == 1:        # (N, 1) == scalar rows
        x = x[:, 0]
        v = v[:, 0] if v.dim() == 2 else v
    n_feat = 1 if x.dim() == 1 else x.shape[-1]
    impl = select_step("labels", platform=x.device.type, n_feat=n_feat)
    return impl.build()(x, v)


def defuzzify_labels_batched(xs: torch.Tensor,
                             v: torch.Tensor) -> torch.Tensor:
    """``(B, N)`` scalar pixel lanes (float32, uint8 or int32) + ``(B,
    c)`` centers -> ``(B, N)`` int32 labels in one launch: the labels
    kernel on the card, its plain version on the CPU."""
    return KD.labels(xs.contiguous(), v.to(torch.float32).contiguous())


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def membership(x: torch.Tensor, v: torch.Tensor,
               m: float = 2.0) -> torch.Tensor:
    """Eq. 4 membership: ``x`` (N,), ``v`` (c,) -> ``u`` (c, N). The
    membership kernel on the card, its plain version on the CPU."""
    return KM.membership(_f32(x), _f32(v), m)


def center_partials(x: torch.Tensor, u: torch.Tensor, m: float = 2.0):
    """Eq. 3 partial sums from a materialized membership (the paper's
    staged reduction): ``x`` (N,), ``u`` (c, N) -> ``(num (c, 1), den
    (c,))``, ``num`` in the ``(c, D)`` center layout."""
    num, den = KC.center_partials(_f32(x), _f32(u), m)
    return num[:, None], den


def fused_step(x: torch.Tensor, v: torch.Tensor,
               m: float = 2.0) -> torch.Tensor:
    """One fused ``v -> v'`` iteration over unit-weight pixels ``x``
    (N,): the fused-partials kernel, then ``num / max(den, 1e-12)``."""
    num, den = KC.fused_partials(_f32(x), None, _f32(v), m)
    return num / torch.clamp(den, min=_D2_FLOOR)


def fused_partials(x: torch.Tensor, w: Optional[torch.Tensor],
                   v: torch.Tensor, m: float = 2.0):
    """Raw fused partials ``(num (c,), den (c,))`` over ``x`` (N,) rows
    weighted by ``w`` (N,) (``None`` = 1), from centers ``v`` (c,)."""
    return KC.fused_partials(_f32(x), None if w is None else _f32(w),
                             _f32(v), m)


def spatial_partials(x: torch.Tensor, v: torch.Tensor, m: float = 2.0,
                     alpha: float = 1.0, neighbors: int = 4):
    """Raw FCM_S partials ``(num (B, c), den (B, c))`` of one step over
    ``(B, H, W)`` lanes (4 or 8 neighbors) or ``(B, D, H, W)`` lanes (6),
    from centers ``v`` (B, c); the caller divides ``num / max((1 + alpha)
    den, 1e-12)``. The step kernels on the card, their plain version on
    the CPU. The grid is unpadded: the TPU's ``tile_grid`` padding has
    no counterpart here."""
    if x.dim() == 3:
        return KSP.spatial_partials_2d(_f32(x), _f32(v), m, alpha, neighbors)
    if neighbors != 6:
        raise ValueError(f"3-D neighborhoods are 6-connected, got "
                         f"{neighbors}")
    return KSP.spatial_partials_3d(_f32(x), _f32(v), m, alpha)


def spatial_step(img: torch.Tensor, v: torch.Tensor, m: float = 2.0,
                 alpha: float = 1.0, neighbors: int = 4) -> torch.Tensor:
    """One fused FCM_S ``v -> v'`` iteration over a 2-D image (H, W)
    (4 or 8 neighbors) or a 3-D volume (D, H, W) (6) from centers ``v``
    (c,): the step kernels (``spatial_partials_pallas_2d`` / ``_3d``'s
    counterparts) on the card, their plain versions on the CPU. The JAX
    package's ``block_rows`` and ``interpret`` are its TPU tiling and
    have no counterpart."""
    num, den = spatial_partials(img[None], v[None], m, alpha, neighbors)
    return (num / torch.clamp((1.0 + alpha) * den, min=_D2_FLOOR))[0]


def slic_assign(img: torch.Tensor, centers: torch.Tensor, gy: int, gx: int,
                sw: float) -> torch.Tensor:
    """SLIC assignment: ``img`` (H, W, D), ``centers`` (gy * gx, D + 2)
    -> (H, W) int32 labels. The SLIC kernel on the card, its plain
    version on the CPU."""
    return KS.slic_assign(_f32(img), _f32(centers), gy, gx, sw)


# ---------------------------------------------------------------------------
# Step dispatch registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StepImpl:
    """One registered step implementation.

    ``build(**params) -> callable`` constructs the step; ``platforms``
    names the device types it runs on; ``scalar_only`` marks impls
    restricted to 1-D feature rows; ``batched`` marks impls that take a
    batch of lanes. ``max_rows``/``max_c``/``max_feat`` bound what one
    lane may hold (None = unbounded); ``fallback`` names the impl to
    dispatch to off ``platforms``.
    """
    kind: str
    name: str
    build: Callable[..., Callable]
    platforms: Tuple[str, ...] = ("cpu", "cuda")
    scalar_only: bool = False
    batched: bool = True
    max_rows: Optional[int] = None
    max_c: Optional[int] = None
    max_feat: Optional[int] = None
    fallback: Optional[str] = None

    def fits(self, n_feat: int, n_rows: Optional[int],
             c: Optional[int]) -> bool:
        if self.max_feat is not None and n_feat > self.max_feat:
            return False
        if self.max_rows is not None and (n_rows is None
                                          or n_rows > self.max_rows):
            return False
        if self.max_c is not None and (c is None or c > self.max_c):
            return False
        return True


_STEP_REGISTRY: Dict[Tuple[str, str], StepImpl] = {}

#: the kernel implementations of each kind, tried in this order on the
#: card (the JAX package's auto order: resident, resident_streamed, pallas;
#: then the batched fused step, where the JAX package runs its reference)
_KERNEL_IMPLS = ("resident", "resident_streamed", "fused", "fused_batched",
                 "cuda")


def register_step(kind: str, name: str, *, platforms=("cpu", "cuda"),
                  scalar_only: bool = False, batched: bool = True,
                  max_rows: Optional[int] = None, max_c: Optional[int] = None,
                  max_feat: Optional[int] = None,
                  fallback: Optional[str] = None):
    """Decorator: register a step builder under (kind, name)."""
    def deco(build):
        _STEP_REGISTRY[(kind, name)] = StepImpl(
            kind=kind, name=name, build=build, platforms=tuple(platforms),
            scalar_only=scalar_only, batched=batched, max_rows=max_rows,
            max_c=max_c, max_feat=max_feat, fallback=fallback)
        return build
    return deco


def step_impls(kind: Optional[str] = None):
    """All registered implementations (of one kind, if given)."""
    return [impl for (k, _), impl in sorted(_STEP_REGISTRY.items())
            if kind is None or k == kind]


def _default_platform() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def _eligible(impl: StepImpl, n_feat: int, batched: bool,
              n_rows: Optional[int], c: Optional[int]) -> bool:
    return (not (impl.scalar_only and n_feat != 1)
            and not (batched and not impl.batched)
            and impl.fits(n_feat, n_rows, c))


def select_step(kind: str, *, prefer: Optional[str] = None,
                platform: Optional[str] = None, n_feat: int = 1,
                batched: bool = False, n_rows: Optional[int] = None,
                c: Optional[int] = None) -> StepImpl:
    """Dispatch: pick the step implementation for a problem shape and
    platform (a device type; default the card when one is present).
    ``prefer`` forces a name. Off its platforms, a preferred impl with
    a declared ``fallback`` degrades by walking the whole fallback
    chain, skipping ineligible links, and raises only when the chain is
    exhausted; one with no fallback is returned as it is, and its
    kernel wrappers take their plain versions for CPU tensors (the
    JAX package's interpret mode). Otherwise the kernels win on
    ``"cuda"`` in the order resident, resident_streamed, fused,
    fused_batched, when the problem fits them, and the plain reference
    runs on the CPU. On ``"cuda"`` a problem no kernel admits raises:
    the card never runs a plain version the caller did not ask for.
    Vector-row labels are not such a problem: no TPU kernel takes them,
    and the plain version is their port (see the module docstring)."""
    kinds = sorted({k for k, _ in _STEP_REGISTRY})
    if kind not in kinds:
        raise ValueError(f"unknown step kind {kind!r}; one of {kinds}")
    inj = FI.get()
    if inj is not None:
        # Chaos hook: a dispatch-time failure for one (kind, impl),
        # injected without patching internals.
        inj.maybe_fail("kernel", route=f"{kind}/{prefer or 'auto'}")
    platform = platform or _default_platform()
    if prefer is not None:
        impl = _STEP_REGISTRY.get((kind, prefer))
        if impl is None:
            names = [i.name for i in step_impls(kind)]
            raise ValueError(f"no {kind!r} step implementation named "
                             f"{prefer!r}; registered: {names}")
        if impl.scalar_only and n_feat != 1:
            raise ValueError(f"{kind}/{prefer} handles scalar (D=1) "
                             f"features only, got D={n_feat}")
        if batched and not impl.batched:
            raise ValueError(f"{kind}/{prefer} does not support batched "
                             f"solves")
        if not impl.fits(n_feat, n_rows, c):
            raise ValueError(
                f"{kind}/{prefer} needs a problem within its bounds "
                f"(rows <= {impl.max_rows}, c <= {impl.max_c}, "
                f"D <= {impl.max_feat}); got rows={n_rows}, c={c}, "
                f"D={n_feat}")
        if platform in impl.platforms or impl.fallback is None:
            return impl
        # Walk the fallback chain: a link that is itself off-platform or
        # ineligible for this problem is skipped; only an exhausted
        # chain raises. The seen-set guards against cycles.
        seen = {impl.name}
        cur = impl
        walked = []
        while cur.fallback is not None and cur.fallback not in seen:
            seen.add(cur.fallback)
            nxt = _STEP_REGISTRY.get((kind, cur.fallback))
            if nxt is None:
                break
            walked.append(nxt.name)
            if (_eligible(nxt, n_feat, batched, n_rows, c)
                    and platform in nxt.platforms):
                return nxt
            cur = nxt
        raise ValueError(
            f"{kind}/{prefer} is unavailable on platform {platform!r} "
            f"and its fallback chain {walked} has no eligible "
            f"implementation for rows={n_rows}, c={c}, D={n_feat}")
    for name in _KERNEL_IMPLS:
        impl = _STEP_REGISTRY.get((kind, name))
        if (impl is not None and platform in impl.platforms
                and _eligible(impl, n_feat, batched, n_rows, c)):
            return impl
    if kind == "labels" and n_feat != 1:
        return _STEP_REGISTRY[(kind, "reference")]
    if platform == "cuda":
        if kind == "stencil":
            raise ValueError(
                f"no stencil kernel admits pixels={n_rows}, c={c}: "
                f"stencil/resident holds pixels <= {KST.STENCIL_MAX_PIXELS}, "
                f"c <= {KST.MAX_C} a lane, stencil/fused c <= {KSP.MAX_C}")
        if kind == "flat":
            raise ValueError(
                f"no flat kernel admits rows={n_rows}, c={c}, D={n_feat}"
                f"{' in a batched solve' if batched else ''}: every flat "
                f"kernel takes c <= {KC.MAX_C} (flat/resident holds rows <= "
                f"{KR.MAX_ROWS}, c <= {KR.MAX_C}, D <= {KR.MAX_FEAT} a lane, "
                f"flat/resident_streamed rows <= {KR.STREAM_MAX_ROWS}, c <= "
                f"{KR.STREAM_MAX_C}, D <= {KR.STREAM_MAX_FEAT}, flat/fused "
                f"and flat/fused_batched any rows and D with c <= "
                f"{KC.MAX_C})")
        raise ValueError(f"no {kind!r} kernel admits D={n_feat} on cuda; "
                         f"pass prefer='reference' to run the plain "
                         f"version on the card")
    return _STEP_REGISTRY[(kind, "reference")]


def step_impl(kind: str, name: str) -> StepImpl:
    """The registered (kind, name) implementation."""
    return _STEP_REGISTRY[(kind, name)]


def build_step(kind: str, name: str, **params) -> Callable:
    """Construct the (kind, name) step with the given problem arrays."""
    return _STEP_REGISTRY[(kind, name)].build(**params)


# -- registered implementations ---------------------------------------------
# Builders import the solver lazily: repro_torch.core imports this module
# too, and resolving both at call time keeps the import graph acyclic.

@register_step("flat", "reference")
def _flat_reference(feats, weights, m, **_):
    """Plain weighted-row update (repro_torch.core.solver)."""
    from repro_torch.core import solver as SV
    return lambda v: SV.weighted_center_step(feats, weights, v, m)


@register_step("flat", "resident", platforms=("cuda",), batched=True,
               max_rows=KR.MAX_ROWS, max_c=KR.MAX_C, max_feat=KR.MAX_FEAT,
               fallback="reference")
def _flat_resident(x, w, m, max_iters, **_):
    """The whole-solve kernel: returns a complete ``(v0, tol) -> (v,
    delta, iters)`` solver, not a ``v -> v'`` step — the convergence
    loop runs inside the kernel. Inputs from :func:`tile_rows_batched`."""
    def solve_fn(v0, tol):
        return KR.resident_solve(x, w, v0.contiguous(), tol.contiguous(), m,
                                 max_iters)
    return solve_fn


@register_step("flat", "resident_streamed", platforms=("cuda",),
               batched=True, max_rows=KR.STREAM_MAX_ROWS,
               max_c=KR.STREAM_MAX_C, max_feat=KR.STREAM_MAX_FEAT,
               fallback="resident")
def _flat_resident_streamed(x, w, m, max_iters, **_):
    """The HBM-streamed whole-solve: the same ``(v0, tol) -> (v, delta,
    iters)`` contract as ``flat/resident`` for lanes past its row bound.
    Off the card the fallback chain walks resident, then reference."""
    def solve_fn(v0, tol):
        return KR.resident_streamed_solve(x, w, v0.contiguous(),
                                          tol.contiguous(), m, max_iters)
    return solve_fn


@register_step("flat", "fused", platforms=("cuda",), scalar_only=True,
               batched=False, max_c=KC.MAX_C)
def _flat_fused(x, w, m, **_):
    """The fused-partials kernel once an iteration over scalar rows ``x``
    (N,) with weights ``w`` (N,) or ``None``: ``v (c, 1) -> num / max(den,
    1e-12)``. The counterpart of the JAX package's ``flat/pallas``."""
    def step(v):
        num, den = KC.fused_partials(x, w, v[:, 0].contiguous(), m)
        return (num / torch.clamp(den, min=_D2_FLOOR))[:, None]
    return step


@register_step("flat", "fused_batched", platforms=("cuda",), batched=True,
               max_c=KC.MAX_C)
def _flat_fused_batched(feats, weights, m, **_):
    """The batched fused-partials kernel once an iteration over ``(B, K,
    D)`` rows with ``(B, K)`` weights: ``v (B, c * D) -> num / max(den,
    1e-12)``, one launch (and its fold) for the whole bucket, under
    :func:`repro_torch.core.solver.masked_while_centers`. It serves the
    lanes no whole-solve kernel holds (c > 8, rows > 2^20 or D > 16),
    where the JAX package runs its reference step."""
    b, _, d = feats.shape
    x, w = _f32(feats), _f32(weights)

    def step(vflat):
        c = vflat.shape[1] // d
        num, den = KC.fused_partials_batched(
            x, w, vflat.reshape(b, c, d).contiguous(), m)
        return (num / torch.clamp(den[..., None], min=_D2_FLOOR)).reshape(
            b, c * d)
    return step


@register_step("stencil", "reference")
def _stencil_reference(x, m, alpha, neighbors, **_):
    """Plain shifted-array FCM_S step (repro_torch.core.spatial) over
    ``(B, *grid)`` lanes with ``(B, c)`` centers."""
    from repro_torch.core import spatial as SP
    return lambda v: SP.spatial_center_step(x, v, m, alpha, neighbors,
                                            batched=True)


@register_step("stencil", "fused", platforms=("cuda",), max_c=KSP.MAX_C)
def _stencil_fused(x, m, alpha, neighbors, **_):
    """The step kernels once an iteration over ``(B, H, W)`` or ``(B, D,
    H, W)`` lanes: ``v (B, c) -> num / max((1 + alpha) den, 1e-12)``, one
    launch for the whole bucket. The counterpart of the JAX package's
    ``stencil/pallas``, which takes one grid; here the lane axis is the
    CUDA form of the JAX route's vmap."""
    def step(v):
        num, den = spatial_partials(x, v.contiguous(), m, alpha, neighbors)
        return num / torch.clamp((1.0 + alpha) * den, min=_D2_FLOOR)
    return step


@register_step("stencil", "resident", platforms=("cuda",), batched=True,
               max_rows=KST.STENCIL_MAX_PIXELS, max_c=KST.MAX_C,
               fallback="reference")
def _stencil_resident(x, m, alpha, neighbors, max_iters, **_):
    """The stencil whole-solve: a ``(v0 (B, c), tol (B,)) -> (v, delta,
    iters)`` solver over ``(B, *grid)`` lanes, the convergence loop inside
    the kernel. ``max_rows`` bounds the per-lane pixel count
    (``FCMProblem.n_rows`` of a stencil problem)."""
    def solve_fn(v0, tol):
        return KST.stencil_solve(x, v0.contiguous(), tol.contiguous(), m,
                                 alpha, neighbors, max_iters)
    return solve_fn


@register_step("bin", "reference")
def _bin_reference(n_bins=256, **_):
    """Plain scatter-add binning."""
    def counts(px):
        squeeze = px.dim() == 1
        h = KB.histogram_bin_plain(px[None] if squeeze else px, n_bins)
        return h[0] if squeeze else h
    return counts


@register_step("bin", "cuda", platforms=("cuda",))
def _bin_cuda(n_bins=256, **_):
    """Shared-memory atomic binning kernel."""
    return lambda px: histogram_counts(px, n_bins)


@register_step("labels", "reference")
def _labels_reference(**_):
    """argmin-distance labels via the plain (c, N) distance matrix."""
    from repro_torch.core import fcm as F
    return lambda x, v: F.labels_from_centers(x, v)


@register_step("labels", "cuda", platforms=("cuda",), scalar_only=True)
def _labels_cuda(**_):
    """One thread per pixel, centers in shared memory (scalar features)."""
    def labels(x, v):
        return KD.labels(x.reshape(1, -1).contiguous(),
                         v.to(torch.float32).reshape(1, -1).contiguous()
                         )[0]
    return labels


@register_step("slic_assign", "reference", batched=False)
def _slic_reference(gy, gx, sw, **_):
    """Plain 3x3-candidate SLIC assignment (repro_torch.superpixel.slic)."""
    from repro_torch.superpixel import slic as SL
    return lambda img, centers: SL.assign_ref(img, centers, gy, gx, sw)


@register_step("slic_assign", "cuda", platforms=("cuda",), batched=False)
def _slic_cuda(gy, gx, sw, **_):
    """A 32 x 8 tile of pixels a block, one thread a pixel, the tile's
    cell window of centers in shared memory."""
    return lambda img, centers: slic_assign(img, centers, gy, gx, sw)


@register_step("selscan", "reference")
def _selscan_reference(**_):
    """The plain recurrence, one position at a time."""
    return KSS.selective_scan_ref


@register_step("selscan", "cuda", platforms=("cuda",))
def _selscan_cuda(**_):
    """A chunked scan: one thread a (batch, chunk, channel) with the
    d_state vector in registers, the chunks' end states carried across
    in order."""
    return KSS.selective_scan
