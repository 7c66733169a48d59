"""Public wrappers around the port's kernels, plus the step dispatch
registry the solver core routes through.

The registry maps a step *kind* (``"flat"`` weighted-row update or
whole-solve, ``"bin"`` ingest binning, ``"labels"`` defuzzify) to its
implementations (``"reference"`` plain PyTorch, a kernel on the card),
and :func:`select_step` picks one by platform and problem shape. The
platform is a device type, taken from the tensors the caller holds:
``"cuda"`` where the JAX package says ``"tpu"``.

On the card no step silently runs its plain version: when no kernel
admits a problem, :func:`select_step` raises, unless the caller asked
for ``"reference"`` by name.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from . import defuzzify as KD
from . import fcm_resident as KR
from . import histogram_bin as KB


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
    scalar features, the plain version on the CPU."""
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

#: the kernel implementation of each kind, tried first on the card
_KERNEL_IMPLS = ("resident", "cuda")


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
    ``prefer`` forces a name; a preferred impl with a declared
    ``fallback`` degrades off its platforms by walking the whole
    fallback chain, skipping ineligible links, and raises only when the
    chain is exhausted. Otherwise the kernel wins on ``"cuda"`` when the
    problem fits it, and the plain reference runs on the CPU. On
    ``"cuda"`` a problem no kernel admits raises: the card never runs a
    plain version the caller did not ask for."""
    kinds = sorted({k for k, _ in _STEP_REGISTRY})
    if kind not in kinds:
        raise ValueError(f"unknown step kind {kind!r}; one of {kinds}")
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
        if platform in impl.platforms:
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
    if platform == "cuda":
        if kind == "flat":
            raise ValueError(
                f"no flat kernel admits rows={n_rows}, c={c}, D={n_feat}: "
                f"flat/resident holds rows <= {KR.MAX_ROWS}, c <= "
                f"{KR.MAX_C}, D <= {KR.MAX_FEAT}, and the HBM-streamed "
                f"whole-solve (resident_streamed) is not ported yet")
        raise ValueError(f"no {kind!r} kernel admits D={n_feat} on cuda; "
                         f"pass prefer='reference' to run the plain "
                         f"version on the card")
    return _STEP_REGISTRY[(kind, "reference")]


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
