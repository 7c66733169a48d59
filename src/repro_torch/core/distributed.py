"""Multi-device FCM: one image's pixels sharded over a mesh of devices.

The paper's two-level reduction (CUDA shared-memory block sums, then
device-global partials, then a single-thread combine) carries over to
devices:

  block sums inside the fused-partials kernel      <- the paper's level 1
  per-device partial sums (one launch a shard)     <- the paper's level 2
  a sum of 2c floats on the lead device            <- the paper's combine,
                                                      across devices

Pixels are sharded over **every** mesh axis (clustering has no model
dimension), so the same code runs on a mesh of ``cpu`` entries, one card
named several times, or several cards. An iteration moves O(c) floats
between devices whatever N is; the histogram form moves 256 floats once.

**One process, one controller.** A :class:`Mesh` names devices the
calling process sees; :func:`shard_map` runs a body on each shard in
turn, each under its device (the launches of different cards overlap,
since a launch returns before its kernel ends). The JAX package's
``psum`` becomes a copy of each shard's partials to the lead device and a
sum there, in shard order: device-to-device copies, no NCCL. The same
code therefore runs the split, the per-shard launches and the merge on a
mesh of ``cpu`` entries in the CPU tests and on one card named twice.

**Results against one device.** Sharding pixels splits each cluster's
sum into per-shard sums added in another order, so the centers of
:func:`fit_sharded` agree with a single-device solve to float32
rounding (the tests' rtol 1e-5 / atol 1e-4), not bit for bit; labels
agree up to near-ties. Sharding *lanes* changes no lane's arithmetic
(see :mod:`repro_torch.core.batched`), which is why the batch-sharded
fit is bit-equal.

**The tolerance** is the JAX module's own, ``eps * max(hi - lo, 1.0) *
0.1``, kept on purpose: it differs from the single-device solver's
``eps * where(rng > 0, rng, 1) * 0.1`` (``solver._tol_from_range``) for
a data range in (0, 1), and the port follows the reference module.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _device as DV
from ..analysis import op_cost
from ..kernels import _build
from ..kernels import fcm_centers as KC
from ..kernels import ops as kops
from . import fcm as F
from . import solver as SV

_BIG = 3.4e38


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices of one process laid out over named axes: ``devices`` in
    row-major order over ``shape``. A device may appear more than once
    (one card, or the CPU, standing in for several shards)."""
    devices: Tuple[torch.device, ...]
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        """The device the shards' partial sums are combined on."""
        return self.devices[0]


def _device_of(d) -> torch.device:
    dev = DV.resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              devices: Optional[Sequence] = None) -> Mesh:
    """A :class:`Mesh` of ``prod(shape)`` devices. With ``devices=None``
    the first ``prod(shape)`` visible cards, raising if there are fewer
    (a card is never reused unasked); an explicit list may name a device
    more than once, but not mix the CPU and cards."""
    shape = tuple(int(s) for s in shape)
    axis_names = tuple(str(a) for a in axis_names)
    if len(shape) != len(axis_names) or any(s < 1 for s in shape):
        raise ValueError(f"a mesh needs one positive size per axis name, "
                         f"got shape {shape} for axes {axis_names}")
    n = math.prod(shape)
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise ValueError(
                f"a mesh of shape {shape} needs {n} cards and {have} "
                f"{'is' if have == 1 else 'are'} visible; name the devices "
                f"(one may appear more than once) to build it anyway")
        devs = tuple(torch.device("cuda", i) for i in range(n))
    else:
        devs = tuple(_device_of(d) for d in devices)
        if len(devs) != n:
            raise ValueError(f"a mesh of shape {shape} holds {n} devices, "
                             f"got {len(devs)}")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a mesh's devices are all cards or all the "
                             f"CPU, got {[str(d) for d in devs]}")
    return Mesh(devs, shape, axis_names)


def mesh_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(mesh.axis_names)


def split(mesh: Mesh, t: torch.Tensor) -> List[torch.Tensor]:
    """The leading axis of ``t`` cut into ``mesh.size`` equal contiguous
    shards, shard ``k`` on ``mesh.devices[k]`` (a view where it already
    lies there)."""
    n = t.shape[0]
    if n % mesh.size:
        raise ValueError(f"a leading axis of {n} does not split into "
                         f"{mesh.size} equal shards")
    per = n // mesh.size
    return [t[k * per:(k + 1) * per].to(dev)
            for k, dev in enumerate(mesh.devices)]


def run_shards(mesh: Mesh, f: Callable, *shards: Sequence) -> list:
    """``f`` on each shard's arguments (``shards`` are per-shard lists,
    as :func:`split` makes them), shard by shard in the mesh's device
    order, each under its device (the kernels' launch guard); returns
    the per-shard outputs."""
    outs = []
    for k, dev in enumerate(mesh.devices):
        with _build.on_device(dev):
            outs.append(f(*(s[k] for s in shards)))
    return outs


def shard_map(f: Callable, *, mesh: Mesh) -> Callable:
    """The counterpart of the JAX package's ``shard_map`` over every
    mesh axis: the returned function splits the leading axis of each of
    its inputs into ``mesh.size`` shards (:func:`split`) and runs ``f``
    on each shard's device (:func:`run_shards`), returning the per-shard
    outputs in the mesh's device order."""
    def mapped(*inputs):
        return run_shards(mesh, f, *(split(mesh, t) for t in inputs))
    return mapped


def _sum_on(dev: torch.device, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The shards' partials summed on ``dev`` in shard order (the JAX
    package's ``psum``, reported to a cost counter as its all-reduce)."""
    op_cost.collective("all-reduce", parts[0].numel()
                       * parts[0].element_size(), len(parts))
    total = parts[0].to(dev)
    for p in parts[1:]:
        total = total + p.to(dev)
    return total


def pad_to_devices(x, n_devices: int, device=None):
    """Pad ``(N,)`` pixels to ``(N',)`` with ``N' % n_devices == 0``;
    returns float32 ``(x_pad, w_pad)``, ``w`` 1 on real pixels and 0 on
    padding, so padding drops out of every weighted partial sum. On
    ``device``, else a tensor's own device, else the card."""
    if device is None and isinstance(x, torch.Tensor):
        dev = x.device
    else:
        dev = DV.resolve_device(device)
    x = DV.as_f32(x, dev).reshape(-1)
    n = x.shape[0]
    n_pad = (-n) % n_devices
    xp = torch.cat([x, torch.zeros((n_pad,), dtype=torch.float32,
                                   device=dev)])
    w = torch.cat([torch.ones((n,), dtype=torch.float32, device=dev),
                   torch.zeros((n_pad,), dtype=torch.float32, device=dev)])
    return xp, w


def masked_center_step(x: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
                       m: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One shard's local Eq. 3 partial sums with validity weights: ``x``,
    ``w`` (n,), ``v`` (c,) -> ``(num (c,), den (c,))``. The fused-partials
    kernel on a card, its plain version on the CPU."""
    return KC.fused_partials(x.contiguous(), w.contiguous(), v.contiguous(),
                             m)


def _extreme_on(dev: torch.device, parts: Sequence[torch.Tensor],
                reduce) -> torch.Tensor:
    """The shards' scalar minima or maxima (``reduce`` ``torch.min`` or
    ``torch.max``) combined on ``dev`` (the JAX package's ``pmin`` /
    ``pmax``, reported as an all-reduce)."""
    op_cost.collective("all-reduce", parts[0].element_size(), len(parts))
    return reduce(torch.stack([p.to(dev) for p in parts]))


def _init_from_range(lo, hi, c: int, eps: float):
    """The JAX module's linspace init and center tolerance from the data
    range: ``(v0 (c,), eps * max(hi - lo, 1) * 0.1)``."""
    frac = (torch.arange(c, dtype=torch.float32, device=lo.device)
            + 0.5) / c
    return (lo + frac * (hi - lo),
            eps * torch.clamp(hi - lo, min=1.0) * 0.1)


def _labels(mesh: Mesh, xs, v) -> torch.Tensor:
    """Each shard labelled on its device (the labels kernel on a card),
    concatenated on the lead device."""
    parts = run_shards(mesh, lambda x: kops.defuzzify_labels(
        x, v.to(x.device)), xs)
    return torch.cat([p.to(mesh.lead) for p in parts])


def one_iteration(step, v0, tol, max_iters):
    """A loop for :func:`build_sharded_fit` that runs ``step`` once, with
    no convergence test: one iteration's work, as the JAX dry-run's
    ``while_override=1`` counts it (a test on fake tensors cannot be
    decided)."""
    v = step(v0)
    return v, (v - v0).abs().max(), 1


def build_sharded_fit(mesh: Mesh, cfg: F.FCMConfig = F.FCMConfig(),
                      loop=None):
    """Returns ``fn(x_padded, w) -> (centers (c,), labels (N',), delta,
    n_iters)``, the outputs on the mesh's lead device. ``x_padded`` and
    ``w`` (pixels and validity weights, :func:`pad_to_devices`) split
    over every mesh axis; each iteration is one fused-partials launch a
    shard, then a sum of 2c floats on the lead device. ``loop`` (default
    :func:`repro_torch.core.solver.while_centers`) runs the iterations;
    :func:`one_iteration` runs one."""
    c, m, max_iters, eps = cfg.n_clusters, cfg.m, cfg.max_iters, cfg.eps
    lead = mesh.lead
    loop = SV.while_centers if loop is None else loop

    def fit(x, w):
        xs, ws = split(mesh, x), split(mesh, w)
        lo = _extreme_on(lead, run_shards(
            mesh, lambda xk, wk: torch.where(wk > 0, xk, _BIG).min(),
            xs, ws), torch.min)
        hi = _extreme_on(lead, run_shards(
            mesh, lambda xk, wk: torch.where(wk > 0, xk, -_BIG).max(),
            xs, ws), torch.max)
        v0, tol = _init_from_range(lo, hi, c, eps)

        def step(v):
            parts = run_shards(mesh, lambda xk, wk: masked_center_step(
                xk, wk, v.to(xk.device), m), xs, ws)
            num = _sum_on(lead, [p[0] for p in parts])
            den = _sum_on(lead, [p[1] for p in parts])
            return num / torch.clamp(den, min=1e-12)

        v, delta, it = loop(step, v0, tol, max_iters)
        return v, _labels(mesh, xs, v), delta, it

    return fit


def build_sharded_histogram_fit(mesh: Mesh,
                                cfg: F.FCMConfig = F.FCMConfig(),
                                n_bins: int = 256):
    """The histogram-compressed form: each shard bins its real pixels
    (the binning kernel on a card; bin ``clip(int(x), 0, n_bins - 1)``),
    one sum of the ``n_bins`` counts on the lead device, then the whole
    weighted solve over the bins on the lead device (the resident
    whole-solve kernel on a card, its plain loop on the CPU) and labels
    per shard. ``w`` must be a 0/1 validity mask, as
    :func:`pad_to_devices` makes it: the binning counts pixels."""
    c, m, max_iters, eps = cfg.n_clusters, cfg.m, cfg.max_iters, cfg.eps
    lead = mesh.lead

    def fit(x, w):
        if not bool(((w == 0) | (w == 1)).all()):
            raise ValueError("the sharded histogram fit counts pixels: "
                             "its weights are a 0/1 validity mask")
        xs, ws = split(mesh, x), split(mesh, w)

        def counts(xk, wk):
            real = xk if bool((wk > 0).all()) else xk[wk > 0]
            return kops.histogram_counts(real, n_bins)

        hist = _sum_on(lead, run_shards(mesh, counts, xs, ws))
        vals = torch.arange(n_bins, dtype=torch.float32, device=lead)
        nz = hist > 0
        lo = torch.where(nz, vals, _BIG).min()
        hi = torch.where(nz, vals, -_BIG).max()
        v0, tol = _init_from_range(lo, hi, c, eps)
        x_rows, w_rows = kops.tile_rows_batched(vals[None, :, None],
                                                hist[None])
        solve_fn = kops.build_step("flat", "resident", x=x_rows, w=w_rows,
                                   m=m, max_iters=max_iters)
        with _build.on_device(lead):
            v, delta, iters = solve_fn(v0[None, :, None], tol.reshape(1))
        v = v[0, :, 0]
        return v, _labels(mesh, xs, v), delta[0], int(iters[0])

    return fit


def fit_sharded(x, mesh: Mesh, cfg: F.FCMConfig = F.FCMConfig(),
                histogram: bool = False) -> F.FCMResult:
    """Pads ``x`` (any shape, flattened) to the mesh size, shards it over
    every mesh axis, fits, and drops the padding's labels. Centers and
    labels come back on the mesh's lead device."""
    n = x.numel() if isinstance(x, torch.Tensor) else int(np.size(x))
    xp, w = pad_to_devices(x, mesh.size, device=mesh.lead)
    fit = (build_sharded_histogram_fit if histogram
           else build_sharded_fit)(mesh, cfg)
    v, labels, delta, it = fit(xp, w)
    return F.FCMResult(centers=v, labels=labels[:n], n_iters=int(it),
                       final_delta=float(delta),
                       healthy=bool(torch.isfinite(v).all()))
