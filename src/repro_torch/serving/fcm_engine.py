"""Request-batching segmentation engine: the histogram, pixel, spatial
and superpixel routes, sync API.

Every serving method is a declarative :class:`RouteSpec` in a route
registry: an ingest transform, a bucket key (requests sharing one may
share one launch), a materializer (per-request labels from centers, for
cache hits, duplicates and routes without a program) and either a
:class:`RouteProgram` factory or a ``build_problem`` hook. ``flush`` groups
queued requests by bucket key, pads each chunk to the nearest size in
``batch_sizes`` and runs one program per chunk, or, for a route without
one, one :func:`~repro_torch.core.solver.solve_batched` on the chunk's
batched problem.

The histogram route's program for same-size payloads is three kernel
launches on the card: the binning kernel turns the ``(B, N)`` uint8
pixels into ``(B, 256)`` histograms, the whole-solve kernel runs every
lane's weighted FCM over the 256 (value, count) rows, and the labels
kernel labels every pixel from its lane's centers (the same labels as
the JAX package's per-bin label table gathered over the pixels). Padding
lanes replay lane 0's pixels. Mixed sizes share one solve over
host-built histograms (padding lanes are uniform histograms) and gather
a per-bin label table on the host. On the CPU the same programs run the
kernels' plain versions.

Identical intensity histograms hit an exact-key LRU lookup and
near-identical ones (L1 distance between normalized histograms at most
``cache_tol``) a nearest-match scan; either way only the label-table
gather runs.

The pixel route clusters every pixel (``(H, W)`` grey or channels-last
``(H, W, D <= 16)`` features): on the card one whole-solve launch per
bucket (the resident kernel up to 1024 pixels, the HBM-streamed one
beyond), then for scalar payloads the labels kernel; vector payloads
are labelled by the plain ``labels_from_centers``, as the JAX package
does. The superpixel route compresses each image at ingest with SLIC
(the SLIC kernel on the card) to ~256 weighted feature rows; a bucket
is one batched solve of those rows (the resident kernel on the card),
and each request's labels are gathered through its superpixel map.

The spatial route runs FCM_S on each ``(H, W)`` slice or ``(D, H, W)``
volume (8 neighbors for slices by default in ``configs/fcm_brainweb.py``,
6 for volumes): a bucket of same-shape payloads is one batched stencil
solve, on the card the whole-solve kernel for lanes within its pixel
bound and the per-iteration step kernels (one launch an iteration for
the bucket) past it; labels are the argmax of the final Eq. 4'
membership, in plain PyTorch on the payloads' device, as the JAX
package computes them.

Every route also gives ``build_problem`` (one batched problem for a
chunk) and a materializer; the fault-tolerance ladder runs them on the
plain solver. **Async admission**: ``submit_async`` queues through the
same per-route queues and returns a
:class:`~repro_torch.serving.admission.SegmentationFuture`; a lazy,
supervised background flusher thread forms batches (a bucket group at
the target shape ``batch_sizes[-1]``, or the oldest async request older
than ``max_wait_ms``), admits by deadline and sheds the least urgent
request past ``max_queue_depth``. ``drain`` flushes synchronously and
``shutdown`` drains or fails what is queued. **The ladder** acts on the
one transient failure the port has, an injected
:class:`~repro_torch.faults.InjectedFault`: such a launch failure is
retried ``retries`` times with exponential backoff; a
chunk whose launch still fails counts toward its route's circuit
breaker and is solved by ``solve_batched(backend="reference")`` on the
engine's device (``route.degraded``); an open breaker sends chunks there
until one half-open probe after ``breaker_cooldown_s`` closes it. A lane
whose centers come back non-finite is re-solved alone on that plain
path (``route.salvaged``) while its batchmates finish untouched; still
non-finite, it fails with
:class:`~repro_torch.serving.admission.SolveFailed`.

Every other error never enters the ladder: no retry, no breaker count,
no degraded chunk. A kernel that fails to build or to launch (a
:class:`~repro_torch.kernels._build.KernelBuildError`, a
:class:`~repro_torch.kernels._build.KernelLaunchError`), torch's own
CUDA errors, running out of card memory and a fault in a wrapper all
fail the route's requests, so the plain path never answers for a kernel
that is broken. Seeded faults
(:mod:`repro_torch.faults`) hook the ``ingest``, ``launch``, ``solve``
and ``flusher`` sites here.

**Mesh dispatch**: with a :class:`~repro_torch.core.distributed.Mesh`
(``mesh=`` or :meth:`FCMServeEngine.set_mesh`), a program whose bucket
divides by the mesh size stages each shard's slice of the bucket on that
shard's device and runs the route's launch for ``bucket / size`` lanes
there, one process driving every shard; lanes are independent, and a
lane's arithmetic does not depend on the lanes beside it, so results are
bit-equal to the single-device engine's. No mesh, a one-device mesh or a
bucket the mesh does not divide runs the single-device path; so do the
superpixel route (no program), degraded chunks and salvage, on the
engine's device. Programs are cached per mesh generation.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import (Any, Callable, Dict, Hashable, List, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from .. import _device as DV
from .. import faults as FI
from .. import obs
from ..core import distributed as DD
from ..core import fcm as F
from ..core import solver as SV
from ..core import spatial as SP
from ..core.batched import hist_rows
from ..kernels import ops as kops
from ..superpixel import pipeline as SX
from .admission import (DeadlineExceeded, EngineShutdown, InvalidInput,
                        Overloaded, SegmentationFuture, SolveFailed)


@dataclasses.dataclass
class SegmentationResult:
    """Per-request output."""
    request_id: int
    labels: np.ndarray            # same spatial shape as the submitted image
    centers: np.ndarray           # (c,) scalar or (c, D) vector features
    n_iters: int                  # 0 for cache hits
    cache_hit: bool
    method: str = "histogram"
    #: False when this request's lane exhausted its iteration budget
    #: without meeting the solver tolerance.
    converged: bool = True


def _validate_payload(img: np.ndarray) -> None:
    """Submit-time input guard: empty and non-finite float payloads are
    rejected with :class:`InvalidInput` before they consume a request id
    or poison a shared batch lane. Integer payloads skip the finite
    scan."""
    if img.size == 0:
        raise InvalidInput(f"empty image payload (shape {img.shape})")
    if img.dtype.kind == "f" and not np.isfinite(img).all():
        raise InvalidInput("image payload contains NaN/Inf pixels")


@dataclasses.dataclass
class _Pending:
    """A histogram-route request. Ingest keeps only the flat bin indices;
    ``hist``/``key`` are filled lazily, when the LRU cache or the
    mixed-size program needs them."""
    request_id: int
    shape: Tuple[int, ...]
    flat: np.ndarray              # uint8 for 8-bit payloads, else clipped
                                  # int32
    hist: Optional[np.ndarray] = None   # (n_bins,) float32, lazy
    key: Optional[bytes] = None         # cache/dedup key, lazy


@dataclasses.dataclass
class _PendingPixels:
    """A pixel or spatial request: the uncompressed payload. Pixel
    requests are per-image FCM, the route every compression is measured
    against ((H, W, D) payloads cluster in D-dim feature space); spatial
    requests are FCM_S grids, (H, W) or (D, H, W), whose stencil needs
    the positions. Same-shape payloads batch."""
    request_id: int
    pixels: np.ndarray


@dataclasses.dataclass
class _PendingSuperpixel:
    """A superpixel request after ingest-time SLIC compression: it
    carries only the reduced payload to the fit and bypasses the
    histogram LRU (vector features have no 256-bin key).
    ``features.shape`` buckets the batch."""
    request_id: int
    features: np.ndarray          # (K, D) superpixel mean features
    weights: np.ndarray           # (K,) pixel counts
    label_map: np.ndarray         # (H, W) int32 pixel -> superpixel
    slic_iters: int


# ---------------------------------------------------------------------------
# Route registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RouteSpec:
    """One serving method, declaratively.

    ``ingest(engine, img, rid)`` validates and reduces the payload;
    ``bucket_key(engine, payload)`` decides which payloads may share one
    launch; ``materialize`` turns fitted centers into one request's
    labels (cache hits and duplicates of ``cacheable`` routes, the
    plain path);
    ``program_key(engine, chunk)`` names the program shape a chunk
    shares and ``make_program(engine, key, bucket)`` builds that
    :class:`RouteProgram`, cached per (route generation, mesh generation,
    bucket, key). Every
    route gives ``build_problem(engine, chunk, bucket)``, which stacks a
    chunk (plus padding lanes up to ``bucket``) into one batched
    :class:`~repro_torch.core.solver.FCMProblem` and names the config
    whose eps/max_iters govern the fit: a route without a program solves
    it, and the degraded path and the salvage solve it on the plain
    solver. ``materialize_batch(engine, chunk, centers, n_iters)``, where
    given, labels a whole solved chunk at once. ``cacheable`` routes
    carry a ``.key``/``.hist`` payload and go through the histogram LRU
    and intra-flush dedup.
    """
    name: str
    ingest: Callable[["FCMServeEngine", np.ndarray, int], Any]
    bucket_key: Callable[["FCMServeEngine", Any], Hashable]
    materialize: Optional[
        Callable[["FCMServeEngine", Any, np.ndarray, int, bool],
                 SegmentationResult]] = None
    program_key: Optional[
        Callable[["FCMServeEngine", List[Any]], Hashable]] = None
    make_program: Optional[
        Callable[["FCMServeEngine", Hashable, int], "RouteProgram"]] = None
    build_problem: Optional[
        Callable[["FCMServeEngine", List[Any], int],
                 Tuple[SV.FCMProblem, F.FCMConfig]]] = None
    materialize_batch: Optional[
        Callable[["FCMServeEngine", List[Any], np.ndarray, np.ndarray],
                 List["SegmentationResult"]]] = None
    cacheable: bool = False
    stats_prefix: str = ""        # "" keeps the legacy histogram names

    def stat(self, name: str) -> str:
        if not self.stats_prefix:   # the histogram route predates routes
            return {"seconds": "fit_seconds", "iters": "fit_iters",
                    "batches": "batches", "images": "batched_images",
                    "padded": "padded_lanes",
                    "ingest": "ingest_seconds",
                    "compress": "compress_seconds",
                    "materialize": "materialize_seconds"}[name]
        legacy = {"seconds": "seconds", "iters": "iters",
                  "batches": "batches", "images": "batched_images",
                  "padded": "padded_lanes", "ingest": "ingest_seconds",
                  "compress": "compress_seconds",
                  "materialize": "materialize_seconds"}[name]
        return f"{self.stats_prefix}_{legacy}"


@dataclasses.dataclass(frozen=True)
class RouteProgram:
    """One chunk's serving pipeline.

    ``gather(engine, chunk, bucket)`` stacks and pads the payloads into
    device tensors on the host side; ``launch(*inputs)`` runs the device
    work (binning, batched solve, labels); ``scatter(engine, chunk,
    outputs)`` unpacks it into per-request results and returns
    ``(results, centers (B, c), n_iters (B,), total_iters, final_delta
    (B,))``. ``max_iters`` is the solve's iteration budget: a lane that
    used all of it did not converge.
    """
    gather: Callable[["FCMServeEngine", List[Any], int], Tuple]
    launch: Callable[..., Tuple]
    scatter: Callable[["FCMServeEngine", List[Any], Tuple], Tuple]
    max_iters: int


#: engine-held programs per (route, generation, mesh generation, bucket,
#: key), bounded so size-keyed program flavors recycle rather than accrete
_PROGRAM_CACHE_SIZE = 64

ROUTES: "collections.OrderedDict[str, RouteSpec]" = collections.OrderedDict()

#: Route generations: bumped on every (re-)registration so engine-held
#: programs for a replaced spec are evicted, never served stale.
_ROUTE_GEN: Dict[str, int] = collections.defaultdict(int)


def register_route(spec: RouteSpec) -> RouteSpec:
    """Add (or replace) a serving route. Replacing a spec invalidates any
    programs built from the old one."""
    ROUTES[spec.name] = spec
    _ROUTE_GEN[spec.name] += 1
    global METHODS
    METHODS = tuple(ROUTES)
    return spec


# -- mesh dispatch ------------------------------------------------------------

def _program(eng: "FCMServeEngine", bucket: int,
             body: Callable[[torch.device, int], Callable[..., Tuple]],
             stack: Callable[["FCMServeEngine", List[Any], int], np.ndarray],
             scatter, max_iters: int) -> RouteProgram:
    """A route's program for one bucket. ``body(device, lanes)`` builds
    the route's launch for ``lanes`` lanes on ``device``; ``stack(engine,
    chunk, bucket)`` stages the padded bucket as one host array.

    With no mesh that shards this bucket (no mesh, a one-device mesh, a
    bucket the mesh size does not divide) it is the single-device
    program: the bucket staged onto the engine's device, one launch.
    Otherwise ``gather`` stages each shard's contiguous slice of the
    bucket straight onto that shard's device; ``launch`` runs the body
    for ``bucket / size`` lanes on each shard under its device (lanes are
    independent, so no shard waits on another); the outputs are merged
    on the engine's device in the mesh's order, ``total`` the largest
    shard's (the JAX engine's ``pmax``). ``scatter`` is the same either
    way."""
    mesh = eng._mesh_for_bucket(bucket)
    if mesh is None:
        dev = eng.device

        def gather(eng_, chunk, bucket_):
            return (torch.from_numpy(stack(eng_, chunk, bucket_)).to(dev),)
        return RouteProgram(gather, body(dev, bucket), scatter, max_iters)

    per = bucket // mesh.size
    launches = {d: body(d, per) for d in set(mesh.devices)}

    def gather_shards(eng_, chunk, bucket_):
        arr = stack(eng_, chunk, bucket_)
        return tuple(torch.from_numpy(arr[k * per:(k + 1) * per]).to(d)
                     for k, d in enumerate(mesh.devices))

    def launch_shards(*shards):
        outs = DD.run_shards(mesh, lambda px: launches[px.device](px),
                             shards)
        dev = eng.device
        v, delta, iters, tail = (torch.cat([o[i].to(dev) for o in outs])
                                 for i in (0, 1, 2, 4))
        return v, delta, iters, max(int(o[3]) for o in outs), tail

    return RouteProgram(gather_shards, launch_shards, scatter, max_iters)


# -- histogram route --------------------------------------------------------

def _ingest_histogram(eng: "FCMServeEngine", img: np.ndarray,
                      rid: int) -> _Pending:
    # No binning here: the program bins on the device; the histogram only
    # materializes for cache keys or the mixed-size program. uint8
    # payloads cannot exceed the bin range, so they stay uint8.
    if img.dtype == np.uint8 and eng.n_bins >= 256:
        # a copy, not a view: the caller may reuse its buffer between
        # submit() and flush()
        flat = img.reshape(-1).copy()
    else:
        flat = np.clip(img.reshape(-1), 0, eng.n_bins - 1).astype(np.int32)
    return _Pending(rid, img.shape, flat)


def _ensure_hist(eng: "FCMServeEngine", p: _Pending) -> _Pending:
    if p.hist is None:
        p.hist = np.bincount(p.flat, minlength=eng.n_bins
                             ).astype(np.float32)[:eng.n_bins]
        if p.key is None:
            p.key = p.hist.tobytes()
    return p


def _build_histogram(eng, chunk, bucket):
    hists = np.stack([_ensure_hist(eng, p).hist for p in chunk])
    n_pad = bucket - len(chunk)
    if n_pad:
        # Uniform-histogram padding lanes converge fast and are dropped.
        hists = np.concatenate([hists,
                                np.ones((n_pad, eng.n_bins), np.float32)])
    hists = torch.from_numpy(hists).to(eng.device)
    return SV.batch_problems(hist_rows(hists), hists, cfg=eng.cfg,
                             device=eng.device), eng.cfg


def _label_lut(centers: np.ndarray, n_bins: int) -> np.ndarray:
    """n_bins-entry defuzzify table in plain numpy — the same float32
    arithmetic and tie-breaking as labels_from_centers."""
    vals = np.arange(n_bins, dtype=np.float32)
    c2 = np.asarray(centers, np.float32).reshape(-1, 1)
    return np.argmin((c2 - vals[None, :]) ** 2, axis=0).astype(np.int32)


def _materialize_histogram(eng, p, centers, n_iters, cache_hit):
    labels = _label_lut(centers, eng.n_bins)[p.flat].reshape(p.shape)
    return SegmentationResult(p.request_id, labels, np.asarray(centers),
                              n_iters, cache_hit)


def _histogram_program_key(eng, chunk):
    # Same-size payloads share the pixels -> binning -> solve -> labels
    # program; mixed sizes take the histograms-only program and a host
    # label-table gather.
    sizes = {p.flat.size for p in chunk}
    return ("px", sizes.pop()) if len(sizes) == 1 else ("hist",)


def _make_histogram_program(eng, key, bucket) -> RouteProgram:
    cfg = eng.cfg
    c, m = cfg.n_clusters, float(cfg.m)
    eps, max_iters = float(cfg.eps), int(cfg.max_iters)
    nb = eng.n_bins

    def body(dev, lanes):
        impl = kops.select_step("flat", platform=dev.type, n_feat=1,
                                batched=True, n_rows=nb, c=c).name
        vals = hist_rows(torch.empty((lanes, nb), device=dev)).contiguous()

        def _solve(hists):
            v, delta, iters, total = SV.flat_batched_solve(
                vals[..., None], hists, c, m, eps, max_iters, impl=impl)
            return v[..., 0].contiguous(), delta, iters, total

        if key[0] == "px":
            def launch(px):
                hists = kops.histogram_counts(px, nb)
                v2, delta, iters, total = _solve(hists)
                labels = kops.defuzzify_labels_batched(px, v2)
                return v2, delta, iters, total, labels
            return launch

        # Mixed payload sizes: one solve on the stacked histograms, the
        # per-bin label table on the device.
        def launch(hists):
            v2, delta, iters, total = _solve(hists)
            lut = kops.defuzzify_labels_batched(vals, v2)
            return v2, delta, iters, total, lut
        return launch

    def _unpack(outs):
        v2, delta, iters, total, tail = outs
        return (v2.cpu().numpy(), delta.cpu().numpy(), iters.cpu().numpy(),
                int(total), tail.cpu().numpy())

    if key[0] == "px":
        n = key[1]

        def stack(eng_, chunk, bucket_):
            # uint8 traffic stages uint8; mixed dtypes stage int32.
            # Padding lanes replay lane 0.
            dtype = (np.uint8 if all(p.flat.dtype == np.uint8
                                     for p in chunk) else np.int32)
            px = np.empty((bucket_, n), dtype)
            for i, p in enumerate(chunk):
                px[i] = p.flat
            px[len(chunk):] = px[0]
            return px

        def scatter(eng_, chunk, outs):
            centers, delta, iters, total, labels = _unpack(outs)
            res = [SegmentationResult(p.request_id,
                                      labels[i].reshape(p.shape),
                                      centers[i], int(iters[i]), False)
                   for i, p in enumerate(chunk)]
            return res, centers, iters, total, delta

        return _program(eng, bucket, body, stack, scatter, max_iters)

    # Mixed payload sizes: padding lanes are uniform histograms, and
    # per-request labels come from a host gather through the label table.
    def stack(eng_, chunk, bucket_):
        hists = np.ones((bucket_, nb), np.float32)
        for i, p in enumerate(chunk):
            hists[i] = _ensure_hist(eng_, p).hist
        return hists

    def scatter(eng_, chunk, outs):
        centers, delta, iters, total, lut = _unpack(outs)
        res = [SegmentationResult(p.request_id,
                                  lut[i][p.flat].reshape(p.shape),
                                  centers[i], int(iters[i]), False)
               for i, p in enumerate(chunk)]
        return res, centers, iters, total, delta

    return _program(eng, bucket, body, stack, scatter, max_iters)


register_route(RouteSpec(
    name="histogram", ingest=_ingest_histogram,
    bucket_key=lambda eng, p: ("hist",),
    materialize=_materialize_histogram,
    program_key=_histogram_program_key,
    make_program=_make_histogram_program,
    build_problem=_build_histogram,
    cacheable=True))


# -- pixel route --------------------------------------------------------------

def _ingest_pixel(eng, img, rid) -> _PendingPixels:
    # 3-D pixel payloads are channels-last feature stacks; a (D, H, W)
    # volume would silently cluster on W-dim rows, so anything that does
    # not look like trailing channels is rejected here.
    if img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[-1] > 16):
        raise ValueError(
            f"pixel requests need (H, W) or channels-last "
            f"(H, W, D<=16) input, got shape {img.shape}; "
            f"use method='histogram' or 'spatial' for volumes")
    # a copy: the caller may reuse its buffer between submit() and flush()
    return _PendingPixels(rid, np.array(img))


def _pixel_rows(img: np.ndarray) -> np.ndarray:
    imgf = img.astype(np.float32)
    return (imgf.reshape(-1, img.shape[-1]) if img.ndim == 3
            else imgf.reshape(-1))


def _build_pixel(eng, chunk, bucket):
    xs = np.stack([_pixel_rows(q.pixels) for q in chunk])
    n_pad = bucket - len(chunk)
    if n_pad:
        # Padding lanes replay the first image and are dropped on output.
        xs = np.concatenate([xs, np.repeat(xs[:1], n_pad, axis=0)])
    return SV.batch_problems(xs, cfg=eng.cfg, device=eng.device), eng.cfg


def _materialize_pixel(eng, q, centers, n_iters, cache_hit):
    img = q.pixels
    spatial_shape = img.shape[:-1] if img.ndim == 3 else img.shape
    # Argmin labels, never the (c, N) membership: the labels kernel on
    # the card for scalar rows.
    labels = kops.defuzzify_labels(
        torch.from_numpy(_pixel_rows(img)).to(eng.device),
        torch.from_numpy(np.asarray(centers, np.float32)).to(eng.device))
    return SegmentationResult(q.request_id,
                              labels.cpu().numpy().reshape(spatial_shape),
                              np.asarray(centers), n_iters, cache_hit,
                              method="pixel")


def _pixel_program_key(eng, chunk):
    return ("px",) + chunk[0].pixels.shape  # bucket_key groups by shape


def _stack_lanes(lane_shape):
    """A program's host staging: the chunk's payloads stacked into
    (bucket, *lane_shape), uint8 when every payload is uint8, else
    float32; padding lanes replay the first payload and are dropped on
    output."""
    def stack(eng_, chunk, bucket_):
        dtype = (np.uint8 if all(q.pixels.dtype == np.uint8 for q in chunk)
                 else np.float32)
        px = np.empty((bucket_,) + lane_shape, dtype)
        for i, q in enumerate(chunk):
            px[i] = q.pixels.reshape(lane_shape)
        px[len(chunk):] = px[0]
        return px
    return stack


def _scatter_lanes(method, label_shape):
    """A program's scatter for outputs ``(v, delta, iters, total,
    labels)``: one result a real lane, labels shaped ``label_shape``."""
    def scatter(eng_, chunk, outs):
        v, delta, iters, total, labels = outs
        centers = v.cpu().numpy()
        iters_np = iters.cpu().numpy()
        labels_np = labels[:len(chunk)].cpu().numpy()
        res = [SegmentationResult(q.request_id,
                                  labels_np[i].reshape(label_shape),
                                  centers[i], int(iters_np[i]), False,
                                  method=method)
               for i, q in enumerate(chunk)]
        return res, centers, iters_np, int(total), delta.cpu().numpy()
    return scatter


def _make_pixel_program(eng, key, bucket) -> RouteProgram:
    """Stack -> batched whole-solve -> labels. On the card the solve is
    one launch of the whole-solve kernel the registry picks for the lane
    size (the HBM-streamed one past 1024 pixels); scalar payloads are
    labelled by the labels kernel, vector payloads by the plain
    ``labels_from_centers`` (no kernel labels vector rows). uint8
    payloads travel to the device as uint8."""
    shape = key[1:]
    scalar = len(shape) == 2
    d = 1 if scalar else shape[-1]
    n = int(np.prod(shape[:2]))
    cfg = eng.cfg
    c, m = cfg.n_clusters, float(cfg.m)
    eps, max_iters = float(cfg.eps), int(cfg.max_iters)
    lane_shape = (n,) if scalar else (n, d)

    def body(dev, lanes):
        impl = kops.select_step("flat", platform=dev.type, n_feat=d,
                                batched=True, n_rows=n, c=c).name
        w = torch.ones((lanes, n), dtype=torch.float32, device=dev)

        def launch(px):
            xs = px.to(torch.float32)
            feats = xs[..., None] if scalar else xs
            v, delta, iters, total = SV.flat_batched_solve(
                feats, w, c, m, eps, max_iters, impl=impl)
            if scalar:
                v2 = v[..., 0].contiguous()
                return (v2, delta, iters, total,
                        kops.defuzzify_labels_batched(px, v2))
            return v, delta, iters, total, F.labels_from_centers(feats, v)
        return launch

    return _program(eng, bucket, body, _stack_lanes(lane_shape),
                    _scatter_lanes("pixel", shape[:2]), max_iters)


# -- spatial route ------------------------------------------------------------

def _ingest_spatial(eng, img, rid) -> _PendingPixels:
    if img.ndim not in (2, 3):
        raise ValueError(f"spatial requests need a (H, W) or (D, H, W) "
                         f"pixel grid, got shape {img.shape}")
    # a copy: the caller may reuse its buffer between submit() and flush()
    return _PendingPixels(rid, np.array(img))


def _spatial_neighbors(eng, ndim: int) -> int:
    return eng.spatial_cfg.neighbors if ndim == 2 else 6


def _build_spatial(eng, chunk, bucket):
    imgs = np.stack([q.pixels.astype(np.float32) for q in chunk])
    n_pad = bucket - len(chunk)
    if n_pad:
        imgs = np.concatenate([imgs, np.repeat(imgs[:1], n_pad, axis=0)])
    scfg = eng.spatial_cfg
    stencil = SV.StencilSpec(alpha=scfg.alpha,
                             neighbors=_spatial_neighbors(eng,
                                                          imgs.ndim - 1))
    return SV.batch_problems(imgs, stencil=stencil, cfg=scfg,
                             device=eng.device), scfg


def _materialize_spatial(eng, q, centers, n_iters, cache_hit):
    # The single-request face of the batch materializer (the salvage
    # labels one request at a time); it must not drift from it.
    return _materialize_spatial_batch(eng, [q], np.asarray(centers)[None],
                                      np.asarray([n_iters]))[0]


def _materialize_spatial_batch(eng, chunk, centers, n_iters):
    """The argmax of the Eq. 4' membership of every request of a solved
    chunk, in one batched plain-PyTorch pass on the engine's device, as
    the route's program labels."""
    scfg = eng.spatial_cfg
    neighbors = _spatial_neighbors(eng, chunk[0].pixels.ndim)
    imgs = torch.from_numpy(np.stack([q.pixels for q in chunk]).astype(
        np.float32)).to(eng.device)
    v = torch.from_numpy(np.asarray(centers[:len(chunk)], np.float32)).to(
        eng.device)
    u = SP.spatial_membership(imgs, v, float(scfg.m), float(scfg.alpha),
                              neighbors, batched=True)
    labels = torch.argmax(u, dim=1).to(torch.int32).cpu().numpy()
    return [SegmentationResult(q.request_id, labels[i],
                               np.asarray(centers[i]), int(n_iters[i]),
                               False, method="spatial")
            for i, q in enumerate(chunk)]


def _spatial_program_key(eng, chunk):
    return ("sp",) + chunk[0].pixels.shape  # bucket_key groups by shape


def _make_spatial_program(eng, key, bucket) -> RouteProgram:
    """Stack -> batched FCM_S solve -> stencil-membership labels. On the
    card the solve is one launch of the stencil whole-solve for lanes
    within its pixel bound, else the step kernels once an iteration for
    the whole bucket (the registry's pick for the lane size); the labels
    are the argmax of the Eq. 4' membership in plain PyTorch (the JAX
    package has no kernel for them either). uint8 payloads travel to the
    device as uint8."""
    shape = key[1:]
    scfg = eng.spatial_cfg
    c, m = scfg.n_clusters, float(scfg.m)
    alpha = float(scfg.alpha)
    neighbors = _spatial_neighbors(eng, len(shape))
    eps, max_iters = float(scfg.eps), int(scfg.max_iters)

    def body(dev, lanes):
        impl = kops.select_step("stencil", platform=dev.type, batched=True,
                                n_rows=int(np.prod(shape)), c=c).name

        def launch(px):
            imgs = px.to(torch.float32)
            v, delta, iters, total = SV.stencil_batched_solve(
                imgs, c, m, alpha, neighbors, eps, max_iters, impl=impl)
            u = SP.spatial_membership(imgs, v, m, alpha, neighbors,
                                      batched=True)
            return v, delta, iters, total, torch.argmax(u, dim=1).to(
                torch.int32)
        return launch

    return _program(eng, bucket, body, _stack_lanes(shape),
                    _scatter_lanes("spatial", shape), max_iters)


# -- superpixel route ---------------------------------------------------------

def _ingest_superpixel(eng, img, rid) -> _PendingSuperpixel:
    if img.ndim not in (2, 3):
        raise ValueError(f"superpixel requests need (H, W) or "
                         f"(H, W, D) input, got shape {img.shape}")
    # compress is a stage of this route's ingest: its own span and
    # stage counter (superpixel_compress_seconds)
    with eng.tracer.span("compress", ring=False, route="superpixel") as sp:
        comp = SX.compress(img.astype(np.float32), eng.superpixel_cfg,
                           device=eng.device)
        out = _PendingSuperpixel(rid, comp.features.cpu().numpy(),
                                 comp.weights.cpu().numpy(),
                                 comp.label_map.cpu().numpy(),
                                 comp.slic_iters)
    eng._stage_seconds("superpixel", "compress").inc(sp.wall_s)
    return out


def _build_superpixel(eng, chunk, bucket):
    k, d = chunk[0].features.shape
    feats = np.stack([q.features for q in chunk])
    ws = np.stack([q.weights for q in chunk])
    n_pad = bucket - len(chunk)
    if n_pad:
        # Benign padding lanes: a unit-weight feature ramp converges in a
        # handful of iterations and is dropped on output.
        ramp = np.broadcast_to(
            np.linspace(0.0, 1.0, k, dtype=np.float32)[:, None], (k, d))
        feats = np.concatenate([feats, np.broadcast_to(ramp, (n_pad, k, d))])
        ws = np.concatenate([ws, np.ones((n_pad, k), np.float32)])
    # The superpixel config governs the fit.
    return SV.batch_problems(feats, ws, cfg=eng.superpixel_cfg,
                             device=eng.device), eng.superpixel_cfg


def _materialize_superpixel(eng, q, centers, n_iters, cache_hit):
    # K superpixel rows against c centers: a host argmin, then one gather
    # through the superpixel map
    sp_labels = F.labels_from_centers(torch.from_numpy(q.features),
                                      torch.from_numpy(np.asarray(centers)))
    labels = sp_labels.numpy()[q.label_map]
    return SegmentationResult(q.request_id, labels, np.asarray(centers),
                              n_iters, cache_hit, method="superpixel")


register_route(RouteSpec(
    name="pixel", ingest=_ingest_pixel,
    bucket_key=lambda eng, p: ("pixel",) + p.pixels.shape,
    materialize=_materialize_pixel, build_problem=_build_pixel,
    program_key=_pixel_program_key, make_program=_make_pixel_program,
    stats_prefix="pixel"))
register_route(RouteSpec(
    name="spatial", ingest=_ingest_spatial,
    bucket_key=lambda eng, p: ("spatial",) + p.pixels.shape,
    materialize=_materialize_spatial, build_problem=_build_spatial,
    materialize_batch=_materialize_spatial_batch,
    program_key=_spatial_program_key, make_program=_make_spatial_program,
    stats_prefix="spatial"))
register_route(RouteSpec(
    name="superpixel", ingest=_ingest_superpixel,
    bucket_key=lambda eng, p: ("superpixel",) + p.features.shape,
    materialize=_materialize_superpixel, build_problem=_build_superpixel,
    stats_prefix="superpixel"))

#: The serving routes, in registration order.
METHODS = tuple(ROUTES)


def _route_of(method: str) -> RouteSpec:
    route = ROUTES.get(method)
    if route is None:
        raise ValueError(f"unknown method {method!r}; registered "
                         f"routes: {METHODS}")
    return route


def _failed_future(method: str, t_submit: float, err: BaseException,
                   deadline: Optional[float] = None) -> SegmentationFuture:
    """A future already failed with ``err``: a request that took no
    request id and no queue slot."""
    fut = SegmentationFuture(-1, method, deadline=deadline)
    fut.submit_t = t_submit
    fut.set_exception(err)
    return fut


class FCMServeEngine:
    """Static-bucket batching engine for FCM segmentation requests.

    ``submit`` ingests an image (any 2-D/3-D shape, 8-bit-range values);
    ``flush`` answers cache hits and runs one program per bucketed
    chunk; ``segment`` is submit-all-then-flush. ``submit_async``
    queues through the same per-route queues and returns a
    :class:`~repro_torch.serving.admission.SegmentationFuture` that a
    lazy background flusher thread resolves; ``drain`` flushes
    synchronously and ``shutdown`` stops the flusher. The engine runs on
    ``device`` (``None`` = the card; with no card it raises), and every
    flush, synchronous or the flusher thread's, runs with that card
    current. With a ``mesh`` (see the module docstring) the programs'
    launches shard their lanes over its devices.
    """

    def __init__(self, cfg: F.FCMConfig = F.FCMConfig(),
                 batch_sizes: Sequence[int] = (1, 8, 64),
                 n_bins: int = 256,
                 cache_size: int = 256,
                 cache_tol: float = 0.15,
                 superpixel_cfg: Optional[SX.SuperpixelFCMConfig] = None,
                 spatial_cfg: Optional[SP.SpatialFCMConfig] = None,
                 tracing: bool = True,
                 trace_ring: int = 64,
                 device=None,
                 max_wait_ms: float = 10.0,
                 faults: Optional[Any] = None,
                 retries: int = 2,
                 retry_backoff_s: float = 0.05,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 5.0,
                 max_queue_depth: Optional[int] = None,
                 mesh: Optional[DD.Mesh] = None):
        if not batch_sizes or any(b <= 0 for b in batch_sizes):
            raise ValueError(f"bad batch_sizes {batch_sizes!r}")
        self.device = DV.resolve_device(device)
        #: the card the flusher thread runs on: a new thread's current
        #: device is device 0, whatever this engine's is
        self._cuda_index = (
            None if self.device.type != "cuda"
            else self.device.index if self.device.index is not None
            else torch.cuda.current_device())
        self.cfg = cfg
        self.spatial_cfg = spatial_cfg or SP.SpatialFCMConfig(
            n_clusters=cfg.n_clusters, m=cfg.m, eps=cfg.eps,
            max_iters=cfg.max_iters)
        self.superpixel_cfg = superpixel_cfg or SX.SuperpixelFCMConfig(
            n_clusters=cfg.n_clusters, m=cfg.m, eps=cfg.eps,
            max_iters=cfg.max_iters)
        self.batch_sizes = tuple(sorted(set(int(b) for b in batch_sizes)))
        self.n_bins = n_bins
        self.cache_size = cache_size
        # Max L1 distance between normalized histograms for a near-match
        # cache hit; 0 restricts the cache to exact-histogram hits.
        self.cache_tol = cache_tol
        # key (exact histogram bytes) -> (centers, normalized histogram)
        self._cache: "collections.OrderedDict[bytes, Tuple[np.ndarray, np.ndarray]]" = \
            collections.OrderedDict()
        self._queues: Dict[str, List[Any]] = {name: [] for name in ROUTES}
        self._programs: Dict[Hashable, RouteProgram] = {}
        self._next_id = 0
        # Instrumentation: a private MetricsRegistry (stats() renders the
        # flat keys from it) and a Tracer keeping the last ``trace_ring``
        # flush traces; tracing=False keeps the counters but records no
        # traces or span histograms.
        self.metrics = obs.MetricsRegistry()
        self.tracer = obs.Tracer(max_traces=trace_ring, enabled=tracing,
                                 metrics=self.metrics)
        # -- fault tolerance ------------------------------------------------
        #: bounded retry of a failed launch, retry_backoff_s * 2^attempt
        #: apart
        self.retries = int(retries)
        self.retry_backoff_s = float(retry_backoff_s)
        #: consecutive post-retry launch failures that open a route's
        #: breaker (its chunks then take the plain solver); after
        #: breaker_cooldown_s one half-open probe launch tests recovery
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        #: queued-request ceiling past which the least urgent async
        #: request (or the incoming one) is shed; None = unbounded
        self.max_queue_depth = (None if max_queue_depth is None
                                else int(max_queue_depth))
        if faults is None:
            self._faults: Optional[FI.FaultInjector] = None
        elif isinstance(faults, FI.FaultInjector):
            self._faults = faults
        else:
            self._faults = FI.FaultInjector(faults, registry=self.metrics)
        #: route -> {"state", "failures", "opened_t"}; guarded by _lock
        self._breakers: Dict[str, Dict[str, Any]] = {}
        #: hard (BaseException) flusher deaths seen
        self._flusher_kills = 0
        #: request id -> (submit perf_counter, route name), consumed when
        #: the result materializes (the per-route latency histogram)
        self._submit_t: Dict[int, Tuple[float, str]] = {}
        # -- async admission ----------------------------------------------
        #: guards queues, futures, id allocation and the shutdown flag;
        #: the condition wakes the flusher on submits and shutdown
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        #: serializes flush bodies (flusher thread vs. flush / drain
        #: callers): queue swaps stay atomic under _lock, the solve runs
        #: outside it, and the kernels of one stream run in turn
        self._flush_lock = threading.Lock()
        #: request id -> unresolved future (async requests only)
        self._futures: Dict[int, SegmentationFuture] = {}
        self.max_wait_ms = float(max_wait_ms)
        self._closed = False
        self._flusher: Optional[threading.Thread] = None
        #: per-route count of queued async requests (guarded by _lock)
        self._async_n: Dict[str, int] = {}
        # -- mesh dispatch ------------------------------------------------
        #: bumped by set_mesh; part of every program-cache key, so programs
        #: built for another mesh are purged like stale route generations
        self._mesh_gen = 0
        self.mesh: Optional[DD.Mesh] = None
        if mesh is not None:
            self.set_mesh(mesh)
        self.metrics.counter("requests")
        self.metrics.counter("cache_hits")
        self.metrics.gauge("queue.depth")
        self.metrics.counter("flusher.restarts")
        for route in ROUTES.values():
            for k in ("requests", "cache_hits", "batches", "images",
                      "padded", "iters", "deadline_expired", "retries",
                      "shed", "salvaged", "degraded", "breaker_trips",
                      "invalid_input"):
                self._route_counter(k, route.name)
            self.metrics.gauge("route.breaker_state", route=route.name)
            for stage in ("ingest", "solve", "materialize", "compress"):
                self._stage_seconds(route.name, stage)
            self._latency_hist(route.name)
            self._iters_hist(route.name)
            self._occupancy_hist(route.name)
            self.metrics.gauge("queue.depth", route=route.name)

    # -- mesh --------------------------------------------------------------

    def set_mesh(self, mesh: Optional[DD.Mesh]) -> None:
        """Attach, replace or (``None``) detach the
        :class:`~repro_torch.core.distributed.Mesh` that program launches
        shard their lanes over. Bumps the mesh generation, so every
        program built for the previous mesh is evicted at its next use."""
        if mesh is not None and any(d.type != self.device.type
                                    for d in mesh.devices):
            raise ValueError(f"an engine on {self.device} shards over "
                             f"{self.device.type} devices only, got "
                             f"{[str(d) for d in mesh.devices]}")
        with self._lock:
            self.mesh = mesh
            self._mesh_gen += 1

    def _mesh_for_bucket(self, bucket: int) -> Optional[DD.Mesh]:
        """The mesh a ``bucket``-lane launch shards over, or None for the
        single-device path: no mesh, a one-device mesh, or a bucket the
        mesh size does not divide."""
        mesh = self.mesh
        if mesh is None or mesh.size <= 1 or bucket % mesh.size != 0:
            return None
        return mesh

    # -- metric accessors --------------------------------------------------

    def _route_counter(self, name: str, route_name: str) -> obs.Counter:
        return self.metrics.counter(f"route.{name}", route=route_name)

    def _stage_seconds(self, route_name: str, stage: str) -> obs.Counter:
        return self.metrics.counter("route.stage_seconds",
                                    route=route_name, stage=stage)

    def _latency_hist(self, route_name: str) -> obs.Histogram:
        """Per-route submit->result latency (seconds)."""
        return self.metrics.histogram("route.latency_seconds",
                                      route=route_name)

    def _iters_hist(self, route_name: str) -> obs.Histogram:
        """Per-route iterations-to-converge, one sample per real lane."""
        return self.metrics.histogram("route.lane_iters",
                                      edges=obs.ITER_EDGES,
                                      route=route_name)

    def _occupancy_hist(self, route_name: str) -> obs.Histogram:
        """Per-route batch occupancy: real lanes / bucket size."""
        return self.metrics.histogram("route.batch_occupancy",
                                      edges=obs.UNIT_EDGES,
                                      route=route_name)

    def _set_queue_gauges(self) -> None:
        """Caller holds ``_lock``."""
        for name, q in self._queues.items():
            self.metrics.gauge("queue.depth", route=name).set(len(q))
        self.metrics.gauge("queue.depth").set(self.queue_depth)

    def _finish(self, route: RouteSpec, results: Dict[int, Any],
                r: SegmentationResult) -> None:
        """Record one materialized result and its submit->result latency,
        and resolve the request's future if it was submitted async."""
        results[r.request_id] = r
        sub = self._submit_t.pop(r.request_id, None)
        if sub is not None:
            self._latency_hist(route.name).record(
                time.perf_counter() - sub[0])
        fut = self._futures.pop(r.request_id, None)
        if fut is not None:
            fut.try_set_result(r)

    def _fail_request(self, p: Any, err: BaseException) -> bool:
        """Resolve one request with a typed error; True when an async
        future took it (a synchronous caller has no future: its flush
        raises the error)."""
        self._submit_t.pop(p.request_id, None)
        fut = self._futures.pop(p.request_id, None)
        if fut is not None:
            fut.try_set_exception(err)
            return True
        return False

    # -- submit ------------------------------------------------------------

    def _ingest(self, method: str, img: np.ndarray):
        """Validate and reduce one payload through its route, outside the
        admission lock (superpixel ingest runs SLIC). A raise consumes
        neither a request id nor a queue slot."""
        route = _route_of(method)
        img = np.asarray(img)
        try:
            with self.tracer.span("ingest", ring=False, route=method) as sp:
                if self._faults is not None:
                    self._faults.maybe_fail("ingest", route=method)
                _validate_payload(img)
                pending = route.ingest(self, img, self._next_id)
        except InvalidInput:
            self._route_counter("invalid_input", method).inc()
            raise
        self._stage_seconds(method, "ingest").inc(sp.wall_s)
        return pending

    def _enqueue(self, method: str, pending, t_submit: float) -> int:
        """Allocate the request id and queue the payload (caller holds
        ``_lock``)."""
        if self._closed:
            raise EngineShutdown("engine is shut down; no new submits")
        rid = self._next_id
        self._next_id += 1
        # The id ingest saw was advisory (submitters race for ids); the
        # queued payload carries the real one.
        pending.request_id = rid
        self.metrics.counter("requests").inc()
        self._route_counter("requests", method).inc()
        self._submit_t[rid] = (t_submit, method)
        self._queues.setdefault(method, []).append(pending)
        self._set_queue_gauges()
        return rid

    def submit(self, img: np.ndarray, method: str = "histogram") -> int:
        """Queue one image on a registered route; returns its request id.
        Invalid payloads raise before consuming an id."""
        t_submit = time.perf_counter()
        pending = self._ingest(method, img)
        with self._lock:
            return self._enqueue(method, pending, t_submit)

    def submit_async(self, img: np.ndarray, method: str = "histogram",
                     deadline: Optional[float] = None) -> SegmentationFuture:
        """Queue one image and return a future for its result.

        ``deadline`` is relative seconds from now: a request still queued
        when it passes resolves with
        :class:`~repro_torch.serving.admission.DeadlineExceeded` instead
        of running (a non-positive deadline fails at submit, consuming no
        request id or queue slot). Batches form in the background, when a
        bucket group reaches ``batch_sizes[-1]`` or the oldest waiting
        async request exceeds ``max_wait_ms``, or at ``drain()``. Raises
        :class:`~repro_torch.serving.admission.EngineShutdown` after
        ``shutdown()``.
        """
        t_submit = time.perf_counter()
        _route_of(method)
        if self._closed:    # before ingest: a closed engine does no work
            raise EngineShutdown("engine is shut down; no new submits")
        if deadline is not None and deadline <= 0:
            self._route_counter("deadline_expired", method).inc()
            return _failed_future(method, t_submit, DeadlineExceeded(
                f"deadline {deadline}s already expired at submit"),
                deadline=t_submit)
        try:
            pending = self._ingest(method, img)
        except (InvalidInput, FI.InjectedFault) as e:
            # A payload that fails ingest fails its own future only: no
            # request id, no queue slot.
            return _failed_future(method, t_submit, e)
        abs_deadline = None if deadline is None else t_submit + deadline
        with self._lock:
            if (self.max_queue_depth is not None
                    and self.queue_depth >= self.max_queue_depth
                    and not self._shed_for(
                        float("inf") if abs_deadline is None
                        else abs_deadline)):
                # Every queued request is at least as urgent: shed the
                # incoming one.
                self._route_counter("shed", method).inc()
                return _failed_future(method, t_submit, Overloaded(
                    f"queue depth {self.queue_depth} at max_queue_depth="
                    f"{self.max_queue_depth}; request shed"),
                    deadline=abs_deadline)
            rid = self._enqueue(method, pending, t_submit)
            fut = SegmentationFuture(rid, method, deadline=abs_deadline)
            fut.submit_t = t_submit
            self._futures[rid] = fut
            self._ensure_flusher()
            # Wake the flusher only when this submit can change its
            # schedule: the route's first queued async request starts a
            # max_wait window, and a multiple of the target shape may
            # complete a bucket group.
            n_async = self._async_n.get(method, 0) + 1
            self._async_n[method] = n_async
            if (n_async == 1 or len(self._queues[method])
                    % self.batch_sizes[-1] == 0):
                self._cond.notify_all()
        return fut

    def _shed_for(self, incoming_deadline: float) -> bool:
        """Overload shedding (caller holds ``_lock``): fail the least
        urgent queued async request, the one with the farthest (or no)
        deadline, with :class:`Overloaded`, freeing its slot for a
        strictly more urgent incoming one. False when nothing queued is
        less urgent (ties shed the incoming request) or only synchronous
        requests are queued (their callers hold no future)."""
        worst: Optional[Tuple[Tuple[float, int], str, Any]] = None
        for name, q in self._queues.items():
            for p in q:
                fut = self._futures.get(p.request_id)
                if fut is None:
                    continue
                d = (fut.deadline if fut.deadline is not None
                     else float("inf"))
                key = (d, p.request_id)
                if worst is None or key > worst[0]:
                    worst = (key, name, p)
        if worst is None or worst[0][0] <= incoming_deadline:
            return False
        (_, rid), name, p = worst
        self._queues[name].remove(p)
        self._set_queue_gauges()
        if self._async_n.get(name):
            self._async_n[name] -= 1
        self._route_counter("shed", name).inc()
        self._submit_t.pop(rid, None)
        fut = self._futures.pop(rid, None)
        if fut is not None:
            fut.try_set_exception(Overloaded(
                f"request {rid} shed under overload (queue at "
                f"max_queue_depth={self.max_queue_depth})"))
        return True

    @staticmethod
    def _normalize(hist: np.ndarray) -> np.ndarray:
        return hist / max(float(hist.sum()), 1.0)

    # -- flush -------------------------------------------------------------

    def flush(self, raise_errors: bool = True) -> List[SegmentationResult]:
        """Run every queued request; returns results in submit order.
        Leaves one root trace per flush in ``tracer``'s ring.

        Thread-safe: the queue swap is atomic under the admission lock
        and flush bodies are serialized, so no request runs twice. A
        route whose batch raises fails that route's unresolved futures
        with the error; with ``raise_errors`` (the synchronous default)
        the first error then propagates, while the background flusher
        passes ``False`` so one failing route never kills the thread
        serving the others."""
        results: Dict[int, SegmentationResult] = {}
        first_err: Optional[BaseException] = None
        with self._flush_lock, self._on_card():
            with self._lock:
                drained = self._queues
                self._queues = {name: [] for name in drained}
                self._async_n = {}
                self._set_queue_gauges()
            n_queued = sum(len(v) for v in drained.values())
            with self.tracer.span("flush", queued=n_queued):
                for route in ROUTES.values():
                    pend = self._admit_order(route,
                                             drained.get(route.name) or [])
                    if not pend:
                        continue
                    try:
                        self._flush_route(route, pend, results)
                    except BaseException as e:  # noqa: BLE001
                        for p in pend:
                            if p.request_id not in results:
                                self._fail_request(p, e)
                        if first_err is None:
                            first_err = e
        if first_err is not None and raise_errors:
            raise first_err
        return [results[rid] for rid in sorted(results)]

    def _admit_order(self, route: RouteSpec, pend: List[Any]) -> List[Any]:
        """Deadline admission on a drained route queue: overdue async
        requests fail with ``DeadlineExceeded`` without spending a lane,
        and the rest run most urgent first, so tight deadlines land in
        the earliest chunk of their bucket group. Synchronous requests
        carry no deadline and keep their submit order."""
        now = time.perf_counter()
        keep: List[Any] = []
        for p in pend:
            fut = self._futures.get(p.request_id)
            if (fut is not None and fut.deadline is not None
                    and now > fut.deadline):
                self._futures.pop(p.request_id, None)
                self._submit_t.pop(p.request_id, None)
                self._route_counter("deadline_expired", route.name).inc()
                fut.try_set_exception(DeadlineExceeded(
                    f"request {p.request_id} missed its deadline "
                    f"while queued"))
                continue
            keep.append(p)

        def urgency(p):
            fut = self._futures.get(p.request_id)
            d = (fut.deadline
                 if fut is not None and fut.deadline is not None
                 else float("inf"))
            return (d, p.request_id)

        keep.sort(key=urgency)
        return keep

    def _flush_route(self, route: RouteSpec, pend: List[Any],
                     results: Dict[int, SegmentationResult]) -> None:
        """One route's share of a flush: cache/dedup, bucket, solve."""
        dups: List[Any] = []
        fitted: Dict[bytes, np.ndarray] = {}
        if route.cacheable:
            pend, dups = self._answer_from_cache(route, pend, results)
        groups: "collections.OrderedDict[Hashable, List[Any]]" = \
            collections.OrderedDict()
        for p in pend:
            groups.setdefault(route.bucket_key(self, p), []).append(p)
        for group in groups.values():
            i = 0
            while i < len(group):
                chunk = group[i:i + self.batch_sizes[-1]]
                i += len(chunk)
                self._run_bucket(route, chunk, self._bucket_for(len(chunk)),
                                 results, fitted)
        # duplicates ride on their representative's centers
        for p in dups:
            self.metrics.counter("cache_hits").inc()
            self._route_counter("cache_hits", route.name).inc()
            self._finish(route, results, route.materialize(
                self, p, fitted[p.key], 0, True))

    def drain(self) -> List[SegmentationResult]:
        """Flush everything queued now, resolving every pending future;
        returns the materialized results. If the flusher is mid-flush,
        this waits for that batch (flush bodies serialize), so every
        request submitted before the call is resolved on return."""
        return self.flush()

    def segment(self, imgs: Sequence[np.ndarray],
                method: str = "histogram") -> List[SegmentationResult]:
        ids = [self.submit(im, method=method) for im in imgs]
        by_id = {r.request_id: r for r in self.flush()}
        return [by_id[i] for i in ids]

    # -- background flusher ------------------------------------------------

    def _ensure_flusher(self) -> None:
        """Start the batch-formation thread lazily (caller holds
        ``_lock``), so an engine serving only the synchronous API never
        runs one. Called on every async submit: a flusher that died hard
        is replaced before a new request could hang on it."""
        if self._flusher is not None and not self._flusher.is_alive():
            self.metrics.counter("flusher.restarts").inc()
            self._flusher = None
        if self._flusher is None:
            self._flusher = threading.Thread(
                target=self._flusher_loop, name="fcm-serve-flusher",
                daemon=True)
            self._flusher.start()

    def _flush_due(self) -> Optional[float]:
        """Batch-formation policy (caller holds ``_lock``): seconds until
        the next flush is due; ``0.0`` when some bucket group reached the
        target shape or the oldest async request exceeded
        ``max_wait_ms``, ``None`` when no async request waits."""
        now = time.perf_counter()
        oldest: Optional[float] = None
        target = self.batch_sizes[-1]
        for name, q in self._queues.items():
            route = ROUTES.get(name)
            if route is None or not q:
                continue
            group_sizes: Dict[Hashable, int] = {}
            async_here = False
            for p in q:
                k = route.bucket_key(self, p)
                group_sizes[k] = group_sizes.get(k, 0) + 1
                fut = self._futures.get(p.request_id)
                if fut is not None:
                    async_here = True
                    if oldest is None or fut.submit_t < oldest:
                        oldest = fut.submit_t
            # Pure synchronous queues belong to their caller's flush.
            if async_here and any(n >= target
                                  for n in group_sizes.values()):
                return 0.0
        if oldest is None:
            return None
        return max(0.0, oldest + self.max_wait_ms / 1000.0 - now)

    def _on_card(self):
        """The engine's card as the calling thread's current device (a
        null context on the CPU), around every flush: a new thread's
        current device is device 0, and a caller's may be any card."""
        if self._cuda_index is None:
            return contextlib.nullcontext()
        return torch.cuda.device(self._cuda_index)

    def _flusher_loop(self) -> None:
        # Supervised: a raise anywhere in an iteration restarts the loop
        # in place (counted in flusher.restarts). Only a BaseException
        # (thread death) escapes; then a replacement starts at once when
        # work is pending, and the next async submit re-ensures one.
        while True:
            try:
                if self._faults is not None:
                    self._faults.maybe_fail("flusher")
                with self._lock:
                    while True:
                        if self._closed:
                            return
                        wait = self._flush_due()
                        if wait is not None and wait <= 0.0:
                            break
                        self._cond.wait(timeout=wait)
                # Outside the lock: per-route errors land in the affected
                # futures (raise_errors=False).
                self.flush(raise_errors=False)
            except FI.FlusherKilled:
                with self._lock:
                    self._flusher_kills += 1
                    self._flusher = None
                    if not self._closed and (
                            self.queue_depth > 0
                            or sum(self._async_n.values()) > 0):
                        self.metrics.counter("flusher.restarts").inc()
                        self._ensure_flusher()
                return
            except Exception:   # noqa: BLE001 — supervised restart
                self.metrics.counter("flusher.restarts").inc()
                continue

    def shutdown(self, drain: bool = True) -> None:
        """Stop the flusher and close admission. With ``drain`` (the
        default) everything queued is flushed and every future resolves;
        with ``drain=False`` queued requests are dropped and their
        futures fail with
        :class:`~repro_torch.serving.admission.EngineShutdown`. Later
        submits raise ``EngineShutdown``; a second call does nothing."""
        with self._lock:
            already = self._closed
            self._closed = True
            self._cond.notify_all()
            flusher = self._flusher
        if flusher is not None and flusher.is_alive():
            flusher.join()
        if already:
            return
        if drain:
            self.flush(raise_errors=False)
            return
        with self._lock:
            dropped: List[Any] = []
            for name in self._queues:
                dropped.extend(self._queues[name])
                self._queues[name] = []
            self._async_n = {}
            self._set_queue_gauges()
        err = EngineShutdown("engine shut down with the request queued")
        for p in dropped:
            self._fail_request(p, err)

    @property
    def closed(self) -> bool:
        return self._closed

    # -- cache / buckets / programs ----------------------------------------

    def _answer_from_cache(self, route: RouteSpec, pend: List[Any],
                           results: Dict[int, SegmentationResult]):
        """Cache lookups + intra-flush dedup (one fit per distinct key);
        returns (representatives to fit, duplicates). With the LRU
        disabled neither histograms nor keys are computed: duplicates
        occupy identical lanes and converge identically."""
        if self.cache_size <= 0:
            return pend, []
        misses: List[Any] = []
        for p in pend:
            _ensure_hist(self, p)
            centers = self._cache_get(p.key, p.hist)
            if centers is not None:
                self.metrics.counter("cache_hits").inc()
                self._route_counter("cache_hits", route.name).inc()
                self._finish(route, results, route.materialize(
                    self, p, centers, 0, True))
            else:
                misses.append(p)
        uniq: Dict[bytes, Any] = {}
        dups: List[Any] = []
        for p in misses:
            if p.key in uniq:
                dups.append(p)
            else:
                uniq[p.key] = p
        return list(uniq.values()), dups

    def _bucket_for(self, n: int) -> int:
        for b in self.batch_sizes:
            if n <= b:
                return b
        return self.batch_sizes[-1]

    def _program_for(self, route: RouteSpec, chunk: List[Any],
                     bucket: int) -> Optional[RouteProgram]:
        """The program this chunk rides, built once per (route
        generation, mesh generation, bucket, shape key), or None for a
        route without programs; stale generations, a re-registered route
        or a swapped mesh, are purged."""
        if route.make_program is None:
            return None
        key = route.program_key(self, chunk)
        gen = _ROUTE_GEN[route.name]
        for k in [k for k in self._programs
                  if (k[0] == route.name and k[1] != gen)
                  or k[2] != self._mesh_gen]:
            del self._programs[k]
        full_key = (route.name, gen, self._mesh_gen, bucket, key)
        prog = self._programs.get(full_key)
        if prog is None:
            prog = route.make_program(self, key, bucket)
            self._programs[full_key] = prog
            while len(self._programs) > _PROGRAM_CACHE_SIZE:
                del self._programs[next(iter(self._programs))]
        return prog

    # -- the ladder: retry, circuit breaker, degraded chunk, salvage -------

    _BREAKER_GAUGE = {"closed": 0.0, "half_open": 0.5, "open": 1.0}

    def _breaker(self, route_name: str) -> Dict[str, Any]:
        b = self._breakers.get(route_name)
        if b is None:
            b = {"state": "closed", "failures": 0, "opened_t": 0.0}
            self._breakers[route_name] = b
        return b

    def _set_breaker(self, route_name: str, b: Dict[str, Any],
                     state: str) -> None:
        b["state"] = state
        self.metrics.gauge("route.breaker_state", route=route_name).set(
            self._BREAKER_GAUGE[state])

    def _breaker_allows(self, route_name: str) -> bool:
        """May this chunk ride the route's program? ``closed``: yes;
        ``open``: no until ``breaker_cooldown_s`` has passed, then one
        half-open probe launch tests recovery; ``half_open``: no (a probe
        is in flight)."""
        with self._lock:
            b = self._breaker(route_name)
            if b["state"] == "closed":
                return True
            if b["state"] == "open" and (
                    time.perf_counter() - b["opened_t"]
                    >= self.breaker_cooldown_s):
                self._set_breaker(route_name, b, "half_open")
                return True
            return False

    def _breaker_success(self, route_name: str) -> None:
        with self._lock:
            b = self._breaker(route_name)
            if b["state"] != "closed" or b["failures"]:
                b["failures"] = 0
                self._set_breaker(route_name, b, "closed")

    def _breaker_failure(self, route_name: str) -> None:
        """One post-retry launch failure: count toward the trip threshold
        (closed) or send the probe's breaker straight back to open with a
        fresh cooldown (half_open)."""
        with self._lock:
            b = self._breaker(route_name)
            if b["state"] == "half_open":
                b["opened_t"] = time.perf_counter()
                self._route_counter("breaker_trips", route_name).inc()
                self._set_breaker(route_name, b, "open")
                return
            b["failures"] += 1
            if (b["state"] == "closed"
                    and b["failures"] >= self.breaker_threshold):
                b["opened_t"] = time.perf_counter()
                self._route_counter("breaker_trips", route_name).inc()
                self._set_breaker(route_name, b, "open")

    def _breaker_abandon_probe(self, route_name: str) -> None:
        """A probe that raised past the ladder (any error but an injected
        fault) proved nothing: back to open, its cooldown
        already spent, so the next chunk probes again. No trip counts."""
        with self._lock:
            b = self._breaker(route_name)
            if b["state"] == "half_open":
                self._set_breaker(route_name, b, "open")

    def _launch_attempts(self, route: RouteSpec, prog: RouteProgram,
                         inputs: Tuple) -> Tuple:
        """One program launch under the bounded-retry policy: an injected
        fault, the one transient failure the port has, is retried up to
        ``retries`` times with exponential backoff. Any other error, and
        the last injected one, propagates."""
        attempt = 0
        while True:
            try:
                if self._faults is not None:
                    self._faults.maybe_fail("launch", route=route.name)
                return prog.launch(*inputs)
            except FI.InjectedFault:
                if attempt >= self.retries:
                    raise
                self._route_counter("retries", route.name).inc()
                time.sleep(self.retry_backoff_s * (2 ** attempt))
                attempt += 1

    def _route_cfg(self, route: RouteSpec):
        """The config whose eps/max_iters govern this route's fits."""
        if route.name == "spatial":
            return self.spatial_cfg
        if route.name == "superpixel":
            return self.superpixel_cfg
        return self.cfg

    def _corrupt(self, route: RouteSpec, centers: np.ndarray) -> np.ndarray:
        """The ``solve`` fault site, on a chunk's fitted centers."""
        if self._faults is None:
            return centers
        return np.asarray(self._faults.corrupt("solve", centers,
                                               route=route.name))

    def _salvage_requests(self, route: RouteSpec, bad: List[Any],
                          results: Dict[int, SegmentationResult],
                          fitted: Dict[bytes, np.ndarray]) -> None:
        """Re-solve poisoned requests in a bucket of their own on the
        plain solver (``backend="reference"``, on the engine's device)
        and finish them from the clean centers: one non-finite lane costs
        a re-solve of that lane, not its batch. A request still
        non-finite fails with :class:`SolveFailed` (async: on its future;
        synchronous: raised to the flushing caller)."""
        self._route_counter("salvaged", route.name).inc(len(bad))
        problem, cfg = route.build_problem(self, bad,
                                           self._bucket_for(len(bad)))
        res = SV.solve_batched(problem, cfg, backend="reference")
        centers = res.centers.cpu().numpy()
        doomed: Optional[BaseException] = None
        for lane, p in enumerate(bad):
            if not bool(res.healthy[lane]):
                err = SolveFailed(
                    f"request {p.request_id}: non-finite centers even "
                    f"on the reference backend")
                if not self._fail_request(p, err) and doomed is None:
                    doomed = err
                continue
            r = route.materialize(self, p, centers[lane],
                                  int(res.n_iters[lane]), False)
            r.converged = bool(res.converged[lane])
            self._finish(route, results, r)
            if route.cacheable and getattr(p, "key", None) is not None:
                fitted[p.key] = centers[lane]
                if self.cache_size > 0 and p.hist is not None:
                    self._cache_put(p.key, centers[lane], p.hist)
        if doomed is not None:
            raise doomed

    def _run_program(self, route: RouteSpec, prog: RouteProgram,
                     chunk: List[Any], bucket: int,
                     results: Dict[int, SegmentationResult]):
        """gather -> launch (under the retry policy) -> scatter; finishes
        the finite lanes and returns (centers, n_iters, total_iters,
        deltas, bad requests, the three spans). Returns None when the
        launch failed past its retries: the breaker has counted it and
        the chunk is degraded. Any error but an injected fault
        propagates."""
        with self.tracer.span("gather", route=route.name) as sp_g:
            inputs = prog.gather(self, chunk, bucket)
        try:
            with self.tracer.span("launch", route=route.name) as sp_s:
                outs = sp_s.fence(self._launch_attempts(route, prog, inputs))
        except FI.InjectedFault:
            self._breaker_failure(route.name)
            self._route_counter("degraded", route.name).inc()
            return None
        except Exception:
            self._breaker_abandon_probe(route.name)
            raise
        self._breaker_success(route.name)
        with self.tracer.span("scatter", route=route.name) as sp_m:
            res_list, centers, n_iters, total_iters, deltas = \
                prog.scatter(self, chunk, outs)
        centers = self._corrupt(route, centers)
        finite = np.isfinite(
            centers.reshape(centers.shape[0], -1)).all(axis=1)
        bad: List[Any] = []
        for lane, (p, r) in enumerate(zip(chunk, res_list)):
            if not bool(finite[lane]):
                bad.append(p)
                continue
            r.converged = bool(n_iters[lane] < prog.max_iters)
            self._finish(route, results, r)
        return (centers, n_iters, total_iters, deltas, bad,
                (sp_g, sp_s, sp_m))

    def _run_solve(self, route: RouteSpec, chunk: List[Any], bucket: int,
                   results: Dict[int, SegmentationResult], backend: str):
        """build_problem -> solve_batched(backend) -> materialize each
        finite lane: a route without a program (``"auto"``) or a degraded
        chunk (``"reference"``, the plain solver on the engine's device).
        Returns what :meth:`_run_program` returns."""
        with self.tracer.span("build", route=route.name) as sp_g:
            problem, cfg = route.build_problem(self, chunk, bucket)
        with self.tracer.span("solve", route=route.name) as sp_s:
            res = SV.solve_batched(problem, cfg, backend=backend)
            sp_s.fence(res.centers)
        with self.tracer.span("materialize", route=route.name) as sp_m:
            centers = self._corrupt(route, res.centers.cpu().numpy())
            finite = np.isfinite(
                centers.reshape(centers.shape[0], -1)).all(axis=1)
            good = [lane for lane in range(len(chunk)) if finite[lane]]
            bad = [p for lane, p in enumerate(chunk) if not finite[lane]]
            if route.materialize_batch is not None:
                done = (route.materialize_batch(
                    self, [chunk[lane] for lane in good], centers[good],
                    res.n_iters[good]) if good else [])
            else:
                done = [route.materialize(self, chunk[lane], centers[lane],
                                          int(res.n_iters[lane]), False)
                        for lane in good]
            for lane, r in zip(good, done):
                r.converged = bool(res.converged[lane])
                self._finish(route, results, r)
        return (centers, res.n_iters, res.total_iters, res.final_delta, bad,
                (sp_g, sp_s, sp_m))

    def _run_bucket(self, route: RouteSpec, chunk: List[Any], bucket: int,
                    results: Dict[int, SegmentationResult],
                    fitted: Dict[bytes, np.ndarray]) -> None:
        prog = self._program_for(route, chunk, bucket)
        use_prog = prog is not None and self._breaker_allows(route.name)
        out = None
        with self.tracer.span("bucket", route=route.name, bucket=bucket,
                              n=len(chunk), fused=use_prog,
                              requests=[p.request_id for p in chunk]):
            if use_prog:
                out = self._run_program(route, prog, chunk, bucket, results)
            if out is None:
                out = self._run_solve(
                    route, chunk, bucket, results,
                    "auto" if prog is None else "reference")
            centers, n_iters, total_iters, deltas, bad, spans = out
            sp_g, sp_s, sp_m = spans
            self._stage_seconds(route.name, "ingest").inc(sp_g.wall_s)
            self._stage_seconds(route.name, "solve").inc(sp_s.wall_s)
            self._stage_seconds(route.name, "materialize").inc(sp_m.wall_s)
            try:
                if bad:
                    # Poisoned lanes re-solve alone; their batchmates are
                    # already finished, untouched.
                    with self.tracer.span("salvage", route=route.name,
                                          n=len(bad)):
                        self._salvage_requests(route, bad, results, fitted)
            finally:
                self._account(route, chunk, bucket, centers, n_iters,
                              total_iters, deltas, bad, fitted)

    def _account(self, route: RouteSpec, chunk: List[Any], bucket: int,
                 centers: np.ndarray, n_iters, total_iters, deltas,
                 bad: List[Any], fitted: Dict[bytes, np.ndarray]) -> None:
        """A bucket's counters, convergence telemetry and cache entries;
        poisoned lanes never enter the cache."""
        self._route_counter("batches", route.name).inc()
        self._route_counter("images", route.name).inc(len(chunk))
        self._route_counter("padded", route.name).inc(bucket - len(chunk))
        self._route_counter("iters", route.name).inc(int(total_iters))
        self._occupancy_hist(route.name).record(len(chunk) / bucket)
        h = self._iters_hist(route.name)
        for it in np.asarray(n_iters)[:len(chunk)]:
            h.record(int(it))
        self.metrics.gauge("route.last_final_delta", route=route.name).set(
            float(np.max(np.asarray(deltas)[:len(chunk)])))
        if route.cacheable and self.cache_size > 0:
            bad_ids = {p.request_id for p in bad}
            for lane, p in enumerate(chunk):
                if p.request_id not in bad_ids:
                    fitted[p.key] = centers[lane]
                    self._cache_put(p.key, centers[lane], p.hist)

    # -- cache -------------------------------------------------------------

    def _cache_get(self, key: bytes,
                   hist: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
        if self.cache_size <= 0:
            return None
        entry = self._cache.get(key)
        if entry is not None:
            self._cache.move_to_end(key)
            return entry[0]
        if hist is None or self.cache_tol <= 0:
            return None
        # Nearest-match scan, most recent first.
        q = self._normalize(hist)
        for k in reversed(self._cache):
            centers, dist = self._cache[k]
            if float(np.abs(dist - q).sum()) <= self.cache_tol:
                self._cache.move_to_end(k)
                return centers
        return None

    def _cache_put(self, key: bytes, centers: np.ndarray, hist: np.ndarray):
        if self.cache_size <= 0:
            return
        self._cache[key] = (np.asarray(centers), self._normalize(hist))
        self._cache.move_to_end(key)
        while len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)

    # -- observability -----------------------------------------------------

    @property
    def queue_depth(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def stats(self) -> Dict[str, Any]:
        """The flat stat keys of the JAX engine (rendered from the
        metrics registry), plus the per-route ``latency``,
        ``convergence``, admission and ``fault_tolerance`` blocks and the
        ``faults`` provenance. Plain JSON types only."""
        s: Dict[str, Any] = {}
        s["requests"] = self.metrics.counter("requests").snapshot()
        s["cache_hits"] = self.metrics.counter("cache_hits").snapshot()
        for route in ROUTES.values():
            s[route.stat("seconds")] = \
                self._stage_seconds(route.name, "solve").snapshot()
            s[route.stat("ingest")] = \
                self._stage_seconds(route.name, "ingest").snapshot()
            s[route.stat("materialize")] = \
                self._stage_seconds(route.name, "materialize").snapshot()
            s[route.stat("compress")] = \
                self._stage_seconds(route.name, "compress").snapshot()
            for k in ("batches", "images", "padded", "iters"):
                s[route.stat(k)] = \
                    self._route_counter(k, route.name).snapshot()
        s["compress_seconds"] = sum(
            self._stage_seconds(r.name, "compress").snapshot()
            for r in ROUTES.values())
        s["queue_depth"] = self.queue_depth
        s["cache_entries"] = len(self._cache)
        s["method_requests"] = {
            r.name: self._route_counter("requests", r.name).snapshot()
            for r in ROUTES.values()}
        s["method_cache_hits"] = {
            r.name: self._route_counter("cache_hits", r.name).snapshot()
            for r in ROUTES.values()}
        cacheable = sum(s["method_requests"][r.name]
                        for r in ROUTES.values() if r.cacheable)
        s["cache_hit_rate"] = (s["cache_hits"] / cacheable
                               if cacheable else 0.0)
        fit_s = s.get("fit_seconds", 0.0)
        s["images_per_sec"] = (s.get("batched_images", 0) / fit_s
                               if fit_s > 0 else 0.0)
        s["stage_seconds"] = {
            r.name: {"ingest": s[r.stat("ingest")],
                     "solve": s[r.stat("seconds")],
                     "materialize": s[r.stat("materialize")]}
            for r in ROUTES.values()}
        s["compiled_programs"] = len(self._programs)
        s["latency"] = {r.name: self._latency_hist(r.name).snapshot()
                        for r in ROUTES.values()}
        s["convergence"] = {}
        for r in ROUTES.values():
            h = self._iters_hist(r.name)
            g = self.metrics.peek("route.last_final_delta", route=r.name)
            s["convergence"][r.name] = {
                "lanes": h.count,
                "mean_iters": h.mean,
                "p50_iters": h.quantile(0.50),
                "p99_iters": h.quantile(0.99),
                "last_final_delta": g.snapshot() if g else None,
            }
        s["queue_depth_by_route"] = {
            r.name: len(self._queues.get(r.name, ()))
            for r in ROUTES.values()}
        s["batch_occupancy"] = {
            r.name: self._occupancy_hist(r.name).snapshot()
            for r in ROUTES.values()}
        s["deadline_expired"] = {
            r.name: self._route_counter("deadline_expired",
                                        r.name).snapshot()
            for r in ROUTES.values()}
        s["pending_futures"] = len(self._futures)
        with self._lock:
            breaker_state = {name: b["state"]
                             for name, b in self._breakers.items()}
        s["fault_tolerance"] = {
            k: {r.name: self._route_counter(k, r.name).snapshot()
                for r in ROUTES.values()}
            for k in ("retries", "shed", "salvaged", "degraded",
                      "breaker_trips", "invalid_input")}
        s["fault_tolerance"].update(
            breaker_state=breaker_state,
            flusher_restarts=self.metrics.counter(
                "flusher.restarts").snapshot(),
            flusher_kills=self._flusher_kills)
        s["faults"] = (self._faults.snapshot() if self._faults is not None
                       else FI.clean_snapshot())
        return obs.json_safe(s)

    def healthy(self) -> bool:
        """Liveness: False once shut down, or while async requests are
        pending with no live flusher to drain them. An open breaker is
        degraded service, not death: it flips :meth:`readiness`."""
        with self._lock:
            if self._closed:
                return False
            if sum(self._async_n.values()) > 0 and (
                    self._flusher is None
                    or not self._flusher.is_alive()):
                return False
        return True

    def readiness(self) -> Dict[str, Any]:
        """One JSON-safe health snapshot for probes: liveness, per-route
        breaker state, the flusher's life and restarts, and the queue
        against the overload limit."""
        with self._lock:
            breaker_state = {r.name: self._breaker(r.name)["state"]
                             for r in ROUTES.values()}
            flusher_alive = (self._flusher is not None
                             and self._flusher.is_alive())
            depth = self.queue_depth
        return obs.json_safe({
            "healthy": self.healthy(),
            "ready": not self._closed
            and all(st != "open" for st in breaker_state.values()),
            "breaker_state": breaker_state,
            "flusher_alive": flusher_alive,
            "flusher_restarts":
                self.metrics.counter("flusher.restarts").snapshot(),
            "flusher_kills": self._flusher_kills,
            "queue_depth": depth,
            "max_queue_depth": self.max_queue_depth,
        })

    def reset_stats(self) -> None:
        """Zero every counter/gauge/histogram and drop the trace ring;
        registered keys survive, so the stats schema is unchanged."""
        self.metrics.reset()
        self.tracer.clear()
        self._submit_t.clear()

    def snapshot(self) -> Dict[str, Any]:
        """One JSON-serializable dump: stats, raw metrics, recent traces."""
        return obs.json_safe({
            "stats": self.stats(),
            "metrics": self.metrics.snapshot(),
            "traces": self.tracer.traces(),
        })
