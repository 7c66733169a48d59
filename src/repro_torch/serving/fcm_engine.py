"""Request-batching segmentation engine: the histogram route, sync API.

Every serving method is a declarative :class:`RouteSpec` in a route
registry: an ingest transform, a bucket key (requests sharing one may
share one launch), a materializer (per-request labels from centers, for
cache hits and duplicates) and a :class:`RouteProgram` factory. ``flush``
groups queued requests by bucket key, pads each chunk to the nearest
size in ``batch_sizes`` and runs one program per chunk.

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

The pixel, spatial and superpixel routes, async admission, retries, the
circuit breaker, per-request salvage and mesh dispatch are not ported
yet. A lane whose centers come back non-finite fails with
:class:`~repro_torch.serving.admission.SolveFailed`.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import (Any, Callable, Dict, Hashable, List, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from .. import _device as DV
from .. import obs
from ..core import fcm as F
from ..core import solver as SV
from ..core.batched import hist_rows
from ..kernels import ops as kops
from .admission import InvalidInput, SolveFailed


@dataclasses.dataclass
class SegmentationResult:
    """Per-request output."""
    request_id: int
    labels: np.ndarray            # same spatial shape as the submitted image
    centers: np.ndarray           # (c,)
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


# ---------------------------------------------------------------------------
# Route registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RouteSpec:
    """One serving method, declaratively.

    ``ingest(engine, img, rid)`` validates and reduces the payload;
    ``bucket_key(engine, payload)`` decides which payloads may share one
    launch; ``materialize`` turns fitted centers into one request's
    labels (cache hits, duplicates); ``program_key(engine, chunk)``
    names the program shape a chunk shares and ``make_program(engine,
    key, bucket)`` builds that :class:`RouteProgram`, cached per (route
    generation, bucket, key). ``cacheable`` routes carry a
    ``.key``/``.hist`` payload and go through the histogram LRU and
    intra-flush dedup.
    """
    name: str
    ingest: Callable[["FCMServeEngine", np.ndarray, int], Any]
    bucket_key: Callable[["FCMServeEngine", Any], Hashable]
    materialize: Callable[["FCMServeEngine", Any, np.ndarray, int, bool],
                          SegmentationResult]
    program_key: Callable[["FCMServeEngine", List[Any]], Hashable]
    make_program: Callable[["FCMServeEngine", Hashable, int],
                           "RouteProgram"]
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
    (B,))``.
    """
    gather: Callable[["FCMServeEngine", List[Any], int], Tuple]
    launch: Callable[..., Tuple]
    scatter: Callable[["FCMServeEngine", List[Any], Tuple], Tuple]


#: engine-held programs per (route, generation, bucket, key), bounded so
#: size-keyed program flavors recycle rather than accrete
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
    dev = eng.device
    impl = kops.select_step("flat", platform=dev.type, n_feat=1,
                            batched=True, n_rows=nb, c=c).name
    vals = hist_rows(torch.empty((bucket, nb), device=dev)).contiguous()

    def _solve(hists):
        v, delta, iters, total = SV.flat_batched_solve(
            vals[..., None], hists, c, m, eps, max_iters, impl=impl)
        return v[..., 0].contiguous(), delta, iters, total

    def _unpack(outs):
        v2, delta, iters, total, tail = outs
        return (v2.cpu().numpy(), delta.cpu().numpy(), iters.cpu().numpy(),
                int(total), tail.cpu().numpy())

    if key[0] == "px":
        n = key[1]

        def launch(px):
            hists = kops.histogram_counts(px, nb)
            v2, delta, iters, total = _solve(hists)
            labels = kops.defuzzify_labels_batched(px, v2)
            return v2, delta, iters, total, labels

        def gather(eng_, chunk, bucket_):
            # uint8 traffic stages uint8; mixed dtypes stage int32.
            # Padding lanes replay lane 0.
            dtype = (np.uint8 if all(p.flat.dtype == np.uint8
                                     for p in chunk) else np.int32)
            px = np.empty((bucket_, n), dtype)
            for i, p in enumerate(chunk):
                px[i] = p.flat
            px[len(chunk):] = px[0]
            return (torch.from_numpy(px).to(dev),)

        def scatter(eng_, chunk, outs):
            centers, delta, iters, total, labels = _unpack(outs)
            res = [SegmentationResult(p.request_id,
                                      labels[i].reshape(p.shape),
                                      centers[i], int(iters[i]), False)
                   for i, p in enumerate(chunk)]
            return res, centers, iters, total, delta

        return RouteProgram(gather, launch, scatter)

    # Mixed payload sizes: one solve on the stacked histograms (padding
    # lanes uniform), the per-bin label table on the device, per-request
    # labels by a host gather.
    def launch(hists):
        v2, delta, iters, total = _solve(hists)
        lut = kops.defuzzify_labels_batched(vals, v2)
        return v2, delta, iters, total, lut

    def gather(eng_, chunk, bucket_):
        hists = np.ones((bucket_, nb), np.float32)
        for i, p in enumerate(chunk):
            hists[i] = _ensure_hist(eng_, p).hist
        return (torch.from_numpy(hists).to(dev),)

    def scatter(eng_, chunk, outs):
        centers, delta, iters, total, lut = _unpack(outs)
        res = [SegmentationResult(p.request_id,
                                  lut[i][p.flat].reshape(p.shape),
                                  centers[i], int(iters[i]), False)
               for i, p in enumerate(chunk)]
        return res, centers, iters, total, delta

    return RouteProgram(gather, launch, scatter)


register_route(RouteSpec(
    name="histogram", ingest=_ingest_histogram,
    bucket_key=lambda eng, p: ("hist",),
    materialize=_materialize_histogram,
    program_key=_histogram_program_key,
    make_program=_make_histogram_program,
    cacheable=True))

#: The serving routes, in registration order.
METHODS = tuple(ROUTES)


class FCMServeEngine:
    """Static-bucket batching engine for FCM segmentation requests.

    ``submit`` ingests an image (any 2-D/3-D shape, 8-bit-range values);
    ``flush`` answers cache hits and runs one program per bucketed
    chunk; ``segment`` is submit-all-then-flush. The engine runs on
    ``device`` (``None`` = the card; with no card it raises).
    """

    def __init__(self, cfg: F.FCMConfig = F.FCMConfig(),
                 batch_sizes: Sequence[int] = (1, 8, 64),
                 n_bins: int = 256,
                 cache_size: int = 256,
                 cache_tol: float = 0.15,
                 tracing: bool = True,
                 trace_ring: int = 64,
                 device=None):
        if not batch_sizes or any(b <= 0 for b in batch_sizes):
            raise ValueError(f"bad batch_sizes {batch_sizes!r}")
        self.device = DV.resolve_device(device)
        self.cfg = cfg
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
        #: request id -> submit perf_counter, consumed when the result
        #: materializes (the per-route latency histogram)
        self._submit_t: Dict[int, float] = {}
        #: guards queues and id allocation: submit may race a flush
        self._lock = threading.Lock()
        self.metrics.counter("requests")
        self.metrics.counter("cache_hits")
        self.metrics.gauge("queue.depth")
        for route in ROUTES.values():
            for k in ("requests", "cache_hits", "batches", "images",
                      "padded", "iters"):
                self._route_counter(k, route.name)
            for stage in ("ingest", "solve", "materialize", "compress"):
                self._stage_seconds(route.name, stage)
            self._latency_hist(route.name)
            self._iters_hist(route.name)
            self._occupancy_hist(route.name)
            self.metrics.gauge("queue.depth", route=route.name)

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
        self.metrics.gauge("queue.depth").set(
            sum(len(q) for q in self._queues.values()))

    def _finish(self, route: RouteSpec, results: Dict[int, Any],
                r: SegmentationResult) -> None:
        """Record one materialized result and its submit->result latency."""
        results[r.request_id] = r
        t = self._submit_t.pop(r.request_id, None)
        if t is not None:
            self._latency_hist(route.name).record(time.perf_counter() - t)

    # -- submit / flush ----------------------------------------------------

    def _ingest(self, method: str, img: np.ndarray):
        route = ROUTES.get(method)
        if route is None:
            raise ValueError(f"unknown method {method!r}; registered "
                             f"routes: {METHODS}")
        img = np.asarray(img)
        with self.tracer.span("ingest", ring=False, route=method) as sp:
            _validate_payload(img)
            pending = route.ingest(self, img, self._next_id)
        self._stage_seconds(method, "ingest").inc(sp.wall_s)
        return pending

    def submit(self, img: np.ndarray, method: str = "histogram") -> int:
        """Queue one image on a registered route; returns its request id.
        Invalid payloads raise before consuming an id."""
        t_submit = time.perf_counter()
        pending = self._ingest(method, img)
        with self._lock:
            rid = self._next_id
            self._next_id += 1
            pending.request_id = rid
            self.metrics.counter("requests").inc()
            self._route_counter("requests", method).inc()
            self._submit_t[rid] = t_submit
            self._queues.setdefault(method, []).append(pending)
            self._set_queue_gauges()
        return rid

    @staticmethod
    def _normalize(hist: np.ndarray) -> np.ndarray:
        return hist / max(float(hist.sum()), 1.0)

    def flush(self) -> List[SegmentationResult]:
        """Run every queued request; returns results in submit order.
        Leaves one root trace per flush in ``tracer``'s ring."""
        results: Dict[int, SegmentationResult] = {}
        with self._lock:
            drained = self._queues
            self._queues = {name: [] for name in drained}
            self._set_queue_gauges()
        n_queued = sum(len(v) for v in drained.values())
        with self.tracer.span("flush", queued=n_queued):
            for route in ROUTES.values():
                pend = drained.get(route.name) or []
                if not pend:
                    continue
                try:
                    self._flush_route(route, pend, results)
                finally:
                    for p in pend:          # failed requests are done too
                        self._submit_t.pop(p.request_id, None)
        return [results[rid] for rid in sorted(results)]

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

    def segment(self, imgs: Sequence[np.ndarray],
                method: str = "histogram") -> List[SegmentationResult]:
        ids = [self.submit(im, method=method) for im in imgs]
        by_id = {r.request_id: r for r in self.flush()}
        return [by_id[i] for i in ids]

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
                     bucket: int) -> RouteProgram:
        """The program this chunk rides, built once per (route
        generation, bucket, shape key); stale generations are purged."""
        key = route.program_key(self, chunk)
        gen = _ROUTE_GEN[route.name]
        for k in [k for k in self._programs
                  if k[0] == route.name and k[1] != gen]:
            del self._programs[k]
        full_key = (route.name, gen, bucket, key)
        prog = self._programs.get(full_key)
        if prog is None:
            prog = route.make_program(self, key, bucket)
            self._programs[full_key] = prog
            while len(self._programs) > _PROGRAM_CACHE_SIZE:
                del self._programs[next(iter(self._programs))]
        return prog

    def _run_bucket(self, route: RouteSpec, chunk: List[Any], bucket: int,
                    results: Dict[int, SegmentationResult],
                    fitted: Dict[bytes, np.ndarray]) -> None:
        prog = self._program_for(route, chunk, bucket)
        max_iters = int(self.cfg.max_iters)
        bad: List[Any] = []
        with self.tracer.span("bucket", route=route.name, bucket=bucket,
                              n=len(chunk),
                              requests=[p.request_id for p in chunk]):
            with self.tracer.span("gather", route=route.name) as sp_g:
                inputs = prog.gather(self, chunk, bucket)
            with self.tracer.span("launch", route=route.name) as sp_s:
                outs = sp_s.fence(prog.launch(*inputs))
            with self.tracer.span("scatter", route=route.name) as sp_m:
                res_list, centers, n_iters, total_iters, deltas = \
                    prog.scatter(self, chunk, outs)
            finite = np.isfinite(
                centers.reshape(centers.shape[0], -1)).all(axis=1)
            for lane, (p, r) in enumerate(zip(chunk, res_list)):
                if not bool(finite[lane]):
                    bad.append(p)
                    continue
                r.converged = bool(n_iters[lane] < max_iters)
                self._finish(route, results, r)
        self._stage_seconds(route.name, "ingest").inc(sp_g.wall_s)
        self._stage_seconds(route.name, "solve").inc(sp_s.wall_s)
        self._stage_seconds(route.name, "materialize").inc(sp_m.wall_s)
        self._route_counter("batches", route.name).inc()
        self._route_counter("images", route.name).inc(len(chunk))
        self._route_counter("padded", route.name).inc(bucket - len(chunk))
        self._route_counter("iters", route.name).inc(int(total_iters))
        self._occupancy_hist(route.name).record(len(chunk) / bucket)
        h = self._iters_hist(route.name)
        for it in n_iters[:len(chunk)]:
            h.record(int(it))
        self.metrics.gauge("route.last_final_delta", route=route.name).set(
            float(np.max(deltas[:len(chunk)])))
        if route.cacheable and self.cache_size > 0:
            for lane, p in enumerate(chunk):
                if bool(finite[lane]):   # poisoned centers never cached
                    fitted[p.key] = centers[lane]
                    self._cache_put(p.key, centers[lane], p.hist)
        if bad:
            raise SolveFailed(
                f"requests {[p.request_id for p in bad]}: non-finite "
                f"centers")

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
        """The flat stat keys of the JAX engine for the counters this
        port has (rendered from the metrics registry), plus the per-route
        ``latency`` and ``convergence`` blocks. Plain JSON types only."""
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
        return obs.json_safe(s)

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
