"""Process-local counters, gauges, and fixed-bucket histograms.

The histogram is the workhorse: a fixed set of bucket edges (log-spaced
for latencies, unit-spaced for iteration counts) so ``record()`` is one
``bisect`` + increment — cheap enough for the serving hot path — while
``quantile()`` reads p50/p90/p99 by linear interpolation inside the
containing bucket. Quantiles are therefore approximate with error
bounded by the bucket width; the test suite pins them against numpy
percentiles at that tolerance.

Metrics live in a :class:`MetricsRegistry`, keyed by name plus optional
labels (``registry.histogram("request_latency", route="spatial")``).
``snapshot()`` renders the whole registry as one plain-JSON dict —
python ints/floats only, never numpy scalars — and ``reset()`` zeroes
every registered metric in place (the registry keeps the keys, so a
dashboard's schema survives a stats reset).
"""
from __future__ import annotations

import contextlib
import json
import math
import threading
from bisect import bisect_right
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_registry", "scoped_registry", "json_safe",
           "LATENCY_EDGES", "ITER_EDGES", "UNIT_EDGES"]


#: Default latency bucket edges (seconds): eighth-decade log steps from
#: 1 µs to 100 s — quantile error bounded by a 10^(1/8) ≈ 1.33x factor.
LATENCY_EDGES: Tuple[float, ...] = tuple(
    10.0 ** (e / 8.0) for e in range(-48, 17))

#: Iteration-count bucket edges: unit-spaced through 64 (quantiles exact
#: to ±1 iteration in the regime FCM converges in), then coarsening
#: toward the solver's max_iters ceilings.
ITER_EDGES: Tuple[float, ...] = tuple(range(1, 65)) + (
    80, 96, 128, 160, 192, 256, 320, 384, 448, 512)

#: Unit-interval bucket edges (fractions: batch occupancy, hit rates) —
#: 1/32 steps so quantiles resolve to ~3% of full scale.
UNIT_EDGES: Tuple[float, ...] = tuple(i / 32.0 for i in range(0, 33))

#: One process-wide mutation lock shared by every Counter/Gauge/
#: Histogram. Metric writes are a handful of int ops, so a single
#: uncontended lock costs ~100ns and makes the async serving engine's
#: cross-thread recording (flusher thread vs. callers) race-free:
#: ``value += n`` and the histogram's multi-field update are
#: read-modify-write sequences the GIL alone does not make atomic.
_MUT = threading.Lock()


def json_safe(obj):
    """Recursively coerce a stats tree to plain JSON types (numpy
    scalars -> python ints/floats, tuples -> lists); raises on anything
    json could not represent rather than letting it leak out."""
    if obj is None or isinstance(obj, (bool, str)):
        return obj
    if isinstance(obj, int):
        return int(obj)
    if isinstance(obj, float):
        return float(obj)
    if isinstance(obj, dict):
        return {str(k): json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    # numpy scalars (np.float32, np.int64, ...) expose item(); arrays
    # expose tolist(). Neither is imported here — duck-type them.
    if hasattr(obj, "item") and not hasattr(obj, "__len__"):
        return json_safe(obj.item())
    if hasattr(obj, "tolist"):
        return json_safe(obj.tolist())
    raise TypeError(f"not JSON-serializable: {type(obj).__name__}: {obj!r}")


class Counter:
    """Monotonic accumulator. Stays a python int while fed ints (batch
    and request counts), becomes a float once fed one (stage seconds)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n=1):
        with _MUT:
            self.value += n

    def snapshot(self):
        return json_safe(self.value)


class Gauge:
    """Last-write-wins value (queue depth, last residual)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v):
        self.value = float(v)

    def snapshot(self):
        return float(self.value)


class Histogram:
    """Fixed-bucket histogram with quantile readout.

    ``edges`` are the bucket boundaries; bucket ``i`` covers
    ``[edges[i-1], edges[i])`` with an underflow bucket below
    ``edges[0]`` and an overflow bucket at ``>= edges[-1]``. Exact
    count/sum/min/max ride alongside, so ``mean`` is exact and
    quantile interpolation can clamp to the observed range.
    """

    __slots__ = ("edges", "counts", "count", "total", "vmin", "vmax")

    def __init__(self, edges: Sequence[float] = LATENCY_EDGES):
        if len(edges) < 1 or any(b <= a for a, b in zip(edges, edges[1:])):
            raise ValueError(f"edges must be strictly increasing, "
                             f"got {edges!r}")
        self.edges: Tuple[float, ...] = tuple(float(e) for e in edges)
        self.counts: List[int] = [0] * (len(self.edges) + 1)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def record(self, v) -> None:
        v = float(v)
        with _MUT:
            self.counts[bisect_right(self.edges, v)] += 1
            self.count += 1
            self.total += v
            if v < self.vmin:
                self.vmin = v
            if v > self.vmax:
                self.vmax = v

    def _bucket_bounds(self, i: int) -> Tuple[float, float]:
        lo = self.edges[i - 1] if i > 0 else min(self.vmin, self.edges[0])
        hi = self.edges[i] if i < len(self.edges) else max(self.vmax,
                                                           self.edges[-1])
        return lo, hi

    def quantile_info(self, q: float) -> Tuple[Optional[float], bool]:
        """``(value, overflow)``: the approximate q-quantile (numpy
        'linear' rank convention, linear-interpolated inside the
        containing bucket, clamped to the observed [min, max]) plus
        whether it landed in the overflow bucket. An overflow-derived
        quantile interpolates between ``edges[-1]`` and the tracked
        ``vmax`` — honest about the observed range (no silent clamp at
        the last edge), but with only two real anchor points, so
        consumers should treat it as a range estimate and widen the
        edges. ``(None, False)`` when empty."""
        if self.count == 0:
            return None, False
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile q must be in [0, 1], got {q}")
        overflow_bucket = len(self.edges)
        rank = q * (self.count - 1)
        cum = 0
        for i, c in enumerate(self.counts):
            if c and rank < cum + c:
                lo, hi = self._bucket_bounds(i)
                frac = (rank - cum + 0.5) / c
                val = lo + frac * (hi - lo)
                return (min(max(val, self.vmin), self.vmax),
                        i == overflow_bucket)
            cum += c
        return self.vmax, self.counts[overflow_bucket] > 0

    def quantile(self, q: float) -> Optional[float]:
        """Approximate q-quantile; see :meth:`quantile_info`."""
        return self.quantile_info(q)[0]

    @property
    def mean(self) -> Optional[float]:
        return self.total / self.count if self.count else None

    def snapshot(self) -> dict:
        empty = self.count == 0
        quants = {f"p{int(q * 100)}": self.quantile_info(q)
                  for q in (0.50, 0.90, 0.99)}
        out = {
            "count": int(self.count),
            "sum": float(self.total),
            "mean": None if empty else float(self.total / self.count),
            "min": None if empty else float(self.vmin),
            "max": None if empty else float(self.vmax),
        }
        for name, (val, over) in quants.items():
            out[name] = val
            # overflow-derived quantiles interpolate off the tracked max
            # rather than a real edge: flagged so dashboards can widen
            # the histogram edges instead of trusting the estimate.
            out[f"{name}_overflow"] = over
        return out


def _key(name: str, labels: Dict[str, str]) -> Hashable:
    return (name, tuple(sorted((k, str(v)) for k, v in labels.items())))


def _render(key: Hashable) -> str:
    name, labels = key
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


class MetricsRegistry:
    """Name+labels keyed metric store with a schema'd JSON snapshot."""

    def __init__(self):
        self._metrics: Dict[Hashable, object] = {}

    def _get(self, cls, name: str, labels: Dict[str, str], **kw):
        key = _key(name, labels)
        with _MUT:       # get-or-create must not race across threads
            m = self._metrics.get(key)
            if m is None:
                m = cls(**kw)
                self._metrics[key] = m
        if not isinstance(m, cls):
            raise TypeError(f"metric {_render(key)!r} already registered "
                            f"as {type(m).__name__}, not {cls.__name__}")
        return m

    def peek(self, name: str, **labels):
        """The metric registered under (name, labels), or None — a
        lookup that never creates (use it for 'has this ever been
        recorded' reads)."""
        return self._metrics.get(_key(name, labels))

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, edges: Sequence[float] = LATENCY_EDGES,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, edges=edges)

    def reset(self) -> None:
        """Zero every metric in place; registered keys survive so
        snapshots keep their schema after a stats reset."""
        for m in self._metrics.values():
            if isinstance(m, Histogram):
                m.counts = [0] * len(m.counts)
                m.count = 0
                m.total = 0.0
                m.vmin = math.inf
                m.vmax = -math.inf
            elif isinstance(m, Counter):
                m.value = 0
            else:
                m.value = 0.0

    def snapshot(self) -> dict:
        """{"counters": {...}, "gauges": {...}, "histograms": {...}},
        keys rendered ``name{label=value,...}``, values plain JSON."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for key in sorted(self._metrics, key=_render):
            m = self._metrics[key]
            group = ("counters" if isinstance(m, Counter)
                     else "gauges" if isinstance(m, Gauge)
                     else "histograms")
            out[group][_render(key)] = m.snapshot()
        return out

    def to_json(self, **json_kw) -> str:
        return json.dumps(self.snapshot(), **json_kw)


#: Registry stack: the bottom entry is the process-wide default; a
#: :func:`scoped_registry` context pushes a fresh registry on top so
#: telemetry recorded inside the scope is captured in isolation.
_REGISTRY_STACK: List[MetricsRegistry] = [MetricsRegistry()]


def default_registry() -> MetricsRegistry:
    """The currently-active registry: the process-wide one (solver
    convergence telemetry lands here; the serving engine keeps its own
    per-instance registry), or — inside a :func:`scoped_registry`
    block — the innermost scoped registry."""
    return _REGISTRY_STACK[-1]


@contextlib.contextmanager
def scoped_registry(registry: Optional[MetricsRegistry] = None):
    """Route :func:`default_registry` telemetry to a private registry
    for the duration of the block — the cell-scoped capture the sweep
    harness wraps around each grid cell, so one cell's convergence
    telemetry never bleeds into another's record::

        with obs.scoped_registry() as reg:
            solver.solve(problem)          # telemetry -> reg
        cell["obs"] = reg.snapshot()

    Scopes nest (innermost wins) and the process-wide default registry
    is untouched throughout.
    """
    reg = MetricsRegistry() if registry is None else registry
    _REGISTRY_STACK.append(reg)
    try:
        yield reg
    finally:
        # Remove *this* scope even if an inner scope leaked; never pop
        # the process-wide default at the bottom of the stack.
        for i in range(len(_REGISTRY_STACK) - 1, 0, -1):
            if _REGISTRY_STACK[i] is reg:
                del _REGISTRY_STACK[i]
                break
