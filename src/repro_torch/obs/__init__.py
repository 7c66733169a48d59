"""Process-local observability: metrics, tracing, convergence telemetry.

* :mod:`repro_torch.obs.metrics` — counters, gauges and fixed-bucket
  histograms with p50/p90/p99 readout, grouped in a
  :class:`~repro_torch.obs.metrics.MetricsRegistry` whose ``snapshot()``
  is plain JSON-serializable.
* :mod:`repro_torch.obs.tracing` — nested spans recording wall time and,
  via :meth:`~repro_torch.obs.tracing.Span.fence`, device time fenced by
  ``torch.cuda.synchronize()``.
* a module-level default registry (:func:`default_registry`) that the
  solver core records convergence telemetry into.

Nothing here imports the solver, kernels or serving layers.
"""
from .metrics import (ITER_EDGES, LATENCY_EDGES, UNIT_EDGES,  # noqa: F401
                      Counter, Gauge, Histogram, MetricsRegistry,
                      default_registry, json_safe, scoped_registry)
from .tracing import Span, Tracer  # noqa: F401
