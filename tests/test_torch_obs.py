"""The port's obs layer against the JAX package's: the same recorded
values give the same snapshots, and ``Span.fence`` waits only when the
value holds CUDA tensors (on the CPU it returns at once)."""
import numpy as np
import torch

from repro import obs as jobs
from repro_torch import obs as tobs


def test_metrics_snapshots_match_jax():
    rng = np.random.default_rng(0)
    vals = rng.lognormal(-6, 1.5, 500)
    its = rng.integers(1, 120, 200)
    snaps = []
    for mod in (jobs, tobs):
        reg = mod.MetricsRegistry()
        h = reg.histogram("lat", route="histogram")
        for v in vals:
            h.record(v)
        it = reg.histogram("iters", edges=mod.ITER_EDGES)
        for v in its:
            it.record(int(v))
        reg.counter("requests").inc(7)
        reg.gauge("depth").set(3)
        snaps.append(reg.snapshot())
    assert snaps[0] == snaps[1]


def test_span_fence_on_cpu_and_trace_ring():
    tr = tobs.Tracer(max_traces=2, metrics=tobs.MetricsRegistry())
    x = torch.ones(3)
    for _ in range(3):
        with tr.span("flush"):
            with tr.span("launch") as sp:
                out = sp.fence((x, 2))
    assert out[0] is x and sp.device_s is not None
    traces = tr.traces()
    assert len(traces) == 2
    assert traces[-1]["children"][0]["name"] == "launch"
    assert "device_s" in traces[-1]["children"][0]


def test_disabled_tracer_times_but_records_nothing():
    reg = tobs.MetricsRegistry()
    tr = tobs.Tracer(enabled=False, metrics=reg)
    with tr.span("flush") as sp:
        pass
    assert sp.wall_s is not None
    assert tr.traces() == [] and reg.snapshot()["histograms"] == {}
