"""One run of one cell: inputs from the seed, the engine on the device,
warm-up, the measured window, the per-layer readers, the check, and the
result line.

The system under test is ``repro_torch.serving.fcm_engine.
FCMServeEngine``; nothing else of the program is called. The window is a
closed loop of one client: ``segment`` a study, wait for its labels,
send the next, until ``seconds`` have passed; the window ends when the
last request returns, so every request counted completed inside it.
"""
from __future__ import annotations

import contextlib
import gc
import os
import statistics
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from . import check as CK
from . import peaks as PK
from . import spec as SPEC
from . import trace as TR
from . import traffic as TF


def build_engine(config: Dict[str, Any], tracing: bool,
                 device: torch.device):
    """The configuration's engine (imported here: the harness loads the
    program only once a run starts)."""
    from repro_torch.core.fcm import FCMConfig
    from repro_torch.core.spatial import SpatialFCMConfig
    from repro_torch.serving.fcm_engine import FCMServeEngine
    f = config["fcm"]
    cfg = FCMConfig(n_clusters=int(f["n_clusters"]), m=float(f["m"]),
                    eps=float(f["eps"]), max_iters=int(f["max_iters"]))
    sp = config.get("spatial")
    spatial_cfg = None if sp is None else SpatialFCMConfig(
        n_clusters=cfg.n_clusters, m=cfg.m, eps=cfg.eps,
        max_iters=cfg.max_iters, alpha=float(sp["alpha"]),
        neighbors=int(sp["neighbors_2d"]))
    e = config["engine"]
    return FCMServeEngine(cfg, batch_sizes=tuple(e["batch_sizes"]),
                          cache_size=int(e["cache_size"]),
                          spatial_cfg=spatial_cfg, tracing=tracing,
                          device=device)


def _annotate_spans(eng) -> None:
    """Open a profiler annotation ``span.<name>`` around each engine span,
    so the trace can say which stage the host was in (traced runs only)."""
    inner = eng.tracer.span

    @contextlib.contextmanager
    def span(name, ring=True, **attrs):
        with torch.profiler.record_function(TR.SPAN + name):
            with inner(name, ring=ring, **attrs) as sp:
                yield sp
    eng.tracer.span = span


class Context:
    """What a per-layer reader reads: the engine's metrics over the
    window, the window's requests (each its lanes, ``traffic.Pool``, and
    the lanes' iterations), the voxels they completed and the window's
    seconds on the host's clock, the bank, the trace (None on an
    untraced run) and the peaks."""

    def __init__(self, cell: SPEC.Cell, route: str, metrics: Dict,
                 pool: TF.Pool, lanes: List[np.ndarray],
                 iters: List[np.ndarray], trace: Optional[TR.Trace],
                 voxels: int = 0, window_s: float = 0.0):
        self.cell = cell
        self.config = cell.config
        self.route = route
        self.metrics = metrics
        self.pool = pool
        self.lanes = lanes
        self.iters = iters
        self.requests = len(lanes)
        self.trace = trace
        self.voxels = voxels
        self.window_s = window_s
        self._bins: Optional[np.ndarray] = None

    def histogram(self, key: str) -> Optional[Dict]:
        h = self.metrics["histograms"].get(key)
        return h if h and h["count"] else None

    def span_ms_per_request(self, span: str) -> Optional[float]:
        """The exact sum of the engine's ``span`` over the window, in ms
        a request."""
        h = self.histogram(f"span_seconds{{span={span}}}")
        if h is None or not self.requests:
            return None
        return 1e3 * h["sum"] / self.requests

    def nonzero_bins(self, lanes: np.ndarray) -> np.ndarray:
        """(L,) distinct intensities of each of a request's lanes."""
        if self._bins is None:
            bank = np.stack(self.pool.volumes)
            flat = bank.reshape(-1, bank[0, 0].size).astype(np.int64)
            off = flat + 256 * np.arange(flat.shape[0])[:, None]
            counts = np.bincount(off.ravel(), minlength=256 * flat.shape[0])
            self._bins = np.count_nonzero(
                counts.reshape(flat.shape[0], 256), axis=1).reshape(
                    bank.shape[:2])
        return self._bins[lanes[:, 0], lanes[:, 1]]

    def counts(self, kernel: str):
        return SPEC.counts(kernel, self.cell.bench)

    @staticmethod
    def roofline_s(flops: float, nbytes: float) -> float:
        return PK.roofline_s(flops, nbytes)


def host_clocks() -> Dict[str, Optional[float]]:
    """The process's CPU seconds and the machine's stolen seconds
    (``/proc/stat``, all cores): read before and after the window, they
    say whether a slow run lacked cores or ran slowly on them."""
    out: Dict[str, Optional[float]] = {"cpu_s": time.process_time(),
                                       "steal_s": None}
    with contextlib.suppress(OSError, ValueError, IndexError):
        with open("/proc/stat") as f:
            out["steal_s"] = int(f.readline().split()[8]) / 100.0
    return out


def _answers_of(res, payload):
    """The centers and iteration counts of one request's results, as the
    results hold them, or None when they do not answer the payload (the
    window keeps these; ``_stacked`` makes arrays of them afterwards)."""
    if len(res) != len(payload) or any(
            r.labels.shape != p.shape for r, p in zip(res, payload)):
        return None
    return [r.centers for r in res], [r.n_iters for r in res]


def _stacked(centers, iters):
    return (np.stack([np.asarray(c, np.float32).reshape(-1)
                      for c in centers]), np.asarray(iters, np.int64))


def run(cell: SPEC.Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float,
        engine_hook: Optional[Callable] = None):
    """One run; returns the result line's object, its ``correct`` not yet
    decided, and the readings of the check (``check.readings``).
    ``engine_hook(engine)``, for the tests, may break the timed path
    underneath before the warm-up."""
    cfg = cell.config
    route = cfg["route"]
    on_card = device.type == "cuda"
    phases = {"start": time.perf_counter() - t_start}
    t = time.perf_counter()
    pool = TF.make_pool(cfg, cell.traffic, seed, device)
    if on_card:
        # the bank is drawn on the card: its scratch is not the program's
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    phases["pool"] = time.perf_counter() - t
    t = time.perf_counter()
    eng = build_engine(cfg, trace, device)
    phases["engine"] = time.perf_counter() - t
    t = time.perf_counter()
    if engine_hook is not None:
        engine_hook(eng)
    if trace:
        _annotate_spans(eng)
    for j in range(int(cell.traffic["warmup"])):
        eng.segment(pool.payload(pool.warmup_request(j)), method=route)
    if on_card:
        torch.cuda.synchronize(device)
    phases["warmup"] = time.perf_counter() - t
    eng.metrics.reset()
    gc.collect()

    answers = CK.Answers(route=route)
    sample = TF.Reservoir(int(cell.traffic["label_sample"]),
                          TF.rng_for(seed, 1))
    latencies: List[float] = []
    voxels = attempted = failed = 0
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    clocks0 = host_clocks()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    deadline = t0 + seconds
    with torch.profiler.record_function(TR.WINDOW):
        i = 0
        while True:
            lanes = pool.request(i)
            payload = pool.payload(lanes)
            attempted += 1
            ts = time.perf_counter()
            try:
                with torch.profiler.record_function(TR.REQUEST):
                    res = eng.segment(payload, method=route)
            except Exception as e:  # noqa: BLE001 - counted, then judged
                failed += 1
                print(f"request {i} failed: {e!r}", file=sys.stderr)
                res = None
            te = time.perf_counter()
            got = None if res is None else _answers_of(res, payload)
            if got is None:
                answers.missing += 1
            else:
                latencies.append(te - ts)
                voxels += len(payload) * pool.slice_pixels
                answers.lanes.append(lanes)
                answers.centers.append(got[0])
                answers.iters.append(got[1])
                sample.offer((lanes, res))
            i += 1
            if te >= deadline:
                break
    window_s = te - t0
    clocks1 = host_clocks()
    for j, (c, it) in enumerate(zip(answers.centers, answers.iters)):
        answers.centers[j], answers.iters[j] = _stacked(c, it)
    tr = None
    if prof is not None:
        prof.__exit__(None, None, None)
        tr = TR.Trace(TR.events_of(prof))
        del prof

    snap = eng.metrics.snapshot()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    ctx = Context(cell, route, snap, pool, answers.lanes, answers.iters, tr,
                  voxels, window_s)
    metrics: Dict[str, Dict[str, Any]] = {}
    if trace:
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        e2e = {"voxels_per_s": voxels / window_s / 1e6,
               "request_p95_ms": 1e3 * float(np.percentile(latencies, 95))
               if latencies else CK.NO_ANSWER,
               "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card
           else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out: Dict[str, Any] = {"correct": False, "attempted": attempted,
                           "failed": failed, "metrics": metrics,
                           "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        if on_card:
            dev["power_limit_w"] = PK.power_limit_w()
        out["breakdown"] = {"device_ops": TR.top(tr.seconds_by_name()),
                            "idle_gaps": TR.top(tr.idle_by_host())}
    out["setup"] = phases
    out["window"] = {"requests": len(latencies), "window_s": window_s,
                     "request_p50_ms": 1e3 * statistics.median(latencies)
                     if latencies else None,
                     "cores": len(os.sched_getaffinity(0))}
    out["window"].update({k: None if clocks0[k] is None else
                          clocks1[k] - clocks0[k] for k in clocks0})

    # the program's state goes before the reference runs on the device
    answers.sample = [(lanes, np.stack([np.asarray(r.labels) for r in res]),
                       np.stack([np.asarray(r.centers, np.float32)
                                 .reshape(-1) for r in res]))
                      for lanes, res in sample.items]
    del eng, sample, ctx, tr
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return out, CK.readings(answers, pool, cfg, device)


def finish(out: Dict[str, Any], values: Dict[str, float],
           limits: Dict[str, float]) -> Dict[str, Any]:
    """Decide ``correct`` from the readings and their limits (and no
    request failed), and put ``checks``, each number beside its limit,
    last in the result line."""
    correct, checks = CK.verdict(values, limits)
    out["correct"] = bool(correct and out["failed"] == 0)
    out["checks"] = checks
    return out
