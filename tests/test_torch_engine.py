"""The port's serving engine (``device="cpu"``: the kernels' plain
versions) against the JAX package's engine on the same phantom requests.

Labels, per-request iteration counts, cache-hit flags and the counters
``requests``, ``cache_hits``, ``batches``, ``batched_images`` and
``padded_lanes`` must be equal; centers within rtol 1e-5 / atol 1e-4.
The route-level ``fit_iters`` counter is not compared: padding lanes
solve a uniform histogram on the JAX CPU path but replay lane 0 in the
port (the JAX TPU path's choice), and the counter sums the bucket's
largest lane.
"""
import json

import numpy as np
import pytest

from repro.data import phantom
from repro.serving.fcm_engine import FCMServeEngine as JAXEngine
from repro_torch import convert
from repro_torch.configs import fcm_brainweb
from repro_torch.core import solver as TS
from repro_torch.serving import FCMServeEngine, InvalidInput, SolveFailed
from repro_torch.serving import fcm_engine as TE

RTOL, ATOL = 1e-5, 1e-4
COUNTERS = ("requests", "cache_hits", "batches", "batched_images",
            "padded_lanes")


def _slices(n, h=64, w=64, seed=0):
    return [phantom.phantom_slice(h, w, slice_pos=float(s), seed=seed + i)[0]
            for i, s in enumerate(np.linspace(0.3, 0.7, n))]


def _engines(**kw):
    cfg = fcm_brainweb.make_config().fcm
    from repro.core.fcm import FCMConfig
    jcfg = FCMConfig(n_clusters=cfg.n_clusters, m=cfg.m, eps=cfg.eps,
                     max_iters=cfg.max_iters)
    return (JAXEngine(jcfg, **kw),
            FCMServeEngine(cfg, device="cpu", **kw))


def _assert_same(jres, tres, same_ids=True):
    assert len(jres) == len(tres)
    if same_ids:
        assert [r.request_id for r in jres] == \
            [r.request_id for r in tres]
    for j, t in zip(jres, tres):
        assert t.cache_hit == j.cache_hit
        assert t.n_iters == j.n_iters
        assert t.converged == j.converged
        np.testing.assert_allclose(t.centers, np.asarray(j.centers),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(t.labels, np.asarray(j.labels))
        assert t.labels.shape == j.labels.shape


def _assert_counters(jeng, teng):
    js, ts = jeng.stats(), teng.stats()
    for k in COUNTERS:
        assert ts[k] == js[k], k


@pytest.mark.parametrize("cache_size", [0, 256])
def test_engine_matches_jax_engine(cache_size):
    imgs = _slices(11)
    jeng, teng = _engines(batch_sizes=(1, 8), cache_size=cache_size)
    _assert_same(jeng.segment(imgs), teng.segment(imgs))
    _assert_same(jeng.segment(imgs[:1]), teng.segment(imgs[:1]))
    _assert_counters(jeng, teng)
    assert teng.stats()["batches"] >= 2


def test_engine_mixed_sizes_and_int32_payloads_match_jax():
    """Mixed sizes take the histograms-only program; float payloads are
    clipped to int32 bins at ingest."""
    imgs = _slices(3) + _slices(2, 40, 56, seed=7)
    imgs.append(imgs[0].astype(np.float32))
    jeng, teng = _engines(batch_sizes=(1, 8), cache_size=0)
    _assert_same(jeng.segment(imgs), teng.segment(imgs))
    _assert_counters(jeng, teng)


def test_engine_cache_carried_across_from_jax():
    """The JAX engine's LRU, carried across as numpy, gives the port the
    same cache hits and labels on the next requests."""
    warm, nxt = _slices(6), _slices(4, seed=20)
    jeng, teng = _engines(batch_sizes=(1, 8), cache_size=256)
    jeng.segment(warm)
    entries = [(k, np.asarray(v), np.asarray(h))
               for k, (v, h) in jeng._cache.items()]
    convert.cache_from_numpy(entries, engine=teng)
    assert len(teng._cache) == len(entries)
    tres = teng.segment(nxt)
    _assert_same(jeng.segment(nxt), tres, same_ids=False)
    assert any(r.cache_hit for r in tres)
    back = convert.cache_to_numpy(teng)
    assert [k for k, _, _ in back] == list(teng._cache)


def test_engine_dedups_identical_requests_in_a_flush():
    imgs = _slices(2)
    jeng, teng = _engines(batch_sizes=(1, 8), cache_size=16)
    batch = [imgs[0], imgs[1], imgs[0]]
    _assert_same(jeng.segment(batch), teng.segment(batch))
    _assert_counters(jeng, teng)


def test_engine_stats_schema_and_reset():
    imgs = _slices(3)
    eng = FCMServeEngine(batch_sizes=(1, 8), cache_size=0, device="cpu")
    eng.segment(imgs)
    s = eng.stats()
    for k in COUNTERS + ("fit_seconds", "ingest_seconds",
                         "materialize_seconds", "fit_iters", "queue_depth",
                         "cache_entries", "method_requests",
                         "method_cache_hits", "cache_hit_rate",
                         "images_per_sec", "stage_seconds",
                         "compiled_programs", "latency", "convergence",
                         "queue_depth_by_route", "batch_occupancy"):
        assert k in s, k
    assert s["batched_images"] == 3 and s["padded_lanes"] == 5
    assert s["convergence"]["histogram"]["lanes"] == 3
    assert s["latency"]["histogram"]["count"] == 3
    json.dumps(eng.snapshot())
    trace = eng.tracer.traces()[-1]
    assert trace["name"] == "flush"
    assert [c["name"] for c in trace["children"][0]["children"]] == \
        ["gather", "launch", "scatter"]
    keys = set(s)
    eng.reset_stats()
    s2 = eng.stats()
    assert set(s2) == keys and s2["requests"] == 0 and s2["batches"] == 0


def test_engine_rejects_bad_input_without_consuming_ids():
    eng = FCMServeEngine(device="cpu")
    with pytest.raises(InvalidInput):
        eng.submit(np.array([[np.nan, 1.0]]))
    with pytest.raises(InvalidInput):
        eng.submit(np.zeros((0, 4), np.uint8))
    with pytest.raises(ValueError):
        eng.submit(_slices(1)[0], method="spatial")
    assert eng.submit(_slices(1)[0]) == 0
    with pytest.raises(ValueError):
        FCMServeEngine(batch_sizes=(), device="cpu")


def test_engine_nonfinite_lane_fails_with_solve_failed(monkeypatch):
    real = TS.flat_batched_solve

    def poisoned(*a, **k):
        v, delta, iters, total = real(*a, **k)
        v = v.clone()
        v[0] = float("nan")
        return v, delta, iters, total

    monkeypatch.setattr(TE.SV, "flat_batched_solve", poisoned)
    eng = FCMServeEngine(batch_sizes=(1, 8), cache_size=16, device="cpu")
    with pytest.raises(SolveFailed):
        eng.segment(_slices(2))
    assert len(eng._cache) == 1          # the poisoned lane is not cached


def test_program_cache_reused_and_evicted_on_reregistration():
    imgs = _slices(2)
    eng = FCMServeEngine(batch_sizes=(1, 8), cache_size=0, device="cpu")
    eng.segment(imgs)
    eng.segment(imgs)
    assert eng.stats()["compiled_programs"] == 1
    prog = next(iter(eng._programs.values()))
    TE.register_route(TE.ROUTES["histogram"])       # same spec, new gen
    assert TE.METHODS == ("histogram",)
    eng.segment(imgs)
    assert len(eng._programs) == 1
    assert next(iter(eng._programs.values())) is not prog
