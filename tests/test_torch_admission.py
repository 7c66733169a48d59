"""The port's async admission on the CPU: futures, deadlines, the
batch-formation policy and shutdown, each case of the JAX package's
``tests/test_admission.py`` on ``device="cpu"``, and the async front door
bit-equal to the synchronous one (the same programs, the same math).
Every engine is shut down by the fixture, so no flusher thread outlives
its test; every ``result()`` has a timeout."""
import sys
import threading
import time

import numpy as np
import pytest

from repro_torch.core import fcm as F
from repro_torch.core import solver as TS
from repro_torch.data import phantom
from repro_torch.serving import fcm_engine as TE
from repro_torch.serving.admission import (DeadlineExceeded, EngineShutdown,
                                           SegmentationFuture)

CFG = F.FCMConfig(max_iters=300)
WAIT = 30.0


def _imgs(n, size=20):
    return [phantom.phantom_slice(size, size, noise=4.0 + (i % 3),
                                  seed=100 + i)[0] for i in range(n)]


@pytest.fixture
def make_engine():
    made = []

    def make(**kw):
        kw.setdefault("cache_size", 0)
        kw.setdefault("batch_sizes", (1, 4))
        eng = TE.FCMServeEngine(CFG, device="cpu", **kw)
        made.append(eng)
        return eng

    yield make
    for eng in made:
        eng.shutdown(drain=False)
        assert eng._flusher is None or not eng._flusher.is_alive()


# -- SegmentationFuture ------------------------------------------------------

def test_future_resolves_exactly_once():
    fut = SegmentationFuture(0, "histogram")
    assert not fut.done() and fut.latency_s is None
    fut.set_result("r")
    assert fut.done() and fut.result() == "r"
    assert fut.latency_s is not None and fut.latency_s >= 0
    with pytest.raises(RuntimeError, match="resolved twice"):
        fut.set_result("again")
    with pytest.raises(RuntimeError, match="resolved twice"):
        fut.set_exception(ValueError("nope"))


def test_future_timeout_and_exception():
    fut = SegmentationFuture(1, "histogram")
    with pytest.raises(TimeoutError):
        fut.result(timeout=0.01)
    fut.set_exception(ValueError("boom"))
    with pytest.raises(ValueError, match="boom"):
        fut.result(timeout=WAIT)
    assert isinstance(fut.exception(), ValueError)


# -- drain / parity ----------------------------------------------------------

def test_zero_request_drain_is_noop(make_engine):
    eng = make_engine()
    assert eng.drain() == []
    assert eng.drain() == []          # repeatable


@pytest.mark.parametrize("method", ["histogram", "pixel"])
def test_async_bitwise_identical_to_sync(make_engine, method):
    imgs = _imgs(6)
    sync_eng = make_engine()
    for im in imgs:
        sync_eng.submit(im, method=method)
    sync_res = {r.request_id: r for r in sync_eng.flush()}

    async_eng = make_engine(max_wait_ms=10_000.0)   # only drain() flushes
    futs = [async_eng.submit_async(im, method=method) for im in imgs]
    async_eng.drain()
    for i, fut in enumerate(futs):
        a, s = fut.result(timeout=WAIT), sync_res[i]
        assert (a.labels == s.labels).all()
        np.testing.assert_array_equal(a.centers, s.centers)
        assert a.n_iters == s.n_iters and a.converged == s.converged


def test_exactly_once_with_duplicates_and_cache_hits(make_engine):
    # Duplicates dedup within a flush and hit the LRU across flushes;
    # every future still resolves exactly once, with the
    # representative's centers.
    eng = make_engine(cache_size=64, max_wait_ms=10_000.0)
    img = _imgs(1)[0]
    futs = [eng.submit_async(img) for _ in range(3)]
    eng.drain()
    first = [f.result(timeout=WAIT) for f in futs]
    assert all(f.done() for f in futs)
    fut2 = eng.submit_async(img.copy())
    eng.drain()
    again = fut2.result(timeout=WAIT)
    assert again.cache_hit
    np.testing.assert_array_equal(again.centers, first[0].centers)
    assert (again.labels == first[0].labels).all()


# -- deadlines ---------------------------------------------------------------

def test_expired_deadline_at_submit_consumes_nothing(make_engine):
    eng = make_engine()
    before = eng._next_id
    fut = eng.submit_async(_imgs(1)[0], deadline=0.0)
    assert fut.done()
    with pytest.raises(DeadlineExceeded):
        fut.result(timeout=WAIT)
    assert eng._next_id == before             # no id, no queue slot
    assert eng.drain() == []
    assert eng._route_counter("deadline_expired", "histogram").value == 1


def test_deadline_expired_while_queued(make_engine):
    eng = make_engine(max_wait_ms=10_000.0)
    imgs = _imgs(2)
    doomed = eng.submit_async(imgs[0], deadline=0.005)
    ok = eng.submit_async(imgs[1])
    time.sleep(0.02)
    eng.drain()
    with pytest.raises(DeadlineExceeded):
        doomed.result(timeout=WAIT)
    res = ok.result(timeout=WAIT)             # batchmate unaffected
    assert res.labels.shape == imgs[1].shape
    assert eng.stats()["deadline_expired"]["histogram"] == 1


def test_deadline_ordering_most_urgent_first(make_engine):
    eng = make_engine(max_wait_ms=10_000.0)
    imgs = _imgs(3)
    loose = eng.submit_async(imgs[0], deadline=60.0)
    none = eng.submit_async(imgs[1])
    tight = eng.submit_async(imgs[2], deadline=5.0)
    with eng._lock:
        pend = list(eng._queues["histogram"])
    ordered = eng._admit_order(TE.ROUTES["histogram"], pend)
    assert [p.request_id for p in ordered] == [
        tight.request_id, loose.request_id, none.request_id]
    eng.drain()
    for f in (loose, none, tight):
        assert f.result(timeout=WAIT).labels.shape == imgs[0].shape


# -- background flusher ------------------------------------------------------

def test_flusher_is_lazy_and_sync_api_never_starts_it(make_engine):
    eng = make_engine()
    eng.submit(_imgs(1)[0])
    eng.flush()
    assert eng._flusher is None
    eng.submit_async(_imgs(1)[0])
    assert eng._flusher is not None and eng._flusher.is_alive()


def test_max_wait_flush_without_explicit_drain(make_engine):
    eng = make_engine(max_wait_ms=20.0)
    fut = eng.submit_async(_imgs(1)[0])
    res = fut.result(timeout=WAIT)            # background flusher only
    assert res.labels.shape == (20, 20)
    assert fut.latency_s >= 0.015             # waited out the window


def test_target_shape_triggers_before_window(make_engine):
    eng = make_engine(batch_sizes=(1, 2), max_wait_ms=60_000.0)
    imgs = _imgs(2)
    futs = [eng.submit_async(im) for im in imgs]
    for f in futs:
        assert f.result(timeout=WAIT).labels.shape == imgs[0].shape
    assert max(f.latency_s for f in futs) < WAIT


def test_concurrent_submitters_all_resolve(make_engine):
    eng = make_engine(batch_sizes=(1, 8), max_wait_ms=15.0)
    imgs = _imgs(12)
    out = {}

    def worker(i):
        out[i] = eng.submit_async(imgs[i]).result(timeout=WAIT)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(imgs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=2 * WAIT)
    assert sorted(out) == list(range(12))
    for i, r in out.items():
        assert r.labels.shape == imgs[i].shape


def test_submitter_stress_every_request_once(make_engine):
    """More submitter threads than cores, a short switch interval: every
    request gets its own id, is counted once and resolves once, and the
    queue ends empty (a lost update in the admission path breaks one of
    these)."""
    eng = make_engine(batch_sizes=(1, 4), max_wait_ms=1.0)
    imgs = _imgs(4, size=12)
    futs, lock = [], threading.Lock()

    def worker(t):
        for i in range(6):
            f = eng.submit_async(imgs[(t + i) % 4])
            with lock:
                futs.append(f)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        assert not any(t.is_alive() for t in threads)
        results = [f.result(timeout=WAIT) for f in futs]
    finally:
        sys.setswitchinterval(old)
    assert len(futs) == 96
    assert sorted(r.request_id for r in results) == list(range(96))
    # a future resolves before its bucket's counters move: drain waits
    # for the flusher's last flush body to end
    eng.drain()
    st = eng.stats()
    assert st["requests"] == 96 and st["batched_images"] == 96
    assert st["queue_depth"] == 0 and st["pending_futures"] == 0


def test_flusher_runs_each_flush_on_the_engines_card(make_engine,
                                                     monkeypatch):
    """A new thread's current CUDA device is device 0: the flusher enters
    the engine's card around every flush."""
    entered = []

    class _Device:
        def __init__(self, index):
            self.index = index

        def __enter__(self):
            entered.append((self.index, threading.current_thread().name))

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(TE.torch.cuda, "device", _Device)
    eng = make_engine(max_wait_ms=5.0)
    eng._cuda_index = 1
    assert eng.submit_async(_imgs(1)[0]).result(timeout=WAIT) is not None
    assert entered and all(e == (1, "fcm-serve-flusher") for e in entered)


# -- shutdown ----------------------------------------------------------------

def test_shutdown_drains_in_flight_futures(make_engine):
    eng = make_engine(max_wait_ms=10_000.0)
    futs = [eng.submit_async(im) for im in _imgs(3)]
    eng.shutdown()                            # drain=True default
    for f in futs:
        assert f.result(timeout=WAIT).labels.shape == (20, 20)
    with pytest.raises(EngineShutdown):
        eng.submit_async(_imgs(1)[0])
    with pytest.raises(EngineShutdown):
        eng.submit(_imgs(1)[0])
    eng.shutdown()                            # idempotent
    assert not eng.healthy()


def test_concurrent_shutdown_and_erroring_route_exactly_once(make_engine,
                                                             monkeypatch):
    # A route whose solve raises, racing shutdown(drain=True): every
    # future resolves exactly once (the typed error or EngineShutdown),
    # no "resolved twice" escapes either resolver, none stays pending.
    from repro_torch import faults as TFI

    plan = TFI.FaultPlan(seed=0, specs=(
        TFI.FaultSpec(site="launch", kind="error", times=None),))
    eng = make_engine(faults=plan, retries=0, breaker_threshold=10**9,
                      max_wait_ms=10_000.0)
    futs = [eng.submit_async(im) for im in _imgs(4)]

    def boom(*a, **k):
        raise ValueError("solver exploded")

    monkeypatch.setattr(TS, "solve_batched", boom)   # degraded path too
    errs = []

    def flusher():
        try:
            eng.flush(raise_errors=False)
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    t = threading.Thread(target=flusher)
    t.start()
    eng.shutdown(drain=True)
    t.join(timeout=WAIT)
    assert errs == []
    for f in futs:
        assert f.done()
        assert isinstance(f.exception(), (ValueError, EngineShutdown))
    assert eng.stats()["pending_futures"] == 0


def test_shutdown_drop_fails_queued_futures(make_engine):
    eng = make_engine(max_wait_ms=10_000.0)
    futs = [eng.submit_async(im) for im in _imgs(2)]
    eng.shutdown(drain=False)
    for f in futs:
        with pytest.raises(EngineShutdown):
            f.result(timeout=WAIT)
    assert eng.closed
    assert eng.metrics.gauge("queue.depth").value == 0
