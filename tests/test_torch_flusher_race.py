"""Fault (l): the background flusher never takes a synchronous caller's
requests.

The contract: every synchronous request is returned by the first
``flush()`` (or the ``segment()`` call) its caller makes after
``submit()``, whatever the flusher does. The race is made deterministic
with a spy in place of the engine's flush lock: the test holds it, as a
``drain()`` in progress would, lets the flusher block on it after an
async submit, queues synchronous requests, and releases it. The spy
serves its waiters first come first served, so the flusher's flush runs
before the caller's.

Every engine is shut down by the fixture and every wait has a timeout,
so a hang fails the test instead of stalling the run. Each request's
labels and iterations equal the JAX engine's ``segment`` on the same
seeded images (centers within rtol 1e-5 / atol 1e-4, the bar of
``tests/test_torch_engine.py``), and labels, centers and iterations are
bit-equal to the port's own synchronous ``segment``.
"""
import collections
import threading

import numpy as np
import pytest

from repro.core.fcm import FCMConfig as JAXConfig
from repro.data import phantom
from repro.serving.fcm_engine import FCMServeEngine as JAXEngine
from repro_torch.core import fcm as TF
from repro_torch.serving import FCMServeEngine

WAIT = 20.0
RTOL, ATOL = 1e-5, 1e-4
ROUTES = ["histogram", "pixel"]
N_IMGS = 6


class SpyLock:
    """A lock served first come first served that tells how many threads
    wait on it."""

    def __init__(self):
        self._cond = threading.Condition()
        self._held = False
        self._waiting = collections.deque()

    def acquire(self):
        with self._cond:
            me = object()
            self._waiting.append(me)
            self._cond.notify_all()
            self._cond.wait_for(
                lambda: not self._held and self._waiting[0] is me)
            self._waiting.popleft()
            self._held = True
            self._cond.notify_all()
            return True

    def release(self):
        with self._cond:
            self._held = False
            self._cond.notify_all()

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()

    def wait_for_waiters(self, n):
        """Block until ``n`` threads wait on the lock; False on timeout."""
        with self._cond:
            return self._cond.wait_for(lambda: len(self._waiting) >= n,
                                       WAIT)


@pytest.fixture(scope="module")
def imgs():
    return [phantom.phantom_slice(24, 24, noise=4.0 + (i % 3),
                                  seed=300 + i)[0] for i in range(N_IMGS)]


@pytest.fixture(scope="module")
def jax_ref(imgs):
    """The JAX engine's ``segment`` of every image on each route."""
    out = {}
    for route in ROUTES:
        jeng = JAXEngine(JAXConfig(max_iters=300), batch_sizes=(1, 4),
                         cache_size=0)
        try:
            out[route] = jeng.segment(imgs, method=route)
        finally:
            jeng.shutdown()
    return out


@pytest.fixture
def make_engine():
    made = []

    def make(**kw):
        kw.setdefault("max_wait_ms", 1.0)
        eng = FCMServeEngine(TF.FCMConfig(max_iters=300), batch_sizes=(1, 4),
                             cache_size=0, device="cpu", **kw)
        made.append(eng)
        return eng

    yield make
    for eng in made:
        eng.shutdown(drain=False)
        assert eng._flusher is None or not eng._flusher.is_alive()


def _spied(eng):
    spy = SpyLock()
    eng._flush_lock = spy
    return spy


def _hold(got, i, jax_ref, route):
    """Image ``i``'s result against the JAX engine's."""
    want = jax_ref[route][i]
    np.testing.assert_array_equal(got.labels, np.asarray(want.labels))
    assert got.n_iters == want.n_iters
    np.testing.assert_allclose(got.centers, np.asarray(want.centers),
                               rtol=RTOL, atol=ATOL)


def _bit_equal(got, want):
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.centers, want.centers)
    assert got.n_iters == want.n_iters and got.converged == want.converged


@pytest.mark.parametrize("route", ROUTES)
def test_flush_returns_the_callers_request(make_engine, imgs, jax_ref,
                                           route):
    """The reproduction of (l): a flusher blocked on the flush lock while
    the caller submits must leave the caller's request to its flush."""
    eng = make_engine()
    spy = _spied(eng)
    spy.acquire()                         # a drain() in progress
    try:
        fut = eng.submit_async(imgs[0], method=route)
        assert spy.wait_for_waiters(1), "the flusher never blocked"
        rid = eng.submit(imgs[1], method=route)
    finally:
        spy.release()
    _hold(fut.result(timeout=WAIT), 0, jax_ref, route)
    got = eng.flush()
    assert [r.request_id for r in got] == [rid]
    _hold(got[0], 1, jax_ref, route)
    assert eng.queue_depth == 0 and eng.stats()["pending_futures"] == 0


@pytest.mark.parametrize("route", ROUTES)
def test_segment_returns_every_image(make_engine, imgs, jax_ref, route):
    """The same race through ``segment()``: its flush queues behind the
    flusher's, and it must return every image it submitted."""
    eng = make_engine()
    spy = _spied(eng)
    out = {}

    def caller():
        try:
            out["res"] = eng.segment(imgs[1:], method=route)
        except BaseException as e:  # noqa: BLE001
            out["err"] = e

    spy.acquire()
    t = threading.Thread(target=caller)
    try:
        fut = eng.submit_async(imgs[0], method=route)
        assert spy.wait_for_waiters(1), "the flusher never blocked"
        t.start()
        assert spy.wait_for_waiters(2), "segment() never reached its flush"
    finally:
        spy.release()
    t.join(timeout=WAIT)
    assert not t.is_alive(), "segment() hung"
    assert "err" not in out, repr(out.get("err"))
    _hold(fut.result(timeout=WAIT), 0, jax_ref, route)
    assert len(out["res"]) == N_IMGS - 1
    for i, r in enumerate(out["res"], start=1):
        _hold(r, i, jax_ref, route)


def test_sync_requests_fill_no_bucket_for_the_flusher(make_engine, imgs,
                                                      jax_ref):
    """Synchronous requests that fill a bucket group neither make a flush
    due nor ride in the flusher's flush: it resolves the one future at
    its max_wait and leaves them queued for their caller."""
    eng = make_engine(max_wait_ms=60_000.0)
    rids = [eng.submit(im) for im in imgs[1:5]]      # a group of 4
    fut = eng.submit_async(imgs[0])
    with eng._lock:
        due = eng._flush_due()
    assert due is not None and due > 1.0, due
    assert not fut.done()
    with eng._cond:                        # end the window now
        eng.max_wait_ms = 1.0
        eng._cond.notify_all()
    _hold(fut.result(timeout=WAIT), 0, jax_ref, "histogram")
    with eng._lock:
        assert eng.queue_depth == 4 and eng._flush_due() is None
    got = eng.flush()
    assert [r.request_id for r in got] == rids
    for i, r in enumerate(got, start=1):
        _hold(r, i, jax_ref, "histogram")


@pytest.mark.parametrize("route", ROUTES)
def test_mixed_queues_bit_equal_to_sync_segment(make_engine, imgs, jax_ref,
                                                route):
    """Sync and async requests interleaved while the flusher runs:
    every request resolves once, through its own API, bit-equal to a
    synchronous ``segment`` of the same images and equal to the JAX
    engine's."""
    ref = make_engine().segment(imgs, method=route)
    eng = make_engine(max_wait_ms=0.5)
    futs, rids = {}, {}
    for i, im in enumerate(imgs):
        if i % 2:
            rids[i] = eng.submit(im, method=route)
        else:
            futs[i] = eng.submit_async(im, method=route)
    by_id = {r.request_id: r for r in eng.flush()}
    assert set(rids.values()) <= set(by_id)
    for i in range(N_IMGS):
        got = (by_id[rids[i]] if i in rids
               else futs[i].result(timeout=WAIT))
        _bit_equal(got, ref[i])
        _hold(got, i, jax_ref, route)
