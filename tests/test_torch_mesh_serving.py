"""The port's engine with a mesh (``FCMServeEngine(mesh=...)``,
``set_mesh``) on meshes of ``cpu`` entries: the JAX package's
``tests/_mesh_serve_runner.py`` in this process, on the histogram, pixel
and spatial routes.

A meshed engine must serve what a single-device engine serves, bit for
bit, through ``segment`` and through ``submit_async`` + ``drain``, and
again after ``set_mesh(None)`` and with a one-device mesh: a lane's
plain arithmetic does not depend on how many lanes share its launch.
Against the JAX package's single-device engine (its meshed one fails
under jax 0.9.0, a fault of the reference) labels and ``n_iters`` are
equal and centers within rtol 1e-5 / atol 1e-4.
"""
import numpy as np
import pytest
import torch

from repro.core.fcm import FCMConfig as JAXConfig
from repro.data import phantom
from repro.serving.fcm_engine import FCMServeEngine as JAXEngine
from repro_torch.core import distributed as TD
from repro_torch.core import fcm as TF
from repro_torch.serving import FCMServeEngine

RTOL, ATOL = 1e-5, 1e-4
ROUTES = ["histogram", "pixel", "spatial"]
WAIT = 60.0


def _mesh(n):
    shape = {1: (1,), 2: (2,), 4: (2, 2), 8: (8,)}[n]
    return TD.make_mesh(shape, ("data", "model")[:len(shape)],
                        devices=["cpu"] * n)


@pytest.fixture(scope="module")
def imgs():
    return [phantom.phantom_slice(32, 32, noise=4.0 + (i % 3),
                                  seed=500 + i)[0] for i in range(11)]


@pytest.fixture
def engines():
    """A single-device and a meshed CPU engine factory; every engine is
    shut down after the test."""
    made = []

    def make(mesh=None, **kw):
        eng = FCMServeEngine(TF.FCMConfig(max_iters=300), batch_sizes=(1, 8),
                             cache_size=0, device="cpu", mesh=mesh,
                             max_wait_ms=10_000.0, **kw)
        made.append(eng)
        return eng
    yield make
    for eng in made:
        eng.shutdown()


def _bit_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.centers, b.centers)
        assert a.n_iters == b.n_iters and a.converged == b.converged


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("size", [2, 4, 8])
def test_meshed_engine_bit_equal_to_single(engines, imgs, route, size):
    ref = engines().segment(imgs, method=route)
    meshed = engines(_mesh(size))
    _bit_equal(meshed.segment(imgs, method=route), ref)
    futs = [meshed.submit_async(im, method=route) for im in imgs]
    meshed.drain()
    _bit_equal([f.result(timeout=WAIT) for f in futs], ref)
    meshed.set_mesh(None)
    _bit_equal(meshed.segment(imgs, method=route), ref)
    meshed.set_mesh(_mesh(1))
    _bit_equal(meshed.segment(imgs, method=route), ref)


@pytest.mark.parametrize("route", ROUTES)
def test_meshed_engine_matches_jax_engine(engines, imgs, route):
    jeng = JAXEngine(JAXConfig(max_iters=300), batch_sizes=(1, 8),
                     cache_size=0)
    try:
        want = jeng.segment(imgs, method=route)
    finally:
        jeng.shutdown()
    got = engines(_mesh(8)).segment(imgs, method=route)
    for t, j in zip(got, want):
        np.testing.assert_array_equal(t.labels, np.asarray(j.labels))
        assert t.n_iters == j.n_iters
        np.testing.assert_allclose(t.centers, np.asarray(j.centers),
                                   rtol=RTOL, atol=ATOL)


def test_mesh_dispatch_by_bucket(engines, imgs):
    """A bucket the mesh divides stages one shard a device; a bucket of
    1, or one the mesh size does not divide, is the single-device
    program; no mesh or a one-device mesh shards nothing."""
    eng = engines(_mesh(4))
    assert eng._mesh_for_bucket(8) is eng.mesh
    assert eng._mesh_for_bucket(1) is None
    assert eng._mesh_for_bucket(6) is None
    eng.segment(imgs[:9])                   # a bucket of 8, one of 1
    progs = {k[3]: p for k, p in eng._programs.items()}
    assert set(progs) == {1, 8}
    staged8 = progs[8].gather(eng, [_pending(eng, im) for im in imgs[:8]], 8)
    staged1 = progs[1].gather(eng, [_pending(eng, imgs[0])], 1)
    assert [t.shape[0] for t in staged8] == [2, 2, 2, 2]
    assert len(staged1) == 1 and staged1[0].shape[0] == 1
    eng.set_mesh(_mesh(1))
    assert eng._mesh_for_bucket(8) is None
    eng.set_mesh(None)
    assert eng._mesh_for_bucket(8) is None


def _pending(eng, img):
    from repro_torch.serving import fcm_engine as TE
    return TE._ingest_histogram(eng, img, 0)


def test_set_mesh_purges_programs_and_keeps_stats_keys(engines, imgs):
    eng = engines(_mesh(2))
    eng.segment(imgs[:8])
    assert eng.stats()["compiled_programs"] == 1
    gen = eng._mesh_gen
    eng.set_mesh(_mesh(4))
    assert eng._mesh_gen == gen + 1
    eng.segment(imgs[:8])
    assert eng.stats()["compiled_programs"] == 1
    assert all(k[2] == eng._mesh_gen for k in eng._programs)
    assert set(eng.stats()) == set(engines().stats())
    assert set(eng.snapshot()) == {"stats", "metrics", "traces"}


def test_set_mesh_rejects_another_device_type(engines):
    eng = engines()
    cards = TD.Mesh((torch.device("cuda", 0),) * 2, (2,), ("data",))
    with pytest.raises(ValueError, match="cpu devices only"):
        eng.set_mesh(cards)
    with pytest.raises(ValueError, match="cpu devices only"):
        engines(cards)
