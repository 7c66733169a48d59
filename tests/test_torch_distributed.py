"""The port's multi-device FCM (``repro_torch.core.distributed`` and the
batch-sharded fit of ``repro_torch.core.batched``) on meshes of ``cpu``
entries, against the JAX package's functions and the port's own
single-device solves.

Pixel-sharded fits sum each cluster's partials shard by shard, another
order than one device's, so their centers are held within rtol 1e-5 /
atol 1e-4, ``n_iters`` equal and labels equal up to near-ties checked in
float64. The batch-sharded fit changes no lane's arithmetic and is held
bit for bit to the port's ``solve_batched``. The JAX package's own
``fit_sharded`` runs here on a one-device mesh in this process; its
batch-sharded fit fails under jax 0.9.0 (a ``shard_map`` carry fault of
the reference), so the port's is held to JAX's single-device
``solve_batched`` instead.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import distributed as JD
from repro.core import fcm as JF
from repro.core import solver as JS
from repro.data import phantom
from repro_torch.core import batched as TB
from repro_torch.core import distributed as TD
from repro_torch.core import fcm as TF
from repro_torch.core import solver as TS

RTOL, ATOL = 1e-5, 1e-4
CFG = dict(max_iters=300)
SHAPES = {1: (1,), 2: (2,), 3: (3,), 8: (4, 2)}


def _cpu_mesh(n):
    shape = SHAPES[n]
    return TD.make_mesh(shape, ("data", "model")[:len(shape)],
                        devices=["cpu"] * n)


@pytest.fixture(scope="module")
def images():
    """A 96x96 phantom, and the reference runner's odd N = 50021 cut
    from a 224x224 one (the padding path on every mesh but one)."""
    small = phantom.phantom_slice(96, 96, seed=11)[0]
    big = phantom.phantom_slice(224, 224, seed=11)[0]
    return {"96x96": small.ravel().astype(np.float32),
            "odd-50021": big.ravel().astype(np.float32)[:50021]}


@pytest.fixture(scope="module")
def single(images):
    """The port's single-device reference solve of each image."""
    return {k: TS.solve(TS.pixel_problem(x, device="cpu"),
                        backend="reference", **CFG)
            for k, x in images.items()}


@pytest.fixture(scope="module")
def jax_sharded(images):
    """The JAX package's fit_sharded on a one-device mesh, both forms."""
    kw = ({"axis_types": (jax.sharding.AxisType.Auto,)}
          if hasattr(jax.sharding, "AxisType") else {})
    mesh = jax.make_mesh((1,), ("data",), **kw)
    return {(k, h): JD.fit_sharded(x, mesh, JF.FCMConfig(**CFG),
                                   histogram=h)
            for k, x in images.items() for h in (False, True)}


def _assert_labels_or_near_ties(got, want, x, centers):
    """Labels equal, or near-ties: the two labels' centers, in float64,
    about equally far from the pixel at these centers' tolerance."""
    diff = np.nonzero(got != want)[0]
    if diff.size == 0:
        return
    v = np.asarray(centers, np.float64)
    xd = x[diff].astype(np.float64)
    gap = np.abs(np.abs(xd - v[got[diff]]) - np.abs(xd - v[want[diff]]))
    slack = 2 * (ATOL + RTOL * np.abs(v).max())
    assert (gap <= slack).all(), (diff[:10], gap.max())
    assert diff.size <= 1e-3 * x.size, diff.size


def _assert_fit(got, want, x):
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(want.centers),
                               rtol=RTOL, atol=ATOL)
    assert got.n_iters == int(want.n_iters)
    assert got.labels.shape == (x.size,)
    _assert_labels_or_near_ties(got.labels.numpy(), np.asarray(want.labels),
                                x, got.centers.numpy())


# -- pieces ------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 7, 8, 50021])
@pytest.mark.parametrize("n_devices", [1, 3, 8])
def test_pad_to_devices_matches_jax(n, n_devices):
    x = np.random.default_rng(n).uniform(0, 255, n).astype(np.float32)
    jx, jw = JD.pad_to_devices(x, n_devices)
    tx, tw = TD.pad_to_devices(x, n_devices, device="cpu")
    assert tx.shape[0] % n_devices == 0
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


@pytest.mark.parametrize("c,m", [(2, 2.0), (4, 2.0), (7, 2.5)])
def test_masked_center_step_matches_jax(c, m):
    rng = np.random.default_rng(c)
    x = rng.uniform(0, 255, 3001).astype(np.float32)
    w = (rng.uniform(size=3001) > 0.2).astype(np.float32)
    v = np.sort(rng.uniform(0, 255, c)).astype(np.float32)
    jn, jd = JD.masked_center_step(x, w, v, m)
    tn, td = TD.masked_center_step(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(v), m)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL,
                               atol=ATOL)


def test_shard_map_splits_in_mesh_order():
    mesh = _cpu_mesh(8)
    x = torch.arange(16.0)
    parts = TD.shard_map(lambda a, b: (a + b, a.device), mesh=mesh)(x, 2 * x)
    assert [p[1] for p in parts] == list(mesh.devices)
    assert torch.equal(torch.cat([p[0] for p in parts]), 3 * x)
    with pytest.raises(ValueError, match="equal shards"):
        TD.shard_map(lambda a: a, mesh=mesh)(torch.arange(12.0))


# -- the pixel-sharded fit -----------------------------------------------------

@pytest.mark.parametrize("image", ["96x96", "odd-50021"])
@pytest.mark.parametrize("n_devices", [1, 2, 8])
@pytest.mark.parametrize("histogram", [False, True],
                         ids=["pixels", "histogram"])
def test_fit_sharded_matches_single_device_and_jax(images, single,
                                                   jax_sharded, image,
                                                   n_devices, histogram):
    x = images[image]
    got = TD.fit_sharded(x, _cpu_mesh(n_devices), TF.FCMConfig(**CFG),
                         histogram=histogram)
    _assert_fit(got, single[image], x)
    _assert_fit(got, jax_sharded[(image, histogram)], x)


def test_build_sharded_fit_returns_padded_labels(images):
    mesh = _cpu_mesh(8)
    xp, w = TD.pad_to_devices(images["odd-50021"], mesh.size, device="cpu")
    v, labels, delta, it = TD.build_sharded_fit(
        mesh, TF.FCMConfig(**CFG))(xp, w)
    assert labels.shape == xp.shape and v.shape == (4,)
    x = images["odd-50021"]
    assert float(delta) < 5e-3 * float(x.max() - x.min()) * 0.1
    assert 0 < it < 300


def test_sharded_histogram_fit_takes_a_validity_mask_only(images):
    mesh = _cpu_mesh(2)
    xp, w = TD.pad_to_devices(images["96x96"], mesh.size, device="cpu")
    with pytest.raises(ValueError, match="0/1 validity mask"):
        TD.build_sharded_histogram_fit(mesh)(xp, 2 * w)


# -- the batch-sharded fit -----------------------------------------------------

@pytest.fixture(scope="module")
def hists():
    """The reference runner's ten phantom slices of three sizes."""
    imgs = [phantom.phantom_slice(64 + 8 * (z % 3), 96,
                                  slice_pos=0.3 + 0.04 * z, seed=z)[0]
            for z in range(10)]
    return np.stack([np.bincount(im.ravel().astype(np.int64),
                                 minlength=256)[:256]
                     for im in imgs]).astype(np.float32)


@pytest.mark.parametrize("n_devices", [1, 3, 8])
def test_fit_batched_sharded_bit_equal_to_solve_batched(hists, n_devices):
    cfg = TF.FCMConfig(**CFG)
    got = TB.fit_batched_sharded(hists, _cpu_mesh(n_devices), cfg)
    h = torch.from_numpy(hists)
    want = TS.solve_batched(TS.batch_problems(TB.hist_rows(h), h,
                                              device="cpu"), cfg)
    assert got.centers.shape == (10, 4)
    assert torch.equal(got.centers, want.centers)
    np.testing.assert_array_equal(got.n_iters, want.n_iters)
    np.testing.assert_array_equal(got.final_delta, want.final_delta)
    assert got.total_iters == want.total_iters


def test_fit_batched_sharded_matches_jax_single_device(hists):
    got = TB.fit_batched_sharded(hists, _cpu_mesh(8), TF.FCMConfig(**CFG))
    jh = jax.numpy.asarray(hists)
    vals = jax.numpy.broadcast_to(jax.numpy.arange(256.0), jh.shape)
    want = JS.solve_batched(JS.batch_problems(vals, jh,
                                              cfg=JF.FCMConfig(**CFG)),
                            JF.FCMConfig(**CFG))
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(want.centers),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.n_iters, np.asarray(want.n_iters))


def test_build_sharded_batched_fit_is_cached():
    mesh, cfg = _cpu_mesh(2), TF.FCMConfig(**CFG)
    assert (TB.build_sharded_batched_fit(mesh, cfg)
            is TB.build_sharded_batched_fit(_cpu_mesh(2), cfg))


# -- meshes --------------------------------------------------------------------

def test_mesh_names_its_devices():
    mesh = _cpu_mesh(8)
    assert mesh.size == 8 and mesh.shape == (4, 2)
    assert TD.mesh_axes(mesh) == ("data", "model")
    assert mesh.lead == torch.device("cpu")
    assert hash(mesh) == hash(_cpu_mesh(8))


@pytest.mark.parametrize("shape,axes,devices,match", [
    ((2,), ("data",), None, "needs 2 cards"),
    ((4, 2), ("data", "model"), ["cpu"] * 4, "holds 8 devices"),
    ((2, 2), ("data",), ["cpu"] * 4, "one positive size per axis"),
    ((0,), ("data",), [], "one positive size per axis"),
], ids=["too-few-cards", "shape-vs-devices", "axis-names", "empty"])
def test_make_mesh_errors(monkeypatch, shape, axes, devices, match):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=match):
        TD.make_mesh(shape, axes, devices=devices)
