"""The port's deprecated ``fit_*`` adapters and ``kernels/ref.py``
against the JAX package's, on the same seeded inputs (``device="cpu"``:
the plain versions).

Both sides must warn with a ``DeprecationWarning`` pointing at the
caller; ``fit_batched_sharded`` warns on neither. Centers agree within
rtol 1e-5 / atol 1e-4 (the same float32 math, summed in other orders),
``n_iters`` and labels equal.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batched as JB
from repro.core import fcm as JF
from repro.core import histogram as JH
from repro.core import spatial as JSP
from repro.core import vector_fcm as JV
from repro.data import phantom
from repro.kernels import ref as JR
from repro_torch.core import batched as TB
from repro_torch.core import distributed as TD
from repro_torch.core import fcm as TF
from repro_torch.core import histogram as TH
from repro_torch.core import spatial as TSP
from repro_torch.core import vector_fcm as TV
from repro_torch.kernels import ref as TR

RTOL, ATOL = 1e-5, 1e-4


def _img(h=40, w=48, seed=3):
    return phantom.phantom_slice(h, w, seed=seed)[0]


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def _both(jfn, tfn, name):
    """Run the JAX adapter and the port's; each must warn once, naming
    itself, at this file (the adapter's caller)."""
    with pytest.warns(DeprecationWarning, match=f"{name} is deprecated") \
            as jw:
        j = jfn()
    with pytest.warns(DeprecationWarning, match=f"{name} is deprecated") \
            as tw:
        t = tfn()
    for rec in (jw, tw):
        assert [w.filename for w in rec] == [__file__]
    return j, t


def _same_fit(j, t):
    _close(t.centers, j.centers)
    assert t.n_iters == int(j.n_iters)
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels))


def test_fit_baseline_matches_jax():
    x = _img().ravel().astype(np.float32)
    rng = np.random.default_rng(0)
    u0 = rng.uniform(1e-3, 1.0, (4, x.size)).astype(np.float32)
    u0 /= u0.sum(axis=0, keepdims=True)
    cfg_j, cfg_t = JF.FCMConfig(), TF.FCMConfig()
    j, t = _both(lambda: JF.fit_baseline(x, cfg_j, u0=jnp.asarray(u0)),
                 lambda: TF.fit_baseline(x, cfg_t, u0=u0, device="cpu"),
                 "fit_baseline")
    _same_fit(j, t)
    _close(t.membership, j.membership, atol=1e-6)


@pytest.mark.parametrize("v0", [None, [10.0, 60.0, 120.0, 200.0]])
@pytest.mark.parametrize("keep", [False, True])
def test_fit_fused_matches_jax(v0, keep):
    x = _img().ravel().astype(np.float32)
    jv0 = None if v0 is None else jnp.asarray(v0, jnp.float32)
    j, t = _both(lambda: JF.fit_fused(x, JF.FCMConfig(), v0=jv0,
                                      keep_membership=keep),
                 lambda: TF.fit_fused(x, TF.FCMConfig(), v0=v0,
                                      keep_membership=keep, device="cpu"),
                 "fit_fused")
    _same_fit(j, t)
    assert (t.membership is None) == (not keep)
    if keep:
        _close(t.membership, j.membership, atol=1e-6)


@pytest.mark.parametrize("m", [2.0, 2.5])
def test_fused_center_step_matches_jax(m):
    x = _img().ravel().astype(np.float32)
    v = np.asarray([5.0, 50.0, 100.0, 170.0], np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        j = JF.fused_center_step(jnp.asarray(x), jnp.asarray(v), m)
        t = TF.fused_center_step(torch.from_numpy(x), torch.from_numpy(v), m)
    _close(t, j)


@pytest.mark.parametrize("given_hist", [False, True])
def test_fit_histogram_matches_jax(given_hist):
    img = _img(seed=5)
    x = img.ravel().astype(np.float32)
    hist = (np.bincount(img.ravel().astype(np.int64), minlength=256)[:256]
            .astype(np.float32) if given_hist else None)
    j, t = _both(lambda: JH.fit_histogram(
                     x, JF.FCMConfig(),
                     hist=None if hist is None else jnp.asarray(hist)),
                 lambda: TH.fit_histogram(x, TF.FCMConfig(), hist=hist,
                                          device="cpu"),
                 "fit_histogram")
    _same_fit(j, t)


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["reference", "kernels"])
@pytest.mark.parametrize("grid", ["2d", "3d"])
def test_fit_spatial_matches_jax(use_pallas, grid):
    if grid == "2d":
        img = phantom.noisy_phantom_slice(24, 20, seed=2)[0]
    else:
        img = phantom.noisy_phantom_volume(3, 12, 10, seed=2)[0]
    img = img.astype(np.float32)
    j, t = _both(lambda: JSP.fit_spatial(img, JSP.SpatialFCMConfig(),
                                         use_pallas=use_pallas),
                 lambda: TSP.fit_spatial(img, TSP.SpatialFCMConfig(),
                                         use_pallas=use_pallas,
                                         device="cpu"),
                 "fit_spatial")
    _close(t.centers, j.centers)
    assert t.n_iters == int(j.n_iters)
    assert tuple(t.labels.shape) == img.shape
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels))


def test_fit_spatial_rejects_flat_input():
    with pytest.warns(DeprecationWarning), \
            pytest.raises(ValueError, match=r"\(H, W\) or \(D, H, W\)"):
        TSP.fit_spatial(np.zeros(16, np.float32), device="cpu")


def _blob_rows(k=90, d=3, seed=0):
    rng = np.random.default_rng(seed)
    means = rng.uniform(0, 200, (4, d))
    feats = (means[rng.integers(0, 4, k)]
             + rng.normal(0, 4, (k, d))).astype(np.float32)
    weights = rng.integers(1, 20, k).astype(np.float32)
    return feats, weights


@pytest.mark.parametrize("weighted", [False, True])
def test_fit_vector_fcm_matches_jax(weighted):
    feats, w = _blob_rows()
    w = w if weighted else None
    j, t = _both(lambda: JV.fit_vector_fcm(feats, w, JF.FCMConfig()),
                 lambda: TV.fit_vector_fcm(feats, w, TF.FCMConfig(),
                                           device="cpu"),
                 "fit_vector_fcm")
    _same_fit(j, t)


def test_fit_vector_batched_matches_jax():
    rows = [_blob_rows(seed=s) for s in range(3)]
    feats = np.stack([f for f, _ in rows])
    ws = np.stack([w for _, w in rows])
    j, t = _both(lambda: JV.fit_vector_batched(feats, ws, JF.FCMConfig()),
                 lambda: TV.fit_vector_batched(feats, ws, TF.FCMConfig(),
                                               device="cpu"),
                 "fit_vector_batched")
    _close(t.centers, j.centers)
    np.testing.assert_array_equal(t.n_iters, np.asarray(j.n_iters))


def _slices():
    return [phantom.phantom_slice(24 + 4 * (z % 3), 32,
                                  slice_pos=0.3 + 0.05 * z, seed=z)[0]
            for z in range(5)]


@pytest.mark.parametrize("given", ["images", "hists"])
def test_fit_batched_matches_jax(given):
    imgs = _slices()
    arg = (imgs if given == "images" else
           np.stack([np.bincount(im.ravel().astype(np.int64),
                                 minlength=256)[:256]
                     for im in imgs]).astype(np.float32))
    j, t = _both(lambda: JB.fit_batched(arg, JF.FCMConfig()),
                 lambda: TB.fit_batched(arg, TF.FCMConfig(), device="cpu"),
                 "fit_batched")
    _close(t.centers, j.centers)
    np.testing.assert_array_equal(t.n_iters, np.asarray(j.n_iters))
    assert t.total_iters == j.total_iters
    if given == "images":
        for tl, jl, im in zip(t.labels, j.labels, imgs):
            assert tl.shape == im.shape
            np.testing.assert_array_equal(tl, np.asarray(jl))
    else:
        assert t.labels is None and j.labels is None


def test_fit_batched_pixels_matches_jax():
    xs = np.stack([phantom.phantom_slice(20, 24, slice_pos=p, seed=s)[0]
                   for s, p in enumerate((0.35, 0.5, 0.65))]).astype(
        np.float32)
    j, t = _both(lambda: JB.fit_batched_pixels(xs, JF.FCMConfig()),
                 lambda: TB.fit_batched_pixels(xs, TF.FCMConfig(),
                                               device="cpu"),
                 "fit_batched_pixels")
    _close(t.centers, j.centers)
    np.testing.assert_array_equal(t.n_iters, np.asarray(j.n_iters))
    for tl, jl in zip(t.labels, j.labels):
        np.testing.assert_array_equal(tl, np.asarray(jl))


def test_fit_batched_sharded_does_not_warn():
    hists = np.stack([np.bincount(im.ravel().astype(np.int64),
                                  minlength=256)[:256]
                      for im in _slices()]).astype(np.float32)
    mesh = TD.make_mesh((2,), ("data",), devices=["cpu", "cpu"])
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        res = TB.fit_batched_sharded(hists, mesh, TF.FCMConfig())
    assert res.centers.shape == (5, 4)


# -- kernels/ref.py --------------------------------------------------------------

def _ref_inputs(n=1537, c=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 255, n).astype(np.float32)
    v = np.sort(rng.uniform(0, 255, c)).astype(np.float32)
    u = rng.uniform(0.01, 1, (c, n)).astype(np.float32)
    u /= u.sum(axis=0, keepdims=True)
    w = (rng.uniform(size=n) > 0.3).astype(np.float32)
    return x, v, u, w


@pytest.mark.parametrize("m", [2.0, 2.5])
@pytest.mark.parametrize("name,weighted", [
    ("membership_ref", False),
    *((name, weighted) for name in ("center_partials_ref",
                                    "fused_partials_ref", "fused_step_ref")
      for weighted in (False, True))])
def test_ref_oracles_match_jax(name, m, weighted):
    x, v, u, w = _ref_inputs()
    if name == "membership_ref":
        args = (x, v, m)
    elif name == "center_partials_ref":
        args = (x, u, m, w if weighted else None)
    else:
        args = (x, v, m, w if weighted else None)
    j = getattr(JR, name)(*args)
    t = getattr(TR, name)(*args)
    for tt, jj in zip(t if isinstance(t, tuple) else (t,),
                      j if isinstance(j, tuple) else (j,)):
        _close(tt, jj, atol=1e-4 if name != "membership_ref" else 1e-6)


def test_selective_scan_ref_matches_jax():
    rng = np.random.default_rng(7)
    b, s, di, ds = 1, 16, 8, 4
    u = rng.normal(size=(b, s, di)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (b, s, di)).astype(np.float32)
    bm = rng.normal(size=(b, s, ds)).astype(np.float32)
    cm = rng.normal(size=(b, s, ds)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, (di, ds)).astype(np.float32)
    j = JR.selective_scan_ref(*(jnp.asarray(t) for t in (u, dt, bm, cm, a)))
    t = TR.selective_scan_ref(*(torch.from_numpy(t)
                                for t in (u, dt, bm, cm, a)))
    _close(t, j, rtol=1e-5, atol=1e-5)
