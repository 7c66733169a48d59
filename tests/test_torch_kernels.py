"""The port's kernel modules against the JAX package's Pallas kernels.

Each Pallas kernel runs here as the JAX package's own tests run it on
the CPU (``interpret=True``); the port's wrappers take their plain
PyTorch versions for CPU tensors. The same numpy inputs, made from a
seed, go through both. Binning and labels must agree exactly; the
whole-solve's centers within rtol 1e-5 / atol 1e-4 (values run 0-255 and
the background center sits near 0, where rtol alone means nothing; the
two sum the rows in different orders) with equal iteration counts.

The CUDA kernels themselves are held against these plain versions on
the card by ``chip_smoke.py`` and by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import phantom
from repro.kernels import defuzzify as JKD
from repro.kernels import fcm_resident as JKR
from repro.kernels import ops as jops
from repro_torch.core import solver as TS
from repro_torch.kernels import defuzzify as KD
from repro_torch.kernels import fcm_resident as KR
from repro_torch.kernels import histogram_bin as KB
from repro_torch.kernels import ops as tops

RTOL, ATOL = 1e-5, 1e-4
CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# Binning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,n", [(1, 1), (1, 1023), (2, 1025), (3, 3001),
                                 (1, 4096)])
def test_binning_plain_matches_pallas_exactly(b, n):
    """Ragged N, including N not a multiple of 1024 (the Pallas tile)."""
    rng = np.random.default_rng(n)
    px = rng.integers(0, 256, (b, n)).astype(np.uint8)
    want = np.asarray(jops.histogram_counts(jnp.asarray(px), interpret=True))
    got = KB.histogram_bin(torch.from_numpy(px), 256)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_binning_clamps_int32_like_the_reference_step():
    rng = np.random.default_rng(1)
    px = rng.integers(-40, 400, (2, 2000)).astype(np.int32)
    want = np.asarray(jops.build_step("bin", "reference", n_bins=256)(
        jnp.asarray(px)))
    got = KB.histogram_bin(torch.from_numpy(px), 256)
    np.testing.assert_array_equal(got.numpy(), want)


def test_binning_phantom_slices_match_bincount_and_pallas():
    px = np.stack([phantom.phantom_slice(64, 64, slice_pos=s, seed=i)[0]
                   .ravel() for i, s in enumerate((0.3, 0.5, 0.7))])
    want = np.asarray(jops.histogram_counts(jnp.asarray(px), interpret=True))
    got = tops.histogram_counts(torch.from_numpy(px), 256).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.stack([np.bincount(r, minlength=256) for r in px]))


def test_histogram_counts_float_pixels_truncate():
    x = np.array([0.0, 0.9, 1.5, 254.99, 255.0, 3.0], np.float32)
    want = np.asarray(jops.build_step("bin", "reference", n_bins=256)(
        jnp.asarray(x)))
    got = tops.histogram_counts(torch.from_numpy(x), 256)
    assert got.shape == (256,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_binning_rejects_bad_input():
    with pytest.raises(ValueError):
        KB.histogram_bin(torch.zeros(5, dtype=torch.uint8), 256)
    with pytest.raises(ValueError):
        KB.histogram_bin(torch.zeros((1, 5), dtype=torch.uint8), 0)


# ---------------------------------------------------------------------------
# Whole-solve
# ---------------------------------------------------------------------------

def _phantom_hists(n, size=64):
    return np.stack([np.bincount(phantom.phantom_slice(
        size, size, slice_pos=s, seed=i)[0].ravel(), minlength=256)
        for i, s in enumerate(np.linspace(0.3, 0.7, n))]).astype(np.float32)


def _init(feats, w, c, eps=5e-3):
    lo, hi = TS.weighted_support(torch.from_numpy(feats),
                                 torch.from_numpy(w))
    v0 = TS.linspace_from_support(lo, hi, c)
    tol = TS._tol_from_range((hi - lo).max(dim=1).values, eps)
    return v0.numpy(), tol.numpy()


def _solve_both(feats, w, c, m=2.0, max_iters=300):
    feats = np.ascontiguousarray(feats, np.float32)
    w = np.ascontiguousarray(w, np.float32)
    v0, tol = _init(feats, w, c)
    x4, w3 = jops.tile_rows_batched(jnp.asarray(feats), jnp.asarray(w))
    jv, jd, ji = JKR.resident_solve_pallas(
        x4, w3, jnp.asarray(v0), jnp.asarray(tol), m, max_iters,
        interpret=True)
    tv, td, ti = KR.resident_solve(
        torch.from_numpy(feats), torch.from_numpy(w), torch.from_numpy(v0),
        torch.from_numpy(tol), m, max_iters)
    return (np.asarray(jv), np.asarray(jd), np.asarray(ji)), \
        (tv.numpy(), td.numpy(), ti.numpy())


def test_whole_solve_phantom_and_degenerate_lanes():
    """Phantom histograms plus an all-zero image (lo == hi, every center
    on one bin, d2 == 0 for all c: the even split), a single-valued
    image, and two lone bins whose zero-weight neighbours must stretch
    neither the init nor the tolerance."""
    hists = _phantom_hists(5)
    zero = np.zeros(256, np.float32)
    zero[0] = 4096
    one = np.zeros(256, np.float32)
    one[77] = 500
    two = np.zeros(256, np.float32)
    two[[10, 250]] = 5
    w = np.concatenate([hists, zero[None], one[None], two[None]])
    feats = np.broadcast_to(np.arange(256, dtype=np.float32)[None, :, None],
                            w.shape + (1,))
    (jv, jd, ji), (tv, td, ti) = _solve_both(feats, w, 4)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)
    assert ti[5] == 1 and (tv[5] == 0).all()       # the all-zero image
    assert ti.dtype == np.int32


@pytest.mark.parametrize("k,d,c", [(17, 1, 2), (100, 2, 4), (129, 3, 8)])
def test_whole_solve_ragged_vector_rows(k, d, c):
    rng = np.random.default_rng(k)
    means = rng.uniform(0, 255, (c, d))
    feats = (means[rng.integers(0, c, (2, k))]
             + rng.normal(0, 5, (2, k, d))).astype(np.float32)
    w = rng.integers(1, 30, (2, k)).astype(np.float32)
    (jv, jd, ji), (tv, td, ti) = _solve_both(feats, w, c)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)


def test_whole_solve_max_iters_zero_returns_init():
    hists = _phantom_hists(2)
    feats = np.broadcast_to(np.arange(256, dtype=np.float32)[None, :, None],
                            hists.shape + (1,))
    (jv, jd, ji), (tv, td, ti) = _solve_both(feats, hists, 4, max_iters=0)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)
    assert np.isinf(td).all() and np.isinf(jd).all()


def test_whole_solve_rejects_shape_mismatch():
    x = torch.zeros(2, 8, 1)
    with pytest.raises(ValueError):
        KR.resident_solve(x, torch.zeros(2, 7), torch.zeros(2, 4, 1),
                          torch.zeros(2), 2.0, 10)


# ---------------------------------------------------------------------------
# Labels
# ---------------------------------------------------------------------------

def _labels_pallas(x, v):
    n = x.shape[1]
    x3, _ = jops.tile_pixels_batched(jnp.asarray(x), 64)
    lab = JKD.labels_pallas(x3, jnp.asarray(v), 64, interpret=True)
    return np.asarray(lab).reshape(x.shape[0], -1)[:, :n]


@pytest.mark.parametrize("n,c", [(256, 4), (1000, 3), (8193, 8)])
def test_labels_plain_matches_pallas_exactly(n, c):
    rng = np.random.default_rng(n + c)
    x = rng.integers(0, 256, (2, n)).astype(np.float32)
    v = np.sort(rng.uniform(0, 255, (2, c)), axis=1).astype(np.float32)
    got = KD.labels(torch.from_numpy(x), torch.from_numpy(v)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, _labels_pallas(x, v))


def test_labels_ties_go_to_lowest_index():
    x = np.array([[30.0, 10.0, 50.0, 29.0, 31.0, 0.0]], np.float32)
    v = np.array([[10.0, 10.0, 50.0, 50.0]], np.float32)
    got = KD.labels(torch.from_numpy(x), torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, _labels_pallas(x, v))
    np.testing.assert_array_equal(got[0], [0, 0, 2, 0, 2, 0])


def test_labels_uint8_pixels_equal_the_bin_table_gather():
    """The engine labels uint8 pixels directly; that must equal the JAX
    engine's per-bin label table gathered over the pixels."""
    rng = np.random.default_rng(3)
    px = rng.integers(0, 256, (3, 700)).astype(np.uint8)
    v = np.sort(rng.uniform(0, 255, (3, 4)), axis=1).astype(np.float32)
    vals = np.broadcast_to(np.arange(256, dtype=np.float32), (3, 256))
    lut = _labels_pallas(np.ascontiguousarray(vals), v)
    want = np.take_along_axis(lut, px.astype(np.int64), axis=1)
    got = tops.defuzzify_labels_batched(torch.from_numpy(px),
                                        torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        KD.labels(torch.from_numpy(px), torch.from_numpy(v)).numpy(), want)
