"""The port's FCM math, step registry and solver core against the JAX
package, on the same seeded numpy inputs.

Elementwise math agrees to float32 rounding; whole solves hold centers
within rtol 1e-5 / atol 1e-4 (values run 0-255 and the background
center sits near 0, where rtol alone means nothing; the two sum rows in
different orders) with equal iteration counts and equal labels.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fcm as JF
from repro.core import histogram as JH
from repro.core import solver as JS
from repro.data import phantom
from repro_torch import convert
from repro_torch.core import batched as TB
from repro_torch.core import fcm as TF
from repro_torch.core import histogram as TH
from repro_torch.core import solver as TS
from repro_torch.data import phantom as TP
from repro_torch.kernels import fcm_resident as KR
from repro_torch.kernels import ops as tops

RTOL, ATOL = 1e-5, 1e-4
CPU = "cpu"


def _t(a):
    return torch.from_numpy(np.array(a))      # a writable copy


# ---------------------------------------------------------------------------
# FCM math
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [2.0, 1.5, 3.0])
def test_membership_and_centers_match_jax(m):
    rng = np.random.default_rng(int(m * 10))
    x = rng.integers(0, 256, 500).astype(np.float32)
    v = np.array([0.0, 60.0, 120.0, 200.0], np.float32)
    ju = np.asarray(JF.update_membership(jnp.asarray(x), jnp.asarray(v), m))
    tu = TF.update_membership(_t(x), _t(v), m).numpy()
    np.testing.assert_allclose(tu, ju, rtol=1e-6, atol=1e-7)
    if m == 2.0:    # exponents -1 and 2: the same float ops as XLA's
        np.testing.assert_array_equal(tu, ju)
    jv = np.asarray(JF.update_centers(jnp.asarray(x), jnp.asarray(ju), m))
    tv = TF.update_centers(_t(x), _t(ju), m).numpy()
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)


def test_zero_distance_rows_split_evenly():
    """A row on a center takes one-hot mass; on two equal centers, half
    each (the 1e-12 floor must not leak into the split)."""
    x = np.array([10.0, 30.0, 20.0], np.float32)
    v = np.array([10.0, 30.0, 30.0], np.float32)
    ju = np.asarray(JF.update_membership(jnp.asarray(x), jnp.asarray(v),
                                         2.0))
    tu = TF.update_membership(_t(x), _t(v), 2.0).numpy()
    np.testing.assert_array_equal(tu, ju)
    np.testing.assert_array_equal(tu[:, 0], [1, 0, 0])
    np.testing.assert_array_equal(tu[:, 1], [0, 0.5, 0.5])


def test_pairwise_and_labels_match_jax_on_vectors():
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 255, (300, 3)).astype(np.float32)
    v = rng.uniform(0, 255, (5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        TF.pairwise_d2(_t(x), _t(v)).numpy(),
        np.asarray(JF.pairwise_d2(jnp.asarray(x), jnp.asarray(v))),
        rtol=1e-6)
    np.testing.assert_array_equal(
        TF.labels_from_centers(_t(x), _t(v)).numpy(),
        np.asarray(JF.labels_from_centers(jnp.asarray(x), jnp.asarray(v))))


def test_labels_from_centers_ties_to_lowest():
    x = np.array([20.0, 5.0], np.float32)
    v = np.array([10.0, 30.0, 10.0], np.float32)
    got = TF.labels_from_centers(_t(x), _t(v)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(JF.labels_from_centers(jnp.asarray(x),
                                               jnp.asarray(v))))
    np.testing.assert_array_equal(got, [0, 0])


def test_linspace_centers_match_jax():
    x = np.array([[3.0, 100.0], [250.0, 7.0], [9.0, 9.0]], np.float32)
    np.testing.assert_array_equal(
        TF.linspace_centers(_t(x), 4).numpy(),
        np.asarray(JF.linspace_centers(jnp.asarray(x), 4)))


def test_weighted_center_step_matches_jax():
    rng = np.random.default_rng(4)
    vals = np.arange(256, dtype=np.float32)
    w = rng.integers(0, 50, 256).astype(np.float32)
    v = np.array([20.0, 90.0, 150.0, 230.0], np.float32)
    np.testing.assert_allclose(
        TH.weighted_center_step(_t(vals), _t(w), _t(v), 2.0).numpy(),
        np.asarray(JH.weighted_center_step(jnp.asarray(vals),
                                           jnp.asarray(w),
                                           jnp.asarray(v), 2.0)),
        rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# Histogram validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x,clip", [
    (np.array([0.0, 12.0, 255.0]), False),
    (np.array([0.0, 1.0, 1.0, 0.0]), False),          # binary mask
    (np.array([-3.0, 12.0, 300.0]), True),
])
def test_intensity_histogram_matches_jax(x, clip):
    want = np.asarray(JH.intensity_histogram(jnp.asarray(x, jnp.float32),
                                             clip=clip))
    got = TH.intensity_histogram(torch.tensor(x, dtype=torch.float32),
                                 clip=clip).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("x", [np.array([-1.0, 5.0]),
                               np.array([0.0, 256.0]),
                               np.array([0.1, 0.5, 0.9])])
def test_intensity_histogram_rejects_what_jax_rejects(x):
    with pytest.raises(ValueError):
        JH.intensity_histogram(jnp.asarray(x, jnp.float32))
    with pytest.raises(ValueError):
        TH.intensity_histogram(torch.tensor(x, dtype=torch.float32))


# ---------------------------------------------------------------------------
# Step registry
# ---------------------------------------------------------------------------

def test_registry_kinds_and_names():
    names = {(i.kind, i.name) for i in tops.step_impls()}
    assert names == {("flat", "reference"), ("flat", "resident"),
                     ("flat", "resident_streamed"), ("flat", "fused"),
                     ("flat", "fused_batched"),
                     ("bin", "reference"), ("bin", "cuda"),
                     ("labels", "reference"), ("labels", "cuda"),
                     ("slic_assign", "reference"), ("slic_assign", "cuda"),
                     ("stencil", "reference"), ("stencil", "fused"),
                     ("stencil", "resident"),
                     ("selscan", "reference"), ("selscan", "cuda")}


@pytest.mark.parametrize("kind", ["flat", "bin", "labels", "slic_assign",
                                  "stencil", "selscan"])
def test_select_step_picks_reference_on_cpu(kind):
    assert tops.select_step(kind, platform="cpu", n_rows=256,
                            c=4).name == "reference"


def test_select_step_picks_kernels_on_cuda():
    assert tops.select_step("flat", platform="cuda", batched=True,
                            n_rows=256, c=4).name == "resident"
    assert tops.select_step("bin", platform="cuda").name == "cuda"
    assert tops.select_step("labels", platform="cuda").name == "cuda"


def test_resident_falls_back_to_reference_off_the_card():
    assert tops.select_step("flat", prefer="resident", platform="cpu",
                            n_rows=256, c=4).name == "reference"


def test_oversize_flat_problem_raises_on_cuda_naming_streamed():
    """Vector rows beyond the streamed whole-solve's bounds take the
    batched fused kernel on the card (scalar rows the fused kernel);
    only c > 32, which no flat kernel holds, raises, naming every
    kernel's bounds. The card never runs the plain loop silently.
    Vector labels are no such case: no TPU kernel takes them, so the
    plain version is their port on the card too."""
    big = KR.STREAM_MAX_ROWS + 1
    assert tops.select_step("flat", platform="cuda", n_rows=big, c=4,
                            n_feat=3).name == "fused_batched"
    assert tops.select_step("flat", platform="cuda", n_rows=5000, c=4,
                            n_feat=17).name == "fused_batched"
    with pytest.raises(ValueError, match="resident_streamed"):
        tops.select_step("flat", platform="cuda", n_rows=5000, c=33,
                         n_feat=17)
    with pytest.raises(ValueError):
        tops.select_step("flat", prefer="resident", platform="cuda",
                         n_rows=5000, c=4)
    assert tops.select_step("labels", platform="cuda",
                            n_feat=3).name == "reference"
    # asked for by name, the plain version may run anywhere
    assert tops.select_step("flat", prefer="reference", platform="cuda",
                            n_rows=5000, c=4).name == "reference"


def test_fallback_walk_cycle_guard(monkeypatch):
    reg = dict(tops._STEP_REGISTRY)
    monkeypatch.setattr(tops, "_STEP_REGISTRY", reg)
    tops.register_step("zz", "a", platforms=("cuda",), fallback="b")(
        lambda **_: None)
    tops.register_step("zz", "b", platforms=("cuda",), fallback="a")(
        lambda **_: None)
    tops.register_step("zz", "reference")(lambda **_: None)
    with pytest.raises(ValueError, match="fallback chain"):
        tops.select_step("zz", prefer="a", platform="cpu")
    with pytest.raises(ValueError, match="unknown step kind"):
        tops.select_step("nope")


# ---------------------------------------------------------------------------
# solve / solve_batched against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,seed", [((64, 64), 0), ((37, 53), 1),
                                        ((64, 64), 5)])
@pytest.mark.parametrize("backend", ["auto", "resident"])
def test_solve_histogram_problem_matches_jax(shape, seed, backend):
    img, _ = phantom.phantom_slice(*shape, slice_pos=0.3 + 0.1 * seed,
                                   seed=seed)
    x = img.ravel().astype(np.float32)
    want = JS.solve(JS.histogram_problem(x), backend="resident",
                    interpret=True)
    got = TS.solve(TS.histogram_problem(x, device=CPU), backend=backend)
    np.testing.assert_allclose(got.centers.numpy(),
                               np.asarray(want.centers), rtol=RTOL,
                               atol=ATOL)
    assert got.n_iters == want.n_iters
    assert got.converged == want.converged and got.healthy
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))


def test_solve_pixel_problem_and_init_match_jax():
    rng = np.random.default_rng(9)
    x = np.concatenate([rng.normal(m, 4, 60) for m in (20, 90, 170)]
                       ).astype(np.float32)
    v0 = np.array([10.0, 100.0, 200.0], np.float32)
    want = JS.solve(JS.pixel_problem(x, c=3, v0=v0))
    got = TS.solve(TS.pixel_problem(x, c=3, v0=v0, device=CPU),
                   keep_membership=True)
    np.testing.assert_allclose(got.centers.numpy(),
                               np.asarray(want.centers), rtol=RTOL,
                               atol=ATOL)
    assert got.n_iters == want.n_iters
    assert got.membership.shape == (3, x.size)


def test_solve_max_iters_exhausted_is_not_converged():
    x = phantom.phantom_slice(64, 64, seed=2)[0].ravel().astype(np.float32)
    want = JS.solve(JS.histogram_problem(x), max_iters=1)
    got = TS.solve(TS.histogram_problem(x, device=CPU), max_iters=1)
    assert got.n_iters == want.n_iters == 1
    assert got.converged == want.converged is False


def _batch(n):
    hists = np.stack([np.bincount(phantom.phantom_slice(
        48, 48, slice_pos=s, seed=i)[0].ravel(), minlength=256)
        for i, s in enumerate(np.linspace(0.3, 0.7, n))]).astype(np.float32)
    hists[-1] = 0
    hists[-1, 40] = 300                       # a single-valued lane
    vals = np.broadcast_to(np.arange(256, dtype=np.float32), hists.shape)
    return np.ascontiguousarray(vals), hists


@pytest.mark.parametrize("backend", ["auto", "reference", "resident"])
def test_solve_batched_matches_jax(backend):
    vals, hists = _batch(6)
    want = JS.solve_batched(JS.batch_problems(vals, hists),
                            backend="resident", interpret=True)
    got = TS.solve_batched(TS.batch_problems(vals, hists, device=CPU),
                           backend=backend)
    np.testing.assert_allclose(got.centers.numpy(),
                               np.asarray(want.centers), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(got.n_iters, want.n_iters)
    assert got.total_iters == want.total_iters
    np.testing.assert_array_equal(got.converged, want.converged)
    np.testing.assert_array_equal(got.healthy, want.healthy)


def test_lanes_match_solo_solves():
    vals, hists = _batch(4)
    res = TS.solve_batched(TS.batch_problems(vals, hists, device=CPU))
    for i in range(4):
        solo = TS.solve(TS.histogram_problem(hist=hists[i], device=CPU))
        assert solo.n_iters == res.n_iters[i]
        np.testing.assert_allclose(solo.centers.numpy(),
                                   res.centers[i].numpy(), rtol=RTOL,
                                   atol=ATOL)


def test_masked_lanes_freeze_like_jax():
    vals, hists = _batch(4)
    active = np.array([True, False, True, True])
    feats = vals[..., None]
    jv, jd, ji, jt = JS.flat_batched_solve(
        jnp.asarray(feats), jnp.asarray(hists), 4, 2.0, 5e-3, 300,
        active=jnp.asarray(active))
    tv, td, ti, tt = TS.flat_batched_solve(_t(feats), _t(hists), 4, 2.0,
                                           5e-3, 300, active=_t(active))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert int(tt) == int(jt)
    assert ti[1] == 0 and td[1] == 0
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL,
                               atol=ATOL)


def test_lane_tolerances_match_jax():
    vals, hists = _batch(5)
    np.testing.assert_array_equal(
        TS.lane_tolerances(TS.batch_problems(vals, hists, device=CPU),
                           5e-3),
        JS.lane_tolerances(JS.batch_problems(vals, hists), 5e-3))


def test_float64_inputs_become_float32():
    x = np.linspace(0, 255, 50)                   # float64
    p = TS.pixel_problem(x, device=CPU)
    assert p.features.dtype == torch.float32
    h = TS.histogram_problem(x.round(), device=CPU)
    assert h.weights.dtype == torch.float32 and h.weights.sum() == 50


def test_problem_and_backend_validation():
    with pytest.raises(ValueError):
        TS.FCMProblem(features=np.zeros((2, 3, 4)), device=CPU)
    with pytest.raises(ValueError, match="unknown backend"):
        TS.solve(TS.pixel_problem(np.zeros(4), device=CPU),
                 backend="pallas")
    with pytest.raises(ValueError):
        TS.solve_batched(TS.pixel_problem(np.zeros(4), device=CPU))


def test_hist_rows_and_phantom_copy():
    rows = TB.hist_rows(torch.zeros(3, 256))
    assert rows.shape == (3, 256) and (rows[2] == torch.arange(256)).all()
    a, la = TP.phantom_slice(40, 30, seed=4)
    b, lb = phantom.phantom_slice(40, 30, seed=4)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(la, lb)


def test_convert_config_and_problem():
    cfg = convert.config_from_numpy(dataclasses.asdict(
        JF.FCMConfig(n_clusters=3, m=2.0, eps=1e-3, max_iters=50)))
    assert (cfg.n_clusters, cfg.eps, cfg.max_iters) == (3, 1e-3, 50)
    with pytest.raises(ValueError):
        convert.config_from_numpy({"bogus": 1})
    jp = JS.histogram_problem(np.arange(30, dtype=np.float32))
    tp = convert.problem_from_numpy(np.asarray(jp.features),
                                    np.asarray(jp.weights), None, jp.c,
                                    jp.m, device=CPU)
    want = JS.solve(jp)
    got = TS.solve(tp)
    assert got.n_iters == want.n_iters
    np.testing.assert_allclose(got.centers.numpy(),
                               np.asarray(want.centers), rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# Per-lane salvage in solve_batched
# ---------------------------------------------------------------------------

def _salvage_counts(reg):
    return {k: v for k, v in reg.snapshot()["counters"].items()
            if k.startswith("solver.salvaged_lanes")}


def test_solve_batched_salvages_a_nan_lane_as_jax_does():
    """One lane with a NaN weight: its centers are non-finite, so both
    packages re-solve it on the plain loop (which gives NaN again), flag
    it and count it; the other lanes are untouched."""
    from repro import obs as jobs
    from repro_torch import obs as tobs
    rng = np.random.default_rng(3)
    hists = rng.integers(0, 50, (3, 256)).astype(np.float32)
    hists[1, 40] = np.nan
    vals = np.broadcast_to(np.arange(256, dtype=np.float32), (3, 256))
    with jobs.scoped_registry() as jreg:
        want = JS.solve_batched(JS.batch_problems(vals, hists, c=4),
                                eps=5e-3, max_iters=40)
    with tobs.scoped_registry() as treg:
        got = TS.solve_batched(TS.batch_problems(vals, hists, c=4,
                                                 device=CPU),
                               eps=5e-3, max_iters=40)
    assert want.salvaged.tolist() == got.salvaged.tolist() == [
        False, True, False]
    np.testing.assert_array_equal(got.n_iters, want.n_iters)
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(want.centers),
                               rtol=RTOL, atol=ATOL, equal_nan=True)
    assert got.healthy.tolist() == want.healthy.tolist() == [True, False,
                                                              True]
    assert _salvage_counts(treg) == _salvage_counts(jreg) == {
        "solver.salvaged_lanes{kind=flat}": 1}
    off = TS.solve_batched(TS.batch_problems(vals, hists, c=4, device=CPU),
                           eps=5e-3, max_iters=40, salvage=False)
    assert not off.salvaged.any() and not off.healthy[1]


def test_solve_batched_salvages_lanes_a_kernel_left_unconverged(
        monkeypatch):
    """Lanes a kernel impl leaves unconverged re-solve on the plain loop,
    as the JAX package re-solves its whole-solve kernel's; the port's
    kernel impl runs its plain version on the CPU, forced by name."""
    from repro import obs as jobs
    from repro_torch import obs as tobs
    rng = np.random.default_rng(4)
    hists = rng.integers(0, 50, (2, 256)).astype(np.float32)
    vals = np.broadcast_to(np.arange(256, dtype=np.float32), (2, 256))
    with jobs.scoped_registry() as jreg:
        want = JS.solve_batched(JS.batch_problems(vals, hists, c=4),
                                eps=5e-3, max_iters=3, backend="resident",
                                interpret=True)
    monkeypatch.setattr(TS, "_select_impl",
                        lambda problem, backend, batch=False: "fused_batched")
    with tobs.scoped_registry() as treg:
        got = TS.solve_batched(TS.batch_problems(vals, hists, c=4,
                                                 device=CPU),
                               eps=5e-3, max_iters=3)
    assert want.salvaged.tolist() == got.salvaged.tolist() == [True, True]
    np.testing.assert_array_equal(got.n_iters, want.n_iters)
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(want.centers),
                               rtol=RTOL, atol=ATOL)
    assert _salvage_counts(treg) == _salvage_counts(jreg) == {
        "solver.salvaged_lanes{kind=flat}": 2}
