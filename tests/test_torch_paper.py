"""The paper's per-iteration path in the port against the JAX package:
the membership, center-partials and fused-partials kernels' plain
versions, and ``solve`` with the fused, staged and sequential backends.

Each Pallas kernel runs here as the JAX package's own tests run it on
the CPU (``interpret=True``); the port's wrappers take their plain
PyTorch versions for CPU tensors. The same numpy inputs, made from a
seed, go through both. Tolerances:

- memberships rtol 1e-6 / atol 1e-7 (the same float32 operations; the
  c-term normalizing sum may be added in another order, and general m
  goes through two pow implementations);
- partial sums rtol 1e-5 (sums over up to 8193 pixels in other orders);
- solves: centers rtol 1e-5 / atol 1e-4 (values run 0-255 and the
  background center sits near 0, where rtol alone means nothing), equal
  iteration counts and labels; the staged path's ``final_delta``, a
  membership difference, within 1e-6;
- the sequential comparator is the same numpy code: equal to the bit.

The CUDA kernels themselves are held against these plain versions on
the card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fcm as JF
from repro.core import solver as JS
from repro.data import phantom
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import fcm as TF
from repro_torch.core import solver as TS
from repro_torch.kernels import _build
from repro_torch.kernels import fcm_centers as KC
from repro_torch.kernels import fcm_membership as KM
from repro_torch.kernels import ops as tops

RTOL, ATOL = 1e-5, 1e-4
CPU = "cpu"


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))   # a writable copy


def _pixels(n, c, seed):
    """``n`` integer-valued pixels and ``c`` sorted centers, a third of
    them on integers that occur among the pixels (exact zero
    distances)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, n).astype(np.float32)
    v = np.sort(rng.uniform(0, 255, c)).astype(np.float32)
    on = rng.choice(c, max(1, c // 3), replace=False)
    v[on] = x[rng.integers(0, n, on.size)]
    return x, v


def _image_20kb():
    return phantom.phantom_of_bytes(20 * 1024)[0].ravel().astype(np.float32)


def _slice_31x33():
    return phantom.phantom_slice(31, 33, seed=3)[0].ravel().astype(
        np.float32)


# ---------------------------------------------------------------------------
# Kernels (plain versions) against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,c,m", [(1, 2, 2.0), (127, 4, 2.0),
                                   (8193, 8, 2.0), (127, 4, 2.5),
                                   (8193, 2, 2.5)])
def test_membership_matches_pallas(n, c, m):
    x, v = _pixels(n, c, n + c)
    want = np.asarray(jops.membership(jnp.asarray(x), jnp.asarray(v), m,
                                      interpret=True))
    got = tops.membership(_t(x), _t(v), m).numpy()
    assert got.shape == (c, n) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    zero = (v[:, None] == x[None, :])
    assert zero.any()
    hit = zero.any(axis=0)
    np.testing.assert_array_equal(got[:, hit],
                                  zero[:, hit] / zero[:, hit].sum(axis=0))


def test_membership_all_equal_image_splits_evenly():
    """Every pixel on the same value and every center on it: the even
    split over all c clusters."""
    x = np.full(300, 77.0, np.float32)
    v = np.full(4, 77.0, np.float32)
    want = np.asarray(jops.membership(jnp.asarray(x), jnp.asarray(v), 2.0,
                                      interpret=True))
    got = tops.membership(_t(x), _t(v), 2.0).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.full((4, 300), 0.25, np.float32))


@pytest.mark.parametrize("n,c,m", [(1, 2, 2.0), (127, 4, 2.0),
                                   (8193, 8, 2.0), (8193, 4, 2.5)])
def test_center_partials_match_pallas(n, c, m):
    rng = np.random.default_rng(n * c)
    x = rng.integers(0, 256, n).astype(np.float32)
    u = rng.uniform(1e-3, 1.0, (c, n)).astype(np.float32)
    u /= u.sum(axis=0, keepdims=True)
    jnum, jden = jops.center_partials(jnp.asarray(x), jnp.asarray(u), m,
                                      interpret=True)
    tnum, tden = tops.center_partials(_t(x), _t(u), m)
    assert tuple(tnum.shape) == (c, 1) and tuple(tden.shape) == (c,)
    np.testing.assert_allclose(tnum.numpy(), np.asarray(jnum), rtol=1e-5)
    np.testing.assert_allclose(tden.numpy(), np.asarray(jden), rtol=1e-5)


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unit", "histogram"])
@pytest.mark.parametrize("n,c,m", [(127, 2, 2.0), (8193, 4, 2.0),
                                   (8193, 8, 2.5)])
def test_fused_partials_and_step_match_pallas(weighted, n, c, m):
    x, v = _pixels(n, c, 3 * n + c)
    rng = np.random.default_rng(n)
    w = (rng.integers(0, 40, n).astype(np.float32) if weighted
         else np.ones(n, np.float32))
    x2d, w2d = jops.tile_rows(jnp.asarray(x), jnp.asarray(w), 8)
    jnum, jden = jops.fused_partials(x2d, w2d, jnp.asarray(v), m,
                                     block_rows=8, interpret=True)
    tnum, tden = tops.fused_partials(_t(x), _t(w) if weighted else None,
                                     _t(v), m)
    np.testing.assert_allclose(tnum.numpy(), np.asarray(jnum), rtol=1e-5)
    np.testing.assert_allclose(tden.numpy(), np.asarray(jden), rtol=1e-5)
    if not weighted:
        want = np.asarray(jops.fused_step(jnp.asarray(x), jnp.asarray(v), m,
                                          block_rows=8, interpret=True))
        got = tops.fused_step(_t(x), _t(v), m).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_kernel_wrappers_reject_bad_input():
    with pytest.raises(ValueError):
        KM.membership(torch.zeros(4, 2), torch.zeros(3), 2.0)
    with pytest.raises(ValueError):
        KC.center_partials(torch.zeros(5), torch.zeros(3, 4), 2.0)
    with pytest.raises(ValueError):
        KC.fused_partials(torch.zeros(5), torch.ones(4), torch.zeros(3),
                          2.0)


# ---------------------------------------------------------------------------
# solve(): fused, staged, sequential
# ---------------------------------------------------------------------------

def _assert_same_solve(got, want):
    assert got.n_iters == int(want.n_iters)
    np.testing.assert_allclose(got.centers.numpy(),
                               np.asarray(want.centers), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))


@pytest.mark.parametrize("stop", [{}, {"tol": -1.0, "max_iters": 10}],
                         ids=["converged", "10-iters"])
@pytest.mark.parametrize("image", [_image_20kb, _slice_31x33],
                         ids=["20KB", "31x33"])
def test_fused_solve_matches_pallas_and_reference(image, stop):
    x = image()
    got = TS.solve(TS.pixel_problem(x, device=CPU), backend="fused", **stop)
    pallas = JS.solve(JS.pixel_problem(x), backend="pallas", interpret=True,
                      block_rows=8, **stop)
    reference = JS.solve(JS.pixel_problem(x), backend="reference", **stop)
    _assert_same_solve(got, pallas)
    _assert_same_solve(got, reference)
    assert got.converged == pallas.converged


def test_fused_solve_of_a_histogram_problem_matches_resident():
    """fused takes weighted scalar rows too (histogram counts)."""
    x = _image_20kb()
    got = TS.solve(TS.histogram_problem(x, device=CPU), backend="fused")
    want = JS.solve(JS.histogram_problem(x), backend="resident",
                    interpret=True)
    _assert_same_solve(got, want)


@pytest.mark.parametrize("image,c", [(_image_20kb, 4), (_slice_31x33, 4),
                                     (_slice_31x33, 2)],
                         ids=["20KB", "31x33", "31x33-c2"])
def test_staged_solve_matches_jax(image, c):
    x = image()
    u0 = np.asarray(JF.random_membership(jax.random.PRNGKey(0), c, x.size))
    got = TS.solve(TS.pixel_problem(x, c=c, device=CPU), backend="staged",
                   u0=convert.membership_from_numpy(u0, CPU),
                   keep_membership=True)
    for use_pallas in (True, False):
        want = JS.solve_staged(JS.pixel_problem(x, c=c), u0=jnp.asarray(u0),
                               keep_membership=True, use_pallas=use_pallas)
        _assert_same_solve(got, want)
        assert abs(got.final_delta - float(want.final_delta)) <= 1e-6
        assert got.converged == want.converged
    out = convert.result_to_numpy(got)
    assert out["membership"].shape == (c, x.size)
    np.testing.assert_array_equal(out["labels"],
                                  out["membership"].argmax(axis=0))


def test_staged_vector_rows_run_the_plain_stages_on_the_cpu():
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.normal(mu, 3, (40, 2)) for mu in (20, 120, 220)]
                       ).astype(np.float32)
    u0 = np.asarray(JF.random_membership(jax.random.PRNGKey(1), 3, 120))
    got = TS.solve_staged(TS.pixel_problem(x, c=3, device=CPU), u0=u0)
    want = JS.solve_staged(JS.pixel_problem(x, c=3), u0=jnp.asarray(u0))
    _assert_same_solve(got, want)


@pytest.mark.parametrize("kw", [{}, {"eps": -1.0, "max_iters": 4},
                                {"seed": 7}],
                         ids=["default", "4-iters", "seed7"])
def test_sequential_equals_jax_bit_for_bit(kw):
    x = _slice_31x33()
    got = TS.solve(TS.pixel_problem(x, device=CPU), backend="sequential",
                   **kw)
    want = JS.solve(JS.pixel_problem(x), backend="sequential", **kw)
    assert got.n_iters == want.n_iters
    np.testing.assert_array_equal(got.centers.numpy(),
                                  np.asarray(want.centers))
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    assert got.converged == want.converged and np.isnan(got.final_delta)


def test_sequential_takes_u0_like_jax():
    x = _slice_31x33()
    u0 = np.asarray(JF.random_membership(jax.random.PRNGKey(2), 4, x.size))
    got = TS.solve(TS.pixel_problem(x, device=CPU), backend="sequential",
                   u0=torch.from_numpy(u0.copy()))
    want = JS.solve(JS.pixel_problem(x), backend="sequential", u0=u0)
    np.testing.assert_array_equal(got.centers.numpy(),
                                  np.asarray(want.centers))
    assert got.n_iters == want.n_iters


def test_paper_backends_reject_what_jax_rejects():
    hist = TS.histogram_problem(np.arange(30, dtype=np.float32), device=CPU)
    vec = TS.pixel_problem(np.zeros((6, 2), np.float32), device=CPU)
    with pytest.raises(ValueError, match="unweighted"):
        TS.solve(hist, backend="staged")
    with pytest.raises(ValueError, match="scalar unweighted"):
        TS.solve(hist, backend="sequential")
    with pytest.raises(ValueError, match="scalar unweighted"):
        TS.solve(vec, backend="sequential")
    with pytest.raises(ValueError, match="scalar"):
        TS.solve(vec, backend="fused")
    with pytest.raises(ValueError, match="u0 must be"):
        TS.solve(TS.pixel_problem(np.zeros(6), device=CPU),
                 backend="staged", u0=np.full((4, 5), 0.25))


# ---------------------------------------------------------------------------
# Dispatch, init, conversion and the build digest
# ---------------------------------------------------------------------------

def test_auto_on_cuda_picks_resident_then_fused():
    """The JAX package's auto order: resident, the streamed whole-solve,
    then the fused step (unbatched scalar rows beyond the streamed
    kernel's bounds)."""
    pick = tops.select_step
    assert pick("flat", platform="cuda", n_rows=1024, c=4).name == "resident"
    assert pick("flat", platform="cuda", n_rows=1025,
                c=4).name == "resident_streamed"
    assert pick("flat", platform="cuda", n_rows=1024 * 1000,
                c=32).name == "fused"
    assert pick("flat", platform="cuda", n_rows=(1 << 20) + 1,
                c=4).name == "fused"
    assert pick("flat", platform="cuda", n_rows=1025, c=4,
                n_feat=3).name == "resident_streamed"
    with pytest.raises(ValueError, match="resident_streamed"):
        pick("flat", platform="cuda", n_rows=1025, c=33, n_feat=3)
    # batched solves never take the fused step
    assert pick("flat", platform="cuda", batched=True, n_rows=1025,
                c=4).name == "resident_streamed"
    with pytest.raises(ValueError, match="resident_streamed"):
        pick("flat", platform="cuda", batched=True, n_rows=1025, c=33)
    # asked for by name off the card, the fused step runs its plain
    # version (the JAX package's interpret mode); on the CPU auto stays
    # on the reference
    assert pick("flat", prefer="fused", platform="cpu", n_rows=1025,
                c=4).name == "fused"
    assert pick("flat", platform="cpu", n_rows=1025, c=4).name == \
        "reference"
    with pytest.raises(ValueError, match="scalar"):
        pick("flat", prefer="fused", platform="cuda", n_feat=3, n_rows=10,
             c=4)


@pytest.mark.parametrize("backend", ["fused", "staged", "sequential"])
def test_solve_batched_refuses_the_per_iteration_backends(backend):
    hists = np.ones((2, 256), np.float32)
    vals = np.broadcast_to(np.arange(256, dtype=np.float32), (2, 256))
    with pytest.raises(ValueError, match="reference or resident"):
        TS.solve_batched(TS.batch_problems(vals, hists, device=CPU),
                         backend=backend)


def test_random_membership_is_seeded_and_u0_overrides_it():
    a = TF.random_membership(torch.Generator().manual_seed(3), 4, 500)
    b = TF.random_membership(torch.Generator().manual_seed(3), 4, 500,
                             device=CPU)
    assert torch.equal(a, b) and a.dtype == torch.float32
    assert float(a.min()) > 0.0
    np.testing.assert_allclose(a.sum(dim=0).numpy(), 1.0, rtol=1e-6)
    x = _slice_31x33()
    p = TS.pixel_problem(x, device=CPU)
    r1 = TS.solve(p, backend="staged", seed=3, max_iters=2,
                  keep_membership=True)
    r2 = TS.solve(p, backend="staged", seed=3, max_iters=2,
                  keep_membership=True)
    assert torch.equal(r1.membership, r2.membership)
    u0 = TF.random_membership(torch.Generator().manual_seed(4), 4, x.size)
    r3 = TS.solve(p, backend="staged", u0=u0, max_iters=2)
    r4 = TS.solve(p, backend="staged", u0=u0, seed=99, max_iters=2)
    assert torch.equal(r3.centers, r4.centers)
    assert not torch.equal(r1.centers, r3.centers)


def test_keep_membership_and_max_iters_zero():
    x = _slice_31x33()
    p = TS.pixel_problem(x, device=CPU)
    r = TS.solve(p, backend="fused", keep_membership=True)
    np.testing.assert_array_equal(
        r.membership.numpy(),
        TF.update_membership(p.features, r.centers, 2.0).numpy())
    u0 = np.asarray(JF.random_membership(jax.random.PRNGKey(0), 4, x.size))
    got = TS.solve_staged(p, u0=u0, max_iters=0)
    want = JS.solve_staged(JS.pixel_problem(x), u0=jnp.asarray(u0),
                           max_iters=0)
    assert got.n_iters == 0 and np.isinf(got.final_delta)
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(want.centers),
                               rtol=RTOL, atol=ATOL)


def test_objective_terms_and_defuzzify_match_jax():
    x, v = _pixels(200, 4, 11)
    u = np.asarray(JF.update_membership(jnp.asarray(x), jnp.asarray(v), 2.0))
    np.testing.assert_allclose(
        float(TF.objective(_t(x), _t(u), _t(v), 2.0)),
        float(JF.objective(jnp.asarray(x), jnp.asarray(u), jnp.asarray(v),
                           2.0)), rtol=1e-5)
    tn, td = TF.center_terms(_t(x), _t(u), 2.0)
    jn, jd = JF.center_terms(jnp.asarray(x), jnp.asarray(u), 2.0)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    tie = np.array([[0.5, 0.2], [0.5, 0.8]], np.float32)
    np.testing.assert_array_equal(TF.defuzzify(_t(tie)).numpy(),
                                  np.asarray(JF.defuzzify(jnp.asarray(tie))))
    np.testing.assert_array_equal(TF.defuzzify(_t(u)).numpy(),
                                  np.asarray(JF.defuzzify(jnp.asarray(u))))


def test_convert_membership_and_result():
    with pytest.raises(ValueError):
        convert.membership_from_numpy(np.zeros(5), CPU)
    u = convert.membership_from_numpy(np.full((2, 3), 0.5), CPU)
    assert u.dtype == torch.float32 and tuple(u.shape) == (2, 3)
    out = convert.result_to_numpy(TS.solve(
        TS.pixel_problem(_slice_31x33(), device=CPU)))
    assert out["membership"] is None and out["labels"].dtype == np.int32
    assert out["centers"].shape == (4,) and out["centers"].dtype == np.float32


def test_build_digest_covers_shared_headers(tmp_path, monkeypatch):
    """An edited header rebuilds the library, not only an edited .cu."""
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build.sources()] == ["k.cu"]
    before = _build._digest()
    (tmp_path / "common.cuh").write_text("// v2\n")
    assert _build._digest() != before


def test_every_exported_kernel_has_a_signature():
    names = set(_build.SIGNATURES)
    assert {"fcm_membership", "fcm_center_partials",
            "fcm_fused_partials"} <= names
    for path in _build.CSRC.glob("*.cu"):
        for line in path.read_text().splitlines():
            if line.startswith('extern "C" int '):
                name = line.split()[3].split("(")[0]
                assert name in names, f"{path.name}: {name}"
