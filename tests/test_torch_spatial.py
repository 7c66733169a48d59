"""The port's spatial (FCM_S) path against the JAX package, on the CPU, at
small sizes.

The same numpy inputs, made from a seed, go through both packages:

- ``core/spatial.py``: ``neighbor_fields``, ``spatial_membership`` and
  ``spatial_center_step`` on 37x61 images (4 and 8 neighbors) and a
  5x19x23 volume (6), alpha 0, 1 and 2.5, m 2 and 1.6; rtol 1e-6 (the
  fields are elementwise; the center step's sums run in another order);
- the step kernels' plain version (rows 9 and 10 of PERF.md's table)
  against ``spatial_partials_pallas_2d`` / ``_3d`` in interpret mode on
  grids padded by ``repro.kernels.ops.tile_grid``: (num, den) rtol 1e-5;
- the whole-solve's plain version (row 8) against
  ``resident_stencil_solve_pallas`` in interpret mode on grids padded by
  ``tile_grid_batched``: equal iteration counts, centers within rtol
  1e-5 / atol 1e-4 (the two sum the pixels in different orders);
- ``solve(spatial_problem)`` with each port backend against the JAX
  package's ``reference`` and ``pallas``: equal iterations and labels;
  with alpha 0 the port's plain ``solve(pixel_problem)`` bit for bit;
- the engine's spatial route against the JAX engine: per-request
  iterations and labels equal, centers within rtol 1e-5 / atol 1e-4;
- FCM_S beats plain FCM on a salt-and-pepper slice.

The CUDA kernels are held against these plain versions on the card by
``chip_smoke.py`` (phase 7) and ``tests/test_torch_cuda.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import solver as JS
from repro.core import spatial as JSP
from repro.data import phantom
from repro.kernels import fcm_resident as JKR
from repro.kernels import ops as jops
from repro.serving.fcm_engine import FCMServeEngine as JAXEngine
from repro_torch import convert
from repro_torch.configs import fcm_brainweb
from repro_torch.core import solver as TS
from repro_torch.core import spatial as TSP
from repro_torch.kernels import fcm_spatial as KSP
from repro_torch.kernels import fcm_stencil as KST
from repro_torch.kernels import ops as tops
from repro_torch.serving import FCMServeEngine
from repro_torch.serving import fcm_engine as TE

RTOL, ATOL = 1e-5, 1e-4
CPU = torch.device("cpu")
#: (grid shape, neighbors): the shapes of the stencil parity tests
GRIDS = [((37, 61), 4), ((37, 61), 8), ((5, 19, 23), 6)]


def _data(shape, c=4, seed=0):
    """Integer pixels and sorted centers, one on a pixel value (an exact
    zero distance)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, shape).astype(np.float32)
    v = np.sort(rng.uniform(5, 250, c)).astype(np.float32)
    v[1] = img.flat[0]
    return img, v


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _noisy(shape, seed):
    if len(shape) == 2:
        return phantom.noisy_phantom_slice(*shape, noise=12.0, impulse=0.05,
                                           seed=seed)[0].astype(np.float32)
    return phantom.noisy_phantom_volume(*shape, seed=seed)[0].astype(
        np.float32)


# -- core/spatial.py ---------------------------------------------------------

@pytest.mark.parametrize("shape,neighbors", GRIDS)
@pytest.mark.parametrize("alpha", [0.0, 1.0, 2.5])
@pytest.mark.parametrize("m", [2.0, 1.6])
def test_stencil_math_matches_jax(shape, neighbors, alpha, m):
    img, v = _data(shape, seed=len(shape))
    for got, want in zip(TSP.neighbor_fields(_t(img), _t(v), neighbors),
                         JSP.neighbor_fields(img, v, neighbors)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(
        TSP.spatial_membership(_t(img), _t(v), m, alpha, neighbors).numpy(),
        np.asarray(JSP.spatial_membership(img, v, m, alpha, neighbors)),
        rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        TSP.spatial_center_step(_t(img), _t(v), m, alpha, neighbors).numpy(),
        np.asarray(JSP.spatial_center_step(img, v, m, alpha, neighbors)),
        rtol=1e-6)


def test_batched_stencil_math_equals_each_lane_alone():
    imgs = np.stack([_data((9, 14), seed=s)[0] for s in range(3)])
    v = np.stack([_data((9, 14), seed=s)[1] for s in range(3)])
    u = TSP.spatial_membership(_t(imgs), _t(v), 2.0, 1.0, 8, batched=True)
    step = TSP.spatial_center_step(_t(imgs), _t(v), 2.0, 1.0, 8,
                                   batched=True)
    for i in range(3):
        assert torch.equal(u[i], TSP.spatial_membership(
            _t(imgs[i]), _t(v[i]), 2.0, 1.0, 8))
        np.testing.assert_allclose(step[i].numpy(), TSP.spatial_center_step(
            _t(imgs[i]), _t(v[i]), 2.0, 1.0, 8).numpy(), rtol=1e-6)


@pytest.mark.parametrize("shape", [(1, 1), (1, 5), (2, 2, 2)])
def test_degenerate_grids_match_jax(shape):
    img, v = _data(shape, seed=5)
    nb = 6 if len(shape) == 3 else 8
    np.testing.assert_allclose(
        TSP.spatial_center_step(_t(img), _t(v), 2.0, 1.0, nb).numpy(),
        np.asarray(JSP.spatial_center_step(img, v, 2.0, 1.0, nb)),
        rtol=1e-6)


# -- rows 9 and 10: the step kernels' plain version ---------------------------

@pytest.mark.parametrize("shape,neighbors", GRIDS)
@pytest.mark.parametrize("alpha,m", [(0.0, 2.0), (1.0, 2.0), (2.5, 1.6)])
def test_step_plain_matches_pallas(shape, neighbors, alpha, m):
    img, v = _data(shape, seed=7)
    xpad, wpad = jops.tile_grid(img, 8)
    jnum, jden = jops.spatial_partials(xpad, wpad, jnp.asarray(v), m, alpha,
                                       neighbors, block_rows=8,
                                       interpret=True)
    fn = KSP.spatial_partials_2d if len(shape) == 2 \
        else KSP.spatial_partials_3d
    args = (neighbors,) if len(shape) == 2 else ()
    num, den = fn(_t(img[None]), _t(v[None]), m, alpha, *args)
    assert fn.launches == 0                  # CPU tensors: the plain version
    np.testing.assert_allclose(num[0].numpy(), np.asarray(jnum), rtol=1e-5)
    np.testing.assert_allclose(den[0].numpy(), np.asarray(jden), rtol=1e-5)


def test_step_wrapper_rejects_what_the_kernels_cannot_take():
    x = torch.zeros((1, 4, 4))
    with pytest.raises(ValueError, match="4 or 8"):
        KSP.spatial_partials_2d(x, torch.zeros((1, 4)), 2.0, 1.0, 6)
    with pytest.raises(ValueError, match="rank 4"):
        KSP.spatial_partials_3d(x, torch.zeros((1, 4)), 2.0, 1.0)
    with pytest.raises(ValueError, match="6-connected"):
        tops.spatial_partials(torch.zeros((1, 2, 4, 4)), torch.zeros((1, 4)),
                              neighbors=8)


# -- row 8: the whole-solve's plain version -----------------------------------

def _lane_init(imgs, c=4, eps=5e-3):
    """The batched solve's v0 and tolerance, in float32 numpy."""
    flat = imgs.reshape(imgs.shape[0], -1)
    lo, hi = flat.min(axis=1), flat.max(axis=1)
    frac = (np.arange(c, dtype=np.float32) + np.float32(0.5)) / np.float32(c)
    v0 = (lo[:, None] + frac[None, :] * (hi - lo)[:, None]).astype(np.float32)
    rng = hi - lo
    tol = (np.float32(eps) * np.where(rng > 0, rng, np.float32(1.0))
           * np.float32(0.1)).astype(np.float32)
    return v0, tol


def _ragged_2d():
    const = np.full((24, 40), 77.0, np.float32)
    two = np.zeros((24, 40), np.float32)
    two[:, 20:] = 200.0
    return np.stack([const, two, _noisy((24, 40), seed=3)])


@pytest.mark.parametrize("case", ["ragged 2-D, 8 nb", "noisy 2-D, 4 nb",
                                  "8x16x16 volume"])
def test_whole_solve_plain_matches_pallas(case):
    if case.startswith("ragged"):
        imgs, nb, alpha = _ragged_2d(), 8, 1.0
    elif case.startswith("noisy"):
        imgs = np.stack([_noisy((24, 40), seed=s) for s in (5, 6)])
        nb, alpha = 4, 2.5
    else:
        imgs, nb, alpha = _noisy((8, 16, 16), seed=1)[None], 6, 1.0
    v0, tol = _lane_init(imgs)
    xpad, vpad = jops.tile_grid_batched(imgs)
    jv, _, jit = JKR.resident_stencil_solve_pallas(
        xpad, vpad, jnp.asarray(v0), jnp.asarray(tol), 2.0, alpha, nb, 300,
        interpret=True)
    v, _, it = KST.stencil_solve(_t(imgs), _t(v0), _t(tol), 2.0, alpha, nb,
                                 300)
    assert KST.stencil_solve.launches == 0
    np.testing.assert_array_equal(it.numpy(), np.asarray(jit))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=RTOL,
                               atol=ATOL)


# -- solve(spatial_problem) ----------------------------------------------------

_JAX_SOLVES = {}


def _jax_solve(name, img, neighbors, backend):
    key = (name, backend)
    if key not in _JAX_SOLVES:
        cfg = JSP.SpatialFCMConfig(alpha=1.0, neighbors=neighbors)
        _JAX_SOLVES[key] = JS.solve(JS.spatial_problem(img, cfg), cfg,
                                    backend=backend, block_rows=8,
                                    interpret=backend == "pallas")
    return _JAX_SOLVES[key]


@pytest.mark.parametrize("name", ["64x64 slice", "6x24x24 volume"])
@pytest.mark.parametrize("backend", ["auto", "reference", "resident",
                                     "fused"])
def test_solve_matches_jax(name, backend):
    shape, nb = ((64, 64), 8) if name.startswith("64") else ((6, 24, 24), 6)
    img = _noisy(shape, seed=0)
    got = TS.solve(TS.spatial_problem(img, alpha=1.0, neighbors=nb,
                                      device="cpu"), backend=backend)
    assert got.labels.shape == img.shape and got.centers.shape == (4,)
    assert got.converged and got.healthy
    for jbackend in ("reference", "pallas"):
        want = _jax_solve(name, img, nb, jbackend)
        assert got.n_iters == want.n_iters, jbackend
        np.testing.assert_array_equal(got.labels.numpy(),
                                      np.asarray(want.labels))
        np.testing.assert_allclose(got.centers.numpy(),
                                   np.asarray(want.centers), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("neighbors", [4, 8])
def test_alpha_zero_is_the_plain_pixel_solve_bit_for_bit(neighbors):
    img = _noisy((64, 64), seed=2)
    s = TS.solve(TS.spatial_problem(img, alpha=0.0, neighbors=neighbors,
                                    device="cpu"))
    p = TS.solve(TS.pixel_problem(img.ravel(), device="cpu"))
    assert s.n_iters == p.n_iters
    assert torch.equal(s.centers, p.centers)
    assert torch.equal(s.labels.reshape(-1), p.labels)


def test_solve_batched_matches_jax_and_each_lane_alone():
    imgs = np.stack([_noisy((32, 40), seed=s) for s in range(3)])
    stencil = TS.StencilSpec(alpha=1.0, neighbors=8)
    got = TS.solve_batched(TS.batch_problems(imgs, stencil=stencil,
                                             device="cpu"))
    want = JS.solve_batched(JS.batch_problems(
        jnp.asarray(imgs), stencil=JS.StencilSpec(alpha=1.0, neighbors=8)))
    np.testing.assert_array_equal(got.n_iters, np.asarray(want.n_iters))
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(want.centers),
                               rtol=RTOL, atol=ATOL)
    assert got.converged.all() and got.healthy.all()
    tol = TS.lane_tolerances(TS.batch_problems(imgs, stencil=stencil,
                                               device="cpu"), 5e-3)
    np.testing.assert_array_equal(tol, JS.lane_tolerances(JS.batch_problems(
        jnp.asarray(imgs), stencil=JS.StencilSpec(alpha=1.0, neighbors=8)),
        5e-3))
    for i in range(3):
        one = TS.solve(TS.spatial_problem(imgs[i], alpha=1.0, neighbors=8,
                                          device="cpu"))
        assert one.n_iters == got.n_iters[i]
        np.testing.assert_allclose(one.centers.numpy(),
                                   got.centers[i].numpy(), rtol=RTOL,
                                   atol=ATOL)


def test_spatial_problem_validation():
    with pytest.raises(ValueError, match="rank|grid"):
        TS.spatial_problem(np.zeros(64, np.float32), device="cpu")
    with pytest.raises(ValueError, match="weights"):
        TS.FCMProblem(features=np.zeros((4, 4)), weights=np.ones(16),
                      stencil=TS.StencilSpec(), device="cpu")
    with pytest.raises(ValueError, match="4 or 8"):
        TS.FCMProblem(features=np.zeros((4, 4)),
                      stencil=TS.StencilSpec(neighbors=6), device="cpu")
    p = TS.spatial_problem(np.zeros((2, 3, 4), np.float32), neighbors=8,
                           device="cpu")
    assert p.stencil.neighbors == 6 and p.n_rows == 24 and p.scalar
    with pytest.raises(ValueError, match="no flat rows"):
        p.rows()
    with pytest.raises(ValueError, match="unweighted pixel"):
        TS.solve(p, backend="staged")


def test_stencil_dispatch_on_the_card_by_lane_size():
    def pick(n_rows, c=4, batched=True):
        return tops.select_step("stencil", platform="cuda", batched=batched,
                                n_rows=n_rows, c=c).name
    assert pick(217 * 181) == "resident"
    assert pick(KST.STENCIL_MAX_PIXELS) == "resident"
    assert pick(KST.STENCIL_MAX_PIXELS + 1) == "fused"
    assert pick(181 * 217 * 181) == "fused"
    assert pick(4000 * 256, batched=False) == "fused"
    assert pick(64 * 64, c=9) == "fused"           # the whole-solve: c <= 8
    with pytest.raises(ValueError, match="no stencil kernel"):
        pick(64 * 64, c=33)
    assert tops.select_step("stencil", platform="cpu", batched=True,
                            n_rows=64, c=4).name == "reference"
    assert tops.select_step("stencil", prefer="resident", platform="cpu",
                            n_rows=64, c=4).name == "reference"
    assert KST.STENCIL_MAX_PIXELS != JKR.STENCIL_MAX_PIXELS


# -- the engine's spatial route ------------------------------------------------

def test_spatial_route_matches_the_jax_engine():
    scfg = fcm_brainweb.make_config().spatial
    jcfg = JSP.SpatialFCMConfig(**dataclasses.asdict(scfg))
    imgs = [_noisy((40, 48), seed=s).astype(np.uint8) for s in range(5)]
    imgs.append(_noisy((5, 20, 24), seed=9))
    mine = FCMServeEngine(batch_sizes=(1, 8), cache_size=0, spatial_cfg=scfg,
                          device="cpu")
    ref = JAXEngine(batch_sizes=(1, 8), cache_size=0, spatial_cfg=jcfg)
    got = mine.segment(imgs, method="spatial")
    want = ref.segment(imgs, method="spatial")
    for g, w, im in zip(got, want, imgs):
        assert g.method == "spatial" and g.labels.shape == im.shape
        assert g.n_iters == w.n_iters and g.converged
        np.testing.assert_array_equal(g.labels, np.asarray(w.labels))
        np.testing.assert_allclose(g.centers, np.asarray(w.centers),
                                   rtol=RTOL, atol=ATOL)
    st, jst = mine.stats(), ref.stats()
    for k in ("spatial_batches", "spatial_batched_images",
              "spatial_padded_lanes", "spatial_iters"):
        assert st[k] == jst[k], k


def test_route_registry_order_and_config():
    assert TE.METHODS == ("histogram", "pixel", "spatial", "superpixel")
    job = fcm_brainweb.make_config()
    assert (job.spatial.alpha, job.spatial.neighbors) == (1.0, 8)
    assert job.noise_levels == phantom.NOISE_LEVELS
    eng = FCMServeEngine(device="cpu")
    assert eng.spatial_cfg.neighbors == 4
    with pytest.raises(ValueError, match="pixel grid"):
        eng.submit(np.zeros(16, np.uint8), method="spatial")
    fields = dataclasses.asdict(JSP.SpatialFCMConfig(alpha=0.5,
                                                     neighbors=8))
    cfg = convert.config_from_numpy(fields)
    assert isinstance(cfg, TSP.SpatialFCMConfig) and cfg.alpha == 0.5


# -- what FCM_S is for ----------------------------------------------------------

def test_spatial_beats_plain_fcm_on_salt_and_pepper():
    """At the heaviest noise level FCM_S beats plain FCM's DSC by a wide
    margin on every tissue class, as the JAX package's
    tests/test_fcm_spatial.py shows for its own solver."""
    sigma, impulse = phantom.NOISE_LEVELS[-1]
    img, gt = phantom.noisy_phantom_slice(128, 128, noise=sigma,
                                          impulse=impulse, seed=0)
    x = img.astype(np.float32)
    rp = TS.solve(TS.pixel_problem(x.ravel(), device="cpu"))
    plain = phantom.match_labels_to_classes(
        rp.labels.numpy().reshape(img.shape), rp.centers.numpy())
    scfg = TSP.SpatialFCMConfig(alpha=1.0, neighbors=8)
    rs = TS.solve(TS.spatial_problem(x, scfg, device="cpu"), scfg)
    spatial = phantom.match_labels_to_classes(rs.labels.numpy(),
                                              rs.centers.numpy())
    dsc_p = phantom.dice_per_class(plain, gt)
    dsc_s = phantom.dice_per_class(spatial, gt)
    for cls in (1, 2, 3):                      # CSF, GM, WM
        assert dsc_s[cls] >= dsc_p[cls] + 0.2, (cls, dsc_p[cls], dsc_s[cls])
        assert dsc_s[cls] > 0.75, (cls, dsc_s[cls])
