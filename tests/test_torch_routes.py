"""The port's pixel and superpixel routes against the JAX package, on the
CPU, at small sizes.

The same numpy inputs, made from a seed, go through both packages:

- the HBM-streamed whole-solve: the port's wrapper on CPU tensors (its
  plain version) against ``resident_streamed_solve_pallas`` in interpret
  mode, and ``solve``/``solve_batched`` with ``backend="resident"`` past
  the resident bound; centers within rtol 1e-5 / atol 1e-4 (the two sum
  the rows in different orders), equal iteration counts;
- dispatch on ``platform="cuda"`` by lane size;
- SLIC: the port's ``assign_ref`` against the JAX package's (not its
  Pallas kernel, which disagrees with its own reference on one shape),
  equal labels except near-ties (the two candidates' distances,
  recomputed in float64, within 1e-6 relative, on at most 1e-4 of the
  pixels); ``fit_slic``, ``compress`` and ``fit_superpixel``;
- the pixel and superpixel routes of the port's CPU engine against the
  JAX CPU engine: labels and per-request iteration counts equal, centers
  within rtol 1e-5 / atol 1e-4, the per-route counters equal.

The CUDA kernels are held against these plain versions on the card by
``chip_smoke.py`` (phase 6) and ``tests/test_torch_cuda.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batched as JB
from repro.core import solver as JS
from repro.core import vector_fcm as JV
from repro.core.fcm import FCMConfig as JFCMConfig
from repro.data import phantom
from repro.kernels import fcm_resident as JKR
from repro.kernels import ops as jops
from repro.serving.fcm_engine import FCMServeEngine as JAXEngine
from repro.superpixel import pipeline as JSX
from repro.superpixel import slic as JSL
from repro_torch import convert
from repro_torch.configs import fcm_brainweb
from repro_torch.core import batched as TB
from repro_torch.core import solver as TS
from repro_torch.core import vector_fcm as TV
from repro_torch.kernels import fcm_resident as KR
from repro_torch.kernels import ops as tops
from repro_torch.kernels import slic_assign as KS
from repro_torch.serving import FCMServeEngine
from repro_torch.superpixel import pipeline as TSX
from repro_torch.superpixel import slic as TSL

RTOL, ATOL = 1e-5, 1e-4
CPU = torch.device("cpu")
#: the near-tie bar for SLIC labels that differ
TIE_RTOL, TIE_SHARE = 1e-6, 1e-4
#: the shapes of tests/test_slic_kernel.py: (H, W, n_segments)
SLIC_SHAPES = [(64, 128, 48), (37, 61, 12), (16, 300, 30), (129, 131, 100),
               (200, 40, 20)]
#: the JAX reference's center update, compiled once a shape (its sums
#: are exact on these integral images, compiled or not). Its assignment
#: runs op by op, as the JAX package's own tests call it: compiled, XLA
#: rounds the distances otherwise and breaks exact float32 ties (three
#: pixels of the 129x131 case) the other way.
_jax_update = jax.jit(JSL.update_centers)


def _blobs(b, k, d, seed, c=4):
    """Rows around ``c`` well-separated means per lane, with weights: a
    clustered payload converges in tens of iterations (uniform noise
    takes hundreds, each amplifying rounding)."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(0, 255, (b, c, d))
    pick = rng.integers(0, c, (b, k))
    feats = (np.take_along_axis(means, pick[..., None], axis=1)
             + rng.normal(0, 6, (b, k, d))).astype(np.float32)
    w = rng.uniform(0.5, 4.0, (b, k)).astype(np.float32)
    return feats, w


def _init(feats, w, eps=5e-3, c=4):
    x, wt = torch.from_numpy(feats), torch.from_numpy(w)
    lo, hi = TS.weighted_support(x, wt)
    v0 = TS.linspace_from_support(lo, hi, c).contiguous()
    tol = TS._tol_from_range((hi - lo).max(dim=1).values, eps).contiguous()
    return x, wt, v0, tol


def _assert_centers(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# The HBM-streamed whole-solve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [300, 1000])
@pytest.mark.parametrize("d", [1, 3])
def test_streamed_plain_matches_pallas(k, d):
    feats, w = _blobs(2, k, d, seed=k + d)
    x, wt, v0, tol = _init(feats, w)
    x4, w3 = jops.tile_rows_batched(jnp.asarray(feats), jnp.asarray(w),
                                    rows_multiple=JKR.STREAM_CHUNK_ROWS)
    jv, _, jit = JKR.resident_streamed_solve_pallas(
        x4, w3, jnp.asarray(v0.numpy()), jnp.asarray(tol.numpy()), 2.0, 300,
        interpret=True)
    before = KR.resident_streamed_solve.launches
    tv, _, tit = KR.resident_streamed_solve(x, wt, v0, tol, 2.0, 300)
    assert KR.resident_streamed_solve.launches == before   # CPU: plain
    np.testing.assert_array_equal(tit.numpy(), np.asarray(jit))
    _assert_centers(tv.numpy(), jv)


def test_streamed_solve_refuses_what_its_contract_excludes():
    with pytest.raises(ValueError, match="shape mismatch"):
        KR.resident_streamed_solve(torch.zeros((1, 5, 2)), torch.ones(1, 5),
                                   torch.zeros((1, 4, 3)), torch.ones(1),
                                   2.0, 10)
    with pytest.raises(ValueError):
        KR.resident_streamed_solve(torch.zeros((5, 2)), torch.ones(5),
                                   torch.zeros((4, 2)), torch.ones(1),
                                   2.0, 10)


def test_solve_batched_resident_past_the_row_bound_matches_jax():
    feats, w = _blobs(2, 1500, 2, seed=5)
    got = TS.solve_batched(TS.batch_problems(feats, w, device=CPU),
                           backend="resident")
    want = JS.solve_batched(JS.batch_problems(jnp.asarray(feats),
                                              jnp.asarray(w)),
                            backend="resident", interpret=True)
    np.testing.assert_array_equal(got.n_iters, want.n_iters)
    _assert_centers(got.centers.numpy(), want.centers)
    # one lane through solve(): vector_problem, routed by size
    one = TS.solve(TS.vector_problem(feats[0], w[0], device=CPU),
                   backend="resident")
    jone = JS.solve(JS.vector_problem(feats[0], w[0]), backend="resident",
                    interpret=True)
    assert one.n_iters == jone.n_iters == int(want.n_iters[0])
    _assert_centers(one.centers.numpy(), jone.centers)
    np.testing.assert_array_equal(one.labels.numpy(), np.asarray(jone.labels))


def test_dispatch_on_cuda_by_lane_size():
    pick = tops.select_step
    assert pick("flat", platform="cuda", batched=True, n_rows=1024,
                c=4).name == "resident"
    assert pick("flat", platform="cuda", batched=True, n_rows=39277,
                c=4).name == "resident_streamed"
    assert pick("flat", platform="cuda", batched=True, n_rows=600, c=4,
                n_feat=16).name == "resident_streamed"
    big = KR.STREAM_MAX_ROWS + 1
    assert pick("flat", platform="cuda", n_rows=big, c=4).name == "fused"
    # past the streamed bound, batched lanes take the batched fused kernel
    assert pick("flat", platform="cuda", batched=True, n_rows=big,
                c=4).name == "fused_batched"
    # named off the card, the streamed solve walks resident -> reference
    assert pick("flat", prefer="resident_streamed", platform="cpu",
                batched=True, n_rows=39277, c=4).name == "reference"
    # backend="resident" routes by size
    p = TS.pixel_problem(np.zeros(5000, np.float32), device=CPU)
    assert TS._select_impl(p, "resident") == "reference"
    assert tops.step_impl("flat", "resident_streamed").fallback == "resident"


def test_vector_labels_have_no_kernel_and_run_plain_on_the_card():
    """Satellite repair: vector rows no longer make labelling raise on
    the card; scalar rows keep the labels kernel."""
    assert tops.select_step("labels", platform="cuda",
                            n_feat=3).name == "reference"
    assert tops.select_step("labels", platform="cuda").name == "cuda"
    x = np.random.default_rng(0).uniform(0, 255, (50, 3)).astype(np.float32)
    r = TS.solve(TS.pixel_problem(x, device=CPU))
    want = JS.solve(JS.pixel_problem(x))
    np.testing.assert_array_equal(r.labels.numpy(), np.asarray(want.labels))


# ---------------------------------------------------------------------------
# SLIC
# ---------------------------------------------------------------------------

def _slic_img(h, w, channels, seed):
    if channels == 1:
        return phantom.phantom_slice(h, w, seed=seed)[0].astype(np.float32)
    img, _ = phantom.phantom_slice_rgb(h, w, seed=seed)
    return img.astype(np.float32)[:, :, :channels]


def _assert_labels_or_near_ties(got, want, img, centers, gy, gx, sw):
    """Equal labels, except pixels whose two candidate distances,
    recomputed in float64, are within TIE_RTOL: at most TIE_SHARE of
    the pixels."""
    got, want = np.asarray(got), np.asarray(want)
    img = img.reshape(img.shape[0], img.shape[1], -1).astype(np.float64)
    cen = np.asarray(centers, np.float64)
    d = img.shape[-1]
    ys, xs = np.nonzero(got != want)
    assert len(ys) <= TIE_SHARE * got.size, len(ys)
    for y, x in zip(ys, xs):
        def dist(k):
            return (((img[y, x] - cen[k, :d]) ** 2).sum()
                    + sw * ((y - cen[k, d]) ** 2 + (x - cen[k, d + 1]) ** 2))
        a, b = dist(got[y, x]), dist(want[y, x])
        assert abs(a - b) <= TIE_RTOL * max(a, b), (y, x, a, b)


@pytest.mark.parametrize("h,w,segs", SLIC_SHAPES)
@pytest.mark.parametrize("channels", [1, 3])
def test_assign_ref_matches_jax(h, w, segs, channels):
    img = _slic_img(h, w, channels, seed=h + w + channels)
    gy, gx = TSL.grid_shape(h, w, segs)
    assert (gy, gx) == JSL.grid_shape(h, w, segs)
    sw = TSL.spatial_weight(h, w, gy, gx, 10.0)
    jc = JSL.seed_centers(img, gy, gx)
    tc = TSL.seed_centers(torch.from_numpy(img), gy, gx)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    for _ in range(2):                     # on the seed grid, then drifted
        want = JSL.assign_ref(img, jc, gy, gx, sw)
        got = KS.slic_assign(torch.from_numpy(img.reshape(h, w, -1)),
                             torch.tensor(np.asarray(jc)), gy, gx, sw)
        assert got.dtype == torch.int32 and got.shape == (h, w)
        _assert_labels_or_near_ties(got.numpy(), want, img, jc, gy, gx, sw)
        jc, _ = _jax_update(img, want, jc)


@pytest.mark.parametrize("fractional", [False, True])
def test_update_centers_matches_jax(fractional):
    """Bit-equal sums: exact on integral features, and in the JAX
    scatter-add's order on fractional ones."""
    img = _slic_img(37, 61, 3, seed=2)
    if fractional:
        img = img + np.random.default_rng(2).uniform(
            0, 1, img.shape).astype(np.float32)
    gy, gx = TSL.grid_shape(37, 61, 12)
    sw = TSL.spatial_weight(37, 61, gy, gx, 10.0)
    jc = JSL.seed_centers(img, gy, gx)
    lab = JSL.assign_ref(img, jc, gy, gx, sw)
    want, wcnt = JSL.update_centers(img, lab, jc)
    got, cnt = TSL.update_centers(torch.from_numpy(img),
                                  torch.tensor(np.asarray(lab)),
                                  torch.tensor(np.asarray(jc)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(wcnt))


@pytest.mark.parametrize("channels", [1, 3])
def test_fit_slic_compress_and_fit_superpixel_match_jax(channels):
    img = _slic_img(64, 128, channels, seed=3)
    params = JSL.SLICParams(n_segments=64)
    jr = JSL.fit_slic(img, params)
    tr = TSL.fit_slic(img, TSL.SLICParams(n_segments=64), device=CPU)
    assert tr.n_iters == jr.n_iters and (tr.gy, tr.gx) == (jr.gy, jr.gx)
    np.testing.assert_array_equal(tr.labels.numpy(), np.asarray(jr.labels))
    np.testing.assert_array_equal(tr.counts.numpy(), np.asarray(jr.counts))
    _assert_centers(tr.centers.numpy(), jr.centers)

    jcfg = JSX.SuperpixelFCMConfig(n_segments=64)
    tcfg = convert.config_from_numpy(dataclasses.asdict(jcfg))
    assert isinstance(tcfg, TSX.SuperpixelFCMConfig)
    jcomp = JSX.compress(img, jcfg)
    tcomp = TSX.compress(img, tcfg, device=CPU)
    assert tcomp.slic_iters == jcomp.slic_iters
    np.testing.assert_array_equal(tcomp.label_map.numpy(),
                                  np.asarray(jcomp.label_map))
    _assert_centers(tcomp.features.numpy(), jcomp.features)
    jseg, _ = JSX.fit_superpixel(img, jcfg, comp=jcomp)
    tseg, _ = TSX.fit_superpixel(img, tcfg, comp=tcomp)
    assert tseg.n_iters == jseg.n_iters
    _assert_centers(tseg.centers.numpy(), jseg.centers)
    np.testing.assert_array_equal(tseg.labels.numpy(),
                                  np.asarray(jseg.labels))
    np.testing.assert_array_equal(
        TSX.broadcast_labels(torch.tensor([3, 1]),
                             torch.tensor([[0, 1], [1, 1]])).numpy(),
        np.asarray(JSX.broadcast_labels(jnp.asarray([3, 1]),
                                        jnp.asarray([[0, 1], [1, 1]]))))


def test_vector_helpers_and_histograms_match_jax():
    feats, w = _blobs(1, 200, 3, seed=9)
    f, wt = feats[0], w[0]
    v = np.asarray(JV.weighted_linspace_centers(jnp.asarray(f),
                                                jnp.asarray(wt), 4))
    tv = TV.weighted_linspace_centers(torch.from_numpy(f),
                                      torch.from_numpy(wt), 4)
    np.testing.assert_array_equal(tv.numpy(), v)
    for a, b in zip(TV.weighted_support(torch.from_numpy(f),
                                        torch.from_numpy(wt)),
                    JV.weighted_support(jnp.asarray(f), jnp.asarray(wt))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _assert_centers(
        TV.weighted_vector_center_step(torch.from_numpy(f),
                                       torch.from_numpy(wt),
                                       torch.from_numpy(v), 2.0).numpy(),
        JV.weighted_vector_center_step(jnp.asarray(f), jnp.asarray(wt),
                                       jnp.asarray(v), 2.0))
    imgs = [phantom.phantom_slice(30, 20 + i, seed=i)[0] for i in range(3)]
    np.testing.assert_array_equal(
        TB.histograms_of(imgs, device=CPU).numpy(),
        np.asarray(JB.histograms_of(imgs)))
    job = fcm_brainweb.make_config()
    from repro.configs import fcm_brainweb as jbw
    assert dataclasses.asdict(job.superpixel) == dataclasses.asdict(
        jbw.make_config().superpixel)


# ---------------------------------------------------------------------------
# The engine's pixel and superpixel routes
# ---------------------------------------------------------------------------

ROUTE_COUNTERS = tuple(f"{r}_{k}" for r in ("pixel", "superpixel")
                       for k in ("batches", "batched_images",
                                 "padded_lanes", "iters"))


def _engines(**kw):
    cfg = fcm_brainweb.make_config().fcm
    jcfg = JFCMConfig(n_clusters=cfg.n_clusters, m=cfg.m, eps=cfg.eps,
                      max_iters=cfg.max_iters)
    return (JAXEngine(jcfg, batch_sizes=(1, 8), cache_size=0, **kw),
            FCMServeEngine(cfg, batch_sizes=(1, 8), cache_size=0,
                           device=CPU, **kw))


def _assert_same(jres, tres, method):
    assert [r.request_id for r in jres] == [r.request_id for r in tres]
    for j, t in zip(jres, tres):
        assert t.method == method
        assert t.n_iters == j.n_iters
        assert t.converged == j.converged
        _assert_centers(t.centers, j.centers)
        np.testing.assert_array_equal(t.labels, np.asarray(j.labels))


def test_pixel_and_superpixel_routes_match_the_jax_engine():
    grey = [phantom.phantom_slice(48, 40, slice_pos=p, seed=i)[0]
            for i, p in enumerate((0.3, 0.5, 0.6))]
    rgb = [phantom.phantom_slice_rgb(40, 36, seed=i)[0] for i in range(2)]
    jeng, teng = _engines()
    # scalar and 3-channel payloads, two shapes, in one flush
    pixel = grey + rgb + [grey[0].astype(np.float32)]
    _assert_same(jeng.segment(pixel, method="pixel"),
                 teng.segment(pixel, method="pixel"), "pixel")
    sp = rgb + [grey[1]]
    _assert_same(jeng.segment(sp, method="superpixel"),
                 teng.segment(sp, method="superpixel"), "superpixel")
    js, ts = jeng.stats(), teng.stats()
    for k in ROUTE_COUNTERS + ("requests",):
        assert ts[k] == js[k], k
    assert ts["superpixel_batches"] == 2 and ts["pixel_batches"] == 2
    assert ts["superpixel_compress_seconds"] > 0.0
    assert ts["pixel_compress_seconds"] == 0.0
    assert ts["method_requests"] == {"histogram": 0, "pixel": 6,
                                     "spatial": 0, "superpixel": 3}
    trace = teng.tracer.traces()[-1]
    assert [c["name"] for c in trace["children"][0]["children"]] == \
        ["build", "solve", "materialize"]


def test_route_ingest_rejects_what_jax_rejects():
    jeng, teng = _engines()
    for bad, method in ((np.zeros((4, 4, 17), np.uint8), "pixel"),
                        (np.zeros((2, 4, 4, 3), np.uint8), "pixel"),
                        (np.zeros(16, np.uint8), "superpixel")):
        with pytest.raises(ValueError):
            jeng.submit(bad, method=method)
        with pytest.raises(ValueError):
            teng.submit(bad, method=method)
    assert teng.submit(np.zeros((4, 4), np.uint8), method="pixel") == 0


def test_pixel_ingest_message_names_the_volume_routes():
    """A (D, H, W) volume sent to the pixel route is refused with the
    JAX package's message: both routes that take volumes."""
    jeng, teng = _engines()
    vol = np.zeros((4, 8, 40), np.uint8)
    with pytest.raises(ValueError) as jerr:
        jeng.submit(vol, method="pixel")
    with pytest.raises(ValueError, match="'histogram' or 'spatial'") as terr:
        teng.submit(vol, method="pixel")
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# Lanes past the whole-solve kernels' bounds: the batched fused step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_rows,c,d", [
    (256, 9, 1), (256, 32, 1), (KR.STREAM_MAX_ROWS + 1, 4, 1),
    (600, 4, 24), (KR.STREAM_MAX_ROWS + 1, 12, 3)])
def test_batched_flat_lanes_past_the_bounds_pick_the_fused_kernel(
        n_rows, c, d):
    """On the card every batched flat lane with c <= 32 selects a kernel,
    whatever its rows and D; the JAX package runs its reference there."""
    assert tops.select_step("flat", platform="cuda", batched=True,
                            n_rows=n_rows, c=c,
                            n_feat=d).name == "fused_batched"
    assert tops.select_step("flat", platform="cpu", batched=True,
                            n_rows=n_rows, c=c,
                            n_feat=d).name == "reference"
    assert jops.select_step("flat", platform="tpu", batched=True,
                            n_rows=n_rows, c=c,
                            n_feat=d).name == "reference"


def test_batched_flat_lanes_past_32_clusters_still_raise():
    with pytest.raises(ValueError, match="c <= 32"):
        tops.select_step("flat", platform="cuda", batched=True, n_rows=256,
                         c=33)


@pytest.mark.parametrize("b,k,d,c,m", [(3, 300, 1, 12, 2.0),
                                       (2, 257, 5, 9, 2.5)])
def test_batched_fused_plain_matches_jax_fused_partials(b, k, d, c, m):
    """The batched kernel's plain version against the JAX package's
    fused-partials oracle, lane by lane."""
    from repro.kernels import ref as jref
    from repro_torch.kernels import fcm_centers as KC
    rng = np.random.default_rng(b * k + d)
    x = rng.uniform(0, 255, (b, k, d)).astype(np.float32)
    w = rng.uniform(0.5, 3.0, (b, k)).astype(np.float32)
    v = rng.uniform(0, 255, (b, c, d)).astype(np.float32)
    num, den = KC.fused_partials_batched(torch.from_numpy(x),
                                         torch.from_numpy(w),
                                         torch.from_numpy(v), m)
    for lane in range(b):
        xl = x[lane, :, 0] if d == 1 else x[lane]
        vl = v[lane, :, 0] if d == 1 else v[lane]
        u = jref.membership_ref(xl, vl, m)
        jnum, jden = jref.center_partials_ref(xl, u, m, w[lane])
        np.testing.assert_allclose(num[lane].numpy().reshape(np.shape(jnum)),
                                   np.asarray(jnum), rtol=1e-5)
        np.testing.assert_allclose(den[lane].numpy(), np.asarray(jden),
                                   rtol=1e-5)


def test_fused_batched_solve_matches_jax_solve_batched():
    """The looped batched solve with the batched fused step (its plain
    version on the CPU) against the JAX package's batched reference:
    c = 12, past every whole-solve kernel's cluster bound."""
    feats, w = _blobs(3, 400, 3, seed=11, c=12)
    v, delta, iters, _ = TS.flat_batched_solve(
        torch.from_numpy(feats), torch.from_numpy(w), 12, 2.0, 5e-3, 300,
        impl="fused_batched")
    want = JS.solve_batched(JS.batch_problems(feats, w, c=12),
                            eps=5e-3, max_iters=300)
    np.testing.assert_array_equal(iters.numpy(), want.n_iters)
    _assert_centers(v.numpy(), np.asarray(want.centers))


def test_pixel_route_with_12_clusters_matches_the_jax_engine():
    """c = 12, past the whole-solve kernels' c <= 8: served on the CPU
    as the JAX engine serves it (on the card by the batched fused
    kernel). The images hold 12 intensity or colour classes: with fewer
    classes than clusters, centers that split one class move apart
    slowly, and rounding of the row sums decides where they stop."""
    rng = np.random.default_rng(12)
    levels = np.linspace(8.0, 247.0, 12)
    grey = [np.clip(levels[rng.integers(0, 12, (40, 36))]
                    + rng.normal(0, 2, (40, 36)), 0, 255).astype(np.uint8)
            for _ in range(2)]
    rgb = [np.clip(_blobs(1, 36 * 32, 3, seed=20 + i, c=12)[0], 0,
                   255).reshape(36, 32, 3).astype(np.uint8)
           for i in range(2)]
    cfg = dataclasses.replace(fcm_brainweb.make_config().fcm, n_clusters=12,
                              max_iters=60)
    jcfg = JFCMConfig(n_clusters=12, m=cfg.m, eps=cfg.eps, max_iters=60)
    jeng = JAXEngine(jcfg, batch_sizes=(1, 8), cache_size=0)
    teng = FCMServeEngine(cfg, batch_sizes=(1, 8), cache_size=0, device=CPU)
    _assert_same(jeng.segment(grey + rgb, method="pixel"),
                 teng.segment(grey + rgb, method="pixel"), "pixel")
