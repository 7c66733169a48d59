"""The five FCM examples of the port (``examples/torch_*.py``) on the
CPU at reduced sizes, each against the JAX example's pipeline on the
same seeded input: labels equal up to near-ties (scalar routes: the two
labels' distances to the port's centers within NEAR_TIE in float64;
spatial and superpixel routes: at most TIE_SHARE of the pixels apart)
and every class's DSC within DSC_TOL."""
import importlib.util
import os

import numpy as np
import pytest

from repro.configs.fcm_brainweb import make_config as jax_job
from repro.core import fcm as JF
from repro.core import solver as JSV
from repro.data import phantom as JP
from repro.serving.fcm_engine import FCMServeEngine as JaxEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DSC_TOL = 0.01
NEAR_TIE = 1e-3
TIE_SHARE = 2e-3


def _example(name):
    path = os.path.join(ROOT, "examples", f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _scalar_labels_agree(got, want, x, centers, what):
    """Labels that differ must be float64 near-ties of ``x`` between the
    two labels' centers (the port's)."""
    got, want = np.asarray(got).ravel(), np.asarray(want).ravel()
    bad = np.nonzero(got != want)[0]
    if bad.size == 0:
        return
    x = np.asarray(x, np.float64).ravel()[bad]
    v = np.asarray(centers, np.float64).ravel()
    da, db = (x - v[got[bad]]) ** 2, (x - v[want[bad]]) ** 2
    assert np.all(np.abs(da - db) <= NEAR_TIE * np.maximum(
        np.maximum(da, db), 1.0)), (what, bad.size)


def _share_apart(got, want, what):
    share = float(np.mean(np.asarray(got).ravel() != np.asarray(want)
                          .ravel()))
    assert share <= TIE_SHARE, (what, share)


def _dsc_close(got, labels, centers, gt, what, means=None):
    if means is None:
        pred = JP.match_labels_to_classes(np.asarray(labels),
                                          np.asarray(centers))
    else:
        pred = JP.match_labels_to_means(np.asarray(labels),
                                        np.asarray(centers), means)
    want = JP.dice_per_class(pred.reshape(np.shape(gt)), gt)
    np.testing.assert_allclose(got, want, atol=DSC_TOL, err_msg=what)


def test_quickstart(tmp_path):
    out = _example("quickstart").main(["--device", "cpu", "--size", "64",
                                       "80", "--out", str(tmp_path)])
    img, gt = JP.phantom_slice(64, 80, slice_pos=0.5, seed=96)
    x = img.ravel().astype(np.float32)
    u0 = JF.update_membership(x, JF.linspace_centers(x, 4), 2.0)
    cfg = JF.FCMConfig()
    problem = JSV.pixel_problem(x, cfg)
    jax_runs = {"staged": JSV.solve(problem, cfg, backend="staged", u0=u0),
                "fused": JSV.solve(problem, cfg)}
    for tag, ref in jax_runs.items():
        got = out["results"][tag]
        assert got["n_iters"] == ref.n_iters, tag
        np.testing.assert_allclose(got["centers"], np.asarray(ref.centers),
                                   rtol=1e-5, atol=1e-4)
        _scalar_labels_agree(got["labels"], np.asarray(ref.labels), x,
                             got["centers"], tag)
        _dsc_close(got["dsc"], ref.labels, ref.centers, gt, tag)
    assert (tmp_path / "torch_segmented_fused.pgm").exists()


def test_segment_noisy(tmp_path):
    out = _example("segment_noisy").main(["--device", "cpu", "--size",
                                          "96", "80", "--out",
                                          str(tmp_path)])
    job = jax_job()
    sigma, impulse = job.noise_levels[-1]
    img, gt = JP.noisy_phantom_slice(96, 80, noise=sigma, impulse=impulse,
                                     seed=7)
    eng = JaxEngine(job.fcm, spatial_cfg=job.spatial)
    plain = eng.segment([img])[0]
    spatial = eng.segment([img], method="spatial")[0]
    got = out["results"]["plain-histogram"]
    assert got["n_iters"] == plain.n_iters
    _scalar_labels_agree(got["labels"], plain.labels, img,
                         got["centers"], "histogram")
    _dsc_close(got["dsc"], plain.labels, plain.centers, gt, "histogram")
    got = out["results"]["spatial-fcm_s"]
    assert got["n_iters"] == spatial.n_iters
    _share_apart(got["labels"], spatial.labels, "spatial")
    _dsc_close(got["dsc"], spatial.labels, spatial.centers, gt, "spatial")


def test_segment_volume(tmp_path):
    out = _example("segment_volume").main(["--device", "cpu", "--slices",
                                           "5", "--size", "64", "--out",
                                           str(tmp_path)])
    slices, gts = zip(*(JP.phantom_slice(64, 64,
                                         slice_pos=0.3 + 0.4 * z / 5,
                                         seed=z) for z in range(5)))
    x = np.stack(slices).ravel().astype(np.float32)
    cfg = JF.FCMConfig(max_iters=300)
    ref = JSV.solve(JSV.histogram_problem(x, cfg), cfg)
    labels = np.asarray(JF.labels_from_centers(x, ref.centers))
    assert out["n_iters"] == ref.n_iters
    np.testing.assert_allclose(out["centers"], np.asarray(ref.centers),
                               rtol=1e-5, atol=1e-4)
    _scalar_labels_agree(out["labels"], labels, x, out["centers"], "volume")
    _dsc_close(out["dsc"], labels, ref.centers, np.stack(gts), "volume")
    # the restart from the checkpointed centers: the JAX example's solve
    v0 = np.asarray(out["centers"], np.float32)
    ref2 = JSV.solve(JSV.pixel_problem(x, v0=v0), eps=cfg.eps, max_iters=50)
    assert out["restart"]["n_iters"] == ref2.n_iters
    _scalar_labels_agree(out["restart"]["labels"], np.asarray(ref2.labels),
                         x, out["restart"]["centers"], "restart")
    assert (tmp_path / "torch_fcm_centers.json").exists()


def test_segment_color(tmp_path):
    out = _example("segment_color").main(["--device", "cpu", "--size", "64",
                                          "--out", str(tmp_path)])
    job = jax_job()
    eng = JaxEngine(job.fcm, superpixel_cfg=job.superpixel)
    for name, means, (img, gt) in (
            ("rgb", JP.CLASS_MEANS_RGB,
             JP.phantom_slice_rgb(64, 64, noise=6.0, seed=7)),
            ("t1t2pd", JP.CLASS_MEANS_MULTI,
             JP.phantom_slice_channels(64, 64, noise=6.0, seed=7))):
        for tag in ("superpixel", "pixel"):
            ref = eng.segment([img], method=tag)[0]
            got = out[name][tag]
            what = f"{name} {tag}"
            _share_apart(got["labels"], ref.labels, what)
            _dsc_close(got["dsc"], ref.labels, ref.centers, gt, what,
                       means=means)


def test_serve_segmentation():
    out = _example("serve_segmentation").main(["--device", "cpu",
                                               "--slices", "10", "--size",
                                               "64"])
    job = jax_job()
    eng = JaxEngine(job.fcm, batch_sizes=job.serving_batch_sizes,
                    spatial_cfg=job.spatial)
    refs = eng.segment(out["images"])
    for i, (got, ref, img) in enumerate(zip(out["results"], refs,
                                            out["images"])):
        assert got.n_iters == ref.n_iters, i
        _scalar_labels_agree(got.labels, ref.labels, img, got.centers,
                             f"request {i}")
    sref = eng.segment(out["noisy"], method="spatial")
    for i, (got, ref) in enumerate(zip(out["spatial"], sref)):
        assert got.n_iters == ref.n_iters, i
        _share_apart(got.labels, ref.labels, f"spatial request {i}")
    assert min(out["min_dsc"]) > 0.80


@pytest.mark.parametrize("name", ["quickstart", "segment_noisy",
                                  "segment_volume", "segment_color",
                                  "serve_segmentation"])
def test_examples_raise_without_a_card_unless_asked(name):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main([])
