"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card and the CUDA toolkit; elsewhere it
skips. On the card run ``python -m pytest -q -m cuda
tests/test_torch_cuda.py``; ``chip_smoke.py`` makes the same checks at
the serving path's full shapes.
"""
import numpy as np
import pytest
import torch

from repro_torch.data import phantom
from repro_torch.core import solver as TS
from repro_torch.kernels import defuzzify as KD
from repro_torch.kernels import fcm_resident as KR
from repro_torch.kernels import histogram_bin as KB
from repro_torch.serving import FCMServeEngine

pytestmark = pytest.mark.cuda

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: kernel vs plain runs in chip_smoke.py")
    return torch.device("cuda")


def _slices(n, h=64, w=64):
    return [phantom.phantom_slice(h, w, slice_pos=float(s), seed=i)[0]
            for i, s in enumerate(np.linspace(0.3, 0.7, n))]


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
def test_binning_kernel_equals_plain(dev, dtype):
    px = torch.from_numpy(np.stack([s.ravel() for s in _slices(3)])).to(
        dev, dtype)
    before = KB.histogram_bin.launches
    got = KB.histogram_bin(px, 256)
    assert KB.histogram_bin.launches == before + 1
    assert torch.equal(got, KB.histogram_bin_plain(px, 256))


def test_whole_solve_kernel_matches_plain(dev):
    hists = KB.histogram_bin(torch.from_numpy(np.stack(
        [s.ravel() for s in _slices(4)])).to(dev), 256)
    feats = torch.arange(256, dtype=torch.float32, device=dev).repeat(
        4, 1)[..., None].contiguous()
    lo, hi = TS.weighted_support(feats, hists)
    v0 = TS.linspace_from_support(lo, hi, 4).contiguous()
    tol = TS._tol_from_range((hi - lo).max(dim=1).values, 5e-3)
    v, _, it = KR.resident_solve(feats, hists, v0, tol, 2.0, 300)
    pv, _, pit = KR.resident_solve_plain(feats, hists, v0, tol, 2.0, 300)
    assert torch.equal(it, pit)
    np.testing.assert_allclose(v.cpu().numpy(), pv.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


def test_labels_kernel_equals_plain(dev):
    px = torch.from_numpy(np.stack([s.ravel() for s in _slices(2)])).to(dev)
    v = torch.tensor([[0.5, 52.0, 106.0, 168.0], [3.0, 50.0, 50.0, 170.0]],
                     device=dev)
    assert torch.equal(KD.labels(px, v), KD.labels_plain(px, v))


def test_cuda_tensors_never_take_the_plain_version(dev):
    with pytest.raises(TypeError):
        KB.histogram_bin(torch.zeros((1, 8), dtype=torch.int64,
                                     device=dev), 256)
    with pytest.raises(ValueError, match="resident_streamed"):
        KR.resident_solve(torch.zeros((1, 2000, 1), device=dev),
                          torch.ones((1, 2000), device=dev),
                          torch.zeros((1, 4, 1), device=dev),
                          torch.ones(1, device=dev), 2.0, 10)


def test_engine_on_the_card_matches_the_cpu_engine(dev):
    imgs = _slices(9)
    gpu = FCMServeEngine(batch_sizes=(1, 8), cache_size=0, device=dev)
    cpu = FCMServeEngine(batch_sizes=(1, 8), cache_size=0, device="cpu")
    counts = (KB.histogram_bin.launches, KR.resident_solve.launches,
              KD.labels.launches)
    for g, c in zip(gpu.segment(imgs), cpu.segment(imgs)):
        assert g.n_iters == c.n_iters
        np.testing.assert_array_equal(g.labels, c.labels)
        np.testing.assert_allclose(g.centers, c.centers, rtol=RTOL,
                                   atol=ATOL)
    assert (KB.histogram_bin.launches, KR.resident_solve.launches,
            KD.labels.launches) == tuple(n + 2 for n in counts)
