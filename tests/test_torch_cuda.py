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
from repro_torch.kernels import fcm_centers as KC
from repro_torch.kernels import fcm_membership as KM
from repro_torch.kernels import fcm_resident as KR
from repro_torch.kernels import fcm_spatial as KSP
from repro_torch.kernels import fcm_stencil as KST
from repro_torch.kernels import histogram_bin as KB
from repro_torch.kernels import selective_scan as KSS
from repro_torch.kernels import slic_assign as KS
from repro_torch.serving import FCMServeEngine
from repro_torch.superpixel import slic as SL

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


def _bincount(arr, n_bins=256):
    return np.stack([np.bincount(np.clip(r.astype(np.int64), 0, n_bins - 1),
                                 minlength=n_bins) for r in arr]).astype(
        np.float32)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
@pytest.mark.parametrize("n", [1, 15, 16, 17, 4095, 20466, 39277, 200000])
@pytest.mark.parametrize("offset", [0, 1, 7, 15])
def test_binning_kernel_exact_at_any_alignment(dev, dtype, n, offset):
    """Three ragged lanes whose buffer starts ``offset`` pixels past a
    16-byte boundary (uint8: every lane start misaligned; int32 too past
    offset 0), one launch, exact against the plain version and
    np.bincount; int32 pixels out of range clip to the end bins. The
    lengths take one block a lane, a cluster of 2-8 (20466 and 39277
    uint8, 20466 and 39277 int32) and the last block's fold (200000)."""
    rng = np.random.default_rng(n + offset)
    lo, hi = (0, 256) if dtype == torch.uint8 else (-40, 300)
    arr = rng.integers(lo, hi, (3, n))
    arr[1, : n // 2] = 7                 # a long run of one value
    flat = torch.from_numpy(arr.reshape(-1)).to(dev, dtype)
    buf = torch.empty(offset + 3 * n, dtype=dtype, device=dev)
    buf[offset:] = flat
    px = buf[offset:].view(3, n)
    assert (px.data_ptr() % 16 == 0) == (offset == 0)
    before = KB.histogram_bin.launches
    got = KB.histogram_bin(px, 256)
    assert KB.histogram_bin.launches == before + 1
    assert torch.equal(got, KB.histogram_bin_plain(px, 256))
    np.testing.assert_array_equal(got.cpu().numpy(), _bincount(arr))
    assert torch.equal(KB.histogram_bin(px, 256), got)


@pytest.mark.parametrize("n_bins", [1, 5, 256, 1000, KB.MAX_BINS])
def test_binning_kernel_bins_other_than_256(dev, n_bins):
    """A lane of the 1000 KB image size (201 int32 blocks, folded by
    the last) and a short one, at bin counts that are not 256 and not a
    multiple of 4, and at the most bins."""
    rng = np.random.default_rng(n_bins)
    arr = rng.integers(-5, 1100, (2, 1_024_000)).astype(np.int32)
    arr[1, 100:] = 3
    px = torch.from_numpy(arr).to(dev)
    got = KB.histogram_bin(px, n_bins)
    assert torch.equal(got, KB.histogram_bin_plain(px, n_bins))
    np.testing.assert_array_equal(got.cpu().numpy(), _bincount(arr, n_bins))


@pytest.mark.parametrize("n", [100, 30_000])
@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
def test_binning_kernel_at_the_most_bins_on_short_lanes(dev, n, dtype):
    """MAX_BINS bins on lanes of one block and of one cluster (30 000
    int32 pixels are 6 blocks, uint8 2): the run form's 48 KB histogram
    beside the kernel's static shared memory."""
    rng = np.random.default_rng(n)
    arr = rng.integers(0, 256 if dtype == np.uint8 else 13_000,
                       (3, n)).astype(dtype)
    px = torch.from_numpy(arr).to(dev)
    assert KB.bin_blocks(n, px.element_size()) <= KB.MAX_CLUSTER
    got = KB.histogram_bin(px, KB.MAX_BINS)
    assert torch.equal(got, KB.histogram_bin_plain(px, KB.MAX_BINS))
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  _bincount(arr, KB.MAX_BINS))


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


def _hist_lanes(dev, n=6):
    """Phantom histograms (BrainWeb-size slices) plus an all-zero image,
    a single-valued image and two lone bins: x (B, 256, 1), w (B, 256)."""
    hists = KB.histogram_bin(torch.from_numpy(np.stack(
        [s.ravel() for s in _slices(n, 217, 181)])).to(dev), 256)
    extra = torch.zeros((3, 256), device=dev)
    extra[0, 0] = 4000.0
    extra[1, 77] = 1000.0
    extra[2, 10] = extra[2, 250] = 5.0
    w = torch.cat([hists, extra]).contiguous()
    x = torch.arange(256, dtype=torch.float32, device=dev).repeat(
        w.shape[0], 1)[..., None].contiguous()
    return x, w


def _solve_init(x, w, c):
    lo, hi = TS.weighted_support(x, w)
    v0 = TS.linspace_from_support(lo, hi, c).contiguous()
    tol = TS._tol_from_range((hi - lo).max(dim=1).values, 5e-3).contiguous()
    return v0, tol


def _vector_lanes(dev, b, k, d, c, seed):
    x = torch.from_numpy(_blobs(b, k, d, c, seed)).to(dev)
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.integers(0, 40, (b, k)).astype(
        np.float32)).to(dev)
    return x, w


@pytest.mark.parametrize("c,m,tier", [
    (4, 2.0, True),        # the plan: the tier
    (4, 2.0, False),       # the run-time body on the same rows
    (4, 2.5, False),
    (3, 2.0, False),
    (8, 2.0, False)])
def test_resident_forms_match_plain_on_histograms(dev, c, m, tier):
    """The tier and the run-time bodies against the plain version on
    phantom histograms and degenerate lanes: iteration counts equal,
    centers within rtol/atol, labels of every bin equal."""
    x, w = _hist_lanes(dev)
    v0, tol = _solve_init(x, w, c)
    plan = KR.ResidentPlan(tier, 1)
    before = KR.resident_solve.launches
    v, _, it = KR._launch_resident(x, w, v0, tol, m, 300, plan)
    assert KR.resident_solve.launches == before + 1
    pv, _, pit = KR.resident_solve_plain(x, w, v0, tol, m, 300)
    assert torch.equal(it, pit)
    np.testing.assert_allclose(v.cpu().numpy(), pv.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
    vals = x[..., 0].contiguous()
    assert torch.equal(KD.labels(vals, v[..., 0].contiguous()),
                       KD.labels(vals, pv[..., 0].contiguous()))


@pytest.mark.parametrize("b,k,d,c,m", [(3, 1024, 8, 8, 2.5),
                                       (3, 1024, 8, 8, 2.0),
                                       (2, 1000, 3, 8, 2.0),
                                       (2, 513, 2, 5, 2.0),
                                       (4, 300, 1, 4, 2.0),
                                       (2, 17, 1, 2, 2.5),
                                       (2, 1, 1, 1, 2.0)])
def test_resident_run_time_forms_match_plain_on_vector_rows(dev, b, k, d, c,
                                                            m):
    """Ragged clustered vector rows up to K = 1024, D = 8, c = 8 and
    m = 2.5 (the run-time bodies; K = 300, c = 4, D = 1 the tier), in
    the plan's form: iteration counts equal, centers within rtol/atol."""
    x, w = _vector_lanes(dev, b, k, d, c, seed=k + d)
    v0, tol = _solve_init(x, w, c)
    v, _, it = KR.resident_solve(x, w, v0, tol, m, 300)
    pv, _, pit = KR.resident_solve_plain(x, w, v0, tol, m, 300)
    assert torch.equal(it, pit)
    np.testing.assert_allclose(v.cpu().numpy(), pv.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["hist", "vectors"])
def test_resident_lane_bits_are_its_own_and_repeat(dev, case):
    """A lane's bits in its bucket equal that lane solved alone, and a
    second run repeats the first bit for bit."""
    if case == "hist":
        x, w = _hist_lanes(dev)
        c = 4
    else:
        x, w = _vector_lanes(dev, 4, 700, 3, 6, seed=9)
        c = 6
    v0, tol = _solve_init(x, w, c)
    got = KR.resident_solve(x, w, v0, tol, 2.0, 300)
    again = KR.resident_solve(x, w, v0, tol, 2.0, 300)
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    for i in (0, x.shape[0] - 1):
        alone = KR.resident_solve(x[i:i + 1].contiguous(),
                                  w[i:i + 1].contiguous(),
                                  v0[i:i + 1].contiguous(),
                                  tol[i:i + 1].contiguous(), 2.0, 300)
        for g, a in zip(got, alone):
            assert torch.equal(g[i:i + 1], a)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32, torch.float32])
@pytest.mark.parametrize("n", [1, 15, 16, 17, 255, 4097, 39277])
@pytest.mark.parametrize("offset", [0, 1, 3, 7, 15])
def test_labels_kernel_exact_at_any_length_and_offset(dev, dtype, n,
                                                      offset):
    """Three lanes whose buffer starts ``offset`` pixels past a 16-byte
    boundary (every lane's head, words and tail move), one launch, equal
    to the plain version; c = 4 with a tie, and c = 300 (table entries
    past one byte) and c = 1."""
    rng = np.random.default_rng(n + offset)
    hi = 256 if dtype == torch.uint8 else 300
    arr = rng.integers(0, hi, (3, n))
    flat = torch.from_numpy(arr.reshape(-1)).to(dev, dtype)
    if dtype == torch.float32:
        flat = flat + torch.from_numpy(rng.uniform(
            -0.5, 0.5, flat.shape[0]).astype(np.float32)).to(dev)
    buf = torch.empty(offset + 3 * n, dtype=dtype, device=dev)
    buf[offset:] = flat
    px = buf[offset:].view(3, n)
    assert (px.data_ptr() % 16 == 0) == (offset == 0)
    centers = [torch.tensor([[10.0, 10.0, 50.0, 130.5]] * 3, device=dev),
               torch.from_numpy(np.sort(rng.uniform(-5, 260, (3, 300)),
                                        axis=1).astype(np.float32)).to(dev),
               torch.tensor([[7.0], [8.0], [9.0]], device=dev)]
    for v in centers:
        before = KD.labels.launches
        got = KD.labels(px, v)
        assert KD.labels.launches == before + 1
        assert torch.equal(got, KD.labels_plain(px, v))


def test_cuda_tensors_never_take_the_plain_version(dev):
    with pytest.raises(TypeError):
        KB.histogram_bin(torch.zeros((1, 8), dtype=torch.int64,
                                     device=dev), 256)
    with pytest.raises(ValueError, match="resident_streamed"):
        KR.resident_solve(torch.zeros((1, 2000, 1), device=dev),
                          torch.ones((1, 2000), device=dev),
                          torch.zeros((1, 4, 1), device=dev),
                          torch.ones(1, device=dev), 2.0, 10)
    # past every whole-solve bound a batched lane now takes the batched
    # fused kernel, which itself refuses what no kernel holds (c > 32)
    from repro_torch.kernels import ops as tops
    assert tops.select_step("flat", platform=dev.type, batched=True,
                            n_rows=2000, c=12).name == "fused_batched"
    with pytest.raises(ValueError, match="c <= 32"):
        KC.fused_partials_batched(torch.zeros((1, 8, 2), device=dev),
                                  torch.ones((1, 8), device=dev),
                                  torch.zeros((1, 33, 2), device=dev), 2.0)


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


def _paper_pixels(dev, n=8193, c=4, seed=0):
    """Integer pixels and centers, one center on a pixel value (an exact
    zero distance)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, n).astype(np.float32)
    v = np.sort(rng.uniform(0, 255, c)).astype(np.float32)
    v[0] = x[0]
    return torch.from_numpy(x).to(dev), torch.from_numpy(v).to(dev)


@pytest.mark.parametrize("n,c,m", [(1, 2, 2.0), (8193, 4, 2.0),
                                   (8193, 8, 2.5), (70000, 32, 2.0)])
def test_membership_kernel_matches_plain(dev, n, c, m):
    x, v = _paper_pixels(dev, n, c, seed=n + c)
    before = KM.membership.launches
    got = KM.membership(x, v, m)
    assert KM.membership.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(),
                               KM.membership_plain(x, v, m).cpu().numpy(),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n,c,m,weighted", [(1, 2, 2.0, False),
                                            (8193, 4, 2.0, False),
                                            (300000, 8, 2.5, True),
                                            (255, 4, 2.0, False),
                                            (257, 4, 2.0, True),
                                            (4097, 4, 2.0, False),
                                            (4 * 1024 * 256 + 3, 4, 2.0,
                                             False),
                                            (16 * 1024 * 256 + 3, 32, 2.5,
                                             True)])
def test_center_partials_kernel_matches_plain(dev, n, c, m, weighted):
    x, v = _paper_pixels(dev, n, c, seed=n)
    u = KM.membership_plain(x, v, m).contiguous()
    w = (torch.arange(n, device=dev) % 7).to(torch.float32) if weighted \
        else None
    before = KC.center_partials.launches
    num, den = KC.center_partials(x, u, m, w)
    assert KC.center_partials.launches == before + 1
    pnum, pden = KC.center_partials_plain(x, u, m, w)
    np.testing.assert_allclose(num.cpu().numpy(), pnum.cpu().numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(den.cpu().numpy(), pden.cpu().numpy(),
                               rtol=1e-5)
    again = KC.center_partials(x, u, m, w)
    assert KC.center_partials.launches == before + 2
    assert torch.equal(again[0], num) and torch.equal(again[1], den)


@pytest.mark.parametrize("n", [8192, 8193])
def test_center_partials_bits_do_not_depend_on_alignment(dev, n):
    """x one float into its buffer takes scalar loads where an aligned
    copy takes 16-byte ones; the sums are added in one order either way."""
    x, v = _paper_pixels(dev, n, 4, seed=n)
    buf = torch.empty(n + 1, device=dev)
    buf[1:] = x
    u = KM.membership_plain(x, v, 2.0).contiguous()
    assert buf[1:].data_ptr() % 16 != 0
    got = KC.center_partials(buf[1:], u, 2.0)
    want = KC.center_partials(x, u, 2.0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n,c,m,weighted", [(1, 2, 2.0, False),
                                            (8193, 4, 2.0, False),
                                            (256, 4, 2.0, True),
                                            (300000, 8, 2.5, False)])
def test_fused_partials_kernel_matches_plain(dev, n, c, m, weighted):
    x, v = _paper_pixels(dev, n, c, seed=2 * n)
    w = (torch.arange(n, device=dev) % 5).to(torch.float32) if weighted \
        else None
    before = KC.fused_partials.launches
    num, den = KC.fused_partials(x, w, v, m)
    assert KC.fused_partials.launches == before + 1
    pnum, pden = KC.fused_partials_plain(x, w, v, m)
    np.testing.assert_allclose(num.cpu().numpy(), pnum.cpu().numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(den.cpu().numpy(), pden.cpu().numpy(),
                               rtol=1e-5)


#: rows of c squared distances through fcm::membership_from_d2 with and
#: without its one-reciprocal form; counts the rows whose memberships
#: differ in any bit and the rows that took the reciprocal
_QUOTIENT_CHECK = r"""
#include <stdint.h>
#include "fcm_common.cuh"

__device__ uint32_t mix(uint32_t x) {
  x ^= x >> 16; x *= 0x7feb352dU; x ^= x >> 15; x *= 0x846ca68bU;
  return x ^ (x >> 16);
}

template <int MAXC>
__global__ void check(int c, int mode, unsigned seed,
                      unsigned long long* counts) {
  uint32_t s = mix(seed ^ ((blockIdx.x * blockDim.x + threadIdx.x) *
                           0x9e3779b9U));
  const float x = (float)(mix(s) % 25600) / 100.f;
  float a[MAXC], b[MAXC];
  for (int j = 0; j < MAXC; ++j) {
    s = mix(s + j + 1);
    float d2;
    if (mode == 0) {  // image-like: centers in [0, 256)
      const float v = (float)(s % 2560000) / 10000.f;
      d2 = (v - x) * (v - x);
    } else {  // log-uniform over [2^-45, 2^61), past the form's 2^55
      d2 = exp2f(-45.f + 105.f * (float)(s & 0xffffff) / 16777216.f) *
           (1.f + (float)(mix(s) & 0xffff) / 65536.f);
    }
    a[j] = b[j] = j < c ? d2 : 0.f;
  }
  float dmin = b[0], dmax = b[0];
  for (int j = 1; j < c; ++j) {
    dmin = fminf(dmin, b[j]);
    dmax = fmaxf(dmax, b[j]);
  }
  fcm::membership_from_d2<MAXC, false>(c, true, -1.f, a);
  fcm::membership_from_d2<MAXC, true>(c, true, -1.f, b);
  bool differ = false;
  for (int j = 0; j < MAXC; ++j)
    differ |= __float_as_uint(a[j]) != __float_as_uint(b[j]);
  if (differ) atomicAdd(counts, 1ULL);
  if (dmin > 0.f && dmax <= 0x1p55f) atomicAdd(counts + 1, 1ULL);
}

extern "C" int quotient_check(int c, int mode, unsigned seed, int blocks,
                              unsigned long long* counts) {
  if (c <= 4) check<4><<<blocks, 256>>>(c, mode, seed, counts);
  else if (c <= 8) check<8><<<blocks, 256>>>(c, mode, seed, counts);
  else if (c <= 16) check<16><<<blocks, 256>>>(c, mode, seed, counts);
  else check<32><<<blocks, 256>>>(c, mode, seed, counts);
  return (int)cudaGetLastError();
}
"""


def test_one_reciprocal_membership_has_the_division_bits(dev):
    """The membership's c divisions by one sum through one reciprocal
    (fcm::quotient_by, taken by the fused partials at tiers 4 and 8) give
    the IEEE divisions' bits: 2^29 random rows, c = 2-32, image-like
    distances and log-uniform ones on both sides of the form's 2^55
    bound (the rows past it take the divisions)."""
    import ctypes
    import subprocess
    from repro_torch.kernels import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "quotient_check.cu"
    lib_path = _build.BUILD_DIR / "quotient_check.so"
    src.write_text(_QUOTIENT_CHECK)
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                          "-I", str(_build.CSRC), str(src), "-o",
                          str(lib_path)], capture_output=True, text=True)
    assert res.returncode == 0, res.stdout + res.stderr
    lib = ctypes.CDLL(str(lib_path))
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    blocks = 16384
    rows = 0
    for mode in (0, 1):
        for c in (2, 3, 4, 7, 8, 12, 16, 32):
            for rep in range(8):
                assert lib.quotient_check(c, mode, rep * 1000 + c * 10 + mode,
                                          blocks,
                                          ctypes.c_void_p(counts.data_ptr())
                                          ) == 0
                rows += blocks * 256
    differ, took = counts.tolist()
    print(f"one-reciprocal check: {rows} rows, {took} through the "
          f"reciprocal, {differ} differ")
    assert differ == 0
    assert rows // 2 < took < rows


@pytest.mark.parametrize("n,c,m,weighted", [(1, 4, 2.0, False),
                                            (8193, 4, 2.0, False),
                                            (8193, 4, 2.5, False),
                                            (1_024_000, 4, 2.0, False),
                                            (300000, 12, 2.0, False),
                                            (256, 4, 2.0, True),
                                            (70000, 32, 2.5, True)])
def test_fused_partials_one_launch_repeats_and_ignores_alignment(
        dev, n, c, m, weighted):
    """One launch a call, the same bits on a second call and on a copy of
    x one float off 16-byte alignment (scalar loads in place of vector
    ones; the sums are added in one order either way)."""
    x, v = _paper_pixels(dev, n, c, seed=3 * n + c)
    w = (torch.arange(n, device=dev) % 5).to(torch.float32) if weighted \
        else None
    before = KC.fused_partials.launches
    got = KC.fused_partials(x, w, v, m)
    again = KC.fused_partials(x, w, v, m)
    assert KC.fused_partials.launches == before + 2
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    buf = torch.empty(n + 1, device=dev)
    buf[1:] = x
    assert buf[1:].data_ptr() % 16 != 0
    off = KC.fused_partials(buf[1:], w, v, m)
    assert torch.equal(got[0], off[0]) and torch.equal(got[1], off[1])
    pnum, pden = KC.fused_partials_plain(x, w, v, m)
    np.testing.assert_allclose(got[0].cpu().numpy(), pnum.cpu().numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(got[1].cpu().numpy(), pden.cpu().numpy(),
                               rtol=1e-5)


@pytest.mark.parametrize("backend", ["auto", "fused", "staged"])
def test_paper_solve_on_the_card_matches_the_cpu(dev, backend):
    img, _ = phantom.phantom_of_bytes(60 * 1024)
    x = img.ravel()
    got = TS.solve(TS.pixel_problem(x, device=dev), backend=backend)
    want = TS.solve(TS.pixel_problem(x, device="cpu"), backend=backend)
    assert got.n_iters == want.n_iters
    np.testing.assert_allclose(got.centers.cpu().numpy(),
                               want.centers.numpy(), rtol=RTOL, atol=ATOL)
    assert torch.equal(got.labels.cpu(), want.labels)


def test_per_iteration_kernels_refuse_what_they_cannot_take(dev):
    with pytest.raises(ValueError, match="c <= 32"):
        KC.fused_partials(torch.zeros(8, device=dev), None,
                          torch.zeros(33, device=dev), 2.0)
    with pytest.raises(TypeError):
        KM.membership(torch.zeros(8, device=dev, dtype=torch.float64),
                      torch.zeros(4, device=dev, dtype=torch.float64), 2.0)
    with pytest.raises(ValueError, match="scalar"):
        TS.solve(TS.pixel_problem(torch.zeros((2000, 3)), device=dev),
                 backend="staged")


def _blobs(b, k, d, c, seed):
    rng = np.random.default_rng(seed)
    means = rng.uniform(0, 255, (b, c, d))
    pick = rng.integers(0, c, (b, k))
    return (np.take_along_axis(means, pick[..., None], axis=1)
            + rng.normal(0, 6, (b, k, d))).astype(np.float32)


@pytest.mark.parametrize("b,k,d,c,m", [(2, 1025, 1, 4, 2.0),
                                       (3, 4099, 3, 4, 2.0),
                                       (1, 70000, 1, 4, 2.0),
                                       (2, 3000, 16, 8, 2.5),
                                       # the 1000 KB image's rows
                                       (1, 1024000, 1, 4, 2.0),
                                       # one row past the most blocks a
                                       # lane takes (128 of 5120 rows)
                                       (1, 128 * 5120 + 1, 1, 4, 2.0),
                                       # more blocks than the card holds:
                                       # lanes taken in rounds
                                       (2000, 1100, 1, 4, 2.0)])
def test_streamed_kernel_matches_plain(dev, b, k, d, c, m):
    x = torch.from_numpy(_blobs(b, k, d, c, seed=k + d)).to(dev)
    w = torch.ones((b, k), device=dev)
    w[0, ::3] = 0.0                        # zero-weight rows are inert
    lo, hi = TS.weighted_support(x, w)
    v0 = TS.linspace_from_support(lo, hi, c).contiguous()
    tol = TS._tol_from_range((hi - lo).max(dim=1).values, 5e-3).contiguous()
    before = KR.resident_streamed_solve.launches
    v, _, it = KR.resident_streamed_solve(x, w, v0, tol, m, 300)
    assert KR.resident_streamed_solve.launches == before + 1
    pv, _, pit = KR.resident_streamed_solve_plain(x, w, v0, tol, m, 300)
    assert torch.equal(it, pit)
    np.testing.assert_allclose(v.cpu().numpy(), pv.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
    again = KR.resident_streamed_solve(x, w, v0, tol, m, 300)
    assert torch.equal(again[0], v) and torch.equal(again[2], it)


def test_streamed_lane_bits_are_its_own_in_a_bucket(dev):
    """The 1000 KB image's lane alone and as lane 0 of a bucket of three:
    the same blocks, slices and reduction order, so the same bits."""
    img = phantom.phantom_of_bytes(1000 * 1024)[0].reshape(-1)
    rng = np.random.default_rng(3)
    lanes = np.stack([img, img[::-1], np.clip(
        img + rng.normal(0, 3, img.shape), 0, 255)]).astype(np.float32)
    x = torch.from_numpy(lanes[..., None]).to(dev)
    w = torch.ones(x.shape[:2], device=dev)
    lo, hi = TS.weighted_support(x, w)
    v0 = TS.linspace_from_support(lo, hi, 4).contiguous()
    tol = TS._tol_from_range((hi - lo).max(dim=1).values, 5e-3).contiguous()
    v, delta, it = KR.resident_streamed_solve(x, w, v0, tol, 2.0, 300)
    v1, delta1, it1 = KR.resident_streamed_solve(
        x[:1].contiguous(), w[:1].contiguous(), v0[:1].contiguous(),
        tol[:1].contiguous(), 2.0, 300)
    assert torch.equal(v1[0], v[0]) and torch.equal(it1[0], it[0])
    assert torch.equal(delta1[0], delta[0])


@pytest.mark.parametrize("h,w,ch,segs", [(217, 181, 1, 256),
                                         (129, 131, 3, 100),
                                         (64, 300, 3, 48),
                                         (512, 512, 3, 256),
                                         (300, 64, 3, 48),
                                         (37, 61, 2, 20)])
def test_slic_kernel_equals_plain(dev, h, w, ch, segs):
    img = phantom.phantom_slice_rgb(h, w, seed=h)[0][:, :, :ch]
    img = torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(dev)
    gy, gx = SL.grid_shape(h, w, segs)
    sw = SL.spatial_weight(h, w, gy, gx, 10.0)
    cen = SL.seed_centers(img, gy, gx)
    for _ in range(2):                     # seed grid, then drifted
        before = KS.slic_assign.launches
        got = KS.slic_assign(img, cen.contiguous(), gy, gx, sw)
        assert KS.slic_assign.launches == before + 1
        want = SL.assign_ref(img, cen, gy, gx, sw)
        assert torch.equal(got, want)
        cen = SL.update_centers(img, want, cen)[0]


def test_vector_solve_on_the_card_labels_like_the_cpu(dev):
    x = _blobs(1, 3000, 3, 4, seed=1)[0]
    got = TS.solve(TS.pixel_problem(x, device=dev))
    want = TS.solve(TS.pixel_problem(x, device="cpu"))
    assert got.n_iters == want.n_iters
    np.testing.assert_allclose(got.centers.cpu().numpy(),
                               want.centers.numpy(), rtol=RTOL, atol=ATOL)
    assert torch.equal(got.labels.cpu(), want.labels)


@pytest.mark.parametrize("method", ["pixel", "superpixel"])
def test_routes_on_the_card_match_the_cpu_engine(dev, method):
    imgs = [phantom.phantom_slice_rgb(64, 64, seed=i)[0] for i in range(3)]
    imgs += _slices(3)
    gpu = FCMServeEngine(batch_sizes=(1, 8), cache_size=0, device=dev)
    cpu = FCMServeEngine(batch_sizes=(1, 8), cache_size=0, device="cpu")
    for g, c in zip(gpu.segment(imgs, method=method),
                    cpu.segment(imgs, method=method)):
        assert g.n_iters == c.n_iters
        np.testing.assert_array_equal(g.labels, c.labels)
        np.testing.assert_allclose(g.centers, c.centers, rtol=RTOL,
                                   atol=ATOL)


def test_streamed_lane_bits_do_not_depend_on_its_bucket(dev):
    """A BrainWeb-sized lane gives the same bits alone and in a bucket of
    64: its blocks and reduction order come from its rows alone."""
    x = torch.from_numpy(_blobs(64, 39277, 1, 4, seed=9)).to(dev)
    w = torch.ones((64, 39277), device=dev)
    lo, hi = TS.weighted_support(x, w)
    v0 = TS.linspace_from_support(lo, hi, 4).contiguous()
    tol = TS._tol_from_range((hi - lo).max(dim=1).values, 5e-3).contiguous()
    v, delta, it = KR.resident_streamed_solve(x, w, v0, tol, 2.0, 300)
    v1, delta1, it1 = KR.resident_streamed_solve(
        x[:1].contiguous(), w[:1].contiguous(), v0[:1].contiguous(),
        tol[:1].contiguous(), 2.0, 300)
    assert torch.equal(v1[0], v[0]) and torch.equal(delta1[0], delta[0])
    assert torch.equal(it1[0], it[0])


def test_fit_slic_repeats_bit_for_bit_on_fractional_features(dev):
    img = phantom.phantom_slice_rgb(217, 181, seed=4)[0].astype(np.float32)
    img += np.random.default_rng(4).uniform(0, 1, img.shape).astype(
        np.float32)
    params = SL.SLICParams(n_segments=256)
    a = SL.fit_slic(img, params, device=dev)
    b = SL.fit_slic(img, params, device=dev)
    assert a.n_iters == b.n_iters
    for x, y in ((a.labels, b.labels), (a.centers, b.centers),
                 (a.counts, b.counts)):
        assert torch.equal(x, y)
    host = SL.fit_slic(img, params, device="cpu")
    assert a.n_iters == host.n_iters
    np.testing.assert_allclose(a.centers.cpu().numpy(), host.centers.numpy(),
                               rtol=RTOL, atol=ATOL)


# -- the spatial (FCM_S) kernels -------------------------------------------

def _noisy_lanes(b, shape, seed):
    """``b`` noisy phantom slices or volumes of ``shape``, float32."""
    if len(shape) == 2:
        imgs = [phantom.noisy_phantom_slice(*shape, noise=12.0, impulse=0.05,
                                            seed=seed + i)[0]
                for i in range(b)]
    else:
        imgs = [phantom.noisy_phantom_volume(*shape, seed=seed + i)[0]
                for i in range(b)]
    return np.stack(imgs).astype(np.float32)


@pytest.mark.parametrize("shape,neighbors,alpha,m,c", [
    ((37, 61), 4, 1.0, 2.0, 4), ((37, 61), 8, 2.5, 1.6, 4),
    ((1, 300), 8, 1.0, 2.0, 4),
    # the 1000 KB image's shape, and a 2-D lane with no interior row
    ((4000, 256), 8, 1.0, 2.0, 4), ((2, 300), 8, 1.0, 2.0, 4),
    # the 2-D march's run-time-c, run-time-m body and its larger tiers
    ((37, 61), 8, 1.0, 2.0, 3), ((130, 33), 4, 1.0, 2.0, 6),
    ((37, 61), 8, 1.0, 2.0, 12), ((37, 61), 8, 2.5, 1.6, 12),
    ((130, 33), 8, 1.0, 2.0, 32), ((37, 61), 4, 1.0, 1.6, 32),
    ((5, 19, 23), 6, 1.0, 2.0, 4), ((5, 19, 23), 6, 0.0, 1.6, 4),
    ((37, 19, 23), 6, 1.0, 2.0, 4), ((70, 9, 33), 6, 2.5, 1.6, 4),
    ((1, 64, 64), 6, 1.0, 2.0, 4)])
def test_spatial_step_kernels_match_plain(dev, shape, neighbors, alpha, m,
                                          c):
    x = torch.from_numpy(_noisy_lanes(3, shape, seed=len(shape))).to(dev)
    v, _ = TS.stencil_lane_init(x, c, 5e-3)
    fn = KSP.spatial_partials_2d if len(shape) == 2 else KSP.spatial_partials_3d
    args = (neighbors,) if len(shape) == 2 else ()
    before = fn.launches
    num, den = fn(x, v, m, alpha, *args)
    assert fn.launches == before + 1
    pnum, pden = KSP.spatial_partials_plain(x, v, m, alpha, neighbors)
    np.testing.assert_allclose(num.cpu().numpy(), pnum.cpu().numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(den.cpu().numpy(), pden.cpu().numpy(),
                               rtol=1e-5)
    again = fn(x, v, m, alpha, *args)
    assert torch.equal(again[0], num) and torch.equal(again[1], den)


@pytest.mark.parametrize("shape", [(37, 19, 23), (70, 9, 33)])
def test_spatial_3d_lane_bits_do_not_depend_on_its_bucket(dev, shape):
    """A volume's partials are bit-equal alone and in a bucket of three:
    its runs and tiles come from its shape alone."""
    x = torch.from_numpy(_noisy_lanes(3, shape, seed=11)).to(dev)
    v, _ = TS.stencil_lane_init(x, 4, 5e-3)
    num, den = KSP.spatial_partials_3d(x, v, 2.0, 1.0)
    for i in range(3):
        n1, d1 = KSP.spatial_partials_3d(x[i:i + 1].contiguous(),
                                         v[i:i + 1].contiguous(), 2.0, 1.0)
        assert torch.equal(n1[0], num[i]) and torch.equal(d1[0], den[i])


@pytest.mark.parametrize("shape,neighbors,c,m", [
    ((37, 61), 8, 4, 2.0), ((217, 181), 4, 4, 2.0), ((130, 33), 8, 4, 2.0),
    # the run-time-c, run-time-m body and the larger tiers
    ((37, 61), 8, 3, 2.0), ((130, 33), 4, 6, 1.6), ((37, 61), 8, 12, 2.0),
    ((130, 33), 8, 32, 2.0)])
def test_spatial_2d_lane_bits_do_not_depend_on_its_bucket(dev, shape,
                                                          neighbors, c, m):
    """A 2-D lane's partials are bit-equal alone and in a bucket of three:
    its strips, runs and fold order come from its shape alone."""
    x = torch.from_numpy(_noisy_lanes(3, shape, seed=13)).to(dev)
    v, _ = TS.stencil_lane_init(x, c, 5e-3)
    num, den = KSP.spatial_partials_2d(x, v, m, 1.0, neighbors)
    for i in range(3):
        n1, d1 = KSP.spatial_partials_2d(x[i:i + 1].contiguous(),
                                         v[i:i + 1].contiguous(), m, 1.0,
                                         neighbors)
        assert torch.equal(n1[0], num[i]) and torch.equal(d1[0], den[i])


@pytest.mark.parametrize("shape,neighbors", [((37, 61), 8), ((64, 64), 4),
                                             ((8, 16, 16), 6)])
def test_stencil_whole_solve_matches_plain(dev, shape, neighbors):
    x = torch.from_numpy(_noisy_lanes(3, shape, seed=7)).to(dev)
    v0, tol = TS.stencil_lane_init(x, 4, 5e-3)
    before = KST.stencil_solve.launches
    v, _, it = KST.stencil_solve(x, v0, tol, 2.0, 1.0, neighbors, 300)
    assert KST.stencil_solve.launches == before + 1
    pv, _, pit = KST.stencil_solve_plain(x, v0, tol, 2.0, 1.0, neighbors, 300)
    assert torch.equal(it, pit)
    np.testing.assert_allclose(v.cpu().numpy(), pv.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
    again = KST.stencil_solve(x, v0, tol, 2.0, 1.0, neighbors, 300)
    assert torch.equal(again[0], v) and torch.equal(again[2], it)


def test_stencil_lane_bits_do_not_depend_on_its_bucket(dev):
    """A BrainWeb-sized slice gives the same bits alone and in a bucket of
    8: its cluster size and reduction order come from its pixels alone."""
    x = torch.from_numpy(_noisy_lanes(8, (217, 181), seed=3)).to(dev)
    v0, tol = TS.stencil_lane_init(x, 4, 5e-3)
    v, delta, it = KST.stencil_solve(x, v0, tol, 2.0, 1.0, 8, 300)
    v1, delta1, it1 = KST.stencil_solve(x[:1].contiguous(), v0[:1].contiguous(),
                                        tol[:1].contiguous(), 2.0, 1.0, 8, 300)
    assert torch.equal(v1[0], v[0]) and torch.equal(delta1[0], delta[0])
    assert torch.equal(it1[0], it[0])


@pytest.mark.parametrize("side", ["under", "past"])
def test_auto_takes_the_whole_solve_under_the_bound_only(dev, side):
    h = 64 if side == "under" else -(-(KST.STENCIL_MAX_PIXELS + 1) // 256)
    img = _noisy_lanes(1, (h, 256), seed=11)[0]
    counts = (KST.stencil_solve.launches, KSP.spatial_partials_2d.launches)
    got = TS.solve(TS.spatial_problem(img, alpha=1.0, neighbors=8,
                                      device=dev))
    used = (KST.stencil_solve.launches - counts[0],
            KSP.spatial_partials_2d.launches - counts[1])
    assert used == ((1, 0) if side == "under" else (0, got.n_iters))
    want = TS.solve(TS.spatial_problem(img, alpha=1.0, neighbors=8,
                                       device="cpu"))
    assert got.n_iters == want.n_iters
    np.testing.assert_allclose(got.centers.cpu().numpy(),
                               want.centers.numpy(), rtol=RTOL, atol=ATOL)


def test_spatial_route_on_the_card_matches_the_cpu_engine(dev):
    from repro_torch.core.spatial import SpatialFCMConfig
    imgs = list(_noisy_lanes(5, (64, 64), seed=20))
    imgs.append(_noisy_lanes(1, (8, 32, 32), seed=30)[0])
    scfg = SpatialFCMConfig(alpha=1.0, neighbors=8)
    gpu = FCMServeEngine(batch_sizes=(1, 8), cache_size=0, spatial_cfg=scfg,
                         device=dev)
    cpu = FCMServeEngine(batch_sizes=(1, 8), cache_size=0, spatial_cfg=scfg,
                         device="cpu")
    before = KST.stencil_solve.launches
    got = gpu.segment(imgs, method="spatial")
    assert KST.stencil_solve.launches == before + 2      # two buckets
    for g, c in zip(got, cpu.segment(imgs, method="spatial")):
        assert g.n_iters == c.n_iters
        np.testing.assert_array_equal(g.labels, c.labels)
        np.testing.assert_allclose(g.centers, c.centers, rtol=RTOL,
                                   atol=ATOL)


# -- lanes past the whole-solve bounds: the batched fused kernel ------------

@pytest.mark.parametrize("b,k,d,c,m", [(3, 5000, 1, 12, 2.0),
                                       (2, 3001, 3, 32, 2.0),
                                       (2, 777, 24, 9, 2.5),
                                       (1, (1 << 20) + 3, 1, 4, 2.0),
                                       # the pixel route's c = 12 bucket
                                       (16, 39277, 1, 12, 2.0),
                                       # the tails of a quad and a tile
                                       (3, 1, 1, 4, 2.0), (2, 255, 1, 12, 2.5),
                                       (2, 4097, 1, 4, 2.0),
                                       (3, 4097, 1, 7, 2.0),
                                       # centers at the edge of the 48 KB
                                       # a block has without opting in
                                       (2, 600, 768, 16, 2.0),
                                       (2, 600, 384, 32, 2.0),
                                       (1, 300, 3072, 4, 2.0)])
def test_batched_fused_kernel_matches_plain(dev, b, k, d, c, m):
    rng = np.random.default_rng(k + c)
    x = torch.from_numpy(_blobs(b, k, d, c, seed=k)).to(dev)
    w = torch.from_numpy(rng.uniform(0.5, 3, (b, k)).astype(
        np.float32)).to(dev)
    v = torch.from_numpy(rng.uniform(0, 255, (b, c, d)).astype(
        np.float32)).to(dev)
    before = KC.fused_partials_batched.launches
    num, den = KC.fused_partials_batched(x, w, v, m)
    assert KC.fused_partials_batched.launches == before + 1
    num2, den2 = KC.fused_partials_batched(x, w, v, m)
    assert torch.equal(num, num2) and torch.equal(den, den2)
    pn, pd = KC.fused_partials_batched_plain(x, w, v, m)
    np.testing.assert_allclose(num.cpu().numpy(), pn.cpu().numpy(),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(den.cpu().numpy(), pd.cpu().numpy(),
                               rtol=1e-5, atol=1e-6)


def test_twelve_cluster_pixel_route_on_the_card_matches_the_cpu(dev):
    """c = 12: past the whole-solve kernels, the pixel route's bucket runs
    the batched fused kernel once an iteration."""
    import dataclasses
    from repro_torch.core.fcm import FCMConfig
    rng = np.random.default_rng(12)
    levels = np.linspace(8.0, 247.0, 12)
    imgs = [np.clip(levels[rng.integers(0, 12, (64, 64))]
                    + rng.normal(0, 2, (64, 64)), 0, 255).astype(np.uint8)
            for _ in range(3)]
    cfg = FCMConfig(n_clusters=12)
    gpu = FCMServeEngine(cfg, batch_sizes=(1, 8), cache_size=0, device=dev)
    cpu = FCMServeEngine(cfg, batch_sizes=(1, 8), cache_size=0,
                         device="cpu")
    before = KC.fused_partials_batched.launches
    got = gpu.segment(imgs, method="pixel")
    assert KC.fused_partials_batched.launches - before == max(
        r.n_iters for r in got)
    for g, c in zip(got, cpu.segment(imgs, method="pixel")):
        assert g.n_iters == c.n_iters
        np.testing.assert_array_equal(g.labels, c.labels)
        np.testing.assert_allclose(g.centers, c.centers, rtol=RTOL,
                                   atol=ATOL)


# -- the selective scan -------------------------------------------------------

@pytest.mark.parametrize("b,s,di,ds", [(2, 128, 128, 4), (1, 100, 96, 16),
                                       (1, 512, 1024, 16), (3, 33, 5, 32)])
def test_selective_scan_kernel_matches_plain(dev, b, s, di, ds):
    rng = np.random.default_rng(s + di)
    mk = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.normal(0, 1, shape).astype(np.float32)).to(dev)
    u, bm, cm = mk(b, s, di), mk(b, s, ds), mk(b, s, ds)
    dt = torch.from_numpy(rng.uniform(1e-3, 0.1, (b, s, di)).astype(
        np.float32)).to(dev)
    a = -torch.from_numpy(rng.uniform(0.5, 4, (di, ds)).astype(
        np.float32)).to(dev)
    before = KSS.selective_scan.launches
    y = KSS.selective_scan(u, dt, bm, cm, a)
    assert KSS.selective_scan.launches == before + 1
    want = KSS.selective_scan_ref(u, dt, bm, cm, a)
    err = float((y - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), err


def _scan_inputs(b, s, di, ds, seed, dt_range=(1e-3, 0.1)):
    rng = np.random.default_rng(seed)
    f32 = lambda v: torch.from_numpy(v.astype(np.float32)).cuda()  # noqa
    return (f32(rng.normal(0, 1, (b, s, di))),
            f32(rng.uniform(*dt_range, (b, s, di))),
            f32(rng.normal(0, 1, (b, s, ds))), f32(rng.normal(0, 1, (b, s, ds))),
            -f32(rng.uniform(0.5, 4, (di, ds))))


@pytest.mark.parametrize("b,s,di,ds", [
    (1, 1, 64, 16),                  # S = 1: one chunk of one position
    (1, 20, 200, 4),                 # S under MIN_CHUNK: one chunk, L = S
    (1, 100, 96, 8),                 # S not a multiple of L: 4 chunks, last 4
    (2, 300, 130, 16),               # B = 2, ragged channels and chunks
    (1, 257, 64, 1), (1, 257, 64, 4), (1, 257, 64, 8), (1, 257, 64, 16),
    (1, 257, 64, 32), (2, 1000, 48, 5)])
def test_chunked_scan_matches_plain_and_repeats(dev, b, s, di, ds):
    ins = _scan_inputs(b, s, di, ds, seed=s * di + ds)
    before = KSS.selective_scan.launches
    y = KSS.selective_scan(*ins)
    assert KSS.selective_scan.launches == before + 1
    assert torch.equal(y, KSS.selective_scan(*ins))
    want = KSS.selective_scan_ref(*ins)
    err = float((y - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), err


def test_chunked_scan_where_the_decay_underflows_within_a_chunk(dev):
    """dt up to 40 against A down to -4: exp(dt A) reaches 0 inside a
    chunk and the carried-in state must vanish, not turn into NaN."""
    ins = _scan_inputs(2, 500, 96, 16, seed=5, dt_range=(0.5, 40.0))
    y = KSS.selective_scan(*ins)
    want = KSS.selective_scan_ref(*ins)
    assert torch.isfinite(y).all()
    err = float((y - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), err
    assert torch.equal(y, KSS.selective_scan(*ins))


@pytest.mark.parametrize("b,s,di,ds", [
    (2, 128, 128, 4),                # 4 chunks: the store after the carry
    (1, 100, 96, 8),                 # ragged: the last chunk holds 4
    (1, 24, 256, 16)])               # one chunk: the one launch stores it
def test_scan_end_state_matches_plain_and_keeps_y(dev, b, s, di, ds,
                                                   monkeypatch):
    """(y, h_S) against the plain recurrence; y bit-equal to a call
    without the state; one library call a wrapper call."""
    from repro_torch.kernels import _build
    lib = _build.library()
    real, calls = lib.selective_scan_f32, []
    monkeypatch.setattr(lib, "selective_scan_f32",
                        lambda *a: calls.append(a) or real(*a))
    ins = _scan_inputs(b, s, di, ds, seed=s + di + ds)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    assert (KSS.chunk_len(b, s, di, sm) == s) == (s == 24)
    before = KSS.selective_scan.launches
    y, h = KSS.selective_scan(*ins, return_state=True)
    assert KSS.selective_scan.launches == before + 1 and len(calls) == 1
    assert h.shape == (b, di, ds) and h.dtype == torch.float32
    assert torch.equal(y, KSS.selective_scan(*ins))
    assert len(calls) == 2 and calls[1][13] is None
    want_y, want_h = KSS.selective_scan_ref(*ins, return_state=True)
    err = float((y - want_y).abs().max())
    assert err <= 1e-4 * float(want_y.abs().max()), err
    err = float((h - want_h).abs().max())
    assert err <= 1e-4 * float(want_h.abs().max()), err


def test_reduced_jamba_serves_on_the_card_like_the_cpu(dev):
    """Prefill through the kernel's end state (7 scans a group), decode
    through the plain recurrence; tokens equal to the CPU engine's."""
    import dataclasses
    from repro_torch import configs as TC
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.models import lm as TLM
    from repro_torch.training import optimizer as TO
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(TC.get_config("jamba-v0.1-52b").reduced(),
                              mamba_pallas=True)
    params = TLM.init_params(0, cfg, device="cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 64))
    before = KSS.selective_scan.launches
    got = ServeEngine(cfg, TO.tree_map(lambda t: t.to(dev), params), 72,
                      2).generate(prompts, 8)
    assert KSS.selective_scan.launches - before == 7
    want = ServeEngine(cfg, params, 72, 2).generate(prompts, 8)
    np.testing.assert_array_equal(got, want)


def _fit_edge(w, neighbors=8):
    """Rows h of a (h, w) lane: the last on the chip, the first off it."""
    h = 1
    while KST.stencil_plan(1, h + 1, w, neighbors).form != KST.OFF_CHIP:
        h += 1
    return h, h + 1


@pytest.mark.parametrize("side", ["inside", "past"])
def test_stencil_lanes_at_the_onchip_fit(dev, side):
    inside, past = _fit_edge(512)
    h = inside if side == "inside" else past
    plan = KST.stencil_plan(1, h, 512, 8)
    assert (plan.form == KST.OFF_CHIP) == (side == "past")
    x = torch.from_numpy(_noisy_lanes(2, (h, 512), seed=h)).to(dev)
    v0, tol = TS.stencil_lane_init(x, 4, 5e-3)
    v, delta, it = KST.stencil_solve(x, v0, tol, 2.0, 1.0, 8, 300)
    pv, _, pit = KST.stencil_solve_plain(x, v0, tol, 2.0, 1.0, 8, 300)
    assert torch.equal(it, pit)
    np.testing.assert_allclose(v.cpu().numpy(), pv.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
    again = KST.stencil_solve(x, v0, tol, 2.0, 1.0, 8, 300)
    assert torch.equal(again[0], v) and torch.equal(again[1], delta)


@pytest.mark.parametrize("shape,neighbors,c,m", [
    ((5, 19, 23), 6, 4, 2.0), ((8, 64, 64), 6, 8, 1.6),
    ((217, 181), 8, 8, 1.6), ((37, 61), 4, 8, 1.6),
    ((512, 512), 8, 4, 2.0)])       # x on chip, x_eff recomputed
def test_stencil_forms_match_plain_and_lane_alone(dev, shape, neighbors, c,
                                                  m):
    x = torch.from_numpy(_noisy_lanes(3, shape, seed=len(shape) + c)).to(dev)
    v0, tol = TS.stencil_lane_init(x, c, 5e-3)
    v, delta, it = KST.stencil_solve(x, v0, tol, m, 1.0, neighbors, 300)
    pv, _, pit = KST.stencil_solve_plain(x, v0, tol, m, 1.0, neighbors, 300)
    assert torch.equal(it, pit)
    np.testing.assert_allclose(v.cpu().numpy(), pv.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
    v1, delta1, it1 = KST.stencil_solve(
        x[1:2].contiguous(), v0[1:2].contiguous(), tol[1:2].contiguous(), m,
        1.0, neighbors, 300)
    assert torch.equal(v1[0], v[1]) and torch.equal(delta1[0], delta[1])
    assert torch.equal(it1[0], it[1])


# -- buckets of more than 65535 lanes ---------------------------------------

def _tiny_bucket(b, shape, seed):
    """``b`` lanes of ``shape``, integers 0-255 as float32, and the last
    lane's values set apart from the rest."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (b,) + shape).astype(np.float32)
    x[-1] = np.arange(np.prod(shape)).reshape(shape) * 37.0 + 11.0
    return x


def _row_6b(x):
    w = torch.ones(x.shape[:2], device=x.device)
    v = torch.stack([x[:, 0, :] - 0.5, x[:, -1, :] + 0.25], dim=1)
    return KC.fused_partials_batched(x, w, v.contiguous(), 2.0)


def _row_7(x):
    w = torch.ones(x.shape[:2], device=x.device)
    lo, hi = TS.weighted_support(x, w)
    v0 = TS.linspace_from_support(lo, hi, 2).contiguous()
    tol = TS._tol_from_range((hi - lo).max(dim=1).values, 5e-3).contiguous()
    return KR.resident_streamed_solve(x, w, v0, tol, 2.0, 300)


def _row_8(x):
    v0, tol = TS.stencil_lane_init(x, 2, 5e-3)
    return KST.stencil_solve(x, v0, tol, 2.0, 1.0, 8, 300)


def _row_9(x):
    v, _ = TS.stencil_lane_init(x, 2, 5e-3)
    return KSP.spatial_partials_2d(x, v, 2.0, 1.0, 8)


def _row_10(x):
    v, _ = TS.stencil_lane_init(x, 2, 5e-3)
    return KSP.spatial_partials_3d(x, v, 2.0, 1.0)


def _row_1(x):
    return (KB.histogram_bin(x.reshape(x.shape[0], -1).to(torch.uint8),
                             256),)


def _row_2(x):
    w = torch.ones(x.shape[:2], device=x.device)
    v0, tol = _solve_init(x, w, 2)
    return KR.resident_solve(x, w, v0, tol, 2.0, 300)


def _row_3(x):
    v = torch.stack([x[:, 0, 0] + 0.5, x[:, -1, 0] - 0.25], dim=1)
    return (KD.labels(x.reshape(x.shape[0], -1), v.contiguous()),)


#: PERF.md row -> (call, its wrapper, a lane's shape, launches for 65 537
#: lanes: one a chunk of at most 65535 where the lanes sit on gridDim.y or z)
_PAST_65535 = {
    "1": (_row_1, KB.histogram_bin, (2, 1), 1),
    "2": (_row_2, KR.resident_solve, (2, 1), 1),
    "3": (_row_3, KD.labels, (2, 1), 1),
    "6b": (_row_6b, KC.fused_partials_batched, (2, 1), 1),
    "7": (_row_7, KR.resident_streamed_solve, (2, 1), 1),
    "8": (_row_8, KST.stencil_solve, (2, 2), 2),
    "9": (_row_9, KSP.spatial_partials_2d, (2, 2), 1),
    "10": (_row_10, KSP.spatial_partials_3d, (2, 2, 2), 2)}


@pytest.mark.parametrize("row", sorted(_PAST_65535))
def test_a_bucket_past_65535_lanes_gives_the_last_lane_its_own_bits(dev,
                                                                    row):
    """65 537 tiny lanes through each kernel whose lanes once sat on a
    grid axis capped at 65535, and the resident whole-solve: the last
    lane's results are bit-equal to that lane alone, and the launch count
    is one a chunk of lanes (one a call on a 1-D grid)."""
    call, fn, shape, launches = _PAST_65535[row]
    x = torch.from_numpy(_tiny_bucket(65537, shape, seed=len(shape))).to(dev)
    before = fn.launches
    got = call(x)
    assert fn.launches == before + launches
    alone = call(x[-1:].contiguous())
    for g, a in zip(got, alone):
        assert torch.equal(g[-1:], a)


# -- the mesh: one card named twice, and the launch guard (fault (k)) -----------

@pytest.mark.parametrize("route", ["histogram", "pixel", "spatial"])
def test_meshed_engine_on_one_card_named_twice_bit_equal(dev, route):
    """A mesh naming cuda:0 twice splits each bucket of 8 into two
    shards on the one card: the split, the two launches and the merge
    give exactly what a single-device engine gives."""
    from repro_torch.core import distributed as TD
    from repro_torch.core.fcm import FCMConfig
    imgs = _slices(11, 32, 32)
    mesh = TD.make_mesh((2,), ("data",), devices=["cuda:0", "cuda:0"])
    single = FCMServeEngine(FCMConfig(), batch_sizes=(1, 8), cache_size=0,
                            device=dev)
    meshed = FCMServeEngine(FCMConfig(), batch_sizes=(1, 8), cache_size=0,
                            device=dev, mesh=mesh)
    try:
        want = single.segment(imgs, method=route)
        got = meshed.segment(imgs, method=route)
    finally:
        single.shutdown()
        meshed.shutdown()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.centers, b.centers)
        assert a.n_iters == b.n_iters


def test_wrapper_launches_on_its_tensors_card_from_another_current_card(dev):
    """A thread whose current device is card 0 calls the kernels with
    tensors on card 1: each wrapper enters its tensors' card around the
    library call, so the launches land there (fault (k))."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: a launch on another card than the "
                    "current one cannot be made with one")
    import threading
    one = torch.device("cuda", 1)
    px = torch.from_numpy(np.stack([s.ravel() for s in _slices(3)])).to(one)
    out = {}

    def work():
        torch.cuda.set_device(0)
        hists = KB.histogram_bin(px, 256)
        v, _, _, _ = TS.flat_batched_solve(
            torch.arange(256.0, device=one).repeat(3, 1)[..., None]
            .contiguous(), hists, 4, 2.0, 5e-3, 300, impl="resident")
        out["labels"] = KD.labels(px, v[..., 0].contiguous())
        out["hists"] = hists
        torch.cuda.synchronize(one)

    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and "labels" in out
    assert torch.equal(out["hists"], KB.histogram_bin_plain(px.cpu(), 256)
                       .to(one))
    assert out["labels"].device == one
