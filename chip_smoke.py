#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, the CUDA toolkit (``nvcc``) and PyTorch built
for CUDA; it imports neither JAX nor the JAX package. Phases, in order
(any failure exits non-zero):

1. card: require CUDA, print the card's name and power limit;
2. build: compile every kernel under ``src/repro_torch/csrc`` for
   ``sm_90a`` and print the build time and ptxas' register report;
3. kernels: call each kernel's wrapper on tensors on the card at the
   serving path's shapes, hold the result against its plain PyTorch
   version on the same inputs, and time kernel, plain version and the
   library call computing the same function (where one exists);
4. engine: serve a 181-slice 217x181 phantom volume (BrainWeb's size)
   through ``FCMServeEngine`` with the launch counts set to 0 just
   before and read just after, hold labels and iteration counts against
   a CPU engine, check each class's DSC, the cache, and serve the
   paper's largest Table 3 image (1000 KB) at batch 1.

The line before the last is a JSON object listing every kernel of the
path; the last line is ``{"ok": true, "device": {...}}``.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: NVIDIA H100 SXM published peaks (data sheet): HBM3 bandwidth and
#: float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

#: Solve tolerance against the plain version: values run 0-255 and the
#: background center sits near 0, where rtol alone means nothing; the
#: kernel and the plain version sum the rows in different orders.
RTOL, ATOL = 1e-5, 1e-4

#: BrainWeb's volume: 181 axial slices of 217x181 voxels.
VOLUME = (181, 217, 181)
#: the paper's largest Table 3 image, 1000 KB at one byte a pixel
BIG_BYTES = 1000 * 1024


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def require(cond, msg):
    if not cond:
        fail(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=20, rounds=7):
    """Median over ``rounds`` of (CUDA-event time of ``reps`` back-to-back
    calls) / reps, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        per.append(start.elapsed_time(stop) / reps)
    return float(np.median(per))


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phantom_volume(n_slices, h, w, phantom):
    imgs, gts = [], []
    for z, pos in enumerate(np.linspace(0.3, 0.7, n_slices)):
        im, gt = phantom.phantom_slice(h, w, slice_pos=float(pos), seed=z)
        imgs.append(im)
        gts.append(gt)
    return imgs, gts


def check_binning(KB, vol_u8, big_u8, dev):
    rng = np.random.default_rng(7)
    cases = {
        "64x217*181 uint8": vol_u8,
        "1x1024000 uint8": big_u8,
        "64x217*181 int32": vol_u8.astype(np.int32),
        "3x1000 int32, out of range": rng.integers(
            -50, 400, (3, 1000)).astype(np.int32),
        "5x777 uint8, ragged": rng.integers(0, 256, (5, 777)).astype(
            np.uint8),
        "2x1 uint8": np.array([[0], [255]], np.uint8),
    }
    for name, arr in cases.items():
        px = torch.from_numpy(arr).to(dev)
        got = KB.histogram_bin(px, 256)
        torch.cuda.synchronize()
        want = KB.histogram_bin_plain(px, 256)
        ref = np.stack([np.bincount(np.clip(r.astype(np.int64), 0, 255),
                                    minlength=256) for r in arr])
        require(torch.equal(got, want),
                f"binning kernel != plain version on {name}")
        require(np.array_equal(got.cpu().numpy(), ref.astype(np.float32)),
                f"binning kernel != np.bincount on {name}")
        print(f"  bin   {name}: exact")
    px = torch.from_numpy(vol_u8).to(dev)
    b, n = px.shape
    flat = (px.to(torch.int64)
            + torch.arange(b, device=dev)[:, None] * 256).reshape(-1)
    ms = time_ms(lambda: KB.histogram_bin(px, 256))
    plain_ms = time_ms(lambda: KB.histogram_bin_plain(px, 256))
    lib_ms = time_ms(lambda: torch.bincount(flat, minlength=b * 256))
    bnd, by = bound_ms(b * n * 1 + b * 256 * 4, b * n)
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                bound_by=by, library_ms=lib_ms)


def check_solve(KR, SV, hists_np, dev):
    """Whole-solve kernel vs its plain version: the 64 phantom
    histograms plus degenerate lanes, random vector rows at the kernel's
    row bound, and m != 2."""
    k = 256
    zero_img = np.zeros(k, np.float32)
    zero_img[0] = 4000.0                      # all-zero image: one bin
    one_val = np.zeros(k, np.float32)
    one_val[77] = 1000.0                      # single-valued image
    two_val = np.zeros(k, np.float32)
    two_val[[10, 250]] = [5.0, 5.0]           # zero rows stretch nothing
    lanes = np.concatenate([hists_np, zero_img[None], one_val[None],
                            two_val[None]])
    # 3-D rows around 8 well-separated means: the vector payload the
    # kernel's row and cluster bounds admit (uniform noise with no
    # cluster structure converges over ~100 iterations, each amplifying
    # rounding, and says nothing about the kernel)
    rng = np.random.default_rng(11)
    means = rng.uniform(0, 255, (5, 8, 3))
    pick = rng.integers(0, 8, (5, KR.MAX_ROWS))
    blobs = (np.take_along_axis(means, pick[..., None], axis=1)
             + rng.normal(0, 6, (5, KR.MAX_ROWS, 3))).astype(np.float32)
    cases = [
        ("64 phantom histograms + 3 degenerate lanes",
         np.broadcast_to(np.arange(k, dtype=np.float32)[None, :, None],
                         (lanes.shape[0], k, 1)), lanes, 4, 2.0),
        ("5 lanes of 1024 clustered 3-D rows, c=8", blobs,
         rng.integers(0, 40, (5, KR.MAX_ROWS)).astype(np.float32), 8, 2.0),
        ("8 phantom histograms, m=2.5",
         np.broadcast_to(np.arange(k, dtype=np.float32)[None, :, None],
                         (8, k, 1)), hists_np[:8], 4, 2.5),
    ]
    worst = 0.0
    timing = None
    for name, feats, w, c, m in cases:
        x = torch.from_numpy(np.ascontiguousarray(feats)).to(dev)
        wt = torch.from_numpy(np.ascontiguousarray(w)).to(dev)
        lo, hi = SV.weighted_support(x, wt)
        v0 = SV.linspace_from_support(lo, hi, c).contiguous()
        tol = SV._tol_from_range((hi - lo).max(dim=1).values,
                                 5e-3).contiguous()
        v, delta, iters = KR.resident_solve(x, wt, v0, tol, m, 300)
        torch.cuda.synchronize()
        pv, pdelta, piters = KR.resident_solve_plain(x, wt, v0, tol, m, 300)
        v_np, pv_np = v.cpu().numpy(), pv.cpu().numpy()
        it_np, pit_np = iters.cpu().numpy(), piters.cpu().numpy()
        require(np.isfinite(v_np).all(), f"non-finite centers on {name}")
        if not np.array_equal(it_np, pit_np):
            bad = np.nonzero(it_np != pit_np)[0]
            margin = (pdelta.cpu().numpy() - tol.cpu().numpy())[bad]
            fail(f"iteration counts differ on {name}: lanes {bad.tolist()}"
                 f" kernel {it_np[bad].tolist()} plain "
                 f"{pit_np[bad].tolist()}, delta - tol {margin.tolist()}")
        np.testing.assert_allclose(v_np, pv_np, rtol=RTOL, atol=ATOL,
                                   err_msg=name)
        err = float(np.abs(v_np - pv_np).max())
        worst = max(worst, err)
        print(f"  solve {name}: iters equal (max {int(it_np.max())}), "
              f"max |dv| {err:.3g}")
        if timing is None:
            timing = (x, wt, v0, tol, m, it_np, c)
    x, wt, v0, tol, m, it_np, c = timing
    x, wt, v0, tol = x[:64].contiguous(), wt[:64].contiguous(), \
        v0[:64].contiguous(), tol[:64].contiguous()
    it_np = it_np[:64]
    ms = time_ms(lambda: KR.resident_solve(x, wt, v0, tol, m, 300))
    plain_ms = time_ms(lambda: KR.resident_solve_plain(x, wt, v0, tol, m,
                                                       300), reps=2,
                       rounds=5)
    b, kk, d = x.shape
    n_bytes = 4 * (b * kk * d + b * kk + 2 * b * c * d + 3 * b)
    # per row, center and iteration: d2 3D, floor, reciprocal, sum,
    # divide, square, weight, numerator 2D, denominator 1
    n_ops = int(it_np.sum()) * kk * c * (5 * d + 7)
    bnd, by = bound_ms(n_bytes, n_ops)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                bound_by=by, library_ms=None), int(it_np.max())


def check_labels(KD, vol_u8, centers, dev):
    px = torch.from_numpy(vol_u8).to(dev)
    v = torch.from_numpy(np.ascontiguousarray(centers)).to(dev)
    vals = torch.arange(256, dtype=torch.float32, device=dev).repeat(
        v.shape[0], 1)
    ties_x = torch.tensor([[30.0, 10.0, 50.0, 29.0, 31.0, 0.0]], device=dev)
    ties_v = torch.tensor([[10.0, 10.0, 50.0, 50.0]], device=dev)
    cases = {
        "64x256 bin values": (vals, v),
        "64x217*181 uint8": (px, v),
        "64x217*181 float32": (px.to(torch.float32), v),
        "64x217*181 int32": (px.to(torch.int32), v),
        "ties": (ties_x, ties_v),
    }
    for name, (x, vv) in cases.items():
        got = KD.labels(x, vv)
        torch.cuda.synchronize()
        want = KD.labels_plain(x, vv)
        require(torch.equal(got, want),
                f"labels kernel != plain version on {name} "
                f"({int((got != want).sum())} labels differ)")
        print(f"  labels {name}: exact")
    require(KD.labels(ties_x, ties_v).cpu().tolist()[0]
            == [0, 0, 2, 0, 2, 0], "ties do not go to the lowest index")
    b, n = px.shape
    c = v.shape[1]
    ms = time_ms(lambda: KD.labels(px, v))
    plain_ms = time_ms(lambda: KD.labels_plain(px, v))
    bnd, by = bound_ms(b * n * 1 + b * c * 4 + b * n * 4, 3 * b * n * c)
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                bound_by=by, library_ms=None)


def dsc_volume(results, gts, phantom):
    pred = np.stack([phantom.match_labels_to_classes(r.labels, r.centers)
                     for r in results])
    gt = np.stack(gts)
    return phantom.dice_per_class(pred, gt)


def serve_timed(eng, imgs, reps):
    """Flush latencies (seconds) of ``reps`` submit-all-then-flush runs."""
    lat = []
    for _ in range(reps):
        for im in imgs:
            eng.submit(im)
        t0 = time.perf_counter()
        out = eng.flush()
        lat.append(time.perf_counter() - t0)
        require(len(out) == len(imgs), "flush lost requests")
    return lat


def profile_flush(eng, imgs, card):
    """One warm flush of the volume under torch.profiler: device time by
    kernel and the device's busy share of the flush's wall time."""
    from torch.profiler import ProfilerActivity, profile
    for im in imgs:
        eng.submit(im)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.flush()
        wall = time.perf_counter() - t0
    # Only the device's own events (kernels, copies): a host op such as
    # aten::copy_ also reports the device time of what it launched, and
    # the profiler's buffer requests are not the program's work.
    rows = []
    for e in prof.key_averages():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.key.startswith("Activity Buffer")):
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) * 1e-6
    if not rows:
        print("  profile: the profiler saw no device time; busy share "
              "not measured")
        return
    print(f"  profile of one flush: wall {wall * 1e3:.2f} ms, device busy "
          f"{busy * 1e3:.3f} ms ({100 * busy / wall:.1f} %) [{card}]")
    for dev_us, count, key in rows[:10]:
        print(f"    {dev_us / 1e3:9.4f} ms  x{count:<4d} "
              f"({dev_us / count:8.2f} us each) {key[:60]}")


def main(dev=None):
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    t_start = time.perf_counter()

    # -- 1. card -------------------------------------------------------------
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    from repro_torch.configs import fcm_brainweb
    from repro_torch.core import solver as SV
    from repro_torch.data import phantom
    from repro_torch.kernels import _build
    from repro_torch.kernels import defuzzify as KD
    from repro_torch.kernels import fcm_resident as KR
    from repro_torch.kernels import histogram_bin as KB
    from repro_torch.serving import FCMServeEngine
    dev = torch.device("cuda") if dev is None else dev

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.library()
    print(f"[build] {len(_build.sources())} sources in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds:.2f}"
          f" s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())
    require(lib.fcm_resident_max_rows() == KR.MAX_ROWS,
            "the kernel's row bound disagrees with fcm_resident.MAX_ROWS")

    # -- 3. kernels against their plain versions ----------------------------
    job = fcm_brainweb.make_config()
    n_slices, h, w = VOLUME
    imgs, gts = phantom_volume(n_slices, h, w, phantom)
    pick = np.linspace(0, n_slices - 1, 64).round().astype(int)
    vol_u8 = np.stack([imgs[i].reshape(-1) for i in pick])
    big_u8 = phantom.phantom_of_bytes(BIG_BYTES)[0][None]
    print("[kernels] binning")
    k_bin = check_binning(KB, vol_u8, big_u8, dev)
    hists = KB.histogram_bin(torch.from_numpy(vol_u8).to(dev), 256)
    print("[kernels] whole-solve")
    k_solve, _ = check_solve(KR, SV, hists.cpu().numpy(), dev)
    feats = torch.arange(256, dtype=torch.float32, device=dev).repeat(
        64, 1)[..., None].contiguous()
    v, _, _, _ = SV.flat_batched_solve(feats, hists, 4, 2.0, 5e-3, 300,
                                       impl="resident")
    print("[kernels] labels")
    k_labels = check_labels(KD, vol_u8, v[..., 0].cpu().numpy(), dev)
    for name, k in (("histogram_bin", k_bin), ("fcm_resident_solve",
                                               k_solve),
                    ("labels", k_labels)):
        lib_ms = ("-" if k["library_ms"] is None
                  else f"{k['library_ms']:.4f} ms")
        print(f"  {name}: kernel {k['ms']:.4f} ms, plain "
              f"{k['plain_ms']:.4f} ms, library {lib_ms}, bound "
              f"{k['bound_ms']:.5f} ms ({k['bound_by']}) [{card}]")

    # -- 4. engine -----------------------------------------------------------
    cfg = job.fcm
    sizes = job.serving_batch_sizes
    eng = FCMServeEngine(cfg, batch_sizes=sizes, cache_size=0, device=dev)
    eng_cpu = FCMServeEngine(cfg, batch_sizes=sizes, cache_size=0,
                             device="cpu")
    KB.histogram_bin.launches = 0
    KR.resident_solve.launches = 0
    KD.labels.launches = 0
    t0 = time.perf_counter()
    res = eng.segment(imgs)
    t_first = time.perf_counter() - t0
    launches = {"histogram_bin": KB.histogram_bin.launches,
                "fcm_resident_solve": KR.resident_solve.launches,
                "labels": KD.labels.launches}
    print(f"[engine] {n_slices} slices {h}x{w} in {t_first * 1e3:.1f} ms (first "
          f"flush); launches {launches}")
    n_buckets = eng.stats()["batches"]
    require(n_buckets == 3, f"expected 3 buckets, got {n_buckets}")
    for name, n in launches.items():
        require(n == n_buckets, f"{name} launched {n} times for "
                f"{n_buckets} buckets")
    res_cpu = eng_cpu.segment(imgs)
    for r, rc in zip(res, res_cpu):
        require(r.n_iters == rc.n_iters,
                f"request {r.request_id}: n_iters {r.n_iters} on the card, "
                f"{rc.n_iters} on the CPU")
        require(np.array_equal(r.labels, rc.labels),
                f"request {r.request_id}: labels differ from the CPU engine")
        np.testing.assert_allclose(r.centers, rc.centers, rtol=RTOL,
                                   atol=ATOL)
        require(np.isfinite(r.centers).all() and r.labels.shape == (h, w),
                "bad result shape or non-finite centers")
    dsc = dsc_volume(res, gts, phantom)
    print(f"  labels and n_iters equal the CPU engine's on {n_slices} "
          f"requests; "
          f"DSC per class {[round(float(d), 4) for d in dsc]}")
    require(min(dsc) >= 0.95, f"DSC below 0.95: {dsc}")

    eng.reset_stats()
    lat = serve_timed(eng, imgs, reps=10)
    st = eng.stats()
    p50 = float(np.median(lat))
    print(f"  volume: {len(imgs) / p50:.1f} images/s, p50 flush "
          f"{p50 * 1e3:.2f} ms over 10 flushes of {n_slices} slices, p50 "
          f"request "
          f"latency {st['latency']['histogram']['p50'] * 1e3:.2f} ms, "
          f"stage seconds {st['stage_seconds']['histogram']} [{card}]")

    profile_flush(eng, imgs, card)

    cached = FCMServeEngine(cfg, batch_sizes=sizes, cache_size=256,
                            device=dev)
    first = cached.segment([imgs[n_slices // 2]])[0]
    again = cached.segment([imgs[n_slices // 2]])[0]
    require(not first.cache_hit and again.cache_hit,
            "resubmitted slice was not answered from the cache")
    require(np.array_equal(first.labels, again.labels),
            "cache hit labels differ")
    print("  cache: resubmitted slice answered from the cache")

    big = big_u8.reshape(-1, 256)
    one = FCMServeEngine(cfg, batch_sizes=sizes, cache_size=0, device=dev)
    r_big = one.segment([big])[0]
    r_big_cpu = FCMServeEngine(cfg, batch_sizes=sizes, cache_size=0,
                               device="cpu").segment([big])[0]
    require(r_big.n_iters == r_big_cpu.n_iters
            and np.array_equal(r_big.labels, r_big_cpu.labels),
            "1000 KB image: card and CPU engines disagree")
    lat_big = serve_timed(one, [big], reps=30)
    p50b = float(np.median(lat_big))
    print(f"  {BIG_BYTES // 1024} KB image {big.shape} at B=1: {1 / p50b:.1f} images/s, "
          f"p50 flush {p50b * 1e3:.3f} ms [{card}]")

    kernels = [
        dict(name="histogram_bin", route="cuda",
             source="src/repro_torch/csrc/histogram_bin.cu",
             replaces="src/repro/kernels/histogram_bin.py:56",
             launches=launches["histogram_bin"], **k_bin),
        dict(name="fcm_resident_solve", route="cuda",
             source="src/repro_torch/csrc/fcm_resident.cu",
             replaces="src/repro/kernels/fcm_resident.py:112",
             launches=launches["fcm_resident_solve"], **k_solve),
        dict(name="labels", route="cuda",
             source="src/repro_torch/csrc/defuzzify.cu",
             replaces="src/repro/kernels/defuzzify.py:27",
             launches=launches["labels"], **k_labels),
    ]
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
