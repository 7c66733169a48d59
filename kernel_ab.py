#!/usr/bin/env python3
"""Times thirteen kernels of one source tree on the card (rows 1-12 and
6b of PERF.md's kernel table: the ingest binning, the resident
whole-solve, the labels, the membership, the center partials, the
scalar and batched fused partials, the HBM-streamed whole-solve, the
stencil whole-solve, the 2-D and 3-D FCM_S steps, the SLIC assignment
and the selective scan), at the shapes their main paths give them, so
that two commits can be compared on one card, in one run.

    python3 kernel_ab.py [--tree DIR] [--label NAME] [--rows 1,6,...]

``--tree`` is the root of a checkout (default: the one holding this
script); its ``src`` goes first on ``sys.path``, so its ``repro_torch``
is imported and its kernels build into its own ``build/kernels``. Only
the wrappers' public signatures are used, so an older checkout (for
example a ``git archive`` of the parent commit, unpacked under
``build/``) runs too. Compare two trees only within one call, in turns:
parent, change, change, parent. Needs one CUDA card; prints the card's
name and power limit, then one JSON line:

    {"label": ..., "card": ..., "histogram_bin": {...},
     "resident_solve": {...}, "labels": {...},
     "membership": {...}, "fused_partials": {...},
     "center_partials": {...}, "fused_partials_batched": {...},
     "streamed_solve": {...}, "selective_scan": {...},
     "stencil_solve": {...}, "spatial_step_2d": {...},
     "spatial_step_3d": {...}, "slic_assign": {...}}

(``--rows`` keeps only the rows it names.)

with, per kernel, the CUDA-event median of back-to-back wrapper calls
(``ms``) and the profiler's device time a call (``device_ms``, every
launch of the call summed, and the kernels of a call by name; a
profiler window that recorded no device event is tried again with twice
the calls, and ``None`` means three windows lost them all). A tree
whose batched or scalar fused partials or 2-D step take a plan
(``batched_plan``, ``scalar_plan``, ``spatial2d_plan``) also prints it
for each case. A tree whose stencil whole-solve takes a
plan (``stencil_plan``) also times it at the fewest blocks that hold a
217x181 lane and at the plan's, on the bucket and on one lane alone
(``by_blocks``); a tree whose 3-D step takes a plan (``spatial3d_plan``)
also times the step at other run lengths than its plan's (``by_z``).

A tree whose streamed whole-solve takes a plan (``streamed_plan``)
prints each case's plan and the kernel's registers and blocks an SM; for
a tree with the earlier cluster form (one cluster of at most 8 blocks a
lane) a probe built from that tree's source reads the same, and the
8-block clusters the card seats at once (``cudaOccupancyMaxActiveClusters``).

The shapes: the binning on the histogram route's bucket (64 phantom
217x181 uint8 slices), the 1000 KB image as one lane and the bucket as
int32, with ``torch.bincount`` beside it; the resident whole-solve on
that bucket's 64 histograms (256 rows, c = 4, m = 2, eps 5e-3), with
each lane's iterations and the device time over the most of them, and
on 5 lanes of 1024 clustered 3-D rows at c = 8 (phase 3's), a tree with
``resident_plan`` also in each form (``by_form``: the tier and the
run-time body on the bucket); the
labels on the bucket as uint8, int32 and float32 and on the 1000 KB
image, c = 4, with the bucket's solved centers; the membership and the scalar
fused partials at the paper's 1000 KB image (c = 4, m = 2, phase 5's
centers; the fused partials also on phase 5's other cases: m = 2.5,
c = 8, N = 1, N = 8193 and 256 weighted histogram rows); the batched
fused partials on ``chip_smoke.py``'s four ``fused_batched_cases``
(imported from it: the pixel route's c = 12
bucket of 16 x 39 277 rows, one lane of 1 100 000 rows at c = 4,
4 x 262 144 RGB rows at c = 12, 2 x 3001 rows of D = 24 at c = 32); the
2-D step on the 1000 KB image with 8 and 4 neighbors and on a noisy
217x181 slice with 8, at c = 4, and on the 1000 KB image with 8 at
c = 8, 12 and 32; the
center partials at the paper's 1000 KB image (1 024 000
pixels, c = 4, m = 2, phase 5's centers, u from the membership kernel),
the staged path's reduction, back to back and with L2 flushed before
each call (``cold_device_ms``); the streamed whole-solve on the pixel
route's bucket, 64 phantom BrainWeb slices of 217x181 (39 277 rows, the
slices phase 4 picks), and on single lanes, the 1000 KB image
(1 024 000 rows) and the 512x512 RGB phantom (noise 6, seed 0; 262 144
rows of D = 3), c = 4, m = 2, eps 5e-3, as phase 6 sets them up; the
selective scan at (B, S, d_inner, d_state) = (1, 4096,
8192, 16), the width of jamba-v0.1-52b's mixers at train_4k's length,
on the inputs ``chip_smoke.py`` phase 8a draws; the stencil whole-solve
on the spatial route's bucket, 64 noisy 217x181 slices of the noisy
181-slice phantom volume (8 neighbors, alpha 1, c = 4, m = 2, eps 5e-3),
as phase 7 draws them, and on single noisy 2-D lanes (``b1_ms``): a
217x181 slice, and 2^16 and 2^18 pixels, the whole-solve's side of phase
7's dispatch sweep; the 3-D step (kernel and fold) on phase 7's noisy
181x217x181 volume at B = 1 with its centers (0.6, 51.3, 105.4, 167.6),
m = 2, alpha 1, the spatial route's volume past the whole-solve bound;
the SLIC assignment on phase 6's 512x512 RGB phantom (noise 6, seed 0)
with K = 256 seed centers and compactness 10, the superpixel route's
request.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "?"


def event_ms(torch, fn, reps, rounds):
    """Median over ``rounds`` of the CUDA-event time of ``reps``
    back-to-back calls, divided by ``reps``, after a warm-up."""
    for _ in range(2):
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


def profiled(torch, fn, calls, tries=3):
    """The device events of ``calls`` calls of ``fn`` under torch.profiler,
    each call synchronized, as (key, device us, count) rows. A window
    whose events all went missing is tried again with twice the calls, up
    to ``tries`` windows; [] when every window lost them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
                torch.cuda.synchronize()
        rows = []
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            if (e.device_type == torch.autograd.DeviceType.CUDA and us > 0
                    and not e.key.startswith("Activity Buffer")):
                rows.append((e.key, us, e.count))
        if rows:
            return rows, calls
        calls *= 2
    return [], calls


def device_ms(torch, fn, calls):
    """The profiler's device time of one call: each kernel's mean time a
    launch times its launches a call (the profiler's count over
    ``calls``, rounded and at least 1: it may drop some launches'
    events), summed; and the kernels it saw (name: launches a call)."""
    rows, calls = profiled(torch, fn, calls)
    total, names = 0.0, {}
    for key, us, count in rows:
        n = max(1, round(count / calls))
        total += us / count * n
        names[key[:48]] = n
    return (total / 1e3 if total else None), names


def blocks_sweep(torch, KST, SV, phantom, bucket, dev):
    """A tree with ``stencil_plan``: the whole-solve launched at other
    cluster sizes than its plan's, the fewest blocks that hold a 217x181
    lane with its x_eff and the plan's, on the bucket and on one lane
    alone: {"bucket" | "alone": {blocks: ms}}."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.fcm_membership import exponent
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    img = phantom.noisy_phantom_slice(217, 181, seed=217)[0]
    alone = torch.from_numpy(img.astype(np.float32)[None]).to(dev)
    plan = KST.stencil_plan(1, 217, 181, 8)
    fewest = min(r for r in range(1, KST.MAX_CLUSTER + 1)
                 if KST.onchip_bytes(1, 217, 181, 8, r, plan.form)
                 <= KST.SMEM_BUDGET)
    out = {}
    for name, x in (("bucket", bucket), ("alone", alone)):
        b = x.shape[0]
        v0, tol = SV.stencil_lane_init(x, 4, 5e-3)
        v = torch.empty((b, 4), device=dev)
        delta = torch.empty((b,), device=dev)
        iters = torch.empty((b,), dtype=torch.int32, device=dev)

        def call(ranks):
            err = lib.fcm_stencil_solve(
                x.data_ptr(), v0.data_ptr(), tol.data_ptr(), b, 1, 217, 181,
                4, 8, 1.0, 2.0, 2.0, exponent(2.0), 300, ranks, plan.form,
                v.data_ptr(), delta.data_ptr(), iters.data_ptr(), stream)
            assert err == 0, err
        out[name] = {r: event_ms(torch, lambda: call(r), 3, 3)
                     for r in sorted({fewest, plan.ranks})}
    return out


def z_sweep(torch, KSP, x, v, runs_of):
    """A tree with ``spatial3d_plan``: the 3-D step launched straight
    through the library at run lengths ``runs_of``, its scratch
    allocated once: {z: ms}."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.fcm_membership import exponent
    lib = _build.library()
    b, depth, h, w = x.shape
    c = v.shape[1]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    out = torch.empty((b, 2 * c), device=x.device)
    res = {}
    for z in runs_of:
        rows = lib.fcm_spatial3d_rows(depth, h, w, z)
        part = torch.empty((b, rows, 2 * c), device=x.device)

        def call():
            err = lib.fcm_spatial_partials_3d(
                x.data_ptr(), v.data_ptr(), b, depth, h, w, c, 1.0, 2.0,
                exponent(2.0), z, part.data_ptr(), out.data_ptr(), stream)
            assert err == 0, err
        res[z] = event_ms(torch, call, 10, 5)
    return res


#: reads, for the earlier cluster form of csrc/fcm_streamed.cu, what its
#: bucket tier (c <= 4, D = 1) gets: registers a thread, threads a block,
#: blocks an SM and 8-block clusters the card seats at once
CLUSTER_PROBE = r"""
#include "%s"
extern "C" int probe_cluster_form(int* out) {
  const void* k = (const void*)streamed_solve_kernel<4, 1>;
  const int threads = threads_for(4 * 2);
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, k);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, threads, 0);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kMaxCluster, 64, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kMaxCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, k, &cfg);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = threads;
  out[2] = blocks;
  out[3] = clusters;
  return 0;
}
"""


def cluster_form_finding(tree, lanes):
    """The earlier cluster form's occupancy, read by a probe compiled from
    ``tree``'s own csrc/fcm_streamed.cu: registers, threads, blocks an SM,
    8-block clusters at once, and the waves of whole solves a bucket of
    ``lanes`` lanes of 8 blocks takes."""
    import ctypes
    from repro_torch.kernels import _build
    src = os.path.join(tree, "src", "repro_torch", "csrc", "fcm_streamed.cu")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    probe = _build.BUILD_DIR / "cluster_probe.cu"
    probe.write_text(CLUSTER_PROBE % src)
    lib_path = _build.BUILD_DIR / "cluster_probe.so"
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                          str(probe), "-o", str(lib_path)],
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"the cluster-form probe did not build:\n"
                           f"{out.stdout}{out.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    vals = (ctypes.c_int * 4)()
    err = lib.probe_cluster_form(vals)
    if err != 0:
        raise RuntimeError(f"the cluster-form probe failed: {err}")
    regs, threads, blocks, clusters = list(vals)
    return dict(registers=regs, threads=threads, blocks_per_sm=blocks,
                clusters_of_8=clusters,
                waves=-(-lanes // clusters) if clusters else None)


def streamed_inputs(torch, SV, x, c, dev):
    """(x, w, v0, tol) on the card for rows ``x`` (B, K, D), unit weights,
    as chip_smoke.py phase 6 sets them up."""
    xt = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
    wt = torch.ones(xt.shape[:2], device=dev)
    lo, hi = SV.weighted_support(xt, wt)
    v0 = SV.linspace_from_support(lo, hi, c).contiguous()
    tol = SV._tol_from_range((hi - lo).max(dim=1).values, 5e-3).contiguous()
    return xt, wt, v0, tol


def row7(torch, tree, dev):
    """The streamed whole-solve on the pixel route's bucket and two lone
    lanes."""
    from repro_torch.core import solver as SV
    from repro_torch.data import phantom
    from repro_torch.kernels import _build
    from repro_torch.kernels import fcm_resident as KR
    cases = {
        "bucket_64x39277": _bucket_u8(phantom)[..., None],
        "lone_1000KB": phantom.phantom_of_bytes(1000 * 1024)[0].reshape(
            1, -1, 1),
        "lone_rgb512": phantom.phantom_slice_rgb(512, 512, noise=6.0,
                                                 seed=0)[0].reshape(1, -1, 3),
    }
    out = {}
    planned = hasattr(KR, "streamed_plan")
    for name, feats in cases.items():
        x, w, v0, tol = streamed_inputs(torch, SV, feats, 4, dev)

        def call():
            return KR.resident_streamed_solve(x, w, v0, tol, 2.0, 300)
        before = KR.resident_streamed_solve.launches
        _, _, it = call()
        torch.cuda.synchronize()
        assert KR.resident_streamed_solve.launches == before + 1
        dms, names = device_ms(torch, call, 5)
        b, k, d = x.shape
        e = dict(shape=[b, k, d], iters=sorted(set(it.cpu().tolist())),
                 ms=event_ms(torch, call, 5, 5), device_ms=dms, kernels=names)
        if planned:
            e["plan"] = KR.streamed_plan(
                b, k, d, *KR.streamed_occupancy(dev, 4, d, 2.0))._asdict()
        out[name] = e
    if planned:
        lib = _build.library()
        out["kernel_c4_d1"] = dict(
            registers=lib.fcm_streamed_registers(4, 1, 2.0),
            threads=KR.STREAM_THREADS,
            blocks_per_sm=lib.fcm_streamed_blocks_per_sm(4, 1, 2.0),
            sm_count=torch.cuda.get_device_properties(
                dev).multi_processor_count)
    else:
        out["kernel_c4_d1"] = cluster_form_finding(tree, 64)
    return out


def kernel_ms(torch, fn, calls, keep):
    """The profiler's device time a call of the kernels whose names hold
    one of ``keep`` (each kernel's mean a launch times its launches a
    call, summed)."""
    rows, calls = profiled(torch, fn, calls)
    total = sum(us / count * max(1, round(count / calls))
                for key, us, count in rows if any(k in key for k in keep))
    return total / 1e3 if total else None


def row5(torch, dev):
    """The center partials at the 1000 KB image, c = 4: back to back
    (x and u stay in L2) and with L2 flushed before each call (a 128 MB
    buffer written), as the staged solve finds them after its other
    passes."""
    from repro_torch.data import phantom
    from repro_torch.kernels import fcm_centers as KC
    from repro_torch.kernels import fcm_membership as KM
    x = torch.from_numpy(phantom.phantom_of_bytes(1000 * 1024)[0].reshape(
        -1).astype(np.float32)).to(dev)
    v = torch.tensor([0.6, 51.3, 105.4, 167.6], device=dev)
    u = KM.membership(x, v, 2.0)
    call = lambda: KC.center_partials(x, u, 2.0)  # noqa: E731
    before = KC.center_partials.launches
    call()
    torch.cuda.synchronize()
    assert KC.center_partials.launches == before + 1
    dms, names = device_ms(torch, call, 20)
    flush = torch.empty(32 << 20, device=dev)

    def cold():
        flush.zero_()
        call()
    cold_ms = kernel_ms(torch, cold, 20, ("center_partials", "fold_kernel"))
    return dict(n=x.shape[0], c=4, ms=event_ms(torch, call, 20, 5),
                device_ms=dms, cold_device_ms=cold_ms, kernels=names)


def row6b(torch, dev):
    """The batched fused partials on chip_smoke.py's four
    ``fused_batched_cases``: the pixel route's c = 12 bucket (16
    twelve-class 217x181 slices), one lane of 1 100 000 phantom rows at
    c = 4, 4 x 262 144 RGB rows at c = 12 (weighted) and 2 x 3001 rows of
    D = 24 at c = 32, m = 2.5."""
    from repro_torch.kernels import fcm_centers as KC
    import chip_smoke
    out = {}
    for key, (_, xt, wt, vt, m) in zip(
            ("bucket_16x39277_c12", "lone_1100000_c4", "rgb_4x262144_c12",
             "wide_2x3001_d24_c32"), chip_smoke.fused_batched_cases(dev)):
        b, k, d = xt.shape
        c = vt.shape[1]
        call = lambda: KC.fused_partials_batched(xt, wt, vt, m)  # noqa
        before = KC.fused_partials_batched.launches
        call()
        torch.cuda.synchronize()
        assert KC.fused_partials_batched.launches == before + 1
        dms, names = device_ms(torch, call, 10)
        e = dict(shape=[b, k, d], c=c, ms=event_ms(torch, call, 10, 5),
                 device_ms=dms, kernels=names)
        if hasattr(KC, "batched_plan"):
            e["plan"] = KC.batched_plan(b, k, d, c)._asdict()
        out[key] = e
    return out


def row9(torch, phantom, dev):
    """The 2-D FCM_S step on the 1000 KB image (4000x256) with 8 and 4
    neighbors, and on the middle slice of the noisy 181x217x181 phantom
    with 8, centers (0.6, 51.3, 105.4, 167.6), m = 2, alpha 1 (phase 7's
    step cases); then the 1000 KB image with 8 neighbors at c = 8, 12
    and 32 (centers evenly over 0-255), the larger cluster tiers."""
    from repro_torch.kernels import fcm_spatial as KSP
    big = phantom.phantom_of_bytes(1000 * 1024)[0].reshape(1, -1, 256)
    noisy = phantom.noisy_phantom_volume(181, 217, 181)[0][90][None]
    v4 = torch.tensor([[0.6, 51.3, 105.4, 167.6]], device=dev)

    def spread(c):
        return torch.linspace(2.5, 252.5, c, device=dev)[None].contiguous()
    out = {}
    for name, img, nb, v in (("1000KB_8nb", big, 8, v4),
                             ("1000KB_4nb", big, 4, v4),
                             ("noisy_217x181_8nb", noisy, 8, v4),
                             ("1000KB_8nb_c8", big, 8, spread(8)),
                             ("1000KB_8nb_c12", big, 8, spread(12)),
                             ("1000KB_8nb_c32", big, 8, spread(32))):
        x = torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(dev)
        call = lambda: KSP.spatial_partials_2d(x, v, 2.0, 1.0, nb)  # noqa
        before = KSP.spatial_partials_2d.launches
        call()
        torch.cuda.synchronize()
        assert KSP.spatial_partials_2d.launches == before + 1
        dms, names = device_ms(torch, call, 10)
        e = dict(shape=list(x.shape), neighbors=nb, c=v.shape[1],
                 ms=event_ms(torch, call, 10, 5), device_ms=dms,
                 kernels=names)
        if hasattr(KSP, "spatial2d_plan"):
            e["plan"] = KSP.spatial2d_plan(*x.shape[1:])._asdict()
        out[name] = e
    return out


def _bucket_u8(phantom):
    """The histogram route's bucket: the 64 phantom 217x181 uint8 slices
    phase 4 picks of the 181-slice volume, (64, 39277)."""
    slices = [phantom.phantom_slice(217, 181, slice_pos=float(p), seed=z)[0]
              for z, p in enumerate(np.linspace(0.3, 0.7, 181))]
    pick = np.linspace(0, 180, 64).round().astype(int)
    return np.stack([slices[i].reshape(-1) for i in pick])


def row1(torch, phantom, dev):
    """The binning on the main path's bucket (64 phantom 217x181 uint8
    slices, the ones phase 4 picks), on the 1000 KB image as one lane,
    and on the bucket as int32; each with the device operations of a call
    by name, and torch.bincount over the bucket's lanes offset by 256 a
    lane (the library call)."""
    from repro_torch.kernels import histogram_bin as KB
    vol = _bucket_u8(phantom)
    cases = {"bucket_64x39277_u8": vol,
             "lone_1x1024000_u8": phantom.phantom_of_bytes(1000 * 1024)[0]
             .reshape(1, -1),
             "bucket_64x39277_i32": vol.astype(np.int32)}
    out = {}
    for name, arr in cases.items():
        px = torch.from_numpy(arr).to(dev)
        call = lambda: KB.histogram_bin(px, 256)  # noqa: E731
        before = KB.histogram_bin.launches
        got = call()
        torch.cuda.synchronize()
        assert KB.histogram_bin.launches == before + 1
        assert torch.equal(got, KB.histogram_bin_plain(px, 256))
        dms, names = device_ms(torch, call, 10)
        out[name] = dict(shape=list(arr.shape), dtype=str(arr.dtype),
                         ms=event_ms(torch, call, 20, 5), device_ms=dms,
                         kernels=names)
    px = torch.from_numpy(vol).to(dev)
    flat = (px.to(torch.int64) + torch.arange(64, device=dev)[:, None]
            * 256).reshape(-1)
    out["bincount_ms"] = event_ms(
        torch, lambda: torch.bincount(flat, minlength=64 * 256), 20, 5)
    return out


def row2(torch, SV, phantom, dev):
    """The resident whole-solve on the main path's bucket (the 64 slices'
    256-bin histograms, c = 4, m = 2, eps 5e-3) and on phase 3's 5 lanes
    of 1024 clustered 3-D rows at c = 8 (a run-time form); each lane's
    iterations and the device time over the most iterations. A tree with
    ``resident_plan`` also times the bucket in each form (the tier and
    the run-time body, ``by_form``)."""
    from repro_torch.kernels import fcm_resident as KR
    vol = _bucket_u8(phantom)
    hists = np.stack([np.bincount(r, minlength=256) for r in vol])
    rng = np.random.default_rng(11)
    means = rng.uniform(0, 255, (5, 8, 3))
    pick = rng.integers(0, 8, (5, 1024))
    blobs = (np.take_along_axis(means, pick[..., None], axis=1)
             + rng.normal(0, 6, (5, 1024, 3))).astype(np.float32)
    cases = {"bucket_64x256_c4": (np.broadcast_to(
        np.arange(256, dtype=np.float32)[None, :, None], (64, 256, 1)),
        hists, 4),
        "blobs_5x1024_d3_c8": (blobs, rng.integers(0, 40, (5, 1024)), 8)}
    out = {}
    for name, (feats, w, c) in cases.items():
        x = torch.from_numpy(np.ascontiguousarray(feats, np.float32)).to(dev)
        wt = torch.from_numpy(np.ascontiguousarray(w, np.float32)).to(dev)
        lo, hi = SV.weighted_support(x, wt)
        v0 = SV.linspace_from_support(lo, hi, c).contiguous()
        tol = SV._tol_from_range((hi - lo).max(dim=1).values,
                                 5e-3).contiguous()
        call = lambda: KR.resident_solve(x, wt, v0, tol, 2.0, 300)  # noqa
        before = KR.resident_solve.launches
        v, _, it = call()
        torch.cuda.synchronize()
        assert KR.resident_solve.launches == before + 1
        pv, _, pit = KR.resident_solve_plain(x, wt, v0, tol, 2.0, 300)
        assert torch.equal(it, pit)
        np.testing.assert_allclose(v.cpu().numpy(), pv.cpu().numpy(),
                                   rtol=1e-5, atol=1e-4)
        dms, names = device_ms(torch, call, 20)
        iters = it.cpu().tolist()
        e = dict(shape=list(x.shape), c=c, iters=iters,
                 ms=event_ms(torch, call, 20, 5), device_ms=dms,
                 kernels=names,
                 device_us_per_iter=None if dms is None
                 else dms * 1e3 / max(iters))
        if hasattr(KR, "resident_plan"):
            k, d = x.shape[1], x.shape[2]
            e["plan"] = KR.resident_plan(k, c, d, 2.0)._asdict()
            e["by_form"] = {}
            for tier in ((True, False) if c == 4 and d == 1 else (False,)):
                plan = KR.resident_plan(k, c, d, 2.0)._replace(tier=tier)
                form = lambda: KR._launch_resident(  # noqa: E731
                    x, wt, v0, tol, 2.0, 300, plan)
                fv, _, fit = form()
                torch.cuda.synchronize()
                assert torch.equal(fit, it)
                np.testing.assert_allclose(fv.cpu().numpy(),
                                           pv.cpu().numpy(), rtol=1e-5,
                                           atol=1e-4)
                key = "tier" if tier else "run_time"
                e["by_form"][key] = device_ms(torch, form, 20)[0]
        out[name] = e
    return out


def row3(torch, SV, phantom, dev):
    """The labels on the main path's bucket (the 64 slices as uint8, and
    as int32 and float32, c = 4, the bucket's solved centers) and on the
    1000 KB image as one uint8 lane; each exact against the plain version,
    with a tree's ``labels_plan`` where it has one."""
    from repro_torch.kernels import defuzzify as KD
    vol = _bucket_u8(phantom)
    hists = torch.from_numpy(np.stack([np.bincount(r, minlength=256)
                                       for r in vol]).astype(np.float32))
    feats = torch.arange(256, dtype=torch.float32).repeat(64, 1)[..., None]
    v, _, _, _ = SV.flat_batched_solve(feats, hists, 4, 2.0, 5e-3, 300)
    v = v[..., 0].contiguous().to(dev)
    big = phantom.phantom_of_bytes(1000 * 1024)[0].reshape(1, -1)
    cases = {"bucket_64x39277_u8": (vol, v),
             "bucket_64x39277_i32": (vol.astype(np.int32), v),
             "bucket_64x39277_f32": (vol.astype(np.float32), v),
             "lone_1x1024000_u8": (big, v[:1].contiguous())}
    out = {}
    for name, (arr, vv) in cases.items():
        px = torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
        call = lambda: KD.labels(px, vv)  # noqa: E731
        before = KD.labels.launches
        got = call()
        torch.cuda.synchronize()
        assert KD.labels.launches == before + 1
        assert torch.equal(got, KD.labels_plain(px, vv))
        dms, names = device_ms(torch, call, 20)
        e = dict(shape=list(arr.shape), dtype=str(arr.dtype),
                 ms=event_ms(torch, call, 20, 5), device_ms=dms,
                 kernels=names)
        if hasattr(KD, "labels_plan"):
            e["plan"] = KD.labels_plan(*px.shape,
                                       px.element_size())._asdict()
        out[name] = e
    return out


def row4(torch, dev):
    """The membership at the 1000 KB image, c = 4, m = 2, phase 5's
    centers."""
    from repro_torch.data import phantom
    from repro_torch.kernels import fcm_membership as KM
    x = torch.from_numpy(phantom.phantom_of_bytes(1000 * 1024)[0].reshape(
        -1).astype(np.float32)).to(dev)
    v = torch.tensor([0.6, 51.3, 105.4, 167.6], device=dev)
    call = lambda: KM.membership(x, v, 2.0)  # noqa: E731
    before = KM.membership.launches
    call()
    torch.cuda.synchronize()
    assert KM.membership.launches == before + 1
    dms, names = device_ms(torch, call, 20)
    return dict(n=x.shape[0], c=4, ms=event_ms(torch, call, 20, 5),
                device_ms=dms, kernels=names)


def plan_ms(torch, KC, x, w, v, m, rows_per_thread):
    """The profiler's device time of one scalar fused partials launch at
    ``rows_per_thread`` (the cluster tier's, or 1 for one row a thread
    in blocks of 256 rows), called through the library, so both of the
    plans ``scalar_plan`` chooses between run on the same inputs."""
    from repro_torch.kernels import _build
    n, c = x.shape[0], v.shape[0]
    blocks = min(-(-n // (KC.THREADS * rows_per_thread)),
                 KC.BATCHED_MAX_BLOCKS)
    part = torch.empty((blocks * 2 * c,), dtype=torch.float32,
                       device=x.device)
    num = torch.empty((c,), dtype=torch.float32, device=x.device)
    den = torch.empty((c,), dtype=torch.float32, device=x.device)
    ticket = torch.zeros((1,), dtype=torch.int32, device=x.device)
    lib = _build.library()

    def call():
        _build.check(lib.fcm_fused_partials(
            x.data_ptr(), None if w is None else w.data_ptr(), n,
            v.data_ptr(), c, float(np.float32(m)), KC.exponent(m), blocks,
            rows_per_thread, part.data_ptr(), ticket.data_ptr(),
            num.data_ptr(), den.data_ptr(), _build.stream_of(x)), "plan_ms")
    call()
    want = KC.fused_partials_plain(x, w, v, m)
    for got, ref in zip((num, den), want):
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=1e-5, atol=1e-3)
    return dict(blocks=blocks, device_ms=device_ms(torch, call, 10)[0])


def row6(torch, phantom, dev):
    """The scalar fused partials on phase 5's cases (``chip_smoke.
    paper_kernel_cases``): the 1000 KB image at c = 4, m = 2, unit
    weights (the fused solve's call), at m = 2.5 and at c = 8, N = 1,
    N = 8193 (m = 2.5) and the 256 weighted histogram rows; and a
    217x181 phantom slice (39 277 rows, c = 4) at m = 2 and 2.5. A tree
    whose wrapper takes ``scalar_plan`` also times each case at the
    tier's rows a thread and at one row a thread (``by_plan``)."""
    from repro_torch.kernels import fcm_centers as KC
    import chip_smoke
    keep = {"1000 KB, c=4, m=2": "1000KB_c4", "1000 KB, m=2.5": "1000KB_m2.5",
            "1000 KB, c=8": "1000KB_c8", "N=1": "n1", "N=8193": "n8193_m2.5",
            "256 histogram rows, counts": "hist256_weighted"}
    big = phantom.phantom_of_bytes(1000 * 1024)[0]
    sl = torch.from_numpy(phantom.phantom_slice(217, 181, slice_pos=0.5)[0]
                          .reshape(-1).astype(np.float32)).to(dev)
    v4 = torch.tensor([0.6, 51.3, 105.4, 167.6], device=dev)
    cases = [c for c in chip_smoke.paper_kernel_cases(big, dev)
             if c[0] in keep]
    keep.update({"slice m=2": "slice39277_c4", "slice m=2.5":
                 "slice39277_m2.5"})
    cases += [("slice m=2", sl, None, v4, 2.0),
              ("slice m=2.5", sl, None, v4, 2.5)]
    out = {}
    for name, x, w, v, m in cases:
        call = lambda: KC.fused_partials(x, w, v, m)  # noqa: E731
        before = KC.fused_partials.launches
        call()
        torch.cuda.synchronize()
        assert KC.fused_partials.launches == before + 1
        dms, names = device_ms(torch, call, 10)
        e = dict(n=x.shape[0], c=v.shape[0], m=m, weighted=w is not None,
                 ms=event_ms(torch, call, 10, 5), device_ms=dms,
                 kernels=names)
        if hasattr(KC, "scalar_plan"):
            e["plan"] = KC.scalar_plan(x.shape[0], v.shape[0], w is not None,
                                       m)._asdict()
            tier = KC.batched_plan(1, x.shape[0], 1, v.shape[0],
                                   w is not None).rows_per_thread
            e["by_plan"] = {f"rows_{r}": plan_ms(torch, KC, x, w, v, m, r)
                            for r in (tier, 1)}
        out[keep[name]] = e
    return out


ROWS = ("1", "2", "3", "4", "5", "6", "6b", "7", "8", "9", "10", "11",
        "12")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--label", default=None)
    ap.add_argument("--rows", default=",".join(ROWS),
                    help="the table rows to time, comma-separated")
    args = ap.parse_args()
    rows = set(args.rows.split(","))
    if not rows <= set(ROWS):
        ap.error(f"--rows takes some of {','.join(ROWS)}")
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import solver as SV
    from repro_torch.data import phantom
    from repro_torch.kernels import fcm_stencil as KST
    from repro_torch.kernels import fcm_spatial as KSP
    from repro_torch.kernels import selective_scan as KSS
    from repro_torch.kernels import slic_assign as KS
    from repro_torch.superpixel import slic as SL
    import repro_torch
    assert os.path.dirname(os.path.dirname(repro_torch.__file__)) == \
        os.path.join(tree, "src"), repro_torch.__file__
    card = card_line()
    print(card)
    dev = torch.device("cuda")
    out = {"label": args.label or tree, "card": card}

    if "1" in rows:
        out["histogram_bin"] = row1(torch, phantom, dev)
    if "2" in rows:
        out["resident_solve"] = row2(torch, SV, phantom, dev)
    if "3" in rows:
        out["labels"] = row3(torch, SV, phantom, dev)
    if "4" in rows:
        out["membership"] = row4(torch, dev)
    if "6" in rows:
        out["fused_partials"] = row6(torch, phantom, dev)
    if "5" in rows:
        out["center_partials"] = row5(torch, dev)
    if "6b" in rows:
        out["fused_partials_batched"] = row6b(torch, dev)
    if "9" in rows:
        out["spatial_step_2d"] = row9(torch, phantom, dev)
    if "7" in rows:
        out["streamed_solve"] = row7(torch, tree, dev)

    if "12" in rows:
        # the selective scan, phase 8a's full-width inputs (seed 0)
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        b, s, di, ds = 1, 4096, 8192, 16
        u = torch.randn((b, s, di), generator=g, device=dev)
        dt = torch.rand((b, s, di), generator=g, device=dev) * 0.099 + 1e-3
        bm = torch.randn((b, s, ds), generator=g, device=dev)
        cm = torch.randn((b, s, ds), generator=g, device=dev)
        a = -(torch.rand((di, ds), generator=g, device=dev) * 3.5 + 0.5)
        scan = lambda: KSS.selective_scan(u, dt, bm, cm, a)  # noqa: E731
        before = KSS.selective_scan.launches
        scan()
        torch.cuda.synchronize()
        assert KSS.selective_scan.launches == before + 1
        dms, names = device_ms(torch, scan, 10)
        out["selective_scan"] = dict(shape=[b, s, di, ds],
                                     ms=event_ms(torch, scan, 10, 5),
                                     device_ms=dms, kernels=names)

    if "8" in rows:
        # the stencil whole-solve, phase 7's bucket of 64 noisy slices
        vol, _ = phantom.noisy_phantom_volume(181, 217, 181)
        pick = np.linspace(0, 180, 64).round().astype(int)
        x = torch.from_numpy(vol[pick].astype(np.float32)).to(dev)
        v0, tol = SV.stencil_lane_init(x, 4, 5e-3)
        st = lambda: KST.stencil_solve(x, v0, tol, 2.0, 1.0, 8, 300)  # noqa
        _, _, it = st()
        torch.cuda.synchronize()
        dms, names = device_ms(torch, st, 5)
        out["stencil_solve"] = dict(
            shape=list(x.shape), iters=sorted(set(it.cpu().tolist())),
            ms=event_ms(torch, st, 5, 5), device_ms=dms, kernels=names)
        single = {}
        for h, w in ((217, 181), (256, 256), (512, 512)):
            img = phantom.noisy_phantom_slice(h, w, seed=h)[0]
            x1 = torch.from_numpy(img.astype(np.float32)[None]).to(dev)
            v1, tol1 = SV.stencil_lane_init(x1, 4, 5e-3)
            single[h * w] = event_ms(torch, lambda: KST.stencil_solve(
                x1, v1, tol1, 2.0, 1.0, 8, 300), 3, 3)
        out["stencil_solve"]["b1_ms"] = single
        if hasattr(KST, "stencil_plan"):
            out["stencil_solve"]["by_blocks"] = blocks_sweep(
                torch, KST, SV, phantom, x, dev)

    if "10" in rows:
        # the 3-D FCM_S step, phase 7's noisy volume at B = 1
        vol3 = torch.from_numpy(phantom.noisy_phantom_volume(181, 217, 181)[0]
                                .astype(np.float32)[None]).to(dev)
        v3 = torch.tensor([[0.6, 51.3, 105.4, 167.6]], device=dev)

        def step():
            return KSP.spatial_partials_3d(vol3, v3, 2.0, 1.0)
        before = KSP.spatial_partials_3d.launches
        step()
        torch.cuda.synchronize()
        assert KSP.spatial_partials_3d.launches == before + 1
        dms, names = device_ms(torch, step, 10)
        out["spatial_step_3d"] = dict(shape=list(vol3.shape),
                                      ms=event_ms(torch, step, 10, 5),
                                      device_ms=dms, kernels=names)
        if hasattr(KSP, "spatial3d_plan"):
            out["spatial_step_3d"]["plan"] = KSP.spatial3d_plan(181, 217,
                                                                181)._asdict()
            out["spatial_step_3d"]["by_z"] = z_sweep(
                torch, KSP, vol3, v3, (4, 8, 12, 16, 24, 32, 64))

    if "11" in rows:
        # the SLIC assignment, phase 6's 512x512 RGB image, K = 256
        rgb = phantom.phantom_slice_rgb(512, 512, noise=6.0, seed=0)[0]
        img = torch.from_numpy(np.ascontiguousarray(rgb, np.float32)).to(dev)
        gy, gx = SL.grid_shape(512, 512, 256)
        sw = SL.spatial_weight(512, 512, gy, gx, 10.0)
        cen = SL.seed_centers(img, gy, gx).contiguous()
        assign = lambda: KS.slic_assign(img, cen, gy, gx, sw)  # noqa: E731
        before = KS.slic_assign.launches
        assign()
        torch.cuda.synchronize()
        assert KS.slic_assign.launches == before + 1
        dms, names = device_ms(torch, assign, 20)
        out["slic_assign"] = dict(shape=[512, 512, 3], k=gy * gx,
                                  ms=event_ms(torch, assign, 20, 5),
                                  device_ms=dms, kernels=names)

    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
