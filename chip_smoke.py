#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, the CUDA toolkit (``nvcc``) and PyTorch built
for CUDA; it imports neither JAX nor the JAX package. Phases, in order
(any failure exits non-zero):

1. card: require CUDA, print the card's name and power limit;
2. build: compile every kernel under ``src/repro_torch/csrc`` for
   ``sm_90a``, print the build time and ptxas' register report, and hold
   the library's exported bounds and plan constants against the Python
   plans (the resident whole-solve's rows and threads, the labels'
   pixels a block, the stencil whole-solve's, the 3-D and 2-D
   marches', the SLIC tile's, the streamed whole-solve's block shape and
   each tier's occupancy, the batched fused partials' tiers, feature
   chunks and rows a thread);
3. kernels: call each kernel's wrapper on tensors on the card at the
   serving path's shapes, hold the result against its plain PyTorch
   version on the same inputs, and time kernel, plain version and the
   library call computing the same function (where one exists); the
   resident whole-solve in its plan's form and, on the histograms, in
   the run-time body too, with the bucket's iterations and device time
   an iteration; the labels on the bucket as uint8, int32 and float32,
   each also 3 pixels off alignment, with each dtype's plan and device
   time;
4. engine: serve a 181-slice 217x181 phantom volume (BrainWeb's size)
   through ``FCMServeEngine`` with the launch counts set to 0 just
   before and read just after, hold labels and iteration counts against
   a CPU engine, check each class's DSC, the cache, and serve the
   paper's largest Table 3 image (1000 KB) at batch 1;
5. paper path: hold the membership, center-partials and fused-partials
   kernels against their plain versions at the 1000 KB image and at
   ragged and degenerate shapes (the center partials also at their block
   and grid-stride edges, one launch a call in the profile, and an
   unaligned x bit-equal to an aligned copy); ``solve`` one image with the auto,
   fused and staged backends (and the whole-solve on its histogram) on
   the card and on the CPU, with the launch counts set to 0 just before
   and read just after; check iterations, centers, labels and DSC; time
   the paper's Table 3 ladder (sequential numpy on the host, staged,
   fused, histogram whole-solve) and profile one fused and one staged
   solve;
6. routes: hold the HBM-streamed whole-solve and the SLIC assignment
   kernels against their plain versions (BrainWeb slices, the 1000 KB
   image, 512x512 RGB, ragged and degenerate lanes, a bucket of more
   blocks than the card holds; SLIC labels equal up to float64-checked
   near-ties; the streamed kernel's occupancy on the card and each
   case's plan and device time; the SLIC tile, its cell window and
   device time); serve the 181-slice volume, the
   1000 KB image and a bucket of RGB slices through the pixel route and
   RGB slices plus a 512x512 RGB image through the superpixel route,
   each with the launch counts set to 0 just before and read just after,
   against a CPU engine; time the 512x512 RGB image through both routes
   with each route's per-class DSC; hold the batched fused-partials
   kernel (lanes past the whole-solve bounds) against its plain version
   on four cases, each with its plan, device time and one kernel a call,
   and serve 16 slices at c = 12 and one 1100x1000 image (past 2^20
   rows) through the pixel route against a CPU engine;
7. spatial: hold the FCM_S step kernels (2-D and 3-D) and the stencil
   whole-solve against their plain versions (the 1000 KB image, noisy
   BrainWeb slices, the whole noisy 181x217x181 volume, degenerate
   grids; ragged lanes and an 8x64x64 volume for the whole-solve), each
   case twice and bit-equal, a whole-solve lane alone bit-equal to
   itself in its bucket, with each case's cluster size, form and shared
   memory a block, and the bucket's active clusters and device time; the
   3-D step's march plan for each volume and its device time; the 2-D
   step's plan for each image, and its device time (one kernel a call) on
   the 1000 KB image with 8 and 4 neighbors and on a noisy slice;
   ``solve(spatial_problem)`` on the card (auto,
   resident, fused, reference) against ``device="cpu"`` with the launch
   counts set to 0 just before and read just after, labels equal up to
   float64-checked near-ties; serve 181 noisy slices, the 1000 KB image
   and the volume through the spatial route against a CPU engine, with
   throughput, p50 flush, per-class DSC and a profiled flush; and time
   the whole-solve against the step kernels at B=1 on 2-D images of
   2^16, 2^18 and 2^20 pixels, the sweep that sets the whole-solve's
   dispatch bound;
8. lm: hold the selective-scan kernel against its plain version at
   (1, 4096, 8192, 16), (2, 128, 128, 4), the ragged (1, 100, 96, 8) and
   the one-chunk (1, 24, 256, 16), each also with the end state (y
   bit-equal, h_S against the plain recurrence's), with its chunk length,
   workspace and device time at full width, with and without the state;
   run one full-width group of jamba-v0.1-52b (8 layers, bf16 compute on
   float32 masters drawn on the card) through ``loss_fn`` on a seeded
   (1, 4096) batch with the launch counts set to 0 just before and read
   just after (7 scans), against the same forward with the plain scan
   (loss and the first mamba mixer's output); and take three
   ``make_train_step`` steps at the reduced config on the card and on
   the CPU (a full-width group's train step needs about 208 GB);
9. async: the 181-slice volume through ``submit_async`` from 4 submitter
   threads at ``max_wait_ms=10`` on the histogram route (9a) and the
   pixel route (9b), every result bit-equal to a synchronous ``segment``
   on the card, the kernels launched once a bucket from the flusher
   thread, the ladder's counters at 0 and every breaker closed; with
   submit-to-result p50 / p99, images/s, flushes and bucket sizes; then
   chaos from seeded fault plans (9c): two launch errors retried, launch
   failures past the retries that degrade two chunks and open the
   histogram breaker (the chunks solved by the plain solver on the card,
   within RTOL/ATOL of 9a, n_iters equal, labels equal up to near-ties),
   the half-open probe after a 0.5 s cooldown that runs the kernels and
   closes it, two NaN lanes salvaged with their batchmates bit-equal, a
   killed flusher replaced, a burst past ``max_queue_depth=64`` with
   mixed deadlines whose outcomes add up, and ``shutdown(drain=False)``;
   then (9d) where an async flush's time goes: the 9a run timed bucket by
   bucket (stages, the launch call's host time, the fence's wait, the
   device span by CUDA events) on a fresh engine and on the same engine
   again, the volume six times over so flushes overlap the submitters
   (at the default and at a 0.1 ms interpreter switch interval), against
   a synchronous flush, and the device's own events under the profiler;
10. mesh: the visible cards' count and the launch guard's cost; meshes of
   1, 2 and 4 shards (the 4 as (2, 2) over ``("data", "model")``), shard
   k on card k % count, so one card is named several times where fewer
   are visible; 10a ``fit_sharded`` in the pixel and histogram forms on
   the 181-slice volume (7 109 137 px) and the 1000 KB image cut to an odd
   N, each against ``solve`` on the card (fused) and on the CPU (centers
   within RTOL/ATOL, n_iters equal, labels up to float64 near-ties), with
   k launches of the fused partials an iteration (pixels) or k binnings,
   one whole-solve and k labels (histogram); 10b ``fit_batched_sharded``
   on the volume's 181 slice histograms on 2 and 4 shards, bit-equal to
   ``solve_batched`` on the card, one whole-solve a shard; 10c the volume
   through the histogram, pixel and spatial routes of engines at buckets
   (1, 8, 64) meshed on 2 and 4 shards, bit-equal to a single-device
   engine through ``segment`` and ``submit_async`` + ``drain``, each
   route kernel launched shards x buckets times, a bucket of 1 on the
   single-device path, ``set_mesh(None)`` and a one-device mesh bit-equal
   again; the p50 flush and its stages, meshed and single;
11. serve: 11a llama3.2-1b whole (16 layers at every published width,
   1.24 B float32 parameters, bf16 compute) through ``ServeEngine`` at
   batch 4, prompt 512 and 64 greedy tokens: each step's logits against
   the teacher-forced ``forward`` on the card, tokens equal to its argmax
   but at counted near-ties, the same seed at temperature 0.8 twice,
   prefill and decode ms, tokens/s, peak memory and a profiled decode
   step's share of weight casts; 11b one full-width jamba-v0.1-52b group
   (8 layers) prefilled at (2, 2048) through the selective scan's
   end-state form (7 launches) and through the plain loop (none), logits,
   every Mamba layer's state and the KV cache held between the two, then
   16 greedy decode steps from each cache (no scan launched); 11c the
   reduced llama3.2-1b, granite-moe-3b-a800m and jamba-v0.1-52b through
   ``ServeEngine`` on the card against ``device="cpu"`` (tokens equal,
   prefill logits within 1e-4), and ``launch.serve.main --ckpt-dir`` on a
   checkpoint the port's ``save_checkpoint`` wrote;
12. archs: the four architectures past GQA and Mamba in bf16 compute on
   float32 masters drawn on the card, each freed before the next, every
   run with the launch counts set to 0 just before and read just after
   (no kernel of the table lies on these paths): 12a rwkv6-1.6b whole
   (24 layers) through ``ServeEngine`` at batch 4, prompt 512 and 32
   greedy tokens, each step's logits against the teacher-forced
   ``forward`` (within SERVE_LOGIT_TOL of the position's max |logit|,
   tokens equal but at counted near-ties), with prefill and decode ms,
   tokens/s, peak memory and the wkv loop's share of a prefill; 12b one
   full-width deepseek-v2-236b group (MLA, 160 experts top-6 + 2 shared,
   capacity raised to drop-free) prefilled at (2, 1024) and 16 greedy
   tokens through the absorbed ``mla_decode``, held against the
   forward's decompressed attention, with the cache's bytes a token and
   layer beside the decompressed K/V's; 12c whisper-tiny whole on frames
   (4, 1500, 384) through ``ServeEngine`` at prompt 64 and 64 tokens, its
   prefill's cross K/V 1500 long; 12d one full-width
   llama-3.2-vision-90b group (the gated cross block and four self
   blocks), its gate opened to 0.5, on memory (2, 1601, 8192), prefilled
   at (2, 512) and 16 greedy tokens, and the gate at 0 giving other
   logits; 12e the four at their reduced configs on the card against
   ``device="cpu"`` (tokens equal, prefill and decode logits within
   SERVE_CPU_RTOL, two ``make_train_step`` steps' losses and every
   parameter and moment leaf within TRAIN_RTOL) and ``launch.serve.main
   --reduced`` on the card;
13. train: LM training through ``repro_torch.launch.train``, every run
   with the launch counts set to 0 just before and read just after:
   13a ``launch.train.main`` on the whole llama3.2-1b at the launcher's
   defaults (batch 8, seq 128, no checkpoints), 20 steps, the loss
   falling, with step ms, tokens/s, peak memory and straggler flags; 13b
   jamba-v0.1-52b at its published widths, depth cut to its block 0
   (Mamba, SwiGLU) repeated 4 times, float32 compute, 4 steps at
   (2, 512) through the launcher's loop with ``mamba_pallas`` (the scan
   launched in every Mamba layer's forward and its recompute), step 0
   held within 1e-3 of the plain loop's; 13c reduced llama3.2-1b with
   the int8 cross-pod mean on (2, 1, 1) and (2, 2, 1) pod meshes and
   uncompressed on (2, 2), granite-moe-3b-a800m's expert-parallel branch
   on (2, 2) and (1, 4), and jamba on (2, 2) (the scan per dp shard), each
   mesh naming the card 2 or 4 times, 2 steps held against the same mesh
   of ``cpu`` entries (and the dense one against one device); 13d the
   fault drill (a pipeline fault at step 12 restarts from step 10's
   checkpoint and ends at the uninterrupted run's state), a 4-shard
   checkpoint resumed on 2 shards through ``reshard_state``, and a
   stalled step flagged by ``StepTimer``;
14. analysis: 14a each kernel of the table that has a kind in the JAX
   package's analytic model (``roofline.kernel_step_costs``: rows 1-3,
   6, 6b and 7-11), its device time from phases 3 and 5-7 folded through
   ``roofline.kernel_cell`` with the byte widths the port's kernel reads
   and writes, beside the row's hand-counted bound, failing above
   FOLD_MAX of the roofline; 14b llama3.2-1b's train step at (8, 128)
   and one iteration of ``build_sharded_fit`` on the 181-slice volume on
   a one-card mesh, each counted by ``analysis.op_cost`` on fake tensors
   and on real ones on the card (flops and bytes equal), the predicted
   peak (arguments plus the fake step's live peak) within PEAK_RTOL of
   ``max_memory_allocated``; 14c ``launch.dryrun`` for llama3.2-1b,
   jamba-v0.1-52b and fcm-brainweb on both production meshes (memory,
   the three terms, the bottleneck, fits_hbm, each cell's wall time);
   14d the five FCM examples at full size on the card against a
   ``device="cpu"`` run of each (labels up to float64-checked near-ties,
   iterations equal, each example's own DSC bar);
15. placed: the train state stored split across a ("data", "model")
   (2, 2) mesh naming the card 4 times: 15a full-width Jamba block 0 x 4
   (float32, (2, 512), row 12 once a dp shard), 3 steps placed against 3
   with the lead-device state, each slot's stored bytes equal to the
   dry-run's per-device state arguments, no gathered leaf alive after a
   step; 15b the whole llama3.2-1b through ``launch.train.train`` placed
   against one device, 5 steps; 15c the drill: a placed checkpoint
   byte-equal to the same state saved whole, loaded on (4, 1) and on no
   mesh bit-equal, resumed on both to the uninterrupted run's state.

The line before the last is a JSON object listing every kernel of the
path; the last line is ``{"ok": true, "device": {...}}``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.analysis import hw  # noqa: E402  (the H100's peaks)

#: Solve tolerance against the plain version: values run 0-255 and the
#: background center sits near 0, where rtol alone means nothing; the
#: kernel and the plain version sum the rows in different orders.
RTOL, ATOL = 1e-5, 1e-4

#: BrainWeb's volume: 181 axial slices of 217x181 voxels.
VOLUME = (181, 217, 181)
#: the paper's largest Table 3 image, 1000 KB at one byte a pixel
BIG_BYTES = 1000 * 1024
#: the paper's Table 3 image sizes (KB) and the fixed iteration count its
#: ladder times each solve at
TABLE3_KB = (20, 40, 60, 80, 100, 200, 300, 500, 700, 1000)
TABLE3_ITERS = 10
#: memberships against the plain version: the same float32 operations,
#: the c-term normalizing sum perhaps in another order, and for m != 2
#: two pow implementations
U_RTOL, U_ATOL = 1e-6, 1e-7
#: partial sums over up to a million pixels, summed in other orders
SUM_RTOL = 1e-5
#: SLIC labels that differ must be near-ties: the two candidates'
#: distances, recomputed in float64, within TIE_RTOL, on at most
#: TIE_SHARE of the pixels
TIE_RTOL, TIE_SHARE = 1e-6, 1e-4
#: the superpixel route's DSC against the pixel route's, per class (the
#: JAX package's benchmarks/superpixel_fcm.py criterion)
DSC_PARITY = 0.02
#: spatial labels that differ from the CPU's must be near-ties: the two
#: labels' effective distances, recomputed in float64 at the card's
#: centers, within SPATIAL_TIE_RTOL (the centers themselves differ by up
#: to RTOL/ATOL), on at most TIE_SHARE of the pixels
SPATIAL_TIE_RTOL = 1e-4
#: FCM_S on noisy slices: every class's DSC at least this (the JAX
#: package's tests/test_fcm_spatial.py bar at its heaviest noise level)
SPATIAL_DSC = 0.75
#: the whole-solve's dispatch sweep: 2-D images of 2^16, 2^18, 2^20 pixels
SWEEP_SHAPES = ((256, 256), (512, 512), (1024, 1024))
#: turns of each path a swept size, taken alternately
SWEEP_TURNS = 15

#: phase 14a's inputs, filled by phases 3 and 5-7: table row -> the
#: JAX model's kind and shape (with the port's byte widths), the kernel's
#: device time a call (profiler; None if not measured), its CUDA-event
#: time a call and its hand-counted bound, both ms
ROOFLINE = {}
#: the largest roofline share a kernel may show against the model
FOLD_MAX = 1.05


def note_roofline(row, kind, shape, device_ms_, ms, bound):
    ROOFLINE[row] = dict(kind=kind, shape=shape, device_ms=device_ms_,
                         ms=ms, bound_ms=bound)


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
    t_bytes = n_bytes / hw.HBM_BW * 1e3
    t_ops = n_ops / hw.PEAK_FLOPS_F32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phantom_volume(n_slices, h, w, phantom):
    imgs, gts = [], []
    for z, pos in enumerate(np.linspace(0.3, 0.7, n_slices)):
        im, gt = phantom.phantom_slice(h, w, slice_pos=float(pos), seed=z)
        imgs.append(im)
        gts.append(gt)
    return imgs, gts


def check_binning(KB, vol_u8, big_u8, dev, card):
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
        ref = np.stack([np.bincount(np.clip(r.astype(np.int64), 0, 255),
                                    minlength=256) for r in arr])
        px = torch.from_numpy(arr).to(dev)
        # the same lanes 3 pixels past a 16-byte boundary (uint8: every
        # lane's start moves; int32: 12 bytes)
        buf = torch.empty(arr.size + 3, dtype=px.dtype, device=dev)
        buf[3:] = px.reshape(-1)
        off = buf[3:].view(px.shape)
        require(off.data_ptr() % 16 != 0, "the offset view is aligned")
        for where, t in (("", px), (", 3 pixels off alignment", off)):
            got = KB.histogram_bin(t, 256)
            torch.cuda.synchronize()
            want = KB.histogram_bin_plain(t, 256)
            require(torch.equal(got, want),
                    f"binning kernel != plain version on {name}{where}")
            require(np.array_equal(got.cpu().numpy(),
                                   ref.astype(np.float32)),
                    f"binning kernel != np.bincount on {name}{where}")
        print(f"  bin   {name}: exact, also 3 pixels off alignment")
    bin_dms = {}
    for name in ("64x217*181 uint8", "1x1024000 uint8", "64x217*181 int32"):
        px = torch.from_numpy(cases[name]).to(dev)
        dms, per = device_ms(lambda: KB.histogram_bin(px, 256))
        bin_dms[name] = dms
        _one_kernel(per, f"histogram_bin {name}")
        blocks = KB.bin_blocks(px.shape[1], px.element_size())
        print(f"  bin   {name}: {blocks} blocks a lane; device "
              f"{_fmt_ms(dms)} a call "
              f"({_kernel_names(per)}) [{card}]")
    px = torch.from_numpy(vol_u8).to(dev)
    b, n = px.shape
    flat = (px.to(torch.int64)
            + torch.arange(b, device=dev)[:, None] * 256).reshape(-1)
    ms = time_ms(lambda: KB.histogram_bin(px, 256))
    plain_ms = time_ms(lambda: KB.histogram_bin_plain(px, 256))
    lib_ms = time_ms(lambda: torch.bincount(flat, minlength=b * 256))
    bnd, by = bound_ms(b * n * 1 + b * 256 * 4, b * n)
    note_roofline("1", "bin", dict(b=b, n_rows=n, n_bins=256, in_bytes=1),
                  bin_dms["64x217*181 uint8"], ms, bnd)
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                bound_by=by, library_ms=lib_ms)


def check_solve(KR, SV, hists_np, dev, card):
    """Whole-solve kernel vs its plain version: the 64 phantom
    histograms plus degenerate lanes (in the plan's form, the tier, and
    in the run-time body), random vector rows at the kernel's row bound,
    and m != 2; the bucket's device time and time an iteration."""
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
        pv, pdelta, piters = KR.resident_solve_plain(x, wt, v0, tol, m, 300)
        pv_np, pit_np = pv.cpu().numpy(), piters.cpu().numpy()
        plan = KR.resident_plan(x.shape[1], c, x.shape[2], m)
        # the plan's form, and on the tier's rows the run-time body too
        forms = [("plan", None)] + ([("run-time body", plan._replace(
            tier=False))] if plan.tier else [])
        for form, forced in forms:
            if forced is None:
                v, delta, iters = KR.resident_solve(x, wt, v0, tol, m, 300)
            else:
                v, delta, iters = KR._launch_resident(x, wt, v0, tol, m,
                                                      300, forced)
            torch.cuda.synchronize()
            v_np, it_np = v.cpu().numpy(), iters.cpu().numpy()
            what = f"{name} ({form})"
            require(np.isfinite(v_np).all(), f"non-finite centers on {what}")
            if not np.array_equal(it_np, pit_np):
                bad = np.nonzero(it_np != pit_np)[0]
                margin = (pdelta.cpu().numpy() - tol.cpu().numpy())[bad]
                fail(f"iteration counts differ on {what}: lanes "
                     f"{bad.tolist()} kernel {it_np[bad].tolist()} plain "
                     f"{pit_np[bad].tolist()}, delta - tol "
                     f"{margin.tolist()}")
            np.testing.assert_allclose(v_np, pv_np, rtol=RTOL, atol=ATOL,
                                       err_msg=what)
            err = float(np.abs(v_np - pv_np).max())
            worst = max(worst, err)
            print(f"  solve {what}: iters equal (max {int(it_np.max())}), "
                  f"max |dv| {err:.3g}; form {(forced or plan)._asdict()}")
        if timing is None:
            timing = (x, wt, v0, tol, m, pit_np, c)
    x, wt, v0, tol, m, it_np, c = timing
    x, wt, v0, tol = x[:64].contiguous(), wt[:64].contiguous(), \
        v0[:64].contiguous(), tol[:64].contiguous()
    it_np = it_np[:64]
    dms, per = device_ms(lambda: KR.resident_solve(x, wt, v0, tol, m, 300))
    _one_kernel(per, "fcm_resident_solve on the 64-lane bucket")
    most = int(it_np.max())
    print(f"  solve 64x256 bucket: iterations {sorted(set(it_np.tolist()))}"
          f" (most {most}); device {_fmt_ms(dms)} a call"
          + ("" if dms is None else f", {dms * 1e3 / most:.3f} us an "
             f"iteration of the slowest lane")
          + f" ({_kernel_names(per)}) [{card}]")
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
    # every lane's rows a pass, memberships on chip: the lanes' rows x
    # their iterations
    note_roofline("2", "flat", dict(n_rows=kk, c=c, n_feat=d,
                                    n_iters=int(it_np.sum()), u_bytes=0),
                  dms, ms, bnd)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                bound_by=by, library_ms=None), int(it_np.max())


def _off_alignment(t, pixels=3):
    """The same (B, N) values in a buffer ``pixels`` past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + pixels, dtype=t.dtype, device=t.device)
    buf[pixels:] = t.reshape(-1)
    off = buf[pixels:].view(t.shape)
    require(off.data_ptr() % 16 != 0, "the offset view is aligned")
    return off


def check_labels(KD, vol_u8, centers, dev, card):
    """The labels kernel vs its plain version, exact: the bucket as
    uint8, float32 and int32, each also 3 pixels off alignment, the bin
    values and ties; each dtype's plan and device time on the bucket,
    one kernel a call."""
    px = torch.from_numpy(vol_u8).to(dev)
    v = torch.from_numpy(np.ascontiguousarray(centers)).to(dev)
    vals = torch.arange(256, dtype=torch.float32, device=dev).repeat(
        v.shape[0], 1)
    ties_x = torch.tensor([[30.0, 10.0, 50.0, 29.0, 31.0, 0.0]], device=dev)
    ties_v = torch.tensor([[10.0, 10.0, 50.0, 50.0]], device=dev)
    dtypes = {"uint8": px, "float32": px.to(torch.float32),
              "int32": px.to(torch.int32)}
    cases = {"64x256 bin values": (vals, v), "ties": (ties_x, ties_v)}
    for dt, t in dtypes.items():
        cases[f"64x217*181 {dt}"] = (t, v)
        cases[f"64x217*181 {dt}, 3 pixels off alignment"] = (
            _off_alignment(t), v)
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
    for dt, t in dtypes.items():
        dms, per = device_ms(lambda: KD.labels(t, v))
        _one_kernel(per, f"labels 64x217*181 {dt}")
        if dt != "float32":
            note_roofline("3" if dt == "uint8" else "3 (int32)", "labels",
                          dict(n_rows=b * n, c=c, n_feat=1,
                               in_bytes=t.element_size(), out_bytes=4),
                          dms, None, None)
        plan = KD.labels_plan(*t.shape, t.element_size())
        print(f"  labels 64x217*181 {dt}: plan {plan._asdict()}; device "
              f"{_fmt_ms(dms)} a call ({_kernel_names(per)}) [{card}]")
    ms = time_ms(lambda: KD.labels(px, v))
    plain_ms = time_ms(lambda: KD.labels_plain(px, v))
    bnd, by = bound_ms(b * n * 1 + b * c * 4 + b * n * 4, 3 * b * n * c)
    ROOFLINE["3"].update(ms=ms, bound_ms=bnd)
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                bound_by=by, library_ms=None)


def dsc_volume(results, gts, phantom):
    pred = np.stack([phantom.match_labels_to_classes(r.labels, r.centers)
                     for r in results])
    gt = np.stack(gts)
    return phantom.dice_per_class(pred, gt)


def serve_timed(eng, imgs, reps, method="histogram"):
    """Flush latencies (seconds) of ``reps`` submit-all-then-flush runs."""
    lat = []
    for _ in range(reps):
        for im in imgs:
            eng.submit(im, method=method)
        t0 = time.perf_counter()
        out = eng.flush()
        lat.append(time.perf_counter() - t0)
        require(len(out) == len(imgs), "flush lost requests")
    return lat


def profile_flush(eng, imgs, card, method="histogram"):
    """One warm flush of the volume under torch.profiler: device time by
    kernel and the device's busy share of the flush's wall time."""
    from torch.profiler import ProfilerActivity, profile
    for im in imgs:
        eng.submit(im, method=method)
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


# ---------------------------------------------------------------------------
# Phase 5: the paper's per-iteration path
# ---------------------------------------------------------------------------

def paper_kernel_cases(big, dev):
    """(name, x, w, v, m) cases at the 1000 KB image and at ragged and
    degenerate shapes. Realistic centers sit between pixel values; the
    'on a pixel' centers are integers that occur in the image (exact zero
    distances), as happens whenever a center lands on an intensity."""
    x = torch.from_numpy(big.astype(np.float32)).to(dev)
    v4 = torch.tensor([0.6, 51.3, 105.4, 167.6], device=dev)
    v_on = torch.tensor([0.0, 51.0, 105.0, 168.0], device=dev)
    v8 = torch.linspace(3.3, 250.1, 8, device=dev)
    flat = torch.full((8193,), 77.0, device=dev)
    hist = torch.bincount(x.to(torch.int64), minlength=256).to(torch.float32)
    vals = torch.arange(256, dtype=torch.float32, device=dev)
    return [
        ("1000 KB, c=4, m=2", x, None, v4, 2.0),
        ("1000 KB, centers on pixels", x, None, v_on, 2.0),
        ("1000 KB, m=2.5", x, None, v4, 2.5),
        ("1000 KB, c=8", x, None, v8, 2.0),
        ("N=1", x[:1].contiguous(), None, v4, 2.0),
        ("N=127", x[:127].contiguous(), None, v_on, 2.0),
        ("N=8193", x[:8193].contiguous(), None, v4, 2.5),
        ("all-equal image", flat, None,
         torch.tensor([77.0, 77.0, 100.0, 150.0], device=dev), 2.0),
        ("256 histogram rows, counts", vals, hist, v4, 2.0),
    ]


def check_membership(KM, cases):
    worst = 0.0
    for name, x, _, v, m in cases:
        got = KM.membership(x, v, m)
        torch.cuda.synchronize()
        want = KM.membership_plain(x, v, m)
        g, p = got.cpu().numpy(), want.cpu().numpy()
        np.testing.assert_allclose(g, p, rtol=U_RTOL, atol=U_ATOL,
                                   err_msg=f"membership {name}")
        err = float(np.abs(g - p).max())
        worst = max(worst, err)
        print(f"  membership {name}: max |du| {err:.3g}")
    name, x, _, v, m = cases[0]
    n, c = x.shape[0], v.shape[0]
    ms = time_ms(lambda: KM.membership(x, v, m))
    plain_ms = time_ms(lambda: KM.membership_plain(x, v, m))
    # per pixel and center: subtract, square, compare, floor, reciprocal,
    # sum, divide
    bnd, by = bound_ms(4 * (n + c + c * n), 7 * n * c)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                bound_by=by, library_ms=None)


def _close_sums(got, want, what):
    """Hold (num, den) against the plain version's; returns (max abs
    error, max error relative to the largest sum)."""
    for g, p, part in zip(got, want, ("num", "den")):
        np.testing.assert_allclose(g.cpu().numpy(), p.cpu().numpy(),
                                   rtol=SUM_RTOL, err_msg=f"{what} {part}")
    errs = [(float((g - p).abs().max()), float(p.abs().max()))
            for g, p in zip(got, want)]
    return (max(e for e, _ in errs),
            max(e / max(top, 1e-30) for e, top in errs))


def center_partials_edges(KC, cases, dev):
    """Row 5's own edge cases: pixel counts at its quad, block and
    grid-stride edges (quads of four pixels, four quads a thread, 256
    threads, at most 1024 blocks), with a ragged tail."""
    x, v4 = cases[0][1], cases[0][3]
    per_block = KC.QUAD * KC.QUADS_PER_THREAD * KC.THREADS
    grid_edge = per_block * KC.MAX_BLOCKS
    long = torch.cat([x] * (grid_edge // x.shape[0] + 1))[:grid_edge + 3]
    out = [(f"N={n}", long[:n].contiguous(), None, v4, 2.0)
           for n in (255, 257, per_block - 1, per_block + 1,
                     4 * 1024 * 256 + 3)]
    out.append((f"N={grid_edge + 3} (past the grid: threads stride)", long,
                None, v4, 2.0))
    out.append((f"N={grid_edge + 3}, weighted, m=2.5", long,
                (torch.arange(long.shape[0], device=dev) % 7).to(
                    torch.float32), v4, 2.5))
    return out


def check_center_partials(KC, KM, cases, dev):
    worst = 0.0
    for name, x, w, v, m in cases + center_partials_edges(KC, cases, dev):
        u = KM.membership_plain(x, v, m).contiguous()
        before = KC.center_partials.launches
        got = KC.center_partials(x, u, m, w)
        torch.cuda.synchronize()
        again = KC.center_partials(x, u, m, w)
        require(KC.center_partials.launches == before + 2,
                f"center_partials did not count one launch a call on {name}")
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"center_partials does not repeat bit for bit on {name}")
        err, rel = _close_sums(got, KC.center_partials_plain(x, u, m, w),
                               f"center_partials {name}")
        worst = max(worst, err)
        print(f"  center_partials {name}: max abs err {err:.3g} (relative "
              f"{rel:.3g}), repeats bit for bit")
    # the same pixels one float into a buffer: x's loads are scalar there
    name, x, w, v, m = cases[0]
    for n in (8192, 8193):
        buf = torch.empty(n + 1, device=dev)
        buf[1:] = x[:n]
        xa, xm = x[:n].contiguous(), buf[1:]
        require(xm.data_ptr() % 16 != 0, "the unaligned view is aligned")
        u = KM.membership_plain(xa, v, m).contiguous()
        require(all(torch.equal(a, b) for a, b in zip(
            KC.center_partials(xa, u, m), KC.center_partials(xm, u, m))),
            f"center_partials at N={n}: an unaligned x gives other bits "
            f"than an aligned copy")
    print("  center_partials: x one float off 16-byte alignment (N = 8192, "
          "8193) gives the aligned copy's bits")
    u = KM.membership(x, v, m)
    n, c = x.shape[0], v.shape[0]
    call = lambda: KC.center_partials(x, u, m)  # noqa: E731
    ms = time_ms(call)
    dms, per = device_ms(call)
    _one_kernel(per, "center_partials")
    print(f"  center_partials at {name}: device {_fmt_ms(dms)} a call "
          f"({_kernel_names(per)})")
    plain_ms = time_ms(lambda: KC.center_partials_plain(x, u, m))
    # per pixel and center: u*u, times x, two adds
    bnd, by = bound_ms(4 * (n + c * n + 2 * c), 4 * n * c)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                bound_by=by, library_ms=None)


def check_fused_partials(KC, cases, card):
    worst = 0.0
    for name, x, w, v, m in cases:
        before = KC.fused_partials.launches
        got = KC.fused_partials(x, w, v, m)
        torch.cuda.synchronize()
        again = KC.fused_partials(x, w, v, m)
        require(KC.fused_partials.launches == before + 2,
                f"fused_partials did not count one launch a call on {name}")
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"fused_partials does not repeat bit for bit on {name}")
        err, rel = _close_sums(got, KC.fused_partials_plain(x, w, v, m),
                               f"fused_partials {name}")
        worst = max(worst, err)
        plan = KC.scalar_plan(x.shape[0], v.shape[0], w is not None, m)
        dms, per = device_ms(lambda: KC.fused_partials(x, w, v, m))
        _one_kernel(per, f"fused_partials {name}")
        print(f"  fused_partials {name}: max abs err {err:.3g} (relative "
              f"{rel:.3g}), repeats bit for bit; {plan.rows_per_thread} rows "
              f"a thread, {plan.blocks} blocks; device {_fmt_ms(dms)} "
              f"({_kernel_names(per)}) [{card}]")
    name, x, w, v, m = cases[0]
    n, c = x.shape[0], v.shape[0]
    ms = time_ms(lambda: KC.fused_partials(x, None, v, m))
    plain_ms = time_ms(lambda: KC.fused_partials_plain(x, None, v, m))
    # per pixel and center: the membership's 7, then u*u, times x, two adds
    bnd, by = bound_ms(4 * (n + 3 * c), 11 * n * c)
    dms, _ = device_ms(lambda: KC.fused_partials(x, None, v, m))
    note_roofline("6", "flat", dict(n_rows=n, c=c, n_feat=1, n_iters=1,
                                    w_bytes=0, u_bytes=0), dms, ms, bnd)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                bound_by=by, library_ms=None)


def _counts(counters):
    return {name: fn.launches for name, fn in counters.items()}


def check_paper_solves(SV, phantom, counters, images, dev):
    """Each image through solve() on the card (auto with no device
    argument, which takes the streamed whole-solve past 1024 rows, fused,
    staged with seed 0, and the histogram problem's auto) and on the
    CPU: iterations, centers, labels, DSC, and each run's launches
    against its iteration count. Returns the launches of the whole
    phase."""
    expect = {
        "auto": lambda it: {"fcm_streamed_solve": 1, "labels": 1},
        "fused": lambda it: {"fcm_fused_partials": it, "labels": 1},
        "staged": lambda it: {"fcm_center_partials": it,
                              "fcm_membership": it},
        "histogram auto": lambda it: {"histogram_bin": 1,
                                      "fcm_resident_solve": 1, "labels": 1},
    }
    runs = {
        "auto": (lambda x, d: SV.pixel_problem(x, device=d), {}),
        "fused": (lambda x, d: SV.pixel_problem(x, device=d),
                  {"backend": "fused"}),
        "staged": (lambda x, d: SV.pixel_problem(x, device=d),
                   {"backend": "staged", "seed": 0}),
        "histogram auto": (lambda x, d: SV.histogram_problem(x, device=d),
                           {}),
    }
    for fn in counters.values():
        fn.launches = 0
    for img_name, (x, gt) in images.items():
        for run, (make, kw) in runs.items():
            before = _counts(counters)
            # auto with no device argument: the entry point's own default
            card = SV.solve(make(x, None if run.endswith("auto") else dev),
                            **kw)
            torch.cuda.synchronize()
            after = _counts(counters)
            host = SV.solve(make(x, "cpu"), **kw)
            it = card.n_iters
            if it != host.n_iters:
                stop = 5e-3 if run == "staged" else SV._single_init(
                    make(x, "cpu"), 5e-3, None)[1]
                fail(f"{img_name} {run}: n_iters {it} on the card, "
                     f"{host.n_iters} on the CPU; delta - tol: card "
                     f"{card.final_delta - stop!r}, CPU "
                     f"{host.final_delta - stop!r}")
            np.testing.assert_allclose(card.centers.cpu().numpy(),
                                       host.centers.numpy(), rtol=RTOL,
                                       atol=ATOL,
                                       err_msg=f"{img_name} {run}")
            require(torch.equal(card.labels.cpu(), host.labels),
                    f"{img_name} {run}: labels differ from the CPU's")
            lab = card.labels.cpu().numpy()
            if run == "histogram auto":
                lab = lab[x.astype(np.int64)]       # per bin -> per pixel
            dsc = phantom.dice_per_class(
                phantom.match_labels_to_classes(lab, card.centers.cpu()),
                gt)
            require(min(dsc) >= 0.95, f"{img_name} {run}: DSC {dsc}")
            used = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
            require(used == expect[run](it),
                    f"{img_name} {run}: launches {used} for {it} "
                    f"iterations, expected {expect[run](it)}")
            print(f"  solve {img_name} {run}: {it} iterations on both, "
                  f"max |dv| "
                  f"{float((card.centers.cpu() - host.centers).abs().max()):.3g}"
                  f", labels equal, DSC {[round(float(d), 4) for d in dsc]}"
                  f", launches {used}")
    launches = _counts(counters)

    # keep_membership on the card: the membership kernel, once
    x = images["217x181"][0]
    before = counters["fcm_membership"].launches
    card = SV.solve(SV.pixel_problem(x, device=dev), keep_membership=True)
    host = SV.solve(SV.pixel_problem(x, device="cpu"), keep_membership=True)
    require(counters["fcm_membership"].launches == before + 1,
            "keep_membership did not launch the membership kernel once")
    np.testing.assert_allclose(card.membership.cpu().numpy(),
                               host.membership.numpy(), rtol=U_RTOL,
                               atol=10 * U_ATOL)
    print("  keep_membership on the card: one membership launch, agrees "
          "with the CPU's")
    return launches


def host_ms(fn, reps):
    """Median host-clock time (ms) of ``fn`` ending in a synchronize,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def paired_host_ms(fns, reps):
    """Host-clock ms of each of ``fns`` (each ending in a synchronize),
    taken in turns for ``reps`` rounds after one warm-up call each, so
    that every function sees the same host: ``(least, median)`` a
    function. A host-bound loop on a shared host's cores reads 1x-3x its
    own cost in bursts; the least of the turns is the one the bursts
    missed."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    out = [[] for _ in fns]
    for _ in range(reps):
        for fn, ms in zip(fns, out):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    return [(min(ms), float(np.median(ms))) for ms in out]


def table3_ladder(SV, phantom, dev, card):
    """Paper Table 3: ms per solve of TABLE3_ITERS iterations from a host
    uint8 image (problem construction, the copy to the card and the
    labels included), for each size."""
    it = TABLE3_ITERS
    print(f"  Table 3 ladder, ms per solve of {it} iterations "
          f"(median; sequential on the host) [{card}]")
    print("     KB      pixels   sequential     staged      fused  "
          "hist-resident  x staged  x fused  x hist")
    rows = []
    for kb in TABLE3_KB:
        x = phantom.phantom_of_bytes(kb * 1024)[0]
        seq = host_ms(lambda: SV.solve(SV.pixel_problem(x, device="cpu"),
                                       backend="sequential", eps=-1.0,
                                       max_iters=it),
                      reps=1 if kb >= 300 else 2)
        staged = host_ms(lambda: SV.solve(SV.pixel_problem(x, device=dev),
                                          backend="staged", eps=-1.0,
                                          max_iters=it), reps=5)
        fused = host_ms(lambda: SV.solve(SV.pixel_problem(x, device=dev),
                                         backend="fused", tol=-1.0,
                                         max_iters=it), reps=5)
        hist = host_ms(lambda: SV.solve(SV.histogram_problem(x, device=dev),
                                        backend="resident", tol=-1.0,
                                        max_iters=it), reps=5)
        rows.append((kb, x.size, seq, staged, fused, hist))
        print(f"  {kb:5d} {x.size:11d} {seq:12.3f} {staged:10.3f} "
              f"{fused:10.3f} {hist:14.3f} {seq / staged:9.1f} "
              f"{seq / fused:8.1f} {seq / hist:7.1f}")
    return rows


def profile_call(fn, card, label):
    """One call of ``fn`` under torch.profiler: device time by kernel and
    the device's busy share of the call's wall time. Returns the device
    events as (us, count, name) rows."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
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
    if not rows:
        print(f"  profile {label}: the profiler saw no device time; busy "
              f"share not measured")
        return rows
    busy = sum(r[0] for r in rows) * 1e-6
    print(f"  profile {label}: wall {wall * 1e3:.2f} ms, device busy "
          f"{busy * 1e3:.3f} ms ({100 * busy / wall:.1f} %) [{card}]")
    for dev_us, count, key in rows[:8]:
        print(f"    {dev_us / 1e3:9.4f} ms  x{count:<4d} "
              f"({dev_us / count:8.2f} us each) {key[:60]}")
    return rows


#: profiler windows device_ms tries before it gives up on a time
PROFILE_TRIES = 3


def device_ms(fn, calls=5):
    """The profiler's device time of one call of ``fn``: each kernel's
    mean time a launch over ``calls`` calls after a warm-up, times its
    launches a call, summed; and each kernel's own, as {name: (us a
    launch, launches a call)}. Launches a call are the profiler's count
    over ``calls``, rounded and at least 1, since the profiler may drop
    the events of some launches. Each call is synchronized. A window in
    which the profiler recorded no device event at all (rare: it
    happened once in a whole run, and not in 160 windows of a fresh
    process on the card) is tried again with twice the calls, up to
    PROFILE_TRIES windows; None when every window lost them, which
    _fmt_ms reports as such. A host or event time never stands in for
    it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
                torch.cuda.synchronize()
        total, per = 0.0, {}
        for e in prof.key_averages():
            if (e.device_type != torch.autograd.DeviceType.CUDA
                    or e.key.startswith("Activity Buffer")):
                continue
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            if us > 0:
                n = max(1, round(e.count / calls))
                total += us / e.count * n
                per[e.key] = (us / e.count, n)
        if total:
            return total / 1e3, per
        calls *= 2
    return None, {}


def _fmt_ms(ms):
    return (f"not measured (the profiler recorded no device event in "
            f"{PROFILE_TRIES} windows)" if ms is None else f"{ms:.5f} ms")


def _kernel_names(per):
    """Each kernel's bare name (no return type, namespace or arguments),
    time a launch and launches a call."""
    def bare(k):
        k = k.replace("(anonymous namespace)::", "").removeprefix("void ")
        return k.split("(")[0].split("::")[-1][:40]
    return ", ".join(f"{bare(k)} {us:.2f} us x{n}"
                     for k, (us, n) in per.items())


def paper_path(SV, F, phantom, KM, KC, counters, dev, card):
    """Phase 5; returns the three kernels' entries (launches from the
    solves' run) without route/source keys."""
    big, big_gt = phantom.phantom_of_bytes(BIG_BYTES)
    cases = paper_kernel_cases(big, dev)
    print("[paper] membership")
    k_mem = check_membership(KM, cases)
    print("[paper] center partials")
    k_cen = check_center_partials(KC, KM, cases, dev)
    print("[paper] fused partials")
    k_fus = check_fused_partials(KC, cases, card)
    for name, k in (("fcm_membership", k_mem),
                    ("fcm_center_partials", k_cen),
                    ("fcm_fused_partials", k_fus)):
        print(f"  {name}: kernel {k['ms']:.4f} ms, plain "
              f"{k['plain_ms']:.4f} ms, library -, bound "
              f"{k['bound_ms']:.5f} ms ({k['bound_by']}) at 1000 KB, c=4 "
              f"[{card}]")

    print("[paper] solve on the card vs the CPU")
    sl, sl_gt = phantom.phantom_slice(217, 181, slice_pos=0.5, seed=0)
    images = {f"{BIG_BYTES // 1024} KB": (big, big_gt),
              "217x181": (sl.ravel(), sl_gt.ravel())}
    launches = check_paper_solves(SV, phantom, counters, images, dev)
    print(f"  launches over the phase's solves: {launches}")

    print("[paper] Table 3")
    table3_ladder(SV, phantom, dev, card)
    for backend in ("fused", "staged"):
        def one():
            return SV.solve(SV.pixel_problem(big, device=dev),
                            backend=backend)
        r = one()
        ms = host_ms(one, reps=5)
        print(f"  {backend} solve of the {BIG_BYTES // 1024} KB image at "
              f"eps=5e-3: {r.n_iters} iterations, {ms:.3f} ms "
              f"({ms / r.n_iters:.3f} ms an iteration) [{card}]")
        rows = profile_call(one, card, f"{backend} {BIG_BYTES // 1024} KB")
        if backend == "fused":
            # one launch an iteration: the partials' fold is in the kernel
            # (an empty profile, one that recorded no device event, shows
            # nothing either way)
            fused = [cnt for _, cnt, key in rows if "d1_kernel" in key]
            require(not rows or (not any("fold" in key for _, _, key in rows)
                                 and fused == [r.n_iters]),
                    f"the fused solve's profile shows {fused} partials "
                    f"launches for {r.n_iters} iterations, or a fold launch")
    # the fixed costs inside those solves, timed alone
    n = big.size
    build = host_ms(lambda: SV.pixel_problem(big, device=dev), reps=5)
    init = host_ms(lambda: SV._single_init(
        SV.pixel_problem(big, device=dev), 5e-3, None), reps=5)
    draw = host_ms(lambda: F.random_membership(
        torch.Generator().manual_seed(0), 4, n, dev), reps=5)
    print(f"  fixed costs at {BIG_BYTES // 1024} KB: pixel_problem from the "
          f"host image {build:.3f} ms; with the center init and tolerance "
          f"{init:.3f} ms; the staged path's random (4, {n}) membership "
          f"drawn on the host and copied {draw:.3f} ms [{card}]")
    return {"fcm_membership": dict(launches=launches["fcm_membership"],
                                   **k_mem),
            "fcm_center_partials": dict(
                launches=launches["fcm_center_partials"], **k_cen),
            "fcm_fused_partials": dict(
                launches=launches["fcm_fused_partials"], **k_fus)}


# ---------------------------------------------------------------------------
# Phase 6: the pixel and superpixel routes
# ---------------------------------------------------------------------------

def _blobs(b, k, d, c, seed):
    """Rows around ``c`` well-separated means per lane (a clustered
    payload: uniform noise converges over hundreds of iterations, each
    amplifying rounding, and says nothing about the kernel)."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(0, 255, (b, c, d))
    pick = rng.integers(0, c, (b, k))
    return (np.take_along_axis(means, pick[..., None], axis=1)
            + rng.normal(0, 6, (b, k, d))).astype(np.float32)


def streamed_cases(vol, big, rgb512):
    """(name, x (B, K, D), w (B, K), c, m) at the pixel route's shapes and
    at ragged and degenerate ones."""
    rng = np.random.default_rng(5)
    const_lane = np.full((5000, 1), 77.0, np.float32)
    slice_lane = np.resize(vol[0], (5000, 1)).astype(np.float32)
    holes = np.ones((2, 5000), np.float32)
    holes[1, ::2] = 0.0                         # zero-weight rows are inert
    ones = np.ones
    return [
        ("64 BrainWeb slices x 39277 scalar rows",
         vol[..., None].astype(np.float32), ones(vol.shape, np.float32), 4,
         2.0),
        (f"1 x {big.size} rows (the {BIG_BYTES // 1024} KB image)",
         big.reshape(1, -1, 1).astype(np.float32),
         ones((1, big.size), np.float32), 4, 2.0),
        ("4 x 262144 x D=3 (512x512 RGB)", rgb512,
         ones(rgb512.shape[:2], np.float32), 4, 2.0),
        ("ragged K=1025, D=2", _blobs(2, 1025, 2, 4, 1),
         rng.uniform(0.5, 4, (2, 1025)).astype(np.float32), 4, 2.0),
        ("ragged K=4099, D=3", _blobs(2, 4099, 3, 4, 2),
         ones((2, 4099), np.float32), 4, 2.0),
        ("a constant lane and zero-weight rows",
         np.stack([const_lane, slice_lane]), holes, 4, 2.0),
        ("c=8, m=2.5, D=16", _blobs(2, 3000, 16, 8, 3),
         ones((2, 3000), np.float32), 8, 2.5),
        ("2000 lanes x 2048 rows (more blocks than the card holds: rounds)",
         _blobs(2000, 2048, 1, 4, 4), ones((2000, 2048), np.float32), 4,
         2.0),
    ]


def streamed_finding(KR, lib, b, k, d, c, m, dev, card):
    """What the streamed kernel gets on this card at c, D and m: registers
    a thread, blocks an SM, blocks resident at once, and the plan of a
    bucket of ``b`` lanes of ``k`` rows (its rounds)."""
    regs = lib.fcm_streamed_registers(c, d, m)
    sms, blocks = KR.streamed_occupancy(dev, c, d, m)
    plan = KR.streamed_plan(b, k, d, sms, blocks)
    print(f"  streamed kernel at c={c}, D={d}, m={m}: {regs} registers a "
          f"thread, {blocks} blocks of {plan.threads} threads an SM "
          f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor; the plan assumes "
          f"{KR.stream_min_blocks(c, d)}), {sms} SMs, {sms * blocks} blocks "
          f"resident at once; a {b} x {k} bucket: {plan.ranks} blocks a "
          f"lane, {plan.grid} blocks, {plan.rounds} round(s) [{card}]")
    return plan


def check_streamed(KR, SV, cases, dev, card):
    """Streamed whole-solve kernel vs its plain version on each case:
    equal iteration counts, centers within RTOL/ATOL, a second launch
    bit-equal to the first, lane 0 alone bit-equal; each case's plan,
    and its time and device time beside its bound and its plain version.
    Returns the entry of the main path's case (the first)."""
    from repro_torch.kernels import _build
    lib = _build.library()
    worst, entry = 0.0, None
    for name, feats, w, c, m in cases:
        x = torch.from_numpy(np.ascontiguousarray(feats)).to(dev)
        wt = torch.from_numpy(np.ascontiguousarray(w)).to(dev)
        if entry is None:
            streamed_finding(KR, lib, *x.shape[:2], x.shape[2], c, m, dev,
                             card)
        lo, hi = SV.weighted_support(x, wt)
        v0 = SV.linspace_from_support(lo, hi, c).contiguous()
        tol = SV._tol_from_range((hi - lo).max(dim=1).values,
                                 5e-3).contiguous()
        v, _, iters = KR.resident_streamed_solve(x, wt, v0, tol, m, 300)
        torch.cuda.synchronize()
        v2, _, iters2 = KR.resident_streamed_solve(x, wt, v0, tol, m, 300)
        require(torch.equal(v, v2) and torch.equal(iters, iters2),
                f"streamed solve does not repeat bit for bit on {name}")
        # a lane's bits do not depend on the other lanes of its launch
        v1, _, iters1 = KR.resident_streamed_solve(
            x[:1].contiguous(), wt[:1].contiguous(), v0[:1].contiguous(),
            tol[:1].contiguous(), m, 300)
        require(torch.equal(v1[0], v[0]) and torch.equal(iters1[0], iters[0]),
                f"streamed lane 0 of {name} differs solved alone")
        pv, pdelta, piters = KR.resident_streamed_solve_plain(x, wt, v0, tol,
                                                              m, 300)
        it_np, pit_np = iters.cpu().numpy(), piters.cpu().numpy()
        v_np, pv_np = v.cpu().numpy(), pv.cpu().numpy()
        require(np.isfinite(v_np).all(), f"non-finite centers on {name}")
        if not np.array_equal(it_np, pit_np):
            bad = np.nonzero(it_np != pit_np)[0]
            margin = (pdelta.cpu().numpy() - tol.cpu().numpy())[bad]
            fail(f"streamed iteration counts differ on {name}: lanes "
                 f"{bad.tolist()} kernel {it_np[bad].tolist()} plain "
                 f"{pit_np[bad].tolist()}, delta - tol {margin.tolist()}")
        np.testing.assert_allclose(v_np, pv_np, rtol=RTOL, atol=ATOL,
                                   err_msg=f"streamed {name}")
        err = float(np.abs(v_np - pv_np).max())
        worst = max(worst, err)
        b, k, d = x.shape
        reps = 5 if b * k >= 1 << 20 else 20

        def call():
            return KR.resident_streamed_solve(x, wt, v0, tol, m, 300)
        ms = time_ms(call, reps=reps, rounds=5)
        dms, per = device_ms(call)
        plan = KR.streamed_plan(b, k, d,
                                *KR.streamed_occupancy(dev, c, d, m))
        plain_ms = time_ms(lambda: KR.resident_streamed_solve_plain(
            x, wt, v0, tol, m, 300), reps=1, rounds=3)
        n_bytes = 4 * (b * k * d + b * k + 2 * b * c * d + 3 * b)
        # per row, center and iteration: d2 3D, floor, reciprocal, sum,
        # divide, square, weight, numerator 2D, denominator 1
        n_ops = int(it_np.sum()) * k * c * (5 * d + 7)
        bnd, by = bound_ms(n_bytes, n_ops)
        require(dms is None or len(per) == 1,
                f"streamed {name}: the profiler saw {_kernel_names(per)}")
        print(f"  streamed {name}: iters equal (max {int(it_np.max())}), "
              f"max |dv| {err:.3g}, repeats bit for bit, lane 0 alone "
              f"bit-equal; plan {plan.ranks} blocks a lane, "
              f"{plan.rows_per_thread} rows a thread, {plan.lanes_per_round} "
              f"lanes a round, {plan.rounds} round(s); kernel {ms:.4f} ms, "
              f"device {_fmt_ms(dms)}, plain {plain_ms:.4f} ms, bound "
              f"{bnd:.5f} ms ({by}) [{card}]")
        if entry is None:
            entry = dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                         library_ms=None)
            # rows re-read every iteration, memberships on chip
            note_roofline("7", "flat", dict(n_rows=k, c=c, n_feat=d,
                                            n_iters=int(it_np.sum()),
                                            u_bytes=0), dms, ms, bnd)
    return dict(max_abs_err=worst, **entry)


def _near_ties(got, want, img, centers, sw):
    """Pixels where two SLIC label maps differ; fails unless each is a
    near-tie (the two candidates' float64 distances within TIE_RTOL)."""
    ys, xs = np.nonzero(got != want)
    img = img.astype(np.float64)
    cen = np.asarray(centers, np.float64)
    d = img.shape[-1]
    for y, x in zip(ys, xs):
        def dist(k):
            return (((img[y, x] - cen[k, :d]) ** 2).sum()
                    + sw * ((y - cen[k, d]) ** 2 + (x - cen[k, d + 1]) ** 2))
        a, b = dist(got[y, x]), dist(want[y, x])
        require(abs(a - b) <= TIE_RTOL * max(a, b),
                f"SLIC labels differ at ({y}, {x}) by more than a near-tie: "
                f"{a!r} vs {b!r}")
    require(len(ys) <= TIE_SHARE * got.size,
            f"{len(ys)} SLIC near-ties of {got.size} pixels")
    return len(ys)


def check_slic(KS, SL, phantom, dev, card):
    """SLIC kernel vs the plain assign_ref on the card: 512x512 RGB with
    seed and with drifted centers, a 217x181 grey slice, and the
    (129, 131) shape with 100 segments and 3 channels."""
    rgb = phantom.phantom_slice_rgb(512, 512, noise=6.0, seed=0)[0]
    grey = phantom.phantom_slice(217, 181, seed=0)[0][:, :, None]
    odd = phantom.phantom_slice_rgb(129, 131, seed=263)[0]
    cases = [("512x512 RGB, seed centers", rgb, 256, 0),
             ("512x512 RGB, drifted centers", rgb, 256, 3),
             ("217x181 grey", grey, 256, 0),
             ("129x131 RGB, 100 segments", odd, 100, 0)]
    timing = None
    n_diff = n_px = 0
    for name, im, segs, drift in cases:
        img = torch.from_numpy(np.ascontiguousarray(im, np.float32)).to(dev)
        h, w, _ = img.shape
        gy, gx = SL.grid_shape(h, w, segs)
        sw = SL.spatial_weight(h, w, gy, gx, 10.0)
        cen = SL.seed_centers(img, gy, gx)
        for _ in range(drift):
            cen = SL.update_centers(img, SL.assign_ref(img, cen, gy, gx, sw),
                                    cen)[0]
        cen = cen.contiguous()
        got = KS.slic_assign(img, cen, gy, gx, sw)
        torch.cuda.synchronize()
        want = SL.assign_ref(img, cen, gy, gx, sw)
        n = _near_ties(got.cpu().numpy(), want.cpu().numpy(),
                       img.cpu().numpy(), cen.cpu().numpy(), sw)
        n_diff, n_px = n_diff + n, n_px + h * w
        print(f"  slic {name} (K={gy * gx}): {n} pixels differ (near-ties)")
        if timing is None:
            timing = (img, cen, gy, gx, sw)
    img, cen, gy, gx, sw = timing
    h, w, d = img.shape
    inv_sy, inv_sx = KS.cell_reciprocals(h, w, gy, gx)
    mid = KS.tile_cell_window(h, w, gy, gx, h // KS.TILE_H // 2,
                              w // KS.TILE_W // 2)
    print(f"  slic_assign: tiles of {KS.TILE_W}x{KS.TILE_H} pixels, "
          f"{-(-h // KS.TILE_H) * -(-w // KS.TILE_W)} blocks; a middle tile "
          f"names cells {mid[0]}-{mid[1]} x {mid[2]}-{mid[3]}; windows of at "
          f"most {KS.window_span(KS.TILE_H, inv_sy, gy)}x"
          f"{KS.window_span(KS.TILE_W, inv_sx, gx)} cells, "
          f"{KS.smem_bytes(h, w, d, gy, gx)} B a block")
    ms = time_ms(lambda: KS.slic_assign(img, cen, gy, gx, sw))
    dev_ms, per = device_ms(lambda: KS.slic_assign(img, cen, gy, gx, sw))
    plain_ms = time_ms(lambda: KS.slic_assign_plain(img, cen, gy, gx, sw),
                       reps=5, rounds=3)
    # per pixel, nine candidates of D (subtract, square, add) and two
    # spatial terms of (subtract, square, weight, add)
    bnd, by = bound_ms(h * w * (4 * d + 4) + cen.numel() * 4,
                       9 * (3 * d + 8) * h * w)
    note_roofline("11", "slic_assign", dict(h=h, w=w, d=d,
                                            n_centers=gy * gx),
                  dev_ms, ms, bnd)
    print(f"  slic_assign: kernel {ms:.4f} ms, device "
          + ("not measured" if dev_ms is None else
             f"{dev_ms:.4f} ms ({_kernel_names(per)})")
          + f", plain {plain_ms:.4f} ms, library -, bound {bnd:.5f} ms "
          f"({by}) at 512x512 RGB, K={gy * gx} [{card}]")
    # a label map's error: the share of pixels whose label differs from
    # the plain version's over the four cases, each a checked near-tie
    print(f"  slic_assign: {n_diff} of {n_px} labels differ from the plain "
          f"version's, all near-ties")
    return dict(max_abs_err=n_diff / n_px, labels_differ=n_diff, ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bnd,
                bound_by=by, library_ms=None)


def _hold_to_cpu(res, res_cpu, what):
    for r, rc in zip(res, res_cpu):
        require(r.n_iters == rc.n_iters,
                f"{what} request {r.request_id}: n_iters {r.n_iters} on the "
                f"card, {rc.n_iters} on the CPU")
        require(np.array_equal(r.labels, rc.labels),
                f"{what} request {r.request_id}: labels differ from the CPU "
                f"engine's")
        np.testing.assert_allclose(r.centers, rc.centers, rtol=RTOL,
                                   atol=ATOL, err_msg=what)
        require(np.isfinite(r.centers).all(), f"{what}: non-finite centers")


def _rgb_dsc(phantom, r, gt):
    return phantom.dice_per_class(phantom.match_labels_to_means(
        r.labels, r.centers, phantom.CLASS_MEANS_RGB), gt)


def pixel_route(FCMServeEngine, cfg, sizes, counters, imgs, gts, big,
                phantom, dev, card):
    """The 181-slice volume, the 1000 KB image and 8 RGB slices through
    the pixel route; returns the volume run's launches."""
    eng = FCMServeEngine(cfg, batch_sizes=sizes, cache_size=0, device=dev)
    cpu = FCMServeEngine(cfg, batch_sizes=sizes, cache_size=0, device="cpu")
    for fn in counters.values():
        fn.launches = 0
    res = eng.segment(imgs, method="pixel")
    launches = _counts(counters)
    n_buckets = eng.stats()["pixel_batches"]
    print(f"  pixel route, {len(imgs)} slices: {n_buckets} buckets, "
          f"launches {launches}")
    require(n_buckets == 3, f"pixel route: {n_buckets} buckets, expected 3")
    require(launches == {**{k: 0 for k in counters},
                         "fcm_streamed_solve": 3, "labels": 3},
            f"pixel route launches {launches}, expected 3 streamed + 3 "
            f"labels")
    _hold_to_cpu(res, cpu.segment(imgs, method="pixel"), "pixel volume")
    dsc = dsc_volume(res, gts, phantom)
    print(f"  labels and n_iters equal the CPU engine's; DSC per class "
          f"{[round(float(d), 4) for d in dsc]}")
    require(min(dsc) >= 0.95, f"pixel route DSC below 0.95: {dsc}")
    eng.reset_stats()
    lat = serve_timed(eng, imgs, reps=10, method="pixel")
    p50 = float(np.median(lat))
    st = eng.stats()
    print(f"  pixel route volume: {len(imgs) / p50:.1f} images/s, p50 flush "
          f"{p50 * 1e3:.2f} ms over 10 flushes, stage seconds "
          f"{st['stage_seconds']['pixel']} [{card}]")
    profile_flush(eng, imgs, card, method="pixel")

    before = _counts(counters)
    r_big = eng.segment([big], method="pixel")[0]
    used = {k: v - before[k] for k, v in _counts(counters).items()
            if v != before[k]}
    require(used == {"fcm_streamed_solve": 1, "labels": 1},
            f"1000 KB pixel request launched {used}")
    _hold_to_cpu([r_big], cpu.segment([big], method="pixel"), "1000 KB")
    lat = serve_timed(eng, [big], reps=10, method="pixel")
    print(f"  pixel route {BIG_BYTES // 1024} KB image at B=1: "
          f"{r_big.n_iters} iterations, p50 flush "
          f"{float(np.median(lat)) * 1e3:.3f} ms [{card}]")

    rgb = [phantom.phantom_slice_rgb(217, 181, slice_pos=float(p), seed=i)[0]
           for i, p in enumerate(np.linspace(0.3, 0.7, 8))]
    before = _counts(counters)
    res = eng.segment(rgb, method="pixel")
    used = {k: v - before[k] for k, v in _counts(counters).items()
            if v != before[k]}
    require(used == {"fcm_streamed_solve": 1},
            f"8 RGB pixel requests launched {used}")
    _hold_to_cpu(res, cpu.segment(rgb, method="pixel"), "RGB pixel")
    print(f"  pixel route, 8 RGB slices (D=3) in one bucket: one streamed "
          f"launch, equal to the CPU engine's; iterations "
          f"{[r.n_iters for r in res]}")
    return launches


def superpixel_route(FCMServeEngine, SL, cfg, sizes, counters, phantom,
                     dev, card):
    """16 RGB slices and one 512x512 RGB image through the superpixel
    route; returns its launches."""
    imgs = [phantom.phantom_slice_rgb(217, 181, slice_pos=float(p),
                                      seed=i)[0]
            for i, p in enumerate(np.linspace(0.3, 0.7, 16))]
    imgs.append(phantom.phantom_slice_rgb(512, 512, noise=6.0, seed=0)[0])
    eng = FCMServeEngine(cfg, batch_sizes=sizes, cache_size=0, device=dev)
    cpu = FCMServeEngine(cfg, batch_sizes=sizes, cache_size=0, device="cpu")
    spcfg = eng.superpixel_cfg
    for fn in counters.values():
        fn.launches = 0
    res = eng.segment(imgs, method="superpixel")
    launches = _counts(counters)
    st = eng.stats()
    # what the SLIC fits ran (the same fits again, after the counts were
    # read), and whether their maps agree with the CPU's
    maps = 0
    slic_iters = 0
    for im in imgs:
        imf = im.astype(np.float32)
        card_s = SL.fit_slic(imf, spcfg.slic_params(), device=dev)
        host_s = SL.fit_slic(imf, spcfg.slic_params(), device="cpu")
        slic_iters += card_s.n_iters
        require(card_s.n_iters == host_s.n_iters,
                "SLIC iterations differ from the CPU's")
        got, want = card_s.labels.cpu().numpy(), host_s.labels.numpy()
        if not np.array_equal(got, want):
            maps += 1
            h, w = got.shape
            sw = SL.spatial_weight(h, w, host_s.gy, host_s.gx,
                                   spcfg.compactness)
            n = _near_ties(got, want, imf.reshape(h, w, -1),
                           host_s.centers.numpy(), sw)
            print(f"  superpixel map differs from the CPU's on {n} pixels")
    n_buckets = st["superpixel_batches"]
    print(f"  superpixel route, {len(imgs)} requests: {n_buckets} buckets, "
          f"{slic_iters} SLIC iterations, launches {launches}")
    require(launches == {**{k: 0 for k in counters},
                         "slic_assign": slic_iters + len(imgs),
                         "fcm_resident_solve": n_buckets},
            f"superpixel launches {launches}, expected "
            f"{slic_iters + len(imgs)} SLIC and {n_buckets} whole-solve")
    _hold_to_cpu(res, cpu.segment(imgs, method="superpixel"), "superpixel")
    print(f"  labels and n_iters equal the CPU engine's; {maps} SLIC maps "
          f"differ from the CPU's; compress "
          f"{st['superpixel_compress_seconds'] * 1e3:.1f} ms in all "
          f"[{card}]")
    return launches


def rgb512_comparison(FCMServeEngine, cfg, phantom, dev, card):
    """benchmarks/superpixel_fcm.py's measurement on the card: ms per
    512x512 RGB image through the pixel route and through the
    superpixel route (compress at submit + fit), each route's DSC."""
    img, gt = phantom.phantom_slice_rgb(512, 512, noise=6.0, seed=0)
    eng = FCMServeEngine(cfg, batch_sizes=(1,), cache_size=0, device=dev)
    out = {}
    for method in ("pixel", "superpixel"):
        r = eng.segment([img], method=method)[0]
        dsc = _rgb_dsc(phantom, r, gt)
        lat = []
        for _ in range(10):
            t0 = time.perf_counter()
            eng.submit(img, method=method)
            eng.flush()
            lat.append(time.perf_counter() - t0)
        out[method] = (float(np.median(lat)) * 1e3, dsc, r.n_iters)
        print(f"  512x512 RGB via {method}: {out[method][0]:.3f} ms per "
              f"image (submit + flush, p50 of 10), {r.n_iters} iterations, "
              f"DSC {[round(float(d), 4) for d in dsc]} [{card}]")
        profile_call(lambda: eng.segment([img], method=method), card,
                     f"512x512 RGB via {method}")
    gap = max(abs(a - b) for a, b in zip(out["pixel"][1],
                                         out["superpixel"][1]))
    speed = out["pixel"][0] / out["superpixel"][0]
    print(f"  superpixel vs pixel: {speed:.2f}x the speed, max per-class "
          f"DSC gap {gap:.4f}")
    require(gap <= DSC_PARITY, f"superpixel DSC {gap:.4f} from the pixel "
            f"route's, over {DSC_PARITY}")


def twelve_class_slices(n, h, w, seed):
    """``n`` (h, w) uint8 slices of 12 intensity classes with a little
    noise: a payload for c = 12 (with fewer classes than clusters, the
    centers that split one class drift apart slowly and rounding decides
    where they stop)."""
    rng = np.random.default_rng(seed)
    levels = np.linspace(8.0, 247.0, 12)
    return [np.clip(levels[rng.integers(0, 12, (h, w))]
                    + rng.normal(0, 2, (h, w)), 0, 255).astype(np.uint8)
            for _ in range(n)]


def fused_batched_cases(dev):
    """(name, x (B, K, D), w (B, K), v (B, c, D), m) on the card: the
    pixel route's c = 12 bucket, a lane past 2^20 rows, RGB, and a wide
    D with the largest c."""
    rng = np.random.default_rng(16)
    sl = np.stack([s.reshape(-1) for s in twelve_class_slices(
        16, *VOLUME[1:], seed=1)]).astype(np.float32)[..., None]
    huge = phantom_of_pixels(1100 * 1000, rng)
    rgb = _blobs(4, 512 * 512, 3, 12, 4)
    wide = _blobs(2, 3001, 24, 32, 5)

    def case(name, x, c, m, weighted=False):
        b, k, _ = x.shape
        w = (rng.uniform(0.5, 3.0, (b, k)) if weighted
             else np.ones((b, k))).astype(np.float32)
        lo, hi = x.min(axis=1), x.max(axis=1)
        frac = (np.arange(c) + 0.5) / c
        v = (lo[:, None, :] + frac[None, :, None]
             * (hi - lo)[:, None, :]).astype(np.float32)
        return name, *(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                       for a in (x, w, v)), m

    return [case("16 lanes x 39277 rows, c=12 (the pixel route's bucket)",
                 sl, 12, 2.0),
            case("1 lane x 1 100 000 rows, c=4 (past 2^20)", huge, 4, 2.0),
            case("4 x 262144 x D=3, c=12", rgb, 12, 2.0, weighted=True),
            case("2 x 3001 x D=24, c=32, m=2.5", wide, 32, 2.5)]


def phantom_of_pixels(n, rng):
    """One (1, n, 1) lane of phantom-like intensities (four classes)."""
    means = np.array([5.0, 60.0, 110.0, 170.0])
    return (means[rng.integers(0, 4, n)] + rng.normal(0, 4, n)).astype(
        np.float32).reshape(1, n, 1)


def _one_kernel(per, what):
    """Fail unless the profiler saw one kernel launched once a call."""
    require(not per or (len(per) == 1
                        and next(iter(per.values()))[1] == 1),
            f"{what} launched more than one kernel a call: "
            f"{_kernel_names(per)}")


def check_fused_batched(KC, cases, card):
    """The batched fused-partials kernel vs its plain version on each
    case, twice and bit-equal, with its plan and device time (one kernel
    a call); the first case timed against its bound. Returns its
    entry."""
    worst, first_dms = 0.0, []
    for name, x, w, v, m in cases:
        before = KC.fused_partials_batched.launches
        got = KC.fused_partials_batched(x, w, v, m)
        torch.cuda.synchronize()
        again = KC.fused_partials_batched(x, w, v, m)
        require(KC.fused_partials_batched.launches == before + 2,
                f"fused_partials_batched did not count one launch a call on "
                f"{name}")
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"fused_partials_batched does not repeat bit for bit on "
                f"{name}")
        err, rel = _close_sums(got, KC.fused_partials_batched_plain(
            x, w, v, m), f"fused_partials_batched {name}")
        worst = max(worst, err)
        b, k, d = x.shape
        plan = KC.batched_plan(b, k, d, v.shape[1])
        dms, per = device_ms(lambda: KC.fused_partials_batched(x, w, v, m))
        _one_kernel(per, f"fused_partials_batched {name}")
        first_dms.append(dms)
        print(f"  fused_partials_batched {name}: max abs err {err:.3g} "
              f"(relative {rel:.3g}), repeats bit for bit; plan tier "
              f"{plan.tier}, {plan.chunks} chunk(s) of {plan.dch} "
              f"feature(s), {plan.rows_per_thread} rows a thread, "
              f"{plan.blocks} blocks a lane and chunk, {plan.grid} blocks; "
              f"device {_fmt_ms(dms)} ({_kernel_names(per)}) [{card}]")
    name, x, w, v, m = cases[0]
    b, k, d = x.shape
    c = v.shape[1]
    ms = time_ms(lambda: KC.fused_partials_batched(x, w, v, m))
    plain_ms = time_ms(lambda: KC.fused_partials_batched_plain(x, w, v, m),
                       reps=3, rounds=3)
    # per row and center: the distance's 3D, the membership's 5, then
    # u*u, the weight, D numerator terms and adds, the denominator add
    bnd, by = bound_ms(4 * (b * k * d + b * k + 2 * b * c * d + b * c),
                       b * k * c * (5 * d + 8))
    note_roofline("6b", "flat", dict(n_rows=b * k, c=c, n_feat=d,
                                     n_iters=1, u_bytes=0),
                  first_dms[0], ms, bnd)
    print(f"  fused_partials_batched {name}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bnd:.5f} ms ({by}) [{card}]")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                bound_by=by, library_ms=None)


def past_bounds_route(FCMServeEngine, cfg, sizes, counters, phantom, dev,
                      card):
    """The pixel route where no whole-solve kernel holds the lanes: 16
    slices of 12 classes at c = 12, and one image of 1 100 000 pixels at
    c = 4, each against a CPU engine; returns the c = 12 run's launches."""
    c12 = dataclasses.replace(cfg, n_clusters=12)
    imgs = twelve_class_slices(16, *VOLUME[1:], seed=2)
    eng = FCMServeEngine(c12, batch_sizes=sizes, cache_size=0, device=dev)
    cpu = FCMServeEngine(c12, batch_sizes=sizes, cache_size=0, device="cpu")
    for fn in counters.values():
        fn.launches = 0
    res = eng.segment(imgs, method="pixel")
    launches = _counts(counters)
    iters = max(r.n_iters for r in res)
    print(f"  pixel route, 16 slices at c=12: one bucket, {iters} "
          f"iterations, launches {launches}")
    require(launches == {**{k: 0 for k in counters},
                         "fcm_fused_partials_batched": iters, "labels": 1},
            f"c=12 pixel route launches {launches}, expected {iters} "
            f"batched fused + 1 labels")
    _hold_to_cpu(res, cpu.segment(imgs, method="pixel"), "c=12 pixel")
    lat = serve_timed(eng, imgs, reps=5, method="pixel")
    print(f"  c=12 pixel route, 16 slices: labels and n_iters equal the CPU "
          f"engine's; p50 flush {float(np.median(lat)) * 1e3:.2f} ms "
          f"[{card}]")

    img = phantom.phantom_slice(1100, 1000, seed=3)[0]
    before = _counts(counters)
    r = FCMServeEngine(cfg, batch_sizes=sizes, cache_size=0,
                       device=dev).segment([img], method="pixel")
    used = {k: v - before[k] for k, v in _counts(counters).items()
            if v != before[k]}
    require(used == {"fcm_fused_partials_batched": r[0].n_iters,
                     "labels": 1},
            f"1100x1000 pixel request launched {used}")
    r_cpu = FCMServeEngine(cfg, batch_sizes=sizes, cache_size=0,
                           device="cpu").segment([img], method="pixel")
    _hold_to_cpu(r, r_cpu, "1100x1000")
    print(f"  pixel route, one 1100x1000 image (past 2^20 rows): "
          f"{r[0].n_iters} batched fused launches, equal to the CPU engine")
    return launches


def routes_path(KR, KS, KC, SV, SL, FCMServeEngine, job, counters, imgs,
                gts, vol_u8, big, phantom, dev, card):
    """Phase 6; returns the streamed, SLIC and batched fused kernels'
    entries."""
    rgb512 = np.stack([phantom.phantom_slice_rgb(512, 512, noise=6.0,
                                                 seed=s)[0]
                       for s in range(4)]).reshape(4, -1, 3).astype(
                           np.float32)
    print("[routes] streamed whole-solve")
    k_str = check_streamed(KR, SV, streamed_cases(vol_u8, big, rgb512), dev,
                           card)
    print("[routes] SLIC assignment")
    k_slic = check_slic(KS, SL, phantom, dev, card)
    print("[routes] pixel route")
    px = pixel_route(FCMServeEngine, job.fcm, job.serving_batch_sizes,
                     counters, imgs, gts, big, phantom, dev, card)
    print("[routes] superpixel route")
    sp = superpixel_route(FCMServeEngine, SL, job.fcm,
                          job.serving_batch_sizes, counters, phantom, dev,
                          card)
    print("[routes] 512x512 RGB: pixels vs superpixels")
    rgb512_comparison(FCMServeEngine, job.fcm, phantom, dev, card)
    print("[routes] batched fused partials (lanes past the whole-solve "
          "bounds)")
    k_fb = check_fused_batched(KC, fused_batched_cases(dev), card)
    fb = past_bounds_route(FCMServeEngine, job.fcm, job.serving_batch_sizes,
                           counters, phantom, dev, card)
    return {"fcm_streamed_solve": dict(launches=px["fcm_streamed_solve"],
                                       **k_str),
            "slic_assign": dict(launches=sp["slic_assign"], **k_slic),
            "fcm_fused_partials_batched": dict(
                launches=fb["fcm_fused_partials_batched"], **k_fb)}


# ---------------------------------------------------------------------------
# Phase 7: the spatial (FCM_S) route
# ---------------------------------------------------------------------------

#: neighbor deltas of each stencil arity, for the float64 near-tie check
_DELTAS = {4: ((1, 0), (-1, 0), (0, 1), (0, -1)),
           8: ((1, 0), (-1, 0), (0, 1), (0, -1),
               (1, 1), (1, -1), (-1, 1), (-1, -1)),
           6: ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
               (0, 0, -1))}


def _effective_d2_f64(img, centers, neighbors, alpha, idx):
    """(len(idx), c) FCM_S effective distances in float64 at the flat
    pixel indices ``idx``: (v - x)^2 + alpha * mean over the in-grid
    neighbors of (v - x_r)^2."""
    x = np.asarray(img, np.float64)
    v = np.asarray(centers, np.float64)
    coords = np.unravel_index(idx, x.shape)
    nb = np.zeros((len(idx), v.size))
    cnt = np.zeros(len(idx))
    for delta in _DELTAS[neighbors]:
        cc = [coords[a] + delta[a] for a in range(x.ndim)]
        ok = np.ones(len(idx), bool)
        for a in range(x.ndim):
            ok &= (cc[a] >= 0) & (cc[a] < x.shape[a])
        xs = x[tuple(np.where(ok, cc[a], 0) for a in range(x.ndim))]
        nb += ok[:, None] * (v[None] - xs[:, None]) ** 2
        cnt += ok
    xi = x[coords]
    return ((v[None] - xi[:, None]) ** 2
            + alpha * nb / np.maximum(cnt, 1.0)[:, None])


def _spatial_near_ties(got, want, img, centers, neighbors, alpha, what):
    """Pixels where two FCM_S label maps differ; fails unless each is a
    near-tie at ``centers`` in float64 and they are at most TIE_SHARE of
    the pixels. Returns their count."""
    got, want = np.asarray(got), np.asarray(want)
    idx = np.flatnonzero(got != want)
    if idx.size:
        d = _effective_d2_f64(img, centers, neighbors, alpha, idx)
        rows = np.arange(idx.size)
        a = d[rows, got.reshape(-1)[idx]]
        b = d[rows, want.reshape(-1)[idx]]
        bad = np.abs(a - b) > SPATIAL_TIE_RTOL * np.maximum(a, b)
        require(not bad.any(), f"{what}: {int(bad.sum())} labels differ by "
                f"more than a near-tie")
    require(idx.size <= TIE_SHARE * got.size,
            f"{what}: {idx.size} near-ties of {got.size} pixels")
    return int(idx.size)


def spatial_step_cases(big, noisy_sl, noisy_vol, dev):
    """(name, x (B, *grid), v (B, c), m, alpha, neighbors) for the step
    kernels: the main path's shapes and degenerate grids. Realistic
    centers sit between pixel values; 'on pixels' are integers that
    occur in the image (exact zero distances)."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    v4 = t([[0.6, 51.3, 105.4, 167.6]])
    v_on = t([[0.0, 51.0, 105.0, 168.0]])
    img = t(big.reshape(1, -1, 256))
    sl = t(noisy_sl[None])
    vol = t(noisy_vol[None])
    rng = np.random.default_rng(3)
    return [
        ("1000 KB 4000x256, 8 nb", img, v4, 2.0, 1.0, 8),
        ("1000 KB, 4 nb", img, v4, 2.0, 1.0, 4),
        ("1000 KB, 8 nb, centers on pixels", img, v_on, 2.0, 1.0, 8),
        ("1000 KB, 8 nb, alpha 0", img, v4, 2.0, 0.0, 8),
        ("1000 KB, 8 nb, alpha 2.5, m 1.6", img, v4, 1.6, 2.5, 8),
        ("noisy 217x181, 8 nb", sl, v4, 2.0, 1.0, 8),
        ("noisy 217x181, 4 nb, alpha 2.5", sl, v_on, 2.0, 2.5, 4),
        ("1x1", t([[[77.0]]]), v4, 2.0, 1.0, 8),
        ("2x2, m 1.6", t(rng.integers(0, 256, (1, 2, 2))), v_on, 1.6, 1.0,
         8),
        ("1x300, alpha 0", t(rng.integers(0, 256, (1, 1, 300))), v4, 2.0,
         0.0, 4),
        ("300x1", t(rng.integers(0, 256, (1, 300, 1))), v4, 2.0, 1.0, 8),
        ("2x300, no interior row", t(rng.integers(0, 256, (1, 2, 300))), v4,
         2.0, 1.0, 8),
        ("BrainWeb volume 181x217x181, 6 nb", vol, v4, 2.0, 1.0, 6),
        ("volume, alpha 2.5, m 1.6", vol, v_on, 1.6, 2.5, 6),
        ("2x2x2", t(rng.integers(0, 256, (1, 2, 2, 2))), v4, 2.0, 1.0, 6),
    ]


#: float operations a pixel and cluster of an FCM_S update spends after
#: its own and its neighbors' distances are known: the neighbors' mean
#: and its weight (divide, multiply, add), the membership (floor,
#: reciprocal, sum, divide), u^m, and the two sums (3)
_FCMS_OPS_PER_CLUSTER = 11


def _step_ops(n, c, k):
    """Float operations of one FCM_S step over n pixels, c clusters, k
    neighbors, as the TPU step kernel does them: per neighbor a count, a
    sum and c (subtract, square, add); per pixel the floor of the count,
    xbar and x + alpha xbar (4); per pixel and cluster its own distance
    (2) and the update."""
    return n * (k * (2 + 3 * c) + 4 + c * (2 + _FCMS_OPS_PER_CLUSTER))


def _stencil_ops(ns, iters, c, k):
    """Float operations of the whole FCM_S fixed point, as the TPU
    whole-solve does them, over lanes of ns pixels that ran iters
    iterations: once a lane, per pixel the neighbor count and intensity
    sum (2k), the count's floor, xbar and x_eff = (x + alpha xbar) / (1
    + alpha) (5); each iteration, per pixel and cluster the distance once
    (2), its k neighbors' shifted copies added (k) and the update."""
    return sum(n * (2 * k + 5) + it * n * c * (2 + k + _FCMS_OPS_PER_CLUSTER)
               for n, it in zip(ns, iters))


def check_spatial_steps(KSP, cases, card):
    """Step kernels vs their plain version on every case, each launched
    twice and required bit-equal; the 2-D kernel timed at the 1000 KB
    image (the main path's solve past the whole-solve bound), the 3-D one
    at the volume (the route's B=1 volume)."""
    out = {}
    for name, x, v, m, alpha, nb in cases:
        key = "3d" if x.dim() == 4 else "2d"
        fn = KSP.spatial_partials_3d if key == "3d" \
            else KSP.spatial_partials_2d
        args = () if key == "3d" else (nb,)
        got = fn(x, v, m, alpha, *args)
        torch.cuda.synchronize()
        again = fn(x, v, m, alpha, *args)
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"spatial step does not repeat bit for bit on {name}")
        err, rel = _close_sums(got, KSP.spatial_partials_plain(
            x, v, m, alpha, nb), f"spatial step {name}")
        e = out.setdefault(key, dict(max_abs_err=0.0, max_rel_err=0.0))
        e["max_abs_err"] = max(e["max_abs_err"], err)
        e["max_rel_err"] = max(e["max_rel_err"], rel)
        line = (f"  spatial step {name}: max abs err {err:.3g} (relative "
                f"{rel:.3g}), repeats bit for bit")
        if key == "3d":
            plan = KSP.spatial3d_plan(*x.shape[1:])
            line += (f"; march: {plan.tile[0]}x{plan.tile[1]} columns a "
                     f"block, {plan.runs} runs of {plan.z} planes, "
                     f"{plan.rows * x.shape[0]} blocks and partial rows, "
                     f"{plan.smem_bytes} B of staged tiles a block")
        else:
            plan = KSP.spatial2d_plan(*x.shape[1:])
            line += (f"; march: tasks of {plan.tile[0]} columns x "
                     f"{plan.run} rows, {plan.strips} strips x {plan.runs} "
                     f"runs, {plan.warps} a block, {plan.blocks * x.shape[0]} "
                     f"blocks")
            if name.startswith(("1000 KB, 4 nb", "noisy 217x181, 8 nb")):
                dms, per = device_ms(lambda: fn(x, v, m, alpha, *args))
                _one_kernel(per, f"spatial step {name}")
                line += f"; device {_fmt_ms(dms)} ({_kernel_names(per)})"
        if "ms" not in e and (name.startswith("1000 KB 4000")
                              or name.startswith("BrainWeb")):
            n = x[0].numel()
            c = v.shape[1]
            e["ms"] = time_ms(lambda: fn(x, v, m, alpha, *args))
            e["device_ms"], per = device_ms(lambda: fn(x, v, m, alpha, *args))
            if key == "2d":
                _one_kernel(per, f"spatial step {name}")
            e["plain_ms"] = time_ms(lambda: KSP.spatial_partials_plain(
                x, v, m, alpha, nb), reps=3, rounds=3)
            e["bound_ms"], e["bound_by"] = bound_ms(4 * (n + 3 * c),
                                                    _step_ops(n, c, nb))
            e["library_ms"] = None
            note_roofline("10" if key == "3d" else "9", "stencil", dict(
                h=n // x.shape[-1], w=x.shape[-1], c=c, neighbors=nb,
                n_iters=1, u_bytes=0), e["device_ms"], e["ms"],
                e["bound_ms"])
            line += (f"; kernel {e['ms']:.4f} ms, device "
                     + _fmt_ms(e["device_ms"])
                     + f" ({_kernel_names(per)}), plain "
                     f"{e['plain_ms']:.4f} ms, bound "
                     f"{e['bound_ms']:.5f} ms ({e['bound_by']}) [{card}]")
        print(line)
    return out["2d"], out["3d"]


def check_stencil(KST, SV, noisy_imgs, phantom, dev, card):
    """Stencil whole-solve vs its plain version: 64 noisy BrainWeb slices
    (the route's bucket), ragged lanes, two 8x64x64 volumes, c=8 with
    m=1.6; each case twice and bit-equal, lane 0 alone bit-equal to
    itself in the bucket, equal iterations, centers within RTOL/ATOL.
    Timed at the 64 slices."""
    pick = np.linspace(0, len(noisy_imgs) - 1, 64).round().astype(int)
    slices = np.stack([noisy_imgs[i] for i in pick]).astype(np.float32)
    const = np.full(slices.shape[1:], 77.0, np.float32)
    two = np.zeros(slices.shape[1:], np.float32)
    two[:, 90:] = 200.0
    vols = np.stack([phantom.noisy_phantom_volume(seed=s)[0]
                     for s in (0, 8)]).astype(np.float32)
    cases = [("64 noisy 217x181 slices, 8 nb", slices, 2.0, 1.0, 8, 4),
             ("ragged: a constant lane, a two-valued lane, 3 noisy slices, "
              "4 nb, alpha 2.5",
              np.stack([const, two, *slices[:3]]), 2.0, 2.5, 4, 4),
             ("two 8x64x64 volumes, 6 nb", vols, 2.0, 1.0, 6, 4),
             ("4 noisy slices, c=8, m=1.6", slices[:4], 1.6, 1.0, 8, 8)]
    from repro_torch.kernels import _build
    lib = _build.library()
    forms = {KST.OFF_CHIP: "off chip", KST.ON_CHIP_X: "x on chip",
             KST.ON_CHIP_X_EFF: "x and x_eff on chip"}
    worst, entry = 0.0, None
    for name, imgs, m, alpha, nb, c in cases:
        x = torch.from_numpy(imgs).to(dev)
        grid = (1,) * (4 - x.dim()) + tuple(x.shape[1:])
        plan = KST.stencil_plan(*grid, nb)
        v0, tol = SV.stencil_lane_init(x, c, 5e-3)
        v, delta, it = KST.stencil_solve(x, v0, tol, m, alpha, nb, 300)
        torch.cuda.synchronize()
        v2, delta2, it2 = KST.stencil_solve(x, v0, tol, m, alpha, nb, 300)
        require(torch.equal(v, v2) and torch.equal(it, it2)
                and torch.equal(delta, delta2),
                f"stencil solve does not repeat bit for bit on {name}")
        v1, delta1, it1 = KST.stencil_solve(
            x[:1].contiguous(), v0[:1].contiguous(), tol[:1].contiguous(),
            m, alpha, nb, 300)
        require(torch.equal(v1[0], v[0]) and torch.equal(it1[0], it[0])
                and torch.equal(delta1[0], delta[0]),
                f"stencil lane 0 of {name} differs solved alone")
        pv, pdelta, pit = KST.stencil_solve_plain(x, v0, tol, m, alpha, nb,
                                                  300)
        it_np, pit_np = it.cpu().numpy(), pit.cpu().numpy()
        if not np.array_equal(it_np, pit_np):
            bad = np.nonzero(it_np != pit_np)[0]
            margin = (pdelta.cpu().numpy() - tol.cpu().numpy())[bad]
            fail(f"stencil iteration counts differ on {name}: lanes "
                 f"{bad.tolist()} kernel {it_np[bad].tolist()} plain "
                 f"{pit_np[bad].tolist()}, delta - tol {margin.tolist()}")
        v_np, pv_np = v.cpu().numpy(), pv.cpu().numpy()
        require(np.isfinite(v_np).all(), f"non-finite centers on {name}")
        np.testing.assert_allclose(v_np, pv_np, rtol=RTOL, atol=ATOL,
                                   err_msg=f"stencil {name}")
        err = float(np.abs(v_np - pv_np).max())
        worst = max(worst, err)
        line = (f"  stencil {name}: iters equal {sorted(set(it_np.tolist()))}"
                f", max |dv| {err:.3g}, repeats bit for bit, lane 0 alone "
                f"bit-equal; {plan.ranks} blocks a lane, {forms[plan.form]}, "
                f"{plan.smem_bytes} B of shared memory a block")
        if entry is None:
            b, n = x.shape[0], x[0].numel()
            call = lambda: KST.stencil_solve(  # noqa: E731
                x, v0, tol, m, alpha, nb, 300)
            ms = time_ms(call, reps=5, rounds=5)
            dev_ms, per = device_ms(call)
            plain_ms = time_ms(lambda: KST.stencil_solve_plain(
                x, v0, tol, m, alpha, nb, 300), reps=1, rounds=3)
            bnd, by = bound_ms(4 * (b * n + 2 * b * c + 3 * b),
                               _stencil_ops([n] * b, it_np.tolist(), c, nb))
            active = lib.fcm_stencil_active_clusters(*grid, c, nb, plan.ranks,
                                                     plan.form)
            entry = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                         bound_ms=bnd, bound_by=by, library_ms=None)
            note_roofline("8", "stencil", dict(
                h=1, w=n, c=c, neighbors=nb, n_iters=int(it_np.sum()),
                u_bytes=0), dev_ms, ms, bnd)
            line += (f"; {active} clusters active at once for {b} lanes; "
                     f"kernel {ms:.4f} ms, device "
                     + ("not measured" if dev_ms is None else
                        f"{dev_ms:.4f} ms ({_kernel_names(per)})")
                     + f", plain {plain_ms:.4f} ms, bound {bnd:.5f} ms ({by})"
                     f" [{card}]")
        print(line)
    return dict(max_abs_err=worst, **entry)


def check_spatial_solves(SV, phantom, scfg, counters, images, dev):
    """solve(spatial_problem) on the card (auto with no device argument)
    and on the CPU for each (image, backend): equal iterations, centers
    within RTOL/ATOL, labels equal up to float64-checked near-ties, and
    the run's launches. Returns the launches of the 1000 KB auto run."""
    expect = {
        "auto, under the bound": lambda it: {"fcm_stencil_solve": 1},
        "resident": lambda it: {"fcm_stencil_solve": 1},
        "fused": lambda it: {"fcm_spatial_partials_2d": it},
        "reference": lambda it: {},
        "auto, 2-D past the bound": lambda it: {"fcm_spatial_partials_2d": it},
        "auto, volume": lambda it: {"fcm_spatial_partials_3d": it},
    }
    runs = [("217x181", "auto, under the bound"), ("217x181", "resident"),
            ("217x181", "fused"), ("217x181", "reference"),
            ("1000 KB 4000x256", "auto, 2-D past the bound"),
            ("volume 181x217x181", "auto, volume")]
    big_launches = None
    for img_name, run in runs:
        img, gt = images[img_name]
        backend = run.split(",")[0]
        nb = 6 if img.ndim == 3 else scfg.neighbors
        before = _counts(counters)
        card = SV.solve(SV.spatial_problem(
            img, scfg, device=None if backend == "auto" else dev), scfg,
            backend=backend)
        torch.cuda.synchronize()
        after = _counts(counters)
        used = {k: after[k] - before[k] for k in after
                if after[k] != before[k]}
        host = SV.solve(SV.spatial_problem(img, scfg, device="cpu"), scfg,
                        backend=backend)
        it = card.n_iters
        require(it == host.n_iters,
                f"spatial {img_name} {run}: n_iters {it} on the card, "
                f"{host.n_iters} on the CPU")
        np.testing.assert_allclose(card.centers.cpu().numpy(),
                                   host.centers.numpy(), rtol=RTOL,
                                   atol=ATOL,
                                   err_msg=f"spatial {img_name} {run}")
        ties = _spatial_near_ties(card.labels.cpu().numpy(),
                                  host.labels.numpy(), img,
                                  card.centers.cpu().numpy(), nb,
                                  scfg.alpha, f"spatial {img_name} {run}")
        require(used == expect[run](it),
                f"spatial {img_name} {run}: launches {used} for {it} "
                f"iterations, expected {expect[run](it)}")
        if run.endswith("past the bound"):
            big_launches = {k: after[k] - before[k] for k in after}
        dsc = phantom.dice_per_class(phantom.match_labels_to_classes(
            card.labels.cpu().numpy(), card.centers.cpu().numpy()), gt)
        print(f"  spatial solve {img_name} {run}: {it} iterations on both, "
              f"max |dv| "
              f"{float((card.centers.cpu() - host.centers).abs().max()):.3g}"
              f", {ties} labels differ (near-ties), DSC "
              f"{[round(float(d), 4) for d in dsc]}, launches {used}")
    return big_launches


def _hold_spatial(res, res_cpu, imgs, scfg, what):
    ties = 0
    for r, rc, im in zip(res, res_cpu, imgs):
        require(r.n_iters == rc.n_iters,
                f"{what} request {r.request_id}: n_iters {r.n_iters} on the "
                f"card, {rc.n_iters} on the CPU")
        require(np.isfinite(r.centers).all(), f"{what}: non-finite centers")
        np.testing.assert_allclose(r.centers, rc.centers, rtol=RTOL,
                                   atol=ATOL, err_msg=what)
        nb = 6 if im.ndim == 3 else scfg.neighbors
        ties += _spatial_near_ties(r.labels, rc.labels, im, r.centers, nb,
                                   scfg.alpha, f"{what} {r.request_id}")
    return ties


def spatial_route(FCMServeEngine, job, counters, noisy_imgs, noisy_gts,
                  big, big_gt, vol, vol_gt, phantom, dev, card):
    """181 noisy slices, the 1000 KB image and the volume through the
    spatial route against a CPU engine, each with the launch counts set to
    0 just before and read just after; returns the slices' and the
    volume's launches."""
    scfg, sizes = job.spatial, job.serving_batch_sizes
    eng = FCMServeEngine(job.fcm, batch_sizes=sizes, cache_size=0,
                         spatial_cfg=scfg, device=dev)
    cpu = FCMServeEngine(job.fcm, batch_sizes=sizes, cache_size=0,
                         spatial_cfg=scfg, device="cpu")
    zero = {k: 0 for k in counters}
    for fn in counters.values():
        fn.launches = 0
    res = eng.segment(noisy_imgs, method="spatial")
    sl_launches = _counts(counters)
    n_buckets = eng.stats()["spatial_batches"]
    print(f"  spatial route, {len(noisy_imgs)} noisy slices: {n_buckets} "
          f"buckets, launches {sl_launches}")
    require(n_buckets == 3, f"spatial route: {n_buckets} buckets, expected 3")
    require(sl_launches == {**zero, "fcm_stencil_solve": 3},
            f"spatial route launches {sl_launches}, expected 3 whole-solve")
    t0 = time.perf_counter()
    res_cpu = cpu.segment(noisy_imgs, method="spatial")
    t_cpu = time.perf_counter() - t0
    ties = _hold_spatial(res, res_cpu, noisy_imgs, scfg, "spatial slices")
    dsc = dsc_volume(res, noisy_gts, phantom)
    print(f"  against the CPU engine ({t_cpu:.1f} s there): n_iters equal, "
          f"{ties} of {sum(im.size for im in noisy_imgs)} labels differ "
          f"(near-ties); DSC per class {[round(float(d), 4) for d in dsc]}")
    require(min(dsc) >= SPATIAL_DSC, f"spatial route DSC {dsc}")
    eng.reset_stats()
    lat = serve_timed(eng, noisy_imgs, reps=10, method="spatial")
    p50 = float(np.median(lat))
    st = eng.stats()
    print(f"  spatial route {len(noisy_imgs)} slices: "
          f"{len(noisy_imgs) / p50:.1f} images/s, p50 flush "
          f"{p50 * 1e3:.2f} ms over 10 flushes, stage seconds "
          f"{st['stage_seconds']['spatial']} [{card}]")
    profile_flush(eng, noisy_imgs, card, method="spatial")

    img = big.reshape(-1, 256)
    for fn in counters.values():
        fn.launches = 0
    r = eng.segment([img], method="spatial")[0]
    used = _counts(counters)
    require(used == {**zero, "fcm_spatial_partials_2d": r.n_iters},
            f"1000 KB spatial request launched {used}")
    ties = _hold_spatial([r], cpu.segment([img], method="spatial"), [img],
                         scfg, "spatial 1000 KB")
    lat = serve_timed(eng, [img], reps=10, method="spatial")
    dsc = phantom.dice_per_class(phantom.match_labels_to_classes(
        r.labels, r.centers), big_gt.reshape(img.shape))
    print(f"  spatial route, the {BIG_BYTES // 1024} KB image at B=1: "
          f"{r.n_iters} iterations, {r.n_iters} step launches, {ties} "
          f"near-ties against the CPU engine, DSC "
          f"{[round(float(d), 4) for d in dsc]}; p50 flush "
          f"{float(np.median(lat)) * 1e3:.3f} ms [{card}]")
    profile_flush(eng, [img], card, method="spatial")

    for fn in counters.values():
        fn.launches = 0
    r = eng.segment([vol], method="spatial")[0]
    vol_launches = _counts(counters)
    require(vol_launches == {**zero, "fcm_spatial_partials_3d": r.n_iters},
            f"volume spatial request launched {vol_launches}")
    t0 = time.perf_counter()
    rc = cpu.segment([vol], method="spatial")
    t_cpu = time.perf_counter() - t0
    ties = _hold_spatial([r], rc, [vol], scfg, "spatial volume")
    dsc = phantom.dice_per_class(phantom.match_labels_to_classes(
        r.labels, r.centers), vol_gt)
    require(min(dsc) >= SPATIAL_DSC, f"spatial volume DSC {dsc}")
    lat = serve_timed(eng, [vol], reps=5, method="spatial")
    print(f"  spatial route, the volume {vol.shape} at B=1: {r.n_iters} "
          f"iterations, launches {vol_launches}, {ties} near-ties against "
          f"the CPU engine ({t_cpu:.1f} s there), DSC "
          f"{[round(float(d), 4) for d in dsc]}; p50 flush "
          f"{float(np.median(lat)) * 1e3:.2f} ms over 5 flushes [{card}]")
    profile_flush(eng, [vol], card, method="spatial")
    return sl_launches, vol_launches


def stencil_sweep(SV, KSP, KST, phantom, dev, card):
    """The whole-solve against the step kernels at B=1 on noisy 2-D images
    of 2^16, 2^18 and 2^20 pixels: host-clock ms of the batched solve
    (init, the loop, the last read of the centers) through each, taken in
    turns (:func:`paired_host_ms`), and each kernel's own time. Fails
    unless the whole-solve's least time beats the step path's at every
    swept size up to fcm_stencil.STENCIL_MAX_PIXELS and loses past it, so
    the sweep that set the dispatch bound also guards it. The step path
    is host-bound (a launch and a read of the lanes' flags an iteration),
    so its median follows the host's load from run to run; the least of
    SWEEP_TURNS turns is its own cost."""
    print(f"  whole-solve vs step kernels at B=1, 8 nb, alpha 1, least "
          f"(median) of {SWEEP_TURNS} turns each [{card}]")
    print("     pixels   iters  whole-solve ms     step path ms      (kernel "
          "alone: whole-solve ms, step ms x iters); iters are the "
          "whole-solve's / the step path's")
    wins = []
    for h, w in SWEEP_SHAPES:
        img = phantom.noisy_phantom_slice(h, w, seed=h)[0]
        x = torch.from_numpy(img.astype(np.float32)[None]).to(dev)
        iters = {impl: int(SV.stencil_batched_solve(
            x, 4, 2.0, 1.0, 8, 5e-3, 300, impl=impl)[2][0])
            for impl in ("resident", "fused")}
        (res, res_med), (step, step_med) = paired_host_ms(
            [lambda impl=impl: SV.stencil_batched_solve(
                x, 4, 2.0, 1.0, 8, 5e-3, 300, impl=impl)
             for impl in ("resident", "fused")], reps=SWEEP_TURNS)
        it = iters["resident"]
        v0, tol = SV.stencil_lane_init(x, 4, 5e-3)
        k_res = time_ms(lambda: KST.stencil_solve(x, v0, tol, 2.0, 1.0, 8,
                                                  300), reps=3, rounds=3)
        k_step = time_ms(lambda: KSP.spatial_partials_2d(x, v0, 2.0, 1.0,
                                                         8))
        print(f"  {h * w:9d} {it:3d}/{iters['fused']:<3d} "
              f"{res:7.3f} ({res_med:7.3f}) {step:7.3f} ({step_med:7.3f})  "
              f"({k_res:.3f}, {k_step:.4f} x {it})")
        if res < step:
            wins.append(h * w)
    print(f"  the whole-solve wins at {wins} pixels of the swept sizes; "
          f"fcm_stencil.STENCIL_MAX_PIXELS = {KST.STENCIL_MAX_PIXELS}")
    require(wins == [h * w for h, w in SWEEP_SHAPES
                     if h * w <= KST.STENCIL_MAX_PIXELS],
            f"the whole-solve wins at {wins} pixels of the swept sizes, "
            f"but auto sends lanes of up to {KST.STENCIL_MAX_PIXELS} pixels "
            f"to it")


def spatial_path(SV, KSP, KST, FCMServeEngine, job, counters, big, big_gt,
                 phantom, dev, card):
    """Phase 7; returns the whole-solve's and the two step kernels'
    entries."""
    n_slices, h, w = VOLUME
    vol, vol_gt = phantom.noisy_phantom_volume(n_slices, h, w)
    noisy_imgs, noisy_gts = list(vol), list(vol_gt)
    print("[spatial] step kernels (rows 9 and 10)")
    k_2d, k_3d = check_spatial_steps(KSP, spatial_step_cases(
        big, vol[n_slices // 2], vol, dev), card)
    print("[spatial] stencil whole-solve (row 8)")
    k_st = check_stencil(KST, SV, noisy_imgs, phantom, dev, card)
    print("[spatial] solve on the card vs the CPU")
    images = {"217x181": (vol[n_slices // 2], vol_gt[n_slices // 2]),
              "1000 KB 4000x256": (big.reshape(-1, 256),
                                   big_gt.reshape(-1, 256)),
              "volume 181x217x181": (vol, vol_gt)}
    big_launches = check_spatial_solves(SV, phantom, job.spatial, counters,
                                        images, dev)
    print("[spatial] spatial route")
    sl_launches, vol_launches = spatial_route(
        FCMServeEngine, job, counters, noisy_imgs, noisy_gts, big, big_gt,
        vol, vol_gt, phantom, dev, card)
    print("[spatial] whole-solve vs step kernels by lane size")
    stencil_sweep(SV, KSP, KST, phantom, dev, card)
    return {"fcm_stencil_solve": dict(
                launches=sl_launches["fcm_stencil_solve"], **k_st),
            "fcm_spatial_partials_2d": dict(
                launches=big_launches["fcm_spatial_partials_2d"], **k_2d),
            "fcm_spatial_partials_3d": dict(
                launches=vol_launches["fcm_spatial_partials_3d"], **k_3d)}


# ---------------------------------------------------------------------------
# Phase 8: Jamba's hybrid stack through loss_fn and make_train_step
# ---------------------------------------------------------------------------

ARCH = "jamba-v0.1-52b"
#: the selective scan against its plain version: at full width, the
#: small shape of the reduced config's train step, a ragged shape the
#: TPU kernel's tiling could not take, and one chunk (S under MIN_CHUNK:
#: the one launch stores the end state)
SELSCAN_CASES = ((1, 4096, 8192, 16), (2, 128, 128, 4), (1, 100, 96, 8),
                 (1, 24, 256, 16))
#: max |y_kernel - y_plain| against max |y|: both walk the same float32
#: recurrence; expf against PyTorch's exp and the order of the d_state sum
#: differ by rounding, which the decay keeps from growing along S
SELSCAN_TOL = 1e-4
#: loss of the full-width forward with the kernel against the plain scan:
#: bf16 activations round the two scans' float32 outputs, then 8 layers of
#: bf16 matmuls and top-2 routing act on the differences
LOSS_RTOL = 2e-3
#: the first mamba mixer's output, kernel against plain scan: the same
#: bf16 rounding of y (8 significant bits, 3.9e-3 relative) before one
#: bf16 projection, against max |y|
MIXER_TOL = 1e-2
#: three reduced train steps, card against CPU, both float32 (TF32 off):
#: losses and gradient norms, relative
TRAIN_RTOL = 1e-4


def selscan_inputs(b, s, di, ds, seed, dev):
    """Seeded scan inputs on the card, as the mixer makes them: dt in
    [1e-3, 0.1) (softplus of the projection), A = -exp(a_log) < 0."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    u = torch.randn((b, s, di), generator=g, device=dev)
    dt = torch.rand((b, s, di), generator=g, device=dev) * 0.099 + 1e-3
    bm = torch.randn((b, s, ds), generator=g, device=dev)
    cm = torch.randn((b, s, ds), generator=g, device=dev)
    a = -(torch.rand((di, ds), generator=g, device=dev) * 3.5 + 0.5)
    return u, dt, bm, cm, a


def check_selective_scan(KSS, dev, card):
    """8(a): the kernel against its plain version at SELSCAN_CASES, twice
    and bit-equal; with the end state (prefill's form): y bit-equal to the
    call without it, h_S against the plain recurrence's; the full-width
    case timed beside its bound, with and without the state."""
    worst_abs = worst_rel = worst_h = 0.0
    for i, shape in enumerate(SELSCAN_CASES):
        ins = selscan_inputs(*shape, seed=i, dev=dev)
        y = KSS.selective_scan(*ins)
        torch.cuda.synchronize()
        require(torch.equal(y, KSS.selective_scan(*ins)),
                f"selective_scan does not repeat bit for bit at {shape}")
        want, want_h = KSS.selective_scan_ref(*ins, return_state=True)
        err = float((y - want).abs().max())
        top = float(want.abs().max())
        rel = err / max(top, 1e-30)
        require(np.isfinite(err) and rel <= SELSCAN_TOL,
                f"selective_scan at {shape}: max abs err {err:.3g} is "
                f"{rel:.3g} of max|y| {top:.3g}, over {SELSCAN_TOL}")
        y_s, h = KSS.selective_scan(*ins, return_state=True)
        require(torch.equal(y_s, y), f"selective_scan at {shape}: y with "
                f"the end state differs from y without it")
        h_err = float((h - want_h).abs().max())
        h_top = float(want_h.abs().max())
        require(np.isfinite(h_err) and h_err <= SELSCAN_TOL * h_top,
                f"selective_scan at {shape}: end state max abs err "
                f"{h_err:.3g} over {SELSCAN_TOL} of max|h| {h_top:.3g}")
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
        worst_h = max(worst_h, h_err / max(h_top, 1e-30))
        print(f"  selective_scan (B, S, di, ds)={shape}: max abs err "
              f"{err:.3g}, {rel:.3g} of max|y| {top:.3g}, repeats bit for "
              f"bit; with the end state y bit-equal, h_S max abs err "
              f"{h_err:.3g} of max|h| {h_top:.3g}")
    b, s, di, ds = SELSCAN_CASES[0]
    ins = selscan_inputs(b, s, di, ds, seed=0, dev=dev)
    call = lambda: KSS.selective_scan(*ins)  # noqa: E731
    ms = time_ms(call, reps=10, rounds=5)
    dev_ms, per = device_ms(call)
    plain_ms = time_ms(lambda: KSS.selective_scan_ref(*ins), reps=1,
                       rounds=3)
    # u, dt, y: 12 B a (b, t, channel); B_t, C_t; A. Per state element:
    # dt*a, exp, da*h, times B, add, times C (and its fold add), plus
    # dt*u a channel
    bnd, by = bound_ms(4 * (3 * b * s * di + 2 * b * s * ds + di * ds),
                       6 * b * s * di * ds + b * s * di)
    # the chunked design's own traffic besides: u and dt read again by the
    # second walk; the end states written, read and rewritten by the carry,
    # read by the second walk; the dt sums written and read
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    chunk = KSS.chunk_len(b, s, di, sm)
    shapes = KSS.workspace_shapes(b, s, di, ds, chunk)
    ws = sum(4 * int(np.prod(sh)) for sh in shapes) if shapes else 0
    n_c = -(-s // chunk)
    extra = 8 * b * s * di + (4 * 4 * int(np.prod(shapes[0]))
                              + 2 * 4 * int(np.prod(shapes[1]))
                              if shapes else 0)
    print(f"  selective_scan {SELSCAN_CASES[0]}: chunks of L = {chunk} "
          f"positions ({n_c} chunks, {sm} SMs), workspace {ws} B, "
          f"{3 if shapes else 1} CUDA launches a call; the design moves "
          f"{extra} B besides the bound's, {bound_ms(extra, 0)[0]:.5f} ms "
          f"at the card's peak")
    print(f"  selective_scan {SELSCAN_CASES[0]}: kernel {ms:.4f} ms, device "
          + ("not measured" if dev_ms is None else
             f"{dev_ms:.4f} ms ({_kernel_names(per)})")
          + f", plain {plain_ms:.4f} ms, library -, bound {bnd:.5f} ms "
          f"({by}) [{card}]")
    # the end state's store, in turns with the call without it: plain,
    # state, state, plain (device time a call)
    state = lambda: KSS.selective_scan(*ins, return_state=True)  # noqa
    turns = [device_ms(f)[0] for f in (call, state, state, call)]
    state_ms = time_ms(state, reps=10, rounds=5)
    print(f"  selective_scan {SELSCAN_CASES[0]} with the end state: kernel "
          f"{state_ms:.4f} ms; device in turns without / with / with / "
          f"without: {' / '.join(_fmt_ms(t) for t in turns)}; the state "
          f"adds {4 * b * di * ds} B of stores [{card}]")
    return dict(max_abs_err=worst_abs, max_rel_err=worst_rel, ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bnd,
                bound_by=by, library_ms=None, state_ms=state_ms,
                state_device_ms=turns[1:3], stateless_device_ms=[
                    turns[0], turns[3]], state_max_rel_err=worst_h)


def jamba_forward(TC, TLM, TO, TT, L, S, counters, dev, card):
    """8(b): one full-width group of jamba-v0.1-52b (8 layers, d_model
    4096, 16 experts, vocab 65536), bf16 compute on float32 masters,
    through loss_fn on a seeded (1, 4096) batch, with the kernel and
    with the plain scan. Returns the kernel run's launches."""
    cfg = dataclasses.replace(TC.get_config(ARCH), n_layers=8,
                              mamba_pallas=True)
    plain = dataclasses.replace(cfg, mamba_pallas=False)
    t0 = time.perf_counter()
    params = TLM.init_params(0, cfg, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in TO.tree_leaves(params))
    print(f"  {cfg.name}, one group: {n_params / 1e9:.2f} B float32 "
          f"parameters drawn on the card in {time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, 4096), generator=g,
                           device=dev)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    with torch.no_grad():
        TT.loss_fn(params, batch, cfg, 0.01)          # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        total, metrics = TT.loss_fn(params, batch, cfg, 0.01)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        launches = _counts(counters)
        peak = torch.cuda.max_memory_allocated()
        require(launches == {**{k: 0 for k in counters},
                             "selective_scan": 7},
                f"the one-group forward launched {launches}, expected 7 "
                f"selective scans")
        runs = [first]
        for _ in range(2):
            t0 = time.perf_counter()
            TT.loss_fn(params, batch, cfg, 0.01)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        fwd = float(np.median(runs))
        profile_call(lambda: TT.loss_fn(params, batch, cfg, 0.01), card,
                     "of the one-group forward")
        loss = float(metrics["loss"])
        t0 = time.perf_counter()
        _, pm = TT.loss_fn(params, batch, plain, 0.01)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        loss_p = float(pm["loss"])
        rel = abs(loss - loss_p) / abs(loss_p)
        require(np.isfinite(loss) and rel <= LOSS_RTOL,
                f"full-width loss {loss!r} with the kernel, {loss_p!r} with "
                f"the plain scan: {rel:.3g} relative, over {LOSS_RTOL}")
        b0 = params["groups"][0]["b0"]
        h = L.rmsnorm(b0["norm1"], L.embed(params["embed"], tokens,
                                           cfg.dtype), cfg.norm_eps)
        yk = S.mamba_forward(b0["mixer"], h, cfg).float()
        yp = S.mamba_forward(b0["mixer"], h, plain).float()
        m_err = float((yk - yp).abs().max())
        m_top = float(yp.abs().max())
        require(m_err <= MIXER_TOL * m_top,
                f"first mamba mixer: max abs diff {m_err:.3g} over "
                f"{MIXER_TOL} of max|y| {m_top:.3g}")
    print(f"  loss_fn (1, 4096), bf16: kernel forward {fwd * 1e3:.1f} ms "
          f"(median of 3: {[round(r * 1e3, 1) for r in runs]}), "
          f"{4096 / fwd:.0f} tokens/s, peak {peak / 2**30:.2f} GiB "
          f"allocated; launches {launches} [{card}]")
    print(f"  loss {loss:.6f} with the kernel, {loss_p:.6f} with the plain "
          f"scan ({plain_s * 1e3:.0f} ms), {rel:.3g} relative; aux "
          f"{float(metrics['aux_loss']):.6f}; first mamba mixer max abs diff "
          f"{m_err:.3g} of max|y| {m_top:.3g}")
    del params
    torch.cuda.empty_cache()
    return launches


def jamba_train_steps(TC, TO, TT, counters, dev, card):
    """8(c): three make_train_step steps at the reduced config (one
    group, d_model 64, float32) with the kernel, on the card and with
    device="cpu", from the same parameters and batches."""
    cfg = dataclasses.replace(TC.get_config(ARCH).reduced(),
                              mamba_pallas=True)
    tcfg = TT.TrainConfig()
    state_cpu = TT.init_state(0, cfg, tcfg, device="cpu")
    state = TO.tree_map(lambda t: t.to(dev), state_cpu)
    step = TT.make_train_step(cfg, tcfg)
    rng = np.random.default_rng(8)
    for fn in counters.values():
        fn.launches = 0
    t_card = 0.0
    for i in range(3):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 128)))
        batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
        t0 = time.perf_counter()
        state, m = step(state, {k: v.to(dev) for k, v in batch.items()})
        torch.cuda.synchronize()
        t_card += time.perf_counter() - t0
        state_cpu, mc = step(state_cpu, batch)
        for k in ("loss", "grad_norm", "aux_loss"):
            a, b = float(m[k]), float(mc[k])
            require(np.isfinite(a) and abs(a - b) <= TRAIN_RTOL * abs(b),
                    f"train step {i} {k}: {a!r} on the card, {b!r} on the "
                    f"CPU")
        print(f"  step {i}: loss {float(m['loss']):.6f} (CPU "
              f"{float(mc['loss']):.6f}), grad norm "
              f"{float(m['grad_norm']):.6f} (CPU "
              f"{float(mc['grad_norm']):.6f})")
    launches = _counts(counters)
    require(launches["selective_scan"] > 0
            and sum(launches.values()) == launches["selective_scan"],
            f"train steps launched {launches}")
    print(f"  3 reduced train steps (2, 128) on the card in "
          f"{t_card * 1e3:.0f} ms, losses and grad norms within "
          f"{TRAIN_RTOL} of the CPU's; launches {launches} (forward and "
          f"its recompute) [{card}]")
    return launches


def lm_path(KSS, counters, dev, card):
    """Phase 8; returns the selective scan's entry."""
    from repro_torch import configs as TC
    from repro_torch.models import layers as L
    from repro_torch.models import lm as TLM
    from repro_torch.models import ssm as S
    from repro_torch.training import optimizer as TO
    from repro_torch.training import train_loop as TT
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 matmuls in full
    print("[lm] selective scan vs plain (8a)")
    k_scan = check_selective_scan(KSS, dev, card)
    print("[lm] full-width jamba-v0.1-52b, one group, loss_fn (8b)")
    fwd = jamba_forward(TC, TLM, TO, TT, L, S, counters, dev, card)
    print("[lm] reduced train steps, card vs CPU (8c)")
    jamba_train_steps(TC, TO, TT, counters, dev, card)
    return dict(launches=fwd["selective_scan"], **k_scan)


# ---------------------------------------------------------------------------
# Phase 9: async serving and chaos on the card
# ---------------------------------------------------------------------------

#: every wait of phase 9 on a future, seconds: a hang fails the phase
FUTURE_WAIT = 120.0
#: submitter threads of the async runs
SUBMITTERS = 4


def _resolve_all(futs, what):
    """{image index: result or exception} of (index, future) pairs; fails
    if a future is still pending after FUTURE_WAIT."""
    out = {}
    for i, f in futs:
        try:
            out[i] = f.result(timeout=FUTURE_WAIT)
        except TimeoutError:
            fail(f"{what}: request for image {i} unresolved after "
                 f"{FUTURE_WAIT} s")
        except Exception as e:  # noqa: BLE001 - typed errors are outcomes
            out[i] = e
    require(len(out) == len(futs) and all(f.done() for _, f in futs),
            f"{what}: not every future resolved")
    return out


def _submit_threads(eng, imgs, method="histogram"):
    """Submit image i from thread i % SUBMITTERS; returns [(i, future)]."""
    futs = []
    lock = threading.Lock()

    def worker(t):
        for i in range(t, len(imgs), SUBMITTERS):
            f = eng.submit_async(imgs[i], method=method)
            with lock:
                futs.append((i, f))

    ts = [threading.Thread(target=worker, args=(t,))
          for t in range(SUBMITTERS)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=FUTURE_WAIT)
        require(not t.is_alive(), "a submitter thread hung")
    return sorted(futs, key=lambda p: p[0])


def _flush_buckets(eng):
    """(flushes, bucket sizes as 'bucket:n', p50 flush wall ms, ms summed
    over the run by stage: gather, launch (fenced), scatter) from the
    engine's traces."""
    traces = eng.tracer.traces()
    buckets = [c for t in traces for c in t.get("children", ())
               if c["name"] == "bucket"]
    sizes = [f"{c['attrs']['bucket']}:{c['attrs']['n']}" for c in buckets]
    stages = {}
    for c in buckets:
        for s in c.get("children", ()):
            stages[s["name"]] = stages.get(s["name"], 0.0) + s["wall_s"] * 1e3
    flush_ms = float(np.median([t["wall_s"] for t in traces])) * 1e3
    return len(traces), sizes, flush_ms, stages


def _ladder_zero(eng, what):
    st = eng.stats()
    ft = st["fault_tolerance"]
    for k in ("retries", "degraded", "salvaged", "breaker_trips"):
        require(all(v == 0 for v in ft[k].values()),
                f"{what}: {k} {ft[k]} in a clean run")
    require(all(s == "closed" for s in ft["breaker_state"].values()),
            f"{what}: breakers {ft['breaker_state']}")
    require(eng.healthy(), f"{what}: engine not healthy")
    require(st["pending_futures"] == 0, f"{what}: futures still pending")


def _bit_equal(got, want, what):
    require(np.array_equal(got.centers, want.centers),
            f"{what}: centers differ from the synchronous run's")
    require(np.array_equal(got.labels, want.labels),
            f"{what}: labels differ from the synchronous run's")
    require(got.n_iters == want.n_iters,
            f"{what}: n_iters {got.n_iters} vs {want.n_iters}")


def _scalar_near_ties(got, want, img, centers, what):
    """Pixels where two scalar label maps differ; each must be a near-tie:
    the pixel's float64 squared distances to its two labels' centers
    within SPATIAL_TIE_RTOL. A histogram label flips every pixel of one
    value, so no share bound applies. Returns their count."""
    idx = np.flatnonzero(got != want)
    if idx.size:
        x = img.reshape(-1)[idx].astype(np.float64)
        v = np.asarray(centers, np.float64)
        a = (x - v[got.reshape(-1)[idx]]) ** 2
        b = (x - v[want.reshape(-1)[idx]]) ** 2
        bad = np.abs(a - b) > SPATIAL_TIE_RTOL * np.maximum(a, b)
        require(not bad.any(), f"{what}: {int(bad.sum())} labels differ by "
                f"more than a near-tie")
    return int(idx.size)


def _hold_degraded(res, ref, imgs, what):
    """Plain-solver results against the kernel path's: centers within
    RTOL/ATOL, n_iters equal, labels equal up to near-ties."""
    ties = 0
    for i, r in res.items():
        require(not isinstance(r, Exception), f"{what}: image {i}: {r!r}")
        np.testing.assert_allclose(r.centers, ref[i].centers, rtol=RTOL,
                                   atol=ATOL, err_msg=f"{what} image {i}")
        require(r.n_iters == ref[i].n_iters,
                f"{what}: image {i} n_iters {r.n_iters} vs "
                f"{ref[i].n_iters}")
        ties += _scalar_near_ties(r.labels, ref[i].labels, imgs[i],
                                  r.centers, f"{what} image {i}")
    return ties


def _async_run(FCMServeEngine, cfg, sizes, counters, imgs, method, ref,
               dev, card, what):
    """9a / 9b: the volume through submit_async from SUBMITTERS threads
    at max_wait_ms=10, held bit-equal to the synchronous run ``ref``."""
    eng = FCMServeEngine(cfg, batch_sizes=sizes, cache_size=0, device=dev,
                         max_wait_ms=10.0, trace_ring=4096)
    try:
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        futs = _submit_threads(eng, imgs, method=method)
        res = _resolve_all(futs, what)
        wall = max(f.resolve_t for _, f in futs) - t0
        launches = _counts(counters)
        require(len({r.request_id for r in res.values()}) == len(imgs),
                f"{what}: request ids not unique")
        for i, r in res.items():
            require(not isinstance(r, Exception), f"{what}: image {i}: "
                    f"{r!r}")
            _bit_equal(r, ref[i], f"{what} image {i}")
        _ladder_zero(eng, what)
        st = eng.stats()
        batches = st["batches" if method == "histogram" else
                     f"{method}_batches"]
        flushes, buckets, flush_ms, stages = _flush_buckets(eng)
        lat = np.array([f.latency_s for _, f in futs])
        return dict(launches=launches, batches=batches, wall=wall,
                         p50=float(np.percentile(lat, 50)),
                         p99=float(np.percentile(lat, 99)),
                         flushes=flushes, buckets=buckets,
                         flush_ms=flush_ms, stages=stages)
    finally:
        eng.shutdown()


def _print_async(what, n, run, card):
    print(f"  {what}: {n} requests from {SUBMITTERS} threads, bit-equal to "
          f"the synchronous run; submit-to-result p50 "
          f"{run['p50'] * 1e3:.2f} ms, p99 {run['p99'] * 1e3:.2f} ms, "
          f"{n / run['wall']:.1f} images/s, {run['flushes']} flushes "
          f"(p50 {run['flush_ms']:.2f} ms), buckets (size:real) "
          f"{run['buckets']}; ms summed over the run by stage "
          f"{ {k: round(v, 3) for k, v in run['stages'].items()} }; "
          f"launches { {k: v for k, v in run['launches'].items() if v} } "
          f"[{card}]")


def async_path(FCMServeEngine, TE, TFI, job, counters, imgs, dev, card):
    """Phase 9: async serving and the fault-tolerance ladder on the card."""
    from repro_torch.serving.admission import (DeadlineExceeded,
                                               EngineShutdown, Overloaded)
    cfg, sizes = job.fcm, job.serving_batch_sizes
    n = len(imgs)
    sync = FCMServeEngine(cfg, batch_sizes=sizes, cache_size=0, device=dev)
    ref_h = dict(enumerate(sync.segment(imgs)))
    ref_p = dict(enumerate(sync.segment(imgs, method="pixel")))

    print("[async] histogram route, full width (9a)")
    run = _async_run(FCMServeEngine, cfg, sizes, counters, imgs,
                        "histogram", ref_h, dev, card, "9a")
    want = {**{k: 0 for k in counters},
            **{k: run["batches"] for k in ("histogram_bin",
                                           "fcm_resident_solve", "labels")}}
    require(run["batches"] >= 3 and run["launches"] == want,
            f"9a: launches {run['launches']} for {run['batches']} buckets")
    _print_async("9a histogram", n, run, card)

    print("[async] pixel route (9b)")
    run = _async_run(FCMServeEngine, cfg, sizes, counters, imgs,
                        "pixel", ref_p, dev, card, "9b")
    want = {**{k: 0 for k in counters},
            **{k: run["batches"] for k in ("fcm_streamed_solve",
                                           "labels")}}
    require(run["batches"] >= 3 and run["launches"] == want,
            f"9b: launches {run['launches']} for {run['batches']} buckets")
    _print_async("9b pixel", n, run, card)

    print("[async] chaos on the card (9c)")
    kernels3 = ("histogram_bin", "fcm_resident_solve", "labels")

    def engine(specs, **kw):
        kw.setdefault("max_wait_ms", 1e6)
        return FCMServeEngine(cfg, batch_sizes=sizes, cache_size=0,
                              device=dev, retry_backoff_s=1e-3,
                              faults=TFI.FaultPlan(seed=25, specs=specs),
                              **kw)

    def submit_all(eng):
        futs = [(i, eng.submit_async(im)) for i, im in enumerate(imgs)]
        eng.drain()
        return futs

    # retries: the first two launch attempts fail, the third runs
    eng = engine((TFI.FaultSpec(site="launch", kind="error",
                                route="histogram", times=2),), retries=2)
    try:
        res = _resolve_all(submit_all(eng), "9c retries")
        ft = eng.stats()["fault_tolerance"]
        require(ft["retries"]["histogram"] == 2
                and ft["degraded"]["histogram"] == 0,
                f"9c retries: counters {ft}")
        for i, r in res.items():
            _bit_equal(r, ref_h[i], f"9c retries image {i}")
    finally:
        eng.shutdown()
    print(f"  retries: 2 failed launch attempts retried, route.retries 2, "
          f"{n} results bit-equal to 9a")

    # breaker: every attempt of the first two chunks fails (retries=1,
    # threshold 2): both degrade and the breaker opens; the later chunks
    # (at least one: 181 requests, 64 a chunk) find it open. All take the
    # plain solver on the card.
    eng = engine((TFI.FaultSpec(site="launch", kind="error",
                                route="histogram", times=4),),
                 retries=1, breaker_threshold=2, breaker_cooldown_s=0.5)
    seen, solve_ms = [], []
    real = TE.SV.solve_batched

    def spy(problem, cfg_=None, **kw):
        t = time.perf_counter()
        out = real(problem, cfg_, **kw)
        solve_ms.append((time.perf_counter() - t) * 1e3)
        seen.append((kw.get("backend"), out.centers.device.type))
        return out

    try:
        for fn in counters.values():
            fn.launches = 0
        TE.SV.solve_batched = spy
        try:
            t0 = time.perf_counter()
            res = _resolve_all(submit_all(eng), "9c breaker")
            t_deg = time.perf_counter() - t0
        finally:
            TE.SV.solve_batched = real
        ft = eng.stats()["fault_tolerance"]
        require(ft["retries"]["histogram"] == 2
                and ft["degraded"]["histogram"] == 2
                and ft["breaker_trips"]["histogram"] == 1
                and ft["breaker_state"]["histogram"] == "open",
                f"9c breaker: counters {ft}")
        require(len(seen) >= 3 and all(s == ("reference", "cuda")
                                       for s in seen),
                f"9c breaker: plain solves {seen}, expected a reference "
                f"solve on cuda for each of at least 3 chunks")
        require(sum(_counts(counters).values()) == 0,
                f"9c breaker: kernels launched {_counts(counters)} while "
                f"the route was degraded")
        ties = _hold_degraded(res, ref_h, imgs, "9c breaker")
        print(f"  breaker: 2 chunks degraded after 2 retries, 1 trip, "
              f"{len(seen) - 2} chunk(s) past the open breaker; {len(seen)} "
              f"plain solves (backend reference) on cuda of "
              f"{[round(t, 2) for t in solve_ms]} ms (chunks in "
              f"{t_deg * 1e3:.1f} ms), "
              f"centers within rtol {RTOL} / atol {ATOL} of 9a, n_iters "
              f"equal, {ties} label near-ties [{card}]")

        # recovery: after the cooldown a half-open probe runs the kernels
        time.sleep(0.6)
        for fn in counters.values():
            fn.launches = 0
        futs = [(i, eng.submit_async(imgs[i])) for i in range(16)]
        eng.drain()
        res = _resolve_all(futs, "9c recovery")
        launches = _counts(counters)
        ft = eng.stats()["fault_tolerance"]
        require(all(launches[k] == 1 for k in kernels3)
                and ft["breaker_state"]["histogram"] == "closed",
                f"9c recovery: launches {launches}, breakers "
                f"{ft['breaker_state']}")
        for i, r in res.items():
            _bit_equal(r, ref_h[i], f"9c recovery image {i}")
    finally:
        eng.shutdown()
    print(f"  recovery: after the 0.5 s cooldown the half-open probe "
          f"launched rows 1-3 once each, the breaker closed, 16 results "
          f"bit-equal to 9a")

    # salvage: lanes 0 and 5 of the first bucket poisoned after the solve
    eng = engine((TFI.FaultSpec(site="solve", kind="nan", route="histogram",
                                lanes=(0, 5), times=1),))
    try:
        futs = submit_all(eng)
        res = _resolve_all(futs, "9c salvage")
        ft = eng.stats()["fault_tolerance"]
        require(ft["salvaged"]["histogram"] == 2,
                f"9c salvage: counters {ft}")
        lane_of = {f.request_id: i for i, f in futs}
        poisoned = {lane_of[0], lane_of[5]}
        for i, r in res.items():
            if i not in poisoned:
                _bit_equal(r, ref_h[i], f"9c salvage batchmate {i}")
        ties = _hold_degraded({i: res[i] for i in poisoned}, ref_h, imgs,
                              "9c salvage")
    finally:
        eng.shutdown()
    print(f"  salvage: 2 poisoned lanes re-solved on the plain solver "
          f"(route.salvaged 2, {ties} label near-ties), {n - 2} batchmates "
          f"bit-equal to 9a")

    # flusher kill: the thread dies once and is replaced
    eng = engine((TFI.FaultSpec(site="flusher", kind="kill", times=1),),
                 max_wait_ms=10.0)
    try:
        res = _resolve_all(_submit_threads(eng, imgs), "9c kill")
        ft = eng.stats()["fault_tolerance"]
        require(ft["flusher_restarts"] >= 1 and ft["flusher_kills"] == 1,
                f"9c kill: {ft}")
        for i, r in res.items():
            require(not isinstance(r, Exception), f"9c kill: image {i}: "
                    f"{r!r}")
            _bit_equal(r, ref_h[i], f"9c kill image {i}")
    finally:
        eng.shutdown()
    print(f"  flusher kill: {ft['flusher_kills']} kill, "
          f"{ft['flusher_restarts']} restart(s), {n} futures resolved "
          f"bit-equal to 9a")

    # overload: a burst past max_queue_depth with mixed deadlines
    deadlines = [(None, 5.0, 0.02, 0.002)[i % 4] for i in range(n)]
    eng = engine((), max_wait_ms=10.0, max_queue_depth=64)
    try:
        futs = [(i, eng.submit_async(im, deadline=deadlines[i]))
                for i, im in enumerate(imgs)]
        res = _resolve_all(futs, "9c overload")
        kinds = {"result": 0, "Overloaded": 0, "DeadlineExceeded": 0}
        for i, r in res.items():
            if isinstance(r, (Overloaded, DeadlineExceeded)):
                kinds[type(r).__name__] += 1
            else:
                require(not isinstance(r, Exception),
                        f"9c overload: image {i}: {r!r}")
                _bit_equal(r, ref_h[i], f"9c overload image {i}")
                kinds["result"] += 1
        st = eng.stats()
        require(sum(kinds.values()) == n and kinds["Overloaded"]
                == st["fault_tolerance"]["shed"]["histogram"]
                and kinds["DeadlineExceeded"]
                == st["deadline_expired"]["histogram"],
                f"9c overload: outcomes {kinds}, stats "
                f"{st['fault_tolerance']['shed']}, "
                f"{st['deadline_expired']}")
    finally:
        eng.shutdown()
    print(f"  overload: {n} requests at max_queue_depth 64, deadlines "
          f"none/5 s/20 ms/2 ms: {kinds} (sum {sum(kinds.values())}), "
          f"results bit-equal to 9a [{card}]")

    # shutdown(drain=False): queued futures fail with EngineShutdown
    eng = engine(())
    futs = [(i, eng.submit_async(imgs[i])) for i in range(30)]
    eng.shutdown(drain=False)
    res = _resolve_all(futs, "9c shutdown")
    require(all(isinstance(r, EngineShutdown) for r in res.values()),
            f"9c shutdown: outcomes "
            f"{set(type(r).__name__ for r in res.values())}")
    print("  shutdown(drain=False): 30 queued futures failed with "
          "EngineShutdown")


def _timed_launches(eng, dev, submitting):
    """Wrap the engine's launch under the ladder so each bucket records
    the host's wall time in the launch call, CUDA events around it on the
    engine's stream (the device span from the call's start to its last
    kernel's end), and whether submitter threads were still running when
    it began. The launch span's wall less the call's is the fence's
    wait."""
    rec = []
    orig = eng._launch_attempts

    def timed(route, prog, inputs):
        stream = torch.cuda.current_stream(dev)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        busy = submitting.is_set()
        t0 = time.perf_counter()
        e0.record(stream)
        out = orig(route, prog, inputs)
        e1.record(stream)
        rec.append(dict(host=time.perf_counter() - t0, ev=(e0, e1),
                        busy=busy))
        return out

    eng._launch_attempts = timed
    return rec


def _anatomy(eng, rec, what, card):
    """Print where a run's flushes spent their time: bucket medians of the
    stages from the trace ring, the launch call's host time, the fence's
    wait and the device span, and each stage's median over the buckets
    begun while submitters ran and over those begun after."""
    torch.cuda.synchronize()
    buckets = [c for t in eng.tracer.traces() for c in t.get("children", ())
               if c["name"] == "bucket"]
    stage = {}
    for c in buckets:
        for sp in c.get("children", ()):
            stage.setdefault(sp["name"], []).append(sp["wall_s"] * 1e3)
    require(len(rec) == len(stage.get("launch", ())),
            f"{what}: {len(rec)} timed launches, "
            f"{len(stage.get('launch', ()))} launch spans")
    dev_ms = [r["ev"][0].elapsed_time(r["ev"][1]) for r in rec]
    fence = [w - r["host"] * 1e3 for w, r in zip(stage["launch"], rec)]
    busy = [r["busy"] for r in rec]

    def med(xs):
        return round(float(np.median(xs)), 3) if len(xs) else None

    def split(xs):
        return (med([x for x, b in zip(xs, busy) if b]),
                med([x for x, b in zip(xs, busy) if not b]))

    print(f"  {what}: {len(rec)} buckets ({sum(busy)} begun while "
          f"submitters ran); median ms a bucket: "
          f"{ {k: med(v) for k, v in stage.items()} }, launch call "
          f"{med([r['host'] * 1e3 for r in rec])}, fence wait {med(fence)}"
          f", device span {med(dev_ms)}; (while submitters ran, after): "
          f"{ {k: split(v) for k, v in stage.items()} }, device span "
          f"{split(dev_ms)} [{card}]")


def async_anatomy(FCMServeEngine, job, imgs, dev, card):
    """9d: where an async flush's time goes. The 9a run timed bucket by
    bucket on a fresh engine and again on the same (warm) engine; the
    volume six times over on a fresh engine, so that flushes overlap
    the submitters, at the interpreter's default switch interval and at
    0.1 ms; a synchronous flush of the volume for comparison; then the
    9a run under torch.profiler for the device's own events."""
    from torch.profiler import ProfilerActivity, profile
    cfg, sizes = job.fcm, job.serving_batch_sizes
    submitting = threading.Event()

    def engine():
        return FCMServeEngine(cfg, batch_sizes=sizes, cache_size=0,
                              device=dev, max_wait_ms=10.0, trace_ring=4096)

    def run(eng, rec, reps=1):
        rec.clear()
        eng.tracer.clear()
        submitting.set()
        try:
            futs = _submit_threads(eng, imgs * reps)
        finally:
            submitting.clear()
        _resolve_all(futs, "9d")
        eng.drain()     # waits for the last flush's trace

    eng = engine()
    try:
        rec = _timed_launches(eng, dev, submitting)
        run(eng, rec)
        _anatomy(eng, rec, "fresh engine (as 9a)", card)
        run(eng, rec)
        _anatomy(eng, rec, "the same engine again (warm)", card)
    finally:
        eng.shutdown()
    old = sys.getswitchinterval()
    for interval in (old, 1e-4):
        eng = engine()
        try:
            rec = _timed_launches(eng, dev, submitting)
            sys.setswitchinterval(interval)
            run(eng, rec, reps=6)
        finally:
            sys.setswitchinterval(old)
            eng.shutdown()
        _anatomy(eng, rec, f"fresh engine, the volume 6 times, switch "
                 f"interval {interval * 1e3:g} ms", card)
    eng = engine()
    try:
        rec = _timed_launches(eng, dev, submitting)
        eng.segment(imgs)
        eng.tracer.clear()
        rec.clear()
        eng.segment(imgs)
        _anatomy(eng, rec, "synchronous segment, warm, caller's thread",
                 card)
    finally:
        eng.shutdown()
    eng = engine()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(eng, [])
            wall = time.perf_counter() - t0
    finally:
        eng.shutdown()
    rows = []
    for e in prof.key_averages():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.key.startswith("Activity Buffer")):
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            rows.append((us, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) * 1e-3
    print(f"  profiled 9a run: wall {wall * 1e3:.2f} ms, device busy "
          f"{busy:.3f} ms [{card}]")
    for us, count, key in rows[:8]:
        print(f"    {us / 1e3:9.4f} ms  x{count:<4d} "
              f"({us / count:8.2f} us each) {key[:60]}")


# ---------------------------------------------------------------------------
# Phase 10: the mesh (one process, shards on the visible cards)
# ---------------------------------------------------------------------------

#: phase 10's meshes by shard count: (shape, axis names)
MESH_LAYOUTS = {1: ((1,), ("data",)), 2: ((2,), ("data",)),
                4: ((2, 2), ("data", "model"))}
#: phase 10c's buckets, and the flushes timed per engine and route
MESH_BUCKETS = (1, 8, 64)
MESH_FLUSHES = 5
#: 10a's second image: the 1000 KB image cut to an odd N (padding on
#: every mesh of more than one shard)
ODD_N = BIG_BYTES - 3


def mesh_of(TD, size):
    """A mesh of ``size`` shards over the visible cards, shard k on card
    k % count: one card is named more than once where fewer are
    visible."""
    shape, axes = MESH_LAYOUTS[size]
    n = torch.cuda.device_count()
    return TD.make_mesh(shape, axes, devices=[
        torch.device("cuda", k % n) for k in range(size)])


def _zero(counters):
    for fn in counters.values():
        fn.launches = 0


def sharded_fits(TD, SV, F, counters, x, what, dev, card):
    """10a on one image: fit_sharded in the pixel and histogram forms on
    meshes of 1, 2 and 4 shards, each held against the single-device
    solve on the card (the fused kernel) and on the CPU, with the launch
    counts set to 0 just before the fit and read just after."""
    cfg = F.FCMConfig(n_clusters=4, m=2.0, eps=5e-3, max_iters=300)
    x_dev = torch.from_numpy(x).to(dev)
    want = {"card": SV.solve(SV.pixel_problem(x_dev, device=dev), cfg,
                             backend="fused"),
            "cpu": SV.solve(SV.pixel_problem(x, device="cpu"), cfg,
                            backend="reference")}
    zero = {k: 0 for k in counters}
    for histogram in (False, True):
        form = "histogram" if histogram else "pixels"
        for size in (1, 2, 4):
            mesh = mesh_of(TD, size)
            _zero(counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = TD.fit_sharded(x_dev, mesh, cfg, histogram=histogram)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            used = _counts(counters)
            expect = ({**zero, "histogram_bin": size,
                       "fcm_resident_solve": 1, "labels": size}
                      if histogram else
                      {**zero, "fcm_fused_partials": size * res.n_iters,
                       "labels": size})
            tag = f"{what} {form} on {size} shard(s)"
            require(used == expect, f"{tag}: launches {used}, expected "
                    f"{ {k: v for k, v in expect.items() if v} }")
            got_v = res.centers.cpu().numpy()
            got_l = res.labels.cpu().numpy()
            require(got_l.shape == (x.size,) and np.isfinite(got_v).all(),
                    f"{tag}: labels {got_l.shape} or centers {got_v}")
            ties = {}
            for where, ref in want.items():
                np.testing.assert_allclose(
                    got_v, ref.centers.cpu().numpy(), rtol=RTOL, atol=ATOL,
                    err_msg=f"{tag} against the {where} solve")
                require(res.n_iters == ref.n_iters,
                        f"{tag}: n_iters {res.n_iters}, {ref.n_iters} in "
                        f"the {where} solve")
                ties[where] = _scalar_near_ties(
                    got_l, ref.labels.cpu().numpy(), x, got_v,
                    f"{tag} against the {where} solve")
            print(f"  {tag} {tuple(d.index for d in mesh.devices)}: "
                  f"{res.n_iters} iterations, {wall * 1e3:.2f} ms, "
                  f"launches { {k: v for k, v in used.items() if v} }, "
                  f"near-ties against the card / CPU solve {ties['card']} "
                  f"/ {ties['cpu']} [{card}]")


def batch_sharded_fit(TD, TB, SV, F, KB, counters, imgs, dev, card):
    """10b: fit_batched_sharded on the volume's slice histograms (181
    lanes, so padding lanes on 2 and 4 shards) against solve_batched on
    the card, bit for bit."""
    cfg = F.FCMConfig(n_clusters=4, m=2.0, eps=5e-3, max_iters=300)
    px = torch.from_numpy(np.stack([im.reshape(-1) for im in imgs])).to(dev)
    hists = KB.histogram_bin(px, 256)
    want = SV.solve_batched(SV.batch_problems(TB.hist_rows(hists), hists,
                                              device=dev), cfg)
    for size in (2, 4):
        _zero(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = TB.fit_batched_sharded(hists, mesh_of(TD, size), cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        used = _counts(counters)["fcm_resident_solve"]
        tag = f"batch-sharded fit of {len(imgs)} lanes on {size} shards"
        require(used == size, f"{tag}: {used} whole-solve launches")
        require(torch.equal(got.centers, want.centers),
                f"{tag}: centers differ from solve_batched's")
        require(np.array_equal(got.n_iters, want.n_iters)
                and got.total_iters == want.total_iters,
                f"{tag}: iterations differ from solve_batched's")
        print(f"  {tag}: bit-equal to solve_batched on the card, "
              f"total_iters {got.total_iters}, {used} launches of the "
              f"resident whole-solve, {wall * 1e3:.2f} ms [{card}]")


#: the kernels each route's program launches once a shard
MESH_ROUTE_KERNELS = {
    "histogram": ("histogram_bin", "fcm_resident_solve", "labels"),
    "pixel": ("fcm_streamed_solve", "labels"),
    "spatial": ("fcm_stencil_solve",)}


def _bit_equal_all(got, want, what):
    """Every result's labels, centers and n_iters bit-equal to the
    single-device engine's."""
    require(len(got) == len(want), f"{what}: {len(got)} results")
    for i, (g, w) in enumerate(zip(got, want)):
        require(np.array_equal(g.centers, w.centers)
                and np.array_equal(g.labels, w.labels)
                and g.n_iters == w.n_iters,
                f"{what} image {i}: differs from the single-device engine")


def _timed_flushes(eng, imgs, route):
    """p50 of MESH_FLUSHES synchronous flushes of ``imgs``, and the ms a
    flush spent in each bucket stage (gather, launch fenced, scatter)
    from the engine's traces."""
    eng.reset_stats()
    p50 = float(np.median(serve_timed(eng, imgs, MESH_FLUSHES,
                                      method=route)))
    stages = _flush_buckets(eng)[3]
    return p50, {k: round(v / MESH_FLUSHES, 3) for k, v in stages.items()}


def mesh_engine(TD, FCMServeEngine, job, counters, imgs, dev, card):
    """10c: the volume through the histogram, pixel and spatial routes of
    engines meshed on 2 and 4 shards, against a single-device engine on
    the card: bit-equal through segment and submit_async + drain, after
    set_mesh(None) and with a one-device mesh; the kernels launched once
    a shard a bucket, and a bucket of 1 on the single-device path."""
    def engine(mesh=None):
        return FCMServeEngine(job.fcm, batch_sizes=MESH_BUCKETS,
                              cache_size=0, spatial_cfg=job.spatial,
                              device=dev, mesh=mesh)

    single = engine()
    ref, timed = {}, {}
    for route in MESH_ROUTE_KERNELS:
        ref[route] = single.segment(imgs, method=route)
        timed[route] = _timed_flushes(single, imgs, route)
    single.shutdown()
    n_buckets = -(-len(imgs) // MESH_BUCKETS[-1])
    for size in (2, 4):
        mesh = mesh_of(TD, size)
        eng = engine(mesh)
        for route, kernels in MESH_ROUTE_KERNELS.items():
            tag = f"{route} route on {size} shards"
            _zero(counters)
            res = eng.segment(imgs, method=route)
            used = _counts(counters)
            expect = {k: (size * n_buckets if k in kernels else 0)
                      for k in counters}
            require(used == expect, f"{tag}: launches {used}, expected "
                    f"{size} a bucket of each of {kernels}")
            _bit_equal_all(res, ref[route], tag)
            lat, stages = _timed_flushes(eng, imgs, route)
            # async on an engine of its own, shut down (its flusher
            # joined) before the next synchronous flush: a flusher that
            # wakes as drain() ends may take requests another caller
            # queues for its own flush
            aeng = engine(mesh)
            futs = [aeng.submit_async(im, method=route) for im in imgs]
            aeng.drain()
            aeng.shutdown()
            _bit_equal_all([f.result(timeout=FUTURE_WAIT) for f in futs],
                           ref[route], f"{tag}, async")
            print(f"  {tag}: bit-equal to the single-device engine (segment "
                  f"and submit_async), launches "
                  f"{ {k: v for k, v in used.items() if v} }; p50 flush "
                  f"{lat * 1e3:.2f} ms meshed, {timed[route][0] * 1e3:.2f} "
                  f"ms single, over {MESH_FLUSHES} flushes; ms a flush by "
                  f"stage meshed {stages}, single {timed[route][1]} "
                  f"[{card}]")
        _zero(counters)
        one = eng.segment(imgs[:1])
        require(eng._mesh_for_bucket(1) is None
                and counters["histogram_bin"].launches == 1,
                f"a bucket of 1 on {size} shards launched "
                f"{counters['histogram_bin'].launches} binning kernels")
        _bit_equal_all(one, ref["histogram"][:1], "a bucket of 1")
        for label, other in (("set_mesh(None)", None),
                             ("a one-device mesh", mesh_of(TD, 1))):
            eng.set_mesh(other)
            for route in MESH_ROUTE_KERNELS:
                _bit_equal_all(eng.segment(imgs, method=route), ref[route],
                               f"{route} route after {label}")
        eng.shutdown()
        print(f"  {size} shards: a bucket of 1 ran the single-device path; "
              f"set_mesh(None) and a one-device mesh bit-equal on every "
              f"route")


def guard_us(_build, dev, calls=100_000):
    """Host microseconds of one enter and exit of the kernels' launch
    guard (``_build.on_device``) on a tensor of the current card: what
    every wrapper call pays for fault (k)'s repair."""
    x = torch.zeros(1, device=dev)
    t0 = time.perf_counter()
    for _ in range(calls):
        with _build.on_device(x):
            pass
    return (time.perf_counter() - t0) / calls * 1e6


def mesh_path(TD, TB, SV, F, KB, _build, FCMServeEngine, job, counters,
              imgs, big_u8, dev, card):
    """Phase 10: the pixel-sharded fit (10a), the batch-sharded fit (10b)
    and the meshed engine (10c)."""
    print(f"[mesh] {torch.cuda.device_count()} visible card(s); meshes name "
          f"card k % count for shard k [{card}]")
    print(f"  the launch guard: {guard_us(_build, dev):.3f} us an enter and "
          f"exit with the tensor's card current [{card}]")
    volume = np.stack(imgs).reshape(-1).astype(np.float32)
    odd = big_u8.reshape(-1)[:ODD_N].astype(np.float32)
    print("[mesh] 10a the pixel-sharded fit")
    sharded_fits(TD, SV, F, counters, volume,
                 f"{len(imgs)}-slice volume ({volume.size} px)", dev, card)
    sharded_fits(TD, SV, F, counters, odd, f"{ODD_N}-px image", dev, card)
    print("[mesh] 10b the batch-sharded fit")
    batch_sharded_fit(TD, TB, SV, F, KB, counters, imgs, dev, card)
    print("[mesh] 10c the meshed engine")
    mesh_engine(TD, FCMServeEngine, job, counters, imgs, dev, card)


# ---------------------------------------------------------------------------
# Phase 11: LM serving on the card (prefill, decode, ServeEngine)
# ---------------------------------------------------------------------------

#: 11a: llama3.2-1b whole, served at this batch, prompt and new tokens
SERVE_ARCH = "llama3.2-1b"
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 512, 64
#: a cache-path logit against the teacher-forced forward's at the same
#: position, as a share of that position's max |logit|: both run bf16
#: (8 significant bits, 3.9e-3 relative a rounding) through 16 layers of
#: GEMMs whose shapes differ between the two paths (B rows against B x S),
#: so their roundings differ at every layer. A token may differ from the
#: forward's argmax only where the forward's top-2 gap is within twice
#: this share (a near-tie: logits within the bound cannot swap otherwise)
SERVE_LOGIT_TOL = 2e-2
#: 11b: one full-width jamba group's prefill and decode
JAMBA_PREFILL = (2, 2048)
JAMBA_DECODE = 16
#: 11b, the kernel prefill against the plain one in float32 compute (TF32
#: off), relative RMS (||a - b|| / ||b||) of the last position's logits,
#: every layer's state and the KV cache: the two differ by the scan's
#: float32 roundings (about 1e-6 relative) carried through 8 float32
#: layers
JAMBA_F32_TOL = 1e-3
#: 11b in bf16, the served dtype: each scan's float32 y is rounded to bf16
#: before the next GEMM, so one rounding flip (3.9e-3 relative) in a layer
#: feeds every later one and grows with depth: on an H100 (this phase,
#: seed 11) the states were 0.5 % apart (relative RMS) after b1 and 9 %
#: after b7, while each mixer held on one input (SELSCAN_TOL on its
#: state, MIXER_TOL on y, the conv state equal) and the float32 pair
#: (1.2e-5 at most) showed the kernel and the loop alike. So the bf16
#: pair holds the last
#: position's logits alone, at this relative RMS, and prints its states;
#: its decode tokens are equal but at near-ties within 2 x this share of
#: a position's max |logit|
JAMBA_TOL = 5e-2
#: 11c: the reduced archs on the card against the CPU, float32 (TF32 off)
SERVE_CPU_ARCHS = ("llama3.2-1b", "granite-moe-3b-a800m", "jamba-v0.1-52b")
SERVE_CPU_RTOL = 1e-4


def _near_tie_tokens(got, logits_ref, tol, what):
    """Tokens ``got`` (B, N) against the argmax of ``logits_ref`` (B, N,
    V): a difference is excused only where the reference's top-2 gap is
    within 2 x tol x the position's max |logit|. Returns the number
    excused."""
    top2 = logits_ref.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    bound = 2 * tol * logits_ref.abs().amax(-1)
    differ = got != logits_ref.argmax(-1)
    bad = differ & (gap > bound)
    require(not bool(bad.any()), f"{what}: {int(bad.sum())} tokens differ "
            f"from the reference's argmax outside a near-tie")
    return int(differ.sum())


def serve_llama(TC, TLM, TSV, TO, counters, dev, card):
    """11a: llama3.2-1b at every published width through ServeEngine,
    each step's logits held against the teacher-forced forward."""
    cfg = TC.get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    params = TLM.init_params(0, cfg, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in TO.tree_leaves(params))
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab_size}, {n_params / 1e9:.3f} B float32 "
          f"parameters drawn on the card in {time.perf_counter() - t0:.1f} s"
          f", {str(cfg.dtype).split('.')[-1]} compute")
    b, plen, n_new = SERVE_BATCH, SERVE_PROMPT, SERVE_NEW
    prompts = np.random.default_rng(11).integers(
        0, cfg.vocab_size, (b, plen)).astype(np.int32)
    eng = TSV.ServeEngine(cfg, params, max_len=plen + n_new, batch_size=b)
    eng.generate(prompts, 2)                              # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    t0 = time.perf_counter()
    out = eng.generate(prompts, n_new)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    launches = _counts(counters)
    peak = torch.cuda.max_memory_allocated()
    require(out.shape == (b, plen + n_new)
            and np.array_equal(out[:, :plen], prompts)
            and ((out >= 0) & (out < cfg.vocab_size)).all(),
            "ServeEngine.generate returned a malformed batch")
    with torch.inference_mode():
        toks = torch.as_tensor(out, device=dev)
        cache = TLM.init_cache(cfg, b, plen + n_new, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = TLM.prefill(params, toks[:, :plen], cache, cfg)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        steps, step_ms = [logits[:, 0]], []
        for i in range(1, n_new):
            pos = plen + i - 1
            t0 = time.perf_counter()
            logits, cache = TLM.decode_step(params, toks[:, pos:pos + 1],
                                            cache, pos, cfg)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            steps.append(logits[:, 0])
        dec = torch.stack(steps, dim=1)                   # (B, N, V)
        require(torch.equal(dec.argmax(-1).cpu(),
                            torch.as_tensor(out[:, plen:], dtype=torch.long)),
                "the engine's tokens differ from the greedy argmax of the "
                "same prefill and decode steps run again")
        full, _ = TLM.forward(params, toks[:, :-1], cfg)
        ref = full[:, plen - 1:].float()                  # (B, N, V)
        scale = ref.abs().amax(-1)
        err = (dec - ref).abs().amax(-1)
        worst = float((err / scale).max())
        require(bool(torch.isfinite(dec).all()) and worst <= SERVE_LOGIT_TOL,
                f"decode logits against the forward: {worst:.3g} of the "
                f"position's max |logit|, over {SERVE_LOGIT_TOL}")
        excused = _near_tie_tokens(toks[:, plen:], ref, SERVE_LOGIT_TOL,
                                   "11a tokens against the forward")
        del full, ref, dec
        hot = [eng.generate(prompts[:, :plen - 16], 16, temperature=0.8,
                            seed=3)
               for _ in range(2)]
        require(np.array_equal(hot[0], hot[1])
                and ((hot[0] >= 0) & (hot[0] < cfg.vocab_size)).all(),
                "temperature 0.8 with one seed gave two token streams")
        # where a decode step's device time goes: the float32 -> bf16
        # casts of every weight (L.gathered) against the rest
        pos = plen + n_new - 1
        tok = toks[:, -1:]
        rows = profile_call(lambda: TLM.decode_step(
            params, tok, TLM.init_cache(cfg, b, plen + n_new, device=dev),
            pos, cfg), card, "of one decode step")
    dec_ms = float(np.median(step_ms))
    print(f"  ServeEngine.generate (B, prompt, new)=({b}, {plen}, {n_new}) "
          f"greedy: {t_gen * 1e3:.1f} ms, {b * n_new / t_gen:.1f} tokens/s; "
          f"prefill {prefill_ms:.2f} ms, decode {dec_ms:.3f} ms a token "
          f"(median of {len(step_ms)}; {min(step_ms):.3f}-"
          f"{max(step_ms):.3f}), {b / dec_ms * 1e3:.1f} tokens/s decoding; "
          f"peak {peak / 2**30:.2f} GiB allocated; launches "
          f"{ {k: v for k, v in launches.items() if v} } "
          f"[{card}]")
    print(f"  decode logits against the teacher-forced forward: worst "
          f"{worst:.3g} of the position's max |logit| (bound "
          f"{SERVE_LOGIT_TOL}); tokens differing from its argmax: "
          f"{excused} of {b * n_new}, each a near-tie within "
          f"{2 * SERVE_LOGIT_TOL} of the max; temperature 0.8 repeats with "
          f"its seed")
    if rows:
        total = sum(r[0] for r in rows)
        cast = sum(r[0] for r in rows if "copy" in r[2])
        cast_bytes = 6 * n_params
        print(f"  one decode step: {total / 1e3:.3f} ms of device time, "
              f"{cast / 1e3:.3f} ms ({100 * cast / total:.1f} %) in copy "
              f"kernels (the weights' float32 -> bf16 casts: "
              f"{cast_bytes / 1e9:.2f} GB moved, "
              f"{bound_ms(cast_bytes, 0)[0]:.3f} ms at the card's peak) "
              f"[{card}]")
    del params, eng, cache
    torch.cuda.empty_cache()
    return dict(prefill_ms=prefill_ms, decode_ms=dec_ms, excused=excused,
                worst=worst)


def _rms_rel(got, want):
    """||got - want|| / ||want||: a routing flip at one of the 4096
    positions moves it little, a wrong state or layout by O(1)."""
    d = (got.float() - want.float()).norm()
    return float(d / want.float().norm().clamp_min(1e-30))


def _max_rel(got, want):
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)


def jamba_layers_alike(B, L, S, params, cfg, plain, tokens, card):
    """11b, layer by layer: walk the group's prefill and hold each Mamba
    mixer's kernel form against its plain loop on the same input (the
    kernel prefill's): y within MIXER_TOL, the ssm state within
    SELSCAN_TOL, the conv state equal."""
    x = L.embed(params["embed"], tokens, cfg.dtype)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)[None]
    worst_y = worst_h = 0.0
    for i, desc in enumerate(cfg.group_layout):
        bp = params["groups"][0][f"b{i}"]
        if desc.mixer == "mamba":
            h = L.rmsnorm(bp["norm1"], x, cfg.norm_eps)
            yk, sk = S.mamba_forward(bp["mixer"], h, cfg, return_state=True)
            yp, sp = S.mamba_forward(bp["mixer"], h, plain,
                                     return_state=True)
            e_y, e_h = _max_rel(yk, yp), _max_rel(sk["ssm"], sp["ssm"])
            require(torch.equal(sk["conv"], sp["conv"]) and e_y <= MIXER_TOL
                    and e_h <= SELSCAN_TOL, f"b{i}'s mamba mixer on one "
                    f"input, kernel against plain: y {e_y:.3g} of max "
                    f"(bound {MIXER_TOL}), ssm state {e_h:.3g} (bound "
                    f"{SELSCAN_TOL}), conv equal: "
                    f"{torch.equal(sk['conv'], sp['conv'])}")
            worst_y, worst_h = max(worst_y, e_y), max(worst_h, e_h)
        cache = B.init_block_cache(cfg, desc, tokens.shape[0],
                                   tokens.shape[1], device=tokens.device)
        x, _ = B.block_prefill(bp, x, cfg, desc, cache, positions=positions)
    print(f"  each Mamba mixer on the kernel prefill's own input, kernel "
          f"against plain loop: y at most {worst_y:.3g} of max (bound "
          f"{MIXER_TOL}), ssm state at most {worst_h:.3g} (bound "
          f"{SELSCAN_TOL}), conv states equal [{card}]")


def jamba_prefill_pair(TLM, params, cfg, plain, tokens, max_len, counters):
    """The kernel prefill (twice: the second is timed) and the plain one
    of ``tokens``; their caches, logits, times and the launch checks."""
    runs = []
    for _ in range(2):
        _zero(counters)
        cache_k = TLM.init_cache(cfg, tokens.shape[0], max_len,
                                 device=tokens.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logit_k, cache_k = TLM.prefill(params, tokens, cache_k, cfg)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
        launches = _counts(counters)
        require(launches == {**{k: 0 for k in counters},
                             "selective_scan": 7},
                f"the kernel prefill launched {launches}, expected 7 "
                f"selective scans")
    _zero(counters)
    cache_p = TLM.init_cache(plain, tokens.shape[0], max_len,
                             device=tokens.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logit_p, cache_p = TLM.prefill(params, tokens, cache_p, plain)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    require(sum(_counts(counters).values()) == 0,
            f"the plain prefill launched {_counts(counters)}")
    return (logit_k, cache_k), (logit_p, cache_p), runs, plain_ms


def _prefill_diffs(cfg, k, p, s):
    """{leaf: (relative RMS, max-relative)} of the kernel prefill's
    logits and group cache against the plain one's."""
    (logit_k, cache_k), (logit_p, cache_p) = k, p
    pairs = {"logits": (logit_k, logit_p)}
    for i, d in enumerate(cfg.group_layout):
        bk, bp = cache_k[0][f"b{i}"], cache_p[0][f"b{i}"]
        if d.mixer == "mamba":
            for leaf in ("ssm", "conv"):
                pairs[f"b{i}.{leaf}"] = (bk["mamba"][leaf],
                                         bp["mamba"][leaf])
        else:
            for leaf in ("k", "v"):
                pairs[f"b{i}.{leaf}"] = (bk["attn"][leaf][:, :, :s],
                                         bp["attn"][leaf][:, :, :s])
    return {n: (_rms_rel(*v), _max_rel(*v)) for n, v in pairs.items()}


def serve_jamba_group(TC, TLM, TO, counters, dev, card):
    """11b: one full-width jamba-v0.1-52b group's prefill with the scan
    kernel's end state against the plain loop, in bf16 (served) and in
    float32 compute (held tight), each Mamba mixer on one input, then
    greedy decode from both bf16 caches."""
    from repro_torch.models import blocks as B
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as S
    cfg = dataclasses.replace(TC.get_config(ARCH), n_layers=8,
                              mamba_pallas=True)
    plain = dataclasses.replace(cfg, mamba_pallas=False)
    b, s = JAMBA_PREFILL
    max_len = s + JAMBA_DECODE
    t0 = time.perf_counter()
    params = TLM.init_params(0, cfg, device=dev)
    torch.cuda.synchronize()
    print(f"  {cfg.name}, one group: "
          f"{sum(t.numel() for t in TO.tree_leaves(params)) / 1e9:.2f} B "
          f"float32 parameters drawn in {time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                           device=dev)
    first = next(f"b{i}" for i, d in enumerate(cfg.group_layout)
                 if d.mixer == "mamba")
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.inference_mode():
        # float32 compute: the two prefills differ by the scan's float32
        # roundings alone, held at JAMBA_F32_TOL
        f32 = dataclasses.replace(cfg, dtype=torch.float32)
        k32, p32, runs32, plain32 = jamba_prefill_pair(
            TLM, params, f32, dataclasses.replace(f32, mamba_pallas=False),
            tokens, max_len, counters)
        d32 = _prefill_diffs(cfg, k32, p32, s)
        del k32, p32
        for n, (rms, top) in d32.items():
            require(np.isfinite(rms) and rms <= JAMBA_F32_TOL,
                    f"float32 compute, {n}, kernel against plain prefill: "
                    f"{rms:.3g} relative (RMS), over {JAMBA_F32_TOL}")
        torch.cuda.reset_peak_memory_stats()
        kb, pb, runs, plain_ms = jamba_prefill_pair(
            TLM, params, cfg, plain, tokens, max_len, counters)
        d16 = _prefill_diffs(cfg, kb, pb, s)
        (logit_k, cache_k), (_, cache_p) = kb, pb
        require(torch.equal(cache_k[0][first]["mamba"]["conv"],
                            cache_p[0][first]["mamba"]["conv"]),
                f"{first}'s conv state differs between the kernel and the "
                f"plain prefill")
        require(all(np.isfinite(rms) for rms, _ in d16.values())
                and d16["logits"][0] <= JAMBA_TOL, f"bf16 last-position "
                f"logits, kernel against plain prefill: {d16['logits'][0]:.3g}"
                f" relative (RMS), over {JAMBA_TOL}")
        del kb, pb
        tok = logit_k[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        _zero(counters)
        step_ms, toks_k, logits_p, dec_rms = [], [], [], 0.0
        for i in range(JAMBA_DECODE):
            pos = s + i
            t0 = time.perf_counter()
            lk, cache_k = TLM.decode_step(params, tok, cache_k, pos, cfg)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            lp, cache_p = TLM.decode_step(params, tok, cache_p, pos, plain)
            dec_rms = max(dec_rms, _rms_rel(lk, lp))
            tok = lk[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            toks_k.append(tok[:, 0])
            logits_p.append(lp[:, -1])
        require(sum(_counts(counters).values()) == 0,
                f"decoding launched {_counts(counters)}; decode takes the "
                f"plain recurrence")
        excused = _near_tie_tokens(torch.stack(toks_k, 1),
                                   torch.stack(logits_p, 1), JAMBA_TOL,
                                   "11b decode tokens, kernel against plain "
                                   "cache")
        peak = torch.cuda.max_memory_allocated()
        del cache_k, cache_p
        jamba_layers_alike(B, L, S, params, cfg, plain, tokens, card)
    dec = float(np.median(step_ms))
    print(f"  prefill (B, S)=({b}, {s}), bf16: kernel {runs[1]:.1f} ms "
          f"(first {runs[0]:.1f}), 7 selective scans; plain loop "
          f"{plain_ms:.1f} ms, none; float32 compute: kernel {runs32[1]:.1f}"
          f" ms, plain {plain32:.1f} ms; decode {dec:.2f} ms a token (median "
          f"of {JAMBA_DECODE}), {b / dec * 1e3:.1f} tokens/s; peak "
          f"{peak / 2**30:.2f} GiB allocated (bf16 pair and decode) [{card}]")
    for what, d in (("float32 compute", d32), ("bf16", d16)):
        print(f"  {what}, kernel against plain prefill, relative RMS "
              f"(max-relative): " + ", ".join(
                  f"{n} {rms:.2g} ({top:.2g})" for n, (rms, top) in d.items()))
    print(f"  {first}'s conv state equal in bf16; float32 pair within "
          f"{JAMBA_F32_TOL} relative RMS, bf16 logits within {JAMBA_TOL}; "
          f"bf16 decode from the two caches: logits at most {dec_rms:.2g} "
          f"relative RMS apart, tokens differing: {excused} of "
          f"{b * JAMBA_DECODE}, near-ties; no scan launched while decoding")
    del params
    torch.cuda.empty_cache()
    return dict(prefill_ms=runs[1], plain_prefill_ms=plain_ms,
                decode_ms=dec, launches=7)


def serve_card_vs_cpu(TC, TLM, TSV, TO, CK, counters, dev, card):
    """11c: reduced archs through ServeEngine on the card and with
    device="cpu", then the CLI on a checkpoint the port wrote."""
    import contextlib
    import io
    import tempfile
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(12)
    for arch in SERVE_CPU_ARCHS:
        cfg = TC.get_config(arch).reduced()
        if arch == ARCH:
            cfg = dataclasses.replace(cfg, mamba_pallas=True)
        params_cpu = TLM.init_params(0, cfg, device="cpu")
        params = TO.tree_map(lambda t: t.to(dev), params_cpu)
        prompts = rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
        _zero(counters)
        got = TSV.ServeEngine(cfg, params, 72, 2).generate(prompts, 8)
        launches = _counts(counters)
        want_scans = 7 if arch == ARCH else 0
        require(launches == {**{k: 0 for k in counters},
                             "selective_scan": want_scans},
                f"{arch}: ServeEngine launched {launches}")
        want = TSV.ServeEngine(cfg, params_cpu, 72, 2).generate(prompts, 8)
        require(np.array_equal(got, want), f"{arch}: the card's tokens "
                f"differ from the CPU's")
        with torch.inference_mode():
            lg, _ = TLM.prefill(params, torch.as_tensor(prompts, device=dev),
                                TLM.init_cache(cfg, 2, 72, device=dev), cfg)
            lc, _ = TLM.prefill(params_cpu, torch.as_tensor(prompts),
                                TLM.init_cache(cfg, 2, 72, device="cpu"),
                                cfg)
        err = float((lg.cpu() - lc).abs().max())
        top = float(lc.abs().max())
        require(err <= SERVE_CPU_RTOL * top, f"{arch}: prefill logits, card "
                f"against CPU: {err:.3g} over {SERVE_CPU_RTOL} of {top:.3g}")
        print(f"  {arch} reduced: tokens (2, 64 + 8) equal to the CPU's, "
              f"prefill logits max abs diff {err:.3g} of max {top:.3g}; "
              f"launches { {k: v for k, v in launches.items() if v} }")
    cfg = TC.get_config(SERVE_ARCH).reduced()
    params = TO.tree_map(lambda t: t * 1.5,
                         TLM.init_params(0, cfg, device=dev))
    with tempfile.TemporaryDirectory() as d:
        CK.save_checkpoint(d, {"params": params}, 1)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = TSV.main(["--arch", SERVE_ARCH, "--reduced", "--ckpt-dir",
                           d, "--device", "cuda", "--batch", "2",
                           "--prompt-len", "8", "--new-tokens", "12"])
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)
    want = TSV.ServeEngine(cfg, params, 20, 2).generate(prompts, 12)
    text = buf.getvalue()
    require(rc == 0 and all(f"-> {want[i, 8:20].tolist()}..." in text
                            for i in range(2)),
            f"launch.serve.main --ckpt-dir did not serve the checkpoint's "
            f"parameters: rc {rc}, output {text!r}")
    print(f"  launch.serve.main --ckpt-dir on the card: exit 0, tokens of "
          f"the checkpoint's parameters ({text.strip().splitlines()[-1]})")


def serve_path(counters, dev, card):
    """Phase 11; returns 11a's and 11b's figures."""
    from repro_torch import configs as TC
    from repro_torch.launch import serve as TSV
    from repro_torch.models import lm as TLM
    from repro_torch.training import checkpoint as CK
    from repro_torch.training import optimizer as TO
    print("[serve] llama3.2-1b whole through ServeEngine (11a)")
    llama = serve_llama(TC, TLM, TSV, TO, counters, dev, card)
    print("[serve] one full-width jamba-v0.1-52b group: prefill with the "
          "scan's end state against the plain loop, decode (11b)")
    jamba = serve_jamba_group(TC, TLM, TO, counters, dev, card)
    print("[serve] reduced archs, card against CPU, and the CLI on a "
          "checkpoint (11c)")
    serve_card_vs_cpu(TC, TLM, TSV, TO, CK, counters, dev, card)
    return dict(llama=llama, jamba=jamba)


# ---------------------------------------------------------------------------
# Phase 12: RWKV6, MLA, the whisper encoder and gated cross-attention
# ---------------------------------------------------------------------------

#: 12a: rwkv6-1.6b whole through ServeEngine: batch, prompt, new tokens
RWKV_SERVE = (4, 512, 32)
#: 12a, 12b, float32 compute (TF32 off): a decode step's logits against the
#: teacher-forced forward's, as a share of the position's max |logit|. In
#: bf16 the recurrent state carries each step's roundings on: on an H100
#: the bf16 decode's logits drifted from the forward's by 0.03 of the max
#: at step 1 to 0.42 at step 31 (24 layers; 0.004 at one layer, 0.02-0.03
#: at four), while the float32 pair agreed within 3e-4 at every step. So
#: bf16 holds the prefill's logits at SERVE_LOGIT_TOL and prints its
#: decode drift; float32 holds every step and the tokens at this share
F32_TOL = 1e-3
#: 12b, bf16: a position whose top-6 expert set differs between the cache
#: path and the forward (a near-tie in the router's float32 probabilities,
#: flipped by one bf16 rounding upstream) takes another sixth of its FFN:
#: on an H100, every 12b position over SERVE_LOGIT_TOL (5 of 32, up to
#: 0.17 of the max |logit|) was such a position, the others within 0.015,
#: and the float32 pair routed every position alike within 5e-5. So bf16
#: holds the positions routed alike at SERVE_LOGIT_TOL and counts the
#: others; float32 holds every position at F32_TOL, all routed alike
#: 12b: one full-width deepseek-v2-236b group: prefill (B, S), decode steps
MLA_PREFILL, MLA_DECODE = (2, 1024), 16
#: 12c: whisper-tiny whole (4 + 4 layers): batch, frames (its encoder's
#: 30-second window at 50 frames a second), prompt, new tokens
WHISPER_SERVE = (4, 1500, 64, 64)
#: 12d: one full-width llama-3.2-vision-90b group (the gated cross block
#: and four self blocks): prefill (B, S), decode steps
VISION_PREFILL, VISION_DECODE = (2, 512), 16
#: 12d, 12e: every tanh gate is opened to this before a run (a gate at
#: its initial 0 makes a cross block add nothing)
GATE_OPEN = 0.5
#: 12e: the four archs at their reduced configs, card against CPU
ARCHS12 = ("rwkv6-1.6b", "deepseek-v2-236b", "whisper-tiny",
           "llama-3.2-vision-90b")


def _draw(TLM, TO, cfg, dev, what):
    t0 = time.perf_counter()
    params = TLM.init_params(0, cfg, device=dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in TO.tree_leaves(params))
    enc = f" + {cfg.enc_layers} encoder layers" if cfg.enc_layers else ""
    print(f"  {what}: {cfg.n_layers} layers{enc}, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab_size}, {n / 1e9:.3f} B float32 parameters "
          f"drawn on the card in {time.perf_counter() - t0:.1f} s, "
          f"{str(cfg.dtype).split('.')[-1]} compute")
    return params


def _set_gates(params, value):
    """Every tanh gate of ``params`` set to ``value``; returns how many."""
    n = 0
    for group in params["groups"]:
        for blk in group.values():
            for sub in ("mixer", "cross"):
                if sub in blk and "gate" in blk[sub]:
                    blk[sub]["gate"].fill_(value)
                    n += 1
    return n


def _greedy(TLM, params, cfg, prompt, n_new, extra):
    """Prefill ``prompt`` (B, P) and decode ``n_new - 1`` greedy steps, each
    timed to a synchronize. Returns (tokens (B, P + n_new), the logits
    each new token was drawn from (B, n_new, V), prefill ms, step ms, the
    cache)."""
    b, plen = prompt.shape
    with torch.inference_mode():
        cache = TLM.init_cache(cfg, b, plen + n_new, device=prompt.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = TLM.prefill(params, prompt, cache, cfg, **extra)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        steps, step_ms = [logits[:, 0]], []
        toks = [prompt, logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)]
        for i in range(1, n_new):
            t0 = time.perf_counter()
            logits, cache = TLM.decode_step(params, toks[-1], cache,
                                            plen + i - 1, cfg)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            steps.append(logits[:, 0])
            toks.append(logits[:, -1].argmax(-1, keepdim=True).to(
                torch.int32))
    return (torch.cat(toks, dim=1), torch.stack(steps, dim=1), prefill_ms,
            step_ms, cache)


def _hold_to_forward(TLM, params, cfg, toks, dec, extra, what):
    """The cache path's logits ``dec`` (B, N, V), drawn at the last N
    positions of ``toks``, against the teacher-forced forward of the same
    stream: within SERVE_LOGIT_TOL of each position's max |logit|, tokens
    equal to its argmax but at counted near-ties. Returns (worst share,
    tokens excused)."""
    plen = toks.shape[1] - dec.shape[1]
    with torch.inference_mode():
        full, _ = TLM.forward(params, toks[:, :-1], cfg, **extra)
        ref = full[:, plen - 1:].float()
        del full
        worst = float(((dec - ref).abs().amax(-1)
                       / ref.abs().amax(-1)).max())
        require(bool(torch.isfinite(dec).all()) and worst <= SERVE_LOGIT_TOL,
                f"{what}: decode logits against the forward: {worst:.3g} of "
                f"the position's max |logit|, over {SERVE_LOGIT_TOL}")
        excused = _near_tie_tokens(toks[:, plen:], ref, SERVE_LOGIT_TOL,
                                   f"{what} tokens against the forward")
    return worst, excused


def _no_launches(counters, what):
    launches = _counts(counters)
    require(sum(launches.values()) == 0, f"{what} launched {launches}: no "
            f"kernel of the table lies on this path")


def _decode_line(what, b, n_new, prefill_ms, step_ms, worst, excused, peak,
                 card):
    dec = float(np.median(step_ms))
    print(f"  {what}: prefill {prefill_ms:.1f} ms, decode {dec:.2f} ms a "
          f"token (median of {len(step_ms)}; {min(step_ms):.2f}-"
          f"{max(step_ms):.2f}), {b / dec * 1e3:.1f} tokens/s decoding; "
          f"logits against the teacher-forced forward: worst {worst:.3g} of "
          f"the position's max |logit| (bound {SERVE_LOGIT_TOL}), tokens "
          f"differing from its argmax {excused} of {b * n_new}, each a "
          f"near-tie; peak {peak / 2**30:.2f} GiB allocated; launches none "
          f"[{card}]")
    return dec


def _engine_run(TSV, params, cfg, prompts, n_new, extra, counters, what):
    """A warm-up, then one timed greedy ServeEngine.generate with the
    launch counts set to 0 just before and read just after. Returns
    (tokens, seconds, peak bytes allocated)."""
    b, plen = prompts.shape
    eng = TSV.ServeEngine(cfg, params, max_len=plen + n_new, batch_size=b)
    eng.generate(prompts, 2, extra_inputs=extra)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    t0 = time.perf_counter()
    out = eng.generate(prompts, n_new, extra_inputs=extra)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    _no_launches(counters, f"{what} ServeEngine.generate")
    require(out.shape == (b, plen + n_new)
            and np.array_equal(out[:, :plen], prompts)
            and ((out >= 0) & (out < cfg.vocab_size)).all(),
            f"{what}: ServeEngine.generate returned a malformed batch")
    return out, t_gen, torch.cuda.max_memory_allocated()


def _wkv_share(TLM, S, params, cfg, prompt):
    """One prefill of ``prompt`` with CUDA events around each _wkv_scan:
    (the loops' summed spans in ms, the prefill's ms, loops seen)."""
    spans, real = [], S._wkv_scan

    def timed(*args):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*args)
        stop.record()
        spans.append((start, stop))
        return out

    S._wkv_scan = timed
    try:
        with torch.inference_mode():
            cache = TLM.init_cache(cfg, prompt.shape[0], prompt.shape[1],
                                   device=prompt.device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            TLM.prefill(params, prompt, cache, cfg)
            torch.cuda.synchronize()
            total = (time.perf_counter() - t0) * 1e3
    finally:
        S._wkv_scan = real
    return sum(a.elapsed_time(z) for a, z in spans), total, len(spans)


def serve_rwkv6(TC, TLM, TSV, TO, S, counters, dev, card):
    """12a: rwkv6-1.6b whole through ServeEngine in bf16 (timed), its
    cache path held against the teacher-forced forward: every step in
    float32 compute, the prefill's logits in bf16 (see F32_TOL); the
    wkv loop's share of a prefill."""
    cfg = TC.get_config("rwkv6-1.6b")
    params = _draw(TLM, TO, cfg, dev, cfg.name)
    b, plen, n_new = RWKV_SERVE
    prompts = np.random.default_rng(12).integers(
        0, cfg.vocab_size, (b, plen)).astype(np.int32)
    out, t_gen, peak = _engine_run(TSV, params, cfg, prompts, n_new, {},
                                   counters, "12a")
    prompt = torch.as_tensor(prompts, device=dev)
    toks, dec, prefill_ms, step_ms, _ = _greedy(TLM, params, cfg, prompt,
                                                n_new, {})
    require(np.array_equal(toks.cpu().numpy(), out), "12a: the engine's "
            "tokens differ from the same prefill and greedy steps run again")
    with torch.inference_mode():
        full, _ = TLM.forward(params, toks[:, :-1], cfg)
        ref = full[:, plen - 1:].float()
        del full
        share = ((dec - ref).abs().amax(-1) / ref.abs().amax(-1)).amax(0)
        differ = int((toks[:, plen:] != ref.argmax(-1)).sum())
        del ref
    require(bool(torch.isfinite(dec).all())
            and float(share[0]) <= SERVE_LOGIT_TOL, f"12a bf16: the "
            f"prefill's logits against the forward: {float(share[0]):.3g} of "
            f"the max |logit|, over {SERVE_LOGIT_TOL}")
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    toks32, dec32, prefill32, step32, _ = _greedy(TLM, params, f32, prompt,
                                                  n_new, {})
    worst32 = 0.0
    with torch.inference_mode():
        full, _ = TLM.forward(params, toks32[:, :-1], f32)
        ref = full[:, plen - 1:]
        del full
        worst32 = float(((dec32 - ref).abs().amax(-1)
                         / ref.abs().amax(-1)).max())
        require(worst32 <= F32_TOL, f"12a float32 compute: decode logits "
                f"against the forward: {worst32:.3g} of the position's max "
                f"|logit|, over {F32_TOL}")
        excused = _near_tie_tokens(toks32[:, plen:], ref, F32_TOL,
                                   "12a float32 tokens against the forward")
        del ref
    wkv_ms, share_ms, loops = _wkv_share(TLM, S, params, cfg, prompt)
    require(loops == cfg.n_layers, f"12a: {loops} wkv loops in a prefill of "
            f"{cfg.n_layers} layers")
    dec_ms = float(np.median(step_ms))
    print(f"  {cfg.name} ServeEngine (B, prompt, new)=({b}, {plen}, {n_new}) "
          f"greedy, bf16: {t_gen * 1e3:.1f} ms, {b * n_new / t_gen:.1f} "
          f"tokens/s; prefill {prefill_ms:.1f} ms, decode {dec_ms:.2f} ms a "
          f"token (median of {len(step_ms)}; {min(step_ms):.2f}-"
          f"{max(step_ms):.2f}), {b / dec_ms * 1e3:.1f} tokens/s decoding; "
          f"peak {peak / 2**30:.2f} GiB allocated; launches none [{card}]")
    print(f"  bf16 against the teacher-forced forward, share of the "
          f"position's max |logit|: prefill {float(share[0]):.3g} (bound "
          f"{SERVE_LOGIT_TOL}), decode steps "
          + " / ".join(f"{i}: {float(share[i]):.3g}"
                       for i in (1, n_new // 4, n_new // 2, n_new - 1))
          + f"; tokens differing from its argmax {differ} of {b * n_new}")
    print(f"  float32 compute (TF32 off): prefill {prefill32:.1f} ms, decode "
          f"{float(np.median(step32)):.2f} ms a token; every step within "
          f"{worst32:.3g} of the position's max |logit| of the forward (bound "
          f"{F32_TOL}), tokens differing from its argmax {excused} of "
          f"{b * n_new}, each a near-tie [{card}]")
    print(f"  the wkv loop in a bf16 prefill of ({b}, {plen}): {wkv_ms:.1f} ms "
          f"of {share_ms:.1f} ms ({100 * wkv_ms / share_ms:.1f} %), {loops} "
          f"loops of {plen} steps (CUDA events around each _wkv_scan) "
          f"[{card}]")
    del params
    torch.cuda.empty_cache()
    return dict(prefill_ms=prefill_ms, decode_ms=dec_ms, wkv_ms=wkv_ms,
                wkv_share=wkv_ms / share_ms, tokens_per_s=b * n_new / t_gen,
                bf16_last_share=float(share[-1]), f32_worst=worst32)


class _RouteLog:
    """Records the top-k expert ids of every MoE routing call (the MoE
    module's ``_route``) while open."""

    def __init__(self, M):
        self.M, self.real, self.ids = M, M._route, []

    def __enter__(self):
        def rec(xf, w, cfg):
            idx, gates, aux = self.real(xf, w, cfg)
            self.ids.append(torch.sort(idx, dim=-1).values)
            return idx, gates, aux
        self.M._route = rec
        return self

    def __exit__(self, *exc):
        self.M._route = self.real


def _mla_pair(TLM, M, params, cfg, prompt, n_new):
    """12b's cache path and teacher-forced forward in ``cfg.dtype``:
    (tokens, each step's logits share of the forward's max |logit| (B,
    N), positions routed to another expert set (B, N), the forward's
    logits, prefill ms, step ms, the cache, peak bytes)."""
    b, plen = prompt.shape
    torch.cuda.reset_peak_memory_stats()
    with _RouteLog(M) as log:
        toks, dec, prefill_ms, step_ms, cache = _greedy(
            TLM, params, cfg, prompt, n_new, {})
    peak = torch.cuda.max_memory_allocated()
    cached = torch.cat([log.ids[0].reshape(b, plen, -1)[:, -1:]]
                       + [i.reshape(b, 1, -1) for i in log.ids[1:]], dim=1)
    with _RouteLog(M) as log, torch.inference_mode():
        full, _ = TLM.forward(params, toks[:, :-1], cfg)
        ref = full[:, plen - 1:].float()
        del full
    fwd = log.ids[0].reshape(b, toks.shape[1] - 1, -1)[:, plen - 1:]
    flips = (cached != fwd).any(-1)
    share = (dec - ref).abs().amax(-1) / ref.abs().amax(-1)
    require(bool(torch.isfinite(dec).all()), f"12b {cfg.dtype}: non-finite "
            f"logits")
    return toks, share, flips, ref, prefill_ms, step_ms, cache, peak


def serve_mla_group(TC, TLM, TO, counters, dev, card):
    """12b: one full-width deepseek-v2-236b group (MLA and a 160-expert
    MoE): prefill, then greedy decode through the absorbed mla_decode, held
    against the forward's decompressed attention: in bf16 at the positions
    routed alike, in float32 compute at every position (see the comment
    on MLA_PREFILL)."""
    from repro_torch.models import moe as M
    full = TC.get_config("deepseek-v2-236b")
    e = full.moe
    # drop-free: the first-come capacity policy drops (token, slot) pairs
    # by token order, so a forward over S + n positions and a prefill over
    # S drop different pairs; with capacity >= the tokens, neither drops
    cf = e.n_experts / e.top_k * 1.001
    cfg = dataclasses.replace(full, n_layers=1, moe=dataclasses.replace(
        e, capacity_factor=cf))
    print(f"  cut: 1 of {full.n_layers} layers (one group); MoE "
          f"capacity_factor {e.capacity_factor} -> {cf:.4g} (drop-free)")
    params = _draw(TLM, TO, cfg, dev, cfg.name + ", one group")
    b, s = MLA_PREFILL
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    prompt = torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                           device=dev, dtype=torch.int32)
    _greedy(TLM, params, cfg, prompt[:, :64], 2, {})      # warm-up
    _zero(counters)
    toks, share, flips, ref, prefill_ms, step_ms, cache, peak = _mla_pair(
        TLM, M, params, cfg, prompt, MLA_DECODE)
    _no_launches(counters, "12b prefill and decode")
    kept = share[~flips]
    worst = float(kept.max()) if kept.numel() else 0.0
    require(worst <= SERVE_LOGIT_TOL, f"12b bf16: decode logits against the "
            f"forward at positions routed alike: {worst:.3g} of the "
            f"position's max |logit|, over {SERVE_LOGIT_TOL}")
    top2 = ref.topk(2, dim=-1).values
    differ = toks[:, s:] != ref.argmax(-1)
    bad = differ & ~flips & (top2[..., 0] - top2[..., 1]
                             > 2 * SERVE_LOGIT_TOL * ref.abs().amax(-1))
    require(not bool(bad.any()), f"12b bf16: {int(bad.sum())} tokens differ "
            f"from the forward's argmax outside a near-tie or a rerouted "
            f"position")
    routed_off = float(share[flips].max()) if bool(flips.any()) else 0.0
    attn = cache[0]["b0"]["attn"]
    require(set(attn) == {"c_kv", "k_rope"}, f"12b: the MLA cache holds "
            f"{sorted(attn)}")
    per_tok = sum(t.shape[-1] * t.element_size() for t in attn.values())
    m = cfg.mla
    values = m.kv_lora_rank + m.qk_rope_head_dim
    decomp = cfg.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim
                            + m.v_head_dim) * attn["c_kv"].element_size()
    require(per_tok == values * attn["c_kv"].element_size(),
            f"12b: {per_tok} cache bytes a token and layer, expected "
            f"{values} values")
    del cache, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    toks32, share32, flips32, ref32, prefill32, step32, _, _ = _mla_pair(
        TLM, M, params, f32, prompt, MLA_DECODE)
    worst32 = float(share32.max())
    require(worst32 <= F32_TOL and not bool(flips32.any()), f"12b float32 "
            f"compute: decode logits against the forward: {worst32:.3g} of "
            f"the position's max |logit| (bound {F32_TOL}), "
            f"{int(flips32.sum())} positions routed otherwise")
    excused32 = _near_tie_tokens(toks32[:, s:], ref32, F32_TOL,
                                 "12b float32 tokens against the forward")
    del ref32
    dec_ms = float(np.median(step_ms))
    print(f"  prefill (B, S)=({b}, {s}) + {MLA_DECODE} greedy tokens, bf16: "
          f"prefill {prefill_ms:.1f} ms, absorbed decode {dec_ms:.2f} ms a "
          f"token (median of {len(step_ms)}; {min(step_ms):.2f}-"
          f"{max(step_ms):.2f}), {b / dec_ms * 1e3:.1f} tokens/s decoding; "
          f"peak {peak / 2**30:.2f} GiB allocated; launches none [{card}]")
    print(f"  bf16 against the teacher-forced forward (decompressed): worst "
          f"{worst:.3g} of the position's max |logit| at the {int(kept.numel())}"
          f" positions routed alike (bound {SERVE_LOGIT_TOL}); "
          f"{int(flips.sum())} of {flips.numel()} positions routed to another "
          f"expert set (worst {routed_off:.3g} there); tokens differing from "
          f"its argmax {int(differ.sum())}, each a near-tie or rerouted")
    print(f"  float32 compute (TF32 off): prefill {prefill32:.1f} ms, decode "
          f"{float(np.median(step32)):.2f} ms a token; every step within "
          f"{worst32:.3g} of the forward (bound {F32_TOL}), every position "
          f"routed alike, tokens differing {excused32}, each a near-tie "
          f"[{card}]")
    print(f"  MLA cache: {per_tok} bytes a token and layer (c_kv "
          f"{m.kv_lora_rank} + k_rope {m.qk_rope_head_dim} = {values} "
          f"{str(cfg.dtype).split('.')[-1]} values, read off the cache); "
          f"decompressed K and V of {cfg.n_heads} heads would take {decomp} "
          f"bytes ({decomp / per_tok:.1f}x)")
    del params
    torch.cuda.empty_cache()
    return dict(prefill_ms=prefill_ms, decode_ms=dec_ms,
                cache_bytes=per_tok, decompressed_bytes=decomp,
                rerouted=int(flips.sum()))


def serve_whisper(TC, TLM, TSV, TO, counters, dev, card):
    """12c: whisper-tiny whole on 30-second frames through ServeEngine:
    the prefill's cross K/V hold the frames' length, and each step's
    logits are held against the teacher-forced forward."""
    cfg = TC.get_config("whisper-tiny")
    params = _draw(TLM, TO, cfg, dev, cfg.name)
    b, n_frames, plen, n_new = WHISPER_SERVE
    rng = np.random.default_rng(12)
    prompts = rng.integers(0, cfg.vocab_size, (b, plen)).astype(np.int32)
    extra = {"frames": torch.as_tensor(rng.standard_normal(
        (b, n_frames, cfg.d_model)), dtype=torch.float32, device=dev)}
    out, t_gen, peak = _engine_run(TSV, params, cfg, prompts, n_new, extra,
                                   counters, "12c")
    toks, dec, prefill_ms, step_ms, cache = _greedy(
        TLM, params, cfg, torch.as_tensor(prompts, device=dev), n_new, extra)
    require(np.array_equal(toks.cpu().numpy(), out), "12c: the engine's "
            "tokens differ from the same prefill and greedy steps run again")
    shapes = {tuple(gc["b0"]["cross_kv"][k].shape) for gc in cache
              for k in ("k", "v")}
    want = (b, cfg.n_kv_heads, n_frames, cfg.head_dim)
    require(shapes == {want}, f"12c: the prefill's cross K/V are {shapes}, "
            f"expected {want} (the frames' length, not max_len "
            f"{plen + n_new})")
    worst, excused = _hold_to_forward(TLM, params, cfg, toks, dec, extra,
                                      "12c")
    dec_ms = _decode_line(f"{cfg.name} ServeEngine (B, frames, prompt, new)="
                          f"({b}, {n_frames}, {plen}, {n_new}) greedy in "
                          f"{t_gen * 1e3:.1f} ms, "
                          f"{b * n_new / t_gen:.1f} tokens/s", b, n_new,
                          prefill_ms, step_ms, worst, excused, peak, card)
    print(f"  cross K/V after prefill: {want} in each of {cfg.n_groups} "
          f"decoder layers (the {n_frames} frames, not max_len "
          f"{plen + n_new})")
    del params, cache
    torch.cuda.empty_cache()
    return dict(prefill_ms=prefill_ms, decode_ms=dec_ms,
                tokens_per_s=b * n_new / t_gen)


def serve_vision_group(TC, TLM, TO, counters, dev, card):
    """12d: one full-width llama-3.2-vision-90b group, its gate opened, on
    seeded image memory: prefill and greedy decode held against the
    forward; the gate at 0 gives other logits."""
    full = TC.get_config("llama-3.2-vision-90b")
    cfg = dataclasses.replace(full, n_layers=len(full.group_layout))
    print(f"  cut: {cfg.n_layers} of {full.n_layers} layers (one group)")
    params = _draw(TLM, TO, cfg, dev, cfg.name + ", one group")
    opened = _set_gates(params, GATE_OPEN)
    require(opened == 1, f"12d: {opened} gates in one group")
    b, s = VISION_PREFILL
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    prompt = torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                           device=dev, dtype=torch.int32)
    extra = {"memory": torch.randn((b, cfg.n_img_tokens, cfg.d_model),
                                   generator=g, device=dev).to(cfg.dtype)}
    _greedy(TLM, params, cfg, prompt[:, :64], 2, extra)   # warm-up
    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    toks, dec, prefill_ms, step_ms, _ = _greedy(
        TLM, params, cfg, prompt, VISION_DECODE, extra)
    _no_launches(counters, "12d prefill and decode")
    peak = torch.cuda.max_memory_allocated()
    worst, excused = _hold_to_forward(TLM, params, cfg, toks, dec, extra,
                                      "12d")
    _set_gates(params, 0.0)
    with torch.inference_mode():
        closed, _ = TLM.prefill(params, prompt, TLM.init_cache(
            cfg, b, s, device=dev), cfg, **extra)
    moved = _rms_rel(closed[:, 0], dec[:, 0])
    require(moved > 1e-3, f"12d: the gate at 0 and at {GATE_OPEN} give "
            f"logits {moved:.3g} apart (relative RMS): the cross block "
            f"reads nothing")
    dec_ms = _decode_line(f"prefill (B, S)=({b}, {s}) on memory ({b}, "
                          f"{cfg.n_img_tokens}, {cfg.d_model}) + "
                          f"{VISION_DECODE} greedy tokens", b, VISION_DECODE,
                          prefill_ms, step_ms, worst, excused, peak, card)
    print(f"  the gate matters: prefill logits with the gate at 0 lie "
          f"{moved:.3g} (relative RMS) from those at {GATE_OPEN}")
    del params
    torch.cuda.empty_cache()
    return dict(prefill_ms=prefill_ms, decode_ms=dec_ms, gate_moved=moved)


def _reduced_extras(cfg, rng):
    """12e's memory inputs as numpy: prefill's keyword arguments and the
    training batch's keys."""
    kw, batch = {}, {}
    if cfg.n_img_tokens:
        kw["memory"] = batch["image_embeds"] = rng.standard_normal(
            (2, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        kw["frames"] = batch["frames"] = rng.standard_normal(
            (2, 40, cfg.d_model)).astype(np.float32)
    return kw, batch


def _card_vs_cpu_logits(TLM, params, cfg, prompts, got, on, dev, arch):
    """Prefill and 3 decode steps on the card and on the CPU; returns the
    worst logits difference, as a share of the CPU's max."""
    worst = 0.0
    plen = prompts.shape[1]
    with torch.inference_mode():
        caches = {d: TLM.init_cache(cfg, 2, plen + 8, device=d)
                  for d in (dev, "cpu")}
        for i in range(4):
            lg = {}
            for d in (dev, "cpu"):
                if i == 0:
                    lg[d], caches[d] = TLM.prefill(
                        params[d], torch.as_tensor(prompts, device=d),
                        caches[d], cfg, **on[d])
                else:
                    pos = plen + i - 1
                    lg[d], caches[d] = TLM.decode_step(
                        params[d], torch.as_tensor(got[:, pos:pos + 1],
                                                   device=d),
                        caches[d], pos, cfg)
            err = _max_rel(lg[dev].cpu(), lg["cpu"])
            require(err <= SERVE_CPU_RTOL, f"12e {arch}: "
                    f"{'prefill' if i == 0 else f'decode step {i}'} logits, "
                    f"card against CPU: {err:.3g} of the max, over "
                    f"{SERVE_CPU_RTOL}")
            worst = max(worst, err)
    return worst


def archs_card_vs_cpu(TC, TLM, TSV, TO, TT, counters, dev, card):
    """12e: the four archs at their reduced configs on the card against
    device="cpu" in float32 (TF32 off), gates opened: greedy tokens,
    prefill and decode logits, two train steps (losses, grad norms, every
    parameter and moment leaf); then launch.serve.main on the card."""
    import contextlib
    import io
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(13)
    for arch in ARCHS12:
        cfg = TC.get_config(arch).reduced()
        params = {"cpu": TLM.init_params(0, cfg, device="cpu")}
        _set_gates(params["cpu"], GATE_OPEN)
        params[dev] = TO.tree_map(lambda t: t.to(dev), params["cpu"])
        prompts = rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
        kw, extra_batch = _reduced_extras(cfg, rng)
        on = {d: {k: torch.as_tensor(v, device=d) for k, v in kw.items()}
              for d in (dev, "cpu")}
        _zero(counters)
        got = TSV.ServeEngine(cfg, params[dev], 72, 2).generate(
            prompts, 8, extra_inputs=on[dev])
        _no_launches(counters, f"12e {arch}")
        want = TSV.ServeEngine(cfg, params["cpu"], 72, 2).generate(
            prompts, 8, extra_inputs=on["cpu"])
        require(np.array_equal(got, want), f"12e {arch}: the card's tokens "
                f"differ from the CPU's")
        worst = _card_vs_cpu_logits(TLM, params, cfg, prompts, got, on, dev,
                                    arch)
        batch = dict(extra_batch, tokens=prompts,
                     labels=np.roll(prompts, -1, axis=1))
        # two steps: the warmup's learning rate is 0 at step 0, so the
        # first moves no parameter (its first moments hold the gradients)
        step = TT.make_train_step(cfg, TT.TrainConfig())
        states = {d: {"params": params[d], "opt": TO.init_opt_state(params[d]),
                      "step": torch.zeros((), dtype=torch.int32, device=d)}
                  for d in (dev, "cpu")}
        metrics = {}
        for i in range(2):
            for d in (dev, "cpu"):
                states[d], metrics[d] = step(states[d], {
                    k: torch.as_tensor(v, device=d) for k, v in batch.items()})
            for k in ("loss", "grad_norm"):
                a, c = float(metrics[dev][k]), float(metrics["cpu"][k])
                require(np.isfinite(a) and abs(a - c) <= TRAIN_RTOL * abs(c),
                        f"12e {arch} train step {i} {k}: {a!r} on the card, "
                        f"{c!r} on the CPU")
        leaves = list(zip(TO.tree_leaves([states[dev]["params"],
                                          states[dev]["opt"]]),
                          TO.tree_leaves([states["cpu"]["params"],
                                          states["cpu"]["opt"]])))
        leaf_err = max(_max_rel(a.cpu(), c) for a, c in leaves)
        require(leaf_err <= TRAIN_RTOL, f"12e {arch}: a parameter or moment "
                f"leaf after two train steps lies {leaf_err:.3g} of its max "
                f"from the CPU's, over {TRAIN_RTOL}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = TSV.main(["--arch", arch, "--reduced"])
        text = buf.getvalue()
        require(rc == 0 and "generated 4x32 tokens on cuda" in text,
                f"12e {arch}: launch.serve.main on the card: rc {rc}, "
                f"output {text!r}")
        print(f"  {arch} reduced: tokens (2, 64 + 8) equal to the CPU's; "
              f"prefill and 3 decode steps' logits within {worst:.3g} of the "
              f"max; two train steps: loss {float(metrics[dev]['loss']):.6f} "
              f"(CPU {float(metrics['cpu']['loss']):.6f}), {len(leaves)} "
              f"parameter and moment leaves within {leaf_err:.3g} of their "
              f"max; "
              f"launch.serve.main --reduced: "
              f"{text.strip().splitlines()[-1]}")


def archs_path(counters, dev, card):
    """Phase 12; returns 12a-12d's figures."""
    from repro_torch import configs as TC
    from repro_torch.launch import serve as TSV
    from repro_torch.models import lm as TLM
    from repro_torch.models import ssm as S
    from repro_torch.training import optimizer as TO
    from repro_torch.training import train_loop as TT
    out = {}
    steps = (
        ("12a", "rwkv6-1.6b whole through ServeEngine", "rwkv6",
         lambda: serve_rwkv6(TC, TLM, TSV, TO, S, counters, dev, card)),
        ("12b", "one full-width deepseek-v2-236b group: MLA prefill and "
         "absorbed decode", "mla",
         lambda: serve_mla_group(TC, TLM, TO, counters, dev, card)),
        ("12c", "whisper-tiny whole on 30-second frames through ServeEngine",
         "whisper",
         lambda: serve_whisper(TC, TLM, TSV, TO, counters, dev, card)),
        ("12d", "one full-width llama-3.2-vision-90b group, gate opened",
         "vision",
         lambda: serve_vision_group(TC, TLM, TO, counters, dev, card)),
        ("12e", "the four reduced archs, card against CPU, and the CLI",
         None,
         lambda: archs_card_vs_cpu(TC, TLM, TSV, TO, TT, counters, dev,
                                   card)),
    )
    for tag, what, key, run in steps:
        print(f"[archs] {what} ({tag})")
        t0 = time.perf_counter()
        res = run()
        if key:
            out[key] = res
        print(f"  {tag}: {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 13: LM training through the launcher
# ---------------------------------------------------------------------------

#: 13a: the launcher's defaults (batch 8, seq 128) on the whole
#: llama3.2-1b, for this many steps
TRAIN_ARCH = "llama3.2-1b"
TRAIN_STEPS = 20
#: 13b: jamba-v0.1-52b at its published widths, depth cut to its block 0
#: (Mamba mixer, SwiGLU FFN) repeated 4 times: (batch, seq, steps)
JAMBA_TRAIN = (2, 512, 4)
#: 13b: step 0's loss and gradient norm, kernel against the plain loop,
#: both float32 compute: the scans' outputs differ by rounding
#: (SELSCAN_TOL), and four layers and the backward act on them
JAMBA_TRAIN_RTOL = 1e-3
#: 13c: (tag, arch, mesh shape, axes, compress_cross_pod); each mesh
#: names the one card 2 or 4 times
TRAIN_MESHES = (
    ("llama pod2 int8", "llama3.2-1b", (2, 1, 1), ("pod", "data", "model"),
     True),
    ("llama pod2 dp2 int8", "llama3.2-1b", (2, 2, 1),
     ("pod", "data", "model"), True),
    ("llama dp2 tp2", "llama3.2-1b", (2, 2), ("data", "model"), False),
    ("granite dp2 tp2 EP", "granite-moe-3b-a800m", (2, 2), ("data", "model"),
     False),
    ("granite tp4 EP", "granite-moe-3b-a800m", (1, 4), ("data", "model"),
     False),
    ("jamba dp2 tp2", "jamba-v0.1-52b", (2, 2), ("data", "model"), False),
)
#: 13c / 13d: (batch, seq) of the reduced configs' steps
TRAIN_SHAPE = (4, 64)
#: 13d: the fault drill's steps, checkpoint interval and faulty step
DRILL = (20, 5, 12)


#: 13c: the absolute floor beside TRAIN_RTOL for parameter leaves (the
#: bar of tests/test_torch_lm.py): AdamW moves a leaf whose gradient is
#: rounding noise by about lr whatever its size, so a zero-initialised
#: bias is about 3e-6 in size after two warm-up steps, and its error
#: against its own max measures that noise
PARAM_ATOL = 1e-6


def _params_within(TO, got, want, what, dev=None):
    """Every leaf of ``got`` within TRAIN_RTOL of its max |want| plus
    PARAM_ATOL, leaf by leaf on ``dev`` (default each ``want`` leaf's
    device; a placed leaf gathered there); (the largest error against a
    leaf's max, the leaves not bit-equal)."""
    from repro_torch.models import sharding as sh
    worst, differ = 0.0, 0
    for i, (a, b) in enumerate(zip(TO.tree_leaves(got),
                                   TO.tree_leaves(want))):
        where = dev or sh.lead_device(b)
        a, b = sh.whole(a, where), sh.whole(b, where)
        d = float((a.float() - b.float()).abs().max())
        top = float(b.float().abs().max())
        require(d <= TRAIN_RTOL * top + PARAM_ATOL,
                f"{what}: leaf {i} lies {d:.3g} from the reference's, its "
                f"max |value| {top:.3g}")
        worst = max(worst, d / max(top, 1e-30))
        differ += not torch.equal(a, b)
    return worst, differ


def _whole_state(TO, state):
    """A state with each leaf placed across a mesh gathered whole on the
    CPU (plain leaves copied there)."""
    from repro_torch.models import sharding as sh
    return TO.tree_map(lambda x: sh.whole(x, "cpu"), state)


def _max_leaf_err(TO, got, want):
    """The largest |got - want| of a leaf against that leaf's max |want|."""
    return max(_max_rel(a.cpu(), b.cpu()) for a, b in
               zip(TO.tree_leaves(got), TO.tree_leaves(want)))


def train_llama_whole(TC, TLM, TO, TP, TT, TTR, counters, dev, card):
    """13a: ``launch.train.main`` on the whole llama3.2-1b at the
    launcher's defaults, 20 steps, no checkpoints (the card is the
    default device, one card gives no mesh)."""
    import contextlib
    import io
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = TTR.main(["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS)])
    wall = time.perf_counter() - t0
    launches = _counts(counters)
    text = buf.getvalue()
    lines = [ln for ln in text.splitlines() if ln.startswith("summary ")]
    require(rc == 0 and "training complete" in text and lines,
            f"13a launch.train.main: rc {rc}, output {text!r}")
    s = json.loads(lines[-1][len("summary "):])
    for ln in text.splitlines():
        if ln.startswith(("arch=", "step ")):
            print("  " + ln)
    require(s["steps"] == TRAIN_STEPS and s["restarts"] == 0,
            f"13a ran {s}")
    require(np.isfinite(s["loss_last"]) and s["loss_last"] < s["loss_first"],
            f"13a: loss {s['loss_first']} at step 0, {s['loss_last']} at "
            f"step {TRAIN_STEPS - 1}: it did not fall")
    require(sum(launches.values()) == 0,
            f"13a: the dense model launched {launches}")
    n = sum(t.numel() for t in TO.tree_leaves(
        TLM.abstract_params(TC.get_config(TRAIN_ARCH))))
    # where a step's time goes: one more step of the same run, profiled
    cfg = TC.get_config(TRAIN_ARCH)
    state, step_fn, _, _ = TTR.build(cfg, TT.TrainConfig(), device=dev)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in TP.make_batch(
        cfg, TC.ShapeConfig("train", "train", 128, 8), 0).items()}
    state, _ = step_fn(state, batch)
    holder = [state]

    def one():
        holder[0], m = step_fn(holder[0], batch)
        float(m["loss"])

    rows = profile_call(one, card, f"of a {TRAIN_ARCH} train step (13a)")
    gemm = sum(r[0] for r in rows if any(
        w in r[2].lower() for w in ("gemm", "sm90_xmma", "cutlass", "nvjet")))
    if rows:
        print(f"    GEMM kernels {gemm / 1e3:.2f} ms of "
              f"{sum(r[0] for r in rows) / 1e3:.2f} ms device time, "
              f"{len(rows)} kernel names")
    del holder, state
    torch.cuda.empty_cache()
    print(f"  13a {TRAIN_ARCH} whole ({n / 1e9:.4f} B float32 masters, bf16 "
          f"compute), (8, 128), {TRAIN_STEPS} steps in {wall:.1f} s: loss "
          f"{s['loss_first']:.4f} at step 0 -> {s['loss_last']:.4f} at step "
          f"{TRAIN_STEPS - 1}; step {s['step_ms_median']:.1f} ms (median "
          f"past step 0), {s['tokens_per_s']:.0f} tokens/s, peak "
          f"{s['peak_allocated_bytes'] / 2**30:.2f} GiB allocated, "
          f"straggler flags {s['straggler_flags']}; no kernel of the table "
          f"on this path [{card}]")
    return s


def train_jamba_wide(TC, TO, TT, TTR, counters, dev, card):
    """13b: jamba-v0.1-52b at every published width, depth cut to block 0
    repeated 4 times, float32 compute: 4 steps through the launcher's loop
    with ``mamba_pallas``, then step 0 with the plain loop from the same
    draw. Returns the scan's launches in the 4 steps."""
    b, s, steps = JAMBA_TRAIN
    cfg = _jamba_block0(TC)
    shape = TC.ShapeConfig("train", "train", s, b)
    quiet = lambda *_: None  # noqa: E731
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = TTR.train(cfg, shape, TT.TrainConfig(), steps, device=dev,
                    log=quiet)
    wall = time.perf_counter() - t0
    launches = _counts(counters)
    peak = torch.cuda.max_memory_allocated()
    n = sum(t.numel() for t in TO.tree_leaves(run.state["params"]))
    summ = TTR.summary(run, shape)
    # every Mamba layer's scan runs in each step's forward, and again in
    # as much of the recompute under remat as the backward asks for
    # (torch.utils.checkpoint stops a recompute once it has what it needs)
    want = launches["selective_scan"]
    require(want >= cfg.n_layers * steps and want % steps == 0
            and sum(launches.values()) == want,
            f"13b: {steps} steps launched {launches}: expected the "
            f"selective scan alone, at least {cfg.n_layers} a step")
    losses = [run.losses[i] for i in range(steps)]
    gn0 = run.grad_norms[0]
    del run
    torch.cuda.empty_cache()
    ref = TTR.train(dataclasses.replace(cfg, mamba_pallas=False), shape,
                    TT.TrainConfig(), 1, device=dev, log=quiet)
    require(_counts(counters)["selective_scan"] == want,
            "13b: the plain loop launched the scan")
    rels = []
    for what, a, p in (("loss", losses[0], ref.losses[0]),
                       ("gradient norm", gn0, ref.grad_norms[0])):
        rel = abs(a - p) / abs(p)
        rels.append(rel)
        require(np.isfinite(a) and rel <= JAMBA_TRAIN_RTOL,
                f"13b step 0 {what}: {a!r} with the kernel, {p!r} with the "
                f"plain loop, {rel:.3g} relative, over {JAMBA_TRAIN_RTOL}")
    plain_ms = ref.step_ms[0]
    print(f"  13b {ARCH} at its widths, block 0 x 4 ({n / 1e9:.4f} B "
          f"parameters, float32 compute), ({b}, {s}), {steps} steps through "
          f"launch.train.train in {wall:.1f} s: losses "
          f"{[round(v, 5) for v in losses]}; step {summ['step_ms_median']:.1f}"
          f" ms (median past step 0), plain-loop step 0 {plain_ms:.1f} ms; "
          f"peak {peak / 2**30:.2f} GiB allocated; selective_scan "
          f"{want} launches ({want // steps} a step: {cfg.n_layers} in the "
          f"forward, the rest in the recompute); "
          f"step 0 loss {losses[0]:.6f} (plain {ref.losses[0]:.6f}), grad "
          f"norm {gn0:.6f} (plain {ref.grad_norms[0]:.6f}), within "
          f"{max(rels):.3g} relative [{card}]")
    del ref
    torch.cuda.empty_cache()
    return want


def _mesh_steps(TC, TT, TP, sh, cfg, tcfg, params, mesh, dev, steps=2):
    """``steps`` train steps of ``cfg`` from ``params`` under ``mesh``
    (None: one device) with the state on ``dev``; (state, metrics,
    step-0 gradients of a compressed step or None)."""
    TO = TT.opt
    state = {"params": TO.tree_map(lambda t: t.to(dev), params),
             "opt": None, "step": torch.zeros((), dtype=torch.int32,
                                              device=dev)}
    state["opt"] = TO.init_opt_state(state["params"])
    b, s = TRAIN_SHAPE
    shape = TC.ShapeConfig("t", "train", s, b)
    step = TT.make_train_step(cfg, tcfg)
    metrics, grads = [], None
    with sh.parallelism(sh.make_parallelism(mesh)):
        for i in range(steps):
            batch = {k: torch.as_tensor(v).to(dev) for k, v in
                     TP.make_batch(cfg, shape, i).items()}
            if i == 0 and tcfg.compress_cross_pod:
                grads, _ = TT._pod_grads(state["params"], batch, cfg, tcfg,
                                         sh.current())
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics, grads


def train_meshes(TC, TD, TLM, TO, TT, TP, sh, counters, dev, card):
    """13c: 2 steps of each TRAIN_MESHES case at the reduced config on a
    mesh naming the card 2 or 4 times, against the same mesh of ``cpu``
    entries (losses and gradient norms within TRAIN_RTOL, every parameter
    leaf within TRAIN_RTOL of its max plus PARAM_ATOL; uncompressed,
    every moment leaf
    too; compressed, the step-0 int8 mean gradients within one
    quantization step of the CPU's and of the uncompressed per-pod
    mean, the moments being those gradients); the uncompressed dense
    case also against one device on the card. Returns the scan's
    launches of the jamba case."""
    scan = None
    for tag, arch, shape, axes, compress in TRAIN_MESHES:
        cfg = dataclasses.replace(TC.get_config(arch).reduced(),
                                  mamba_pallas=arch == ARCH)
        tcfg = TT.TrainConfig(compress_cross_pod=compress)
        n = int(np.prod(shape))
        params = TLM.init_params(0, cfg, device="cpu")
        card_mesh = TD.make_mesh(shape, axes, devices=[dev] * n)
        cpu_mesh = TD.make_mesh(shape, axes, devices=["cpu"] * n)
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        got, gm, gg = _mesh_steps(TC, TT, TP, sh, cfg, tcfg, params,
                                  card_mesh, dev)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = _counts(counters)
        want, wm, wg = _mesh_steps(TC, TT, TP, sh, cfg, tcfg, params,
                                   cpu_mesh, "cpu")
        for i, (a, c) in enumerate(zip(gm, wm)):
            for k in ("loss", "grad_norm", "aux_loss"):
                require(np.isfinite(a[k]) and abs(a[k] - c[k])
                        <= TRAIN_RTOL * abs(c[k]),
                        f"13c {tag} step {i} {k}: {a[k]!r} on the card, "
                        f"{c[k]!r} on the cpu mesh")
        p_err, _ = _params_within(TO, got["params"], want["params"],
                                  f"13c {tag}")
        notes = [f"parameters within {p_err:.3g} of their max (+ "
                 f"{PARAM_ATOL:g})"]
        if compress:
            pods = shape[0]
            worst_q = worst_mean = 0.0
            flips = 0
            b = TRAIN_SHAPE[0]
            batch = {k: torch.as_tensor(v) for k, v in TP.make_batch(
                cfg, TC.ShapeConfig("t", "train", TRAIN_SHAPE[1], b),
                0).items()}
            per_pod = []
            for k in range(pods):
                sub = sh.sub_mesh(cpu_mesh, "pod", k)
                with sh.parallelism(sh.make_parallelism(sub)):
                    per_pod.append(TT._microbatch_grads(
                        params, {n_: v[k * b // pods:(k + 1) * b // pods]
                                 for n_, v in batch.items()}, cfg, tcfg)[0])
            for g, w, *pp in zip(*(TO.tree_leaves(t) for t in
                                   [gg, wg] + per_pod)):
                q = max(float(x.abs().max()) for x in pp) / 127.0
                d = (g.cpu() - w).abs()
                worst_q = max(worst_q, float(d.max()) / max(q, 1e-30))
                flips += int((d > 0.25 * q).sum())
                mean = sum(pp) / pods
                worst_mean = max(worst_mean, float(
                    (g.cpu() - mean).abs().max()) / max(q, 1e-30))
            require(worst_q <= 1.0 and worst_mean <= 1.0,
                    f"13c {tag}: the int8 mean gradients lie {worst_q:.3g} "
                    f"quantization steps from the cpu mesh's and "
                    f"{worst_mean:.3g} from the uncompressed mean")
            notes.append(f"int8 mean gradients within {worst_q:.3g} "
                         f"quantization steps of the cpu mesh's ({flips} "
                         f"elements a rounding apart) and {worst_mean:.3g} "
                         f"of the uncompressed mean")
        else:
            m_err = _max_leaf_err(TO, got["opt"], want["opt"])
            require(m_err <= TRAIN_RTOL, f"13c {tag}: a moment leaf lies "
                    f"{m_err:.3g} of its max from the cpu mesh's")
            notes.append(f"moments within {m_err:.3g}")
        if not compress and cfg.moe is None and arch != ARCH:
            one, om, _ = _mesh_steps(TC, TT, TP, sh, cfg, tcfg, params,
                                     None, dev)
            same = all(torch.equal(a, c) for a, c in zip(
                TO.tree_leaves(got), TO.tree_leaves(one)))
            o_err = _max_leaf_err(TO, got, one)
            require(o_err <= TRAIN_RTOL and [m["loss"] for m in om]
                    == [m["loss"] for m in gm],
                    f"13c {tag}: the mesh step lies {o_err:.3g} from one "
                    f"device's on the card")
            notes.append("one device's state "
                         + ("bit for bit" if same else f"within {o_err:.3g}"))
        if arch == ARCH:
            n_mamba = sum(d.mixer == "mamba" for d in cfg.group_layout)
            dp = dict(zip(axes, shape))["data"]
            scan = launches["selective_scan"]
            require(scan >= 2 * n_mamba * dp and scan % dp == 0
                    and sum(launches.values()) == scan,
                    f"13c {tag}: launched {launches}: expected the scan "
                    f"alone, once a dp shard, at least {n_mamba} Mamba "
                    f"layers x {dp} shards x 2 steps")
        else:
            require(sum(launches.values()) == 0,
                    f"13c {tag}: launched {launches}")
        print(f"  13c {tag} {dict(zip(axes, shape))}: 2 steps in {ms:.0f} ms"
              f" on the card, losses {[round(m['loss'], 6) for m in gm]} "
              f"(cpu mesh {[round(m['loss'], 6) for m in wm]}); "
              + "; ".join(notes) + f"; launches {launches} [{card}]")
    return scan


def fault_drill(TC, TD, TO, TT, TTR, TE, TP, dev, card):
    """13d: the fault drill at reduced llama3.2-1b, in a temporary
    directory the phase deletes: a pipeline that raises once at step 12
    (--ckpt-every 5, --steps 20) restarts from step 10's checkpoint and
    ends at an uninterrupted run's state; a 4-shard checkpoint resumed on
    2 shards through reshard_state takes 2 steps alike the 4-shard run's;
    a stalled step is flagged by StepTimer."""
    import shutil
    import tempfile
    steps, every, at = DRILL
    cfg = TC.get_config(TRAIN_ARCH).reduced()
    b, s = TRAIN_SHAPE
    shape = TC.ShapeConfig("train", "train", s, b)
    tcfg = TT.TrainConfig()
    quiet = lambda *_: None  # noqa: E731
    fired = []

    def faulty(cfg_, shape_, start):
        for i, batch in enumerate(TP.batches(cfg_, shape_, start)):
            if start + i == at and not fired:
                fired.append(start + i)
                raise RuntimeError(f"injected fault at step {at}")
            yield batch

    def arrays(d, step):
        with np.load(os.path.join(d, f"step_{step:08d}",
                                  "arrays.npz")) as z:
            return {k: z[k] for k in z.files}

    tmp = tempfile.mkdtemp(prefix="chip_smoke_drill_")
    try:
        t0 = time.perf_counter()
        clean = TTR.train(cfg, shape, tcfg, steps, device=dev,
                          ckpt_dir=os.path.join(tmp, "clean"),
                          ckpt_every=every, log=quiet)
        resumed_from = []
        real = TTR.ckpt.load_checkpoint
        TTR.ckpt.load_checkpoint = lambda d, like, **kw: (
            resumed_from.append(TTR.ckpt.latest_step(d)) or real(d, like,
                                                                 **kw))
        try:
            drill = TTR.train(cfg, shape, tcfg, steps, device=dev,
                              ckpt_dir=os.path.join(tmp, "drill"),
                              ckpt_every=every, batches=faulty, log=quiet)
        finally:
            TTR.ckpt.load_checkpoint = real
        wall = time.perf_counter() - t0
        require(fired == [at] and drill.restarts == 1
                and resumed_from == [10],
                f"13d: fault at {fired}, {drill.restarts} restarts, resumed "
                f"from {resumed_from}")
        want = arrays(os.path.join(tmp, "clean"), steps)
        got = arrays(os.path.join(tmp, "drill"), steps)
        require(sorted(got) == sorted(want) and int(got["step"]) == steps,
                "13d: the final checkpoints differ in leaves or step")
        differ = [k for k in want if not np.array_equal(got[k], want[k])]
        worst = max((_max_rel(torch.from_numpy(got[k]).float(),
                              torch.from_numpy(want[k]).float())
                     for k in differ), default=0.0)
        require(worst <= TRAIN_RTOL, f"13d: the resumed run's final "
                f"checkpoint lies {worst:.3g} from the uninterrupted one's")
        same_losses = drill.losses == clean.losses
        print(f"  13d fault at step {at}: restarted from step 10's "
              f"checkpoint, ran to step {steps} ({wall:.1f} s for both "
              f"runs); final checkpoint "
              + ("bit-equal to the uninterrupted run's" if not differ else
                 f"{len(differ)} of {len(want)} leaves not bit-equal, within "
                 f"{worst:.3g} of their max (the card's scatter-add in the "
                 f"backward of the embedding gather and of the "
                 f"cross-entropy's target gather adds in no fixed order)")
              + f"; losses of steps 0-{steps - 1} "
              + ("equal" if same_losses else "not all equal") + f" [{card}]")

        # a 4-shard state resumed on 2 shards
        m4 = TD.make_mesh((4, 1), ("data", "model"), devices=[dev] * 4)
        m2 = TD.make_mesh((2, 1), ("data", "model"), devices=[dev] * 2)
        base = os.path.join(tmp, "four")
        TTR.train(cfg, shape, tcfg, 4, mesh=m4, ckpt_dir=base, log=quiet)
        for d in ("on4", "on2"):
            shutil.copytree(base, os.path.join(tmp, d))
        through = TTR.train(cfg, shape, tcfg, 6, mesh=m4,
                            ckpt_dir=os.path.join(tmp, "on4"), log=quiet)
        moved = TTR.train(cfg, shape, tcfg, 6, mesh=m2,
                          ckpt_dir=os.path.join(tmp, "on2"), log=quiet)
        r_err = _max_leaf_err(TO, _whole_state(TO, moved.state),
                              _whole_state(TO, through.state))
        require(sorted(moved.losses) == [4, 5] and r_err <= TRAIN_RTOL,
                f"13d: resumed on 2 shards the state lies {r_err:.3g} from "
                f"the 4-shard run's (steps {sorted(moved.losses)})")
        print(f"  13d a step-4 checkpoint of a (4, 1) mesh resumed on (2, 1) "
              f"through reshard_state: steps 4-5 within "
              f"{r_err:.3g} of the 4-shard run's; losses "
              f"{[round(moved.losses[k], 6) for k in (4, 5)]} (4 shards "
              f"{[round(through.losses[k], 6) for k in (4, 5)]})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    timer = TE.StepTimer()
    for _ in range(8):                      # steady 5 ms steps
        timer.start()
        torch.cuda.synchronize()
        time.sleep(0.005)
        timer.stop()
    timer.start()
    time.sleep(0.05)
    timer.stop()
    require(timer.total_flagged == 1 and timer.consecutive_slow == 1,
            f"13d: a stalled step was not flagged ({timer.total_flagged} "
            f"flagged)")
    print(f"  13d StepTimer: a 50 ms stall after 8 steps of median "
          f"{sorted(timer.durations)[4] * 1e6:.0f} us flagged "
          f"({timer.total_flagged} of 9)")


def train_path(counters, dev, card):
    """Phase 13; returns the selective scan's launches on the train
    path (13b, and 13c's jamba mesh)."""
    from repro_torch import configs as TC
    from repro_torch.core import distributed as TD
    from repro_torch.data import pipeline as TP
    from repro_torch.launch import train as TTR
    from repro_torch.models import lm as TLM
    from repro_torch.models import sharding as sh
    from repro_torch.training import elastic as TE
    from repro_torch.training import optimizer as TO
    from repro_torch.training import train_loop as TT
    out = {}
    steps = (
        ("13a", f"{TRAIN_ARCH} whole through launch.train.main",
         lambda: train_llama_whole(TC, TLM, TO, TP, TT, TTR, counters, dev,
                                   card)),
        ("13b", f"{ARCH} at its widths, block 0 x 4, through the loop",
         lambda: out.__setitem__("wide", train_jamba_wide(
             TC, TO, TT, TTR, counters, dev, card))),
        ("13c", "meshes naming the card 2 and 4 times",
         lambda: out.__setitem__("mesh", train_meshes(
             TC, TD, TLM, TO, TT, TP, sh, counters, dev, card))),
        ("13d", "the fault drill, a resume on fewer shards, a stall",
         lambda: fault_drill(TC, TD, TO, TT, TTR, TE, TP, dev, card)),
    )
    for tag, what, run in steps:
        print(f"[train] {what} ({tag})")
        t0 = time.perf_counter()
        run()
        print(f"  {tag}: {time.perf_counter() - t0:.1f} s")
    return out

# --------------------------------------------------------------------------
# 14. the analysis layer and the dry-run planner on the card
# --------------------------------------------------------------------------

#: 14b's predicted peak against the card's max_memory_allocated
PEAK_RTOL = 0.10
#: 14c: the archs the dry-run plans on the card, on both production meshes
DRYRUN_ARCHS = ("llama3.2-1b", "jamba-v0.1-52b", "fcm-brainweb")
#: 14b: phase 13a's train shape (the launcher's defaults)
DRYRUN_TRAIN = (8, 128)


def roofline_folds(card):
    """14a: each table row with a kind in the JAX package's model, its
    device time from phases 3 and 5-7 folded through
    ``roofline.kernel_cell`` with the port's byte widths, beside the
    row's hand-counted bound. Fails on a share above FOLD_MAX."""
    from repro_torch.analysis import roofline as RF
    shares = {}
    for row, r in ROOFLINE.items():
        t_ms = r["device_ms"] if r["device_ms"] is not None else r["ms"]
        src = "device" if r["device_ms"] is not None else "CUDA events"
        costs = RF.kernel_step_costs(r["kind"], **r["shape"])
        cell = RF.kernel_cell(r["kind"], "cuda", "gpu", r["shape"],
                              costs["flops"], costs["bytes"], t_ms / 1e3)
        hand = ("-" if r["bound_ms"] is None
                else f"{r['bound_ms'] * 1e3:.2f} us")
        print(f"  row {row} ({r['kind']}, {r['shape']}): flops "
              f"{cell.flops:.4g}, bytes {cell.bytes:.4g}, t_roofline "
              f"{cell.t_roofline * 1e6:.2f} us ({cell.bound}), {src} "
              f"{t_ms * 1e3:.2f} us a call, frac_of_roofline "
              f"{cell.frac_of_roofline:.3f}; hand-counted bound {hand} "
              f"[{card}]")
        require(cell.frac_of_roofline <= FOLD_MAX,
                f"row {row}: {cell.frac_of_roofline:.3f} of the model's "
                f"roofline, above {FOLD_MAX}")
        shares[row] = cell.frac_of_roofline
    require({"1", "2", "3", "6", "6b", "7", "8", "9", "10", "11"}
            <= set(shares), f"14a folded only rows {sorted(shares)}")
    return shares


def _op_diff(fake, real):
    """The aten ops whose counts differ between two counters."""
    names = set(fake.costs.by_op) | set(real.costs.by_op)
    return {n: (fake.costs.by_op.get(n), real.costs.by_op.get(n))
            for n in sorted(names)
            if fake.costs.by_op.get(n) != real.costs.by_op.get(n)}


def _hold_count(what, fake, real, args, measured, card):
    """Fake and real counts equal, the predicted peak (arguments plus the
    fake step's live peak) within PEAK_RTOL of the card's."""
    predicted = args + fake.peak
    print(f"  {what}: flops {fake.costs.flops:.6g} (fake) / "
          f"{real.costs.flops:.6g} (card), bytes {fake.costs.bytes:.6g} / "
          f"{real.costs.bytes:.6g}, {fake.costs.n_ops} / "
          f"{real.costs.n_ops} ops; peak predicted {predicted / 2**30:.3f} "
          f"GiB, max_memory_allocated {measured / 2**30:.3f} GiB "
          f"({predicted / measured - 1:+.2%}) [{card}]")
    require(fake.costs.flops == real.costs.flops
            and fake.costs.bytes == real.costs.bytes,
            f"14b {what}: fake and card counts differ: "
            f"{_op_diff(fake, real)}")
    require(abs(predicted - measured) <= PEAK_RTOL * measured,
            f"14b {what}: predicted peak {predicted} B, the card's "
            f"{measured} B")
    return predicted, measured


def _measured(fn, args_real):
    """(counter, the card's peak of ``fn()`` over what it was given):
    ``max_memory_allocated`` less what was allocated before that is not
    ``fn``'s arguments (``args_real`` bytes)."""
    from repro_torch.analysis import op_cost
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with op_cost.CostCounter() as counter:
        out = fn()
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - (before - args_real)
    del out
    return counter, peak


def dryrun_vs_card(imgs, dev, card):
    """14b: llama3.2-1b's train step at 13a's shape and one iteration of
    ``build_sharded_fit`` on the 181-slice volume (one-card mesh), each
    counted on fake tensors and on real ones on the card."""
    import gc
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch import configs as TC
    from repro_torch.analysis import op_cost
    from repro_torch.core import distributed as TD
    from repro_torch.core.fcm import FCMConfig
    from repro_torch.launch import dryrun as DR
    from repro_torch.models import sharding as sh
    from repro_torch.training import train_loop as TT
    gc.collect()
    torch.cuda.empty_cache()
    cfg = TC.get_config(TRAIN_ARCH)
    tcfg = TT.TrainConfig()
    b, s = DRYRUN_TRAIN
    shape = TC.ShapeConfig("train_8x128", "train", s, b)
    step = TT.make_train_step(cfg, tcfg)
    one = sh.Parallelism()
    with FakeTensorMode():
        state = DR._fake_like(TT.abstract_state(cfg, tcfg), dev)
        batch = DR._batch(cfg, shape, dev)
        args = (DR.arg_bytes(state, TT.state_specs(cfg), one)
                + DR.arg_bytes(batch, TT.batch_specs(cfg), one))
        with op_cost.CostCounter() as fake:
            out = step(state, batch)
        del out, state, batch
    state = TT.init_state(0, cfg, tcfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(14)
    tokens = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen,
                           device=dev, dtype=torch.int32)
    batch = {"tokens": tokens[:, :-1].contiguous(),
             "labels": tokens[:, 1:].contiguous()}
    warm = step(state, batch)               # cuBLAS workspaces, caches
    del warm
    real, peak = _measured(lambda: step(state, batch),
                           op_cost.nbytes_of(state) + op_cost.nbytes_of(batch))
    require(args == op_cost.nbytes_of(state) + op_cost.nbytes_of(batch),
            f"14b: the spec trees' {args} B of arguments against the "
            f"card's {op_cost.nbytes_of(state) + op_cost.nbytes_of(batch)}")
    out = {"llama": _hold_count(f"{TRAIN_ARCH} train step {b}x{s}", fake,
                                real, args, peak, card)}
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()

    vol = np.stack(imgs).reshape(-1).astype(np.float32)
    n = vol.size
    mesh = TD.make_mesh((1,), ("data",), devices=[dev])
    fit = TD.build_sharded_fit(mesh, FCMConfig(), loop=TD.one_iteration)
    with FakeTensorMode():
        xf = torch.zeros((n,), dtype=torch.float32, device=dev)
        wf = torch.ones_like(xf)
        with op_cost.CostCounter() as fake:
            res = fit(xf, wf)
        del res, xf, wf
    x = torch.from_numpy(vol).to(dev)
    w = torch.ones_like(x)
    fit(x, w)                                # the kernels' counters
    real, peak = _measured(lambda: fit(x, w), 2 * n * 4)
    require(real.costs.n_kernels == fake.costs.n_kernels == 2,
            f"14b: {real.costs.n_kernels} kernel calls on the card, "
            f"{fake.costs.n_kernels} on fake tensors (want the fused "
            f"partials and the labels)")
    out["fcm"] = _hold_count(f"build_sharded_fit, one iteration, {n} "
                             f"voxels", fake, real, 2 * n * 4, peak, card)
    return out


def dryrun_cells(dev, card):
    """14c: the dry-run of DRYRUN_ARCHS on both production meshes, one
    ``python -m repro_torch.launch.dryrun`` process an (arch, mesh), all
    started together and each waited for; each cell's memory, terms,
    bottleneck, fits_hbm and wall time."""
    import tempfile
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")
               + (os.pathsep + os.environ["PYTHONPATH"]
                  if os.environ.get("PYTHONPATH") else ""))
    tmp = tempfile.mkdtemp(prefix="dryrun_")
    procs = []
    for arch in DRYRUN_ARCHS:
        for mesh in ("single", "multi"):
            out = os.path.join(tmp, f"{arch}-{mesh}.jsonl")
            procs.append((arch, mesh, out, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--mesh", mesh, "--device", str(dev), "--out", out,
                 "--force"], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    recs = []
    for arch, mesh, out, proc in procs:
        try:
            text, _ = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        require(proc.returncode == 0, f"14c dry-run of {arch} on the "
                f"{mesh} mesh failed:\n{text[-3000:]}")
        with open(out) as f:
            recs += [json.loads(line) for line in f]
    for rec in recs:
        print(f"  {rec['arch']} x {rec['shape']} x {rec['mesh']}: args "
              f"{rec['mem_args_gb']:.3f} GiB, temp "
              f"{rec['mem_temp_gb']:.3f} GiB, out "
              f"{rec['mem_out_gb']:.3f} GiB a device, fits_hbm "
              f"{rec['fits_hbm']}; compute {rec['t_compute']:.4g} s, "
              f"memory {rec['t_memory']:.4g} s, collective "
              f"{rec['t_collective']:.4g} s -> {rec['bottleneck']}; "
              f"{rec['n_ops']} ops, {rec['wall_s']} s a cell"
              + (", Mamba through row 12" if rec["mamba_kernel"] else ""))
        require(rec["flops_per_dev"] > 0 and rec["bytes_per_dev"] > 0,
                f"14c {rec['arch']} x {rec['shape']}: nothing counted")
    require(len(recs) == 16, f"14c: {len(recs)} cells, not 16")
    print(f"  {len(recs)} cells in {len(procs)} processes at once; analytic "
          f"on H100 SXM data-sheet peaks: {sum(r['fits_hbm'] for r in recs)}"
          f" fit 80 GB [{card}]")
    return recs


def _example(name):
    import importlib.util
    path = os.path.join(ROOT, "examples", f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _vector_near_ties(got, want, feats, centers, what):
    """Pixels where two vector label maps differ, each a float64 near-tie
    of the pixel's feature row between its two labels' centers, at most
    TIE_SHARE of them."""
    got, want = np.asarray(got).reshape(-1), np.asarray(want).reshape(-1)
    idx = np.flatnonzero(got != want)
    if idx.size:
        f = np.asarray(feats, np.float64).reshape(got.size, -1)[idx]
        v = np.asarray(centers, np.float64).reshape(-1, f.shape[1])
        a = ((f - v[got[idx]]) ** 2).sum(axis=1)
        b = ((f - v[want[idx]]) ** 2).sum(axis=1)
        bad = np.abs(a - b) > SPATIAL_TIE_RTOL * np.maximum(a, b)
        require(not bad.any(), f"{what}: {int(bad.sum())} labels differ by "
                f"more than a near-tie")
    require(idx.size <= TIE_SHARE * got.size,
            f"{what}: {idx.size} near-ties of {got.size} pixels")
    return int(idx.size)


def examples_on_card(counters, dev, card):
    """14d: the five FCM examples at full size on the card against a
    ``device="cpu"`` run of each (labels up to float64-checked near-ties,
    iterations equal); each example asserts its own DSC bar. Returns the
    kernels the card runs launched, by name."""
    import contextlib
    import io
    import tempfile
    job = None
    out_dir = tempfile.mkdtemp(prefix="torch_examples_")
    launched = {}
    scfg = None
    for name in ("quickstart", "segment_noisy", "segment_volume",
                 "segment_color", "serve_segmentation"):
        mod = _example(name)
        extra = [] if name == "serve_segmentation" else ["--out", out_dir]
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            got = mod.main(extra)
        wall = time.perf_counter() - t0
        for k, n in _counts(counters).items():
            if n:
                launched[k] = launched.get(k, 0) + n
        with contextlib.redirect_stdout(io.StringIO()):
            want = mod.main(extra + ["--device", "cpu"])
        ties = 0
        if name == "quickstart":
            for tag in ("staged", "fused"):
                g, w = got["results"][tag], want["results"][tag]
                require(g["n_iters"] == w["n_iters"], f"14d {name} {tag}")
                ties += _scalar_near_ties(g["labels"], w["labels"],
                                          got["image"], g["centers"],
                                          f"14d {name} {tag}")
        elif name == "segment_noisy":
            if scfg is None:
                from repro_torch.configs.fcm_brainweb import make_config
                job = make_config()
                scfg = job.spatial
            g, w = (got["results"]["plain-histogram"],
                    want["results"]["plain-histogram"])
            require(g["n_iters"] == w["n_iters"], f"14d {name} histogram")
            ties += _scalar_near_ties(g["labels"], w["labels"], got["image"],
                                      g["centers"], f"14d {name} histogram")
            g, w = (got["results"]["spatial-fcm_s"],
                    want["results"]["spatial-fcm_s"])
            require(g["n_iters"] == w["n_iters"], f"14d {name} spatial")
            ties += _spatial_near_ties(g["labels"], w["labels"],
                                       got["image"].astype(np.float32),
                                       g["centers"], scfg.neighbors,
                                       scfg.alpha, f"14d {name} spatial")
        elif name == "segment_volume":
            require(got["n_iters"] == want["n_iters"], f"14d {name}")
            ties += _scalar_near_ties(got["labels"], want["labels"],
                                      got["volume"], got["centers"],
                                      f"14d {name}")
            g, w = got["restart"], want["restart"]
            require(g["n_iters"] == w["n_iters"], f"14d {name} restart")
            ties += _scalar_near_ties(g["labels"], w["labels"],
                                      got["volume"], g["centers"],
                                      f"14d {name} restart")
        elif name == "segment_color":
            for work in ("rgb", "t1t2pd"):
                for tag in ("superpixel", "pixel"):
                    g, w = got[work][tag], want[work][tag]
                    require(g["n_iters"] == w["n_iters"],
                            f"14d {name} {work} {tag}")
                    if tag == "pixel":
                        ties += _vector_near_ties(
                            g["labels"], w["labels"], got[work]["image"],
                            g["centers"], f"14d {name} {work} {tag}")
                    else:
                        require(np.array_equal(g["labels"], w["labels"]),
                                f"14d {name} {work} superpixel labels "
                                f"differ from the CPU's")
        else:
            for i, (g, w) in enumerate(zip(got["results"],
                                           want["results"])):
                require(g.n_iters == w.n_iters, f"14d {name} request {i}")
                ties += _scalar_near_ties(g.labels, w.labels,
                                          got["images"][i], g.centers,
                                          f"14d {name} request {i}")
            if scfg is None:
                from repro_torch.configs.fcm_brainweb import make_config
                scfg = make_config().spatial
            for i, (g, w) in enumerate(zip(got["spatial"],
                                           want["spatial"])):
                require(g.n_iters == w.n_iters,
                        f"14d {name} spatial request {i}")
                ties += _spatial_near_ties(
                    g.labels, w.labels,
                    got["noisy"][i].astype(np.float32), g.centers,
                    scfg.neighbors, scfg.alpha,
                    f"14d {name} spatial request {i}")
        print(f"  {name}: the card's labels = the CPU's but {ties} "
              f"float64-checked near-ties, iterations equal, its DSC bar "
              f"held; {wall:.2f} s on the card [{card}]")
    print(f"  kernels the examples launched: {launched}")
    need = {"histogram_bin", "fcm_resident_solve", "labels",
            "fcm_membership", "fcm_center_partials", "fcm_fused_partials",
            "fcm_streamed_solve", "fcm_stencil_solve", "slic_assign"}
    require(need <= set(launched), f"14d: the examples launched no "
            f"{sorted(need - set(launched))}")
    return launched


def analysis_path(counters, imgs, dev, card):
    """Phase 14; returns what it measured."""
    out = {}
    steps = (
        ("14a", "kernel rooflines from the JAX model, port widths",
         lambda: out.__setitem__("folds", roofline_folds(card))),
        ("14b", "the dry-run's counts and peak against the card",
         lambda: out.__setitem__("held", dryrun_vs_card(imgs, dev, card))),
        ("14c", f"the dry-run of {', '.join(DRYRUN_ARCHS)}",
         lambda: out.__setitem__("cells", dryrun_cells(dev, card))),
        ("14d", "the five FCM examples, card against CPU",
         lambda: out.__setitem__("examples", examples_on_card(
             counters, dev, card))),
    )
    for tag, what, run in steps:
        print(f"[analysis] {what} ({tag})")
        t0 = time.perf_counter()
        run()
        print(f"  {tag}: {time.perf_counter() - t0:.1f} s")
    return out


# --------------------------------------------------------------------------
# 15. the train state stored split across the mesh (FSDP / TP storage)
# --------------------------------------------------------------------------

#: 15a-15b: the ("data", "model") mesh naming the card 4 times
PLACED_MESH = ((2, 2), ("data", "model"))
#: 15a: train steps of full-width Jamba block 0 x 4 at JAMBA_TRAIN's shape
PLACED_STEPS = 3
#: 15b: llama3.2-1b whole through launch.train.train: (batch, seq, steps)
PLACED_LLAMA = (8, 128, 5)


def _jamba_block0(TC):
    """13b's and 15a's config: jamba-v0.1-52b at every published width,
    depth cut to block 0 (Mamba, SwiGLU) x 4, float32 compute, the
    selective-scan kernel."""
    base = TC.get_config(ARCH)
    return dataclasses.replace(base, group_layout=base.group_layout[:1],
                               n_layers=4, mamba_pallas=True,
                               dtype=torch.float32)


def placed_jamba(TC, TD, TO, TP, TT, DR, sh, counters, dev, card):
    """15a: full-width Jamba block 0 x 4, float32, PLACED_STEPS steps at
    JAMBA_TRAIN's (batch, seq) with the state placed across a (2, 2) mesh
    of the card, then the same steps with the lead-device state (the
    placed state freed first): losses and gradient norms within
    TRAIN_RTOL, every leaf within TRAIN_RTOL x max + PARAM_ATOL, row 12
    once a dp shard; each slot's stored bytes equal to the dry-run's
    per-device state arguments; no gathered leaf alive after a step.
    Returns the scan's launches in the placed steps."""
    import gc
    b, s, _ = JAMBA_TRAIN
    cfg = _jamba_block0(TC)
    tcfg = TT.TrainConfig()
    shape = TC.ShapeConfig("train", "train", s, b)
    (mshape, axes) = PLACED_MESH
    mesh = TD.make_mesh(mshape, axes, devices=[dev] * int(np.prod(mshape)))
    ctx = sh.make_parallelism(mesh)
    step = TT.make_train_step(cfg, tcfg)
    batches = [{k: torch.as_tensor(v).to(dev) for k, v in TP.make_batch(
        cfg, shape, i).items()} for i in range(PLACED_STEPS)]

    def run(state, what):
        """PLACED_STEPS timed steps: (state, metrics, step ms)."""
        ms, metrics = [], []
        with sh.parallelism(ctx):
            for i, batch in enumerate(batches):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(state, batch)
                metrics.append({k: float(m[k]) for k in ("loss",
                                                         "grad_norm")})
                ms.append((time.perf_counter() - t0) * 1e3)
                require(sh.live_gathers() == 0, f"15a {what} step {i}: "
                        f"{sh.live_gathers()} gathered tensors outlived "
                        f"their group")
        return state, metrics, ms

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    state = TT.init_state(0, cfg, tcfg, device=dev, ctx=ctx)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    want = DR.arg_bytes(TT.abstract_state(cfg, tcfg), TT.state_specs(cfg),
                        ctx)
    stored = [sh.stored_bytes(state, k) for k in range(mesh.size)]
    require(all(x == want for x in stored), f"15a: slots store {stored} "
            f"bytes, the dry-run's per-device state arguments {want}")
    n = sum(t.numel() for t in TO.tree_leaves(state["params"]))
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    retries0 = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    state, pm, pms = run(state, "placed")
    peak_placed = torch.cuda.max_memory_allocated() - base
    retries = [torch.cuda.memory_stats().get("num_alloc_retries", 0)
               - retries0]
    launches = _counts(counters)
    scan = launches["selective_scan"]
    dp = dict(zip(axes, mshape))["data"]
    steps = PLACED_STEPS
    require(scan >= cfg.n_layers * dp * steps and scan % dp == 0
            and sum(launches.values()) == scan,
            f"15a: launched {launches}: expected the scan alone, once a dp "
            f"shard, at least {cfg.n_layers} layers x {dp} shards x "
            f"{steps} steps")
    require(all(sh.is_placed(x) for x in TO.tree_leaves(state)),
            "15a: a leaf of the stepped state is not placed")
    host = _whole_state(TO, {"params": state["params"], "opt": state["opt"]})
    del state
    gc.collect()
    torch.cuda.empty_cache()
    lead = TT.init_state(0, cfg, tcfg, device=dev)
    torch.cuda.reset_peak_memory_stats()
    retries0 = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    lead, lm_, lms = run(lead, "lead-device")
    peak_lead = torch.cuda.max_memory_allocated() - base
    retries.append(torch.cuda.memory_stats().get("num_alloc_retries", 0)
                   - retries0)
    for i, (a, c) in enumerate(zip(pm, lm_)):
        for k in ("loss", "grad_norm"):
            require(np.isfinite(a[k]) and abs(a[k] - c[k])
                    <= TRAIN_RTOL * abs(c[k]), f"15a step {i} {k}: "
                    f"{a[k]!r} placed, {c[k]!r} on the lead device")
    worst, differ = _params_within(
        TO, host, {"params": lead["params"], "opt": lead["opt"]}, "15a")
    del lead, host
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  15a {ARCH} at its widths, block 0 x 4 ({n / 1e9:.4f} B "
          f"parameters, float32), ({b}, {s}), {steps} steps on "
          f"{dict(zip(axes, mshape))} naming the card {mesh.size} times: "
          f"losses {[round(m['loss'], 6) for m in pm]} (lead-device "
          f"{[round(m['loss'], 6) for m in lm_]}); step ms placed "
          f"{[round(v, 1) for v in pms]}, lead-device "
          f"{[round(v, 1) for v in lms]}; peak allocated placed "
          f"{peak_placed / 2**30:.2f} GiB, lead-device "
          f"{peak_lead / 2**30:.2f} GiB; allocator retries placed "
          f"{retries[0]}, lead-device {retries[1]}; each slot stores {stored[0]} B = "
          f"the dry-run's per-device state arguments {int(want)} B (the "
          f"card holds {held / 2**30:.2f} GiB for the 4 slots: one card "
          f"named 4 times cannot show the per-device split); leaves within "
          f"{worst:.3g} of their max, {differ} not bit-equal; "
          f"selective_scan {scan} launches ({scan // steps} a step,"
          f" {dp} dp shards) [{card}]")
    return scan


def placed_llama(TC, TD, TO, TT, TTR, sh, counters, dev, card):
    """15b: the whole llama3.2-1b through ``launch.train.train`` on a
    (2, 2) mesh of the card (the launcher places the state),
    PLACED_LLAMA's steps, against the same run on one device (the state
    whole; the placed run's state stays on the card meanwhile, and each
    peak is read above what was allocated before its run): losses and
    gradient norms within TRAIN_RTOL, every leaf within TRAIN_RTOL x max
    + PARAM_ATOL."""
    import gc
    b, s, steps = PLACED_LLAMA
    cfg = TC.get_config(TRAIN_ARCH)
    shape = TC.ShapeConfig("train", "train", s, b)
    tcfg = TT.TrainConfig()
    (mshape, axes) = PLACED_MESH
    mesh = TD.make_mesh(mshape, axes, devices=[dev] * int(np.prod(mshape)))
    quiet = lambda *_: None  # noqa: E731
    runs, states, peaks = {}, {}, {}
    for tag, m in (("placed", mesh), ("one device", None)):
        for fn in counters.values():
            fn.launches = 0
        held = torch.cuda.memory_allocated()    # the other run's state
        torch.cuda.reset_peak_memory_stats()
        run = TTR.train(cfg, shape, tcfg, steps, mesh=m, device=dev,
                        log=quiet)
        peaks[tag] = torch.cuda.max_memory_allocated() - held
        require(sum(_counts(counters).values()) == 0,
                f"15b {tag}: the dense model launched {_counts(counters)}")
        if m is not None:
            require(all(sh.is_placed(x) for x in TO.tree_leaves(run.state)),
                    "15b: the launcher's meshed state is not placed")
            require(sh.live_gathers() == 0, "15b: gathered tensors "
                    "outlived their group")
        states[tag] = run.state
        runs[tag] = (TTR.summary(run, shape), dict(run.losses),
                     dict(run.grad_norms))
        del run
        gc.collect()
        torch.cuda.empty_cache()
    (ps, pl, pg), (os_, ol, og) = runs["placed"], runs["one device"]
    for i in range(steps):
        for what, a, c in (("loss", pl[i], ol[i]), ("grad_norm", pg[i],
                                                     og[i])):
            require(np.isfinite(a) and abs(a - c) <= TRAIN_RTOL * abs(c),
                    f"15b step {i} {what}: {a!r} placed, {c!r} on one "
                    f"device")
    worst, differ = _params_within(TO, states["placed"],
                                   states["one device"], "15b", dev)
    n = sum(t.numel() for t in TO.tree_leaves(states["one device"]["params"]))
    del states
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  15b {TRAIN_ARCH} whole ({n / 1e9:.4f} B float32 masters, "
          f"bf16 compute), ({b}, {s}), {steps} steps through "
          f"launch.train.train on {dict(zip(axes, mshape))} naming the card "
          f"{mesh.size} times: losses {[round(pl[i], 6) for i in range(steps)]}"
          f" (one device {[round(ol[i], 6) for i in range(steps)]}); step "
          f"{ps['step_ms_median']:.1f} ms placed, {os_['step_ms_median']:.1f}"
          f" ms on one device (medians past step 0); peak "
          f"{peaks['placed'] / 2**30:.2f} GiB placed, "
          f"{peaks['one device'] / 2**30:.2f} GiB on one device (each "
          f"above what was allocated before its run); "
          f"leaves within {worst:.3g} of their max, {differ} not bit-equal "
          f"[{card}]")


def placed_drill(TC, TD, TO, TT, TTR, TCK, sh, dev, card):
    """15c: the drill on a placed state at reduced llama3.2-1b: 4 steps on
    (2, 2) saving every 2; the placed step-2 checkpoint byte-equal to the
    same state saved whole; it loads with ``shardings`` on (4, 1) and
    without a mesh bit-equal to the saved leaves; resumed on (4, 1) and on
    no mesh, steps 2-3 end at the uninterrupted run's state (13d's rule:
    within TRAIN_RTOL of each leaf's max where not bit-equal)."""
    import filecmp
    import shutil
    import tempfile
    cfg = TC.get_config(TRAIN_ARCH).reduced()
    b, s = TRAIN_SHAPE
    shape = TC.ShapeConfig("train", "train", s, b)
    tcfg = TT.TrainConfig()
    quiet = lambda *_: None  # noqa: E731
    m22 = TD.make_mesh((2, 2), ("data", "model"), devices=[dev] * 4)
    m41 = TD.make_mesh((4, 1), ("data", "model"), devices=[dev] * 4)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_placed_")
    try:
        base = os.path.join(tmp, "base")
        through = TTR.train(cfg, shape, tcfg, 4, mesh=m22, ckpt_dir=base,
                            ckpt_every=2, log=quiet)
        mid = os.path.join(tmp, "mid")
        os.makedirs(mid)
        shutil.copytree(os.path.join(base, "step_00000002"),
                        os.path.join(mid, "step_00000002"))
        with open(os.path.join(mid, "LATEST"), "w") as f:
            f.write("step_00000002")
        like = TT.to_stacked(TT.abstract_state(cfg, tcfg), "meta")
        saved, _ = TCK.load_checkpoint(mid, like, device="cpu")
        # the placed save against the same state saved whole
        TCK.save_checkpoint(os.path.join(tmp, "whole"), saved, 2)
        same_files = all(filecmp.cmp(
            os.path.join(mid, "step_00000002", f),
            os.path.join(tmp, "whole", "step_00000002", f), shallow=False)
            for f in ("arrays.npz", "manifest.json"))
        require(same_files, "15c: the placed checkpoint's files differ "
                "from the same state's saved whole")
        for tag, mesh in (("(4, 1)", m41), ("no mesh", None)):
            ctx = sh.make_parallelism(mesh)
            shd = (None if mesh is None else sh.to_named_shardings(
                like, TT.stacked_specs(cfg), ctx))
            tree, _ = TCK.load_checkpoint(mid, like, device=dev,
                                          shardings=shd)
            for a, w in zip(TO.tree_leaves(tree), TO.tree_leaves(saved)):
                require(sh.is_placed(a) == (mesh is not None)
                        and torch.equal(sh.whole(a, "cpu"), w),
                        f"15c: a leaf loaded on {tag} differs from the "
                        f"saved one")
        ends = {}
        for tag, mesh in (("(4, 1)", m41), ("no mesh", None)):
            d = os.path.join(tmp, tag.replace(" ", "_").strip("()"))
            shutil.copytree(mid, d)
            run = TTR.train(cfg, shape, tcfg, 4, mesh=mesh, device=dev,
                            ckpt_dir=d, log=quiet)
            require(sorted(run.losses) == [2, 3], f"15c: the run resumed "
                    f"on {tag} took steps {sorted(run.losses)}")
            got, want = (_whole_state(TO, r.state) for r in (run, through))
            differ = sum(not torch.equal(a, w) for a, w in
                         zip(TO.tree_leaves(got), TO.tree_leaves(want)))
            err = _max_leaf_err(TO, got, want)
            require(err <= TRAIN_RTOL, f"15c: resumed on {tag}, the state "
                    f"lies {err:.3g} from the uninterrupted run's")
            ends[tag] = (differ, err)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  15c reduced {TRAIN_ARCH}: a (2, 2) placed step-2 checkpoint, "
          f"its files byte-equal to the same state saved whole; loaded on "
          f"(4, 1) and on no mesh bit-equal to the saved leaves; resumed "
          + "; ".join(f"on {t}: steps 2-3 end "
                      + ("bit-equal to" if d == 0 else
                         f"with {d} leaves within {e:.3g} of")
                      + " the uninterrupted run's state"
                      for t, (d, e) in ends.items()) + f" [{card}]")


def placed_path(counters, dev, card):
    """Phase 15; returns the selective scan's launches in 15a."""
    from repro_torch import configs as TC
    from repro_torch.core import distributed as TD
    from repro_torch.data import pipeline as TP
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import train as TTR
    from repro_torch.models import sharding as sh
    from repro_torch.training import checkpoint as TCK
    from repro_torch.training import optimizer as TO
    from repro_torch.training import train_loop as TT
    out = {}
    steps = (
        ("15a", f"{ARCH} at its widths, block 0 x 4, the state placed on "
         f"(2, 2)", lambda: out.__setitem__("scan", placed_jamba(
             TC, TD, TO, TP, TT, DR, sh, counters, dev, card))),
        ("15b", f"{TRAIN_ARCH} whole through launch.train.train on (2, 2)",
         lambda: placed_llama(TC, TD, TO, TT, TTR, sh, counters, dev,
                              card)),
        ("15c", "the drill on a placed state",
         lambda: placed_drill(TC, TD, TO, TT, TTR, TCK, sh, dev, card)),
    )
    for tag, what, run in steps:
        print(f"[placed] {what} ({tag})")
        t0 = time.perf_counter()
        run()
        print(f"  {tag}: {time.perf_counter() - t0:.1f} s")
    return out



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
    from repro_torch.core import fcm as F
    from repro_torch.core import batched as TB
    from repro_torch.core import distributed as TD
    from repro_torch.core import solver as SV
    from repro_torch.data import phantom
    from repro_torch.kernels import _build
    from repro_torch.kernels import defuzzify as KD
    from repro_torch.kernels import fcm_centers as KC
    from repro_torch.kernels import fcm_membership as KM
    from repro_torch.kernels import fcm_resident as KR
    from repro_torch.kernels import fcm_spatial as KSP
    from repro_torch.kernels import fcm_stencil as KST
    from repro_torch.kernels import histogram_bin as KB
    from repro_torch.kernels import selective_scan as KSS
    from repro_torch.kernels import slic_assign as KS
    from repro_torch import faults as TFI
    from repro_torch.serving import FCMServeEngine
    from repro_torch.serving import fcm_engine as TE
    from repro_torch.superpixel import slic as SL
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
    require(lib.fcm_resident_max_rows() == KR.MAX_ROWS
            and lib.fcm_resident_threads() == KR.THREADS,
            "the resident kernel's row bound or threads disagree with "
            "fcm_resident.MAX_ROWS / THREADS")
    require(lib.labels_block_pixels() == KD.BLOCK_PIXELS,
            "the labels kernel's pixels a block disagree with "
            "defuzzify.BLOCK_PIXELS")
    require(lib.fcm_max_c() == KM.MAX_C == KC.MAX_C,
            "the per-iteration kernels' cluster bound disagrees with "
            "fcm_membership.MAX_C")
    require((lib.fcm_streamed_max_rows(), lib.fcm_streamed_max_c(),
             lib.fcm_streamed_max_feat())
            == (KR.STREAM_MAX_ROWS, KR.STREAM_MAX_C, KR.STREAM_MAX_FEAT),
            "the streamed kernel's bounds disagree with fcm_resident's "
            "STREAM_MAX_*")
    require((lib.fcm_streamed_threads(), lib.fcm_streamed_max_ranks())
            == (KR.STREAM_THREADS, KR.STREAM_MAX_RANKS)
            and all(lib.fcm_streamed_rows_per_block(d)
                    == KR.stream_rows_per_block(d)
                    for d in range(1, KR.STREAM_MAX_FEAT + 1)),
            "the streamed kernel's block shape disagrees with "
            "fcm_resident.streamed_plan's")
    for c, d in ((4, 1), (4, 3), (4, 8), (4, 16), (8, 1), (8, 3), (8, 8),
                 (8, 16)):
        want = KR.stream_min_blocks(c, d)
        got = min(lib.fcm_streamed_blocks_per_sm(c, d, m)
                  for m in (2.0, 2.5))
        require(lib.fcm_streamed_min_blocks(c, d) == want and got >= want,
                f"the streamed kernel at c={c}, D={d}: __launch_bounds__ asks "
                f"for {lib.fcm_streamed_min_blocks(c, d)} blocks an SM, the "
                f"card holds {got}; the plan assumes {want}")
    require(lib.slic_max_center_bytes() == KS.MAX_CENTER_BYTES,
            "the SLIC kernel's center-table bound disagrees with "
            "slic_assign.MAX_CENTER_BYTES")
    require((lib.fcm_stencil_max_pixels(), lib.fcm_stencil_max_c(),
             lib.fcm_stencil_max_cluster())
            == (KST.MAX_PIXELS, KST.MAX_C, KST.MAX_CLUSTER)
            and KST.STENCIL_MAX_PIXELS <= KST.MAX_PIXELS,
            "the stencil whole-solve's bounds disagree with fcm_stencil's")
    for grid in ((1, 217, 181, 8), (8, 64, 64, 6), (1, 512, 512, 8),
                 (1, 1024, 1024, 8)):
        plan = KST.stencil_plan(*grid)
        require(lib.fcm_stencil_smem_bytes(*grid, plan.ranks, plan.form)
                == plan.smem_bytes, f"the stencil kernel's shared memory at "
                f"{grid} disagrees with fcm_stencil.stencil_plan's {plan}")
    require((lib.fcm_spatial2d_strip_w(), lib.fcm_spatial2d_warps(),
             lib.fcm_spatial2d_max_warp_rows())
            == (KSP.STRIP_W, KSP.STRIP_WARPS, KSP.MAX_WARP_ROWS),
            "the 2-D march's strip, warps or rows disagree with "
            "fcm_spatial's STRIP_W/STRIP_WARPS/MAX_WARP_ROWS")
    for grid in ((4000, 256), (217, 181), (512, 512), (1, 1), (2, 300),
                 (300, 1), (1024, 1024)):
        plan = KSP.spatial2d_plan(*grid)
        require(lib.fcm_spatial2d_blocks(*grid, plan.run) == plan.blocks,
                f"the 2-D march's blocks at {grid} disagree with "
                f"fcm_spatial.spatial2d_plan's {plan}")
    require(lib.histogram_bin_block_bytes() == KB.BLOCK_BYTES
            and lib.histogram_bin_max_cluster() == KB.MAX_CLUSTER
            and all(lib.histogram_bin_blocks(n, size) == KB.bin_blocks(n, size)
                    for n in (1, 15, 16, 17, 20465, 20466, 39277, 163825,
                              1024000)
                    for size in (1, 4)),
            "the binning kernel's blocks a lane or cluster bound disagree "
            "with histogram_bin.bin_blocks / MAX_CLUSTER")
    require((lib.fcm_batched_threads(), lib.fcm_batched_max_blocks())
            == (KC.THREADS, KC.BATCHED_MAX_BLOCKS),
            "the batched fused kernel's threads or most blocks disagree "
            "with fcm_centers' THREADS/BATCHED_MAX_BLOCKS")
    for c in (1, 4, 5, 8, 9, 12, 13, 16, 17, 32):
        for d in (1, 2, 3, 16, 24, 500):
            for weighted in ((True, False) if d == 1 else (True,)):
                plan = KC.batched_plan(1, 39277, d, c, weighted)
                require((lib.fcm_batched_tier(c, d),
                         lib.fcm_batched_dchunk(c, d),
                         lib.fcm_batched_rows_per_thread(c, d, weighted))
                        == (plan.tier, plan.dch, plan.rows_per_thread),
                        f"the fused kernels' tier, feature chunk or rows a "
                        f"thread at c={c}, D={d}, weighted={weighted} "
                        f"disagree with fcm_centers.batched_plan's {plan}")
    for grid in ((181, 217, 181), (1, 1, 1), (37, 19, 23), (70, 9, 33),
                 (1, 64, 64)):
        plan = KSP.spatial3d_plan(*grid)
        require((lib.fcm_spatial3d_tile_w(), lib.fcm_spatial3d_tile_h())
                == plan.tile and lib.fcm_spatial3d_tile_bytes()
                == plan.smem_bytes and lib.fcm_spatial3d_rows(*grid, plan.z)
                == plan.rows, f"the 3-D march's grid at {grid} disagrees "
                f"with fcm_spatial.spatial3d_plan's {plan}")
    require((lib.slic_tile_w(), lib.slic_tile_h(), lib.slic_window_slack())
            == (KS.TILE_W, KS.TILE_H, KS.WINDOW_SLACK),
            "the SLIC kernel's tile or window slack disagrees with "
            "slic_assign's TILE_W/TILE_H/WINDOW_SLACK")

    # -- 3. kernels against their plain versions ----------------------------
    job = fcm_brainweb.make_config()
    n_slices, h, w = VOLUME
    imgs, gts = phantom_volume(n_slices, h, w, phantom)
    pick = np.linspace(0, n_slices - 1, 64).round().astype(int)
    vol_u8 = np.stack([imgs[i].reshape(-1) for i in pick])
    big_u8 = phantom.phantom_of_bytes(BIG_BYTES)[0][None]
    print("[kernels] binning")
    k_bin = check_binning(KB, vol_u8, big_u8, dev, card)
    hists = KB.histogram_bin(torch.from_numpy(vol_u8).to(dev), 256)
    print("[kernels] whole-solve")
    k_solve, _ = check_solve(KR, SV, hists.cpu().numpy(), dev, card)
    feats = torch.arange(256, dtype=torch.float32, device=dev).repeat(
        64, 1)[..., None].contiguous()
    v, _, _, _ = SV.flat_batched_solve(feats, hists, 4, 2.0, 5e-3, 300,
                                       impl="resident")
    print("[kernels] labels")
    k_labels = check_labels(KD, vol_u8, v[..., 0].cpu().numpy(), dev,
                            card)
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

    # -- 5. the paper's per-iteration path -------------------------------
    counters = {"histogram_bin": KB.histogram_bin,
                "fcm_resident_solve": KR.resident_solve,
                "labels": KD.labels, "fcm_membership": KM.membership,
                "fcm_center_partials": KC.center_partials,
                "fcm_fused_partials": KC.fused_partials,
                "fcm_streamed_solve": KR.resident_streamed_solve,
                "slic_assign": KS.slic_assign,
                "fcm_stencil_solve": KST.stencil_solve,
                "fcm_spatial_partials_2d": KSP.spatial_partials_2d,
                "fcm_spatial_partials_3d": KSP.spatial_partials_3d,
                "fcm_fused_partials_batched": KC.fused_partials_batched,
                "selective_scan": KSS.selective_scan}
    paper = paper_path(SV, F, phantom, KM, KC, counters, dev, card)

    # -- 6. the pixel and superpixel routes ------------------------------
    routes = routes_path(KR, KS, KC, SV, SL, FCMServeEngine, job, counters,
                         imgs, gts, vol_u8, big, phantom, dev, card)

    # -- 7. the spatial (FCM_S) route ------------------------------------
    t7 = time.perf_counter()
    big_img, big_gt = phantom.phantom_of_bytes(BIG_BYTES)
    spatial = spatial_path(SV, KSP, KST, FCMServeEngine, job, counters,
                           big_img, big_gt, phantom, dev, card)
    print(f"[spatial] {time.perf_counter() - t7:.1f} s")

    # -- 8. Jamba's hybrid stack: loss_fn and train steps -----------------
    t8 = time.perf_counter()
    k_scan = lm_path(KSS, counters, dev, card)
    print(f"[lm] {time.perf_counter() - t8:.1f} s")

    # -- 9. async serving and chaos on the card -----------------------------
    t9 = time.perf_counter()
    async_path(FCMServeEngine, TE, TFI, job, counters, imgs, dev, card)
    print("[async] where an async flush's time goes (9d)")
    async_anatomy(FCMServeEngine, job, imgs, dev, card)
    print(f"[async] {time.perf_counter() - t9:.1f} s")

    # -- 10. the mesh: sharded fits and the meshed engine -------------------
    t10 = time.perf_counter()
    mesh_path(TD, TB, SV, F, KB, _build, FCMServeEngine, job, counters,
              imgs, big_u8, dev, card)
    print(f"[mesh] {time.perf_counter() - t10:.1f} s")

    # -- 11. LM serving: prefill, decode and ServeEngine --------------------
    t11 = time.perf_counter()
    served = serve_path(counters, dev, card)
    print(f"[serve] {time.perf_counter() - t11:.1f} s")

    # -- 12. RWKV6, MLA, the whisper encoder, gated cross-attention ---------
    t12 = time.perf_counter()
    archs_path(counters, dev, card)
    print(f"[archs] {time.perf_counter() - t12:.1f} s")

    # -- 13. LM training through the launcher -------------------------------
    t13 = time.perf_counter()
    trained = train_path(counters, dev, card)
    print(f"[train] {time.perf_counter() - t13:.1f} s")

    # -- 14. the analysis layer, the dry-run planner and the examples -------
    t14 = time.perf_counter()
    analysis_path(counters, imgs, dev, card)
    print(f"[analysis] {time.perf_counter() - t14:.1f} s")

    # -- 15. the train state stored split across the mesh -------------------
    t15 = time.perf_counter()
    placed = placed_path(counters, dev, card)
    print(f"[placed] {time.perf_counter() - t15:.1f} s")

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
        dict(name="fcm_membership", route="cuda",
             source="src/repro_torch/csrc/fcm_membership.cu",
             replaces="src/repro/kernels/fcm_membership.py:43",
             **paper["fcm_membership"]),
        dict(name="fcm_center_partials", route="cuda",
             source="src/repro_torch/csrc/fcm_centers.cu",
             replaces="src/repro/kernels/fcm_centers.py:70",
             **paper["fcm_center_partials"]),
        dict(name="fcm_fused_partials", route="cuda",
             source="src/repro_torch/csrc/fcm_centers.cu",
             replaces="src/repro/kernels/fcm_centers.py:98",
             **paper["fcm_fused_partials"]),
        dict(name="fcm_streamed_solve", route="cuda",
             source="src/repro_torch/csrc/fcm_streamed.cu",
             replaces="src/repro/kernels/fcm_resident.py:222",
             **routes["fcm_streamed_solve"]),
        dict(name="slic_assign", route="cuda",
             source="src/repro_torch/csrc/slic_assign.cu",
             replaces="src/repro/kernels/slic_assign.py:83",
             **routes["slic_assign"]),
        dict(name="fcm_stencil_solve", route="cuda",
             source="src/repro_torch/csrc/fcm_stencil.cu",
             replaces="src/repro/kernels/fcm_resident.py:347",
             **spatial["fcm_stencil_solve"]),
        dict(name="fcm_spatial_partials_2d", route="cuda",
             source="src/repro_torch/csrc/fcm_spatial.cu",
             replaces="src/repro/kernels/fcm_spatial.py:170",
             **spatial["fcm_spatial_partials_2d"]),
        dict(name="fcm_spatial_partials_3d", route="cuda",
             source="src/repro_torch/csrc/fcm_spatial.cu",
             replaces="src/repro/kernels/fcm_spatial.py:184",
             **spatial["fcm_spatial_partials_3d"]),
        dict(name="fcm_fused_partials_batched", route="cuda",
             source="src/repro_torch/csrc/fcm_centers.cu",
             replaces="src/repro/kernels/fcm_centers.py:98",
             **routes["fcm_fused_partials_batched"]),
        dict(name="selective_scan", route="cuda",
             source="src/repro_torch/csrc/selective_scan.cu",
             replaces="src/repro/kernels/selective_scan.py:57",
             prefill_launches=served["jamba"]["launches"],
             train_launches=trained["wide"],
             mesh_train_launches=trained["mesh"],
             placed_train_launches=placed["scan"], **k_scan),
    ]
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
