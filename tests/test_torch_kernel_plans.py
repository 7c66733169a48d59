"""The shape plans of the port's redesigned kernels, on the CPU.

The chunked selective scan (``csrc/selective_scan.cu``) cuts S into
chunks of :func:`chunk_len` positions, walks each chunk from zero state,
carries the end states across the chunks with ``exp(A * sum dt)`` and
walks each chunk again from its carried-in state. A float32 numpy model
of that decomposition, in the kernel's order, is held here against the
JAX package's oracle and the port's plain recurrence on the same seeded
inputs, at ``chip_smoke.py``'s scan tolerance (1e-4 of max |y|).

The stencil whole-solve (``csrc/fcm_stencil.cu``) takes its cluster size
and form from :func:`stencil_plan`; its shared-memory count and the
bands it implies are checked here.

The 3-D FCM_S step (``csrc/fcm_spatial.cu``) marches tiles of columns
along z in runs of planes from :func:`spatial3d_plan`; the SLIC
assignment (``csrc/slic_assign.cu``) stages each tile's cell window
(:func:`tile_cell_window`). The HBM-streamed whole-solve
(``csrc/fcm_streamed.cu``) gives each lane a group of blocks and the
groups rounds of lanes from :func:`streamed_plan`; the center partials
(``csrc/fcm_centers.cu``) take quads of pixels over
:func:`center_blocks` blocks. The batched fused partials
(``csrc/fcm_centers.cu``) take tiles of rows over :func:`batched_plan`
blocks a lane; the 2-D FCM_S step (``csrc/fcm_spatial.cu``) marches
warp tasks of :func:`spatial2d_plan`. Their coverage is checked here by
mirroring the kernels' index rules, as is that of the ingest binning
(``csrc/histogram_bin.cu``: aligned 16-byte words over
:func:`bin_blocks` blocks a lane) and of the scalar fused partials (the
batched form's plan at one lane). The wrappers of the kernels whose
lanes once sat on a grid axis capped at 65535 are driven past their
device checks with a fake library at 65 537 lanes. The labels kernel
(``csrc/defuzzify.cu``) takes (lane, segment) blocks from
:func:`labels_plan` and splits a lane into a head, aligned 16-byte
words and a tail, whose coverage is checked here at every offset. The
resident whole-solve (``csrc/fcm_resident.cu``) takes its form from
:func:`resident_plan`; a float32 numpy model of its
reduction order is held against the JAX package's kernel in interpret
mode. The kernels themselves run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import phantom as jphantom
from repro.kernels import fcm_resident as JKR
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import solver as TS
from repro_torch.kernels import _build
from repro_torch.kernels import defuzzify as KD
from repro_torch.kernels import fcm_centers as KC
from repro_torch.kernels import fcm_resident as KR
from repro_torch.kernels import fcm_spatial as KSP
from repro_torch.kernels import fcm_stencil as KST
from repro_torch.kernels import histogram_bin as KB
from repro_torch.kernels import selective_scan as KSS
from repro_torch.kernels import slic_assign as KS
from repro_torch.superpixel import slic as SL

SCAN_TOL = 1e-4


def _scan_data(b, s, di, ds, seed, dt_range=(1e-3, 0.1)):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, s, di)).astype(np.float32),
            rng.uniform(*dt_range, (b, s, di)).astype(np.float32),
            rng.normal(0, 1, (b, s, ds)).astype(np.float32),
            rng.normal(0, 1, (b, s, ds)).astype(np.float32),
            -rng.uniform(0.5, 4.0, (di, ds)).astype(np.float32))


def chunked_scan_model(u, dt, bm, cm, a, chunk):
    """The kernels' three launches in float32 numpy: walk every chunk but
    the last from zero state (end state, dt sum), carry across the chunks,
    walk every chunk again from its carried-in state."""
    f32 = np.float32
    b, s, di = u.shape
    a2 = (a * f32(1.4426950408889634)).astype(f32)           # (di, ds)
    n_c = -(-s // chunk)

    def walk(k, h):
        ys, dsum = [], np.zeros((b, di), f32)
        for t in range(k * chunk, min(s, (k + 1) * chunk)):
            da = np.exp2(dt[:, t, :, None] * a2).astype(f32)
            dtu = (dt[:, t] * u[:, t])[..., None]
            h = (da * h + dtu * bm[:, t, None, :]).astype(f32)
            ys.append((h * cm[:, t, None, :]).sum(-1, dtype=f32))
            dsum = (dsum + dt[:, t]).astype(f32)
        return h, dsum, ys

    zero = np.zeros((b, di, a.shape[1]), f32)
    h_in = [zero]
    for k in range(n_c - 1):
        end, dsum, _ = walk(k, zero)
        decay = np.exp2(a2 * dsum[..., None]).astype(f32)
        h_in.append((decay * h_in[-1] + end).astype(f32))
    ys = [y for k in range(n_c) for y in walk(k, h_in[k])[2]]
    return np.stack(ys, axis=1)


@pytest.mark.parametrize("b,s,di,ds,chunk,dt_range", [
    (1, 1, 8, 4, None, (1e-3, 0.1)),        # S = 1: one chunk
    (1, 20, 16, 4, 64, (1e-3, 0.1)),        # S < L
    (1, 100, 12, 8, 32, (1e-3, 0.1)),       # S not a multiple of L
    (2, 130, 10, 16, 64, (1e-3, 0.1)),      # B = 2
    (1, 257, 6, 1, 32, (1e-3, 0.1)), (1, 96, 5, 32, 7, (1e-3, 0.1)),
    (2, 200, 8, 16, 32, (0.5, 40.0))])      # the decay underflows in a chunk
def test_chunked_scan_model_matches_jax_and_plain(b, s, di, ds, chunk,
                                                  dt_range):
    ins = _scan_data(b, s, di, ds, seed=s + di + ds, dt_range=dt_range)
    chunk = chunk or KSS.chunk_len(b, s, di, 132)
    got = chunked_scan_model(*ins, chunk)
    want = np.asarray(jref.selective_scan_ref(*[jnp.asarray(x)
                                                for x in ins]))
    plain = KSS.selective_scan(*[torch.from_numpy(x)
                                 for x in ins]).numpy()
    top = float(np.abs(want).max())
    assert np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= SCAN_TOL * top
    assert float(np.abs(plain - want).max()) <= SCAN_TOL * top


@pytest.mark.parametrize("b,s,di,sm,want", [
    (1, 4096, 8192, 132, 125),      # jamba's mixers at train_4k: 33 chunks
    (2, 128, 128, 132, 32),         # the reduced train step: MIN_CHUNK
    (1, 100, 96, 132, 32), (1, 1, 16, 132, 1), (1, 20, 200, 132, 20),
    (4, 4096, 8192, 132, 456), (1, 4096, 8192, 66, 241)])
def test_chunk_len_from_the_shape_and_the_sm_count(b, s, di, sm, want):
    chunk = KSS.chunk_len(b, s, di, sm)
    assert chunk == want
    n_c = -(-s // chunk)
    assert 1 <= chunk <= s and n_c <= KSS.MAX_CHUNKS
    # enough chunks to offer every SM its threads, unless a chunk is
    # already at the floor of MIN_CHUNK positions (or the whole sequence)
    assert (b * di * n_c >= sm * KSS.THREADS_PER_SM
            or chunk in (KSS.MIN_CHUNK, s))


def test_chunk_len_caps_the_chunk_count_and_rejects_empty_shapes():
    s = 10 * KSS.MAX_CHUNKS * KSS.MIN_CHUNK
    assert -(-s // KSS.chunk_len(1, s, 1, 132)) <= KSS.MAX_CHUNKS
    with pytest.raises(ValueError):
        KSS.chunk_len(1, 0, 8, 132)


def test_scan_workspace_holds_every_chunk_but_the_last():
    assert KSS.workspace_shapes(1, 4096, 8192, 16, 125) == (
        (1, 32, 16, 8192), (1, 32, 8192))
    assert KSS.workspace_shapes(2, 64, 8, 4, 64) is None
    assert KSS.workspace_shapes(2, 65, 8, 4, 64) == ((2, 1, 4, 8), (2, 1, 8))


def test_the_route_bucket_lane_is_held_on_chip_in_eight_blocks():
    """A 217x181 BrainWeb slice: 8 blocks of 28 rows, x with its two halo
    rows and x_eff, 41 992 B each (two blocks share an SM)."""
    plan = KST.stencil_plan(1, 217, 181, 8)
    assert plan == KST.StencilPlan(8, KST.ON_CHIP_X_EFF,
                                   4 * 181 * (28 + 2 + 28))


def _plan_grids():
    grids = [(1, h, w, nb) for h, w in ((1, 1), (1, 300), (37, 61),
                                        (217, 181), (256, 256), (512, 512),
                                        (880, 512), (881, 512),
                                        (1024, 1024), (4000, 256))
             for nb in (4, 8)]
    return grids + [(d, h, w, 6) for d, h, w in ((1, 5, 7), (5, 19, 23),
                                                 (8, 64, 64), (16, 128, 128),
                                                 (64, 128, 128))]


@pytest.mark.parametrize("grid", _plan_grids())
def test_stencil_plan_follows_its_rule(grid):
    depth, h, w, nb = grid
    plan = KST.stencil_plan(*grid)
    n = depth * h * w
    top = min(KST.MAX_CLUSTER, depth if nb == 6 else h)

    def fits(r, form):
        return KST.onchip_bytes(depth, h, w, nb, r, form) <= KST.SMEM_BUDGET

    if plan.form == KST.OFF_CHIP:
        assert not any(fits(r, f) for r in range(1, top + 1)
                       for f in (KST.ON_CHIP_X, KST.ON_CHIP_X_EFF))
        assert plan.ranks == min(KST.MAX_CLUSTER,
                                 -(-n // KST.PIXELS_PER_BLOCK))
        assert plan.smem_bytes == 0
        return
    if plan.form == KST.ON_CHIP_X:     # x_eff fits no cluster
        assert not any(fits(r, KST.ON_CHIP_X_EFF) for r in range(1, top + 1))
    fewest = min(r for r in range(1, top + 1) if fits(r, plan.form))
    assert plan.ranks == max(fewest, min(
        top, -(-n // KST.PIXELS_PER_BLOCK)))
    assert plan.smem_bytes == KST.onchip_bytes(depth, h, w, nb, plan.ranks,
                                               plan.form) <= KST.SMEM_BUDGET


@pytest.mark.parametrize("grid", _plan_grids())
def test_stencil_bands_cover_the_lane_once(grid):
    """The kernel's split of the rows (planes) over the cluster: every
    unit in exactly one band, every band with its halo inside the block's
    shared memory."""
    depth, h, w, nb = grid
    plan = KST.stencil_plan(*grid)
    if plan.form == KST.OFF_CHIP:
        return
    unit, n_units = (h * w, depth) if nb == 6 else (w, h)
    per = -(-n_units // plan.ranks)
    seen = []
    for r in range(plan.ranks):
        u0 = min(n_units, r * per)
        u1 = min(n_units, u0 + per)
        seen.extend(range(u0, u1))
        held = (per + 2) * unit * 4 + (per * unit * 4 if plan.form ==
                                       KST.ON_CHIP_X_EFF else 0)
        assert held == plan.smem_bytes
    assert seen == list(range(n_units))


def test_the_onchip_fit_edge_at_512_columns():
    """880 rows of 512 hold x alone in 8 blocks of 229 376 B; 881 do not
    fit, and take the off-chip form."""
    inside = KST.stencil_plan(1, 880, 512, 8)
    assert inside == KST.StencilPlan(8, KST.ON_CHIP_X, 4 * 512 * (110 + 2))
    assert KST.stencil_plan(1, 881, 512, 8).form == KST.OFF_CHIP


def test_stencil_plan_rejects_an_empty_grid():
    with pytest.raises(ValueError):
        KST.stencil_plan(1, 0, 5, 8)


# -- the 3-D FCM_S step's march ---------------------------------------------

_VOLUMES = [(181, 217, 181), (1, 1, 1), (2, 2, 2), (5, 19, 23), (37, 19, 23),
            (70, 9, 33), (KSP.Z_RUN + 1, 8, 32), (3 * KSP.Z_RUN, 9, 33),
            (1, 64, 64), (1, 217, 181)]


def _march_blocks(depth, h, w, plan):
    """The kernel's blocks as it decodes them: (z0, z1, y0, y1, x0, x1)
    for block (tile, run), tiles x fastest."""
    tw, th = plan.tile
    tiles_x = -(-w // tw)
    for run in range(plan.runs):
        for tile in range(plan.tiles):
            ty, tx = divmod(tile, tiles_x)
            z0 = run * plan.z
            yield (z0, min(depth, z0 + plan.z), ty * th, min(h, ty * th + th),
                   tx * tw, min(w, tx * tw + tw))


@pytest.mark.parametrize("shape", _VOLUMES)
def test_spatial3d_plan_covers_every_voxel_once(shape):
    depth, h, w = shape
    plan = KSP.spatial3d_plan(depth, h, w)
    seen = np.zeros(shape, np.int32)
    n = 0
    for z0, z1, y0, y1, x0, x1 in _march_blocks(depth, h, w, plan):
        assert z0 < z1 and y0 < y1 and x0 < x1      # no empty block
        seen[z0:z1, y0:y1, x0:x1] += 1
        n += 1
    assert (seen == 1).all()
    assert n == plan.rows == plan.tiles * plan.runs
    assert 1 <= plan.z <= max(depth, 1) and plan.runs == -(-depth // plan.z)


def test_spatial3d_plan_fills_the_card_with_the_route_volume():
    """The spatial route's volume at B = 1: at least two blocks for each
    of an H100's 132 SMs, and about 30x fewer partial rows than one
    plane a block (30 408)."""
    plan = KSP.spatial3d_plan(181, 217, 181)
    assert plan.tiles == 6 * 28
    assert plan.rows >= 2 * 132
    assert plan.rows * 10 <= 181 * 6 * 28
    assert plan.smem_bytes == 2 * 10 * 34 * 4


def test_spatial3d_plan_depends_on_the_shape_alone():
    a = KSP.spatial3d_plan(37, 19, 23)
    assert a == KSP.spatial3d_plan(37, 19, 23)
    assert a.z == KSP.spatial3d_plan(37, 5, 7).z
    with pytest.raises(ValueError):
        KSP.spatial3d_plan(0, 4, 4)


class _FakeLibrary:
    """Stands in for the kernel library: records the 3-D step's run
    length and lane count, and the scratch the wrapper passes."""
    def __init__(self):
        self.calls = []

    def fcm_spatial_partials_3d(self, x, v, b, depth, h, w, c, alpha, m,
                                expo, z_run, part, out, stream):
        self.calls.append(dict(b=b, shape=(depth, h, w), c=c, z=z_run))
        return 0


@pytest.mark.parametrize("b,shape", [(1, (37, 19, 23)), (3, (37, 19, 23)),
                                     (2, (181, 217, 181)), (1, (1, 1, 1))])
def test_spatial3d_scratch_holds_the_plan_rows(monkeypatch, b, shape):
    """The wrapper passes the plan's run length and sizes the partials
    scratch to the plan's rows, the same for a lane alone and in a
    bucket. The wrapper is driven past its device check with a fake
    library; the rows it must allocate follow the kernel's rule, tiles
    of the plane times runs of z planes."""
    lib = _FakeLibrary()
    scratch = []
    real_buffers = KSP._buffers

    def spy(x, c, n_rows):
        part, out = real_buffers(x, c, n_rows)
        scratch.append(tuple(part.shape))
        return part, out
    monkeypatch.setattr(KSP, "_checked", lambda *a: True)
    monkeypatch.setattr(KSP, "_buffers", spy)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    depth, h, w = shape
    x = torch.zeros((b,) + shape)
    v = torch.zeros((b, 4))
    before = KSP.spatial_partials_3d.launches
    KSP.spatial_partials_3d(x, v, 2.0, 1.0)
    assert KSP.spatial_partials_3d.launches == before + 1
    KSP.spatial_partials_3d.launches = before
    plan = KSP.spatial3d_plan(*shape)
    rows = -(-h // 8) * -(-w // 32) * -(-depth // lib.calls[0]["z"])
    assert lib.calls == [dict(b=b, shape=shape, c=4, z=plan.z)]
    assert scratch == [(b, plan.rows, 8)] and plan.rows == rows


# -- the SLIC assignment's cell windows ---------------------------------------

_SLIC_SHAPES = [(512, 512, 256), (217, 181, 256), (129, 131, 100),
                (64, 300, 48), (300, 64, 48), (1, 1, 1), (7, 500, 9)]


def _candidates(h, w, gy, gx):
    """Every pixel's nine candidate cells under assign_ref's rule:
    ((H, W, 9) cell rows, (H, W, 9) cell columns)."""
    inv_sy, inv_sx = KS.cell_reciprocals(h, w, gy, gx)
    yy = np.arange(h, dtype=np.float32)[:, None]
    xx = np.arange(w, dtype=np.float32)[None, :]
    pcy = np.clip((yy * np.float32(inv_sy)).astype(np.int32), 0, gy - 1)
    pcx = np.clip((xx * np.float32(inv_sx)).astype(np.int32), 0, gx - 1)
    pcy, pcx = np.broadcast_arrays(pcy, pcx)
    cy = np.stack([np.clip(pcy + dy, 0, gy - 1) for dy in (-1, 0, 1)
                   for dx in (-1, 0, 1)], axis=-1)
    cx = np.stack([np.clip(pcx + dx, 0, gx - 1) for dy in (-1, 0, 1)
                   for dx in (-1, 0, 1)], axis=-1)
    return cy, cx


def _windows(h, w, gy, gx):
    """Each pixel's tile window, ((H, W) cy0, cy1, cx0, cx1)."""
    ty_n, tx_n = -(-h // KS.TILE_H), -(-w // KS.TILE_W)
    win = np.array([[KS.tile_cell_window(h, w, gy, gx, ty, tx)
                     for tx in range(tx_n)] for ty in range(ty_n)])
    ty = np.arange(h)[:, None] // KS.TILE_H
    tx = np.arange(w)[None, :] // KS.TILE_W
    return [win[ty, tx, i] for i in range(4)]


@pytest.mark.parametrize("h,w,segs", _SLIC_SHAPES)
def test_tile_cell_window_holds_every_candidate(h, w, segs):
    gy, gx = SL.grid_shape(h, w, segs)
    cy, cx = _candidates(h, w, gy, gx)
    cy0, cy1, cx0, cx1 = (a[..., None] for a in _windows(h, w, gy, gx))
    assert ((cy >= cy0) & (cy <= cy1) & (cx >= cx0) & (cx <= cx1)).all()
    # every window fits the shared memory the kernel sizes for it
    inv_sy, inv_sx = KS.cell_reciprocals(h, w, gy, gx)
    assert (cy1 - cy0 + 1).max() <= KS.window_span(KS.TILE_H, inv_sy, gy)
    assert (cx1 - cx0 + 1).max() <= KS.window_span(KS.TILE_W, inv_sx, gx)
    assert KS.smem_bytes(h, w, 3, gy, gx) <= KS.MAX_CENTER_BYTES


@pytest.mark.parametrize("h,w,segs", _SLIC_SHAPES)
def test_assign_ref_labels_lie_in_their_tile_window(h, w, segs):
    """The plain version's labels on a seeded RGB image, seed and
    drifted centers: each pixel's label is a cell of its tile's window,
    and the cell rule of the window's twin is assign_ref's."""
    rng = np.random.default_rng(h * w + segs)
    img = torch.from_numpy(rng.uniform(0, 255, (h, w, 3)).astype(np.float32))
    gy, gx = SL.grid_shape(h, w, segs)
    sw = SL.spatial_weight(h, w, gy, gx, 10.0)
    cen = SL.seed_centers(img, gy, gx)
    cy0, cy1, cx0, cx1 = _windows(h, w, gy, gx)
    for _ in range(2):
        lab = SL.assign_ref(img, cen, gy, gx, sw).numpy()
        ly, lx = lab // gx, lab % gx
        assert ((ly >= cy0) & (ly <= cy1) & (lx >= cx0) & (lx <= cx1)).all()
        cen = SL.update_centers(img, torch.from_numpy(lab), cen)[0]
    inv_sy, _ = KS.cell_reciprocals(h, w, gy, gx)
    ys = torch.arange(h, dtype=torch.float32)
    want = torch.clamp((ys * inv_sy).to(torch.int32), 0, gy - 1)
    assert [KS.cell_of(y, inv_sy, gy) for y in range(h)] == want.tolist()


def test_the_route_image_window_is_three_by_three_cells():
    """512x512 at K = 256: cells of 32 x 32 pixels, so a 32 x 8 tile
    names one cell and its eight neighbours (four at a corner)."""
    gy, gx = SL.grid_shape(512, 512, 256)
    assert (gy, gx) == (16, 16)
    assert KS.tile_cell_window(512, 512, gy, gx, 5, 3) == (0, 2, 2, 4)
    assert KS.tile_cell_window(512, 512, gy, gx, 0, 0) == (0, 1, 0, 1)
    assert KS.tile_cell_window(512, 512, gy, gx, 63, 15) == (14, 15, 14, 15)
    assert KS.smem_bytes(512, 512, 3, gy, gx) == 4 * 5 * 5 * 5


# -- the HBM-streamed whole-solve's plan -------------------------------------

#: an H100's SM count
H100_SMS = 132


def _lane_rows(k, ranks, ahead):
    """The rows of a lane in the order the kernel adds them: for each rank
    (block), each thread's rows, r0 + t, r0 + t + 256, ..., taken ``ahead``
    rows at a time as the kernel's row loop steps."""
    per = -(-k // ranks)
    t_n = KR.STREAM_THREADS
    out = []
    for rank in range(ranks):
        r0 = min(k, rank * per)
        r1 = min(k, r0 + per)
        for t in range(t_n):
            for base in range(r0 + t, r1, ahead * t_n):
                out.extend(r for r in (base + q * t_n for q in range(ahead))
                           if r < r1)
    return out


@pytest.mark.parametrize("k", [1, 255, 5120, 5121, 39277, 262144,
                                1024000, 1 << 20])
@pytest.mark.parametrize("d", [1, 3, 16])
def test_streamed_plan_covers_every_row_of_a_lane_once(k, d):
    plan = KR.streamed_plan(1, k, d, H100_SMS, KR.stream_min_blocks(4, d))
    assert 1 <= plan.ranks <= min(k, KR.STREAM_MAX_RANKS)
    per = -(-k // plan.ranks)
    assert plan.rows_per_thread == -(-per // KR.STREAM_THREADS)
    if k <= 39277:               # the full mirror; the index rule is linear
        for ahead in (1, 2, 4):
            rows = _lane_rows(k, plan.ranks, ahead)
            assert sorted(rows) == list(range(k))
    else:                        # the slices alone at the large sizes
        edges = [min(k, r * per) for r in range(plan.ranks)] + [k]
        assert edges[0] == 0 and all(a <= b for a, b in zip(edges,
                                                             edges[1:]))
        assert all(b - a <= per for a, b in zip(edges, edges[1:]))


@pytest.mark.parametrize("k,d", [(39277, 1), (1024000, 1), (262144, 3),
                                 (3000, 16), (5000, 2), (1, 1)])
def test_streamed_blocks_a_lane_depend_on_its_rows_alone(k, d):
    """The same ranks, so the same slices and reduction order, for a lane
    alone and in a bucket, on any card and at any occupancy."""
    ranks = {KR.streamed_plan(b, k, d, sms, blocks).ranks
             for b in (1, 3, 64, 2000)
             for sms, blocks in ((132, 1), (114, 2), (132, 4), (132, 8))}
    assert ranks == {min(KR.STREAM_MAX_RANKS,
                         -(-k // KR.stream_rows_per_block(d)))}


@pytest.mark.parametrize("b,k,d", [(1, 1024000, 1), (64, 39277, 1),
                                   (2000, 2048, 1), (4, 262144, 3),
                                   (181, 39277, 1), (2, 3000, 16),
                                   (65535, 1, 1), (7, 655361, 8)])
@pytest.mark.parametrize("sms,blocks", [(132, 4), (132, 1), (114, 2),
                                        (132, 8)])
def test_streamed_grid_never_exceeds_the_occupancy(b, k, d, sms, blocks):
    plan = KR.streamed_plan(b, k, d, sms, blocks)
    assert plan.grid == plan.lanes_per_round * plan.ranks
    assert plan.grid <= sms * blocks
    assert 1 <= plan.lanes_per_round <= b
    # rounds of groups: every lane exactly once, each group's lanes in turn
    seen = [lane for g in range(plan.lanes_per_round)
            for lane in range(g, b, plan.lanes_per_round)]
    assert sorted(seen) == list(range(b))
    assert plan.rounds == -(-b // plan.lanes_per_round)
    # as many lanes at once as the card holds
    assert (plan.lanes_per_round == b
            or (plan.lanes_per_round + 1) * plan.ranks > sms * blocks)


def test_the_route_bucket_fits_the_card_in_one_wave():
    """64 BrainWeb slices of 217x181 (39 277 rows): 8 blocks of 256
    threads a lane, 512 blocks, within 132 SMs x the 4 blocks an SM the
    c = 4, D = 1 kernel's launch bounds ask for."""
    blocks = KR.stream_min_blocks(4, 1)
    plan = KR.streamed_plan(64, 39277, 1, H100_SMS, blocks)
    assert blocks == 4
    assert plan == KR.StreamedPlan(8, 256, 20, 64, 1, 512)


def test_a_lone_large_lane_spreads_past_eight_blocks():
    for k, d, want in ((1 << 20, 1, 128), (1024000, 1, 128),
                       (262144, 3, 128), (39277, 3, 20)):
        plan = KR.streamed_plan(1, k, d, H100_SMS,
                                KR.stream_min_blocks(4, d))
        assert plan.ranks == want > 8
        assert plan.rounds == 1


def test_streamed_plan_refuses_a_lane_the_card_cannot_hold():
    with pytest.raises(ValueError, match="holds at once"):
        KR.streamed_plan(1, 1 << 20, 1, 100, 1)
    with pytest.raises(ValueError):
        KR.streamed_plan(0, 5, 1, 132, 4)


class _FakeStreamedLibrary:
    """Stands in for the kernel library: records what the streamed
    wrapper passes."""
    def __init__(self):
        self.calls = []

    def fcm_streamed_solve(self, x, w, v0, tol, b, k, d, c, m, expo,
                           max_iters, ranks, lanes, part, sync, v, delta,
                           iters, stream):
        self.calls.append(dict(b=b, k=k, d=d, c=c, ranks=ranks, lanes=lanes))
        return 0


@pytest.mark.parametrize("b,k,d,c", [(1, 39277, 1, 4), (64, 39277, 1, 4),
                                     (3, 20000, 3, 8), (700, 5121, 1, 4)])
def test_streamed_wrapper_launches_the_plan(monkeypatch, b, k, d, c):
    """The wrapper passes the plan's blocks a lane and lanes a round,
    sizes the partials for them and takes two counters a lane. It is
    driven past its device check with a fake library and occupancy."""
    lib = _FakeStreamedLibrary()
    sizes = []
    real_empty = torch.empty

    def spy_empty(shape, **kw):
        sizes.append(tuple(shape))
        return real_empty(shape, **kw)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "_counters", {})
    monkeypatch.setattr(KR, "streamed_occupancy",
                        lambda dev, c, d, m: (H100_SMS, 4))
    monkeypatch.setattr(KR.torch, "empty", spy_empty)
    x = real_empty((b, k, d))
    before = KR.resident_streamed_solve.launches
    KR._launch_streamed(x, real_empty((b, k)), real_empty((b, c, d)),
                        real_empty((b,)), 2.0, 300, b, k, d, c)
    assert KR.resident_streamed_solve.launches == before + 1
    KR.resident_streamed_solve.launches = before
    plan = KR.streamed_plan(b, k, d, H100_SMS, 4)
    assert lib.calls == [dict(b=b, k=k, d=d, c=c, ranks=plan.ranks,
                              lanes=plan.lanes_per_round)]
    assert (b * 2 * plan.ranks * c * (d + 1),) in sizes
    counters = _build._counters[(x.device, 0)]
    assert counters.numel() >= 2 * b and not counters.any()


# -- the center partials' quads ---------------------------------------------

@pytest.mark.parametrize("n", [1, 3, 4, 255, 257, 1023, 1025, 4097, 8193,
                               4 * 1024 * 256 + 3, 16 * 1024 * 256,
                               16 * 1024 * 256 + 3])
def test_center_partials_quads_cover_every_pixel_once(n):
    """Thread t of the grid takes quads t, t + G, ... (G the grid's
    threads), pixels 4q .. 4q + 3 masked at N: every pixel once, each
    thread's pixels in index order, a block count from N alone."""
    blocks = KC.center_blocks(n)
    assert 1 <= blocks <= KC.MAX_BLOCKS
    assert blocks == min(KC.MAX_BLOCKS, -(-n // (
        KC.QUAD * KC.QUADS_PER_THREAD * KC.THREADS)))
    g = blocks * KC.THREADS
    n_quads = -(-n // KC.QUAD)
    q = np.arange(n_quads)
    owner = q % g                                  # the thread of each quad
    pix = (KC.QUAD * q[:, None] + np.arange(KC.QUAD)).ravel()
    keep = pix < n
    assert np.array_equal(np.sort(pix[keep]), np.arange(n))
    # a thread's quads rise with its stride, so its pixels are in order
    assert np.all(np.diff(q[owner == 0]) == g)


# -- the ingest binning's words ----------------------------------------------

def _bin_bytes(start, n, itemsize):
    """The lane bytes each (block, thread, word) of the binning kernel
    reads, for a lane whose first byte lies ``start`` bytes into the
    buffer: block blk, thread t, word k reads the 16-byte word (start //
    16) * 16 + blk * BLOCK_BYTES + 16 (k * THREADS + t) if it starts
    before the lane's end, and bins the bytes of it inside the lane.
    Returns each binned byte's offset into the lane."""
    blocks = KB.bin_blocks(n, itemsize)
    lo, hi = start, start + n * itemsize
    blk, k, t = np.meshgrid(np.arange(blocks), np.arange(KB.WORDS),
                            np.arange(KB.THREADS), indexing="ij")
    word = (lo // 16) * 16 + blk * KB.BLOCK_BYTES + 16 * (k * KB.THREADS + t)
    word = word[word < hi]
    byte = (word[:, None] + np.arange(16)).ravel()
    return byte[(byte >= lo) & (byte < hi)] - lo


@pytest.mark.parametrize("n", [1, 15, 16, 17, 4096, 16384, 39277, 1_024_000])
@pytest.mark.parametrize("itemsize,start", [(1, 0), (1, 1), (1, 7), (1, 15),
                                            (1, 39277), (4, 0), (4, 4),
                                            (4, 12), (4, 4 * 39277)])
def test_binning_words_cover_every_pixel_once(n, itemsize, start):
    """Every byte of a lane is binned exactly once, at any alignment of
    the lane's first byte (uint8 lanes of a (B, 39277) bucket start at
    every alignment; int32 lanes at multiples of 4), and an int32 pixel
    never straddles two words; the block count comes from N and the
    pixel size alone."""
    got = np.sort(_bin_bytes(start, n, itemsize))
    assert np.array_equal(got, np.arange(n * itemsize))
    if itemsize == 4:
        assert ((start + got[::4]) % 16 <= 12).all()
    assert KB.bin_blocks(n, itemsize) == -(-(n * itemsize + 15)
                                           // KB.BLOCK_BYTES)


def test_the_route_bucket_bins_in_clusters_of_two_blocks():
    """A 217x181 uint8 slice is 2 blocks of 20 KB, one cluster, so the
    route's bucket of 64 lanes is 128 blocks, at most one on each of the
    H100's 132 SMs; the 1000 KB image alone 51 blocks, past a cluster,
    folded by its last block; an int32 slice 8, one cluster."""
    assert KB.BLOCK_BYTES == 20480
    assert KB.bin_blocks(217 * 181, 1) == 2 <= KB.MAX_CLUSTER
    assert 64 * KB.bin_blocks(217 * 181, 1) == 128 <= H100_SMS
    assert KB.bin_blocks(1_024_000, 1) == 51 > KB.MAX_CLUSTER
    assert KB.bin_blocks(217 * 181, 4) == 8 == KB.MAX_CLUSTER


class _FakeBinLibrary:
    def __init__(self):
        self.calls = []

    def histogram_bin_u8(self, px, b, n, n_bins, blocks, part, ticket, out,
                         stream):
        self.calls.append(("u8", b, n, n_bins, blocks))
        return 0

    def histogram_bin_i32(self, px, b, n, n_bins, blocks, part, ticket, out,
                          stream):
        self.calls.append(("i32", b, n, n_bins, blocks))
        return 0


@pytest.mark.parametrize("dtype,b,n,n_bins", [
    (torch.uint8, 64, 39277, 256), (torch.uint8, 1, 1_024_000, 256),
    (torch.int32, 3, 1000, 256), (torch.uint8, 2, 1, 256),
    (torch.int32, 2, 5000, 7), (torch.int32, 2, 40000, 300)])
def test_binning_wrapper_launches_once_with_the_plan(monkeypatch, dtype, b, n,
                                                     n_bins):
    """One library call a wrapper call, with the plan's blocks, partial
    rows of n_bins rounded up to 4 ints only where a lane has more blocks
    than a cluster holds, and one ticket a lane; the output is
    float32."""
    lib = _FakeBinLibrary()
    sizes = []
    real_empty = torch.empty

    def spy(*shape, **kw):
        t = real_empty(*shape, **kw)
        sizes.append((tuple(t.shape), t.dtype))
        return t
    monkeypatch.setattr(KB, "_checked", lambda *a: True)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "_counters", {})
    monkeypatch.setattr(torch, "empty", spy)
    before = KB.histogram_bin.launches
    out = KB.histogram_bin(torch.zeros((b, n), dtype=dtype), n_bins)
    assert KB.histogram_bin.launches == before + 1
    KB.histogram_bin.launches = before
    blocks = KB.bin_blocks(n, torch.zeros((), dtype=dtype).element_size())
    kind = "u8" if dtype == torch.uint8 else "i32"
    assert lib.calls == [(kind, b, n, n_bins, blocks)]
    assert out.dtype == torch.float32 and tuple(out.shape) == (b, n_bins)
    rows = (b * blocks * (-(-n_bins // 4) * 4) if blocks > KB.MAX_CLUSTER
            else 0)
    assert ((rows,), torch.int32) in sizes
    assert _build._counters[(out.device, 0)].numel() >= b


# -- the scalar fused partials' plan -----------------------------------------

@pytest.mark.parametrize("n", [1, 3, 255, 1023, 1024, 1025, 8193, 39277,
                               300000, 1_024_000])
@pytest.mark.parametrize("c", [1, 4, 8, 12, 32])
@pytest.mark.parametrize("weighted,m", [(False, 2.0), (True, 2.0),
                                        (False, 2.5)])
def test_fused_partials_plan_covers_every_pixel_once(n, c, weighted, m):
    """The scalar fused partials take the batched form's plan at one lane
    of scalar rows (8 rows a thread at c <= 8 with unit weights, 4 with
    weights at c <= 4), or one row a thread where that would leave fewer
    blocks than an H100's SMs or m != 2: every pixel once, a block count
    from N, c, the weights' presence and m == 2 alone, never from the
    values."""
    plan = KC.scalar_plan(n, c, weighted, m)
    tier_rows = KC.batched_plan(1, n, 1, c, weighted).rows_per_thread
    assert tier_rows == (8 if c <= 8 and not (weighted and c <= 4) else 4)
    spread = -(-n // (KC.THREADS * tier_rows)) >= KC.SPREAD_BLOCKS
    assert plan.rows_per_thread == (tier_rows if spread and m == 2.0 else 1)
    if plan.rows_per_thread == 1:
        tiles = -(-n // KC.THREADS)
        owner = np.arange(tiles) % plan.blocks
        rows = (np.arange(tiles)[:, None] * KC.THREADS
                + np.arange(KC.THREADS)).ravel()
        blocks = np.repeat(owner, KC.THREADS)[rows < n]
        rows = rows[rows < n]
    else:
        blocks, rows = _batched_rows(n, plan)
    assert np.array_equal(np.sort(rows), np.arange(n))
    assert plan.grid == plan.blocks == min(-(-n // plan.tile),
                                           KC.BATCHED_MAX_BLOCKS)
    assert len(np.unique(blocks)) == plan.blocks
    assert plan.part_floats == plan.blocks * 2 * c


def test_the_1000kb_image_sits_on_the_card_in_one_wave():
    """The fused solve's call: 8 rows a thread, 500 blocks (4 an SM at
    most, the 48-register kernel's 5 an SM allow it); a 217x181 slice
    and N = 8193 take one row a thread, 154 and 33 blocks."""
    big = KC.scalar_plan(1_024_000, 4, False, 2.0)
    assert (big.rows_per_thread, big.blocks) == (8, 500)
    assert -(-big.blocks // H100_SMS) <= 4
    assert KC.scalar_plan(39277, 4, False, 2.0).blocks == 154
    assert KC.scalar_plan(8193, 4, False, 2.5)[3:6] == (1, 256, 33)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("n,c", [(1_024_000, 4), (8193, 8), (1, 2),
                                 (70000, 32)])
def test_fused_partials_wrapper_launches_the_plan(monkeypatch, weighted, n,
                                                  c):
    """One library call a wrapper call with the plan's blocks and rows a
    thread, a null weight pointer for unit weights, partials of the
    plan's size and one ticket."""
    calls, sizes = [], []
    real_empty = torch.empty

    class Lib:
        def fcm_fused_partials(self, x, w, nn, v, cc, m, expo, blocks, rpt,
                               part, ticket, num, den, stream):
            calls.append((w is None, nn, cc, blocks, rpt))
            return 0

    def spy(*shape, **kw):
        t = real_empty(*shape, **kw)
        sizes.append(tuple(t.shape))
        return t
    monkeypatch.setattr(KC, "_checked", lambda *a: True)
    monkeypatch.setattr(_build, "library", lambda: Lib())
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "_counters", {})
    monkeypatch.setattr(torch, "empty", spy)
    x = torch.zeros(n)
    before = KC.fused_partials.launches
    KC.fused_partials(x, torch.ones(n) if weighted else None, torch.zeros(c),
                      2.0)
    assert KC.fused_partials.launches == before + 1
    KC.fused_partials.launches = before
    plan = KC.scalar_plan(n, c, weighted, 2.0)
    assert calls == [(not weighted, n, c, plan.blocks, plan.rows_per_thread)]
    assert (plan.blocks, 2 * c) in sizes
    assert _build._counters[(x.device, 0)].numel() >= 1


# -- buckets of more than 65535 lanes ----------------------------------------

#: a bucket one lane past two full chunks of 65535 would need; two lanes
#: past one
BIG_B = 65537


class _FakeLaneLibrary:
    """Stands in for the kernel library: records, for each call of the
    kernels whose lanes once sat on a grid axis capped at 65535 and of the
    resident whole-solve, the lanes it was given and the pointers of its
    first input and output."""
    def __init__(self):
        self.calls = []

    def fcm_resident_solve(self, x, w, v0, tol, b, k, d, c, m, expo,
                           max_iters, tier, v, delta, iters, stream):
        self.calls.append((b, x, v))
        return 0

    def fcm_fused_partials_batched(self, x, w, b, n, d, v, c, m, expo,
                                   blocks, rpt, part, ticket, num, den,
                                   stream):
        self.calls.append((b, x, num))
        return 0

    def fcm_streamed_solve(self, x, w, v0, tol, b, k, d, c, m, expo,
                           max_iters, ranks, lanes, part, sync, v, delta,
                           iters, stream):
        self.calls.append((b, x, v))
        return 0

    def fcm_stencil_solve(self, x, v0, tol, b, depth, h, w, c, neighbors,
                          alpha, one_alpha, m, expo, max_iters, ranks, form,
                          v, delta, iters, stream):
        self.calls.append((b, x, v))
        return 0

    def fcm_spatial_partials_2d(self, x, v, b, h, w, c, neighbors, alpha, m,
                                expo, warp_rows, part, ticket, out, stream):
        self.calls.append((b, x, out))
        return 0

    def fcm_spatial_partials_3d(self, x, v, b, depth, h, w, c, alpha, m,
                                expo, z_run, part, out, stream):
        self.calls.append((b, x, out))
        return 0

    def histogram_bin_i32(self, px, b, n, n_bins, blocks, part, ticket, out,
                          stream):
        self.calls.append((b, px, out))
        return 0

    def labels_f32(self, x, b, n, v, c, segs, out, stream):
        self.calls.append((b, x, out))
        return 0


def _drive_1(monkeypatch, x):
    monkeypatch.setattr(KB, "_checked", lambda *a: True)
    return KB.histogram_bin(x.reshape(x.shape[0], -1), 256)


def _drive_2(monkeypatch, x):
    monkeypatch.setattr(KR, "_on_card", lambda t: True)
    b = x.shape[0]
    return KR.resident_solve(x, torch.ones(x.shape[:2]),
                             torch.zeros((b, 2, 1)), torch.zeros((b,)), 2.0,
                             300)[0]


def _drive_3(monkeypatch, x):
    monkeypatch.setattr(KD, "_checked", lambda *a: True)
    return KD.labels(x.reshape(x.shape[0], -1), torch.zeros((x.shape[0], 2)))


def _drive_6b(monkeypatch, x):
    monkeypatch.setattr(KC, "_batched_checked", lambda *a: True)
    w = torch.ones(x.shape[:2])
    v = torch.zeros((x.shape[0], 2, 1))
    return KC.fused_partials_batched(x, w, v, 2.0)[0]


def _drive_7(monkeypatch, x):
    monkeypatch.setattr(KR, "_on_card", lambda t: True)
    monkeypatch.setattr(KR, "streamed_occupancy",
                        lambda dev, c, d, m: (H100_SMS, 4))
    b = x.shape[0]
    return KR.resident_streamed_solve(
        x, torch.ones(x.shape[:2]), torch.zeros((b, 2, 1)),
        torch.zeros((b,)), 2.0, 300)[0]


def _drive_8(monkeypatch, x):
    monkeypatch.setattr(KST, "_checked", lambda *a: True)
    b = x.shape[0]
    return KST.stencil_solve(x, torch.zeros((b, 2)), torch.zeros((b,)), 2.0,
                             1.0, 8, 300)[0]


def _drive_9(monkeypatch, x):
    monkeypatch.setattr(KSP, "_checked", lambda *a: True)
    return KSP.spatial_partials_2d(x, torch.zeros((x.shape[0], 2)), 2.0,
                                   1.0, 8)[0]


def _drive_10(monkeypatch, x):
    monkeypatch.setattr(KSP, "_checked", lambda *a: True)
    return KSP.spatial_partials_3d(x, torch.zeros((x.shape[0], 2)), 2.0,
                                   1.0)[0]


#: PERF.md row -> (its _drive_ function, its wrapper, a lane's shape, the
#: lanes of each library call)
_PAST_65535 = {
    "1": (_drive_1, KB.histogram_bin, (2, 1), [BIG_B]),
    "2": (_drive_2, KR.resident_solve, (2, 1), [BIG_B]),
    "3": (_drive_3, KD.labels, (2, 1), [BIG_B]),
    "6b": (_drive_6b, KC.fused_partials_batched, (2, 1), [BIG_B]),
    "7": (_drive_7, KR.resident_streamed_solve, (2, 1), [BIG_B]),
    "8": (_drive_8, KST.stencil_solve, (2, 2), [65535, 2]),
    "9": (_drive_9, KSP.spatial_partials_2d, (2, 2), [BIG_B]),
    "10": (_drive_10, KSP.spatial_partials_3d, (2, 2, 2), [65535, 2])}


@pytest.mark.parametrize("row", sorted(_PAST_65535))
def test_a_bucket_past_65535_lanes_takes_chunks_or_one_call(monkeypatch,
                                                            row):
    """65 537 tiny lanes through each wrapper, driven past its device
    check with a fake library: rows 8 and 10 (lanes on gridDim.y or z)
    make one call a chunk, of 65535 and 2 lanes, each into its own slice
    of the inputs and outputs; rows 1, 2, 3, 6b, 7 and 9 (a 1-D grid)
    make one call. No wrapper raises, and launches counts the calls."""
    drive, fn, shape, lanes = _PAST_65535[row]
    lib = _FakeLaneLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "_counters", {})
    x = torch.zeros((BIG_B,) + shape)
    before = fn.launches
    out = drive(monkeypatch, x)
    assert fn.launches == before + len(lanes)
    fn.launches = before
    assert [b for b, _, _ in lib.calls] == lanes
    starts = np.cumsum([0] + lanes[:-1])
    for (b, xp, op), i0 in zip(lib.calls, starts):
        assert xp == x[i0:].data_ptr()
        assert op == out[i0:].data_ptr()


# -- the batched fused partials' plan ----------------------------------------

def _batched_rows(n, plan):
    """Every row of a lane once per (chunk) in the kernel's order: block
    blk takes tiles blk, blk + blocks, ...; at D = 1 thread t of a tile
    takes quads a * 256 + t (a < rows a thread / 4), rows 4q .. 4q + 3,
    else rows q * 256 + t (q < rows a thread). Returns (block, row)."""
    t_n = KC.THREADS
    rpt = plan.rows_per_thread
    blk = np.arange(plan.blocks)
    tiles = np.arange(-(-n // plan.tile))
    owner = tiles % plan.blocks
    t = np.arange(t_n)
    if plan.dch == 1:
        a, e = np.arange(rpt // 4), np.arange(4)
        off = 4 * (a[:, None, None] * t_n + t[None, :, None]) + e
    else:
        off = np.arange(rpt)[:, None] * t_n + t[None, :]
    rows = tiles[:, None] * plan.tile + off.reshape(1, -1)
    blocks = np.broadcast_to(owner[:, None], rows.shape)
    keep = rows < n
    assert set(owner.tolist()) <= set(blk.tolist())
    return blocks[keep], rows[keep]


@pytest.mark.parametrize("n", [1, 3, 4, 255, 1023, 1024, 1025, 4097, 39277,
                               1100000])
@pytest.mark.parametrize("d,c", [(1, 4), (1, 12), (1, 32), (3, 12),
                                 (24, 32), (2, 3)])
def test_batched_plan_covers_every_row_and_feature_once(n, d, c):
    plan = KC.batched_plan(1, n, d, c)
    blocks, rows = _batched_rows(n, plan)
    assert np.array_equal(np.sort(rows), np.arange(n))
    assert 1 <= plan.blocks <= KC.BATCHED_MAX_BLOCKS
    assert plan.blocks == min(-(-n // plan.tile), KC.BATCHED_MAX_BLOCKS)
    # every block has rows, unless the lane has fewer tiles than the cap
    assert len(np.unique(blocks)) == plan.blocks
    feats = [ch * plan.dch + k for ch in range(plan.chunks)
             for k in range(plan.dch) if ch * plan.dch + k < d]
    assert feats == list(range(d))
    assert plan.part_floats == plan.grid * (c * plan.dch + c)


@pytest.mark.parametrize("n,d,c", [(39277, 1, 12), (1100000, 1, 4),
                                   (262144, 3, 12), (3001, 24, 32), (2, 1, 4),
                                   (5000, 1, 9)])
def test_batched_blocks_depend_on_the_lane_alone(n, d, c):
    """The same tiles, blocks and chunks, so the same reduction order, for
    a lane alone and in a bucket of 64."""
    one, many = KC.batched_plan(1, n, d, c), KC.batched_plan(64, n, d, c)
    assert one._replace(grid=0, part_floats=0) == \
        many._replace(grid=0, part_floats=0)
    assert many.grid == 64 * one.grid


def test_the_c12_bucket_fills_the_card_and_a_lone_lane_spreads():
    """16 twelve-class BrainWeb slices: a block for each 1024 rows, 624
    blocks, more than one for each of an H100's 132 SMs; the lone
    weighted lane of 1 100 000 rows takes the most blocks, 1024 of 1024
    rows; the 1000 KB image with unit weights 500 blocks of 2048 rows."""
    bucket = KC.batched_plan(16, 39277, 1, 12)
    assert (bucket.tier, bucket.rows_per_thread, bucket.blocks) == (12, 4, 39)
    assert bucket.grid == 624 >= H100_SMS
    lone = KC.batched_plan(1, 1100000, 1, 4)
    assert lone.blocks == KC.BATCHED_MAX_BLOCKS > H100_SMS
    unit = KC.batched_plan(1, 1_024_000, 1, 4, weighted=False)
    assert (unit.rows_per_thread, unit.blocks) == (8, 500)


@pytest.mark.parametrize("c,d,tier", [(1, 1, 4), (4, 1, 4), (5, 1, 8),
                                      (9, 1, 12), (12, 1, 12), (13, 1, 16),
                                      (17, 1, 32), (32, 1, 32), (12, 3, 16),
                                      (9, 2, 16), (32, 24, 32)])
def test_batched_tier(c, d, tier):
    assert KC.batched_tier(c, d) == tier
    with pytest.raises(ValueError):
        KC.batched_tier(33, 1)


# -- the 2-D FCM_S step's march ----------------------------------------------

def _march2d_pixels(h, w, plan):
    """The pixels of each block in the kernel's order: warp k of block blk
    takes task blk * warps + k, strip task % strips, rows (task // strips)
    * run .. + run, columns strip * 32 .. + 32, clipped to the grid."""
    seen = np.zeros((h, w), np.int32)
    for blk in range(plan.blocks):
        for k in range(plan.warps):
            task = blk * plan.warps + k
            wrun, strip = divmod(task, plan.strips)
            y0, x0 = wrun * plan.run, strip * plan.tile[0]
            if task >= plan.tasks:
                assert y0 >= h                  # an idle warp
                continue
            seen[y0:y0 + plan.run, x0:x0 + plan.tile[0]] += 1
    return seen


@pytest.mark.parametrize("h,w", [(1, 1), (1, 300), (300, 1), (2, 300),
                                 (2, 2), (37, 61), (217, 181), (512, 512),
                                 (4000, 256), (129, 33)])
def test_spatial2d_plan_covers_every_pixel_once(h, w):
    plan = KSP.spatial2d_plan(h, w)
    assert (_march2d_pixels(h, w, plan) == 1).all()
    assert plan.tasks == plan.strips * plan.runs
    assert plan.blocks == plan.rows == -(-plan.tasks // plan.warps) >= 1
    assert 1 <= plan.run <= KSP.MAX_WARP_ROWS


def test_spatial2d_plan_spreads_the_main_path_images():
    """The 1000 KB image marches 8 rows a warp in 250 blocks; a 217x181
    slice 1 row a warp in 82 blocks; the plan reads the shape alone."""
    big = KSP.spatial2d_plan(4000, 256)
    assert (big.run, big.strips, big.runs, big.blocks) == (8, 8, 500, 250)
    small = KSP.spatial2d_plan(217, 181)
    assert (small.run, small.blocks) == (1, 82)
    assert KSP.spatial2d_plan(217, 181) == small
    with pytest.raises(ValueError):
        KSP.spatial2d_plan(0, 5)


@pytest.mark.parametrize("b", [1, 3])
def test_spatial2d_scratch_holds_the_plan_rows(monkeypatch, b):
    """The 2-D wrapper passes the plan's rows a warp, sizes the partials
    to the plan's blocks a lane and takes one ticket a lane, the same for
    a lane alone and in a bucket."""
    calls, scratch = [], []
    real_buffers = KSP._buffers

    class Lib:
        def fcm_spatial_partials_2d(self, x, v, bb, h, w, c, nb, alpha, m,
                                    expo, warp_rows, part, ticket, out,
                                    stream):
            calls.append((bb, h, w, warp_rows))
            return 0

    def spy(x, c, n_rows):
        part, out = real_buffers(x, c, n_rows)
        scratch.append(tuple(part.shape))
        return part, out
    monkeypatch.setattr(KSP, "_checked", lambda *a: True)
    monkeypatch.setattr(KSP, "_buffers", spy)
    monkeypatch.setattr(_build, "library", lambda: Lib())
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "_counters", {})
    before = KSP.spatial_partials_2d.launches
    KSP.spatial_partials_2d(torch.zeros((b, 217, 181)), torch.zeros((b, 4)),
                            2.0, 1.0, 8)
    assert KSP.spatial_partials_2d.launches == before + 1
    KSP.spatial_partials_2d.launches = before
    plan = KSP.spatial2d_plan(217, 181)
    assert calls == [(b, 217, 181, plan.run)]
    assert scratch == [(b, plan.rows, 8)]
    assert _build._counters[(torch.device("cpu"), 0)].numel() >= b


# -- the labels kernel's plan ------------------------------------------------

def _label_pixels(start, b, n, itemsize):
    """The pixels the labels kernel labels, mirroring its index rules, for
    a (b, n) bucket whose first pixel lies ``start`` bytes past a 16-byte
    boundary: lane l's pixels [l n, l n + n) split into a head up to the
    first pixel on a 16-byte boundary (at most n pixels), whole 16-byte
    words of ``16 // itemsize`` pixels, and a tail; block (l, s), thread
    t, word q loads word s * THREADS * wpt + q * THREADS + t of the
    lane's words; segment 0's thread t < 16 labels the head's pixel t and
    thread 16 + t the tail's. Returns every labelled pixel (a flat index,
    once for each time it is labelled) and each word's byte address."""
    plan = KD.labels_plan(b, n, itemsize)
    per = 16 // itemsize
    t = np.arange(KD.THREADS)
    q = np.arange(plan.words_per_thread)[:, None]
    pixels, words = [], []
    for lane in range(b):
        g0 = lane * n
        lead = ((16 - (start + g0 * itemsize) % 16) % 16) // itemsize
        a0 = g0 + min(lead, n)
        n_words = (g0 + n - a0) // per
        t0 = a0 + n_words * per
        for seg in range(plan.segs):
            wi = (seg * KD.THREADS * plan.words_per_thread + q * KD.THREADS
                  + t).ravel()
            first = a0 + wi[wi < n_words] * per
            words.append(start + first * itemsize)
            pixels.append((first[:, None] + np.arange(per)).ravel())
            if seg == 0:
                head, tail = g0 + t[:16], t0 + t[:16]
                pixels += [head[head < a0], tail[tail < g0 + n]]
    return np.concatenate(pixels), np.concatenate(words)


@pytest.mark.parametrize("n", [1, 15, 16, 17, 255, 39277])
@pytest.mark.parametrize("itemsize,offset", [(1, o) for o in range(16)]
                         + [(4, o) for o in range(4)])
def test_labels_plan_covers_every_pixel_once(n, itemsize, offset):
    """Every pixel of every lane of a 3-lane bucket is labelled exactly
    once, through the head, the aligned words or the tail, at every
    offset of the buffer (uint8 lanes of odd length start at every
    alignment; 4-byte pixels at every 4-byte offset); every word load is
    16-byte aligned, and the blocks come from the shape alone."""
    b = 3
    pixels, words = _label_pixels(offset * itemsize, b, n, itemsize)
    assert np.array_equal(np.sort(pixels), np.arange(b * n))
    assert (words % 16 == 0).all()
    plan = KD.labels_plan(b, n, itemsize)
    assert plan.segs == -(-n // KD.BLOCK_PIXELS)
    assert plan.grid == b * plan.segs
    assert plan.words_per_thread * 16 // itemsize * KD.THREADS == \
        KD.BLOCK_PIXELS


def test_the_route_bucket_labels_in_one_wave():
    """64 BrainWeb slices of 217x181 (39 277 pixels) are 10 blocks a lane,
    640 blocks as uint8 and as int32, within one wave of the H100's 132
    SMs x 8 blocks of 256 threads; the 1000 KB image 250 blocks; 65 537
    lanes of 2 pixels one block a lane, on a 1-D grid."""
    for itemsize in (1, 4):
        assert KD.labels_plan(64, 39277, itemsize) == KD.LabelsPlan(
            10, itemsize, 640)
    assert 640 <= H100_SMS * 2048 // KD.THREADS
    assert KD.labels_plan(1, 1_024_000, 1).grid == 250
    assert KD.labels_plan(65537, 2, 4).grid == 65537
    with pytest.raises(ValueError):
        KD.labels_plan(1, 5, 2)
    with pytest.raises(ValueError):
        KD.labels_plan(0, 5, 1)


class _FakeLabelsLibrary:
    def __init__(self):
        self.calls = []

    def _record(self, kind, x, b, n, v, c, segs, out, stream):
        self.calls.append((kind, b, n, c, segs))
        return 0

    def labels_u8(self, *a):
        return self._record("u8", *a)

    def labels_i32(self, *a):
        return self._record("i32", *a)

    def labels_f32(self, *a):
        return self._record("f32", *a)


@pytest.mark.parametrize("dtype,kind", [(torch.uint8, "u8"),
                                        (torch.int32, "i32"),
                                        (torch.float32, "f32")])
@pytest.mark.parametrize("b,n,c", [(64, 39277, 4), (1, 1_024_000, 4),
                                   (65537, 2, 2), (3, 1, 12)])
def test_labels_wrapper_launches_once_with_the_plan(monkeypatch, dtype, kind,
                                                    b, n, c):
    """One library call a wrapper call at any number of lanes, with the
    plan's blocks a lane, into a (B, N) int32 output."""
    lib = _FakeLabelsLibrary()
    monkeypatch.setattr(KD, "_checked", lambda *a: True)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    before = KD.labels.launches
    out = KD.labels(torch.zeros((b, n), dtype=dtype), torch.zeros((b, c)))
    assert KD.labels.launches == before + 1
    KD.labels.launches = before
    segs = KD.labels_plan(b, n, torch.zeros((), dtype=dtype)
                          .element_size()).segs
    assert lib.calls == [(kind, b, n, c, segs)]
    assert out.dtype == torch.int32 and tuple(out.shape) == (b, n)


# -- the resident whole-solve's plan and reduction order ---------------------

@pytest.mark.parametrize("k", [1, 31, 256, 512, 513, 1000, 1024])
@pytest.mark.parametrize("c,d,m", [(4, 1, 2.0), (4, 1, 2.5), (3, 1, 2.0),
                                   (8, 1, 2.0), (4, 2, 2.0), (8, 8, 2.5),
                                   (1, 1, 2.0), (4, 3, 2.0)])
def test_resident_plan_takes_the_tier_for_the_papers_shape_alone(k, c, d,
                                                                 m):
    """The tier (c, D and m compiled in) for c == 4, D == 1, m == 2 and
    for nothing else; 8 warps a lane, so a thread holds at most 4 rows;
    from the shape alone."""
    plan = KR.resident_plan(k, c, d, m)
    assert plan.tier == (c == 4 and d == 1 and m == 2.0)
    assert plan.rows_per_thread == -(-k // KR.THREADS)
    assert plan.rows_per_thread <= KR.ROWS_PER_THREAD
    assert KR.THREADS * KR.ROWS_PER_THREAD == KR.MAX_ROWS


def test_the_histogram_bucket_takes_the_tier_one_row_a_thread():
    """The histogram route's lanes: 256 rows, c = 4, D = 1, m = 2; the
    float32 m of 2 exactly is the tier, a near miss is not."""
    assert KR.resident_plan(256, 4, 1, 2.0) == KR.ResidentPlan(True, 1)
    assert not KR.resident_plan(256, 4, 1, 2.001).tier


@pytest.mark.parametrize("k,c,d", [(0, 4, 1), (1025, 4, 1), (256, 9, 1),
                                   (256, 4, 9), (256, 0, 1)])
def test_resident_plan_refuses_what_the_kernel_cannot_hold(k, c, d):
    with pytest.raises(ValueError):
        KR.resident_plan(k, c, d, 2.0)


class _FakeResidentLibrary:
    def __init__(self):
        self.calls = []

    def fcm_resident_solve(self, x, w, v0, tol, b, k, d, c, m, expo,
                           max_iters, tier, v, delta, iters, stream):
        self.calls.append(dict(b=b, k=k, d=d, c=c, m=m, tier=tier))
        return 0


@pytest.mark.parametrize("b,k,d,c,m", [(64, 256, 1, 4, 2.0),
                                       (8, 256, 1, 4, 2.5),
                                       (5, 1024, 3, 8, 2.0),
                                       (3, 17, 1, 2, 2.0),
                                       (2, 600, 8, 8, 2.5)])
def test_resident_wrapper_launches_the_plan(monkeypatch, b, k, d, c, m):
    """One library call a wrapper call, in the plan's form; driven past
    its device check with a fake library."""
    lib = _FakeResidentLibrary()
    monkeypatch.setattr(KR, "_on_card", lambda t: True)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    before = KR.resident_solve.launches
    KR.resident_solve(torch.zeros((b, k, d)), torch.ones((b, k)),
                      torch.zeros((b, c, d)), torch.zeros((b,)), m, 300)
    assert KR.resident_solve.launches == before + 1
    KR.resident_solve.launches = before
    plan = KR.resident_plan(k, c, d, m)
    assert lib.calls == [dict(b=b, k=k, d=d, c=c, m=float(np.float32(m)),
                              tier=int(plan.tier))]


def _resident_model(x, w, v0, tol, max_iters, threads=KR.THREADS):
    """The resident kernel at m == 2 in float32 numpy, in its order: each
    lane alone; each thread adds its rows t, t + threads, ... in order
    into its c (D + 1) sums (Eq. 4 as fcm::membership_from_d2: the
    floored reciprocals summed in cluster order, one division a cluster,
    the even split over zero distances); a butterfly over each warp's 32
    lanes (lane l adds lane l ^ 16, 8, 4, 2, 1); the warps' sums in warp
    order; v' = num / max(den, 1e-12), delta = max|v' - v|. Returns (v,
    delta, iters) as the kernel does."""
    f32 = np.float32
    b, k, d = x.shape
    c = v0.shape[1]
    rpt = -(-k // threads)
    pad = rpt * threads
    valid = (np.arange(pad) < k).reshape(rpt, threads)
    flips = [np.arange(32) ^ off for off in (16, 8, 4, 2, 1)]
    vs, deltas, iters = [], [], []
    for lane in range(b):
        xl = np.zeros((pad, d), f32)
        xl[:k] = x[lane]
        wl = np.zeros(pad, f32)
        wl[:k] = w[lane]
        v = v0[lane].astype(f32)
        delta, it = f32(np.inf), 0
        while delta >= tol[lane] and it < max_iters:
            d2 = np.zeros((c, pad), f32)
            for dd in range(d):
                e = v[:, dd, None] - xl[None, :, dd]
                d2 = d2 + e * e
            zero = d2 <= 0
            p = f32(1) / np.maximum(d2, f32(1e-12))
            ps = np.zeros(pad, f32)
            for j in range(c):
                ps = ps + p[j]
            share = f32(1) / np.maximum(zero.sum(axis=0), 1).astype(f32)
            u = np.where(zero.any(axis=0)[None],
                         np.where(zero, share[None], f32(0)), p / ps)
            um = (u * u) * wl[None]
            terms = np.concatenate([um[..., None] * xl[None], um[..., None]],
                                   axis=2).reshape(c, rpt, threads, d + 1)
            acc = np.zeros((c, threads, d + 1), f32)
            for r in range(rpt):
                acc = np.where(valid[r][None, :, None], acc + terms[:, r],
                               acc)
            acc = acc.reshape(c, threads // 32, 32, d + 1)
            for flip in flips:
                acc = acc + acc[:, :, flip]
            tot = acc[:, 0, 0]
            for q in range(1, threads // 32):
                tot = tot + acc[:, q, 0]
            v_new = tot[:, :d] / np.maximum(tot[:, d:], f32(1e-12))
            delta = np.abs(v_new - v).max()
            v, it = v_new, it + 1
        vs.append(v)
        deltas.append(delta)
        iters.append(it)
    return np.stack(vs), np.array(deltas, f32), np.array(iters, np.int32)


def _resident_inputs(case):
    """Seeded inputs: BrainWeb-size phantom histograms with degenerate
    lanes, ragged clustered vector rows, or scalar lanes of 1000 rows (4
    rows a thread but the last)."""
    if case == "phantom":
        w = np.stack([np.bincount(jphantom.phantom_slice(
            217, 181, slice_pos=float(s), seed=i)[0].ravel(), minlength=256)
            for i, s in enumerate(np.linspace(0.3, 0.7, 6))])
        zero = np.zeros(256)
        zero[0] = 4000
        one = np.zeros(256)
        one[77] = 1000
        two = np.zeros(256)
        two[[10, 250]] = 5
        w = np.concatenate([w, zero[None], one[None], two[None]])
        x = np.broadcast_to(np.arange(256.0)[None, :, None], w.shape + (1,))
        return x.astype(np.float32), w.astype(np.float32), 4
    rng = np.random.default_rng(5)
    k, d, c = (300, 2, 3) if case == "vectors" else (1000, 1, 4)
    means = rng.uniform(0, 255, (c, d))
    x = means[rng.integers(0, c, (2, k))] + rng.normal(0, 5, (2, k, d))
    return (x.astype(np.float32),
            rng.integers(1, 30, (2, k)).astype(np.float32), c)


@pytest.mark.parametrize("case", ["phantom", "vectors", "rows1000"])
def test_the_resident_reduction_order_matches_pallas(case):
    """The kernel's fixed order against the JAX package's kernel in
    interpret mode on the same seeded inputs: centers within rtol 1e-5 /
    atol 1e-4 (values run 0-255, the background center sits near 0) and
    equal iteration counts."""
    x, w, c = _resident_inputs(case)
    lo, hi = TS.weighted_support(torch.from_numpy(x), torch.from_numpy(w))
    v0 = TS.linspace_from_support(lo, hi, c).numpy()
    tol = TS._tol_from_range((hi - lo).max(dim=1).values, 5e-3).numpy()
    x4, w3 = jops.tile_rows_batched(jnp.asarray(x), jnp.asarray(w))
    jv, _, ji = JKR.resident_solve_pallas(x4, w3, jnp.asarray(v0),
                                          jnp.asarray(tol), 2.0, 300,
                                          interpret=True)
    mv, md, mi = _resident_model(x, w, v0, tol, 300)
    np.testing.assert_array_equal(mi, np.asarray(ji))
    np.testing.assert_allclose(mv, np.asarray(jv), rtol=1e-5, atol=1e-4)
    assert (md < tol).all()
