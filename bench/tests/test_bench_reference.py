"""The plain reference gives known answers on tiny inputs."""
import numpy as np
import pytest
import torch

from harness import reference as R


def test_membership_splits_a_zero_distance_and_sums_to_one():
    d2 = torch.tensor([[[0.0, 4.0]], [[0.0, 1.0]], [[9.0, 4.0]]])  # (c, 1, 2)
    u = R.membership(d2.reshape(3, 2), 2.0, dim=0)
    torch.testing.assert_close(u[:, 0], torch.tensor([0.5, 0.5, 0.0]))
    torch.testing.assert_close(u.sum(0), torch.ones(2))
    # column 1: 1/4, 1, 1/4 normalised
    torch.testing.assert_close(u[:, 1], torch.tensor([1 / 6, 2 / 3, 1 / 6]))


def test_two_spikes_converge_to_their_values():
    h = torch.zeros(1, 256)
    h[0, 10] = 500
    h[0, 200] = 300
    v, it = R.hist_fcm(h, 2, 2.0, 5e-3, 300)[:2]
    assert abs(v[0, 0].item() - 10) < 0.05
    assert abs(v[0, 1].item() - 200) < 0.05
    assert 1 < it.item() < 300


def test_init_and_tolerance_follow_the_support():
    v0, tol = R.init_centers(torch.tensor([10.0, 5.0]),
                             torch.tensor([90.0, 5.0]), 4, 5e-3)
    torch.testing.assert_close(v0[0], torch.tensor([20.0, 40.0, 60.0, 80.0]))
    torch.testing.assert_close(tol, torch.tensor([0.04, 5e-4]))


def test_histogram_fcm_is_pixel_fcm_on_the_same_pixels():
    g = torch.Generator().manual_seed(0)
    px = torch.randint(0, 256, (3, 500), generator=g, dtype=torch.uint8)
    vh, ih = R.hist_fcm(R.histograms(px), 4, 2.0, 5e-3, 300)[:2]
    vp, ip = R.pixel_fcm(px.float(), 4, 2.0, 5e-3, 300)[:2]
    torch.testing.assert_close(vh, vp, rtol=0, atol=2e-3)
    assert (ih - ip).abs().max() <= 1


def test_histograms_count_every_lane_apart():
    px = torch.tensor([[0, 0, 255], [7, 7, 7]], dtype=torch.uint8)
    h = R.histograms(px)
    assert h.shape == (2, 256)
    assert h[0, 0] == 2 and h[0, 255] == 1 and h[1, 7] == 3
    assert h.sum() == 6


def test_nearest_labels_table_equals_direct_argmin_and_ties_go_low():
    v = torch.tensor([[10.0, 20.0, 100.0, 180.0]])
    x = torch.arange(256, dtype=torch.uint8)[None]
    lut = R.nearest_labels(x, v)
    direct = R.nearest_labels(x.float(), v)
    assert torch.equal(lut, direct)
    assert lut[0, 15].item() == 0          # equidistant from 10 and 20
    assert lut[0, 60].item() == 1          # equidistant from 20 and 100
    assert lut[0, 61].item() == 2 and lut[0, 255].item() == 3


@pytest.mark.parametrize("ndim,nb", [(2, 8), (2, 4), (3, 6)])
def test_fcms_without_its_neighbour_term_is_pixel_fcm(ndim, nb):
    g = torch.Generator().manual_seed(1)
    shape = (2, 12, 10) if ndim == 2 else (1, 5, 6, 7)
    x = torch.randint(0, 256, shape, generator=g).float()
    vs, its = R.stencil_fcm(x, 3, 2.0, 0.0, nb, 5e-3, 300)[:2]
    vp, itp = R.pixel_fcm(x.reshape(x.shape[0], -1), 3, 2.0, 5e-3, 300)[:2]
    torch.testing.assert_close(vs, vp, rtol=0, atol=1e-3)
    assert torch.equal(its, itp)


def test_fcms_neighbour_fields_at_a_corner_and_inside():
    x = torch.arange(12.0).reshape(1, 3, 4)
    st = R.Stencil(x, 8)
    assert st.cnt[0, 0, 0].item() == 3 and st.cnt[0, 1, 1].item() == 8
    # corner (0, 0): neighbours 1, 4, 5
    assert st.xbar[0, 0, 0].item() == pytest.approx(10 / 3)
    st6 = R.Stencil(torch.zeros(1, 3, 3, 3), 6)
    assert st6.cnt[0, 1, 1, 1].item() == 6 and st6.cnt[0, 0, 0, 0].item() == 3


def test_fcms_cleans_impulses_that_plain_labels_keep():
    # two flat regions, one impulse in each: FCM_S labels by region
    x = torch.full((1, 9, 12), 40.0)
    x[0, :, 6:] = 160.0
    x[0, 4, 2] = 120.0       # nearer 160 than 40
    x[0, 4, 9] = 90.0        # nearer 40 than 160
    v = R.stencil_fcm(x, 2, 2.0, 1.0, 8, 5e-3, 300).centers
    lab = R.stencil_labels(x, v, 2.0, 1.0, 8)
    region = (torch.arange(12) >= 6).long().expand(9, 12)
    rank = torch.argsort(torch.argsort(v[0]))
    assert torch.equal(rank[lab[0]], region)
    plain = R.nearest_labels(x.reshape(1, -1), v).reshape(9, 12)
    assert rank[plain[4, 2]] == 1 and rank[plain[4, 9]] == 0


def test_volume_regions_are_recovered_in_3d():
    x = torch.zeros(1, 4, 5, 6)
    x[0, 2:] = 120.0
    v = R.stencil_fcm(x, 2, 2.0, 1.0, 6, 5e-3, 300).centers
    lab = R.labels("spatial", x, v, {"m": 2.0}, {"alpha": 1.0,
                                                  "neighbors_2d": 8,
                                                  "neighbors_3d": 6})
    assert lab.shape == x.shape
    assert torch.equal(lab[0, :2], lab[0, :1].expand(2, 5, 6))
    assert (lab[0, :2] != lab[0, 2:]).all()


def test_bfloat16_reference_runs_and_departs_from_float32():
    g = torch.Generator().manual_seed(2)
    px = torch.randint(0, 256, (2, 2000), generator=g, dtype=torch.uint8)
    v32 = R.hist_fcm(R.histograms(px), 4, 2.0, 5e-3, 300).centers
    v16 = R.hist_fcm(R.histograms(px), 4, 2.0, 5e-3, 300,
                     dtype=torch.bfloat16).centers
    assert v16.dtype == torch.bfloat16
    assert (v16.float() - v32).abs().max() > 1e-2
    assert np.isfinite(v16.float().numpy()).all()


def test_iterate_stops_each_lane_and_goes_on_where_asked():
    # v -> v / 2 moves 1/2, 1/4, ... from 1: lane 0 (tol 0.2) stops after
    # the move of 1/8 (step 3), lane 1 (tol 0.6) after that of 1/2
    step = lambda v: v / 2
    v0 = torch.ones(2, 1)
    fit = R.iterate(step, v0, torch.tensor([0.2, 0.6]), 300)
    assert fit.iters.tolist() == [3, 1]
    torch.testing.assert_close(fit.centers[:, 0], torch.tensor([1 / 8, 1 / 2]))
    assert fit.traj.shape == (4, 2, 1)
    longer = R.iterate(step, v0, torch.tensor([0.2, 0.6]), 300, until=6)
    assert longer.traj.shape == (7, 2, 1)
    assert longer.iters.tolist() == [3, 1]
    assert longer.traj[6, 1, 0].item() == 1 / 64
    capped = R.iterate(step, v0, torch.tensor([0.0, 0.0]), 5)
    assert capped.iters.tolist() == [5, 5]


def test_a_stop_one_step_off_is_excused_only_at_a_near_tie():
    from harness.check import stop_gaps
    tol = np.array([0.1, 0.1, 0.1, 0.1])
    # the reference's moves a step (T, lanes): lane 0 stops at 3 by a
    # hair (0.0999), lane 1 at 3 clearly, lanes 2, 3 at 2
    moves = np.array([[1.0, 1.0, 1.0, 1.0],
                      [0.3, 0.3, 0.09, 0.1005],
                      [0.0999, 0.02, 0.01, 0.01],
                      [0.01, 0.01, 0.0, 0.0]])
    rit = np.array([3, 3, 2, 3])
    prog = np.array([4, 4, 3, 2])
    # lane 0: one step past a stop at 0.0999 (a tie); lane 1: one step
    # past a clear stop; lane 2: one past a clear stop; lane 3: stopped
    # one step early at a move of 0.1005 (a tie)
    assert stop_gaps(prog, rit, moves, tol).tolist() == [0, 1, 1, 0]
    assert stop_gaps(np.array([5, 3, 2, 3]), rit, moves, tol).tolist() == [
        2, 0, 0, 0]
