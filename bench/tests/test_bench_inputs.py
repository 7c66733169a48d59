"""The inputs come from --seed alone, and every seed does the same work."""
import numpy as np
import pytest
import torch

from harness import phantom, traffic

SEEDS = (0, 7, 2**31 + 11, 2**40 + 3)


@pytest.mark.parametrize("name", ["hist-volume", "fcms-slices"])
@pytest.mark.parametrize("seed", SEEDS)
def test_pool_is_a_function_of_the_seed(tiny_cell, name, seed):
    cell = tiny_cell(name)
    a = traffic.make_pool(cell.config, cell.traffic, seed)
    b = traffic.make_pool(cell.config, cell.traffic, seed)
    assert len(a.volumes) == 2 * 2
    for va, vb in zip(a.volumes, b.volumes):
        assert va.dtype == np.uint8 and va.shape == (6, 40, 36)
        np.testing.assert_array_equal(va, vb)
    for i in range(8):
        np.testing.assert_array_equal(a.request(i), b.request(i))
    c = traffic.make_pool(cell.config, cell.traffic, seed + 1)
    assert any((va != vc).any() for va, vc in zip(a.volumes, c.volumes))


def test_every_seed_sends_the_same_sizes_and_anatomies(tiny_cell):
    cell = tiny_cell("hist-volume")
    per_seed = []
    for seed in SEEDS:
        pool = traffic.make_pool(cell.config, cell.traffic, seed)
        n = len(pool.cycle)
        assert n == 2 * 3           # anatomies x depths
        reqs = [pool.request(i) for i in range(n)]
        per_seed.append(sorted((int(r[0, 0]) // 2, len(r)) for r in reqs))
        # a cycle later the same pairs come again, on other slices
        again = [pool.request(n + i) for i in range(n)]
        assert [len(r) for r in again] == [len(r) for r in reqs]
    assert all(p == per_seed[0] for p in per_seed)
    assert sorted({d for _, d in per_seed[0]}) == [3, 5, 6]


def test_a_request_is_a_run_of_slices_of_one_anatomy(tiny_cell):
    cell = tiny_cell("fcms-slices")
    pool = traffic.make_pool(cell.config, cell.traffic, 2**31 + 1)
    for i in range(40):
        lanes = pool.request(i)
        vol, z = lanes[:, 0], lanes[:, 1]
        # one anatomy (bank volumes a*R .. a*R + R - 1), consecutive slices
        assert len(set((vol // pool.realisations).tolist())) == 1
        assert (np.diff(z) == 1).all() and z[0] >= 0 and z[-1] < 6
        payload = pool.payload(lanes)
        assert len(payload) == len(lanes)
        assert payload[0].shape == (40, 36) and payload[0].dtype == np.uint8
        assert payload[1] is not None and np.shares_memory(
            payload[1], pool.volumes[vol[1]])
    warm = [len(pool.warmup_request(j)) for j in range(3)]
    assert warm == [6, 5, 3]


def test_no_study_of_a_window_repeats(tiny_cell):
    """The cells' own mix at full depth (small slices): a window's
    studies differ in their offsets or their slices' realisations."""
    from harness import spec
    cell = spec.load_cell("hist-volume")
    cell.config["volume"].update(height=24, width=20)
    pool = traffic.make_pool(cell.config, cell.traffic, 2**31 + 9)
    seen = {pool.request(i).tobytes() for i in range(6000)}
    assert len(seen) == 6000
    assert {len(pool.request(i)) for i in range(len(pool.cycle))} == set(
        cell.traffic["depths"])


def test_anatomy_is_the_same_for_every_seed():
    pos = phantom.slice_positions(5, 0.3, 0.7)
    np.testing.assert_allclose(pos, [0.3, 0.38, 0.46, 0.54, 0.62])
    lab = phantom.labels_volume(217, 181, pos)
    assert set(np.unique(lab.numpy())) == {0, 1, 2, 3}
    # the anatomy grows along the axis, and with the head's scale
    assert (lab[-1] > 0).sum() > (lab[0] > 0).sum()
    small = phantom.labels_volume(217, 181, pos, scale=0.88)
    assert (small > 0).sum() < (lab > 0).sum()


def test_impulses_hit_the_stated_share_of_each_slice():
    lab = phantom.labels_volume(40, 36, phantom.slice_positions(4, .3, .7))
    clean = phantom.noisy_volume(lab, [0, 52, 106, 168], 0.0, 0.0,
                                 traffic.torch_gen(1, torch.device("cpu")))
    noisy = phantom.noisy_volume(lab, [0, 52, 106, 168], 0.0, 0.05,
                                 traffic.torch_gen(1, torch.device("cpu")))
    clean, noisy = clean.numpy(), noisy.numpy()
    k = round(0.05 * 40 * 36)
    for z in range(4):
        changed = (clean[z] != noisy[z]).sum()
        assert changed <= k
        assert set(np.unique(noisy[z][clean[z] != noisy[z]])) <= {0, 255}
        assert ((noisy[z] == 255).sum() + (noisy[z] == 0).sum()
                >= (clean[z] == 0).sum() - k)


def test_noise_has_the_stated_spread():
    lab = phantom.labels_volume(217, 181, phantom.slice_positions(8, .3, .7))
    vol = phantom.noisy_volume(lab, [0, 52, 106, 168], 12.0, 0.0,
                               traffic.torch_gen(5, torch.device("cpu")))
    vol, lab = vol.numpy().astype(np.float64), lab.numpy()
    wm = vol[lab == 3]
    # truncation to uint8 takes half a level off the mean
    assert abs(wm.mean() - 167.5) < 0.2 and abs(wm.std() - 12) < 0.3


def test_reservoir_sample_is_uniform_and_seeded():
    picks = []
    for s in range(2):
        r = traffic.Reservoir(3, traffic.rng_for(5, 1))
        for i in range(100):
            r.offer(i)
        picks.append(sorted(r.items))
    assert picks[0] == picks[1] and len(picks[0]) == 3
    r = traffic.Reservoir(3, traffic.rng_for(5, 1))
    for i in range(2):
        r.offer(i)
    assert r.items == [0, 1]


def test_traffic_rejects_what_the_generator_does_not_drive(tiny_cell):
    cell = tiny_cell("hist-volume")
    for bad in ({"loop": "open"}, {"clients": 2}, {"payload": "volume"},
                {"head_scales": []}, {"realisations": 0}, {"depths": [7]},
                {"depths": [0]}):
        with pytest.raises(ValueError):
            traffic.make_pool(cell.config, dict(cell.traffic, **bad), 0)
