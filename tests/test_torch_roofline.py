"""The port's analysis layer against the JAX package's on the CPU:
``analysis/hw.py`` (H100 constants), ``analysis/roofline.py``
(``kernel_step_costs`` at its defaults bit for bit, ``kernel_cell`` on
the port's peaks, ``count_params`` / ``model_flops`` for all ten archs)
and ``analysis/op_cost.py`` (the JAX package's hand-counted programs of
``tests/test_roofline.py``: dot flops, a loop of 17, the ring math, a
fused chain's bytes), plus the counter's reports: kernel IO on fake card
tensors, collectives, live memory."""
import itertools

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as JC
from repro.analysis import roofline as JR
from repro_torch import configs as TC
from repro_torch.analysis import hw, op_cost, roofline as TR
from repro_torch.kernels import defuzzify as KD
from repro_torch.kernels import fcm_centers as KC


# -- hw ----------------------------------------------------------------------

def test_h100_constants():
    assert hw.PEAK_FLOPS_BF16 == 989.4e12
    assert hw.PEAK_FLOPS_F32 == 67e12
    assert hw.HBM_BW == 3.35e12
    assert hw.HBM_BYTES == 80e9
    assert hw.NVLINK_BW == 450e9
    assert hw.NET_BW == 50e9
    assert hw.GPUS_PER_NODE == 8


@pytest.mark.parametrize("dtype,want", [
    (torch.bfloat16, 2), (torch.float32, 4), (torch.int8, 1),
    (torch.uint8, 1), (torch.int32, 4), (torch.float64, 8),
    (torch.bool, 1), ("bf16", 2), ("s32", 4), ("u8", 1), ("c128", 16),
    ("token", 4)])
def test_dtype_bytes_torch_and_hlo_names(dtype, want):
    assert hw.dtype_bytes(dtype) == want


# -- kernel_step_costs / kernel_cell ----------------------------------------

_GRID = {
    "flat": [dict(n_rows=n, c=c, n_feat=d, n_iters=it)
             for n, c, d, it in itertools.product(
                 (1, 256, 39277, 1 << 20), (2, 4, 12), (1, 3, 16), (1, 7))],
    "stencil": [dict(h=h, w=w, c=c, neighbors=k, n_iters=it)
                for h, w, c, k, it in itertools.product(
                    (1, 217, 4000), (181, 256), (4, 8), (4, 6, 8), (1, 19))],
    "bin": [dict(b=b, n_rows=n, n_bins=nb)
            for b, n, nb in itertools.product((1, 64), (1, 39277), (16, 256))],
    "labels": [dict(n_rows=n, c=c, n_feat=d)
               for n, c, d in itertools.product((1, 2513728), (2, 4, 32),
                                                (1, 3))],
    "slic_assign": [dict(h=h, w=w, d=d, n_centers=k)
                    for h, w, d, k in itertools.product(
                        (7, 512), (5, 512), (1, 3), (4, 256))],
}


@pytest.mark.parametrize("kind", sorted(_GRID))
def test_kernel_step_costs_defaults_equal_jax(kind):
    for shape in _GRID[kind]:
        assert TR.kernel_step_costs(kind, **shape) == \
            JR.kernel_step_costs(kind, **shape), (kind, shape)


def test_kernel_step_costs_widths():
    # the port's uint8 bucket: 1 byte in, 4 bytes of int32 label out
    got = TR.kernel_step_costs("labels", n_rows=64 * 39277, c=4,
                               in_bytes=1, out_bytes=4)
    assert got["bytes"] == 64 * 39277 * 5 + 4 * 4
    got = TR.kernel_step_costs("bin", b=64, n_rows=39277, in_bytes=1)
    assert got["bytes"] == 64 * (39277 + 4 * 256)
    # a whole-solve keeps the memberships on chip
    got = TR.kernel_step_costs("flat", n_rows=256, c=4, u_bytes=0,
                               n_iters=3)
    assert got["bytes"] == (256 * 8 + 4 * 8) * 3
    assert got["flops"] == JR.kernel_step_costs(
        "flat", n_rows=256, c=4, n_iters=3)["flops"]
    with pytest.raises(ValueError):
        TR.kernel_step_costs("membership")


def test_kernel_cell_arithmetic_on_h100_peaks():
    cell = TR.kernel_cell("labels", "cuda", "gpu", {"n": 4}, 6.7e7, 3.35e7,
                          2e-5)
    assert cell.t_roofline == pytest.approx(1e-5)          # bytes: 10 us
    assert cell.bound == "memory"
    assert cell.frac_of_roofline == pytest.approx(0.5)
    assert cell.achieved_bytes_per_s == pytest.approx(3.35e7 / 2e-5)
    compute = TR.kernel_cell("stencil", "cuda", "gpu", {}, 6.7e9, 1.0, 1e-3)
    assert compute.bound == "compute"
    assert compute.t_roofline == pytest.approx(6.7e9 / hw.PEAK_FLOPS_F32)
    assert TR.kernel_cell("flat", "cuda", "gpu", {}, 1.0, 1.0,
                          0.0).frac_of_roofline == 0.0
    assert set(cell.row()) == set(JR.KernelCell.__dataclass_fields__)


# -- count_params / model_flops ----------------------------------------------

@pytest.mark.parametrize("arch", JC.list_archs())
def test_count_params_and_model_flops_equal_jax(arch):
    jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    assert TR.count_params(tcfg) == JR.count_params(jcfg)
    for name in JC.SHAPES:
        assert TR.model_flops(tcfg, TC.SHAPES[name]) == \
            JR.model_flops(jcfg, JC.SHAPES[name])


def test_model_flops_moe_active_params():
    cfg = TC.get_config("granite-moe-3b-a800m")
    n = TR.count_params(cfg)
    assert n["active"] < 0.55 * n["total"]      # 8/40 experts active
    mf = TR.model_flops(cfg, TC.SHAPES["train_4k"])
    assert mf == pytest.approx(6 * n["active"] * 4096 * 256)


# -- op_cost: the JAX package's hand-counted programs -----------------------

def test_dot_flops_exact():
    a, b = torch.zeros((128, 256)), torch.zeros((256, 512))
    _, c = op_cost.count(lambda: a @ b)
    assert c.costs.flops == c.costs.dot_flops == 2 * 128 * 256 * 512
    x = torch.zeros((3, 16, 8))
    _, c = op_cost.count(lambda: torch.einsum("bik,bkj->bij", x,
                                              x.transpose(1, 2)))
    assert c.costs.flops == 2 * 3 * 16 * 16 * 8


def _tanh_chain(x, n):
    for _ in range(n):
        x = torch.tanh(x @ x)
    return x


def test_loop_of_17_gives_17_times_the_flops():
    a = torch.zeros((64, 64))
    _, c1 = op_cost.count(_tanh_chain, a, 1)
    _, c17 = op_cost.count(_tanh_chain, a, 17)
    assert c1.costs.flops == 2 * 64 ** 3
    assert c17.costs.flops == 17 * c1.costs.flops
    assert c17.costs.bytes == 17 * c1.costs.bytes


def _repeated(w, x, n):
    loop = op_cost.repeat(n)

    def body(trips, w, x):
        for _ in range(trips):
            x = torch.tanh(x @ w)
        return (x,)

    y, = loop.run(body, w, x)
    return y


@pytest.mark.parametrize("fake", [False, True])
def test_scaled_loop_counts_like_the_whole_loop(fake):
    """One trip weighted 17 times counts what 17 trips count, forward
    and backward (the carry needs a gradient, as a recurrence's state
    does); without ``scale_loops`` every trip runs."""
    ctx = FakeTensorMode() if fake else torch.no_grad()
    with ctx:
        w = torch.zeros((32, 32)) + 0.01
        x = torch.ones((8, 32))
    w.requires_grad_(True)
    x.requires_grad_(True)

    def grad(scale):
        with op_cost.CostCounter(scale_loops=scale) as c:
            y = _repeated(w, x, 17)
            g, _ = torch.autograd.grad(y.sum(), [w, x])
        return c.costs, g

    full, g_full = grad(False)
    one, _ = grad(True)
    assert one.flops == pytest.approx(full.flops)
    assert one.dot_flops == pytest.approx(full.dot_flops)
    if not fake:
        ref = w.detach().clone().requires_grad_(True)
        y = x.detach()
        for _ in range(17):
            y = torch.tanh(y @ ref)
        assert torch.equal(g_full, torch.autograd.grad(y.sum(), [ref])[0])


def test_ring_math_matches_the_jax_multipliers():
    for kind in op_cost.COLLECTIVES:
        for n in (1, 2, 8, 16, 512):
            assert TR.collective_wire(kind, 100.0, n) == \
                100.0 * JR._WIRE_MULT[kind](n)
    assert TR.collective_wire("all-reduce", 100, 8) == \
        pytest.approx(2 * 7 / 8 * 100)
    assert TR.collective_wire("all-gather", 100, 8) == pytest.approx(87.5)
    assert TR.collective_wire("collective-permute", 100, 8) == 100


def test_collective_reports_global_wire():
    op_cost.collective("all-reduce", 1024, 4)          # no counter: no-op
    with op_cost.CostCounter() as c:
        op_cost.collective("all-reduce", 1024, 4)
        op_cost.collective("all-gather", 100, 8)
    assert c.costs.wire_by_kind["all-reduce"] == 4 * 1536
    assert c.costs.wire_by_kind["all-gather"] == pytest.approx(8 * 87.5)
    assert c.costs.n_coll_ops == 2


def test_bytes_of_a_fused_chain_in_the_walkers_window():
    x = torch.zeros((1024,))
    _, c = op_cost.count(lambda: torch.tanh(x) * 2 + 1)
    # three eager kernels of 8 KB each: inside the JAX test's window
    assert 4096 <= c.costs.bytes <= 32768, c.costs.bytes
    assert c.costs.flops == 0


def test_views_move_nothing_and_reductions_count_elements():
    x = torch.zeros((64, 32))
    _, c = op_cost.count(lambda: x.t().t().reshape(-1)[:10].unsqueeze(0))
    assert c.costs.bytes == 0
    _, c = op_cost.count(lambda: x.sum(dim=1))
    assert c.costs.flops == 64 * 32
    assert c.costs.bytes == (64 * 32 + 64) * 4


def test_live_memory_and_peak():
    x = torch.zeros((1024,))

    def step():
        a = x * 2                   # 4 KB, freed below
        b = a + 1                   # 4 KB, returned
        del a
        return b

    out, c = op_cost.count(step)
    assert c.peak == 8192
    assert c.live == 4096
    del out
    assert c.live == 0


def test_kernel_wrappers_on_fake_card_tensors_never_launch():
    """The fused partials and the labels on fake ``cuda`` tensors: the
    counter sees each kernel's inputs and outputs once, nothing launches
    and nothing is built."""
    l0, f0 = KD.labels.launches, KC.fused_partials.launches
    with FakeTensorMode():
        x = torch.empty((1, 1000), device="cuda")
        v = torch.empty((1, 4), device="cuda")
        x1, v1 = torch.empty((1000,), device="cuda"), torch.empty(
            (4,), device="cuda")
        with op_cost.CostCounter() as c:
            lab = KD.labels(x, v)
            num, den = KC.fused_partials(x1, x1, v1, 2.0)
        assert tuple(lab.shape) == (1, 1000) and lab.dtype == torch.int32
        assert tuple(num.shape) == tuple(den.shape) == (4,)
    assert c.costs.n_kernels == 2
    assert c.costs.kernel_bytes == (4000 + 16 + 4000) + (8000 + 16 + 32)
    assert (KD.labels.launches, KC.fused_partials.launches) == (l0, f0)


def test_kernel_io_counts_real_cpu_calls_of_nothing():
    """On the CPU the wrappers take their plain versions: no kernel is
    reported, the plain ops are counted."""
    x = torch.rand(1000) * 255
    v = torch.tensor([10.0, 80.0, 150.0, 230.0])
    _, c = op_cost.count(KC.fused_partials, x, torch.ones(1000), v, 2.0)
    assert c.costs.n_kernels == 0 and c.costs.bytes > 0


def test_split_bytes():
    sizes = {"pod": 2, "data": 16, "model": 16}
    assert op_cost.split_bytes((256, 4096), torch.bfloat16,
                               (("pod", "data"), "model"), sizes) == \
        256 * 4096 * 2 / 512
    assert op_cost.split_bytes((3,), torch.float32, (None,), sizes) == 12
    assert op_cost.split_bytes((), torch.int32, (), sizes) == 4
    assert np.isclose(op_cost.split_bytes((10, 10), "f32", None, {}), 400)
