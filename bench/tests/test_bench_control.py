"""The control, the reference in bfloat16 put in the program's place,
and the reference stopped early in its place come out not correct under
every cell's limits (here at a tiny size on the CPU;
``bench/calibrate.py`` reads them at the cells' own size on the card)."""
import pytest
import torch

from harness import check, control, traffic


def _correct(cell, pool, **kw):
    dev = torch.device("cpu")
    ans = control.answers(cell.config["route"], pool, cell.config, dev, **kw)
    values = check.readings(ans, pool, cell.config, dev)
    return check.verdict(values, cell.limits)[0], values


@pytest.mark.parametrize("name", ["hist-volume", "fcms-slices"])
@pytest.mark.parametrize("seed", [1, 2**31 + 17, 40])
def test_bfloat16_control_is_not_correct(tiny_cell, name, seed):
    cell = tiny_cell(name)
    pool = traffic.make_pool(cell.config, cell.traffic, seed)
    assert not _correct(cell, pool)[0]
    # the float32 reference in the same place is correct
    assert _correct(cell, pool, dtype=torch.float32)[0]


@pytest.mark.parametrize("name", ["hist-volume", "fcms-slices"])
@pytest.mark.parametrize("early", [1, 2])
def test_a_stop_before_the_reference_is_not_correct(tiny_cell, name, early):
    cell = tiny_cell(name)
    pool = traffic.make_pool(cell.config, cell.traffic, 2**31 + 3)
    correct, values = _correct(cell, pool, dtype=torch.float64, early=early)
    assert not correct
    assert values["iters_share"] > 0.5
    # the check's own float64 solve, its count reported honestly: the
    # iterate at it is the reference's own (but for the float32 rounding
    # of the answers it returns), and the stop is what moves
    assert values["center_gap"] < 1e-4
    assert values["stop_gap"] > 0.0
