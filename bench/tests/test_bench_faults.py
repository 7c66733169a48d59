"""The check catches a broken timed path: each fault a cell can have is
planted underneath a whole run (the look for a card skipped, tiny
sizes, the CPU), and ``correct`` comes out false. One card, so no
exchange between chips can be left out."""
import dataclasses
import time

import pytest
import torch

from harness import drive

CELLS = ["hist-volume", "fcms-slices"]


def state_unchanged(monkeypatch):
    """Every solver step returns the centers it was given."""
    import repro_torch.core.solver as SV
    inner = SV.masked_while_centers

    def frozen(step, v0, tol, max_iters, active=None):
        return inner(lambda v: v, v0, tol, max_iters, active)
    monkeypatch.setattr(SV, "masked_while_centers", frozen)
    return None


def early_stop(monkeypatch):
    """Every lane stops under a hundred times its tolerance: a looser
    stop that moves every lane's count at the tiny size, so a window of
    one request shows it too."""
    import repro_torch.core.solver as SV
    inner = SV.masked_while_centers

    def loose(step, v0, tol, max_iters, active=None):
        return inner(step, v0, 100 * torch.as_tensor(tol), max_iters, active)
    monkeypatch.setattr(SV, "masked_while_centers", loose)
    return None


def _wrap_programs(eng, wrap):
    inner = eng._program_for

    def program_for(route, chunk, bucket):
        prog = inner(route, chunk, bucket)
        return None if prog is None else wrap(prog)
    eng._program_for = program_for


def half_left_out(monkeypatch):
    """Half of each bucket never reaches the device: its lanes (of a
    one-lane bucket, its rows) are replaced by the other half's, and the
    answers come back from those."""
    def wrap(prog):
        def gather(eng_, chunk, bucket):
            (x,) = prog.gather(eng_, chunk, bucket)
            x = x.clone()
            axis = 0 if x.shape[0] >= 2 else 1
            half = x.shape[axis] // 2
            x.narrow(axis, half, half).copy_(x.narrow(axis, 0, half))
            return (x,)
        return dataclasses.replace(prog, gather=gather)
    return lambda eng: _wrap_programs(eng, wrap)


def answer_altered(monkeypatch):
    """One voxel's label of every lane changed where the launch makes
    it."""
    def wrap(prog):
        def launch(*inputs):
            v, delta, iters, total, labels = prog.launch(*inputs)
            labels = labels.clone()
            flat = labels.view(labels.shape[0], -1)
            flat[:, 0] = (flat[:, 0] + 1) % v.shape[1]
            return v, delta, iters, total, labels
        return dataclasses.replace(prog, launch=launch)
    return lambda eng: _wrap_programs(eng, wrap)


@pytest.mark.parametrize("fault", [state_unchanged, early_stop,
                                   half_left_out, answer_altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_makes_the_run_incorrect(tiny_cell, monkeypatch,
                                                 name, fault):
    cell = tiny_cell(name)
    hook = fault(monkeypatch)
    out, values = drive.run(cell, 2**31 + 99, 0.2, False,
                            torch.device("cpu"), time.perf_counter(),
                            engine_hook=hook)
    line = drive.finish(out, values, cell.limits)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())
