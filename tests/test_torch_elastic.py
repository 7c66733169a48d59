"""The port's elastic training pieces (``training/elastic.py``) against
the JAX package's, on the CPU.

- ``plan_mesh``: the mesh shapes equal the JAX package's for 1-8
  devices, tp named or not, 1 or 2 pods (the JAX side in a subprocess
  under 8 fake devices, ``tests/_torch_train_mesh_runner.py plans``);
  the port's mesh names one device several times where asked.
- ``StepTimer``: flags, consecutive counts, hook calls and medians equal
  the JAX package's under one patched ``time.perf_counter``.
- ``reshard_state`` between meshes of ``cpu`` entries: the state moves
  whole to the new mesh's lead device unchanged, and a resumed 4-shard
  state takes two more steps on 2 shards equal to the 4-shard run's.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.training import elastic as JE
from repro_torch import configs as TC
from repro_torch.core import distributed as TD
from repro_torch.data import pipeline as TP
from repro_torch.models import sharding as sh
from repro_torch.training import elastic as TE
from repro_torch.training import optimizer as TO
from repro_torch.training import train_loop as TT

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def jax_plans(tmp_path_factory):
    out = tmp_path_factory.mktemp("plans") / "plans.pkl"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "_torch_train_mesh_runner.py"),
         str(out), "plans"], capture_output=True, text=True, env=env,
        timeout=300)
    assert "TRAIN_MESH_OK" in proc.stdout, proc.stdout + proc.stderr
    with open(out, "rb") as f:
        return pickle.load(f)["plan_mesh"]


def test_plan_mesh_shapes_equal_jax(jax_plans):
    assert len(jax_plans) > 30
    for (n, tp, pods), shape in jax_plans.items():
        mesh = TE.plan_mesh(n, tp, pods, devices=["cpu"] * n)
        assert mesh.shape == shape, (n, tp, pods)
        assert mesh.axis_names == (("pod", "data", "model") if pods > 1
                                   else ("data", "model"))
        assert mesh.size == int(np.prod(shape))


def test_plan_mesh_prefers_16_and_names_one_device_repeatedly():
    mesh = TE.plan_mesh(32, devices=["cpu"] * 32)
    assert mesh.shape == (2, 16) and set(mesh.devices) == {
        torch.device("cpu")}
    assert TE.plan_mesh(12, devices=["cpu"] * 12).shape == (3, 4)
    with pytest.raises(ValueError, match="cannot hold"):
        TE.plan_mesh(2, model_parallel=4, devices=["cpu"] * 2)


def test_plan_mesh_defaults_to_the_visible_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="cards"):
        TE.plan_mesh(2)


class _Clock:
    def __init__(self, ticks):
        self.ticks = list(ticks)

    def __call__(self):
        return self.ticks.pop(0)


@pytest.mark.parametrize("durations,kw", [
    ([1.0] * 6 + [5.0] + [1.0] * 3, {}),
    ([1.0] * 4 + [3.0] * 7 + [1.0], {"consecutive_limit": 3}),
    ([0.5, 0.6, 0.7, 0.5, 2.0, 0.55, 4.0, 0.6], {"threshold": 3.0,
                                                 "window": 4}),
])
def test_step_timer_equals_jax(monkeypatch, durations, kw):
    ticks = []
    t = 0.0
    for d in durations:
        ticks += [t, t + d]
        t += d + 0.25
    calls = {"jax": [], "torch": []}
    out = {}
    for name, mod in (("jax", JE), ("torch", TE)):
        monkeypatch.setattr(mod.time, "perf_counter", _Clock(ticks))
        timer = mod.StepTimer(
            on_straggler=lambda dt, med, n=name: calls[n].append((dt, med)),
            **kw)
        rebalance = []
        for _ in durations:
            timer.start()
            rebalance.append(timer.stop())
        out[name] = (rebalance, timer.total_flagged, timer.consecutive_slow,
                     timer.median(), list(timer.durations))
    assert out["torch"] == out["jax"]
    assert calls["torch"] == calls["jax"] and calls["torch"]


def test_step_timer_flags_a_stalled_step(monkeypatch):
    ticks = []
    for i, d in enumerate([0.01] * 8 + [0.5]):
        ticks += [float(i), i + d]
    monkeypatch.setattr(TE.time, "perf_counter", _Clock(ticks))
    timer = TE.StepTimer()
    for _ in range(9):
        timer.start()
        timer.stop()
    assert timer.total_flagged == 1 and timer.consecutive_slow == 1
    with pytest.raises(RuntimeError, match="without start"):
        timer.stop()


def _mesh(n):
    return TD.make_mesh((n, 1), ("data", "model"), devices=["cpu"] * n)


def test_reshard_state_moves_the_state_whole():
    cfg = TC.get_config("granite-moe-3b-a800m").reduced()
    state = TT.init_state(0, cfg, device="cpu")
    moved, ctx = TE.reshard_state(state, TT.state_specs(cfg), _mesh(2))
    assert ctx.mesh.shape == (2, 1) and ctx.dp_axes == ("data",)
    # placed across the mesh by the specs, each block on its slot's
    # device; gathered whole, every leaf is the source's bit for bit
    for a, b in zip(TO.tree_leaves(moved), TO.tree_leaves(state)):
        assert sh.is_placed(a) and a.mesh == ctx.mesh
        assert all(t.device == torch.device("cpu") for t in a.blocks)
        assert torch.equal(sh.whole(a, "cpu"), b)
    same, ctx1 = TE.reshard_state(state, TT.state_specs(cfg), None)
    assert ctx1 == sh.Parallelism() and same is state
    bad = {**TT.state_specs(cfg), "step": (None,)}
    with pytest.raises(ValueError, match="spec of 1 dims"):
        TE.reshard_state(state, bad, _mesh(2))


def test_resume_on_fewer_shards_continues_the_run():
    """A state after 2 steps on 4 shards, resharded onto 2, takes 2 more
    steps equal to the 4-shard run's own next 2."""
    cfg = TC.get_config("llama3.2-1b").reduced()
    tcfg = TT.TrainConfig()
    step = TT.make_train_step(cfg, tcfg)
    shape = TC.ShapeConfig("t", "train", 32, 4)

    def run(state, ctx, steps):
        with sh.parallelism(ctx):
            for i in steps:
                state, _ = step(state, {k: torch.as_tensor(v) for k, v in
                                        TP.make_batch(cfg, shape, i).items()})
        return state

    state, ctx4 = TE.reshard_state(TT.init_state(0, cfg, device="cpu"),
                                   TT.state_specs(cfg), _mesh(4))
    state = run(state, ctx4, range(2))
    through = run(state, ctx4, range(2, 4))
    moved, ctx2 = TE.reshard_state(state, TT.state_specs(cfg), _mesh(2))
    resumed = run(moved, ctx2, range(2, 4))
    for a, b in zip(TO.tree_leaves(resumed), TO.tree_leaves(through)):
        assert torch.equal(sh.whole(a), sh.whole(b))
