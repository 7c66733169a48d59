"""The port's training launcher (``launch/train.py``) on the CPU, against
the JAX package's launcher where both run.

- Both launchers resume copies of one checkpoint the JAX package wrote
  (reduced llama3.2-1b drawn from ``PRNGKey(1)``, saved at step 3) and
  run to step 6; their final checkpoints agree leaf by leaf within rtol
  1e-4 (atol 1e-6), the step counters equal.
- The fault drill: a batch source that raises once at step 12, with
  ``ckpt_every`` 5 and 20 steps, restarts from step 10's checkpoint and
  ends bit-equal to an uninterrupted run, checkpoint files included;
  with ``max_restarts`` spent, or without a checkpoint directory, the
  fault reaches the caller.
- ``main`` without a card and without ``--device cpu`` raises.
- ``examples/torch_train_lm.py`` and ``examples/torch_moe_fuzzy_router.py``
  at tiny step counts.
"""
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.launch import train as JL
from repro.training import checkpoint as JCK
from repro.training import train_loop as JT
from repro_torch import configs as TC
from repro_torch.data import pipeline as TP
from repro_torch.launch import train as TL
from repro_torch.training import checkpoint as TCK
from repro_torch.training import train_loop as TT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "llama3.2-1b"
ARGS = ["--arch", ARCH, "--reduced", "--batch", "4", "--seq", "32"]


def _arrays(ckpt_dir, step):
    with np.load(os.path.join(ckpt_dir, f"step_{step:08d}",
                              "arrays.npz")) as data:
        return {k: data[k] for k in data.files}


def test_both_launchers_resume_one_jax_checkpoint(tmp_path):
    cfg = JC.get_config(ARCH).reduced()
    state = JT.init_state(jax.random.PRNGKey(1), cfg)
    state = dict(state, step=jax.numpy.asarray(3, jax.numpy.int32))
    JCK.save_checkpoint(str(tmp_path / "seed"), state, 3)
    for name in ("jax", "torch"):
        shutil.copytree(tmp_path / "seed", tmp_path / name)
    assert JL.main(ARGS + ["--steps", "6", "--ckpt-dir",
                           str(tmp_path / "jax")]) == 0
    assert TL.main(ARGS + ["--steps", "6", "--ckpt-dir",
                           str(tmp_path / "torch"), "--device", "cpu"]) == 0
    assert TCK.latest_step(str(tmp_path / "torch")) == 6
    assert JCK.latest_step(str(tmp_path / "jax")) == 6
    want = _arrays(str(tmp_path / "jax"), 6)
    got = _arrays(str(tmp_path / "torch"), 6)
    assert sorted(got) == sorted(want)
    assert int(got["step"]) == int(want["step"]) == 6
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def _faulty(at, times):
    """A pipeline that raises at step ``at`` the first ``times`` times."""
    left = [times]

    def batches(cfg, shape, start):
        for i, batch in enumerate(TP.batches(cfg, shape, start)):
            if start + i == at and left[0] > 0:
                left[0] -= 1
                raise RuntimeError(f"injected fault at step {at}")
            yield batch
    return batches


def _run(ckpt_dir, batches=TP.batches, max_restarts=2, steps=20):
    cfg = TC.get_config(ARCH).reduced()
    return TL.train(cfg, TC.ShapeConfig("t", "train", 32, 4),
                    TT.TrainConfig(), steps, device="cpu",
                    ckpt_dir=ckpt_dir, ckpt_every=5,
                    max_restarts=max_restarts, batches=batches,
                    log=lambda *_: None)


def test_fault_drill_restarts_to_the_uninterrupted_state(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(TL, "RESTART_BACKOFF_S", 0.0)
    clean = _run(str(tmp_path / "clean"))
    loads = []
    real = TCK.load_checkpoint
    monkeypatch.setattr(TCK, "load_checkpoint", lambda d, like, **kw: (
        loads.append(TCK.latest_step(d)) or real(d, like, **kw)))
    drill = _run(str(tmp_path / "drill"), _faulty(12, 1))
    assert (clean.restarts, drill.restarts) == (0, 1)
    assert loads == [10]
    assert drill.losses == clean.losses and sorted(drill.losses) == list(
        range(20))
    for d in ("clean", "drill"):
        assert TCK.latest_step(str(tmp_path / d)) == 20
    want = _arrays(str(tmp_path / "clean"), 20)
    got = _arrays(str(tmp_path / "drill"), 20)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    # step 10's checkpoint holds the state after ten steps
    assert int(_arrays(str(tmp_path / "drill"), 10)["step"]) == 10


def test_spent_restarts_raise(tmp_path, monkeypatch):
    monkeypatch.setattr(TL, "RESTART_BACKOFF_S", 0.0)
    with pytest.raises(RuntimeError, match="injected fault at step 7"):
        _run(str(tmp_path / "a"), _faulty(7, 2), max_restarts=1, steps=10)
    with pytest.raises(RuntimeError, match="injected fault at step 2"):
        _run(None, _faulty(2, 1), steps=4)


def test_main_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TL.main(ARGS + ["--steps", "1"])


def test_main_prints_a_summary(capsys):
    assert TL.main(ARGS + ["--steps", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "mesh=None" in out and "training complete" in out
    assert '"steps": 3' in out and '"restarts": 0' in out


@pytest.mark.parametrize("script,args,want", [
    ("torch_train_lm.py", ["--steps", "3", "--layers", "2", "--d-model",
                           "128", "--batch", "2", "--seq", "32"],
     "done at step 3"),
    ("torch_moe_fuzzy_router.py", ["--steps", "3"],
     "fuzzy-membership routing trains comparably"),
])
def test_examples_run_on_the_cpu(tmp_path, script, args, want):
    if script == "torch_train_lm.py":
        args = args + ["--ckpt-dir", str(tmp_path / "ck")]
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", script), *args,
         "--device", "cpu"], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert want in proc.stdout
