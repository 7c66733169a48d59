"""The port's checkpoints (``repro_torch.training.checkpoint``) on the
CPU: a round trip with bfloat16 leaves, crash consistency, garbage
collection, the asynchronous writer, trees written by either package
loading bit for bit in the other, and ``launch.serve --ckpt-dir``."""
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import checkpoint as jckpt
from repro_torch import configs as TC
from repro_torch.launch import serve as TSV
from repro_torch.models import lm as TLM
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as TO


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((3, 4), generator=g),
                       "half": torch.randn((5,), generator=g).to(
                           torch.bfloat16),
                       "layers": [torch.arange(4, dtype=torch.int32),
                                  torch.randn((2, 2), generator=g)]},
            "step": torch.tensor(7, dtype=torch.int64),
            "skipped": None}


def _assert_bit_equal(got, want):
    gk, gl = ckpt._flatten_with_paths(got)
    wk, wl = ckpt._flatten_with_paths(want)
    assert gk == wk
    for g, w in zip(gl, wl):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def test_round_trip_keeps_every_leaf_bf16_included(tmp_path):
    d = str(tmp_path / "ckpt")
    state = _tree()
    final = ckpt.save_checkpoint(d, state, 7, extra={"arch": "x"})
    assert final.endswith("step_00000007") and ckpt.latest_step(d) == 7
    with np.load(os.path.join(final, "arrays.npz")) as data:
        assert data["params/half::bf16"].dtype == np.uint16
        assert "params/layers/1" in data
    restored, manifest = ckpt.load_checkpoint(d, _tree(seed=1))
    assert manifest["step"] == 7 and manifest["extra"] == {"arch": "x"}
    assert restored["skipped"] is None and list(restored) == list(state)
    _assert_bit_equal(restored, state)
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_checkpoint(d, {**state, "step": torch.zeros(2)})
    with pytest.raises(KeyError, match="missing"):
        ckpt.load_checkpoint(d, {"other": torch.zeros(1)})


def test_crash_consistency_and_latest(tmp_path):
    """A half-written newer snapshot does not shadow the good one; the
    next commit names itself in LATEST."""
    d = str(tmp_path / "ckpt")
    state = _tree()
    ckpt.save_checkpoint(d, state, 1)
    os.makedirs(os.path.join(d, "step_00000002.tmp"))
    assert ckpt.latest_step(d) == 1
    _, m = ckpt.load_checkpoint(d, state)
    assert m["step"] == 1
    later = _tree(seed=2)
    ckpt.save_checkpoint(d, later, 2)
    assert ckpt.latest_step(d) == 2
    assert not os.path.exists(os.path.join(d, "step_00000002.tmp"))
    _assert_bit_equal(ckpt.load_checkpoint(d, state)[0], later)
    _assert_bit_equal(ckpt.load_checkpoint(d, state, step=1)[0], state)
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(str(tmp_path / "none"), state)


def test_gc_keeps_the_newest(tmp_path):
    d = str(tmp_path / "ckpt")
    for s in range(6):
        ckpt.save_checkpoint(d, {"x": torch.zeros(2)}, s)
    ckpt.gc_old_checkpoints(d, keep=2)
    steps = sorted(n for n in os.listdir(d) if n.startswith("step_"))
    assert steps == ["step_00000004", "step_00000005"]


def test_async_checkpointer_snapshots_and_waits(tmp_path):
    d = str(tmp_path / "ckpt")
    ac = ckpt.AsyncCheckpointer(d, keep=2)
    tree = {"a": torch.arange(5.0), "b": {"c": torch.ones((3, 3))}}
    for s in (1, 2, 3):
        ac.save(tree, s)
    tree["a"].add_(100.0)            # after save: not in the snapshot
    assert ac.wait(timeout=60)
    assert ac.last_error is None and ckpt.latest_step(d) == 3
    got, _ = ckpt.load_checkpoint(d, tree)
    assert torch.equal(got["a"], torch.arange(5.0))
    # saves from several threads while the worker runs: the last is kept
    threads = [threading.Thread(target=ac.save, args=(tree, s))
               for s in range(4, 12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert ac.wait(timeout=60) and ac.last_error is None
    assert ckpt.latest_step(d) in range(4, 12)
    assert len([n for n in os.listdir(d) if n.startswith("step_")]) <= 3


def test_trees_cross_between_the_packages_bit_for_bit(tmp_path):
    rng = np.random.default_rng(3)
    w = rng.normal(0, 1, (4, 3)).astype(np.float32)
    h = rng.normal(0, 1, (6,)).astype(np.float32)
    ids = np.arange(5, dtype=np.int32)
    jtree = {"model": {"w": jnp.asarray(w),
                       "h": jnp.asarray(h, jnp.bfloat16)},
             "ids": jnp.asarray(ids)}
    jckpt.save_checkpoint(str(tmp_path / "jax"), jtree, 3)
    like = {"model": {"w": torch.zeros((4, 3)),
                      "h": torch.zeros((6,), dtype=torch.bfloat16)},
            "ids": torch.zeros(5, dtype=torch.int32)}
    got, m = ckpt.load_checkpoint(str(tmp_path / "jax"), like)
    assert m["step"] == 3 and got["model"]["h"].dtype == torch.bfloat16
    assert np.array_equal(got["model"]["w"].numpy(), w)
    assert np.array_equal(got["ids"].numpy(), ids)
    assert np.array_equal(
        got["model"]["h"].view(torch.int16).numpy().view(np.uint16),
        np.asarray(jtree["model"]["h"]).view(np.uint16))

    ckpt.save_checkpoint(str(tmp_path / "torch"), got, 4)
    back, m = jckpt.load_checkpoint(str(tmp_path / "torch"), jtree)
    assert m["step"] == 4
    for k in ("w", "h"):
        assert back["model"][k].dtype == jtree["model"][k].dtype
        assert np.array_equal(np.asarray(back["model"][k]).view(np.uint8),
                              np.asarray(jtree["model"][k]).view(np.uint8))
    assert np.array_equal(np.asarray(back["ids"]), ids)


def test_serve_cli_restores_a_checkpoint(tmp_path, capsys):
    """``--ckpt-dir`` serves the checkpoint's parameters, not the seed's:
    the CLI's tokens equal an engine's on the saved parameters."""
    cfg = TC.get_config("llama3.2-1b").reduced()
    params = TO.tree_map(lambda t: t * 1.5,
                         TLM.init_params(0, cfg, device="cpu"))
    d = str(tmp_path / "ckpt")
    ckpt.save_checkpoint(d, {"params": params}, 1)
    argv = ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
            "--batch", "2", "--prompt-len", "6", "--new-tokens", "12"]
    assert TSV.main(argv + ["--ckpt-dir", d]) == 0
    out = capsys.readouterr().out
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 6)).astype(np.int32)
    want = TSV.ServeEngine(cfg, params, 18, 2).generate(prompts, 12)
    for b in range(2):
        assert f"-> {want[b, 6:18].tolist()}..." in out
