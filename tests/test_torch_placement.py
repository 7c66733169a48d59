"""The train state stored split across a mesh (FSDP / TP storage), on the
CPU: ``sharding.place`` against the JAX package's ``NamedSharding``,
``gather`` and its reduce-scatter, the checkpoint files of a placed state,
a resume on other meshes, and the dry-run's gather wire.

The JAX side (``tests/_torch_placement_runner.py``, 4 fake host devices,
about 4 s) gives each device's index ranges of every state leaf of
reduced llama3.2-1b, granite-moe-3b-a800m and jamba-v0.1-52b on
("data", "model") (2, 2) and ("pod", "data", "model") (2, 1, 2); every
slot's block here must cover exactly those ranges. The meshes here name
the CPU 4 times.
"""
import dataclasses
import filecmp
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs as TC
from repro_torch.core import distributed as TD
from repro_torch.data import pipeline as TP
from repro_torch.launch import dryrun as TDR
from repro_torch.launch import train as TTR
from repro_torch.models import lm as TLM
from repro_torch.models import sharding as sh
from repro_torch.training import checkpoint as TCK
from repro_torch.training import elastic as TE
from repro_torch.training import optimizer as TO
from repro_torch.training import train_loop as TT

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from _torch_placement_runner import CASES  # noqa: E402

ARCHS = ("llama3.2-1b", "granite-moe-3b-a800m", "jamba-v0.1-52b")
MESHES = {(2, 2): ("data", "model"), (2, 1, 2): ("pod", "data", "model")}


def _mesh(shape, names=None):
    names = names or MESHES[tuple(shape)]
    return TD.make_mesh(shape, names, devices=["cpu"] * int(np.prod(shape)))


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("placement") / "jax.pkl"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "_torch_placement_runner.py"),
         str(out)], capture_output=True, text=True, env=env, timeout=300)
    assert "PLACEMENT_OK" in proc.stdout, proc.stdout + proc.stderr
    with open(out, "rb") as f:
        return pickle.load(f)


def _placed_state(arch, shape):
    cfg = TC.get_config(arch).reduced()
    state = TT.init_state(0, cfg, device="cpu")
    ctx = sh.make_parallelism(_mesh(shape))
    return cfg, state, TE.reshard_state(state, TT.state_specs(cfg),
                                        ctx.mesh)[0]


def _slot_ranges(leaf, k):
    bshape = leaf.block_shape()
    return tuple((c * b, (c + 1) * b) for c, b in zip(leaf.cell(k), bshape))


@pytest.mark.parametrize("arch,shape,names", CASES,
                         ids=[f"{a}-{'x'.join(map(str, s))}"
                              for a, s, _ in CASES])
def test_every_slot_holds_the_block_jax_gives_its_device(jax_side, arch,
                                                         shape, names):
    """Each slot's block of every state leaf (the groups as the port's
    lists) has the shape and index ranges that JAX's
    ``devices_indices_map`` gives device k of the same mesh; its values
    are the whole leaf's there."""
    ref = jax_side[(arch, shape)]
    cfg, state, placed = _placed_state(arch, shape)
    keys, leaves = TCK._flatten_with_paths(placed)
    _, whole = TCK._flatten_with_paths(state)
    seen = set()
    for key, leaf, w in zip(keys, leaves, whole):
        assert sh.is_placed(leaf), key
        parts = key.split("/")
        if "groups" in parts:           # the JAX tree stacks the groups
            i = parts.index("groups")
            g = int(parts.pop(i + 1))
            jkey = "/".join(parts)
        else:
            g, jkey = None, key
        want = ref[jkey]
        seen.add(jkey)
        for k in range(leaf.mesh.size):
            got = _slot_ranges(leaf, k)
            exp = want["ranges"][k]
            if g is not None:
                assert exp[0] == (0, cfg.n_groups)
                exp = exp[1:]
            assert got == tuple(exp), (key, k, got, exp)
            blk = leaf.blocks[k]
            assert tuple(blk.shape) == tuple(z - a for a, z in got), key
            assert torch.equal(blk, w[tuple(slice(a, z) for a, z in got)])
    assert seen == set(ref)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", sorted(MESHES))
def test_place_then_gather_is_bit_equal(arch, shape):
    """``place`` then ``whole`` and the autograd ``gather`` give every
    leaf back bit for bit; each slot stores what ``arg_bytes`` of the
    dry-run says a device holds."""
    cfg, state, placed = _placed_state(arch, shape)
    for a, b in zip(TO.tree_leaves(placed), TO.tree_leaves(state)):
        assert torch.equal(sh.whole(a, "cpu"), b)
        assert torch.equal(sh.gather(a, "cpu"), b)
    ctx = sh.make_parallelism(_mesh(shape))
    want = TDR.arg_bytes(TT.abstract_state(cfg), TT.state_specs(cfg), ctx)
    for k in range(ctx.mesh.size):
        assert sh.stored_bytes(placed, k) == want


def test_gather_backward_cuts_the_gradient_into_blocks():
    """The gradient of a gathered leaf comes back as each slot's block of
    the whole gradient, a replicated block to every slot that holds it;
    a partial gather (one tp rank's experts) reaches only its slots."""
    mesh = _mesh((2, 2))
    ctx = sh.make_parallelism(mesh)
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    w = torch.linspace(-1, 1, 8 * 6).reshape(8, 6)
    for spec in (("tp", "fsdp"), ("fsdp", None), (None, None)):
        p = sh.put(x, ctx.sharding(*spec))
        ts = [t.requires_grad_(True) for t in p.tensors()]
        p = p.with_tensors(ts)
        grads = torch.autograd.grad((sh.gather(p, "cpu") * w).sum(), ts)
        by_id = {id(t): g for t, g in zip(ts, grads)}
        for k in range(mesh.size):
            r = _slot_ranges(p, k)
            assert torch.equal(by_id[id(p.blocks[k])],
                               w[tuple(slice(a, z) for a, z in r)])
    e = torch.arange(4 * 6 * 2, dtype=torch.float32).reshape(4, 6, 2)
    p = sh.put(e, ctx.sharding("tp", "fsdp", None))
    ts = [t.requires_grad_(True) for t in p.tensors()]
    p = p.with_tensors(ts)
    part = sh.gather(p, "cpu", keep={"model": 1})
    assert torch.equal(part, e[2:4])
    grads = torch.autograd.grad(part.sum(), ts, allow_unused=True)
    for k, t in enumerate(p.blocks):
        g = grads[[id(u) for u in ts].index(id(t))]
        assert (g is not None) == (p.cell(k)[0] == 1)


def test_placed_checkpoint_is_byte_equal_and_resumes_on_other_meshes(
        tmp_path):
    """Two launcher steps on a (2, 2) mesh save a placed state; its files
    equal, byte for byte, those of the same state saved whole. It loads
    with ``shardings`` on (4, 1) and without a mesh bit-equal to the
    saved leaves, and the launcher resumes it on (4, 1) to the state of
    an uninterrupted (2, 2) run."""
    cfg = TC.get_config("llama3.2-1b").reduced()
    shape = TC.ShapeConfig("t", "train", 32, 4)
    tcfg = TT.TrainConfig()
    quiet = lambda *_: None  # noqa: E731
    run = TTR.train(cfg, shape, tcfg, 2, mesh=_mesh((2, 2)), device="cpu",
                    ckpt_dir=str(tmp_path / "placed"), log=quiet)
    assert all(sh.is_placed(x) for x in TO.tree_leaves(run.state))
    whole = TO.tree_map(lambda x: sh.whole(x, "cpu"), run.state)
    TCK.save_checkpoint(str(tmp_path / "whole"), TT.to_stacked(whole), 2)
    a, b = (tmp_path / t / "step_00000002" for t in ("placed", "whole"))
    for name in ("arrays.npz", "manifest.json"):
        assert filecmp.cmp(a / name, b / name, shallow=False), name
    like = TT.to_stacked(TT.abstract_state(cfg, tcfg), "meta")
    saved, _ = TCK.load_checkpoint(str(tmp_path / "placed"), like,
                                   device="cpu")
    for shp, names in (((4, 1), ("data", "model")), (None, None)):
        ctx = sh.make_parallelism(None if shp is None else _mesh(shp, names))
        shardings = (None if shp is None else sh.to_named_shardings(
            like, TT.stacked_specs(cfg), ctx))
        tree, _ = TCK.load_checkpoint(str(tmp_path / "placed"), like,
                                      device="cpu", shardings=shardings)
        for got, want in zip(TO.tree_leaves(tree), TO.tree_leaves(saved)):
            assert sh.is_placed(got) == (shp is not None)
            assert torch.equal(sh.whole(got, "cpu"), want)
    through = TTR.train(cfg, shape, tcfg, 4, mesh=_mesh((2, 2)),
                        device="cpu", log=quiet)
    moved = TTR.train(cfg, shape, tcfg, 4, mesh=_mesh((4, 1),
                                                      ("data", "model")),
                      device="cpu", ckpt_dir=str(tmp_path / "placed"),
                      log=quiet)
    assert sorted(moved.losses) == [2, 3]
    for got, want in zip(TO.tree_leaves(moved.state),
                         TO.tree_leaves(through.state)):
        g, w = sh.whole(got, "cpu"), sh.whole(want, "cpu")
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


def _hand_wire(cfg, state, ctx, passes):
    """All-gather wire of one pass over every placed leaf of the
    parameters: for each leaf split over n slots, a block's bytes a
    participant, n participants, (n - 1) / n of it on the wire, once for
    each of the mesh's size / n replica groups; times the leaf's passes."""
    total = 0.0
    keys, leaves = TCK._flatten_with_paths(state["params"])
    for key, leaf in zip(keys, leaves):
        n = int(np.prod([g for g in (leaf.shape[d] // leaf.block_shape()[d]
                                     for d in range(leaf.dim()))]))
        if n == 1:
            continue
        block = leaf.slot_bytes(0)
        total += (ctx.mesh.size // n) * n * block * (n - 1) / n \
            * passes(key)
    return total


def test_dryrun_wire_counts_each_gather_and_reduce_scatter():
    """One dry-run train step of reduced llama3.2-1b on a (2, 2) mesh (fake
    tensors, loops scaled): the counter's all-gather and reduce-scatter
    wire equal a hand count of block bytes x passes. A group's leaf is
    gathered in the forward and again in the recompute under remat and
    reduce-scattered once; the embedding table is gathered for the
    embedding and for the cross-entropy chunk, forward and recompute, and
    reduce-scattered twice; replicated leaves move nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = TC.get_config("llama3.2-1b").reduced()
    ctx = sh.make_parallelism(_mesh((2, 2)))
    shape = TC.ShapeConfig("t", "train", 64, 8)
    with FakeTensorMode(), sh.parallelism(ctx):
        counter, _, _ = TDR.cost_lm(cfg, shape, ctx, torch.device("cpu"))
        state = sh.place(TDR._fake_like(TT.abstract_state(cfg, TDR.TRAIN_CFG),
                                        torch.device("cpu")),
                         TT.state_specs(cfg), ctx)
    assert cfg.remat and cfg.n_groups == 1

    def gathers(key):
        return 3 if key == "embed/table" else 2

    def scatters(key):
        return 2 if key == "embed/table" else 1

    got = counter.costs.wire_by_kind
    assert got["all-gather"] == pytest.approx(
        _hand_wire(cfg, state, ctx, gathers), rel=1e-12)
    assert got["reduce-scatter"] == pytest.approx(
        _hand_wire(cfg, state, ctx, scatters), rel=1e-12)
    assert got["all-gather"] > 0


def _counted_step(cfg, ctx, fake: bool):
    """(costs, live bytes after the step with its outputs held, peak) of
    one train step on a state placed on ``ctx``'s mesh under a dry-run's
    counter: fake tensors as the dry-run places them, or the real state
    of ``init_state``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.analysis import op_cost
    dev = torch.device("cpu")
    shape = TC.ShapeConfig("t", "train", 64, 8)
    step = TT.make_train_step(cfg, TDR.TRAIN_CFG)
    with (FakeTensorMode() if fake else torch.no_grad()), \
            sh.parallelism(ctx):
        if fake:
            state = sh.place(TDR._fake_like(TT.abstract_state(
                cfg, TDR.TRAIN_CFG), dev), TT.state_specs(cfg), ctx)
        else:
            state = TT.init_state(0, cfg, TDR.TRAIN_CFG, device=dev, ctx=ctx)
        batch = TDR._batch(cfg, shape, dev)
        with op_cost.CostCounter(scale_loops=True) as counter:
            out = step(state, batch)
        live = counter.live
        del out
    return counter.costs, live, counter.peak


@pytest.mark.parametrize("arch", ARCHS)
def test_fake_placed_step_counts_as_the_real_one(arch):
    """The dry-run's fake placement (one tensor a device standing for
    the device's blocks) counts what the real placement on a (2, 2)
    mesh of cpu entries counts, under the same scaled counter: flops,
    wire, bytes, and the live bytes of the step's outputs (the new
    parameters and moments, one block a cell) and the peak. Two
    microbatches, so the gradients' sum and mean are counted too. The
    one exception is ``zeros_like``: a real state under a scaled counter
    runs one expert-parallel trip, so the blocks of the tp ranks no trip
    reached get no gradient and are filled with zeros, while a fake
    block stands for every rank's."""
    cfg = dataclasses.replace(TC.get_config(arch).reduced(), microbatches=2)
    ctx = sh.make_parallelism(_mesh((2, 2)))
    real, real_live, real_peak = _counted_step(cfg, ctx, fake=False)
    fake, fake_live, fake_peak = _counted_step(cfg, ctx, fake=True)

    def moved(c):
        return c.bytes - c.by_op.get("zeros_like", [0, 0.0])[1]

    assert fake.flops == real.flops
    assert dict(fake.wire_by_kind) == dict(real.wire_by_kind)
    assert moved(fake) == pytest.approx(moved(real), rel=1e-12)
    assert (fake_live, fake_peak) == (real_live, real_peak)
    # the outputs hold every cell of the new parameters and moments
    state = TT.abstract_state(cfg, TDR.TRAIN_CFG)
    whole = sum(t.numel() * t.element_size() for t in TO.tree_leaves(
        {"params": state["params"], "opt": state["opt"]}))
    assert real_live >= whole


def test_placed_steps_leave_no_gathered_leaf_behind():
    """After placed train steps no gathered tensor is still referenced:
    each group's gathered parameters, and each tp rank's experts, died
    with their body."""
    cfg = TC.get_config("granite-moe-3b-a800m").reduced()
    ctx = sh.make_parallelism(_mesh((2, 2)))
    state = TT.init_state(0, cfg, device="cpu", ctx=ctx)
    step = TT.make_train_step(cfg)
    batch = {k: torch.as_tensor(v) for k, v in TP.make_batch(
        cfg, TC.ShapeConfig("t", "train", 32, 4), 0).items()}
    with sh.parallelism(ctx):
        state, m = step(state, batch)
    assert np.isfinite(float(m["loss"]))
    assert sh.live_gathers() == 0
    assert all(sh.is_placed(x) for x in TO.tree_leaves(state))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "whisper-tiny",
                                  "granite-moe-3b-a800m"])
def test_entry_points_take_placed_parameters(arch):
    """``forward`` on parameters placed across a (2, 2) mesh equals the
    plain tree's bit for bit (whisper's encoder groups gathered too); so
    do llama's ``prefill`` and two ``decode_step``s."""
    cfg = TC.get_config(arch).reduced()
    params = TLM.init_params(0, cfg, device="cpu")
    ctx = sh.make_parallelism(_mesh((2, 2)))
    placed = sh.place(params, TLM.param_specs(cfg), ctx)
    gen = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
    extra = ({"frames": torch.randn((2, 16, cfg.d_model), generator=gen)}
             if cfg.is_encdec else {})
    with torch.no_grad(), sh.parallelism(ctx):
        got, _ = TLM.forward(placed, tokens, cfg, **extra)
        want, _ = TLM.forward(params, tokens, cfg, **extra)
        assert torch.equal(got, want)
        if arch != "llama3.2-1b":
            return
        outs = []
        for p in (placed, params):
            cache = TLM.init_cache(cfg, 2, 24, device="cpu")
            logits, cache = TLM.prefill(p, tokens, cache, cfg)
            seq = [logits]
            for pos in (16, 17):
                tok = seq[-1][:, -1].argmax(-1)[:, None]
                logits, cache = TLM.decode_step(p, tok, cache, pos, cfg)
                seq.append(logits)
            outs.append(seq)
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert sh.live_gathers() == 0
