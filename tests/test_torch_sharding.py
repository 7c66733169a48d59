"""The port's logical sharding (``models/sharding.py`` and the
``spec_*`` / ``*_specs`` functions of the model and train modules)
against the JAX package's, on the CPU.

- The spec trees equal the JAX package's leaf for leaf for all ten
  archs at their published widths: parameters (the port's list of
  groups, stacked back with ``stack_spec``), the decode cache, the train
  state and the batch; the meta-device abstract trees have the JAX
  package's shapes and dtypes (no memory allocated).
- ``resolve``, ``pspec`` and ``prune_spec`` on (2, 16, 16) and (16, 16)
  meshes: the JAX side gets a stand-in object carrying ``axis_names``,
  ``shape`` and ``devices.shape``; the port's mesh names the CPU 512 or
  256 times. Every leaf's pruned spec of every arch's train state
  (``to_shardings``) equals the JAX package's ``prune_spec``.
- The context: nesting, restore on error, and one context a thread.
"""
import threading

import jax
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import lm as JLM
from repro.models import sharding as JS
from repro.training import train_loop as JT
from repro_torch import configs as TC
from repro_torch.core import distributed as TD
from repro_torch.models import lm as TLM
from repro_torch.models import sharding as TS
from repro_torch.training import optimizer as TO
from repro_torch.training import train_loop as TT

ARCHS = TC.list_archs()
MESHES = {"pods": ((2, 16, 16), ("pod", "data", "model")),
          "pod": ((16, 16), ("data", "model"))}


class _StandIn:
    """What the JAX package's sharding functions read of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.shape = dict(zip(names, shape))
        self.devices = np.empty(shape, dtype=object)


def _stacked(tree):
    """The port's param / cache spec tree with each list of groups back
    in the JAX package's stacked form."""
    if isinstance(tree, list):
        assert all(t == tree[0] for t in tree)
        return TS.stack_spec(tree[0])
    if isinstance(tree, dict):
        return {k: _stacked(v) for k, v in tree.items()}
    return tree


def _spec_leaves(tree):
    return jax.tree_util.tree_leaves(tree,
                                     is_leaf=lambda s: isinstance(s, tuple))


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_equal_jax(arch):
    jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    assert _stacked(TLM.param_specs(tcfg)) == JLM.param_specs(jcfg)
    assert TS.stack_spec(TLM.cache_specs(tcfg)[0]) == JLM.cache_specs(jcfg)
    assert len(TLM.cache_specs(tcfg)) == tcfg.n_groups
    got = TT.state_specs(tcfg)
    want = JT.state_specs(jcfg)
    assert {"params": _stacked(got["params"]),
            "opt": {k: _stacked(v) for k, v in got["opt"].items()},
            "step": got["step"]} == want
    assert TT.batch_specs(tcfg) == JT.batch_specs(jcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_state_matches_jax_on_meta(arch):
    """abstract_state's leaves are meta tensors with the JAX package's
    shapes and dtypes, in the same order as the spec leaves."""
    jcfg, tcfg = JC.get_config(arch).reduced(), TC.get_config(arch).reduced()
    got = TT.abstract_state(tcfg)
    leaves = TO.tree_leaves(got)
    assert all(t.device.type == "meta" for t in leaves)
    want = JT.abstract_state(jcfg)
    stacked = TO.tree_leaves(TT.to_stacked(got, "meta"))
    wl = jax.tree_util.tree_leaves(want)
    assert [tuple(t.shape) for t in stacked] == [tuple(a.shape) for a in wl]
    assert [str(t.dtype).split(".")[-1] for t in stacked] == [
        str(a.dtype) for a in wl]
    assert len(_spec_leaves(TT.state_specs(tcfg))) == len(leaves)


def test_abstract_params_of_the_largest_arch_allocate_nothing():
    cfg = TC.get_config("deepseek-v2-236b")
    leaves = TO.tree_leaves(TLM.abstract_params(cfg))
    assert sum(t.numel() for t in leaves) > 2e11
    assert {t.device.type for t in leaves} == {"meta"}


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_resolve_and_pspec_equal_jax(mesh):
    shape, names = MESHES[mesh]
    jctx = JS.make_parallelism(_StandIn(shape, names))
    tctx = TS.make_parallelism(TD.make_mesh(
        shape, names, devices=["cpu"] * int(np.prod(shape))))
    assert (tctx.fsdp_axes, tctx.tp_axis, tctx.dp_axes) == (
        jctx.fsdp_axes, jctx.tp_axis, jctx.dp_axes)
    assert tctx.tp_size == jctx.tp_size == 16
    for logical in (None, "fsdp", "tp", "dp", ("dp", "tp"), ("tp", "fsdp"),
                    ("fsdp", None)):
        assert tctx.resolve(logical) == jctx.resolve(logical)
    for spec in (("dp", None), ("fsdp", "tp"), ("tp", None, "fsdp"), ()):
        assert tctx.pspec(*spec) == tuple(jctx.pspec(*spec))
    with pytest.raises(ValueError, match="unknown logical axis"):
        tctx.resolve("expert")


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape", [(1, 7), (2, 49155), (32, 24), (4, 16),
                                   (64, 2048), (512, 3), (3,)])
def test_prune_spec_equals_jax(mesh, shape):
    mshape, names = MESHES[mesh]
    stand = _StandIn(mshape, names)
    tmesh = TD.make_mesh(mshape, names,
                         devices=["cpu"] * int(np.prod(mshape)))
    batchy = tuple(n for n in names if n != "model")
    for spec in ((batchy, "model"), ("model", batchy), (None, batchy),
                 (batchy,)):
        want = JS.prune_spec(jax.sharding.PartitionSpec(*spec), shape, stand)
        assert TS.prune_spec(spec, shape, tmesh) == tuple(want)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "jamba-v0.1-52b",
                                  "whisper-tiny", "deepseek-v2-236b"])
def test_state_shardings_equal_jax_prune(arch):
    """to_shardings over every train-state leaf equals the JAX package's
    prune_spec of its pspec on the (2, 16, 16) mesh."""
    shape, names = MESHES["pods"]
    stand = _StandIn(shape, names)
    jctx = JS.make_parallelism(stand)
    tcfg = TC.get_config(arch)
    tctx = TS.make_parallelism(TD.make_mesh(
        shape, names, devices=["cpu"] * int(np.prod(shape))))
    state = TT.abstract_state(tcfg)
    got = TS.to_shardings(state, TT.state_specs(tcfg), tctx)
    leaves = TO.tree_leaves(state)
    specs = _spec_leaves(TT.state_specs(tcfg))
    flat = _spec_leaves(got)
    assert len(flat) == len(leaves) == len(specs)
    for pruned, leaf, spec in zip(flat, leaves, specs):
        want = JS.prune_spec(jctx.pspec(*spec), tuple(leaf.shape), stand)
        assert pruned == tuple(want)
    assert TS.to_shardings(state, TT.state_specs(tcfg),
                           TS.Parallelism())["step"] is None


def test_context_nests_and_restores():
    a = TS.make_parallelism(TD.make_mesh((2, 1), ("data", "model"),
                                         devices=["cpu"] * 2))
    b = TS.make_parallelism(TD.make_mesh((1, 2), ("data", "model"),
                                         devices=["cpu"] * 2))
    assert TS.current() == TS.Parallelism()
    with TS.parallelism(a):
        assert TS.current() is a and TS.current().tp_size == 1
        with TS.parallelism(b):
            assert TS.current() is b and TS.current().tp_size == 2
        assert TS.current() is a
        with pytest.raises(KeyError):
            with TS.parallelism(b):
                raise KeyError("x")
        assert TS.current() is a
    assert TS.current() == TS.Parallelism()


def test_context_is_thread_local():
    a = TS.make_parallelism(TD.make_mesh((1, 2), ("data", "model"),
                                         devices=["cpu"] * 2))
    seen, inside, leave = {}, threading.Event(), threading.Event()

    def worker():
        seen["before"] = TS.current()
        with TS.parallelism(a):
            inside.set()
            leave.wait(10)
            seen["inside"] = TS.current()

    t = threading.Thread(target=worker)
    t.start()
    assert inside.wait(10)
    assert TS.current() == TS.Parallelism()     # not the worker's context
    leave.set()
    t.join(10)
    assert seen["before"] == TS.Parallelism() and seen["inside"] is a


def test_shards_of_a_mesh():
    devs = [torch.device("cpu")] * 8
    mesh = TD.make_mesh((2, 2, 2), ("pod", "data", "model"), devices=devs)
    ctx = TS.make_parallelism(mesh)
    shards = TS.dp_shards(ctx, 8)
    assert [s for s, _ in shards] == [slice(0, 2), slice(2, 4), slice(4, 6),
                                      slice(6, 8)]
    assert [c for _, c in shards] == [{"pod": 0, "data": 0},
                                      {"pod": 0, "data": 1},
                                      {"pod": 1, "data": 0},
                                      {"pod": 1, "data": 1}]
    # 6 rows: "pod" dropped first, 6 % 2 keeps "data"; 3 rows drop both
    assert [c for _, c in TS.dp_shards(ctx, 6)] == [{"data": 0}, {"data": 1}]
    assert TS.dp_shards(ctx, 3) == [(slice(0, 3), {})]
    assert [c for _, c in TS.dp_shards(ctx, 2)] == [{"data": 0}, {"data": 1}]
    assert TS.dp_shards(TS.Parallelism(), 5) == [(slice(0, 5), {})]
    sub = TS.sub_mesh(mesh, "pod", 1)
    assert (sub.shape, sub.axis_names) == ((2, 2), ("data", "model"))
    x = torch.ones(3)
    assert TS.shard(x, "dp") is x
