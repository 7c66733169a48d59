"""The port's train step on a mesh against the JAX package's, on the CPU.

The JAX side runs once per module in a subprocess under 8 fake host
devices (``tests/_torch_train_mesh_runner.py``); the port's side runs
in-process on meshes whose entries are all ``cpu``. Both start from the
JAX package's ``PRNGKey(0)`` parameters (carried across with
``convert.lm_params_from_numpy``) and take two steps on the same
pipeline batches (batch 4, seq 64, the reduced configs, the default
optimizer).

The cases: reduced granite-moe-3b-a800m (8 experts, capacity factor 1.0
so that capacity binds) on ("data", "model") meshes (2, 2) (a dp split
under expert parallelism: global aux loss, per-shard capacity), (1, 4),
(1, 3) (8 experts padded to 9) and (4, 1) (tp == 1: global capacity);
reduced llama3.2-1b with ``compress_cross_pod`` on ("pod", "data",
"model") (2, 1, 1) and (2, 2, 1); reduced Jamba on (2, 2) (expert
parallelism, and the Mamba scan per dp shard with ``mamba_pallas`` on
the port's side).

Tolerances: metrics rtol 1e-4; parameters rtol 1e-4 with atol 1e-6
(``tests/test_torch_lm.py``'s bar); the AdamW moments, which hold the
gradients, within 1e-4 of each leaf's largest entry (``chip_smoke.py``'s
``TRAIN_RTOL``: the Mamba backward sums over positions in another
order); the compressed cases' int8 mean gradients within one
quantization step of JAX's.

The JAX compressed step fails on (2, 1, 1) (ROADMAP queue 3 (m)); that
case holds the port to the composition the branch defines, per-pod
``_microbatch_grads`` and ``compressed_psum_mean`` under
``jax.vmap(axis_name="pod")``, which the runner marks ``composed``.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.core import distributed as TD
from repro_torch.data import pipeline as TP
from repro_torch.models import lm as TLM
from repro_torch.models import moe as TM
from repro_torch.models import sharding as sh
from repro_torch.models import ssm as TS
from repro_torch.training import optimizer as TO
from repro_torch.training import train_loop as TT

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH, SEQ, STEPS = 4, 64, 2
RTOL = 1e-4

#: the runner's cases: (arch, mesh shape, axes, compress, capacity factor)
CASES = {
    "granite_dp2_tp2": ("granite-moe-3b-a800m", (2, 2), ("data", "model"),
                        False, 1.0),
    "granite_tp4": ("granite-moe-3b-a800m", (1, 4), ("data", "model"),
                    False, 1.0),
    "granite_tp3_pad": ("granite-moe-3b-a800m", (1, 3), ("data", "model"),
                        False, 1.0),
    "granite_dp4": ("granite-moe-3b-a800m", (4, 1), ("data", "model"),
                    False, 1.0),
    "llama_pod2": ("llama3.2-1b", (2, 1, 1), ("pod", "data", "model"),
                   True, None),
    "llama_pod2_dp2": ("llama3.2-1b", (2, 2, 1), ("pod", "data", "model"),
                       True, None),
    "jamba_dp2_tp2": ("jamba-v0.1-52b", (2, 2), ("data", "model"), False,
                      None),
}
COMPRESSED = [n for n, c in CASES.items() if c[3]]


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("train_mesh") / "jax.pkl"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "_torch_train_mesh_runner.py"),
         str(out)], capture_output=True, text=True, env=env, timeout=600)
    assert "TRAIN_MESH_OK" in proc.stdout, proc.stdout + proc.stderr
    with open(out, "rb") as f:
        return pickle.load(f)


def _cfg(arch, capacity_factor=None, **kw):
    cfg = TC.get_config(arch).reduced()
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return dataclasses.replace(cfg, **kw)


def _cpu_mesh(shape, axes):
    return TD.make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


def _batch(cfg, i):
    shape = TC.ShapeConfig("t", "train", SEQ, BATCH)
    return {k: torch.as_tensor(v)
            for k, v in TP.make_batch(cfg, shape, i).items()}


def _state(params):
    return {"params": params, "opt": TO.init_opt_state(params),
            "step": torch.zeros((), dtype=torch.int32)}


def _steps(cfg, tcfg, state, mesh, n=STEPS):
    step = TT.make_train_step(cfg, tcfg)
    metrics = []
    with sh.parallelism(sh.make_parallelism(mesh)):
        for i in range(n):
            state, m = step(state, _batch(cfg, i))
            metrics.append(m)
    return state, metrics


def _port_case(name, jax_side):
    arch, shape, axes, compress, cf = CASES[name]
    cfg = _cfg(arch, cf, mamba_pallas=arch.startswith("jamba"))
    params = convert.lm_params_from_numpy(
        jax_side["cases"][name]["params0"], cfg, device="cpu")
    return cfg, TT.TrainConfig(compress_cross_pod=compress), params, \
        _cpu_mesh(shape, axes)


def _from_jax_state(tree):
    return TT.from_stacked(TO.tree_map(lambda a: torch.as_tensor(
        np.array(a)), tree), "cpu")


@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_steps_match_jax(jax_side, name):
    ref = jax_side["cases"][name]
    cfg, tcfg, params, mesh = _port_case(name, jax_side)
    state, metrics = _steps(cfg, tcfg, _state(params), mesh)
    for i, (m, jm) in enumerate(zip(metrics, ref["metrics"])):
        for k in ("loss", "aux_loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=RTOL,
                                       err_msg=f"{name} step {i} {k}")
    want = _from_jax_state(ref["state"])
    assert int(state["step"]) == int(want["step"]) == STEPS
    for got, exp in zip(TO.tree_leaves(state["params"]),
                        TO.tree_leaves(want["params"])):
        np.testing.assert_allclose(got.numpy(), exp.numpy(), rtol=RTOL,
                                   atol=1e-6)
    for got, exp in zip(TO.tree_leaves(state["opt"]),
                        TO.tree_leaves(want["opt"])):
        top = float(exp.abs().max())
        assert float((got - exp).abs().max()) <= RTOL * top, name


@pytest.mark.parametrize("name", sorted(CASES))
def test_placed_mesh_steps_match_jax(jax_side, name):
    """The same two steps on the state placed across the mesh (each slot
    a block of every leaf, ``sharding.place``): the state stays placed,
    no gathered leaf outlives the steps, and metrics and leaves match
    the lead-device steps and the JAX package's within the bars of
    :func:`test_mesh_steps_match_jax`."""
    ref = jax_side["cases"][name]
    cfg, tcfg, params, mesh = _port_case(name, jax_side)
    ctx = sh.make_parallelism(mesh)
    placed = sh.place(_state(params), TT.state_specs(cfg), ctx)
    got, gm = _steps(cfg, tcfg, placed, mesh)
    assert sh.live_gathers() == 0
    assert all(sh.is_placed(x) for x in TO.tree_leaves(got))
    lead, lm_ = _steps(cfg, tcfg, _state(params), mesh)
    whole = TO.tree_map(lambda x: sh.whole(x, "cpu"), got)
    want = _from_jax_state(ref["state"])
    for i, m in enumerate(gm):
        for k in ("loss", "aux_loss", "grad_norm", "lr"):
            for exp in (ref["metrics"][i][k], lm_[i][k]):
                np.testing.assert_allclose(float(m[k]), float(exp),
                                           rtol=RTOL,
                                           err_msg=f"{name} step {i} {k}")
    assert int(whole["step"]) == STEPS
    for other in (want, lead):
        for a, b in zip(TO.tree_leaves(whole["params"]),
                        TO.tree_leaves(other["params"])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                       atol=1e-6)
        for a, b in zip(TO.tree_leaves(whole["opt"]),
                        TO.tree_leaves(other["opt"])):
            assert float((a - b).abs().max()) <= RTOL * float(
                b.abs().max()), name


@pytest.mark.parametrize("name", COMPRESSED)
def test_compressed_grads_within_one_quantization_step(jax_side, name):
    """The int8 mean of the per-pod gradients against JAX's, leaf by
    leaf, within one quantization step (the shared scale max|g| / 127
    over the pods, at least the largest |mean|)."""
    cfg, tcfg, params, mesh = _port_case(name, jax_side)
    ctx = sh.make_parallelism(mesh)
    grads, _ = TT._pod_grads(params, _batch(cfg, 0), cfg, tcfg, ctx)
    want = convert.lm_params_from_numpy(jax_side["cases"][name]["grads0"],
                                        cfg, device="cpu")
    # the per-pod gradients, uncompressed, for each leaf's shared scale
    pods = []
    for k in range(2):
        sub = sh.sub_mesh(mesh, "pod", k)
        mb = {n: v[k * BATCH // 2:(k + 1) * BATCH // 2]
              for n, v in _batch(cfg, 0).items()}
        with sh.parallelism(sh.make_parallelism(sub)):
            pods.append(TT._microbatch_grads(params, mb, cfg, tcfg)[0])
    for got, exp, a, b in zip(*(TO.tree_leaves(t) for t in
                                (grads, want, pods[0], pods[1]))):
        step = max(float(a.abs().max()), float(b.abs().max())) / 127.0
        assert float((got - exp).abs().max()) <= step
        # and one quantization step of the uncompressed mean
        assert float((got - (a + b) / 2).abs().max()) <= step


def test_compressed_case_that_jax_refuses_is_composed(jax_side):
    assert jax_side["cases"]["llama_pod2"]["composed"]
    assert not jax_side["cases"]["llama_pod2_dp2"]["composed"]


def test_dense_mesh_step_equals_single_device(jax_side):
    """Without compression the step computes the global function: a dense
    model's two steps on a (2, 2) mesh equal one device's bit for bit."""
    cfg = _cfg("llama3.2-1b")
    params = convert.lm_params_from_numpy(
        jax_side["cases"]["llama_pod2"]["params0"], cfg, device="cpu")
    tcfg = TT.TrainConfig()
    meshed, mm = _steps(cfg, tcfg, _state(params),
                        _cpu_mesh((2, 2), ("data", "model")))
    single, sm = _steps(cfg, tcfg, _state(params), None)
    for a, b in zip(mm, sm):
        assert float(a["loss"]) == float(b["loss"])
    for a, b in zip(TO.tree_leaves(meshed), TO.tree_leaves(single)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cf,same", [(8.0, True), (1.0, False)])
def test_expert_parallel_capacity_is_per_shard(cf, same):
    """moe_ffn on a (2, 2) mesh equals one device's where capacity is
    drop-free and differs where it binds (capacity from the local token
    count); the aux loss is the global one either way."""
    cfg = _cfg("granite-moe-3b-a800m", cf)
    gen = torch.Generator().manual_seed(3)
    p = TM.init_moe(gen, cfg)
    x = torch.randn((4, 64, cfg.d_model), generator=gen)
    one, aux1 = TM.moe_ffn(p, x, cfg)
    with sh.parallelism(sh.make_parallelism(
            _cpu_mesh((2, 2), ("data", "model")))):
        two, aux2 = TM.moe_ffn(p, x, cfg)
    assert float(aux1) == float(aux2)
    assert torch.allclose(one, two, rtol=1e-5, atol=1e-6) == same


def test_mamba_scan_runs_per_dp_shard(monkeypatch):
    """With mamba_pallas under a (2, 1) mesh each Mamba layer's scan runs
    once per dp shard, on half the rows, and the output equals the
    unsharded forward's."""
    cfg = _cfg("jamba-v0.1-52b", mamba_pallas=True)
    params = TLM.init_params(0, cfg, device="cpu")
    tokens = torch.as_tensor(TP.make_batch(
        cfg, TC.ShapeConfig("t", "train", SEQ, BATCH), 0)["tokens"])
    rows = []
    orig = TS.SelectiveScan.apply
    monkeypatch.setattr(TS.SelectiveScan, "apply",
                        lambda *a: rows.append(a[0].shape[0]) or orig(*a))
    with torch.no_grad():
        want, _ = TLM.forward(params, tokens, cfg, return_features=True)
        n_mamba = len(rows)
        rows.clear()
        with sh.parallelism(sh.make_parallelism(
                _cpu_mesh((2, 1), ("data", "model")))):
            got, _ = TLM.forward(params, tokens, cfg, return_features=True)
    assert n_mamba == sum(d.mixer == "mamba" for d in cfg.group_layout)
    assert rows == [BATCH // 2] * (2 * n_mamba)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_recompute_keeps_the_mesh_context_on_another_thread():
    """The backward of CUDA tensors runs on autograd's device threads,
    where the caller's thread-local context is not set. A backward run on
    a thread of its own here: the recompute under remat still takes the
    expert-parallel path (else its saved tensors would not match the
    forward's) and gives the gradients of a backward on this thread."""
    cfg = _cfg("granite-moe-3b-a800m", 1.0)
    params = TLM.init_params(0, cfg, device="cpu")
    batch = _batch(cfg, 0)
    ctx = sh.make_parallelism(_cpu_mesh((2, 2), ("data", "model")))
    live = TO.tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = TO.tree_leaves(live)
    with sh.parallelism(ctx), torch.enable_grad():
        total, _ = TT.loss_fn(live, batch, cfg, 0.01)
    out = {}
    worker = threading.Thread(target=lambda: out.update(g=torch.autograd.grad(
        total, leaves, allow_unused=True)))
    worker.start()
    worker.join(120)
    assert not worker.is_alive() and "g" in out
    with sh.parallelism(ctx):
        want, _ = TT._value_and_grad(params, batch, cfg, 0.01)
    for g, w in zip(out["g"], TO.tree_leaves(want)):
        assert torch.equal(torch.zeros_like(w) if g is None else g, w)
