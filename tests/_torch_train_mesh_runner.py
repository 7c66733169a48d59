"""Subprocess entry for the port's mesh-training tests: the JAX
package's side, under 8 fake host devices (set here, not globally).

  python tests/_torch_train_mesh_runner.py OUT.pkl [plans]

Writes a pickle of numpy values (with ``plans``, the first item alone):

- ``plan_mesh``: ``{(n_devices, model_parallel, pods): mesh shape}``
  from ``repro.training.elastic.plan_mesh``;
- ``cases``: for each case of :data:`CASES`, the initial parameters
  (``PRNGKey(0)``), each step's metrics, the state after the steps and
  (compressed cases) the first step's int8-mean gradients, from the
  JAX package's jitted train step
  on a mesh of the fake devices. Where that step fails (the compressed
  step on a mesh whose pod-local batch the pod and data axes both
  divide: a sharding constraint inside the manual-"pod" ``shard_map``
  names the manual axis), the case holds the composition the branch
  defines instead: per-pod ``_microbatch_grads`` with
  ``compressed_psum_mean`` under ``jax.vmap(axis_name="pod")``, then
  ``adamw_step``; ``"composed"`` says which.
"""
import os
import pickle
import sys
import time

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
sys.path.insert(0, _SRC)

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs  # noqa: E402
from repro.data import pipeline  # noqa: E402
from repro.models import sharding as sh  # noqa: E402
from repro.training import elastic  # noqa: E402
from repro.training import grad_compress as gc  # noqa: E402
from repro.training import optimizer as opt  # noqa: E402
from repro.training import train_loop as tl  # noqa: E402

BATCH, SEQ, STEPS = 4, 64, 2

#: name -> (arch, mesh shape, axis names, compress_cross_pod, capacity
#: factor or None for the reduced config's)
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


def case_config(arch, capacity_factor):
    cfg = configs.get_config(arch).reduced()
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return cfg


def train_config(compress):
    """The default optimizer (its warmup's small learning rate: at a
    full one AdamW moves a leaf whose gradient is rounding noise by about
    lr, and the packages would part on those leaves alone)."""
    return tl.TrainConfig(compress_cross_pod=compress)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(cfg, i):
    shape = configs.ShapeConfig("t", "train", SEQ, BATCH)
    return {k: jnp.asarray(v)
            for k, v in pipeline.make_batch(cfg, shape, i).items()}


def composed_grads(params, batch, cfg, tcfg, pods):
    mb = jax.tree_util.tree_map(
        lambda x: x.reshape((pods, x.shape[0] // pods) + x.shape[1:]), batch)

    def per_pod(b):
        g, m = tl._microbatch_grads(params, b, cfg, tcfg)
        g = gc.compressed_psum_mean(g, "pod")
        m = jax.tree_util.tree_map(lambda v: jax.lax.pmean(v, "pod"), m)
        return g, m

    g, m = jax.vmap(per_pod, axis_name="pod")(mb)
    return (jax.tree_util.tree_map(lambda x: x[0], g),
            jax.tree_util.tree_map(lambda x: x[0], m))


def composed_step(state, batch, cfg, tcfg, pods):
    g, m = composed_grads(state["params"], batch, cfg, tcfg, pods)
    params, opt_state, om = opt.adamw_step(state["params"], g, state["opt"],
                                           state["step"], tcfg.optimizer)
    return ({"params": params, "opt": opt_state, "step": state["step"] + 1},
            dict(m, **om))


def run_case(name):
    arch, shape, axes, compress, cf = CASES[name]
    cfg = case_config(arch, cf)
    tcfg = train_config(compress)
    n = int(np.prod(shape))
    mesh = jax.sharding.Mesh(
        np.array(jax.devices()[:n]).reshape(shape), axes,
        axis_types=(jax.sharding.AxisType.Auto,) * len(axes))
    init = tl.init_state(jax.random.PRNGKey(0), cfg, tcfg)
    out = {"params0": _np(init["params"]), "composed": False}
    pods = dict(zip(axes, shape)).get("pod", 1)
    if compress:
        g, _ = jax.jit(lambda p, b: composed_grads(p, b, cfg, tcfg, pods))(
            init["params"], _batch(cfg, 0))
        out["grads0"] = _np(g)
    ctx = sh.make_parallelism(mesh)
    metrics = []
    try:
        with sh.parallelism(ctx):
            shard = sh.to_named_shardings(tl.abstract_state(cfg, tcfg),
                                          tl.state_specs(cfg), ctx)
            state = jax.tree_util.tree_map(jax.device_put, init, shard)
            fn = jax.jit(tl.make_train_step(cfg, tcfg))
            for i in range(STEPS):
                state, m = fn(state, _batch(cfg, i))
                metrics.append(_np(m))
    except ValueError:
        if not compress:
            raise
        out["composed"] = True
        state, metrics = init, []
        fn = jax.jit(lambda s, b: composed_step(s, b, cfg, tcfg, pods))
        for i in range(STEPS):
            state, m = fn(state, _batch(cfg, i))
            metrics.append(_np(m))
    out["metrics"] = metrics
    out["state"] = _np(state)
    return out


def main():
    assert len(jax.devices()) == 8, jax.devices()
    plans = {}
    for n in range(1, 9):
        for tp in (None, 1, 2):
            for pods in (1, 2):
                if n // pods < (tp or 1):
                    continue
                plans[(n, tp, pods)] = tuple(
                    elastic.plan_mesh(n, tp, pods).devices.shape)
    cases = {}
    for name in (CASES if sys.argv[2:] != ["plans"] else ()):
        t0 = time.perf_counter()
        cases[name] = run_case(name)
        print(f"{name}: {time.perf_counter() - t0:.1f} s")
    with open(sys.argv[1], "wb") as f:
        pickle.dump({"plan_mesh": plans, "cases": cases}, f)
    print("TRAIN_MESH_OK")


if __name__ == "__main__":
    main()
