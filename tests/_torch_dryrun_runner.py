"""Subprocess entry for the port's dry-run tests: the JAX package's side,
under 4 fake host devices (set here, not globally).

  python tests/_torch_dryrun_runner.py OUT.json [--gap]

Writes a JSON object:

- ``args``: ``memory_analysis().argument_size_in_bytes`` of the JAX
  dry-run's lowering of reduced llama3.2-1b at :data:`TRAIN` and
  :data:`DECODE` on a (2, 2) ("data", "model") mesh;
- ``dense``: the HLO walker's flops of the JAX train step of reduced
  llama3.2-1b at :data:`DENSE` on one device, all of them (``flops``)
  and the dots' alone (``dot_flops``: reductions renamed so the walker
  counts them as elementwise);
- ``wire``: the walker's per-participant wire of the histogram-form
  ``build_sharded_histogram_fit`` and (one iteration) the pixel-form
  ``build_sharded_fit`` on ``N_PIXELS`` pixels over the 4 devices, with
  their collective counts;
- ``cells``: the JAX dry-run's ``cells("all", "all")`` as (arch, shape).

It prints the dense, argument and wire numbers; with ``--gap`` also the
port's op counter's flops and bytes of the dense cell (the port's
dry-run on fake CPU tensors), for the gap between the two.
"""
import json
import os
import sys
import time

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
sys.path.insert(0, _SRC)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs  # noqa: E402
from repro.analysis import hlo_cost  # noqa: E402
from repro.core import distributed as D  # noqa: E402
from repro.core.fcm import FCMConfig  # noqa: E402
from repro.models import sharding as sh  # noqa: E402
from repro.training import train_loop as tl  # noqa: E402

TRAIN = configs.ShapeConfig("t", "train", 64, 8)
DECODE = configs.ShapeConfig("d", "decode", 96, 4)
DENSE = configs.ShapeConfig("dense", "train", 1024, 2)
N_PIXELS = 4096


def _mesh():
    kwargs = {}
    if hasattr(jax.sharding, "AxisType"):
        kwargs["axis_types"] = (jax.sharding.AxisType.Auto,) * 2
    return jax.make_mesh((2, 2), ("data", "model"), **kwargs)


def _walk(lowered, n, while_override=None):
    return hlo_cost.analyze_text(lowered.compile().as_text(), n,
                                 while_override)


def main(out_path):
    t0 = time.time()
    assert len(jax.devices()) == 4, jax.devices()
    # the dry-run module sets XLA_FLAGS for 512 devices at import; jax is
    # already initialized here, so that has no effect on this process
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as JD
    os.environ["XLA_FLAGS"] = saved
    cfg = configs.get_config("llama3.2-1b").reduced()
    mesh = _mesh()
    ctx = sh.make_parallelism(mesh)
    out = {"args": {}, "cells": [[a, s.name] for a, s in
                                 JD.cells("all", "all")]}
    with mesh, sh.parallelism(ctx):
        for shape in (TRAIN, DECODE):
            mem = JD.lower_cell(cfg, shape, mesh, ctx).compile() \
                .memory_analysis()
            out["args"][shape.kind] = float(mem.argument_size_in_bytes)

    astate = tl.abstract_state(cfg, JD.TRAIN_CFG)
    abatch = JD._abstract_batch(cfg, DENSE)
    text = jax.jit(tl.make_train_step(cfg, JD.TRAIN_CFG)).lower(
        astate, abatch).compile().as_text()
    dots = text.replace(" reduce(", " reduce_as_elementwise(")
    walk = hlo_cost.analyze_text(text, 1)
    out["dense"] = {
        "flops": walk.flops, "bytes": walk.bytes,
        "dot_flops": hlo_cost.analyze_text(dots, 1).flops}

    spec = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(("data", "model")))
    x = jax.ShapeDtypeStruct((N_PIXELS,), jnp.float32, sharding=spec)
    hist = _walk(D.build_sharded_histogram_fit(mesh, FCMConfig()).lower(
        x, x), 4)
    pix = _walk(D.build_sharded_fit(mesh, FCMConfig()).lower(x, x), 4,
                while_override=1)
    out["wire"] = {"histogram": hist.wire, "histogram_ops": hist.n_coll_ops,
                   "pixel": pix.wire, "pixel_ops": pix.n_coll_ops}
    out["seconds"] = time.time() - t0
    with open(out_path, "w") as f:
        json.dump(out, f)
    print(json.dumps({"dense": out["dense"], "args": out["args"],
                      "wire": out["wire"]}))


def port_gap():
    """The port's dry-run counts of the same cells, beside the JAX
    side's (``--gap``): the gap between the op counter and the walker."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch import configs as TC
    from repro_torch.launch import dryrun as TDR
    from repro_torch.models import sharding as TSH
    cfg = TC.get_config("llama3.2-1b").reduced()
    shape = TC.ShapeConfig(DENSE.name, DENSE.kind, DENSE.seq_len,
                           DENSE.global_batch)
    with FakeTensorMode():
        c, _, _ = TDR.cost_lm(cfg, shape, TSH.Parallelism(),
                              torch.device("cpu"))
    print(json.dumps({"port_dense": {"flops": c.costs.flops,
                                     "bytes": c.costs.bytes,
                                     "dot_flops": c.costs.dot_flops}}))


if __name__ == "__main__":
    main(sys.argv[1])
    if "--gap" in sys.argv[2:]:
        port_gap()
