"""Subprocess entry for the port's placement tests: the JAX package's
side, under 4 fake host devices (set here, not globally).

  python tests/_torch_placement_runner.py OUT.pkl

For each case of :data:`CASES` (a reduced arch on a mesh), the train
state's ``NamedSharding`` of every leaf (``to_named_shardings`` of
``train_loop.state_specs``, as the JAX launcher places the state) and
``devices_indices_map(shape)``: for each device in the mesh's row-major
order, its index ranges, one ``(start, stop)`` a dimension. Leaves are
keyed by their checkpoint path (groups stacked on a leading axis).
"""
import os
import pickle
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
sys.path.insert(0, _SRC)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs  # noqa: E402
from repro.models import sharding as sh  # noqa: E402
from repro.training import checkpoint as ckpt  # noqa: E402
from repro.training import train_loop as tl  # noqa: E402

ARCHS = ("llama3.2-1b", "granite-moe-3b-a800m", "jamba-v0.1-52b")
MESHES = (((2, 2), ("data", "model")), ((2, 1, 2), ("pod", "data", "model")))
CASES = [(a, s, n) for a in ARCHS for s, n in MESHES]


def _ranges(index, shape):
    return tuple((0 if sl.start is None else sl.start,
                  n if sl.stop is None else sl.stop)
                 for sl, n in zip(index, shape))


def main(out):
    res = {}
    devs = np.array(jax.devices()[:4])
    for arch, shape, names in CASES:
        mesh = jax.sharding.Mesh(devs.reshape(shape), names)
        ctx = sh.make_parallelism(mesh)
        cfg = configs.get_config(arch).reduced()
        abstract = tl.abstract_state(cfg)
        shardings = sh.to_named_shardings(abstract, tl.state_specs(cfg), ctx)
        keys, avals, _ = ckpt._flatten_with_paths(abstract)
        _, shs, _ = ckpt._flatten_with_paths(shardings)
        case = {}
        for k, aval, s in zip(keys, avals, shs):
            imap = s.devices_indices_map(tuple(aval.shape))
            case[k] = {"shape": tuple(aval.shape),
                       "spec": tuple(s.spec),
                       "ranges": [_ranges(imap[d], aval.shape)
                                  for d in mesh.devices.flat]}
        res[(arch, shape)] = case
    with open(out, "wb") as f:
        pickle.dump(res, f)
    print("PLACEMENT_OK", len(res))


if __name__ == "__main__":
    main(sys.argv[1])
