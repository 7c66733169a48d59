"""Logical-axis sharding for the language models.

Parameters and activations carry *logical* axes, which a
:class:`Parallelism` resolves onto the axes of the port's
:class:`repro_torch.core.distributed.Mesh`:

  "fsdp"  -> ("pod", "data") (multi-pod) / ("data",): weight sharding
             over the batch axes
  "tp"    -> "model": tensor parallel (heads / d_ff / experts / vocab)
  "dp"    -> ("pod", "data"): batch sharding
  None    -> replicated

A resolved spec is a tuple with one entry a dimension (``None``, an axis
name or a tuple of names), the JAX package's ``PartitionSpec``; where
that package builds a ``NamedSharding`` for a leaf, the port keeps the
leaf's pruned spec (:func:`to_shardings`).

**One process, and the state on the lead device.** A mesh here is the
devices of one process (as in :mod:`repro_torch.core.distributed`). The
model's state lives whole on the mesh's lead device; the specs say how
it *would* split, and per-device storage of split parameters (FSDP / TP
storage) is not ported. What does run per shard is what the function
itself splits: the expert-parallel MoE dispatch (each (dp shard, tp
rank) on its device, :func:`repro_torch.models.moe.moe_ffn`), the
Mamba selective scan's dp shards, and the per-pod gradients of the
compressed cross-pod step. :func:`shard` is a layout hint and moves
nothing.

Without a mesh (one device) the context is empty and every annotation
is a no-op, so the same model code runs everywhere.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from contextlib import contextmanager, nullcontext
from typing import Dict, List, Optional, Tuple, Union

import torch

from ..core.distributed import Mesh

Logical = Union[str, Tuple[str, ...], None]
#: the axes of ``Mesh.axis_names`` that split the batch
BATCH_AXES = ("pod", "data", "replica")


@dataclasses.dataclass(frozen=True)
class Parallelism:
    mesh: Optional[Mesh] = None
    fsdp_axes: Tuple[str, ...] = ()
    tp_axis: Optional[str] = None
    dp_axes: Tuple[str, ...] = ()

    @property
    def tp_size(self) -> int:
        if self.mesh is None or self.tp_axis is None:
            return 1
        return axis_sizes(self.mesh)[self.tp_axis]

    def resolve(self, logical: Logical):
        """Logical axis name(s) -> the physical entry of a spec."""
        if logical is None:
            return None
        if isinstance(logical, tuple):
            out = []
            for name in logical:
                r = self.resolve(name)
                if r is None:
                    continue
                out.extend(r if isinstance(r, tuple) else (r,))
            return tuple(out) if out else None
        if logical == "fsdp":
            return self.fsdp_axes if self.fsdp_axes else None
        if logical == "tp":
            return self.tp_axis
        if logical == "dp":
            return self.dp_axes if self.dp_axes else None
        raise ValueError(f"unknown logical axis {logical!r}")

    def pspec(self, *logical: Logical) -> tuple:
        return _spec(self.resolve(name) for name in logical)


def _spec(entries) -> tuple:
    """A spec with each entry in the JAX package's ``PartitionSpec``
    form: a one-axis tuple as the bare axis name, an empty one as None."""
    return tuple(e if not isinstance(e, tuple) else
                 (e[0] if len(e) == 1 else (e or None)) for e in entries)


_STATE = threading.local()


def current() -> Parallelism:
    return getattr(_STATE, "ctx", None) or Parallelism()


@contextmanager
def parallelism(ctx: Parallelism):
    """Make ``ctx`` the calling thread's context for the block."""
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = ctx
    try:
        yield ctx
    finally:
        _STATE.ctx = prev


def checkpoint_context_fn():
    """A ``context_fn`` for ``torch.utils.checkpoint`` that runs the
    recompute under the context current at the forward. The backward of
    CUDA tensors runs on autograd's device threads, where the calling
    thread's context is not set; without it a recompute under a mesh
    would take the one-device path."""
    ctx = current()
    return lambda: (nullcontext(), parallelism(ctx))


def make_parallelism(mesh: Optional[Mesh]) -> Parallelism:
    """Infer the logical -> physical mapping from the mesh's axis names."""
    if mesh is None:
        return Parallelism()
    names = tuple(mesh.axis_names)
    batchy = tuple(n for n in names if n in BATCH_AXES)
    tp = "model" if "model" in names else None
    return Parallelism(mesh=mesh, fsdp_axes=batchy, tp_axis=tp,
                       dp_axes=batchy)


def axis_sizes(mesh: Mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))


def prune_spec(spec, shape, mesh: Mesh) -> tuple:
    """Drop mesh axes that do not evenly divide the corresponding dim
    (batch 1 on the dp axes, 24 heads on tp 16, vocab 49155). Axes are
    dropped left to right ("pod" before "data") until the rest divides."""
    sizes = axis_sizes(mesh)
    out = []
    for d, entry in enumerate(spec):
        if entry is None or d >= len(shape):
            out.append(entry)
            continue
        axes = list(entry if isinstance(entry, tuple) else (entry,))
        while axes and shape[d] % math.prod(sizes[a] for a in axes) != 0:
            axes.pop(0)
        out.append(tuple(axes))
    return _spec(out)


def shard(x: torch.Tensor, *logical: Logical) -> torch.Tensor:
    """The JAX package's activation sharding constraint. A layout hint:
    in the one-process model it moves nothing and returns ``x``."""
    return x


# --------------------------------------------------------------------------
# Shards of a mesh
# --------------------------------------------------------------------------

def _unravel(k: int, axes, sizes: Dict[str, int]) -> Dict[str, int]:
    """The row-major index ``k`` over ``axes`` as axis name -> index."""
    coords = {}
    for a in reversed(axes):
        coords[a] = k % sizes[a]
        k //= sizes[a]
    return coords


def device_at(mesh: Mesh, coords: Dict[str, int]) -> torch.device:
    """The device at ``coords`` (axis name -> index; an axis not named
    takes index 0) of ``mesh``'s row-major device grid."""
    flat = 0
    for name, size in zip(mesh.axis_names, mesh.shape):
        flat = flat * size + coords.get(name, 0)
    return mesh.devices[flat]


def dp_shards(ctx: Parallelism, n: int) -> List[Tuple[slice, Dict[str, int]]]:
    """A leading (batch or token) axis of ``n`` split as the pruned
    ``("dp",)`` spec says: ``(rows, coords)`` a shard in row-major order
    over the kept dp axes, ``coords`` their indices. One shard covering
    every row without a mesh or when no dp axis divides ``n``."""
    if ctx.mesh is None:
        return [(slice(0, n), {})]
    entry = prune_spec((ctx.resolve("dp"),), (n,), ctx.mesh)[0]
    axes = () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))
    sizes = axis_sizes(ctx.mesh)
    count = math.prod(sizes[a] for a in axes)
    per = n // count
    return [(slice(k * per, (k + 1) * per), _unravel(k, axes, sizes))
            for k in range(count)]


def sub_mesh(mesh: Mesh, axis: str, index: int) -> Mesh:
    """The mesh of the devices at ``index`` along ``axis``, without that
    axis (a pod's own ("data", "model") mesh)."""
    sizes = axis_sizes(mesh)
    rest = tuple(a for a in mesh.axis_names if a != axis)
    shape = tuple(sizes[a] for a in rest)
    devs = tuple(device_at(mesh, {axis: index, **_unravel(k, rest, sizes)})
                 for k in range(math.prod(shape)))
    return Mesh(devs, shape, rest)


# --------------------------------------------------------------------------
# Parameter trees with attached logical specs
# --------------------------------------------------------------------------

def _is_spec(s) -> bool:
    return isinstance(s, tuple)


def map_specs(fn, spec_tree, *rest):
    """``fn`` over the leaves of a spec tree (a leaf is a tuple), with
    the same leaves of the trees in ``rest`` (dicts and lists alike)."""
    if _is_spec(spec_tree):
        return fn(spec_tree, *rest)
    if isinstance(spec_tree, dict):
        if any(set(r) != set(spec_tree) for r in rest):
            raise ValueError(f"trees differ in keys: {sorted(spec_tree)}")
        return {k: map_specs(fn, v, *[r[k] for r in rest])
                for k, v in spec_tree.items()}
    if isinstance(spec_tree, list):
        if any(len(r) != len(spec_tree) for r in rest):
            raise ValueError("trees differ in list lengths")
        return [map_specs(fn, v, *[r[i] for r in rest])
                for i, v in enumerate(spec_tree)]
    raise TypeError(f"not a spec tree node: {spec_tree!r}")


def to_shardings(abstract_tree, spec_tree, ctx: Parallelism):
    """(tree of tensors, meta or real; tree of logical specs) -> a tree
    of pruned physical specs, ``None`` a leaf without a mesh: the
    counterpart of the JAX package's ``to_named_shardings``."""
    def conv(spec, leaf):
        if len(spec) != leaf.dim():
            raise ValueError(f"a spec of {len(spec)} dims for a leaf of "
                             f"shape {tuple(leaf.shape)}")
        if ctx.mesh is None:
            return None
        return prune_spec(ctx.pspec(*spec), tuple(leaf.shape), ctx.mesh)

    return map_specs(conv, spec_tree, abstract_tree)


def stack_spec(spec_tree):
    """Prepend a replicated leading (scan / stack) dim to every leaf spec."""
    return map_specs(lambda s: (None,) + s, spec_tree)
