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

**One process; the state stored split across the mesh.** A mesh here
is the devices of one process (as in :mod:`repro_torch.core.distributed`).
:func:`place` is the JAX package's ``device_put(x, NamedSharding(mesh,
spec))``: each leaf becomes a :class:`Placed`, one block a mesh slot, the
block that the leaf's pruned physical spec gives the slot's coordinates,
on ``mesh.devices[k]``; a leaf is replicated over the axes its spec does
not name (slots that name one device and hold the same block share its
tensor). :func:`gather` is the parameter all-gather of FSDP / TP storage:
an autograd function whose forward assembles the whole leaf (or a region
of it) on one device and whose backward cuts the gradient into each
slot's block on that slot's device, the reduce-scatter; both report
their wire to a cost counter. The model gathers a group's parameters at
the start of the group's body, so no gathered group outlives its use.
Compute runs on the mesh's lead device, where the activations live; what
the function itself splits runs per shard: the expert-parallel MoE
dispatch (each (dp shard, tp rank) on its device, from its own slot's
expert blocks, :func:`repro_torch.models.moe.moe_ffn`), the Mamba
selective scan's dp shards, and the per-pod gradients of the compressed
cross-pod step. A plain (unplaced) tree still runs under a mesh, whole
on the lead device. :func:`shard` is a layout hint and moves nothing.

Without a mesh (one device) the context is empty and every annotation
is a no-op, so the same model code runs everywhere.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import math
import threading
import weakref
from contextlib import contextmanager, nullcontext
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from ..analysis import op_cost
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

    def sharding(self, *logical: Logical) -> Optional["NamedSharding"]:
        """The JAX package's ``NamedSharding(mesh, pspec(*logical))``;
        ``None`` without a mesh."""
        if self.mesh is None:
            return None
        return NamedSharding(self.mesh, self.pspec(*logical), logical)


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
    of pruned physical specs, ``None`` a leaf without a mesh: the specs
    of :func:`to_named_shardings`."""
    return map_specs(lambda _, s: None if s is None else s.spec, spec_tree,
                     to_named_shardings(abstract_tree, spec_tree, ctx))


def stack_spec(spec_tree):
    """Prepend a replicated leading (scan / stack) dim to every leaf spec."""
    return map_specs(lambda s: (None,) + s, spec_tree)


# --------------------------------------------------------------------------
# Storage split across a mesh (FSDP / TP storage)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a physical spec: the JAX package's ``NamedSharding``.
    ``logical`` is the logical spec it was resolved from, kept so that a
    placed leaf can be placed again on another mesh (a pod's sub-mesh)."""
    mesh: Mesh
    spec: tuple
    logical: Optional[tuple] = None


def _axes_of(entry) -> Tuple[str, ...]:
    return () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))


def _full_spec(spec, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


def _grid(spec, mesh: Mesh) -> Tuple[int, ...]:
    """Blocks along each dimension."""
    sizes = axis_sizes(mesh)
    return tuple(math.prod(sizes[a] for a in _axes_of(e)) for e in spec)


@functools.lru_cache(maxsize=None)
def _coords(mesh: Mesh) -> Tuple[Dict[str, int], ...]:
    """Each slot's coordinates, axis name -> index."""
    sizes = axis_sizes(mesh)
    return tuple(_unravel(k, mesh.axis_names, sizes)
                 for k in range(mesh.size))


@functools.lru_cache(maxsize=None)
def _cells(spec, mesh: Mesh) -> Tuple[Tuple[int, ...], ...]:
    """Each slot's block index along each dimension: the row-major index
    of its coordinates over the axes of the dimension's entry (the first
    axis named the major one), as a ``NamedSharding`` lays out its
    ``devices_indices_map``."""
    sizes = axis_sizes(mesh)
    out = []
    for coords in _coords(mesh):
        cell = []
        for e in spec:
            i = 0
            for a in _axes_of(e):
                i = i * sizes[a] + coords[a]
            cell.append(i)
        out.append(tuple(cell))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _n_blocks(spec, mesh: Mesh) -> int:
    return len(set(zip(_cells(spec, mesh), mesh.devices)))


@dataclasses.dataclass(eq=False)
class Placed:
    """A leaf stored split across ``sharding.mesh``: ``blocks[k]`` is
    slot ``k``'s block, on ``mesh.devices[k]``, the block the pruned
    ``sharding.spec`` gives the slot's coordinates. ``shape`` and
    ``dtype`` are the whole leaf's. Slots that name one device and hold
    the same block share its tensor; ``tensors()`` lists each tensor
    once, in slot order."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    sharding: NamedSharding
    blocks: Tuple[torch.Tensor, ...]

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def spec(self) -> tuple:
        return self.sharding.spec

    def dim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        return math.prod(self.shape)

    def cell(self, k: int) -> Tuple[int, ...]:
        return _cells(self.spec, self.mesh)[k]

    def block_shape(self) -> Tuple[int, ...]:
        return tuple(s // g for s, g in
                     zip(self.shape, _grid(self.spec, self.mesh)))

    def slot_bytes(self, k: int) -> int:
        b = self.blocks[k]
        return b.numel() * b.element_size()

    def _firsts(self) -> List[int]:
        """The first slot holding each distinct tensor."""
        seen, out = set(), []
        for k, b in enumerate(self.blocks):
            if id(b) not in seen:
                seen.add(id(b))
                out.append(k)
        return out

    def tensors(self) -> List[torch.Tensor]:
        return [self.blocks[k] for k in self._firsts()]

    def n_blocks(self) -> int:
        """The blocks the placement stores, one a distinct (cell,
        device) pair: ``len(tensors())`` for real tensors, more where one
        fake tensor stands for a device's blocks."""
        return _n_blocks(self.spec, self.mesh)

    def stands_for(self) -> float:
        """Blocks each of :meth:`tensors` stands for (1 but for fakes)."""
        return self.n_blocks() / len(self._firsts())

    def with_tensors(self, ts) -> "Placed":
        """The same placement over new tensors, ``ts`` in
        :meth:`tensors`' order (same block shapes)."""
        ts = list(ts)
        firsts = self._firsts()
        by_id = {id(self.blocks[k]): t for k, t in zip(firsts, ts)}
        return Placed(self.shape, ts[0].dtype, self.sharding,
                      tuple(by_id[id(b)] for b in self.blocks))

    def cells(self) -> Dict[Tuple[int, ...], torch.Tensor]:
        """One tensor a distinct block (the first slot's that holds it)."""
        out: Dict[Tuple[int, ...], torch.Tensor] = {}
        for c, b in zip(_cells(self.spec, self.mesh), self.blocks):
            out.setdefault(c, b)
        return out


def is_placed(x) -> bool:
    return isinstance(x, Placed)


def lead_device(x) -> torch.device:
    """Where a leaf's compute runs: a placed leaf's mesh's lead device,
    a tensor's own device."""
    return x.mesh.lead if isinstance(x, Placed) else x.device


def _piece(src: Placed, ranges, dev, cells) -> torch.Tensor:
    """``src``'s elements in ``ranges`` (one (start, stop) a dimension) on
    ``dev``, cut from the blocks that cover them."""
    bshape = src.block_shape()
    per_dim = [range(a // b, (z - 1) // b + 1) if z > a else range(0)
               for (a, z), b in zip(ranges, bshape)]

    def build(d, idx):
        if d == len(ranges):
            blk = cells[tuple(idx)]
            sl = tuple(slice(max(a, i * b) - i * b, min(z, (i + 1) * b) - i * b)
                       for (a, z), b, i in zip(ranges, bshape, idx))
            return blk[sl].to(dev)
        parts = [build(d + 1, idx + [i]) for i in per_dim[d]]
        return parts[0] if len(parts) == 1 else torch.cat(parts, d)

    return build(0, [])


def _fresh(x: torch.Tensor, dev) -> torch.Tensor:
    """A contiguous copy of ``x`` on ``dev`` in storage of its own."""
    return torch.empty(tuple(x.shape), dtype=x.dtype, device=dev).copy_(x)


def put(x, sharding: Optional[NamedSharding]):
    """``x`` (a tensor anywhere, or a :class:`Placed` on any mesh) stored
    as ``sharding`` says: the JAX package's ``jax.device_put(x,
    sharding)``. The spec is pruned for ``x``'s shape. A leaf already
    placed so is returned as it is. ``sharding=None``: the whole tensor
    (on the source mesh's lead device for a placed leaf)."""
    if sharding is None:
        return whole(x, x.mesh.lead) if isinstance(x, Placed) else x
    mesh = sharding.mesh
    shape = tuple(int(s) for s in x.shape)
    spec = prune_spec(_full_spec(sharding.spec, len(shape)), shape, mesh)
    target = NamedSharding(mesh, spec, sharding.logical)
    if isinstance(x, Placed) and x.mesh == mesh and x.spec == spec:
        return x if x.sharding == target else Placed(x.shape, x.dtype,
                                                     target, x.blocks)
    src_t = x.tensors()[0] if isinstance(x, Placed) else x
    # fake tensors have no values: one block a device stands for all
    fake = op_cost.is_fake(src_t)
    cells = x.cells() if isinstance(x, Placed) else None
    bshape = [s // g for s, g in zip(shape, _grid(spec, mesh))]
    made: Dict[Any, torch.Tensor] = {}
    blocks = []
    with torch.no_grad():
        for cell, dev in zip(_cells(spec, mesh), mesh.devices):
            key = dev if fake else (cell, dev)
            if key not in made:
                ranges = [(c * b, (c + 1) * b) for c, b in zip(cell, bshape)]
                if cells is None:
                    part = x[tuple(slice(a, z) for a, z in ranges)]
                else:
                    part = _piece(x, ranges, dev, cells)
                made[key] = _fresh(part, dev)
            blocks.append(made[key])
    return Placed(shape, x.dtype, target, tuple(blocks))


def whole(x, device=None) -> torch.Tensor:
    """A placed leaf assembled whole on ``device`` (default its mesh's
    lead device), outside autograd; a tensor moved to ``device``."""
    if not isinstance(x, Placed):
        return x if device is None else x.to(device)
    dev = x.mesh.lead if device is None else torch.device(device)
    with torch.no_grad():
        return _piece(x, [(0, s) for s in x.shape], dev, x.cells())


def to_named_shardings(abstract_tree, spec_tree, ctx: Parallelism):
    """(tree of tensors, meta or real; tree of logical specs) -> a tree
    of :class:`NamedSharding`, pruned for each leaf's shape (``None``
    leaves without a mesh): the JAX package's ``to_named_shardings``."""
    def conv(spec, leaf):
        if len(spec) != leaf.dim():
            raise ValueError(f"a spec of {len(spec)} dims for a leaf of "
                             f"shape {tuple(leaf.shape)}")
        if ctx.mesh is None:
            return None
        return NamedSharding(ctx.mesh, prune_spec(
            ctx.pspec(*spec), tuple(leaf.shape), ctx.mesh), spec)

    return map_specs(conv, spec_tree, abstract_tree)


def place(tree, spec_tree, ctx: Parallelism):
    """Every leaf of ``tree`` stored as its logical spec in ``spec_tree``
    resolves and prunes on ``ctx``'s mesh (:func:`put` of each leaf's
    :func:`to_named_shardings` entry, which checks each spec against its
    leaf's rank); whole tensors without a mesh. The source leaves may be
    whole or placed on another mesh."""
    shardings = to_named_shardings(tree, spec_tree, ctx)
    if ctx.mesh is None and not any(isinstance(x, Placed)
                                    for x in leaves_of(tree)):
        return tree
    return map_specs(lambda _, leaf, where: put(leaf, where), spec_tree,
                     tree, shardings)


def leaves_of(tree) -> list:
    """The leaves (tensors and placed leaves) of nested dicts and lists."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves_of(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves_of(v)]
    return [tree]


def stored_bytes(tree, k: int) -> int:
    """Bytes slot ``k`` stores of ``tree``'s placed leaves."""
    return sum(x.slot_bytes(k) for x in leaves_of(tree)
               if isinstance(x, Placed))


def tensors_of(x) -> List[torch.Tensor]:
    """A leaf's tensors: a placed leaf's distinct blocks, else itself."""
    return x.tensors() if isinstance(x, Placed) else [x]


def blockwise(fn, *xs):
    """``fn`` over the leaves ``xs`` slot by slot, each call on the
    slot's blocks on the slot's device; ``fn(*xs)`` for plain tensors.
    The leaves share one placement. Returns a placed leaf, or a tuple of
    them where ``fn`` returns a tuple. A counter counts a call a stored
    block (:meth:`Placed.n_blocks`), its results too, so a fake leaf's
    one tensor a device counts as the blocks it stands for; a dry-run's
    counter runs one call for all (:func:`op_cost.each`)."""
    if not isinstance(xs[0], Placed):
        return fn(*xs)
    firsts = xs[0]._firsts()
    outs = op_cost.each(len(firsts), lambda i: fn(
        *(x.blocks[firsts[i]] for x in xs)), counted=xs[0].n_blocks())
    if isinstance(outs[0], tuple):
        return tuple(xs[0].with_tensors([o[j] for o in outs])
                     for j in range(len(outs[0])))
    return xs[0].with_tensors(outs)


def index0(x, i: int):
    """Entry ``i`` of a leaf's leading (stack) axis, which no mesh axis
    splits: a placed leaf stays placed."""
    if not isinstance(x, Placed):
        return x[i]
    if x.spec and x.spec[0] is not None:
        raise ValueError(f"the leading axis of a leaf placed as {x.spec} "
                         f"is split")
    lg = x.sharding.logical
    sharding = NamedSharding(x.mesh, x.spec[1:],
                             None if lg is None else tuple(lg[1:]))
    firsts = x._firsts()
    new = {id(x.blocks[k]): x.blocks[k][i] for k in firsts}
    return Placed(x.shape[1:], x.dtype, sharding,
                  tuple(new[id(b)] for b in x.blocks))


def restrict(x, ctx: Parallelism):
    """A placed leaf placed again on ``ctx``'s mesh by its logical spec
    (a pod's sub-mesh); a tensor as it is."""
    if not isinstance(x, Placed):
        return x
    if x.sharding.logical is None:
        raise ValueError("a leaf placed without its logical spec cannot "
                         "move to another mesh")
    return put(x, ctx.sharding(*x.sharding.logical))


# -- the gather: the parameter all-gather and its reduce-scatter -------------

class _Live:
    """Counts the gathered tensors still alive (the no-fallback check:
    no gathered group outlives its use)."""

    def __init__(self):
        self.n = 0
        self._lock = threading.Lock()

    def add(self, t: torch.Tensor):
        with self._lock:
            self.n += 1
        weakref.finalize(t, self._dec)

    def _dec(self):
        with self._lock:
            self.n -= 1


_LIVE = _Live()


def live_gathers() -> int:
    """Gathered tensors (outputs of :func:`gather`) still referenced."""
    return _LIVE.n


@dataclasses.dataclass
class _Plan:
    counts: Tuple[int, ...]          # region cells along each dimension
    lo: Tuple[int, ...]              # its first cell along each dimension
    bshape: Tuple[int, ...]
    rep: List[int]                   # input index of each region cell
    cell_of: List[Tuple[int, ...]]   # each input's cell in the region
    devs: List[torch.device]
    device: torch.device
    report: Tuple[int, float, int]   # group size, bytes, replica groups
    stands: float                    # blocks an input tensor stands for


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan: _Plan, *ts):
        ctx.plan = plan
        ctx.standing = ts if plan.stands > 1 else ()
        n, nbytes, groups = plan.report
        if n > 1:
            op_cost.collective("all-gather", nbytes * groups, n)
        moved = {i: ts[i] if ts[i].device == plan.device
                 else ts[i].to(plan.device) for i in set(plan.rep)}
        if len(plan.rep) == 1:
            return moved[plan.rep[0]]
        nd = len(plan.counts)
        x = torch.stack([moved[i] for i in plan.rep]).view(
            *plan.counts, *plan.bshape)
        perm = [p for d in range(nd) for p in (d, nd + d)]
        return x.permute(*perm).reshape(
            *(c * b for c, b in zip(plan.counts, plan.bshape)))

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        n, nbytes, groups = plan.report
        if n > 1:
            op_cost.collective("reduce-scatter", nbytes * groups, n)
        # autograd sums the gradients of a leaf gathered more than once,
        # one add a block: a tensor standing for several takes one add
        # for all of them, so the rest are charged here
        counter = op_cost.active()
        for t in ctx.standing:
            if counter is not None and getattr(t, "_gathered_grads", 0):
                counter.add_bytes("add", 3.0 * (plan.stands - 1)
                                  * t.numel() * t.element_size())
            t._gathered_grads = getattr(t, "_gathered_grads", 0) + 1
        nd = len(plan.counts)
        if len(plan.rep) == 1:
            return (None,) + tuple(g.to(d) for d in plan.devs)
        inter = [v for c, b in zip(plan.counts, plan.bshape) for v in (c, b)]
        perm = list(range(0, 2 * nd, 2)) + list(range(1, 2 * nd, 2))
        parts = g.reshape(*inter).permute(*perm).contiguous().view(
            *plan.counts, *plan.bshape)
        return (None,) + tuple(parts[c].to(d) for c, d in
                               zip(plan.cell_of, plan.devs))


def gather(x, device, keep: Optional[Dict[str, int]] = None,
           share: float = 1.0):
    """A placed leaf assembled on ``device`` under autograd (FSDP / TP's
    parameter all-gather); its backward cuts the gradient into each
    slot's block on that slot's device (the reduce-scatter). With
    ``keep`` (axis name -> index) only the slots at those coordinates
    take part: the region they hold, whole along the dimensions the
    other axes split (a tp rank's experts gathered over the fsdp axes).
    Each spec entry must name only kept axes or none. A plain tensor is
    returned as it is.

    A cost counter sees one ``all-gather`` (and, in the backward, one
    ``reduce-scatter``) of a block's bytes a participant over the
    region's blocks, for each replica group of the region's slots;
    ``share`` scales the bytes (a group gathered once for several
    callers)."""
    if not isinstance(x, Placed):
        return x
    keep = keep or {}
    dev = torch.device(device)
    spec, mesh = x.spec, x.mesh
    grid = _grid(spec, mesh)
    sizes = axis_sizes(mesh)
    counts, lo = [], []
    for e, g in zip(spec, grid):
        axes = _axes_of(e)
        kept = [a for a in axes if a in keep]
        if kept and len(kept) != len(axes):
            raise ValueError(f"entry {e!r} mixes kept and gathered axes")
        if kept:
            i = 0
            for a in axes:
                i = i * sizes[a] + keep[a]
            counts.append(1)
            lo.append(i)
        else:
            counts.append(g)
            lo.append(0)
    coords = _coords(mesh)
    region = [k for k in range(mesh.size)
              if all(coords[k][a] == i for a, i in keep.items())]
    inputs, index, cell_of, devs = [], {}, [], []
    by_cell: Dict[Tuple[int, ...], List[int]] = {}
    cells = _cells(spec, mesh)
    for k in region:
        b = x.blocks[k]
        c = tuple(ci - l for ci, l in zip(cells[k], lo))
        if id(b) not in index:
            index[id(b)] = len(inputs)
            inputs.append(b)
            cell_of.append(c)
            devs.append(b.device)
        by_cell.setdefault(c, []).append(index[id(b)])
    rep = []
    for c in itertools.product(*(range(n) for n in counts)):
        cand = by_cell[c]
        on = [i for i in cand if devs[i] == dev]
        rep.append((on or cand)[0])
    n = math.prod(counts)
    bshape = x.block_shape()
    nbytes = math.prod(bshape) * x.blocks[0].element_size() * share
    plan = _Plan(tuple(counts), tuple(lo), bshape, rep, cell_of, devs, dev,
                 (n, nbytes, max(1, len(region) // n)), x.stands_for())
    out = _Gather.apply(plan, *inputs)
    _LIVE.add(out)
    return out
