"""Op-level cost accounting of a step, eager or on fake tensors.

The port has no HLO: a step is the aten ops PyTorch dispatches. A
:class:`CostCounter` is a ``TorchDispatchMode`` that sees each of them,
on real tensors or on fake ones
(``torch._subclasses.fake_tensor.FakeTensorMode``, which runs a step of
any size with no memory behind it), and keeps the JAX package's rules
(its ``analysis/hlo_cost.py``):

  flops -- 2*prod(out)*prod(contracting) for every matmul (``mm``,
           ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``dot``: einsum and
           linear reach these); reductions 1 flop an input element;
           elementwise ops nothing
  bytes -- operands plus result of every op that moves data. Each eager
           op is its own kernel, so this is HBM traffic at kernel
           boundaries, as XLA's fusion boundaries are there. Views,
           metadata ops and ``empty`` move nothing. A hand-written kernel
           reports its inputs and outputs (:func:`kernel_io`) and no
           flops, as the walker counts a Pallas custom-call.
  wire  -- what the port's own mesh operations move: each reports its
           kind, per-participant bytes and group size (:func:`collective`)
           and the counter adds ``bytes * ring multiplier * group size``
           (global wire), the JAX package's ``_WIRE_MULT``.

Beside the costs it keeps the live bytes of the storages the step
allocates, and their peak (``temp`` and ``out`` of a memory analysis).

**Loops.** The JAX walker multiplies a scan body by its trip count. A
loop of trips that cost the same takes a :func:`repeat`: under a counter
made with ``scale_loops=True`` it runs one trip with the counts weighted
by the trip count (its gradient too, with the eager backward's
accumulation of each trip's gradient of an input every trip reads), and
:meth:`Repeat.fill` stands the one trip's output in for all of them,
uncounted. Elsewhere it runs every
trip and changes nothing. A scaled loop's live memory is one trip's.
:func:`each` is the form for calls whose results all outlive them (a
placed leaf's blocks): one call stands for all, counted as many times,
and what it leaves alive is charged to live memory as many times.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import weakref
from typing import Dict, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_WIRE_MULT = {
    "all-reduce": lambda n: 2.0 * (n - 1) / max(n, 1),
    "all-gather": lambda n: float(n - 1) / max(n, 1),
    "reduce-scatter": lambda n: float(n - 1) / max(n, 1),
    "all-to-all": lambda n: float(n - 1) / max(n, 1),
    "collective-permute": lambda n: 1.0,
}
COLLECTIVES = tuple(_WIRE_MULT)


def wire_bytes(kind: str, nbytes: float, n: int) -> float:
    """Wire bytes a participant sends for ``kind`` over a group of ``n``
    with ``nbytes`` of operand each (ring algorithms)."""
    return nbytes * _WIRE_MULT[kind](n)


#: ops that move no data: views, metadata, uninitialized allocations
_FREE = {
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand",
    "expand_as", "permute", "transpose", "t", "slice", "select",
    "unsqueeze", "squeeze", "as_strided", "alias", "detach", "split",
    "split_with_sizes", "chunk", "unbind", "diagonal", "narrow",
    "view_as", "view_as_real", "view_as_complex", "lift_fresh",
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "_local_scalar_dense", "resize", "set",
    "sym_size", "sym_stride", "sym_numel", "is_same_size", "unfold",
    "movedim", "swapaxes", "flatten", "unflatten", "contiguous",
}

#: reductions: 1 flop an input element
_REDUCE = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "argmax",
    "argmin", "any", "all", "var", "std", "var_mean", "std_mean",
    "norm", "linalg_vector_norm", "logsumexp", "cumsum", "cumprod",
    "_softmax", "_log_softmax", "nansum", "count_nonzero",
}


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _tensors(e)]
    if isinstance(x, dict):
        return [t for e in x.values() for t in _tensors(e)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _matmul_flops(name: str, args) -> float:
    if name in ("mm", "bmm"):
        a, b = args[0], args[1]
    elif name in ("addmm", "baddbmm", "addbmm"):
        a, b = args[1], args[2]
    elif name in ("mv", "addmv"):
        a = args[0] if name == "mv" else args[1]
        return 2.0 * a.numel()
    elif name in ("dot", "vdot"):
        return 2.0 * args[0].numel()
    else:
        return 0.0
    # (.., n, k) @ (.., k, m): 2 * batch * n * m * k
    return 2.0 * a.numel() * b.shape[-1]


_MATMULS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv",
            "dot", "vdot"}


@dataclasses.dataclass
class Costs:
    """Counts of one traced step, global (every shard's work)."""
    flops: float = 0.0
    dot_flops: float = 0.0
    bytes: float = 0.0
    kernel_bytes: float = 0.0
    wire_by_kind: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})
    n_coll_ops: int = 0
    n_ops: int = 0
    n_kernels: int = 0
    #: aten op name -> [calls, bytes, flops] (calls unweighted)
    by_op: Dict[str, list] = dataclasses.field(default_factory=dict)

    @property
    def wire(self) -> float:
        return sum(self.wire_by_kind.values())


_ACTIVE: List["CostCounter"] = []
_ACTIVE_LOCK = threading.Lock()


def active() -> Optional["CostCounter"]:
    """The innermost counter in use, on any thread (the backward of card
    tensors runs on autograd's own threads), else ``None``."""
    return _ACTIVE[-1] if _ACTIVE else None


class CostCounter(TorchDispatchMode):
    """Counts the aten ops of the block it is entered around (see the
    module docstring); ``scale_loops`` turns on :func:`repeat`'s one-trip
    form, for a dry-run on fake tensors."""

    def __init__(self, *, scale_loops: bool = False):
        super().__init__()
        self.costs = Costs()
        self.scale_loops = scale_loops
        self.weight = 1.0
        self.live = 0
        self.peak = 0
        self._paused = 0
        self._storages: Dict[int, tuple] = {}
        self._made: Optional[list] = None   # keys tracked in standing_for
        self._lock = threading.RLock()

    def __enter__(self):
        with _ACTIVE_LOCK:
            _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            with _ACTIVE_LOCK:
                _ACTIVE.remove(self)

    @contextlib.contextmanager
    def paused(self):
        """Ops in the block cost nothing (their allocations still count
        toward live memory)."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    # -- memory ---------------------------------------------------------

    def _track(self, outs, ins):
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._storages:
                continue
            seen.add(key)
            nb = st.nbytes()

            def freed(_ref, key=key, counter=self):
                with counter._lock:
                    entry = counter._storages.pop(key, None)
                    if entry is not None:
                        counter.live -= entry[0]

            with self._lock:
                self._storages[key] = (nb, weakref.ref(st, freed))
                if self._made is not None:
                    self._made.append(key)
                self.live += nb
                self.peak = max(self.peak, self.live)

    @contextlib.contextmanager
    def standing_for(self, factor: float):
        """The block's ops stand for ``factor`` copies of themselves:
        counted ``factor`` times, and the storages they allocate that
        outlive the block charged ``factor`` times to live memory."""
        outer, self._made = self._made, []
        self.weight *= factor
        try:
            yield
        finally:
            self.weight /= factor
            with self._lock:
                made, self._made = self._made, outer
                for key in set(made):
                    entry = self._storages.get(key)
                    if entry is not None:
                        self._storages[key] = (entry[0] * factor, entry[1])
                        self.live += entry[0] * (factor - 1)
                self.peak = max(self.peak, self.live)
                if outer is not None:
                    outer.extend(made)

    # -- dispatch -------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__.rstrip("_")
        ins = _tensors(args) + _tensors(kwargs)
        outs = _tensors(out)
        self._track(outs, ins)
        if name in _FREE or self._paused or not outs:
            return out              # metadata (e.g. prim.device): no data
        w = self.weight
        c = self.costs
        c.n_ops += 1
        nb = w * (sum(_nbytes(t) for t in ins)
                  + sum(_nbytes(t) for t in outs))
        f = 0.0
        if name in _MATMULS:
            f = w * _matmul_flops(name, args)
            c.dot_flops += f
        elif name in _REDUCE and ins:
            f = w * ins[0].numel()
        c.bytes += nb
        c.flops += f
        row = c.by_op.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += nb
        row[2] += f
        return out

    # -- reports from the port's own code --------------------------------

    def add_kernel(self, reads: Sequence, writes: Sequence):
        if self._paused:
            return
        nb = (sum(_nbytes(t) for t in _tensors(list(reads)))
              + sum(_nbytes(t) for t in _tensors(list(writes))))
        self.costs.bytes += self.weight * nb
        self.costs.kernel_bytes += self.weight * nb
        self.costs.n_kernels += 1

    def add_bytes(self, name: str, nb: float):
        """Bytes of ops the run performs but the counter does not see,
        charged to aten op ``name`` at the current weight."""
        if self._paused or not nb:
            return
        nb *= self.weight
        self.costs.bytes += nb
        self.costs.by_op.setdefault(name, [0, 0.0, 0.0])[1] += nb

    def add_collective(self, kind: str, nbytes: float, n: int):
        if self._paused:
            return
        self.costs.wire_by_kind[kind] += (self.weight * n
                                          * wire_bytes(kind, nbytes, n))
        self.costs.n_coll_ops += 1


def is_fake(t) -> bool:
    """True for a tensor of ``FakeTensorMode`` (no memory behind it)."""
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def kernel_io(reads: Sequence, writes: Sequence) -> bool:
    """Report a hand-written kernel's call to the active counter: its
    inputs and outputs once each, no flops. Returns True when the call
    must not launch: its tensors are fake, and the outputs already
    allocated stand for the kernel's."""
    c = active()
    if c is not None:
        c.add_kernel(reads, writes)
    return any(is_fake(t) for t in _tensors(list(reads)))


def collective(kind: str, nbytes: float, n: int) -> None:
    """Report one collective of the port's mesh (a no-op without an
    active counter): ``kind`` of ``COLLECTIVES``, ``nbytes`` a
    participant, over a group of ``n``."""
    c = active()
    if c is not None:
        c.add_collective(kind, nbytes, n)


class _ScaledLoop(torch.autograd.Function):
    """One trip of a loop standing for ``factor``: the forward counts
    ``factor`` times; the backward recomputes the trip uncounted and
    counts its gradient ``factor`` times. The weight is set around each
    pass explicitly, so the count does not depend on the order the
    autograd engine runs nodes in, nor on a recompute under
    ``torch.utils.checkpoint``.

    The eager loop's backward also adds each trip's gradient of an input
    that every trip reads (a walked input's ``x[:, t]`` gives a gradient
    of ``x``'s full size a trip) into one gradient: ``factor - 1``
    full-size adds of read, read, write, which one trip never performs.
    The backward charges them for each such input that needs a gradient
    (``reads - 1`` adds for an input only ``reads`` of the trips read).
    The last ``carries`` inputs are the loop's carries, read by the first
    trip only; every later trip takes their gradient, so the recomputed
    trip does too, whether or not the loop's input needs it."""

    @staticmethod
    def forward(ctx, body, factor, carries, reads, *xs):
        ctx.body, ctx.factor, ctx.carries = body, factor, carries
        ctx.reads = reads
        ctx.save_for_backward(*xs)
        c = active()
        c.weight *= factor
        try:
            return tuple(body(*xs))
        finally:
            c.weight /= factor

    @staticmethod
    def backward(ctx, *grads):
        xs = ctx.saved_tensors
        need = ctx.needs_input_grad[4:]
        read = len(xs) - ctx.carries
        # every trip but the first takes the gradient of its carries
        grad_of = [bool(n) or i >= read for i, n in enumerate(need)]
        live = [x.detach().requires_grad_(g) if x.is_floating_point()
                else x for x, g in zip(xs, grad_of)]
        c = active()
        c.add_bytes("add", 3.0 * sum(
            (r - 1) * _nbytes(x) for x, n, r in zip(xs[:read], need[:read],
                                                    ctx.reads) if n))
        with torch.enable_grad():
            with c.paused():
                outs = tuple(ctx.body(*live))
            pairs = [(o, g) for o, g in zip(outs, grads)
                     if o.requires_grad and g is not None]
            wanted = [x for x in live if x.requires_grad]
            c.weight *= ctx.factor
            try:
                got = torch.autograd.grad([o for o, _ in pairs],
                                          wanted, [g for _, g in pairs],
                                          allow_unused=True)
            finally:
                c.weight /= ctx.factor
        by_id = {id(x): g for x, g in zip(wanted, got)}
        got = [by_id[id(x)] for x, n in zip(live, need) if n]
        it = iter(got)
        return (None,) * 4 + tuple(next(it) if n else None for n in need)


class Repeat:
    """A loop of ``n`` trips that cost the same (see the module
    docstring). Use::

        r = op_cost.repeat(n)
        y, h = r.run(body, u, h, carries=1)   # body(trips, u, h) -> (y, h)
        y = r.fill(y, dim)            # one trip's output stood in n times

    ``carries`` counts the trailing inputs that are carries (read by the
    first trip, each trip returning their update); every other input is
    read by every trip, or by ``reads[i]`` of them where given (see
    :class:`_ScaledLoop`).

    or, for a loop with no gradient through it, ``with r.weighted(): for
    i in range(r.trips): ...``."""

    def __init__(self, n: int):
        c = active()
        self.n = n
        self.counter = c if (c is not None and c.scale_loops
                             and n > 1) else None
        self.trips = 1 if self.counter else n

    def run(self, body, *xs, carries: int = 0,
            reads: Optional[Sequence[float]] = None):
        if self.counter is None:
            return body(self.n, *xs)
        reads = tuple(reads or (self.n,) * (len(xs) - carries))
        return _ScaledLoop.apply(lambda *a: body(1, *a), float(self.n),
                                 carries, reads, *xs)

    @contextlib.contextmanager
    def weighted(self):
        if self.counter is None:
            yield
            return
        self.counter.weight *= self.n
        try:
            yield
        finally:
            self.counter.weight /= self.n

    def fill(self, y: torch.Tensor, dim: int, times: Optional[int] = None):
        """``y`` as the loop's n trips would have made it: one trip's
        output repeated ``times`` (default n) along ``dim``, uncounted."""
        if self.counter is None:
            return y
        reps = [1] * y.dim()
        reps[dim] = self.n if times is None else times
        with self.counter.paused():
            return y.repeat(*reps)


def repeat(n: int) -> Repeat:
    return Repeat(int(n))


def each(n: int, fn, counted: Optional[float] = None) -> list:
    """``[fn(0), ..., fn(n - 1)]``: ``n`` calls that cost the same, with
    no gradient through them, which a counter counts as ``counted``
    (default ``n``) such calls, the storages they leave alive too (a fake
    block standing for several counts more calls than it makes). Under a
    counter made with ``scale_loops`` one call stands for all, its
    result returned for every ``i``."""
    trips = repeat(n).trips
    c = active()
    factor = (n if counted is None else counted) / trips
    with (c.standing_for(factor) if c is not None and factor != 1
          else contextlib.nullcontext()):
        out = [fn(i) for i in range(trips)]
    return out + out[:1] * (n - len(out))


def count(fn, *args, scale_loops: bool = False, **kwargs):
    """``(fn(*args, **kwargs), counter)`` with every op of the call
    counted."""
    with CostCounter(scale_loops=scale_loops) as c:
        out = fn(*args, **kwargs)
    return out, c


def nbytes_of(tree) -> int:
    """Bytes of every tensor leaf of a nested dict / list tree."""
    return sum(_nbytes(t) for t in _tensors(tree))


def split_bytes(shape, dtype, spec, sizes: Dict[str, int]) -> float:
    """Bytes a device holds of a leaf of ``shape`` / ``dtype`` split as
    the pruned physical ``spec`` says (each entry ``None``, an axis name
    or a tuple of names; ``sizes`` axis name -> size)."""
    from . import hw
    n = math.prod(int(s) for s in shape) * hw.dtype_bytes(dtype)
    div = 1
    for entry in (spec or ()):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            div *= sizes[a]
    return n / div
