"""int8 gradient compression for the cross-pod data-parallel mean.

Within a pod gradients reduce at full precision. Across pods the link
is the slow one, so the cross-pod mean runs on int8-quantized gradients:
one symmetric scale a leaf shared by every pod, quantize, an int32 sum,
dequantize. 4x fewer bytes on the wire than float32 (2x against bf16),
with an error of at most half a quantization step an element.

:func:`compressed_psum_mean` is the one-process form of the JAX
package's ``compressed_psum_mean(tree, "pod")`` (as
:mod:`repro_torch.core.distributed` is of its ``shard_map``): it takes
the trees of every position along the mesh axis, each on its shard's
device, and returns their mean on the mesh's lead device. Each shard
quantizes on its own device, so only int8 payloads (and one float32 a
leaf for the shared scale) cross to the lead. ``torch.round`` rounds
half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..analysis import op_cost
from ..core.distributed import Mesh
from ..models import sharding as sh
from . import optimizer as opt


def _scale_of(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(amax, min=1e-30) / 127.0


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127)


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8: returns ``(q int8, scale float32)``."""
    scale = _scale_of(torch.max(torch.abs(x.to(torch.float32))))
    return _quantize(x, scale).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _axis_size(mesh: Mesh, axis: str) -> int:
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh axes {mesh.axis_names} have no {axis!r}")
    return mesh.shape[mesh.axis_names.index(axis)]


def _amax(x) -> torch.Tensor:
    """max |x| of a leaf (over a placed leaf's blocks), on its lead."""
    parts = [torch.max(torch.abs(t.to(torch.float32))).to(sh.lead_device(x))
             for t in sh.tensors_of(x)]
    return parts[0] if len(parts) == 1 else torch.stack(parts).max()


def compressed_psum_mean(trees: Sequence, mesh: Mesh, axis: str, like=None):
    """The mean of ``trees`` (one tree a position along ``axis``, in
    order, each on that shard's device) with int8 on the wire. For each
    leaf: the max |x| over the shards, one shared scale, each shard
    quantized on its device, an int32 sum on ``mesh.lead`` in shard
    order, then dequantized, divided by the axis size and cast back to
    the leaf's dtype. Returns one tree on the lead device; where a leaf
    of ``like`` is placed across ``mesh`` (the shards' leaves placed on
    their sub-meshes), the mean is formed block by block on each slot's
    device and placed as that leaf is. A cost counter sees two
    all-reduces a leaf: the float32 max and the int8 payload (the JAX
    package sums the payload as int32)."""
    n = _axis_size(mesh, axis)
    if len(trees) != n:
        raise ValueError(f"axis {axis!r} has {n} positions, got "
                         f"{len(trees)} trees")
    lead = mesh.lead

    def one(ref, *xs):
        # on the wire: one float32 max a leaf, then its int8 payload
        op_cost.collective("all-reduce", 4, n)
        op_cost.collective("all-reduce", xs[0].numel(), n)
        scale = _scale_of(torch.stack([_amax(x).to(lead) for x in xs]).max())
        qs = [sh.blockwise(lambda t: _quantize(t, scale.to(t.device)).to(
            torch.int8), x) for x in xs]
        if sh.is_placed(ref):
            # each slot's block of every shard's int8 payload, summed there
            qs = [sh.put(q, ref.sharding) for q in qs]
            total = sh.blockwise(lambda *b: sum(t.to(torch.int32) for t in b),
                                 *qs)
            return sh.blockwise(lambda t: (t.to(torch.float32) * scale.to(
                t.device) / n).to(xs[0].dtype), total)
        total = None
        for q in qs:
            q = q.to(lead)
            total = (q.to(torch.int32) if total is None
                     else total + q.to(torch.int32))
        return (total.to(torch.float32) * scale / n).to(xs[0].dtype)

    return opt.tree_map(one, trees[0] if like is None else like, *trees)
