"""Production meshes: the JAX package's shapes and axis names, so every
dry-run cell has its JAX counterpart, as a port :class:`Mesh` that names
one device 256 or 512 times (the one-process model of
:mod:`repro_torch.core.distributed`). Building one needs no process-level
setup: the JAX package's ``XLA_FLAGS`` preamble has no counterpart."""
from __future__ import annotations

import math

from .. import _device as DV
from ..core.distributed import Mesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """Single pod: (16, 16) = 256 devices, axes (data, model).
    Multi-pod: (2, 16, 16) = 512 devices, axes (pod, data, model). Every
    entry is ``device`` (``None`` = the card; ``"cpu"`` when asked)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    dev = DV.resolve_device(device)
    return make_mesh(shape, axes, devices=[dev] * math.prod(shape))
