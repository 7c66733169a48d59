"""Roofline terms of a traced step, and of one kernel call, on H100
constants (:mod:`hw`).

Per (arch, shape, mesh) cell :func:`analyze` reports three times
(seconds a step):

  compute    = flops a device / PEAK_FLOPS_BF16
  memory     = bytes a device / HBM_BW
  collective = global wire bytes / (devices * NET_BW)

from the counts of :mod:`op_cost` over the global step (every shard's
work, divided by the mesh's size), where the JAX package reads its HLO.

:func:`kernel_step_costs` is the JAX package's analytic model of one FCM
step kernel's work, the same whatever implements it, with the byte
widths of what a kernel streams as parameters; :func:`kernel_cell` folds
one measured call into its roofline share, on the float32 peak: every
FCM kernel computes in float32 outside the tensor cores.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from . import hw
from .op_cost import _WIRE_MULT, Costs


def collective_wire(kind: str, nbytes: float, n: int) -> float:
    """Wire bytes a participant sends for a collective ``kind`` of
    ``nbytes`` a participant over a group of ``n`` (the JAX package's
    ``_WIRE_MULT``: all-reduce 2(n-1)/n, gather / scatter / all-to-all
    (n-1)/n, permute 1)."""
    return nbytes * _WIRE_MULT[kind](n)


# ---------------------------------------------------------------------------
# Model-FLOPs accounting (6*N*D / 2*N*D)
# ---------------------------------------------------------------------------

_STACKED = ("groups", "enc_groups")


def _leaves_stacked(tree, path=()):
    """``(path, shape)`` of each leaf in the JAX package's flatten order
    and layout: dict keys sorted, each list of groups one stacked leaf a
    position (a leading axis of the list's length)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            v = tree[k]
            if k in _STACKED and isinstance(v, list):
                for p, shape in _leaves_stacked(v[0], path + (k,)):
                    yield p, (len(v),) + shape
            else:
                yield from _leaves_stacked(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_stacked(v, path + (str(i),))
    else:
        yield path, tuple(tree.shape)


def count_params(cfg) -> Dict[str, float]:
    """Total and active (MoE-aware) parameter counts from the abstract
    parameter tree (meta tensors): expert-stacked FFN leaves ((G, E, d, f)
    stacked) count at top_k/E toward the active parameters."""
    from ..models import lm
    tree = lm.abstract_params(cfg)
    total = active = 0.0
    for path, shape in _leaves_stacked(tree):
        n = 1.0
        for s in shape:
            n *= s
        total += n
        keys = "/".join(path)
        if "ffn" in keys and len(shape) == 4 and cfg.moe is not None \
                and shape[1] == cfg.moe.n_experts:
            active += n * cfg.moe.top_k / cfg.moe.n_experts
        else:
            active += n
    return {"total": total, "active": active}


def model_flops(cfg, shape) -> float:
    """6*N_active*D for training, 2*N_active*D for inference steps."""
    n = count_params(cfg)["active"]
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        return 6.0 * n * d
    if shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        return 2.0 * n * d
    d = shape.global_batch * 1
    return 2.0 * n * d


# ---------------------------------------------------------------------------
# Cell report
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MemoryAnalysis:
    """Bytes a device holds: arguments (from the spec trees), temporaries
    and outputs (the traced step's live storages)."""
    argument_size_in_bytes: float
    temp_size_in_bytes: float
    output_size_in_bytes: float


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops_per_dev: float
    bytes_per_dev: float
    wire_bytes: float
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops_total: float
    useful_flops_frac: float
    mem_args_gb: float
    mem_temp_gb: float
    mem_out_gb: float
    fits_hbm: bool
    xla_flops_per_dev: float = 0.0     # no XLA in the port: always 0
    xla_bytes_per_dev: float = 0.0

    def row(self) -> dict:
        return dataclasses.asdict(self)


def analyze(arch: str, shape, mesh_label: str, n_devices: int,
            costs: Costs, mem: Optional[MemoryAnalysis],
            cfg) -> RooflineReport:
    """Roofline terms of one cell from the counts of its global step
    (:class:`op_cost.Costs`) and the per-device memory ``mem``."""
    flops_dev = costs.flops / n_devices
    bytes_dev = costs.bytes / n_devices
    wire = costs.wire
    t_c = flops_dev / hw.PEAK_FLOPS_BF16
    t_m = bytes_dev / hw.HBM_BW
    t_x = wire / (n_devices * hw.NET_BW)
    dominant = max((("compute", t_c), ("memory", t_m),
                    ("collective", t_x)), key=lambda kv: kv[1])[0]
    mf = model_flops(cfg, shape) if cfg is not None else 0.0
    total = flops_dev * n_devices
    gib = 2 ** 30
    peak = ((mem.argument_size_in_bytes + mem.temp_size_in_bytes
             + mem.output_size_in_bytes) if mem else 0)
    return RooflineReport(
        arch=arch, shape=shape.name, mesh=mesh_label, n_devices=n_devices,
        flops_per_dev=flops_dev, bytes_per_dev=bytes_dev, wire_bytes=wire,
        t_compute=t_c, t_memory=t_m, t_collective=t_x, bottleneck=dominant,
        model_flops_total=mf,
        useful_flops_frac=(mf / total if total else 0.0),
        mem_args_gb=mem.argument_size_in_bytes / gib if mem else 0.0,
        mem_temp_gb=mem.temp_size_in_bytes / gib if mem else 0.0,
        mem_out_gb=mem.output_size_in_bytes / gib if mem else 0.0,
        fits_hbm=bool(peak <= hw.HBM_BYTES))


# ---------------------------------------------------------------------------
# Kernel roofline-vs-achieved cells (the FCM step kernels)
# ---------------------------------------------------------------------------

_F32 = 4  # the JAX package's width of every stream (labels int32 alike)


def kernel_step_costs(kind: str, *, n_rows: int = 0, c: int = 0,
                      n_feat: int = 1, n_bins: int = 256, b: int = 1,
                      h: int = 0, w: int = 0, d: int = 0,
                      neighbors: int = 4, n_iters: int = 1,
                      n_centers: int = 0, in_bytes: int = _F32,
                      w_bytes: int = _F32, u_bytes: int = _F32,
                      out_bytes: int = _F32) -> Dict[str, float]:
    """Analytic FLOPs/bytes of one call of a step ``kind``: the JAX
    package's model (``roofline.kernel_step_costs``), the intrinsic math
    at the probe shape whatever implements it. Bytes are inputs once,
    outputs once, plus the (c, N) membership intermediate where a
    reference materializes it.

    The widths are those of what the kernel streams, 4 bytes each by
    default (at the defaults it returns exactly the JAX model's numbers):
    ``in_bytes`` a feature / pixel element, ``w_bytes`` a weight,
    ``u_bytes`` an element of the (c, N) intermediate (0 for a kernel
    that keeps it on chip), ``out_bytes`` a histogram bin or a label."""
    if kind == "flat":
        # distances 3D, membership ~6 (pow, recip, normalize), weighted
        # partials 2(D+1) -- per (row, cluster); per convergence iter.
        flops = n_rows * c * (5 * n_feat + 8) * n_iters
        bytes_ = (n_rows * (in_bytes * n_feat + w_bytes)  # feats + weights
                  + u_bytes * n_rows * c                  # (c, N) membership
                  + _F32 * 2 * c * n_feat) * n_iters
    elif kind == "stencil":
        # neighbor sum + distance/membership for center and neighbor
        # terms + partials -- per (pixel, cluster), plus the stencil pass.
        flops = h * w * (2 * neighbors + c * (10 + neighbors)) * n_iters
        bytes_ = (h * w * (2 * in_bytes + u_bytes * c)
                  + _F32 * 2 * c) * n_iters
    elif kind == "bin":
        flops = b * n_rows            # one increment per pixel
        bytes_ = b * (in_bytes * n_rows + out_bytes * n_bins)
    elif kind == "labels":
        flops = n_rows * c * (3 * n_feat + 1)
        bytes_ = (n_rows * (in_bytes * n_feat + out_bytes)
                  + _F32 * c * n_feat)
    elif kind == "slic_assign":
        # 9 grid-cell candidates x joint distance over D+2 dims.
        flops = h * w * 9 * (3 * (d + 2) + 1)
        bytes_ = (h * w * (in_bytes * d + out_bytes)
                  + _F32 * n_centers * (d + 2))
    else:
        raise ValueError(f"no analytic cost model for step kind {kind!r}")
    return {"flops": float(flops), "bytes": float(bytes_)}


@dataclasses.dataclass
class KernelCell:
    """Roofline-vs-achieved for one (step kind, impl) cell."""
    kind: str
    impl: str
    backend: str
    interpret: bool               # always False: the port has no interpret
    shape: Dict[str, int]
    flops: float                  # analytic model, one invocation
    bytes: float
    hlo_flops: float              # op counter (0 for a hand-written kernel)
    hlo_bytes: float
    wall_s: float                 # measured time of one call
    achieved_flops_per_s: float
    achieved_bytes_per_s: float
    t_roofline: float             # max(flops/peak, bytes/bw)
    bound: str                    # "compute" | "memory"
    frac_of_roofline: float       # t_roofline / wall_s (1.0 = at roof)

    def row(self) -> dict:
        return dataclasses.asdict(self)


def kernel_cell(kind: str, impl: str, backend: str, shape: Dict[str, int],
                flops: float, bytes_: float, wall_s: float, *,
                interpret: bool = False, hlo_flops: float = 0.0,
                hlo_bytes: float = 0.0) -> KernelCell:
    """Fold one measured kernel call into its roofline cell, on the
    float32 peak and HBM bandwidth."""
    t_c = flops / hw.PEAK_FLOPS_F32
    t_m = bytes_ / hw.HBM_BW
    t_roof = max(t_c, t_m)
    return KernelCell(
        kind=kind, impl=impl, backend=backend, interpret=interpret,
        shape=dict(shape), flops=flops, bytes=bytes_,
        hlo_flops=hlo_flops, hlo_bytes=hlo_bytes, wall_s=wall_s,
        achieved_flops_per_s=flops / wall_s if wall_s > 0 else 0.0,
        achieved_bytes_per_s=bytes_ / wall_s if wall_s > 0 else 0.0,
        t_roofline=t_roof,
        bound="compute" if t_c >= t_m else "memory",
        frac_of_roofline=t_roof / wall_s if wall_s > 0 else 0.0,
    )
