"""Dry-run planner: every (arch x input shape) cell on the production
meshes (16, 16) and (2, 16, 16), costed on fake tensors, with per-device
memory, the roofline terms on H100 constants and the bottleneck,
appended as JSONL records (the JAX package's ``launch/dryrun.py``
record keys).

Where the JAX package AOT-compiles each step for 512 fake TPU devices and
walks its HLO, the port runs the *global* step once under
``FakeTensorMode`` (no memory behind a tensor, any size) inside an
:class:`~repro_torch.analysis.op_cost.CostCounter`:

- the state (the parameters of a serving cell) is placed across the
  mesh by its specs (``sharding.place``), as the launcher places it, so
  the step gathers each group's parameters and reduce-scatters their
  gradients;
- argument bytes a device come from the spec trees (``lm.param_specs``,
  ``train_loop.state_specs`` / ``batch_specs``, ``lm.cache_specs``,
  pruned by ``sharding.prune_spec``): each leaf's bytes over the sizes
  of the axes that split it, as ``memory_analysis()`` reports them and
  as ``place`` stores them in each slot;
- temporaries and outputs are the step's peak and final live bytes, and
  flops, bytes and wire the counter's totals, each over the mesh's size;
- loops of equal trips (microbatches, flash-attention chunks, the expert
  dispatch's (shard, rank) pairs, the Mamba and RWKV6 recurrences over
  positions) are counted as one trip times the trip count, as the JAX
  walker multiplies a scan body;
- ``fcm-brainweb`` costs one iteration of ``build_sharded_fit`` (the JAX
  dry-run's ``while_override=1``).

**Scope.** The wire is what the port's own mesh operations move: the
parameter all-gathers and gradient reduce-scatters of the placed state
(each gather of a leaf split over n slots one all-gather of a block a
participant for each replica group, a recompute under remat gathering
again), the pixel fit's psums, the expert dispatch's rank sums and the
int8 cross-pod mean. Activation resharding that XLA's partitioner would
insert has no counterpart: the port's activations live on the lead
device. Each record says so under ``scope``. Numbers are analytic on
data-sheet constants (:mod:`repro_torch.analysis.hw`), not
measurements.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
      --shape train_4k --mesh single --device cpu --force
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from pathlib import Path

import torch

from .. import _device as DV
from .. import configs
from ..analysis import op_cost, roofline
from ..core import distributed as fcm_dist
from ..core.fcm import FCMConfig
from ..models import lm
from ..models import sharding as sh
from ..training import optimizer as opt
from ..training import train_loop as tl
from .mesh import make_production_mesh

DEFAULT_OUT = (Path(__file__).resolve().parents[3] / "build"
               / "dryrun_torch.jsonl")

# At-scale training config: bf16 Adam moments (fp32 master weights kept).
TRAIN_CFG = tl.TrainConfig(
    optimizer=opt.OptimizerConfig(moment_dtype="bfloat16"))

# deeper grad-accumulation for the giant configs (activation footprint)
MICROBATCH_OVERRIDE = {"deepseek-v2-236b": 16, "mistral-large-123b": 16,
                       "llama-3.2-vision-90b": 16}

FCM_SHAPE = configs.ShapeConfig("fcm_1g", "fcm", 1 << 30, 1)

SCOPE = ("wire: the port's own mesh operations (the placed state's "
         "parameter all-gathers and gradient reduce-scatters, psums of the "
         "FCM fit, the expert dispatch's rank sums, the int8 cross-pod "
         "mean); no activation resharding (activations live on the lead "
         "device); temp and out: the global step's live bytes over the "
         "mesh's size; analytic, H100 SXM data-sheet constants")


def _fake_like(tree, dev):
    """Fake tensors of a meta tree's shapes and dtypes on ``dev``."""
    return opt.tree_map(lambda t: torch.empty(tuple(t.shape), dtype=t.dtype,
                                              device=dev), tree)


def _batch(cfg, shape, dev):
    b, s = shape.global_batch, shape.seq_len
    out = {"tokens": torch.zeros((b, s), dtype=torch.int32, device=dev),
           "labels": torch.zeros((b, s), dtype=torch.int32, device=dev)}
    if cfg.is_encdec:
        out["frames"] = torch.zeros((b, s, cfg.d_model), dtype=torch.float32,
                                    device=dev)
    if cfg.n_img_tokens:
        out["image_embeds"] = torch.zeros((b, cfg.n_img_tokens, cfg.d_model),
                                          dtype=torch.float32, device=dev)
    return out


def arg_bytes(tree, spec_tree, ctx: sh.Parallelism) -> float:
    """Bytes a device holds of ``tree`` split as ``spec_tree`` (logical
    specs) resolves and prunes on ``ctx``'s mesh."""
    sizes = sh.axis_sizes(ctx.mesh) if ctx.mesh is not None else {}
    phys = sh.to_shardings(tree, spec_tree, ctx)
    leaves = opt.tree_leaves(tree)
    specs = _spec_leaves(phys, spec_tree)
    return sum(op_cost.split_bytes(t.shape, t.dtype, s, sizes)
               for t, s in zip(leaves, specs))


def _spec_leaves(phys, spec_tree):
    """The physical specs in :func:`optimizer.tree_leaves` order (dict
    keys sorted); ``None`` leaves without a mesh."""
    if isinstance(spec_tree, tuple):
        return [phys]
    if isinstance(spec_tree, dict):
        return [x for k in sorted(spec_tree)
                for x in _spec_leaves(phys[k], spec_tree[k])]
    return [x for p, s in zip(phys, spec_tree) for x in _spec_leaves(p, s)]


def _dp_bytes(t, ctx) -> float:
    """A batch-leading input's bytes a device (spec ("dp", None, ...))."""
    return arg_bytes(t, ("dp",) + (None,) * (t.dim() - 1), ctx)


def cost_lm(cfg, shape, ctx: sh.Parallelism, dev):
    """Counter and per-device argument bytes of one LM cell's step, on
    fake tensors (call under ``FakeTensorMode``)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        state = sh.place(_fake_like(tl.abstract_state(cfg, TRAIN_CFG), dev),
                         tl.state_specs(cfg), ctx)
        batch = _batch(cfg, shape, dev)
        args = (arg_bytes(state, tl.state_specs(cfg), ctx)
                + arg_bytes(batch, tl.batch_specs(cfg), ctx))
        step = tl.make_train_step(cfg, TRAIN_CFG)
        with op_cost.CostCounter(scale_loops=True) as counter:
            out = step(state, batch)
        return counter, args, out
    params = sh.place(_fake_like(lm.abstract_params(cfg), dev),
                      lm.param_specs(cfg), ctx)
    cache = lm.init_cache(cfg, b, s, device=dev)
    args = (arg_bytes(params, lm.param_specs(cfg), ctx)
            + arg_bytes(cache, lm.cache_specs(cfg), ctx))
    if shape.kind == "prefill":
        tok = torch.zeros((b, s), dtype=torch.int32, device=dev)
        extra = {}
        if cfg.is_encdec:
            extra["frames"] = torch.zeros((b, s, cfg.d_model),
                                          dtype=torch.float32, device=dev)
        if cfg.n_img_tokens:
            extra["memory"] = torch.zeros((b, cfg.n_img_tokens, cfg.d_model),
                                          dtype=cfg.dtype, device=dev)
        args += sum(_dp_bytes(t, ctx) for t in (tok, *extra.values()))
        with op_cost.CostCounter(scale_loops=True) as counter:
            out = lm.prefill(params, tok, cache, cfg, **extra)
        return counter, args, out
    tok = torch.zeros((b, 1), dtype=torch.int32, device=dev)
    args += _dp_bytes(tok, ctx) + 4                 # + the int32 position
    with op_cost.CostCounter(scale_loops=True) as counter:
        out = lm.decode_step(params, tok, cache, s - 1, cfg)
    return counter, args, out


def cost_fcm(mesh, dev, n: int = FCM_SHAPE.seq_len):
    """Counter and per-device argument bytes of one iteration of the
    pixel-sharded FCM fit on ``n`` voxels (call under
    ``FakeTensorMode``)."""
    x = torch.zeros((n,), dtype=torch.float32, device=dev)
    w = torch.ones((n,), dtype=torch.float32, device=dev)
    fit = fcm_dist.build_sharded_fit(mesh, FCMConfig(),
                                     loop=fcm_dist.one_iteration)
    with op_cost.CostCounter(scale_loops=True) as counter:
        out = fit(x, w)
    return counter, 2 * n * 4 / mesh.size, out


def _has_mamba(cfg) -> bool:
    return any(d.mixer == "mamba" for d in cfg.group_layout)


def cell_config(arch, shape, dev, microbatches=8, reduced=False):
    """The config a cell runs: the arch's, reduced when asked, with the
    giants' microbatches for training, and on the card the Mamba layers
    through the selective-scan kernel (row 12), as the launcher's users
    run them."""
    cfg = configs.get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if shape.kind == "train":
        mb = MICROBATCH_OVERRIDE.get(arch, microbatches)
        if mb > 1:
            cfg = dataclasses.replace(cfg, microbatches=mb)
    if dev.type == "cuda" and _has_mamba(cfg):
        cfg = dataclasses.replace(cfg, mamba_pallas=True)
    return cfg


def run_cell(arch, shape, multi_pod, device=None, verbose=True,
             microbatches=8, reduced=False):
    """One cell's record (a dict of the JAX record's keys, plus
    ``scope``, ``device``, ``mamba_kernel`` and ``wall_s``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    t_start = time.perf_counter()
    dev = DV.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_production_mesh(multi_pod=multi_pod, device=dev)
    ctx = sh.make_parallelism(mesh)
    label = "2x16x16" if multi_pod else "16x16"
    cfg = None
    t0 = time.perf_counter()
    with FakeTensorMode(), sh.parallelism(ctx):
        if arch == "fcm-brainweb":
            shape = FCM_SHAPE
            counter, args, out = cost_fcm(mesh, dev)
        else:
            cfg = cell_config(arch, shape, dev, microbatches, reduced)
            counter, args, out = cost_lm(cfg, shape, ctx, dev)
        live = counter.live             # the outputs, still referenced
        del out
    t_trace = time.perf_counter() - t0
    n = mesh.size
    mem = roofline.MemoryAnalysis(
        argument_size_in_bytes=args,
        temp_size_in_bytes=(counter.peak - live) / n,
        output_size_in_bytes=live / n)
    rep = roofline.analyze(arch, shape, label, n, counter.costs, mem, cfg)
    rec = rep.row()
    rec.update(lower_s=round(t_trace, 2), compile_s=0.0, hlo_bytes=0,
               scope=SCOPE, device=dev.type,
               mamba_kernel=bool(cfg is not None and cfg.mamba_pallas),
               n_ops=counter.costs.n_ops,
               wall_s=round(time.perf_counter() - t_start, 2))
    if verbose:
        print(f"  memory: args={rep.mem_args_gb:.3f}GiB "
              f"temp={rep.mem_temp_gb:.3f}GiB out={rep.mem_out_gb:.3f}GiB "
              f"fits_hbm={rep.fits_hbm}")
        print(f"  costs: flops/dev={rep.flops_per_dev:.3e} "
              f"bytes/dev={rep.bytes_per_dev:.3e}")
        print(f"  collectives: wire={rep.wire_bytes:.3e}B "
              f"terms (s): compute={rep.t_compute:.4f} "
              f"memory={rep.t_memory:.4f} coll={rep.t_collective:.4f} "
              f"-> {rep.bottleneck}-bound ({rec['wall_s']} s)")
    return rec


def cells(arch_filter, shape_filter):
    for arch in configs.list_archs() + ["fcm-brainweb"]:
        if arch_filter != "all" and arch not in arch_filter.split(","):
            continue
        if arch == "fcm-brainweb":
            yield arch, FCM_SHAPE
            continue
        cfg = configs.get_config(arch)
        for s in configs.applicable_shapes(cfg):
            if shape_filter != "all" and s.name not in shape_filter.split(","):
                continue
            yield arch, s


def load_done(path):
    done = set()
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    done.add((r["arch"], r["shape"], r["mesh"]))
                except json.JSONDecodeError:
                    pass
    return done


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--microbatches", type=int, default=8,
                    help="grad-accum microbatches for train cells")
    ap.add_argument("--device", default=None,
                    help="the device the fake tensors name (default the "
                         "card; 'cpu' runs the CPU's plain paths)")
    ap.add_argument("--reduced", action="store_true",
                    help="each arch's reduced config (one group, narrow "
                         "widths) at the cell's shape")
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    todo = [(a, s, mp) for a, s in cells(args.arch, args.shape)
            for mp in meshes]
    if args.list:
        for a, s, mp in todo:
            print(a, s.name, "2x16x16" if mp else "16x16")
        return 0

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    done = set() if args.force else load_done(args.out)
    failures = []
    for arch, shape, mp in todo:
        label = "2x16x16" if mp else "16x16"
        key = (arch, shape.name, label)
        if key in done:
            print(f"[skip] {arch} x {shape.name} x {label}")
            continue
        print(f"[cell] {arch} x {shape.name} x {label}")
        try:
            rec = run_cell(arch, shape, mp, device=args.device,
                           microbatches=args.microbatches,
                           reduced=args.reduced)
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
            print(f"  ok (traced in {rec['lower_s']} s)")
        except Exception as e:
            failures.append((key, repr(e)))
            traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILED cells:")
        for k, e in failures:
            print(" ", k, e)
        return 1
    print("\nall cells OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
