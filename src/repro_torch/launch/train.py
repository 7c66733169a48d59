"""The training launcher of the port.

Wires the substrate together: arch config and shape -> mesh (planned
from the visible card count) -> train state placed across the mesh by
its specs (one block of each leaf a mesh slot, on the slot's device)
-> the deterministic data pipeline -> the train step -> asynchronous
checkpoints, the straggler watchdog and a crash-restart loop.

:func:`train` is the loop itself: it takes a :class:`ModelConfig`, so
a caller can run any config (Jamba with ``mamba_pallas=True``, a cut
depth) and any batch source, and returns what the run measured.
:func:`main` is the command line, the JAX package's flags plus
``--device``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --reduced --steps 50 --batch 8 --seq 128 --ckpt-dir CKPT \\
      [--device cpu]

Without ``--device`` it runs on the card, and raises where there is
none. With more than one visible card the mesh comes from
:func:`repro_torch.training.elastic.plan_mesh`.

Checkpoints hold the state in the JAX package's layout (groups stacked
on a leading axis, :func:`repro_torch.training.train_loop.to_stacked`),
so either package's launcher resumes the other's. A checkpoint is named
by the number of steps its state has taken, and a resumed run's data
stream restarts at that step, so a run that crashed and resumed ends
in the state of one that did not.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
from typing import Callable, Dict, Optional

import torch

from .. import _device as DV
from .. import configs
from ..configs.base import ModelConfig, ShapeConfig
from ..core.distributed import Mesh
from ..data import pipeline
from ..models import sharding as sh
from ..training import checkpoint as ckpt
from ..training import elastic
from ..training import optimizer as opt
from ..training import train_loop as tl

#: seconds between a fault and the restart from the latest checkpoint
RESTART_BACKOFF_S = 1.0


def build(cfg: ModelConfig, tcfg: tl.TrainConfig, mesh: Optional[Mesh] = None,
          resume_dir: Optional[str] = None, device=None):
    """``(state, step_fn, ctx, start)``: the state restored from the
    latest checkpoint under ``resume_dir`` (``start`` its step), else
    drawn from seed 0 (``start`` 0). With a mesh it is placed across the
    mesh by :func:`~repro_torch.training.train_loop.state_specs` (a
    checkpoint's leaves placed as they are read); without one it lies
    whole on ``device`` (``None`` = the card)."""
    dev = mesh.lead if mesh is not None else DV.resolve_device(device)
    ctx = sh.make_parallelism(mesh)
    if resume_dir and ckpt.latest_step(resume_dir) is not None:
        like = tl.to_stacked(tl.abstract_state(cfg, tcfg), "meta")
        shardings = (sh.to_named_shardings(like, tl.stacked_specs(cfg), ctx)
                     if mesh is not None else None)
        tree, manifest = ckpt.load_checkpoint(
            resume_dir, like, device=None if mesh is not None else "cpu",
            shardings=shardings)
        state = tl.from_stacked(tree, dev)
        start = int(manifest["step"])
    else:
        state = tl.init_state(0, cfg, tcfg, device=dev, ctx=ctx)
        start = 0
    state, ctx = elastic.reshard_state(state, tl.state_specs(cfg), mesh)
    if mesh is not None:
        require_placed(state)
    return state, tl.make_train_step(cfg, tcfg), ctx, start


def require_placed(state):
    """Raise unless every leaf of ``state`` is placed across a mesh: a
    meshed run never falls back to a whole state on its lead device."""
    whole = [i for i, x in enumerate(opt.tree_leaves(state))
             if not sh.is_placed(x)]
    if whole:
        raise RuntimeError(f"{len(whole)} leaves of a meshed train state "
                           f"are whole tensors, not placed on the mesh")


@dataclasses.dataclass
class TrainRun:
    """What :func:`train` measured. ``losses`` and ``step_ms`` are keyed
    by step (a step run again after a restart keeps its last value);
    ``step_ms`` is each step's wall time up to its loss on the host."""
    state: dict
    losses: Dict[int, float]
    grad_norms: Dict[int, float]
    step_ms: Dict[int, float]
    flagged: int
    restarts: int


def _to_device(batch, dev: torch.device):
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def train(cfg: ModelConfig, shape: ShapeConfig, tcfg: tl.TrainConfig,
          steps: int, *, mesh: Optional[Mesh] = None, device=None,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          max_restarts: int = 2,
          batches: Callable = pipeline.batches,
          log: Callable = print) -> TrainRun:
    """Train ``cfg`` up to step ``steps`` on batches of ``shape`` from
    ``batches(cfg, shape, start)`` (the pipeline by default). With
    ``ckpt_dir``, resumes from its latest checkpoint, saves every
    ``ckpt_every`` steps and at the end, and on an error restarts from
    the latest checkpoint up to ``max_restarts`` times (without it, an
    error is raised at once)."""
    losses, gnorms, step_ms = {}, {}, {}
    flagged = restarts = 0
    while True:
        saver = None
        try:
            state, step_fn, ctx, start = build(cfg, tcfg, mesh, ckpt_dir,
                                               device)
            dev = sh.lead_device(state["step"])
            saver = ckpt.AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
            timer = elastic.StepTimer()
            with sh.parallelism(ctx):
                for i, batch in enumerate(batches(cfg, shape, start)):
                    step = start + i
                    if step >= steps:
                        break
                    timer.start()
                    state, metrics = step_fn(state, _to_device(batch, dev))
                    if mesh is not None:
                        require_placed(state)
                    losses[step] = float(metrics["loss"])
                    slow = timer.stop()
                    step_ms[step] = timer.durations[-1] * 1e3
                    gnorms[step] = float(metrics["grad_norm"])
                    if step % 10 == 0 or step == steps - 1:
                        log(f"step {step:5d} loss={losses[step]:.4f} "
                            f"gnorm={gnorms[step]:.2f}"
                            + (" [straggler]" if slow else ""))
                    if saver and (step + 1) % ckpt_every == 0:
                        saver.save(tl.to_stacked(state), step + 1)
            flagged += timer.total_flagged
            if saver:
                saver.save(tl.to_stacked(state), int(sh.whole(
                    state["step"])))
                saver.wait()
                if saver.last_error is not None:
                    raise saver.last_error
            return TrainRun(state, losses, gnorms, step_ms, flagged,
                            restarts)
        except Exception as e:      # the crash-restart boundary
            restarts += 1
            if restarts > max_restarts or not ckpt_dir:
                raise
            if saver:
                saver.wait()        # resume from every save already asked
            log(f"[fault] {e!r}; restart {restarts}/{max_restarts} from "
                f"the latest checkpoint")
            time.sleep(RESTART_BACKOFF_S)


def summary(run: TrainRun, shape: ShapeConfig) -> dict:
    """The run's figures: first and last loss, the median step time past
    the first step, tokens a second at that median, straggler flags,
    restarts and the card's peak allocated memory."""
    steps = sorted(run.losses)
    later = [run.step_ms[s] for s in steps[1:]] or [run.step_ms[steps[0]]]
    ms = statistics.median(later)
    dev = sh.lead_device(run.state["step"])
    return {"steps": len(steps), "loss_first": run.losses[steps[0]],
            "loss_last": run.losses[steps[-1]], "step_ms_median": ms,
            "tokens_per_s": shape.global_batch * shape.seq_len / ms * 1e3,
            "straggler_flags": run.flagged, "restarts": run.restarts,
            "peak_allocated_bytes": (torch.cuda.max_memory_allocated(dev)
                                     if dev.type == "cuda" else None)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config of the same family")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-cross-pod", action="store_true")
    ap.add_argument("--max-restarts", type=int, default=2,
                    help="crash-restart attempts (fault tolerance)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = DV.resolve_device(args.device)
    cfg = configs.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, microbatches=args.microbatches)
    shape = ShapeConfig("train", "train", args.seq, args.batch)
    tcfg = tl.TrainConfig(
        optimizer=opt.OptimizerConfig(lr=args.lr, warmup_steps=20,
                                      total_steps=args.steps),
        compress_cross_pod=args.compress_cross_pod)

    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    mesh = elastic.plan_mesh(n_dev) if n_dev > 1 else None
    print(f"arch={cfg.name} devices={n_dev} "
          f"mesh={dict(zip(mesh.axis_names, mesh.shape)) if mesh else None}")
    run = train(cfg, shape, tcfg, args.steps, mesh=mesh, device=dev,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                max_restarts=args.max_restarts)
    print("training complete")
    print("summary " + json.dumps(summary(run, shape)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
