"""AdamW with a warmup + cosine schedule and global-norm clipping;
float32 moments shaped like the (float32 master) parameters.

Parameters, gradients and moments are the same nested dict / list trees
(:mod:`repro_torch.models.lm`); :func:`tree_leaves` and :func:`tree_map`
walk them in the JAX package's order (dict keys sorted), so the
global norm sums its leaves in the same order.

A leaf may be placed across a mesh
(:class:`repro_torch.models.sharding.Placed`): the update then runs a
slot at a time on the slot's device and the new state stays placed; the
global norm sums each distinct block once, so replicated copies are not
counted twice. Each leaf's squares are summed in float64 (block by
block for a placed leaf) and the leaf's total rounded to float32 once:
the norm then does not depend on how a mesh cuts the leaf, so a placed
state takes the steps a whole one takes, and a run resumed on another
mesh the steps the first mesh would have.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from ..analysis import op_cost
from ..models import sharding as sh


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    # "float32" or "bfloat16"
    moment_dtype: str = "float32"


def tree_leaves(tree):
    """The tensors of a nested dict / list / tuple tree, dict keys in
    sorted order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of the
    trees in ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *[r[k] for r in rest])
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *[r[i] for r in rest])
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def schedule(step: torch.Tensor, cfg: OptimizerConfig) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac)
                    * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params, moment_dtype: str = "float32") -> Dict[str, Any]:
    dt = getattr(torch, moment_dtype)

    def zeros(p):
        return sh.blockwise(lambda b: torch.zeros_like(b, dtype=dt), p)

    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def _sum_sq(x: torch.Tensor) -> torch.Tensor:
    """The squares of ``x`` in float32, summed in float64."""
    return torch.sum(torch.square(x.to(torch.float32)), dtype=torch.float64)


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    lead = sh.lead_device(leaves[0])
    total = torch.zeros((), dtype=torch.float32, device=lead)
    for leaf in leaves:
        if sh.is_placed(leaf):
            blocks = list(leaf.cells().values())
            parts = op_cost.each(len(blocks), lambda i: _sum_sq(blocks[i]))
            part = torch.stack([p.to(lead) for p in parts]).sum()
        else:
            part = _sum_sq(leaf)
        total = total + part.to(torch.float32)
    return torch.sqrt(total)


def adamw_step(params, grads, opt_state, step: torch.Tensor,
               cfg: OptimizerConfig):
    """Returns (new_params, new_opt_state, metrics); nothing is updated
    in place."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = schedule(step, cfg)
    t = (step + 1).to(torch.float32)
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t

    def upd(p, g, m, v):
        mdt = m.dtype
        dev = p.device
        scale_, lr_, bc1_, bc2_ = (t.to(dev) for t in (scale, lr, bc1, bc2))
        g = g.to(torch.float32) * scale_
        m = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g
        v = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * g * g
        step_ = (m / bc1_) / (torch.sqrt(v / bc2_) + cfg.eps)
        # decoupled weight decay on matrices only (ndim >= 2)
        wd = cfg.weight_decay if p.dim() >= 2 else 0.0
        pf = p.to(torch.float32)
        newp = pf - lr_ * (step_ + wd * pf)
        return newp.to(p.dtype), m.to(mdt), v.to(mdt)

    out = tree_map(lambda *x: sh.blockwise(upd, *x), params, grads,
                   opt_state["m"], opt_state["v"])
    return (_pick(out, 0), {"m": _pick(out, 1), "v": _pick(out, 2)},
            {"grad_norm": gnorm, "lr": lr})


def _pick(tree, i):
    """Element ``i`` of every (new_p, new_m, new_v) leaf tuple."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]
