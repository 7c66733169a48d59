"""The train step: the chunked cross-entropy loss, microbatch gradient
accumulation, the optional int8 cross-pod gradient mean and the AdamW
update.

:func:`make_train_step` returns ``train_step(state, batch) -> (state,
metrics)`` over ``state = {"params", "opt", "step"}``, as the JAX
package's does; gradients come from :func:`torch.autograd.grad` on the
float32 master parameters. Call it under
``sharding.parallelism(ctx)`` to run it on a mesh:

- without compression the step computes the *global* function, as the
  JAX step does whatever its mesh: one loss over the whole batch, the
  router's aux loss from global means, capacity from the global token
  count where tp == 1. Only what the function itself splits runs per
  shard (the expert-parallel MoE dispatch and the Mamba scan's dp
  shards, :mod:`repro_torch.models.sharding`);
- with ``compress_cross_pod`` and a ``"pod"`` axis, pods are pure data
  replicas: each pod's gradients come from its slice of the batch on its
  own devices (under the pod's own ``("data", "model")`` mesh, so aux
  loss and capacity are per pod), then
  :func:`~repro_torch.training.grad_compress.compressed_psum_mean` over
  ``"pod"`` and the metrics' mean over pods.

The state is either plain (every leaf whole on one device, the lead
device under a mesh) or placed across the mesh by its specs
(:func:`init_state` with a mesh, :func:`repro_torch.models.sharding.place`):
then the model gathers each group's parameters as it runs, the
gradients come back cut into each slot's blocks, and AdamW updates each
slot's blocks on the slot's device, so the new state stays placed.

:func:`abstract_state`, :func:`state_specs` and :func:`batch_specs` give
the state's shapes on the meta device and the logical specs of state and
batch; :func:`to_stacked` and :func:`from_stacked` convert a state, plain
or placed, to and from the JAX package's layout (groups stacked on a
leading axis), the layout the launcher's checkpoints use
(:func:`stacked_specs` are its specs).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from ..analysis import op_cost
from ..configs.base import ModelConfig
from ..models import layers as L
from ..models import lm
from ..models import sharding as sh
from . import grad_compress as gc
from . import optimizer as opt


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: opt.OptimizerConfig = opt.OptimizerConfig()
    aux_loss_weight: float = 0.01
    # int8-compress the cross-pod gradient mean (pods become pure data
    # replicas); see grad_compress.py
    compress_cross_pod: bool = False


XENT_CHUNK = 512      # sequence positions per streamed cross-entropy chunk


def _chunked_xent(params, x, labels, cfg: ModelConfig) -> torch.Tensor:
    """Streaming cross-entropy: unembed and log-softmax one chunk of
    positions at a time, recomputed in the backward, so the (B, S, V)
    float32 logits never exist at once."""
    b, s, _ = x.shape
    chunk = min(XENT_CHUNK, s)
    if s % chunk != 0:
        chunk = s

    def body(x_c, y_c):
        logits = L.unembed(lm.gathered(params["embed"], x_c.device), x_c,
                           cfg.dtype)
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, y_c[..., None])[..., 0]
        return torch.sum(lse - tgt)

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(s // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        if torch.is_grad_enabled():
            part = checkpoint(body, x[:, sl], labels[:, sl],
                              use_reentrant=False,
                              context_fn=sh.checkpoint_context_fn())
        else:
            part = body(x[:, sl], labels[:, sl])
        total = total + part
    return total / (b * s)


def loss_fn(params, batch: Dict[str, Any], cfg: ModelConfig,
            aux_weight: float):
    """``batch``: ``tokens`` and ``labels`` (B, S), and ``frames`` (B,
    n_frames, D) for an encoder-decoder model or ``image_embeds`` (B,
    n_img_tokens, D) for a vision model."""
    kwargs = {}
    if cfg.is_encdec:
        kwargs["frames"] = batch["frames"]
    if cfg.n_img_tokens:
        kwargs["memory"] = batch["image_embeds"]
    x, aux = lm.forward(params, batch["tokens"], cfg, return_features=True,
                        **kwargs)
    loss = _chunked_xent(params, x, batch["labels"].long(), cfg)
    total = loss + aux_weight * aux
    return total, {"loss": loss, "aux_loss": aux,
                   "perplexity": torch.exp(torch.clamp(loss, 0, 20.0))}


def _on_tensors(fn, x):
    """``fn`` over a leaf's tensors (a placed leaf's blocks)."""
    if sh.is_placed(x):
        return x.with_tensors([fn(t) for t in x.tensors()])
    return fn(x)


def _value_and_grad(params, batch, cfg, aux_weight):
    """(grads, metrics) of :func:`loss_fn`; grads is a tree like
    ``params``, placed as they are (zeros for a leaf the loss does not
    reach)."""
    live = opt.tree_map(lambda p: _on_tensors(
        lambda t: t.detach().requires_grad_(True), p), params)
    leaves = [t for p in opt.tree_leaves(live) for t in sh.tensors_of(p)]
    with torch.enable_grad():
        total, metrics = loss_fn(live, batch, cfg, aux_weight)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    by_leaf = {id(p): torch.zeros_like(p) if g is None else g
               for p, g in zip(leaves, grads)}
    return (opt.tree_map(lambda p: _on_tensors(lambda t: by_leaf[id(t)], p),
                         live),
            {k: v.detach() for k, v in metrics.items()})


def _microbatch_grads(params, batch, cfg: ModelConfig, tcfg: TrainConfig):
    """Gradient accumulation over ``cfg.microbatches`` equal slices of
    the batch; gradients and metrics are their means."""
    nmb = cfg.microbatches
    if nmb <= 1:
        return _value_and_grad(params, batch, cfg, tcfg.aux_loss_weight)
    grads = metrics = None
    # each microbatch's forward and backward cost the same: a dry-run
    # counts one
    loop = op_cost.repeat(nmb)
    with loop.weighted():
        for i in range(loop.trips):
            mb = {k: v.reshape((nmb, v.shape[0] // nmb) + v.shape[1:])[i]
                  for k, v in batch.items()}
            g, m = _value_and_grad(params, mb, cfg, tcfg.aux_loss_weight)
            grads = g if grads is None else opt.tree_map(
                lambda a, b: sh.blockwise(torch.add, a, b), grads, g)
            metrics = m if metrics is None else {k: metrics[k] + m[k]
                                                 for k in m}
    if loop.trips < nmb:
        # a dry-run ran one microbatch: charge the eager loop's nmb - 1
        # sums of the gradients
        with op_cost.repeat(nmb - 1).weighted():
            opt.tree_map(lambda a: sh.blockwise(torch.add, a, a), grads)
    return (opt.tree_map(lambda g: sh.blockwise(lambda b: b / nmb, g),
                         grads),
            {k: v / nmb for k, v in metrics.items()})


def init_state(seed: int, cfg: ModelConfig,
               tcfg: TrainConfig = TrainConfig(), device=None,
               ctx: sh.Parallelism = sh.Parallelism()):
    """Parameters (:func:`repro_torch.models.lm.init_params`), zero
    moments and step 0 on ``device`` (``None`` = the card). With a mesh
    in ``ctx`` the state is placed across it by :func:`state_specs`: the
    parameters are drawn on ``device`` (the mesh's lead device by
    default) and placed, the moments made zero a block at a time."""
    dev = ctx.mesh.lead if ctx.mesh is not None and device is None else device
    specs = state_specs(cfg)
    params = sh.place(lm.init_params(seed, cfg, dev), specs["params"], ctx)
    step = torch.zeros((), dtype=torch.int32,
                       device=sh.lead_device(params["final_norm"]["scale"]))
    return {"params": params,
            "opt": opt.init_opt_state(params, tcfg.optimizer.moment_dtype),
            "step": sh.place(step, specs["step"], ctx)}


def abstract_state(cfg: ModelConfig, tcfg: TrainConfig = TrainConfig()):
    """:func:`init_state`'s tree on the meta device: shapes and dtypes,
    nothing allocated."""
    params = lm.abstract_params(cfg)
    return {"params": params,
            "opt": opt.init_opt_state(params, tcfg.optimizer.moment_dtype),
            "step": torch.zeros((), dtype=torch.int32, device="meta")}


def state_specs(cfg: ModelConfig):
    pspec = lm.param_specs(cfg)
    return {"params": pspec,
            "opt": {"m": pspec, "v": pspec},
            "step": ()}


def batch_specs(cfg: ModelConfig):
    spec = {"tokens": ("dp", None), "labels": ("dp", None)}
    if cfg.is_encdec:
        spec["frames"] = ("dp", None, None)
    if cfg.n_img_tokens:
        spec["image_embeds"] = ("dp", None, None)
    return spec


_STACKED = ("groups", "enc_groups")


def _restack(state, params_fn, step_fn):
    """``state`` with ``params_fn`` over each parameter-shaped tree (the
    parameters and both moments) and ``step_fn`` over ``step``."""
    return {"params": params_fn(state["params"]),
            "opt": {k: params_fn(v) for k, v in state["opt"].items()},
            "step": step_fn(state["step"])}


def stacked_specs(cfg: ModelConfig):
    """:func:`state_specs` in the JAX package's layout: each list of
    group specs as one spec tree with a replicated leading axis."""
    def stack(tree):
        return {k: sh.stack_spec(v[0]) if k in _STACKED else v
                for k, v in tree.items()}
    return _restack(state_specs(cfg), stack, lambda s: s)


def to_stacked(state, device="cpu"):
    """The state in the JAX package's layout on ``device``: each list of
    groups stacked on a leading axis, leaf by leaf; placed leaves are
    gathered whole there."""
    def whole(x):
        return sh.whole(x, device)

    def stack(tree):
        return {k: (opt.tree_map(lambda *xs: torch.stack(
                    [whole(x) for x in xs]), *v) if k in _STACKED
                    else opt.tree_map(whole, v))
                for k, v in tree.items()}
    return _restack(state, stack, whole)


def from_stacked(tree, device):
    """:func:`to_stacked`'s inverse: the stacked groups as lists. Plain
    leaves land on ``device``; placed ones (a checkpoint read with
    ``shardings``) stay placed, a group's entry of each stacked block."""
    def move(x):
        return x if sh.is_placed(x) else x.to(device)

    def unstack(t):
        return {k: ([opt.tree_map(lambda x: move(sh.index0(x, g)), v)
                     for g in range(opt.tree_leaves(v)[0].shape[0])]
                    if k in _STACKED
                    else opt.tree_map(move, v))
                for k, v in t.items()}
    return _restack(tree, unstack, move)


def _pod_grads(params, batch, cfg: ModelConfig, tcfg: TrainConfig,
               ctx: sh.Parallelism):
    """The compressed cross-pod gradients: each pod's
    :func:`_microbatch_grads` on its slice of the batch under the pod's
    own mesh, on the pod's lead device, then the int8 mean over
    ``"pod"`` and the metrics' mean on the mesh's lead device. Placed
    parameters are placed again on each pod's sub-mesh (the all-gather
    over ``"pod"``), so a pod gathers its groups within its own devices;
    their mean gradients come back placed as the parameters are. Plain
    parameters are copied whole to each pod's lead device."""
    mesh = ctx.mesh
    pods = sh.axis_sizes(mesh)["pod"]
    per_pod = []
    for k in range(pods):
        sub = sh.sub_mesh(mesh, "pod", k)
        sub_ctx = sh.make_parallelism(sub)
        dev = sub.lead
        mb = {n: v.reshape((pods, v.shape[0] // pods) + tuple(v.shape[1:]))
              [k].to(dev) for n, v in batch.items()}
        local = opt.tree_map(lambda p: sh.restrict(p, sub_ctx)
                             if sh.is_placed(p) else p.detach().to(dev),
                             params)
        with sh.parallelism(sub_ctx):
            per_pod.append(_microbatch_grads(local, mb, cfg, tcfg))
        del local
    grads = gc.compressed_psum_mean([g for g, _ in per_pod], mesh, "pod",
                                    like=params)
    metrics = {n: sum(m[n].to(mesh.lead) for _, m in per_pod) / pods
               for n in per_pod[0][1]}
    return grads, metrics


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig = TrainConfig()):
    """Returns ``train_step(state, batch) -> (state, metrics)``; the mesh
    is the calling thread's :func:`repro_torch.models.sharding.current`
    context."""

    def train_step(state, batch):
        ctx = sh.current()
        step = sh.whole(state["step"])
        if (tcfg.compress_cross_pod and ctx.mesh is not None
                and "pod" in ctx.mesh.axis_names):
            grads, metrics = _pod_grads(state["params"], batch, cfg, tcfg,
                                        ctx)
        else:
            grads, metrics = _microbatch_grads(state["params"], batch, cfg,
                                               tcfg)
        params, opt_state, om = opt.adamw_step(
            state["params"], grads, state["opt"], step, tcfg.optimizer)
        metrics = dict(metrics, **om)
        nxt = step + 1
        if sh.is_placed(state["step"]):
            nxt = sh.put(nxt, state["step"].sharding)
        return ({"params": params, "opt": opt_state, "step": nxt}, metrics)

    return train_step
