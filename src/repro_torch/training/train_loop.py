"""The train step: the chunked cross-entropy loss, microbatch gradient
accumulation and the AdamW update.

:func:`make_train_step` returns ``train_step(state, batch) -> (state,
metrics)`` over ``state = {"params", "opt", "step"}``, as the JAX
package's does; gradients come from :func:`torch.autograd.grad` on the
float32 master parameters. The JAX package's int8 cross-pod gradient
sync is not ported (one device).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..models import layers as L
from ..models import lm
from . import optimizer as opt


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: opt.OptimizerConfig = opt.OptimizerConfig()
    aux_loss_weight: float = 0.01


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
        logits = L.unembed(params["embed"], x_c, cfg.dtype)
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, y_c[..., None])[..., 0]
        return torch.sum(lse - tgt)

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(s // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        if torch.is_grad_enabled():
            part = checkpoint(body, x[:, sl], labels[:, sl],
                              use_reentrant=False)
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


def _value_and_grad(params, batch, cfg, aux_weight):
    """(grads, metrics) of :func:`loss_fn`; grads is a tree like
    ``params`` (zeros for a leaf the loss does not reach)."""
    live = opt.tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = opt.tree_leaves(live)
    with torch.enable_grad():
        total, metrics = loss_fn(live, batch, cfg, aux_weight)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    by_leaf = {id(p): torch.zeros_like(p) if g is None else g
               for p, g in zip(leaves, grads)}
    return (opt.tree_map(lambda p: by_leaf[id(p)], live),
            {k: v.detach() for k, v in metrics.items()})


def _microbatch_grads(params, batch, cfg: ModelConfig, tcfg: TrainConfig):
    """Gradient accumulation over ``cfg.microbatches`` equal slices of
    the batch; gradients and metrics are their means."""
    nmb = cfg.microbatches
    if nmb <= 1:
        return _value_and_grad(params, batch, cfg, tcfg.aux_loss_weight)
    grads = metrics = None
    for i in range(nmb):
        mb = {k: v.reshape((nmb, v.shape[0] // nmb) + v.shape[1:])[i]
              for k, v in batch.items()}
        g, m = _value_and_grad(params, mb, cfg, tcfg.aux_loss_weight)
        grads = g if grads is None else opt.tree_map(torch.add, grads, g)
        metrics = m if metrics is None else {k: metrics[k] + m[k]
                                             for k in m}
    return (opt.tree_map(lambda g: g / nmb, grads),
            {k: v / nmb for k, v in metrics.items()})


def init_state(seed: int, cfg: ModelConfig,
               tcfg: TrainConfig = TrainConfig(), device=None):
    """Parameters (:func:`repro_torch.models.lm.init_params`), zero
    moments and step 0 on ``device`` (``None`` = the card)."""
    params = lm.init_params(seed, cfg, device)
    return {"params": params,
            "opt": opt.init_opt_state(params, tcfg.optimizer.moment_dtype),
            "step": torch.zeros((), dtype=torch.int32,
                                device=params["final_norm"]["scale"].device)}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig = TrainConfig()):
    """Returns ``train_step(state, batch) -> (state, metrics)``."""

    def train_step(state, batch):
        grads, metrics = _microbatch_grads(state["params"], batch, cfg,
                                           tcfg)
        params, opt_state, om = opt.adamw_step(
            state["params"], grads, state["opt"], state["step"],
            tcfg.optimizer)
        metrics = dict(metrics, **om)
        return ({"params": params, "opt": opt_state,
                 "step": state["step"] + 1}, metrics)

    return train_step
