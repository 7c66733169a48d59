"""Model assembly: embedding, the loop over layer groups, final norm and
head; the training forward.

Parameters: ``{"embed": {"table"}, "groups": [group, ...],
"final_norm": {"scale"}}``, a group being ``{"b0": block, ...}`` in the
architecture's group layout. The JAX package stacks the groups on a
leading axis for its ``lax.scan``; here they are a list and the scan is
a Python loop (:func:`repro_torch.convert.lm_params_from_numpy` unstacks
a JAX tree). ``prefill``, ``decode_step`` and the encoder are not ported
yet.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from .. import _device as DV
from ..configs.base import ModelConfig
from . import blocks as B
from . import layers as L


def _init_group(gen, cfg, layout):
    return {f"b{i}": B.init_block(gen, cfg, d) for i, d in enumerate(layout)}


def init_params(seed: int, cfg: ModelConfig, device=None) -> Dict[str, Any]:
    """Float32 master parameters drawn on ``device`` (``None`` = the
    card) from a :class:`torch.Generator` there seeded with ``seed`` (the
    JAX package's ``key``). A generator on the card and one on the CPU
    draw different numbers: to run one model on both, draw once and
    copy."""
    gen = torch.Generator(device=DV.resolve_device(device))
    gen.manual_seed(int(seed))
    return {
        "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model),
        "groups": [_init_group(gen, cfg, cfg.group_layout)
                   for _ in range(cfg.n_groups)],
        "final_norm": L.init_rmsnorm(cfg.d_model, gen.device),
    }


def _sqrt_factor(n: int) -> int:
    """Largest divisor of n that is <= sqrt(n)."""
    best, d = 1, 1
    while d * d <= n:
        if n % d == 0:
            best = d
        d += 1
    return best


def _ckpt(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False)


def _scan_groups_remat(body, carry, groups, n_groups: int, remat: bool):
    """Loop ``carry = body(carry, group)`` over the groups. With
    ``remat`` under autograd, the JAX package's O(sqrt(L)) activation
    plan: each group recomputed in the backward, inside an outer
    recompute over super-groups of about sqrt(n_groups) groups."""
    if not remat or not torch.is_grad_enabled():
        for gp in groups:
            carry = body(carry, gp)
        return carry
    outer = _sqrt_factor(n_groups)
    if outer <= 1:
        for gp in groups:
            carry = _ckpt(body, carry, gp)
        return carry
    inner = n_groups // outer

    def super_body(c, super_gp):
        for gp in super_gp:
            c = _ckpt(body, c, gp)
        return c

    for o in range(outer):
        carry = _ckpt(super_body, carry, groups[o * inner:(o + 1) * inner])
    return carry


def forward(params, tokens: torch.Tensor, cfg: ModelConfig,
            return_features: bool = False):
    """tokens (B, S) -> (logits (B, S, V) float32, aux_loss scalar). With
    ``return_features``: (features (B, S, D) after the final norm, aux),
    what the chunked cross-entropy consumes."""
    if cfg.is_encdec or cfg.n_img_tokens:
        raise NotImplementedError("encoder-decoder and image-memory models "
                                  "wait for a later slice of the port")
    x = L.embed(params["embed"], tokens, cfg.dtype)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)[None]

    def body(carry, gp):
        x, aux = carry
        for i, desc in enumerate(cfg.group_layout):
            x, a = B.block_forward(gp[f"b{i}"], x, cfg, desc,
                                   positions=positions)
            aux = aux + a
        return x, aux

    aux0 = torch.zeros((), dtype=torch.float32, device=tokens.device)
    x, aux = _scan_groups_remat(body, (x, aux0), params["groups"],
                                cfg.n_groups, cfg.remat)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if return_features:
        return x, aux
    return L.unembed(params["embed"], x, cfg.dtype), aux
