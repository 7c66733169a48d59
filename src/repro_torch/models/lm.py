"""Model assembly: embedding, the loop over layer groups, final norm and
head. Three entry points a model:

* :func:`forward`     -- the training path (full sequence, no cache);
* :func:`prefill`     -- fills the decode cache, returns the last
                         position's logits;
* :func:`decode_step` -- one token with the cache.

Parameters: ``{"embed": {"table"}, "groups": [group, ...],
"final_norm": {"scale"}}``, a group being ``{"b0": block, ...}`` in the
architecture's group layout, and for an encoder-decoder model (whisper)
``"enc_groups"``, ``cfg.enc_layers`` groups of one :data:`ENC_DESC`
block, and ``"enc_norm"``; the decode cache is a list alike, one
``{"b0": block cache, ...}`` a group. The JAX package stacks the groups
on a leading axis for its ``lax.scan``; here they are lists and the
scan is a Python loop (:func:`repro_torch.convert.lm_params_from_numpy`
and :func:`~repro_torch.convert.lm_cache_from_numpy` unstack a JAX
tree).

Cross-attention reads ``memory`` (B, M, D): an encoder-decoder model
makes it from ``frames`` (B, n_frames, D) with :func:`encode`; a vision
model takes the image embeddings as ``memory``. A model without cross
blocks ignores memory, as in the JAX package.

Every entry point takes a plain tree or one placed across a mesh
(:func:`repro_torch.models.sharding.place`): a group's parameters are
gathered onto the activations' device at the start of the group's body
(again in a recompute), and the embedding table and the norms where
they are used, so no gathered group outlives its use.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .. import _device as DV
from ..configs.base import BlockDesc, ModelConfig
from . import blocks as B
from . import layers as L
from . import moe as M
from . import sharding as sh

#: the encoder's block: bidirectional GQA and the GELU MLP
ENC_DESC = BlockDesc(mixer="gqa", ffn="gelu")


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
    params = {
        "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model),
        "groups": [_init_group(gen, cfg, cfg.group_layout)
                   for _ in range(cfg.n_groups)],
        "final_norm": L.init_rmsnorm(cfg.d_model, gen.device),
    }
    if cfg.is_encdec:
        params["enc_groups"] = [_init_group(gen, cfg, (ENC_DESC,))
                                for _ in range(cfg.enc_layers)]
        params["enc_norm"] = L.init_rmsnorm(cfg.d_model, gen.device)
    return params



def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The logical specs of :func:`init_params`'s tree: the same dicts
    and lists, a tuple of logical axis names a leaf. A group's specs are
    the JAX package's stacked ones without the leading stack axis
    (:func:`repro_torch.models.sharding.stack_spec` adds it back)."""
    group_spec = {f"b{i}": B.spec_block(cfg, d)
                  for i, d in enumerate(cfg.group_layout)}
    specs: Dict[str, Any] = {
        "embed": L.spec_embedding(),
        "groups": [group_spec for _ in range(cfg.n_groups)],
        "final_norm": L.spec_rmsnorm(),
    }
    if cfg.is_encdec:
        enc = {"b0": B.spec_block(cfg, ENC_DESC)}
        specs["enc_groups"] = [enc for _ in range(cfg.enc_layers)]
        specs["enc_norm"] = L.spec_rmsnorm()
    return specs


class _OnMeta(torch.overrides.TorchFunctionMode):
    """Every factory call that names a device makes its tensor on the
    meta device instead, drawing nothing (the generator is dropped)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = torch.device("meta")
            kwargs.pop("generator", None)
        return func(*args, **kwargs)


def abstract_params(cfg: ModelConfig) -> Dict[str, Any]:
    """:func:`init_params`'s tree on the meta device: every leaf's shape
    and dtype, no memory allocated and no number drawn (the JAX
    package's ``eval_shape``), so it sizes configs of 100 B+ parameters."""
    with _OnMeta():
        return init_params(0, cfg, device="cpu")

def gathered(tree, device):
    """``tree`` with each placed leaf gathered whole on ``device``
    (:func:`repro_torch.models.sharding.gather`); plain leaves as they
    are. Under expert parallelism (tp > 1) an MoE's expert stacks stay
    placed: each tp rank gathers its own experts
    (:func:`repro_torch.models.moe.moe_ffn`)."""
    ep = sh.current().tp_size > 1

    def walk(node):
        if isinstance(node, dict):
            keep = M.EXPERT_STACKS if ep and "router" in node else ()
            return {k: v if k in keep else walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return sh.gather(node, device)

    return walk(tree)


def encode(params, frames: torch.Tensor, cfg: ModelConfig):
    """The encoder (whisper): frame embeddings (B, n_frames, D) through
    ``cfg.enc_layers`` bidirectional blocks and the encoder norm; each
    block recomputed in the backward when ``cfg.remat``."""
    x = frames.to(cfg.dtype)
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)[None]

    def body(x, gp):
        gp = gathered(gp, x.device)
        return B.block_forward(gp["b0"], x, cfg, ENC_DESC,
                               positions=positions, causal=False)[0]

    remat = cfg.remat and torch.is_grad_enabled()
    for gp in params["enc_groups"]:
        x = _ckpt(body, x, gp) if remat else body(x, gp)
    return L.rmsnorm(gathered(params["enc_norm"], x.device), x, cfg.norm_eps)


def _memory(params, cfg: ModelConfig, memory, frames):
    """The cross-attention memory in the compute dtype: the encoded
    frames of an encoder-decoder model, else ``memory`` as given."""
    if cfg.is_encdec:
        if frames is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder model: "
                             f"give it frames")
        memory = encode(params, frames, cfg)
    return None if memory is None else memory.to(cfg.dtype)


def _sqrt_factor(n: int) -> int:
    """Largest divisor of n that is <= sqrt(n)."""
    best, d = 1, 1
    while d * d <= n:
        if n % d == 0:
            best = d
        d += 1
    return best


def _ckpt(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=sh.checkpoint_context_fn())


def _scan_groups_remat(body, carry, groups, n_groups: int, remat: bool,
                       device=None):
    """Loop ``carry = body(carry, group)`` over the groups, each group's
    placed parameters gathered on ``device`` at the start of its body
    (:func:`gathered`). With ``remat`` under autograd, the JAX package's
    O(sqrt(L)) activation plan: each group recomputed in the backward,
    gathers included, inside an outer recompute over super-groups of
    about sqrt(n_groups) groups."""
    inner_body = body

    def body(c, gp):
        return inner_body(c, gathered(gp, device))

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
            memory: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None,
            return_features: bool = False):
    """tokens (B, S) -> (logits (B, S, V) float32, aux_loss scalar). With
    ``return_features``: (features (B, S, D) after the final norm, aux),
    what the chunked cross-entropy consumes. ``frames`` (B, n_frames, D)
    for an encoder-decoder model, ``memory`` (B, M, D) for a vision
    model."""
    memory = _memory(params, cfg, memory, frames)
    x = L.embed(gathered(params["embed"], tokens.device), tokens, cfg.dtype)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)[None]

    def body(carry, gp):
        x, aux = carry
        for i, desc in enumerate(cfg.group_layout):
            x, a = B.block_forward(gp[f"b{i}"], x, cfg, desc,
                                   positions=positions, memory=memory)
            aux = aux + a
        return x, aux

    aux0 = torch.zeros((), dtype=torch.float32, device=tokens.device)
    x, aux = _scan_groups_remat(body, (x, aux0), params["groups"],
                                cfg.n_groups, cfg.remat, tokens.device)
    x = L.rmsnorm(gathered(params["final_norm"], x.device), x, cfg.norm_eps)
    if return_features:
        return x, aux
    return L.unembed(gathered(params["embed"], x.device), x, cfg.dtype), aux


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def _memory_len(cfg: ModelConfig, max_len: int) -> int:
    """The cross K/V buffer's length in a fresh cache (the JAX package's
    sizes; prefill replaces the buffer by the memory's own K/V)."""
    if cfg.is_encdec:
        return max_len
    if cfg.n_img_tokens:
        return cfg.n_img_tokens
    return 1


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """The decode state, zeros on ``device`` (``None`` = the card): a
    list of ``cfg.n_groups`` group caches."""
    dev = DV.resolve_device(device)
    n_mem = _memory_len(cfg, max_len)
    return [{f"b{i}": B.init_block_cache(cfg, d, batch, max_len, n_mem, dev)
             for i, d in enumerate(cfg.group_layout)}
            for _ in range(cfg.n_groups)]



def cache_specs(cfg: ModelConfig):
    """The logical specs of :func:`init_cache`'s list (one group's
    specs a group)."""
    group = {f"b{i}": B.block_cache_spec(cfg, d)
             for i, d in enumerate(cfg.group_layout)}
    return [group for _ in range(cfg.n_groups)]

@torch.no_grad()
def prefill(params, tokens: torch.Tensor, cache, cfg: ModelConfig,
            memory=None, frames=None):
    """Fills ``cache`` from a full prompt (B, S); returns (last-position
    logits (B, 1, V) float32, cache). No gradient: the Mamba layers take
    the selective-scan kernel's end-state form. The attention caches are
    written in place, so the returned cache aliases ``cache``; each
    cross block's ``cross_kv`` becomes the memory's K/V, of the memory's
    length. ``memory`` and ``frames`` as in :func:`forward`."""
    memory = _memory(params, cfg, memory, frames)
    dev = tokens.device
    x = L.embed(gathered(params["embed"], dev), tokens, cfg.dtype)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=dev)[None]
    new_cache = []
    for gp, gc in zip(params["groups"], cache, strict=True):
        gp = gathered(gp, dev)
        new_gc = {}
        for i, desc in enumerate(cfg.group_layout):
            x, new_gc[f"b{i}"] = B.block_prefill(
                gp[f"b{i}"], x, cfg, desc, gc[f"b{i}"], positions=positions,
                memory=memory)
        new_cache.append(new_gc)
    x = L.rmsnorm(gathered(params["final_norm"], dev), x[:, -1:],
                  cfg.norm_eps)
    return L.unembed(gathered(params["embed"], dev), x, cfg.dtype), new_cache


@torch.no_grad()
def decode_step(params, token: torch.Tensor, cache, pos: int,
                cfg: ModelConfig):
    """One new token (B, 1) given the cache at position ``pos``. Returns
    (logits (B, 1, V) float32, cache); the attention caches are written
    in place."""
    dev = token.device
    x = L.embed(gathered(params["embed"], dev), token, cfg.dtype)
    new_cache = []
    for gp, gc in zip(params["groups"], cache, strict=True):
        gp = gathered(gp, dev)
        new_gc = {}
        for i, desc in enumerate(cfg.group_layout):
            x, new_gc[f"b{i}"] = B.block_decode(gp[f"b{i}"], x, cfg, desc,
                                                gc[f"b{i}"], pos=pos)
        new_cache.append(new_gc)
    x = L.rmsnorm(gathered(params["final_norm"], dev), x, cfg.norm_eps)
    return L.unembed(gathered(params["embed"], dev), x, cfg.dtype), new_cache
