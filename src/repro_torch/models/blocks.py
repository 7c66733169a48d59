"""Composable blocks: a pre-norm mixer sub-layer and a pre-norm FFN
sub-layer, both residual. The mixer and FFN kinds come from the
architecture's group layout, so Jamba's 1:7 attention:mamba interleave
with its alternating SwiGLU / MoE FFNs composes from one code path.

Ported kinds: mixers ``gqa`` and ``mamba``, FFNs ``swiglu`` and ``moe``.
The JAX package's others (``mla``, ``cross``, ``rwkv6``; ``gelu``,
``rwkv_cm``) raise :class:`NotImplementedError`.
"""
from __future__ import annotations

import torch

from . import attention as A
from . import layers as L
from . import moe as M
from . import ssm as S

_MIXERS = ("gqa", "mamba")
_FFNS = ("swiglu", "moe")


def _check(desc):
    if desc.mixer not in _MIXERS or desc.ffn not in _FFNS or desc.cross:
        raise NotImplementedError(
            f"block {desc}: the port runs mixers {_MIXERS} and FFNs "
            f"{_FFNS} without cross-attention; MLA, cross-attention, RWKV6 "
            f"and the GELU MLP wait for a later slice of the port")


def init_block(gen: torch.Generator, cfg, desc):
    _check(desc)
    d = cfg.d_model
    p = {"norm1": L.init_rmsnorm(d, gen.device),
         "norm2": L.init_rmsnorm(d, gen.device)}
    p["mixer"] = (A.init_gqa(gen, cfg) if desc.mixer == "gqa"
                  else S.init_mamba(gen, cfg))
    p["ffn"] = (L.init_mlp(gen, d, cfg.d_ff) if desc.ffn == "swiglu"
                else M.init_moe(gen, cfg))
    return p


def _apply_ffn(p, x, cfg, desc):
    """Returns (out, aux)."""
    if desc.ffn == "swiglu":
        return L.mlp(p["ffn"], x, cfg.dtype), 0.0
    return M.moe_ffn(p["ffn"], x, cfg)


def block_forward(p, x, cfg, desc, *, positions=None, causal: bool = True):
    """Train path: the full sequence, no cache. Returns (x, aux)."""
    _check(desc)
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    if desc.mixer == "gqa":
        y = A.gqa_forward(p["mixer"], h, positions, cfg, causal=causal)
    else:
        y = S.mamba_forward(p["mixer"], h, cfg)
    x = x + y
    h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
    out, aux = _apply_ffn(p, h, cfg, desc)
    return x + out, aux
