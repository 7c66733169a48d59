"""Composable blocks: a pre-norm mixer sub-layer and a pre-norm FFN
sub-layer, both residual. The mixer and FFN kinds come from the
architecture's group layout, so Jamba's 1:7 attention:mamba interleave
with its alternating SwiGLU / MoE FFNs composes from one code path.

Three paths a block: the train forward (no cache), prefill (the whole
prompt, filling the block's decode cache) and one-token decode. A
block's cache is ``{"attn": {"k", "v"}}`` for GQA and ``{"mamba":
{"conv", "ssm"}}`` for Mamba; the K/V are written in place, so a cache
returned by prefill or decode aliases the one passed in.

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


def init_block_cache(cfg, desc, batch: int, max_len: int, device=None):
    """Decode-time state for one block, zeros on ``device``."""
    _check(desc)
    if desc.mixer == "gqa":
        return {"attn": A.init_gqa_cache(cfg, batch, max_len, cfg.dtype,
                                         device)}
    return {"mamba": S.init_mamba_state(cfg, batch, device)}


def block_prefill(p, x, cfg, desc, cache, *, positions):
    """Prefill: the full prompt, filling the decode cache (the prompt's
    K/V written into slots [0, S) in place). Returns (x, cache)."""
    _check(desc)
    new_cache = dict(cache)
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    if desc.mixer == "gqa":
        y, (k, v) = A.gqa_forward(p["mixer"], h, positions, cfg, causal=True,
                                  return_kv=True)
        kc, vc = cache["attn"]["k"], cache["attn"]["v"]
        kc[:, :, :k.shape[2]] = k
        vc[:, :, :v.shape[2]] = v
        new_cache["attn"] = {"k": kc, "v": vc}
    else:
        y, new_cache["mamba"] = S.mamba_forward(p["mixer"], h, cfg,
                                                return_state=True)
    x = x + y
    h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
    out, _ = _apply_ffn(p, h, cfg, desc)
    return x + out, new_cache


def block_decode(p, x, cfg, desc, cache, *, pos: int):
    """One-token decode. x (B,1,D). Returns (x, cache)."""
    _check(desc)
    new_cache = dict(cache)
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    if desc.mixer == "gqa":
        y, new_cache["attn"] = A.gqa_decode(p["mixer"], h, cache["attn"],
                                            pos, cfg)
    else:
        y, new_cache["mamba"] = S.mamba_forward(p["mixer"], h, cfg,
                                                state=cache["mamba"],
                                                return_state=True)
    x = x + y
    h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
    out, _ = _apply_ffn(p, h, cfg, desc)
    return x + out, new_cache
