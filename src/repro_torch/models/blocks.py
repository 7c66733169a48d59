"""Composable blocks: a pre-norm mixer sub-layer, an optional pre-norm
cross-attention sub-layer and a pre-norm FFN sub-layer, all residual.
The mixer and FFN kinds come from the architecture's group layout, so
Jamba's 1:7 attention:mamba interleave, llama-vision's gated cross block
every fifth layer and whisper's decoder compose from one code path.

Mixers: ``gqa``, ``mla``, ``cross``, ``rwkv6`` and ``mamba``; FFNs:
``swiglu``, ``gelu``, ``moe`` and ``rwkv_cm``; ``desc.cross`` adds the
cross sub-layer (``norm_x``, ``cross``) after the mixer.

Three paths a block: the train forward (no cache), prefill (the whole
prompt, filling the block's decode cache) and one-token decode. A
block's cache holds ``"attn"`` ({"k", "v"} for GQA, {"c_kv", "k_rope"}
for MLA), ``"mamba"`` ({"conv", "ssm"}), ``"rwkv"`` ({"x_prev", "wkv"})
with ``"cm_prev"`` for the channel-mix, and ``"cross_kv"`` ({"k", "v"}
of the memory) for cross-attention. The attention caches are written in
place, so a cache returned by prefill or decode aliases the one passed
in; prefill replaces ``cross_kv`` by the memory's K/V, of the memory's
length whatever the buffer it was given.
"""
from __future__ import annotations

import torch
import torch.nn.functional as Fn

from . import attention as A
from . import layers as L
from . import moe as M
from . import ssm as S


# --- GELU MLP (whisper) ----------------------------------------------------

def init_gelu_mlp(gen: torch.Generator, d: int, f: int):
    return {"w_in": L.init_dense(gen, (d, f), d),
            "w_out": L.init_dense(gen, (f, d), f)}


def spec_gelu_mlp():
    return {"w_in": ("fsdp", "tp"), "w_out": ("tp", "fsdp")}


def gelu_mlp(p, x, dtype):
    # the tanh form: jax.nn.gelu's default, not torch's (erf)
    h = Fn.gelu(torch.einsum("bsd,df->bsf", x, L.gathered(p["w_in"], dtype)),
                approximate="tanh")
    return torch.einsum("bsf,fd->bsd", h, L.gathered(p["w_out"], dtype))


# --- block -------------------------------------------------------------------

def init_block(gen: torch.Generator, cfg, desc):
    d = cfg.d_model
    p = {"norm1": L.init_rmsnorm(d, gen.device),
         "norm2": L.init_rmsnorm(d, gen.device)}
    if desc.mixer == "gqa":
        p["mixer"] = A.init_gqa(gen, cfg)
    elif desc.mixer == "mla":
        p["mixer"] = A.init_mla(gen, cfg)
    elif desc.mixer == "cross":
        p["mixer"] = A.init_cross(gen, cfg, gated=desc.gated)
    elif desc.mixer == "rwkv6":
        p["mixer"] = S.init_rwkv6(gen, cfg)
    elif desc.mixer == "mamba":
        p["mixer"] = S.init_mamba(gen, cfg)
    else:
        raise ValueError(f"unknown mixer {desc.mixer!r}")
    if desc.cross:                      # extra cross sub-layer (whisper)
        p["norm_x"] = L.init_rmsnorm(d, gen.device)
        p["cross"] = A.init_cross(gen, cfg, gated=desc.gated)
    if desc.ffn == "swiglu":
        p["ffn"] = L.init_mlp(gen, d, cfg.d_ff)
    elif desc.ffn == "gelu":
        p["ffn"] = init_gelu_mlp(gen, d, cfg.d_ff)
    elif desc.ffn == "moe":
        p["ffn"] = M.init_moe(gen, cfg)
    elif desc.ffn == "rwkv_cm":
        p["ffn"] = S.init_rwkv_cm(gen, cfg)
    else:
        raise ValueError(f"unknown FFN {desc.ffn!r}")
    return p


def spec_block(cfg, desc):
    """The logical specs of :func:`init_block`'s tree."""
    s = {"norm1": L.spec_rmsnorm(), "norm2": L.spec_rmsnorm()}
    s["mixer"] = {"gqa": A.spec_gqa, "mla": A.spec_mla,
                  "cross": lambda: A.spec_cross(desc.gated),
                  "rwkv6": S.spec_rwkv6, "mamba": S.spec_mamba}[desc.mixer]()
    if desc.cross:
        s["norm_x"] = L.spec_rmsnorm()
        s["cross"] = A.spec_cross(desc.gated)
    s["ffn"] = {"swiglu": L.spec_mlp, "gelu": spec_gelu_mlp,
                "moe": lambda: M.spec_moe(cfg),
                "rwkv_cm": S.spec_rwkv_cm}[desc.ffn]()
    return s


def init_block_cache(cfg, desc, batch: int, max_len: int, n_memory: int = 1,
                     device=None):
    """Decode-time state for one block, zeros on ``device``;
    ``n_memory`` sizes the cross-attention K/V buffer."""
    cache = {}
    if desc.mixer == "gqa":
        cache["attn"] = A.init_gqa_cache(cfg, batch, max_len, cfg.dtype,
                                         device)
    elif desc.mixer == "mla":
        cache["attn"] = A.init_mla_cache(cfg, batch, max_len, cfg.dtype,
                                         device)
    elif desc.mixer == "rwkv6":
        cache["rwkv"] = S.init_rwkv6_state(cfg, batch, device)
    elif desc.mixer == "mamba":
        cache["mamba"] = S.init_mamba_state(cfg, batch, device)
    if desc.mixer == "cross" or desc.cross:
        shape = (batch, cfg.n_kv_heads, n_memory, cfg.head_dim)
        cache["cross_kv"] = {
            "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
    if desc.mixer == "rwkv6" or desc.ffn == "rwkv_cm":
        cache["cm_prev"] = torch.zeros((batch, cfg.d_model), dtype=cfg.dtype,
                                       device=device)
    return cache


def block_cache_spec(cfg, desc):
    """The logical specs of :func:`init_block_cache`'s tree."""
    spec = {}
    if desc.mixer in ("gqa", "mla"):
        spec["attn"] = (A.gqa_cache_spec(cfg) if desc.mixer == "gqa"
                        else A.mla_cache_spec(cfg))
    elif desc.mixer == "rwkv6":
        spec["rwkv"] = S.rwkv6_state_spec(cfg)
        spec["cm_prev"] = ("dp", None)
    elif desc.mixer == "mamba":
        spec["mamba"] = S.mamba_state_spec(cfg)
    if desc.mixer == "cross" or desc.cross:
        kv = (("dp", "tp", None, None) if cfg.n_kv_heads % 16 == 0
              else ("dp", None, "tp", None))
        spec["cross_kv"] = {"k": kv, "v": kv}
    if desc.ffn == "rwkv_cm":
        spec["cm_prev"] = ("dp", None)
    return spec


def _apply_ffn(p, x, cfg, desc, cm_prev=None):
    """Returns (out, aux, the channel-mix's new previous token or None)."""
    if desc.ffn == "swiglu":
        return L.mlp(p["ffn"], x, cfg.dtype), 0.0, None
    if desc.ffn == "gelu":
        return gelu_mlp(p["ffn"], x, cfg.dtype), 0.0, None
    if desc.ffn == "moe":
        out, aux = M.moe_ffn(p["ffn"], x, cfg)
        return out, aux, None
    out, new_prev = S.rwkv_cm_forward(p["ffn"], x, cfg, cm_prev,
                                      return_state=True)
    return out, 0.0, new_prev


def _cross_sublayer(p, x, cfg, kv):
    h = L.rmsnorm(p["norm_x"], x, cfg.norm_eps)
    return x + A.cross_forward(p["cross"], h, kv, cfg)


def block_forward(p, x, cfg, desc, *, positions=None, memory=None,
                  causal: bool = True):
    """Train / encoder path: the full sequence, no cache. Returns
    (x, aux)."""
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    if desc.mixer == "gqa":
        y = A.gqa_forward(p["mixer"], h, positions, cfg, causal=causal)
    elif desc.mixer == "mla":
        y = A.mla_forward(p["mixer"], h, positions, cfg, causal=causal)
    elif desc.mixer == "cross":
        y = A.cross_forward(p["mixer"], h,
                            A.cross_kv(p["mixer"], memory, cfg), cfg)
    elif desc.mixer == "rwkv6":
        y = S.rwkv6_forward(p["mixer"], h, cfg)
    else:
        y = S.mamba_forward(p["mixer"], h, cfg)
    x = x + y
    if desc.cross:
        x = _cross_sublayer(p, x, cfg, A.cross_kv(p["cross"], memory, cfg))
    h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
    out, aux, _ = _apply_ffn(p, h, cfg, desc)
    return x + out, aux


def block_prefill(p, x, cfg, desc, cache, *, positions, memory=None):
    """Prefill: the full prompt, filling the decode cache (the prompt's
    K/V or latents written into slots [0, S) in place). Returns
    (x, cache)."""
    new_cache = dict(cache)
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    if desc.mixer == "gqa":
        y, (k, v) = A.gqa_forward(p["mixer"], h, positions, cfg, causal=True,
                                  return_kv=True)
        kc, vc = cache["attn"]["k"], cache["attn"]["v"]
        kc[:, :, :k.shape[2]] = k
        vc[:, :, :v.shape[2]] = v
        new_cache["attn"] = {"k": kc, "v": vc}
    elif desc.mixer == "mla":
        y, (c_kv, k_rope) = A.mla_forward(p["mixer"], h, positions, cfg,
                                          causal=True, return_kv=True)
        cc, rc = cache["attn"]["c_kv"], cache["attn"]["k_rope"]
        cc[:, :c_kv.shape[1]] = c_kv
        rc[:, :k_rope.shape[1]] = k_rope
        new_cache["attn"] = {"c_kv": cc, "k_rope": rc}
    elif desc.mixer == "cross":
        kv = A.cross_kv(p["mixer"], memory, cfg)
        y = A.cross_forward(p["mixer"], h, kv, cfg)
        new_cache["cross_kv"] = {"k": kv[0], "v": kv[1]}
    elif desc.mixer == "rwkv6":
        y, new_cache["rwkv"] = S.rwkv6_forward(p["mixer"], h, cfg,
                                               return_state=True)
    else:
        y, new_cache["mamba"] = S.mamba_forward(p["mixer"], h, cfg,
                                                return_state=True)
    x = x + y
    if desc.cross:
        kv = A.cross_kv(p["cross"], memory, cfg)
        x = _cross_sublayer(p, x, cfg, kv)
        new_cache["cross_kv"] = {"k": kv[0], "v": kv[1]}
    h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
    out, _, cm_prev = _apply_ffn(p, h, cfg, desc, cache.get("cm_prev"))
    if cm_prev is not None:
        new_cache["cm_prev"] = cm_prev
    return x + out, new_cache


def block_decode(p, x, cfg, desc, cache, *, pos: int):
    """One-token decode. x (B,1,D). Returns (x, cache)."""
    new_cache = dict(cache)
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    if desc.mixer == "gqa":
        y, new_cache["attn"] = A.gqa_decode(p["mixer"], h, cache["attn"],
                                            pos, cfg)
    elif desc.mixer == "mla":
        y, new_cache["attn"] = A.mla_decode(p["mixer"], h, cache["attn"],
                                            pos, cfg)
    elif desc.mixer == "cross":
        y = A.cross_forward(p["mixer"], h, (cache["cross_kv"]["k"],
                                            cache["cross_kv"]["v"]), cfg)
    elif desc.mixer == "rwkv6":
        y, new_cache["rwkv"] = S.rwkv6_forward(p["mixer"], h, cfg,
                                               state=cache["rwkv"],
                                               return_state=True)
    else:
        y, new_cache["mamba"] = S.mamba_forward(p["mixer"], h, cfg,
                                                state=cache["mamba"],
                                                return_state=True)
    x = x + y
    if desc.cross:
        x = _cross_sublayer(p, x, cfg, (cache["cross_kv"]["k"],
                                        cache["cross_kv"]["v"]))
    h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
    out, _, cm_prev = _apply_ffn(p, h, cfg, desc, cache.get("cm_prev"))
    if cm_prev is not None:
        new_cache["cm_prev"] = cm_prev
    return x + out, new_cache
