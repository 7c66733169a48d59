"""Attention mixers: the plain and the chunked (flash-style) softmax
cores and their dispatch; GQA; cross-attention over encoder or image
memory (whisper's decoder, llama-vision's tanh-gated blocks); and MLA
(DeepSeek-V2's multi-head latent attention with its compressed cache
and absorbed decode).

Plain PyTorch ops that follow the JAX package's algorithm step for step
(``repro/models/attention.py``), not a fused library kernel: the scores
in float32, the max-subtracted exponentials in the compute dtype, the
denominator summed in float32. Shapes: activations (B, S, D); q/k/v
(B, H, S, hd), v's head dim may differ from q's and k's (MLA); the GQA
decode cache {"k", "v"} (B, Hkv, max_len, hd); the MLA cache {"c_kv"
(B, max_len, kv_lora), "k_rope" (B, max_len, rope_dim)}. Decode writes
the new slot in place, so a returned cache aliases the one passed in.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..analysis import op_cost
from . import layers as L

_NEG_INF = -1e30


def _plain_attention(q, k, v, causal: bool, q_offset: int = 0,
                     kv_len: Optional[torch.Tensor] = None):
    """q (B,K,G,Sq,hd) grouped-query vs k/v (B,K,Skv,hd)."""
    sq, hd = q.shape[3], q.shape[4]
    skv = k.shape[2]
    scores = torch.einsum("bkgqh,bkth->bkgqt", q, k).to(torch.float32)
    scores = scores / math.sqrt(hd)
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        kpos = torch.arange(skv, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        scores = torch.where(mask, scores, _NEG_INF)
    if kv_len is not None:
        mask = torch.arange(skv, device=q.device)[None, :] < kv_len[:, None]
        scores = torch.where(mask[:, None, None, None], scores, _NEG_INF)
    # float32 row max and denominator, exponentials in the compute dtype
    m = torch.amax(scores, dim=-1, keepdim=True).detach()
    p = torch.exp((scores - m).to(q.dtype))
    denom = torch.sum(p, dim=-1, keepdim=True, dtype=torch.float32)
    w = p / denom.to(q.dtype)
    return torch.einsum("bkgqt,bkth->bkgqh", w, v)


def _flash_attention(q, k, v, causal: bool, q_chunk: int, kv_chunk: int):
    """Online-softmax chunked attention: O(Sq * ckv) live scores instead
    of O(Sq * Skv); loops over q chunks and, inside, kv chunks."""
    b, kh, g, sq, hd = q.shape
    hd_v = v.shape[-1]
    skv = k.shape[2]
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    if sq % q_chunk or skv % kv_chunk:
        raise ValueError(f"flash attention needs whole chunks: Sq={sq}, "
                         f"Skv={skv}")
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    # every (q chunk, kv chunk) pair costs the same: a dry-run counts one
    q_loop = op_cost.repeat(sq // q_chunk)
    kv_loop = op_cost.repeat(skv // kv_chunk)

    def kv_steps(trips, q_blk, k, v, m, l, acc, qi):
        # causal: later kv chunks contribute nothing but are still walked
        for kj in range(trips):
            kb = k[:, :, kj * kv_chunk:(kj + 1) * kv_chunk]
            vb = v[:, :, kj * kv_chunk:(kj + 1) * kv_chunk]
            s = torch.einsum("bkgqh,bkth->bkgqt", q_blk, kb)
            s = s.to(torch.float32) * scale
            if causal:
                qpos = qi * q_chunk + torch.arange(q_chunk, device=dev)
                kpos = kj * kv_chunk + torch.arange(kv_chunk, device=dev)
                s = torch.where(kpos[None, :] <= qpos[:, None], s, _NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + torch.sum(p, dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqt,bkth->bkgqh", p.to(vb.dtype), vb).to(torch.float32)
            m = m_new
        return l, acc

    def q_steps(trips, q, k, v):
        outs = []
        for qi in range(trips):
            q_blk = q[:, :, :, qi * q_chunk:(qi + 1) * q_chunk]
            m = torch.full((b, kh, g, q_chunk), _NEG_INF,
                           dtype=torch.float32, device=dev)
            l = torch.zeros((b, kh, g, q_chunk), dtype=torch.float32,
                            device=dev)
            acc = torch.zeros((b, kh, g, q_chunk, hd_v), dtype=torch.float32,
                              device=dev)
            l, acc = kv_loop.run(lambda n, *xs: kv_steps(n, *xs, qi), q_blk,
                                 k, v, m, l, acc, carries=3)
            outs.append(acc / torch.clamp(l[..., None], min=1e-30))
        return (torch.cat(outs, dim=3),)

    out, = q_loop.run(q_steps, q, k, v)
    return q_loop.fill(out, 3, sq // q_chunk).to(q.dtype)


def grouped_attention(q, k, v, causal: bool, q_offset: int = 0,
                      kv_len=None, flash_threshold: int = 4096,
                      q_chunk: int = 512, kv_chunk: int = 1024):
    """Dispatch between the plain and flash paths. q (B,Hq,Sq,hd),
    k/v (B,Hkv,Skv,hd); Hq % Hkv == 0. K/V are repeated to the full
    query-head count first, as in the JAX package."""
    b, hq, sq, hd = q.shape
    hkv = k.shape[1]
    if hkv != hq:
        k = torch.repeat_interleave(k, hq // hkv, dim=1)
        v = torch.repeat_interleave(v, hq // hkv, dim=1)
    qg = q.reshape(b, hq, 1, sq, hd)
    skv = k.shape[2]
    flash_ok = (sq % min(q_chunk, sq) == 0
                and skv % min(kv_chunk, skv) == 0 and skv > kv_chunk)
    if not flash_ok or (sq * skv <= flash_threshold * flash_threshold
                        and sq <= flash_threshold):
        out = _plain_attention(qg, k, v, causal, q_offset, kv_len)
    else:
        if kv_len is not None:
            raise ValueError("the flash path is for full-length "
                             "prefill / train")
        out = _flash_attention(qg, k, v, causal, q_chunk, kv_chunk)
    return out.reshape(b, hq, sq, out.shape[-1])


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------

def init_gqa(gen: torch.Generator, cfg):
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": L.init_dense(gen, (d, hq, hd), d),
        "wk": L.init_dense(gen, (d, hkv, hd), d),
        "wv": L.init_dense(gen, (d, hkv, hd), d),
        "wo": L.init_dense(gen, (hq, hd, d), hq * hd),
    }


def spec_gqa():
    return {"wq": ("fsdp", "tp", None), "wk": ("fsdp", "tp", None),
            "wv": ("fsdp", "tp", None), "wo": ("tp", None, "fsdp")}


def gqa_qkv(p, x, positions, cfg):
    dtype = cfg.dtype
    q = torch.einsum("bsd,dhk->bhsk", x, L.gathered(p["wq"], dtype))
    k = torch.einsum("bsd,dhk->bhsk", x, L.gathered(p["wk"], dtype))
    v = torch.einsum("bsd,dhk->bhsk", x, L.gathered(p["wv"], dtype))
    q = L.apply_rope(q.transpose(1, 2), positions,
                     cfg.rope_theta).transpose(1, 2)
    k = L.apply_rope(k.transpose(1, 2), positions,
                     cfg.rope_theta).transpose(1, 2)
    return q, k, v


def gqa_forward(p, x, positions, cfg, causal: bool = True,
                return_kv: bool = False):
    """Train / prefill path; with ``return_kv``, ``(y, (k, v))``."""
    q, k, v = gqa_qkv(p, x, positions, cfg)
    out = grouped_attention(q, k, v, causal,
                            flash_threshold=cfg.flash_threshold,
                            q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    y = torch.einsum("bhsk,hkd->bsd", out, L.gathered(p["wo"], cfg.dtype))
    return (y, (k, v)) if return_kv else y


def init_gqa_cache(cfg, batch: int, max_len: int, dtype, device=None):
    shape = (batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_cache_spec(cfg):
    """KV heads rarely divide tp = 16 (GQA kv = 8), so the long cache is
    sequence-sharded over tp instead."""
    if cfg.n_kv_heads % 16 == 0:
        kv = ("dp", "tp", None, None)
    else:
        kv = ("dp", None, "tp", None)
    return {"k": kv, "v": kv}


def gqa_decode(p, x, cache, pos: int, cfg):
    """One-token decode: x (B,1,D); cache k/v (B,Hkv,Smax,hd); pos the
    new token's position. Returns ``(y, cache)``. The new K/V slot is
    written in place, one (B, Hkv, 1, hd) write a step where the JAX
    package copies the cache: the returned cache aliases the one passed
    in."""
    b, smax = x.shape[0], cache["k"].shape[2]
    if not 0 <= pos < smax:
        raise ValueError(f"decode position {pos} outside the cache's "
                         f"{smax} slots")
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = gqa_qkv(p, x, positions, cfg)
    k, v = cache["k"], cache["v"]
    k[:, :, pos:pos + 1] = k_new
    v[:, :, pos:pos + 1] = v_new
    kv_len = torch.full((b,), pos + 1, dtype=torch.int32, device=x.device)
    out = grouped_attention(q, k, v, causal=False, kv_len=kv_len,
                            flash_threshold=1 << 30)
    y = torch.einsum("bhsk,hkd->bsd", out, L.gathered(p["wo"], cfg.dtype))
    return y, {"k": k, "v": v}


# ---------------------------------------------------------------------------
# Cross-attention (whisper decoder / llama-vision gated cross blocks)
# ---------------------------------------------------------------------------

def init_cross(gen: torch.Generator, cfg, gated: bool):
    p = init_gqa(gen, cfg)
    if gated:
        # tanh-gated, starts closed: a fresh gated block adds nothing
        p["gate"] = torch.zeros((1,), dtype=torch.float32, device=gen.device)
    return p


def spec_cross(gated: bool):
    s = {"wq": ("fsdp", "tp", None), "wk": ("fsdp", "tp", None),
         "wv": ("fsdp", "tp", None), "wo": ("tp", None, "fsdp")}
    if gated:
        s["gate"] = (None,)
    return s


def cross_kv(p, memory, cfg):
    """K/V of encoder or image memory (B, M, D): (B, Hkv, M, hd) each."""
    if memory is None:
        raise ValueError("a cross-attention block needs memory: frames for "
                         "an encoder-decoder model, image embeddings for a "
                         "vision model")
    dtype = cfg.dtype
    k = torch.einsum("bmd,dhk->bhmk", memory, L.gathered(p["wk"], dtype))
    v = torch.einsum("bmd,dhk->bhmk", memory, L.gathered(p["wv"], dtype))
    return k, v


def cross_forward(p, x, kv, cfg):
    k, v = kv
    q = torch.einsum("bsd,dhk->bhsk", x, L.gathered(p["wq"], cfg.dtype))
    out = grouped_attention(q, k, v, causal=False,
                            flash_threshold=cfg.flash_threshold,
                            q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    y = torch.einsum("bhsk,hkd->bsd", out, L.gathered(p["wo"], cfg.dtype))
    if "gate" in p:
        y = torch.tanh(p["gate"]).to(cfg.dtype) * y
    return y


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention (DeepSeek-V2)
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg):
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "w_dq": L.init_dense(gen, (d, m.q_lora_rank), d),
        "w_uq": L.init_dense(gen, (m.q_lora_rank, h, qk), m.q_lora_rank),
        "w_dkv": L.init_dense(gen, (d, m.kv_lora_rank), d),
        "w_uk": L.init_dense(gen, (m.kv_lora_rank, h, m.qk_nope_head_dim),
                             m.kv_lora_rank),
        "w_uv": L.init_dense(gen, (m.kv_lora_rank, h, m.v_head_dim),
                             m.kv_lora_rank),
        "w_kr": L.init_dense(gen, (d, m.qk_rope_head_dim), d),
        "wo": L.init_dense(gen, (h, m.v_head_dim, d), h * m.v_head_dim),
    }


def spec_mla():
    return {"w_dq": ("fsdp", None), "w_uq": (None, "tp", None),
            "w_dkv": ("fsdp", None), "w_uk": (None, "tp", None),
            "w_uv": (None, "tp", None), "w_kr": ("fsdp", None),
            "wo": ("tp", None, "fsdp")}


def _mla_q(p, x, positions, cfg):
    m, dtype = cfg.mla, cfg.dtype
    cq = torch.einsum("bsd,dr->bsr", x, L.gathered(p["w_dq"], dtype))
    q = torch.einsum("bsr,rhk->bhsk", cq, L.gathered(p["w_uq"], dtype))
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = L.apply_rope(q[..., m.qk_nope_head_dim:].transpose(1, 2),
                          positions, cfg.rope_theta).transpose(1, 2)
    return q_nope, q_rope


def _mla_ckv(p, x, positions, cfg):
    dtype = cfg.dtype
    c_kv = torch.einsum("bsd,dr->bsr", x, L.gathered(p["w_dkv"], dtype))
    k_rope = torch.einsum("bsd,dk->bsk", x, L.gathered(p["w_kr"], dtype))
    return c_kv, L.apply_rope(k_rope, positions, cfg.rope_theta)


def mla_forward(p, x, positions, cfg, causal: bool = True,
                return_kv: bool = False):
    """Train / prefill: K and V decompressed from the latent, then the
    softmax core with q/k head dim qk_nope + qk_rope and v's v_head_dim.
    With ``return_kv``, ``(y, (c_kv, k_rope))``, what the cache holds."""
    dtype = cfg.dtype
    q_nope, q_rope = _mla_q(p, x, positions, cfg)
    c_kv, k_rope = _mla_ckv(p, x, positions, cfg)
    k_nope = torch.einsum("bsr,rhk->bhsk", c_kv, L.gathered(p["w_uk"], dtype))
    v = torch.einsum("bsr,rhk->bhsk", c_kv, L.gathered(p["w_uv"], dtype))
    kr = k_rope[:, None].expand(-1, cfg.n_heads, -1, -1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, kr], dim=-1)
    out = grouped_attention(q, k, v, causal,
                            flash_threshold=cfg.flash_threshold,
                            q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    y = torch.einsum("bhsk,hkd->bsd", out, L.gathered(p["wo"], dtype))
    return (y, (c_kv, k_rope)) if return_kv else y


def init_mla_cache(cfg, batch: int, max_len: int, dtype, device=None):
    m = cfg.mla
    return {"c_kv": torch.zeros((batch, max_len, m.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, m.qk_rope_head_dim),
                                  dtype=dtype, device=device)}


def mla_cache_spec(cfg):
    # the compressed cache has no head dim: shard the sequence over tp
    return {"c_kv": ("dp", "tp", None), "k_rope": ("dp", "tp", None)}


def mla_decode(p, x, cache, pos: int, cfg):
    """Absorbed decode: W_uk folded into q and the context formed against
    the compressed cache, kv_lora + rope_dim values a token and layer
    instead of the decompressed K and V of every head. The new slot is
    written in place. Returns ``(y, cache)``."""
    m, dtype = cfg.mla, cfg.dtype
    b, smax = x.shape[0], cache["c_kv"].shape[1]
    if not 0 <= pos < smax:
        raise ValueError(f"decode position {pos} outside the cache's "
                         f"{smax} slots")
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(p, x, positions, cfg)          # (B, H, 1, *)
    c_new, kr_new = _mla_ckv(p, x, positions, cfg)         # (B, 1, *)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    c_kv[:, pos:pos + 1] = c_new
    k_rope[:, pos:pos + 1] = kr_new
    q_abs = torch.einsum("bhsk,rhk->bhsr", q_nope,
                         L.gathered(p["w_uk"], dtype))
    scores = (torch.einsum("bhsr,btr->bhst", q_abs, c_kv)
              + torch.einsum("bhsk,btk->bhst", q_rope, k_rope))
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    scores = scores.to(torch.float32) * scale
    mask = torch.arange(smax, device=x.device) <= pos
    scores = torch.where(mask, scores, _NEG_INF)
    w = torch.softmax(scores, dim=-1).to(dtype)
    ctx = torch.einsum("bhst,btr->bhsr", w, c_kv)
    out = torch.einsum("bhsr,rhk->bhsk", ctx, L.gathered(p["w_uv"], dtype))
    y = torch.einsum("bhsk,hkd->bsd", out, L.gathered(p["wo"], dtype))
    return y, {"c_kv": c_kv, "k_rope": k_rope}
