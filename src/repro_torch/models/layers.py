"""Elementary layers: RMSNorm, embeddings, RoPE, the SwiGLU MLP.

Parameters are nested dicts of float32 tensors (the master copy), the
same trees as the JAX package's, cast to the compute dtype at use.
Every ``init_*`` draws from one seeded :class:`torch.Generator`, on the
generator's device: the JAX package's key splits have no counterpart,
so the two packages' draws differ and parity tests carry the JAX
parameters across (:func:`repro_torch.convert.lm_params_from_numpy`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as Fn


def _normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device) * scale


def gathered(w: torch.Tensor, dtype) -> torch.Tensor:
    """Cast a weight to the compute dtype at use (the JAX package's
    sharding constraint here is a layout hint, nothing on one device)."""
    return w.to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, device=None):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def spec_rmsnorm():
    return {"scale": (None,)}


def rmsnorm(p, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"]).to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, vocab: int, d: int):
    return {"table": _normal(gen, (vocab, d), d ** -0.5)}


def spec_embedding():
    return {"table": ("tp", "fsdp")}


def embed(p, tokens: torch.Tensor, dtype) -> torch.Tensor:
    # rows gathered, then cast: the values of the JAX package's cast-then-take
    return p["table"][tokens].to(dtype)


def unembed(p, x: torch.Tensor, dtype) -> torch.Tensor:
    """Logits in float32 (softmax stability)."""
    return torch.einsum("bsd,vd->bsv", x.to(dtype),
                        p["table"].to(dtype)).to(torch.float32)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, head_dim) or (..., S, head_dim); positions: (S,)
    or (B, S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., :, None].to(torch.float32) * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    while cos.dim() < x.dim():          # head axes between S and head_dim
        cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d: int, f: int):
    return {
        "w_gate": _normal(gen, (d, f), d ** -0.5),
        "w_up": _normal(gen, (d, f), d ** -0.5),
        "w_down": _normal(gen, (f, d), f ** -0.5),
    }


def spec_mlp():
    return {"w_gate": ("fsdp", "tp"), "w_up": ("fsdp", "tp"),
            "w_down": ("tp", "fsdp")}


def mlp(p, x: torch.Tensor, dtype) -> torch.Tensor:
    h = torch.einsum("bsd,df->bsf", x, gathered(p["w_gate"], dtype))
    u = torch.einsum("bsd,df->bsf", x, gathered(p["w_up"], dtype))
    h = Fn.silu(h) * u
    return torch.einsum("bsf,fd->bsd", h, gathered(p["w_down"], dtype))


# ---------------------------------------------------------------------------
# Dense projection helper
# ---------------------------------------------------------------------------

def init_dense(gen: torch.Generator, shape, fan_in: int) -> torch.Tensor:
    return _normal(gen, shape, fan_in ** -0.5)
