"""The Mamba mixer (selective SSM), Jamba's dominant mixer.

An exact linear recurrence over time: the plain version is a Python
loop over the sequence (:func:`_ssm_scan`, the JAX package's
``lax.scan``). With ``cfg.mamba_pallas`` set and no state carried in,
the selective-scan kernel runs instead, where ``S % 64 == 0`` and
``d_inner % 64 == 0`` (the JAX package's shape condition; the kernel
itself takes any shape):

- the training forward through :class:`SelectiveScan`. The kernel has
  no backward: the autograd function recomputes through the plain
  recurrence, as the JAX package's ``custom_vjp`` does;
- prefill (``return_state``, no gradient) through the kernel's end-state
  form, ``selective_scan(..., return_state=True)``. Here the dispatch
  differs from the JAX package's, which leaves its kernel for the
  recurrence whenever the state is returned: the function is the same
  (y and h_S of the same recurrence), but the port's plain form is a
  Python loop of S steps, which a server cannot afford on every Mamba
  layer of a prompt, where the JAX package's is one compiled loop.

Decode (a state given, S = 1) keeps the plain recurrence. RWKV6 is not
ported yet.

State: {"ssm": (B, d_inner, d_state), "conv": (B, k - 1, d_inner)}.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as Fn

from ..kernels import ops as kops
from ..kernels import selective_scan as KSS
from . import layers as L


def init_mamba(gen: torch.Generator, cfg):
    d = cfg.d_model
    di = cfg.mamba_expand * d
    ds, kconv = cfg.mamba_d_state, cfg.mamba_conv
    dt_rank = max(d // 16, 1)
    dev = gen.device
    a = torch.arange(1, ds + 1, dtype=torch.float32,
                     device=dev)[None].repeat(di, 1)
    # softplus^-1 of dt drawn log-uniform in [1e-3, 1e-1]
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(torch.rand((di,), generator=gen, dtype=torch.float32,
                              device=dev) * (hi - lo) + lo)
    return {
        "in_proj": L.init_dense(gen, (d, 2 * di), d),
        "conv_w": L.init_dense(gen, (di, kconv), kconv),
        "conv_b": torch.zeros((di,), dtype=torch.float32, device=dev),
        "x_proj": L.init_dense(gen, (di, dt_rank + 2 * ds), di),
        "dt_proj": L.init_dense(gen, (dt_rank, di), dt_rank),
        "dt_bias": torch.log(torch.expm1(dt)),
        "a_log": torch.log(a),
        "d_skip": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": L.init_dense(gen, (di, d), di),
    }


def _causal_depthwise_conv(x, w, b, conv_state=None):
    """x (B,S,di); w (di,k). Returns the conv output and the new conv
    state (the last k-1 inputs)."""
    bsz, s, di = x.shape
    k = w.shape[1]
    if conv_state is None:
        conv_state = torch.zeros((bsz, k - 1, di), dtype=x.dtype,
                                 device=x.device)
    xp = torch.cat([conv_state, x], dim=1)                  # (B, S+k-1, di)
    out = torch.zeros((bsz, s, di), dtype=torch.float32, device=x.device)
    for i in range(k):                                      # k is tiny (4)
        out = out + (xp[:, i:i + s] * w[:, i]).to(torch.float32)
    out = out + b
    new_state = xp[:, -(k - 1):] if k > 1 else conv_state
    return out.to(x.dtype), new_state


def _ssm_scan(u, dt, bmat, cmat, a, d_skip, h0):
    """The selective-SSM recurrence, one step a position.
    u (B,S,di) conv'd input; dt (B,S,di); bmat/cmat (B,S,ds); a (di,ds);
    h0 (B,di,ds). Returns y (B,S,di), h_final."""
    u, dt, bmat, cmat = (t.to(torch.float32) for t in (u, dt, bmat, cmat))
    h = h0.to(torch.float32)
    ys = []
    for t in range(u.shape[1]):
        u_t, dt_t = u[:, t], dt[:, t]
        da = torch.exp(dt_t[..., None] * a[None])          # (B,di,ds)
        h = da * h + (dt_t * u_t)[..., None] * bmat[:, t, None, :]
        ys.append(torch.einsum("bds,bs->bd", h, cmat[:, t]) + d_skip * u_t)
    return torch.stack(ys, dim=1), h


class SelectiveScan(torch.autograd.Function):
    """y = selective_scan(u, dt, bmat, cmat, a), float32: the forward is
    the selected ``selscan`` impl (the kernel on the card, its plain
    version on the CPU); the backward recomputes through the plain
    recurrence and differentiates it (the JAX package's
    ``_selscan_bwd``), since the kernel has no backward."""

    @staticmethod
    def forward(ctx, u, dt, bmat, cmat, a):
        ctx.save_for_backward(u, dt, bmat, cmat, a)
        impl = kops.select_step("selscan", platform=u.device.type)
        return impl.build()(u.contiguous(), dt.contiguous(),
                            bmat.contiguous(), cmat.contiguous(),
                            a.contiguous())

    @staticmethod
    def backward(ctx, g):
        ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = KSS.selective_scan_ref(*ins)
            return torch.autograd.grad(y, ins, g)


def _scan_with_state(u, dt, bmat, cmat, a):
    """(y, h_final) of the zero-state recurrence from the selected
    ``selscan`` impl: the kernel's end-state form on the card, the plain
    recurrence on the CPU. For prefill: the kernel has no backward, so a
    call that needs a gradient raises rather than drop it."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (u, dt, bmat, cmat, a)):
        raise RuntimeError("the selective scan's end state has no backward; "
                           "run prefill under torch.no_grad()")
    impl = kops.select_step("selscan", platform=u.device.type)
    return impl.build()(u.contiguous(), dt.contiguous(), bmat.contiguous(),
                        cmat.contiguous(), a.contiguous(), return_state=True)


def _softplus(x):
    """log(1 + e^x) as jax.nn.softplus forms it (no linear threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def mamba_forward(p, x, cfg, state=None, return_state: bool = False):
    dtype = cfg.dtype
    b, s, d = x.shape
    di = cfg.mamba_expand * d
    ds = cfg.mamba_d_state
    dt_rank = max(d // 16, 1)
    xz = torch.einsum("bsd,de->bse", x, p["in_proj"].to(dtype))
    xin, z = torch.chunk(xz, 2, dim=-1)
    conv_state = state["conv"] if state is not None else None
    xc, conv_state = _causal_depthwise_conv(
        xin, p["conv_w"].to(dtype), p["conv_b"].to(dtype), conv_state)
    xc = Fn.silu(xc)
    proj = torch.einsum("bse,er->bsr", xc, p["x_proj"].to(dtype))
    dt, bmat, cmat = torch.split(proj, [dt_rank, ds, ds], dim=-1)
    dt = _softplus(torch.einsum("bsr,re->bse", dt,
                                p["dt_proj"].to(dtype)).to(torch.float32)
                   + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    h0 = (state["ssm"] if state is not None
          else torch.zeros((b, di, ds), dtype=torch.float32,
                           device=x.device))
    if (cfg.mamba_pallas and state is None and s % 64 == 0
            and di % 64 == 0):
        xc32 = xc.to(torch.float32)
        scan_in = (xc32, dt, bmat.to(torch.float32), cmat.to(torch.float32),
                   a)
        if return_state:
            y, h_f = _scan_with_state(*scan_in)
        else:
            y, h_f = SelectiveScan.apply(*scan_in), h0
        y = y + p["d_skip"] * xc32
    else:
        y, h_f = _ssm_scan(xc, dt, bmat.to(torch.float32),
                           cmat.to(torch.float32), a, p["d_skip"], h0)
    y = y.to(dtype) * Fn.silu(z)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"].to(dtype))
    if return_state:
        return out, {"conv": conv_state, "ssm": h_f}
    return out


def init_mamba_state(cfg, batch: int, device=None):
    di = cfg.mamba_expand * cfg.d_model
    return {"conv": torch.zeros((batch, cfg.mamba_conv - 1, di),
                                dtype=cfg.dtype, device=device),
            "ssm": torch.zeros((batch, di, cfg.mamba_d_state),
                               dtype=torch.float32, device=device)}
