"""Attention-free mixers: RWKV6 ("Finch", data-dependent decay linear
attention, with its channel-mix FFN) and Mamba (the selective SSM,
Jamba's dominant mixer).

Both are exact linear recurrences over time.

RWKV6's wkv recurrence is a Python loop over positions in float32
(:func:`_wkv_scan`, the JAX package's ``lax.scan``), differentiable
through autograd; the JAX package has no kernel for it. Its state is
``{"x_prev" (B, D), "wkv" (B, nh, hd, hd) float32}``; the channel-mix's
previous token (B, D) sits beside it in the block cache, as ``cm_prev``.

Mamba's plain version is a Python loop over the sequence
(:func:`_ssm_scan`, the JAX package's ``lax.scan``). With
``cfg.mamba_pallas`` set and no state carried in, the selective-scan
kernel runs instead, where ``S % 64 == 0`` and ``d_inner % 64 == 0``
(the JAX package's shape condition; the kernel itself takes any shape):

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

Decode (a state given, S = 1) keeps the plain recurrence.

Under a mesh (:mod:`repro_torch.models.sharding`) the training forward's
scan runs per dp shard: the batch rows split as the pruned ``("dp",)``
spec says, each shard's scan on its device (the kernel's launch guard,
``kernels/_build.on_device``, follows the tensors there), and the rows
gathered back on the lead device. The scan is independent per row, so
this changes no value.

Mamba's state: {"ssm": (B, d_inner, d_state), "conv": (B, k - 1,
d_inner)}.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as Fn

from ..analysis import op_cost
from ..kernels import ops as kops
from ..kernels import selective_scan as KSS
from . import layers as L
from . import sharding as sh


_TSZ = 32      # rwkv6 ddlerp lora rank
_DSZ = 64      # rwkv6 decay lora rank


# ===========================================================================
# RWKV6 time-mix
# ===========================================================================

def init_rwkv6(gen: torch.Generator, cfg):
    d = cfg.d_model
    nh, hd = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    dev = gen.device
    return {
        "mu": torch.rand((5, d), generator=gen, dtype=torch.float32,
                         device=dev),
        "ddlerp_a": L.init_dense(gen, (d, 5 * _TSZ), d),
        "ddlerp_b": L.init_dense(gen, (5, _TSZ, d), _TSZ),
        "w0": torch.full((d,), -2.0, dtype=torch.float32, device=dev),
        "w_a": L.init_dense(gen, (d, _DSZ), d),
        "w_b": L.init_dense(gen, (_DSZ, d), _DSZ),
        "u": torch.randn((nh, hd), generator=gen, dtype=torch.float32,
                         device=dev) * 0.1,
        "wr": L.init_dense(gen, (d, d), d),
        "wk": L.init_dense(gen, (d, d), d),
        "wv": L.init_dense(gen, (d, d), d),
        "wg": L.init_dense(gen, (d, d), d),
        "wo": L.init_dense(gen, (d, d), d),
        "ln_x": torch.ones((d,), dtype=torch.float32, device=dev),
    }


def spec_rwkv6():
    return {"mu": (None, None), "ddlerp_a": ("fsdp", None),
            "ddlerp_b": (None, None, "fsdp"), "w0": (None,),
            "w_a": ("fsdp", None), "w_b": (None, "fsdp"),
            "u": ("tp", None), "wr": ("fsdp", "tp"), "wk": ("fsdp", "tp"),
            "wv": ("fsdp", "tp"), "wg": ("fsdp", "tp"), "wo": ("tp", "fsdp"),
            "ln_x": (None,)}


def _token_shift(x, x_prev):
    """x_{t-1} - x_t with x_prev (B, D) before x[:, 0]."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1) - x


def _rwkv_inputs(p, x, x_prev, cfg):
    """Data-dependent token shift (ddlerp) and the projections.
    x (B, S, D); x_prev (B, D) is the token before x[:, 0]. Returns r, k,
    v, g in the compute dtype and the log-decay in float32."""
    dtype = cfg.dtype
    xx = _token_shift(x, x_prev)
    mu = p["mu"].to(dtype)
    base = x + xx * mu[0]
    lora = torch.tanh(torch.einsum("bsd,dr->bsr", base,
                                   L.gathered(p["ddlerp_a"], dtype)))
    lora = lora.reshape(*lora.shape[:-1], 5, _TSZ)
    offs = torch.einsum("bsir,ird->ibsd", lora,
                        L.gathered(p["ddlerp_b"], dtype))
    xw, xk, xv, xr, xg = (x + xx * (mu[i] + offs[i]) for i in range(5))
    # data-dependent per-channel decay w_t in (0, 1), clipped in float32
    dw = torch.einsum("bsr,rd->bsd", torch.tanh(torch.einsum(
        "bsd,dr->bsr", xw, L.gathered(p["w_a"], dtype))),
        L.gathered(p["w_b"], dtype))
    logw = -torch.exp(torch.clamp(p["w0"] + dw.to(torch.float32),
                                  -8.0, 4.0))
    r = torch.einsum("bsd,de->bse", xr, L.gathered(p["wr"], dtype))
    k = torch.einsum("bsd,de->bse", xk, L.gathered(p["wk"], dtype))
    v = torch.einsum("bsd,de->bse", xv, L.gathered(p["wv"], dtype))
    g = Fn.silu(torch.einsum("bsd,de->bse", xg, L.gathered(p["wg"], dtype)))
    return r, k, v, g, logw


def _heads(t, nh: int, hd: int):
    return t.reshape(*t.shape[:-1], nh, hd)


def _group_norm(y, scale, nh: int, eps: float):
    """Per-head layer norm of (B, S, D) laid out as (B, S, nh, hd), in
    float32 with the population variance."""
    b, s, d = y.shape
    yh = y.reshape(b, s, nh, d // nh).to(torch.float32)
    mean = yh.mean(dim=-1, keepdim=True)
    var = yh.var(dim=-1, keepdim=True, correction=0)
    yh = (yh - mean) * torch.rsqrt(var + eps)
    return (yh.reshape(b, s, d) * scale).to(y.dtype)


def _wkv_scan(r, k, v, logw, u, s0):
    """The exact WKV6 recurrence in float32, one step a position.
    r/k/v (B, S, nh, hd); logw (B, S, nh, hd) the log-decay; u (nh, hd);
    s0 (B, nh, hd, hd). y_t reads s + u * k_t v_t^T before the decay
    update. Returns (y (B, S, nh, hd) float32, s_final)."""
    r, k, v = (t.to(torch.float32) for t in (r, k, v))
    decay = torch.exp(logw.to(torch.float32))[..., None]   # (B,S,nh,hd,1)
    u = u.to(torch.float32)[None, :, :, None]
    s = s0.to(torch.float32)

    def steps(trips, r, k, v, decay, u, s):
        ys = []
        for t in range(trips):
            kv = k[:, t, :, :, None] * v[:, t, :, None, :]  # rank-1 update
            # addcmul: one kernel, and one rounding as XLA's fused
            # multiply-add
            ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                                   torch.addcmul(s, u, kv)))
            s = torch.addcmul(kv, decay[:, t], s)
        return torch.stack(ys, dim=1), s

    loop = op_cost.repeat(r.shape[1])   # a dry-run counts one step
    y, s = loop.run(steps, r, k, v, decay, u, s, carries=1)
    return loop.fill(y, 1), s


def rwkv6_forward(p, x, cfg, state=None, return_state: bool = False):
    """x (B, S, D). ``state`` carries (x_prev, wkv) across segments and
    decode steps; with ``return_state``, ``(out, state)``."""
    b, s, d = x.shape
    nh, hd = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    if state is None:
        state = init_rwkv6_state(cfg, b, x.device)
    r, k, v, g, logw = _rwkv_inputs(p, x, state["x_prev"], cfg)
    y, s_f = _wkv_scan(_heads(r, nh, hd), _heads(k, nh, hd),
                       _heads(v, nh, hd), _heads(logw, nh, hd), p["u"],
                       state["wkv"])
    y = y.reshape(b, s, d).to(cfg.dtype)
    y = _group_norm(y, p["ln_x"], nh, cfg.norm_eps) * g
    out = torch.einsum("bse,ed->bsd", y, L.gathered(p["wo"], cfg.dtype))
    if return_state:
        return out, {"x_prev": x[:, -1].to(cfg.dtype), "wkv": s_f}
    return out


def init_rwkv6_state(cfg, batch: int, device=None):
    d = cfg.d_model
    nh, hd = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    return {"x_prev": torch.zeros((batch, d), dtype=cfg.dtype,
                                  device=device),
            "wkv": torch.zeros((batch, nh, hd, hd), dtype=torch.float32,
                               device=device)}


def rwkv6_state_spec(cfg):
    return {"x_prev": ("dp", None), "wkv": ("dp", "tp", None, None)}


# --- rwkv channel-mix (its FFN counterpart; token-shifted squared relu) ----

def init_rwkv_cm(gen: torch.Generator, cfg):
    d, f = cfg.d_model, cfg.d_ff
    dev = gen.device
    return {"mu_k": torch.rand((d,), generator=gen, dtype=torch.float32,
                               device=dev),
            "mu_r": torch.rand((d,), generator=gen, dtype=torch.float32,
                               device=dev),
            "wk": L.init_dense(gen, (d, f), d),
            "wv": L.init_dense(gen, (f, d), f),
            "wr": L.init_dense(gen, (d, d), d)}


def spec_rwkv_cm():
    return {"mu_k": (None,), "mu_r": (None,), "wk": ("fsdp", "tp"),
            "wv": ("tp", "fsdp"), "wr": ("fsdp", None)}


def rwkv_cm_forward(p, x, cfg, x_prev=None, return_state: bool = False):
    """x (B, S, D); ``x_prev`` (B, D) the token before x[:, 0] (zeros if
    None). With ``return_state``, ``(out, x[:, -1])``."""
    dtype = cfg.dtype
    if x_prev is None:
        x_prev = torch.zeros((x.shape[0], x.shape[-1]), dtype=dtype,
                             device=x.device)
    xx = _token_shift(x, x_prev)
    xk = x + xx * p["mu_k"].to(dtype)
    xr = x + xx * p["mu_r"].to(dtype)
    kk = torch.einsum("bsd,df->bsf", xk, L.gathered(p["wk"], dtype))
    kk = torch.square(torch.relu(kk))
    out = torch.einsum("bsf,fd->bsd", kk, L.gathered(p["wv"], dtype))
    r = torch.sigmoid(torch.einsum("bsd,de->bse", xr,
                                   L.gathered(p["wr"], dtype)))
    out = r * out
    if return_state:
        return out, x[:, -1].to(dtype)
    return out


# ===========================================================================
# Mamba (selective SSM)
# ===========================================================================

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


def spec_mamba():
    return {"in_proj": ("fsdp", "tp"), "conv_w": ("tp", None),
            "conv_b": ("tp",), "x_proj": ("tp", None),
            "dt_proj": (None, "tp"), "dt_bias": ("tp",),
            "a_log": ("tp", None), "d_skip": ("tp",),
            "out_proj": ("tp", "fsdp")}


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

    def steps(trips, u, dt, bmat, cmat, a, d_skip, h):
        ys = []
        for t in range(trips):
            u_t, dt_t = u[:, t], dt[:, t]
            da = torch.exp(dt_t[..., None] * a[None])      # (B,di,ds)
            h = da * h + (dt_t * u_t)[..., None] * bmat[:, t, None, :]
            ys.append(torch.einsum("bds,bs->bd", h, cmat[:, t])
                      + d_skip * u_t)
        return torch.stack(ys, dim=1), h

    loop = op_cost.repeat(u.shape[1])   # a dry-run counts one step
    y, h = loop.run(steps, u, dt, bmat, cmat, a, d_skip, h, carries=1)
    return loop.fill(y, 1), h


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



def _sharded_scan(u, dt, bmat, cmat, a):
    """:class:`SelectiveScan` on each dp shard's batch rows on its
    device (one call without a mesh), the rows gathered on ``u``'s
    device."""
    ctx = sh.current()
    shards = sh.dp_shards(ctx, u.shape[0])
    if len(shards) == 1:
        return SelectiveScan.apply(u, dt, bmat, cmat, a)
    loop = op_cost.repeat(len(shards))  # equal shards: a dry-run counts one

    def per_shard(trips, u, dt, bmat, cmat, a):
        outs = []
        for rows, coords in shards[:trips]:
            dev = sh.device_at(ctx.mesh, coords)
            outs.append(SelectiveScan.apply(
                *(t[rows].to(dev) for t in (u, dt, bmat, cmat)),
                a.to(dev)).to(u.device))
        return (torch.cat(outs),)

    y, = loop.run(per_shard, u, dt, bmat, cmat, a)
    return loop.fill(y, 0, len(shards))

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
            y, h_f = _sharded_scan(*scan_in), h0
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


def mamba_state_spec(cfg):
    return {"conv": ("dp", None, "tp"), "ssm": ("dp", "tp", None)}
