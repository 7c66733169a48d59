"""Prefix invariance of rwkv6-1.6b's forward on the card, and how float32
and float64 rounding and a small perturbation grow through its layers.

  python3 prefix_probe.py

Runs rwkv6-1.6b whole (random weights from seed 0, TF32 off) at batch 4,
once in float32 and once in float64 (every ``torch.float32`` the model's
modules name reads ``torch.float64`` for that run, so the recurrence,
the norms and the GEMMs all run in float64), and reports layer by layer
the max |difference| of the residual stream at positions 0-7 against its
max |value| there:

1. drift: S = 512 against S = 543, the first sequence plus 31 tokens
   (and, inside the first layer that differs, each op; and the
   projections' GEMM alone on identical rows at M = 4 x 512 and 4 x 543);
2. growth: S = 512 with a perturbation of 1e-6 of layer 0's max |value|
   (seeded normal) added to layer 0's output, against the same run
   without it;
3. injection (float32 only): each layer run in float32 on the float64
   run's input to it, against the float64 layer's output: the error the
   layer adds in float32; and, in the layer where it is largest, each op.

Needs one CUDA card. Prints one JSON object as its last line.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

from repro_torch import configs as TC  # noqa: E402
from repro_torch.models import (attention, blocks, layers, lm, moe,  # noqa
                                ssm)
from repro_torch.training import optimizer as TO  # noqa: E402

ARCH = "rwkv6-1.6b"
BATCH = 4
LENGTHS = (512, 543)
HEAD = 8            # the first positions, where the drift was first seen
PERTURB = 1e-6      # of layer 0's max |value|


class _Wide:
    """The ``torch`` module as the model's modules see it in a float64
    run: ``float32`` names ``float64``, everything else is torch's."""

    def __getattr__(self, name):
        return torch.float64 if name == "float32" else getattr(torch, name)


@contextlib.contextmanager
def _wide():
    mods = (attention, blocks, layers, lm, moe, ssm)
    saved = {m: m.torch for m in mods}
    for m in mods:
        m.torch = _Wide()
    try:
        yield
    finally:
        for m, t in saved.items():
            m.torch = t


def _head(a: torch.Tensor, b: torch.Tensor, n: int) -> dict:
    """max |a - b| at positions < HEAD and < n, and max |b| at positions
    < HEAD, of (B, S, ...) tensors on their first n positions."""
    d = (a[:, :n].double() - b[:, :n].double()).abs()
    top = float(b[:, :HEAD].double().abs().max())
    head = float(d[:, :HEAD].max())
    return {"head_max_abs": head, "prefix_max_abs": float(d.max()),
            "head_max_value": top, "head_rel": head / max(top, 1e-300)}


def _stream(params, toks, cfg, perturb=None):
    """The residual stream after the embedding and after each layer, and
    the logits; ``perturb`` added to layer 0's output."""
    x = layers.embed(params["embed"], toks, cfg.dtype)
    out = [x]
    for i, gp in enumerate(params["groups"]):
        x, _ = blocks.block_forward(gp["b0"], x, cfg, cfg.group_layout[0])
        if i == 0 and perturb is not None:
            x = x + perturb.to(x.dtype)
        out.append(x)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    out.append(layers.unembed(params["embed"], x, cfg.dtype))
    return out


def _name(i: int, n: int) -> str:
    return "embed" if i == 0 else "logits" if i == n - 1 else f"layer {i - 1}"


def _layer_ops(p, x, cfg):
    """The rwkv6 block's ops on input x (B, S, D), by name."""
    nh, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    b, s, d = x.shape
    out = {}
    h = layers.rmsnorm(p["norm1"], x, cfg.norm_eps)
    out["norm1"] = h
    st = ssm.init_rwkv6_state(cfg, b, x.device)
    r, k, v, g, logw = ssm._rwkv_inputs(p["mixer"], h, st["x_prev"], cfg)
    out.update(r=r, k=k, v=v, g=g, logw=logw)
    y, _ = ssm._wkv_scan(*(ssm._heads(t, nh, hd) for t in (r, k, v, logw)),
                         p["mixer"]["u"], st["wkv"])
    out["wkv_scan"] = y
    y = y.reshape(b, s, d).to(cfg.dtype)
    gn = ssm._group_norm(y, p["mixer"]["ln_x"], nh, cfg.norm_eps)
    out["group_norm"] = gn
    out["gate"] = gn * g
    out["wo"] = torch.einsum("bse,ed->bsd", out["gate"],
                             layers.gathered(p["mixer"]["wo"], cfg.dtype))
    x1 = x + out["wo"]
    h2 = layers.rmsnorm(p["norm2"], x1, cfg.norm_eps)
    out["channel_mix"] = ssm.rwkv_cm_forward(p["ffn"], h2, cfg)
    out["block"] = x1 + out["channel_mix"]
    return out


def _ops_diff(got, want, n):
    return {k: _head(got[k], want[k], n) for k in want}


def run():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    base = TC.get_config(ARCH)
    cfgs = {dt: type(base)(**{**base.__dict__, "dtype": getattr(torch, dt)})
            for dt in ("float32", "float64")}
    p32 = lm.init_params(0, cfgs["float32"], device=dev)
    p64 = TO.tree_map(lambda t: t.double(), p32)
    n_par = sum(t.numel() for t in TO.tree_leaves(p32))
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, base.vocab_size,
                                        (BATCH, LENGTHS[1])),
                           dtype=torch.int64, device=dev)
    n = LENGTHS[0]
    res = {"arch": ARCH, "batch": BATCH, "lengths": list(LENGTHS),
           "params": n_par, "perturb": PERTURB}
    gen = torch.Generator().manual_seed(0)
    noise = torch.randn((BATCH, n, base.d_model), generator=gen,
                        dtype=torch.float64)
    streams = {}
    with torch.no_grad():
        for dt, params in (("float32", p32), ("float64", p64)):
            cfg = cfgs[dt]
            with (_wide() if dt == "float64" else contextlib.nullcontext()):
                long_ = _stream(params, toks, cfg)
                short = _stream(params, toks[:, :n], cfg)
                scale = PERTURB * float(short[1].abs().max())
                bumped = _stream(params, toks[:, :n], cfg,
                                 (noise * scale).to(dev))
                drift = [_head(a, b, n) for a, b in zip(long_, short)]
                growth = [_head(a, b, n) for a, b in zip(bumped, short)]
                first = next((i - 1 for i, r in enumerate(drift)
                              if r["prefix_max_abs"] > 0
                              and 0 < i < len(drift) - 1), None)
                ops = {}
                if first is not None:
                    p = params["groups"][first]["b0"]
                    ops = _ops_diff(_layer_ops(p, long_[first], cfg),
                                    _layer_ops(p, short[first], cfg), n)
                w = layers.gathered(params["groups"][0]["b0"]["mixer"]["wr"],
                                    cfg.dtype)
                h = long_[0]
                gemm = _head((h.reshape(-1, base.d_model) @ w).reshape(
                    BATCH, LENGTHS[1], -1), (h[:, :n].reshape(
                        -1, base.d_model) @ w).reshape(BATCH, n, -1), n)
            res[dt] = {"drift": drift, "growth": growth,
                       "first_layer_that_differs": first,
                       "ops_of_first_layer": ops, "gemm_same_rows": gemm}
            streams[dt] = short
            del long_, bumped
        # each layer in float32 on the float64 run's input to it
        cfg = cfgs["float32"]
        s64 = streams["float64"]
        inj = []
        for i, gp in enumerate(p32["groups"]):
            y, _ = blocks.block_forward(gp["b0"], s64[i].float(), cfg,
                                        cfg.group_layout[0])
            inj.append(_head(y, s64[i + 1], n))
        worst = int(np.argmax([r["head_rel"] for r in inj]))
        got = _layer_ops(p32["groups"][worst]["b0"], s64[worst].float(), cfg)
        with _wide():
            want = _layer_ops(p64["groups"][worst]["b0"], s64[worst],
                              cfgs["float64"])
        res["injection"] = {"layers": inj, "worst_layer": worst,
                            "ops_of_worst_layer": _ops_diff(got, want, n)}
    return res


def _print(res, card):
    n = len(res["float32"]["drift"])
    for dt in ("float32", "float64"):
        r = res[dt]
        for i, (d, g) in enumerate(zip(r["drift"], r["growth"])):
            print(f"  {dt} after {_name(i, n):>9}: S 543 vs 512 "
                  f"{d['head_rel']:.3e} of {d['head_max_value']:.3e}, "
                  f"perturbed {g['head_rel']:.3e}")
        for k, o in r["ops_of_first_layer"].items():
            print(f"  {dt} layer {r['first_layer_that_differs']} op {k:>11}: "
                  f"S 543 vs 512 {o['head_max_abs']:.3e} of "
                  f"{o['head_max_value']:.3e}")
        print(f"  {dt} GEMM on identical rows: "
              f"{r['gemm_same_rows']['prefix_max_abs']:.3e}")
    inj = res["injection"]
    for i, r in enumerate(inj["layers"]):
        print(f"  float32 layer {i} on the float64 input: {r['head_rel']:.3e}"
              f" of {r['head_max_value']:.3e}")
    for k, o in inj["ops_of_worst_layer"].items():
        print(f"  float32 layer {inj['worst_layer']} op {k:>11} against "
              f"float64: {o['head_rel']:.3e} of {o['head_max_value']:.3e}")
    print(f"  [{card}]")


def main():
    if not torch.cuda.is_available():
        print("prefix_probe.py needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    res = run()
    res["card"] = card
    res["wall_s"] = round(time.perf_counter() - t0, 1)
    _print(res, card)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
