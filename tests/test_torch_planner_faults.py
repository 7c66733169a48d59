"""Two faults of the port's LM path, on the CPU.

(p) The planner's scaled loops. ``op_cost.repeat`` runs one trip of a
loop weighted by its trip count. The eager backward also adds each
trip's gradient of an input that every trip reads (``u[:, t]`` of a
walked input gives a gradient of ``u``'s full size) into one gradient,
and takes the gradient of the loop's carries in every trip but the
first; one trip shows neither. With both charged, the bytes of one
train step at (2, 64) under ``CostCounter(scale_loops=True)`` must lie
within 1 % of the unscaled count on reduced jamba-v0.1-52b and
rwkv6-1.6b (76.2 % and 75.6 % before) and within 2 % on reduced
granite-moe-3b-a800m, deepseek-v2-236b and llama3.2-1b with four flash
chunks of queries and of keys, and on granite's state placed across a
(2, 2) mesh (each expert block read by its tp rank's trips alone); flops
within 0.1 %.

(o) A causal forward is prefix-invariant: reduced rwkv6-1.6b's logits
at the first 512 positions do not move when the sequence grows to 543,
beyond float32 rounding (a GEMM's blocking may follow the row count).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs as TC
from repro_torch.analysis import op_cost
from repro_torch.core import distributed as TD
from repro_torch.data import pipeline as TP
from repro_torch.launch import dryrun as TDR
from repro_torch.models import lm as TLM
from repro_torch.models import sharding as sh
from repro_torch.training import train_loop as TT

#: (arch, config changes, bytes tolerance)
CASES = {
    "jamba": ("jamba-v0.1-52b", {}, 0.01),
    "rwkv6": ("rwkv6-1.6b", {}, 0.01),
    "granite": ("granite-moe-3b-a800m", {}, 0.02),
    "deepseek": ("deepseek-v2-236b", {}, 0.02),
    # S = 64 in chunks of 16: 4 x 4 (q chunk, kv chunk) trips
    "llama_chunked": ("llama3.2-1b", {"flash_threshold": 16, "q_chunk": 16,
                                      "kv_chunk": 16}, 0.02),
    "granite_placed": ("granite-moe-3b-a800m", {}, 0.02),
}


def _costs(cfg, scale, mesh=None):
    ctx = sh.make_parallelism(mesh)
    state = TT.init_state(0, cfg, TDR.TRAIN_CFG, device="cpu", ctx=ctx)
    batch = {k: torch.as_tensor(v) for k, v in TP.make_batch(
        cfg, TC.ShapeConfig("t", "train", 64, 2), 0).items()}
    step = TT.make_train_step(cfg, TDR.TRAIN_CFG)
    with sh.parallelism(ctx), op_cost.CostCounter(scale_loops=scale) as c:
        step(state, batch)
    return c.costs


@pytest.mark.parametrize("name", sorted(CASES))
def test_scaled_loops_count_the_eager_step(name):
    arch, changes, tol = CASES[name]
    cfg = dataclasses.replace(TC.get_config(arch).reduced(), **changes)
    mesh = (TD.make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
            if name.endswith("_placed") else None)
    scaled, plain = _costs(cfg, True, mesh), _costs(cfg, False, mesh)
    assert scaled.bytes == pytest.approx(plain.bytes, rel=tol), name
    assert scaled.flops == pytest.approx(plain.flops, rel=1e-3), name
    assert scaled.dot_flops == pytest.approx(plain.dot_flops, rel=1e-3)


def test_scaled_loop_charges_the_gradient_accumulation():
    """A walked input's accumulation: (n - 1) adds of 3 x its bytes, on
    top of one trip's gradient counted n times."""
    n, shape = 8, (3, 8, 5)
    x = torch.randn(shape, requires_grad=True)

    def body(trips, x):
        return (torch.stack([x[:, t] * 2.0 for t in range(trips)], 1),)

    def run(scale):
        with op_cost.CostCounter(scale_loops=scale) as c:
            loop = op_cost.repeat(n)
            y, = loop.run(body, x)
            y = loop.fill(y, 1)
            torch.autograd.grad(y.sum(), x)
        return c.costs.by_op.get("add", [0, 0.0])[1]

    nbytes = x.numel() * 4
    assert run(True) == pytest.approx(3 * (n - 1) * nbytes)
    assert run(True) == pytest.approx(run(False))


def test_rwkv6_forward_is_prefix_invariant():
    cfg = TC.get_config("rwkv6-1.6b").reduced()
    params = TLM.init_params(0, cfg, device="cpu")
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 543)))
    with torch.no_grad():
        short, _ = TLM.forward(params, toks[:, :512], cfg)
        long, _ = TLM.forward(params, toks, cfg)
    top = float(short.abs().max())
    assert float((long[:, :512] - short).abs().max()) <= 1e-5 * top
    assert torch.equal(long[:, :8], short[:, :8])


if __name__ == "__main__":
    # the figures behind the test: bytes and flops of one train step at
    # (2, 64), scaled against unscaled, and the eager backward's aten add
    for name, (arch, changes, _) in CASES.items():
        cfg = dataclasses.replace(TC.get_config(arch).reduced(), **changes)
        mesh = (TD.make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
                if name.endswith("_placed") else None)
        s, u = _costs(cfg, True, mesh), _costs(cfg, False, mesh)
        print(f"{name}: bytes scaled {s.bytes / 1e6:.1f} MB, unscaled "
              f"{u.bytes / 1e6:.1f} MB ({100 * s.bytes / u.bytes:.2f} %), "
              f"flops {100 * s.flops / u.flops:.3f} %, add "
              f"{s.by_op['add'][1] / 1e6:.1f} / "
              f"{u.by_op['add'][1] / 1e6:.1f} MB")
