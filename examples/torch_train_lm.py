"""End-to-end training on the PyTorch port: a ~100M-parameter
llama-style model on the synthetic pipeline through the launcher's loop
(``repro_torch.launch.train.train``), with checkpoint / resume and the
straggler watchdog, on the card unless ``--device cpu``.

  PYTHONPATH=src python examples/torch_train_lm.py --steps 200
  PYTHONPATH=src python examples/torch_train_lm.py --steps 300  # resumes @200

``--layers`` and ``--d-model`` shrink the model (heads of 64, a third
of them KV heads, d_ff four times d_model).
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import train_loop as tl  # noqa: E402


def make_100m_config(layers: int = 12, d_model: int = 768):
    """~100M params at the defaults: llama-family, narrow (113M with tied
    embeddings), float32 compute."""
    heads = max(d_model // 64, 1)
    return dataclasses.replace(
        configs.get_config("llama3.2-1b"), name="llama-100m",
        n_layers=layers, d_model=d_model, n_heads=heads,
        n_kv_heads=max(heads // 3, 1), head_dim=64, d_ff=4 * d_model,
        vocab_size=8192, dtype=torch.float32, remat=False)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        os.path.dirname(__file__), "out", "ckpt_100m_torch"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = make_100m_config(args.layers, args.d_model)
    shape = configs.ShapeConfig("train", "train", args.seq, args.batch)
    tcfg = tl.TrainConfig(optimizer=opt.OptimizerConfig(
        lr=1e-3, warmup_steps=20, total_steps=max(args.steps, 100)))
    n_params = sum(t.numel() for t in opt.tree_leaves(
        lm.abstract_params(cfg)))
    print(f"model: {cfg.name}, {n_params / 1e6:.1f}M params")

    run = launch.train(cfg, shape, tcfg, args.steps, device=args.device,
                       ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    if run.losses:
        s = launch.summary(run, shape)
        print(f"steps {min(run.losses)}-{max(run.losses)}: loss "
              f"{s['loss_first']:.4f} -> {s['loss_last']:.4f}, "
              f"{s['step_ms_median']:.1f} ms a step, "
              f"{s['straggler_flags']} straggler flags")
    print(f"done at step {int(run.state['step'])}; checkpoints in "
          f"{args.ckpt_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
