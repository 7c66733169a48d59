"""Batched serving demo on the PyTorch port: prefill and step-synchronous
greedy decode with the KV cache, on the card unless ``--device cpu``.
Verifies the decoded continuation against the teacher-forced argmax of
the train forward.

  PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.launch.serve import ServeEngine  # noqa: E402
from repro_torch.models import lm  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    cfg = dataclasses.replace(
        configs.get_config("llama3.2-1b").reduced(),
        name="serve-demo", n_layers=4, d_model=128, n_heads=4,
        n_kv_heads=2, head_dim=32, d_ff=256, vocab_size=1024)
    params = lm.init_params(7, cfg, device=args.device)

    batch, prompt_len, n_new = 4, 12, 20
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (batch, prompt_len)).astype(np.int32)

    engine = ServeEngine(cfg, params, max_len=prompt_len + n_new,
                         batch_size=batch)
    out = engine.generate(prompts, n_new=n_new, temperature=0.0)
    print("prompts:", prompts[:, :8], "...")
    print("generated:", out[:, prompt_len:])

    # verify against teacher forcing: feed the generated stream through
    # the train forward; argmax at each position must reproduce it
    with torch.inference_mode():
        logits, _ = lm.forward(params, torch.as_tensor(
            out[:, :-1], device=engine.device), cfg)
    greedy = logits.argmax(-1).cpu().numpy()[:, prompt_len - 1:]
    agree = float((greedy == out[:, prompt_len:]).mean())
    print(f"teacher-forced agreement: {agree:.3f} on {engine.device}")
    if agree != 1.0:
        raise RuntimeError("the decode path diverged from the train forward")
    print("serving OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
