"""LM serving: the static-batch token engine and its CLI launcher.

:class:`ServeEngine` (one prefill, then step-synchronous decode over
``lm.decode_step``) serves the language models; it shares nothing with
the image-segmentation serving stack (``repro_torch.serving.fcm_engine``).
``repro_torch.serving.ServeEngine`` remains as a deprecated re-export.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --reduced --batch 4 --prompt-len 16 --new-tokens 32 [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional

import numpy as np
import torch

from .. import configs
from ..configs.base import ModelConfig
from ..models import lm
from ..training import checkpoint as ckpt


class ServeEngine:
    """Static-batch engine: one prefill for the whole batch, then
    step-synchronous decode. ``max_len`` bounds the KV cache. Runs on
    the device of ``params``."""

    def __init__(self, cfg: ModelConfig, params, max_len: int,
                 batch_size: int):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.batch_size = batch_size
        self.device = params["embed"]["table"].device

    def generate(self, prompts, n_new: int, temperature: float = 0.0,
                 seed: int = 0,
                 extra_inputs: Optional[Dict] = None) -> np.ndarray:
        """prompts (B, P) int -> (B, P + n_new) int32. Greedy argmax at
        ``temperature`` 0; else draws from softmax(logits / temperature)
        with a :class:`torch.Generator` on the parameters' device seeded
        with ``seed`` (reproducible, but not ``jax.random``'s draws).
        ``extra_inputs``: prefill's ``memory`` (a vision model's image
        embeddings) and ``frames`` (an encoder-decoder model's), numpy
        arrays or tensors, moved to the engine's device."""
        prompts = np.asarray(prompts)
        if prompts.ndim != 2:
            raise ValueError(f"prompts must be (B, P), got {prompts.shape}")
        b, plen = prompts.shape
        if b != self.batch_size:
            raise ValueError(f"a batch of {b} prompts on an engine of batch "
                             f"size {self.batch_size}")
        if plen + n_new > self.max_len:
            raise ValueError(f"{plen} prompt + {n_new} new tokens exceed "
                             f"max_len {self.max_len}")
        if prompts.size and not (0 <= prompts.min()
                                 and prompts.max() < self.cfg.vocab_size):
            raise ValueError(f"prompt tokens must lie in [0, "
                             f"{self.cfg.vocab_size})")
        with torch.inference_mode():
            tokens = torch.as_tensor(prompts.astype(np.int32),
                                     device=self.device)
            cache = lm.init_cache(self.cfg, b, self.max_len,
                                  device=self.device)
            extra = {k: torch.as_tensor(v, device=self.device)
                     for k, v in (extra_inputs or {}).items()}
            logits, cache = lm.prefill(self.params, tokens, cache, self.cfg,
                                       **extra)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed))
            out = [tokens]
            tok = self._sample(logits, temperature, gen)
            out.append(tok)
            for i in range(1, n_new):
                pos = plen + i - 1
                logits, cache = lm.decode_step(self.params, tok, cache, pos,
                                               self.cfg)
                tok = self._sample(logits, temperature, gen)
                out.append(tok)
            return torch.cat(out, dim=1).cpu().numpy()

    @staticmethod
    def _sample(logits, temperature: float, gen: torch.Generator):
        last = logits[:, -1]
        if temperature <= 0.0:
            return torch.argmax(last, dim=-1).to(torch.int32)[:, None]
        probs = torch.softmax(last / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen).to(torch.int32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = configs.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = lm.init_params(0, cfg, device=args.device)
    if args.ckpt_dir:
        state, _ = ckpt.load_checkpoint(args.ckpt_dir, {"params": params})
        params = state["params"]

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    extra = {}
    if cfg.n_img_tokens:
        extra["memory"] = torch.as_tensor(rng.standard_normal(
            (args.batch, cfg.n_img_tokens, cfg.d_model))).to(cfg.dtype)
    if cfg.is_encdec:
        extra["frames"] = torch.as_tensor(rng.standard_normal(
            (args.batch, args.prompt_len, cfg.d_model)), dtype=torch.float32)
    engine = ServeEngine(cfg, params,
                         max_len=args.prompt_len + args.new_tokens,
                         batch_size=args.batch)
    out = engine.generate(prompts, args.new_tokens, args.temperature,
                          extra_inputs=extra)
    for b in range(args.batch):
        print(f"[{b}] prompt={prompts[b, :6].tolist()}... "
              f"-> {out[b, args.prompt_len:args.prompt_len + 12].tolist()}...")
    print(f"generated {args.batch}x{args.new_tokens} tokens on "
          f"{engine.device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
