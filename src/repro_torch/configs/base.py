"""Config schema of the language-model stack: the architecture
(:class:`ModelConfig` with its group layout of :class:`BlockDesc`), the
MoE and MLA sub-configs, and the assigned input shapes.

The port's own copy of ``repro/configs/base.py``: the same fields and
defaults, with ``dtype`` a :class:`torch.dtype` (bfloat16, float32 in
:meth:`ModelConfig.reduced`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class BlockDesc:
    mixer: str = "gqa"          # gqa | mla | mamba | rwkv6 | cross
    ffn: str = "swiglu"         # swiglu | gelu | moe | rwkv_cm
    cross: bool = False         # extra cross-attn sub-layer (whisper dec)
    gated: bool = False         # gated cross-attn (llama-vision)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    router: str = "softmax"     # softmax | fcm (the paper's bridge)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    group_layout: Tuple[BlockDesc, ...] = (BlockDesc(),)
    enc_layers: int = 0         # >0 -> encoder-decoder (whisper)
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    n_img_tokens: int = 0       # vlm stub frontend tokens
    audio_frames: bool = False  # input is precomputed frame embeddings
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    rwkv_head_dim: int = 64
    mamba_d_state: int = 16
    mamba_expand: int = 2
    mamba_conv: int = 4
    mamba_pallas: bool = False   # selective-scan kernel (train forward)
    sub_quadratic: bool = False  # True -> long_500k shape applies
    dtype: Any = torch.bfloat16
    # execution knobs: flash (chunked online-softmax) attention above
    # flash_threshold positions; remat of the group loop under autograd
    flash_threshold: int = 4096
    q_chunk: int = 512
    kv_chunk: int = 1024
    remat: bool = True
    microbatches: int = 1

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.n_heads)
        if self.n_layers % len(self.group_layout) != 0:
            raise ValueError(f"{self.name}: n_layers {self.n_layers} is not "
                             f"a multiple of the group length "
                             f"{len(self.group_layout)}")

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.group_layout)

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU tests: one group, narrow
        widths, few experts, float32 — the same code paths."""
        # capacity_factor=8: drop-free at test sizes, as in the JAX package
        moe = (MoEConfig(n_experts=min(8, self.moe.n_experts),
                         top_k=min(2, self.moe.top_k), d_ff_expert=64,
                         n_shared=min(1, self.moe.n_shared),
                         capacity_factor=8.0,
                         router=self.moe.router)
               if self.moe else None)
        mla = (MLAConfig(kv_lora_rank=32, q_lora_rank=48,
                         qk_nope_head_dim=16, qk_rope_head_dim=8,
                         v_head_dim=16) if self.mla else None)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=len(self.group_layout),
            d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=512, enc_layers=min(self.enc_layers, 2),
            moe=moe, mla=mla, n_img_tokens=8 if self.n_img_tokens else 0,
            rwkv_head_dim=16, mamba_d_state=4,
            flash_threshold=2048, microbatches=1,
            dtype=torch.float32,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def applicable_shapes(cfg: ModelConfig):
    """The assigned shapes, less long_500k for quadratic attention."""
    return [s for s in SHAPES.values()
            if s.name != "long_500k" or cfg.sub_quadratic]
