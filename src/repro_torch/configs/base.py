"""Architecture configuration system.

One :class:`ArchConfig` per assigned architecture (exact public configs), plus
``reduced()`` smoke-scale twins for CPU tests. ``input_specs`` builds the
abstract inputs for each assigned input shape: tensors on the ``meta``
device, which hold a shape and a dtype and no storage. A copy of
``repro.configs.base``; only ``input_specs``'s return type differs.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Tuple

import torch


def pad_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    max_seq: int = 131072

    # norm / act / misc
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "swiglu"  # swiglu | gelu
    qkv_bias: bool = False
    mlp_bias: bool = False
    rope_theta: float = 10000.0
    partial_rotary: float = 1.0  # fraction of head_dim rotated
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    experts_top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    first_k_dense: int = 0  # leading dense layers (deepseek)
    moe_every: int = 1  # MoE layer stride (jamba: 2)
    moe_capacity_factor: float = 1.25

    # MLA (deepseek)
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # SSM (mamba2)
    ssm: bool = False
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    attn_every: int = 0  # hybrid: 1 attention layer per this many (jamba: 8)

    # enc-dec / multimodal stubs
    encoder_layers: int = 0
    encoder_seq: int = 0  # stub frontend sequence length (frames/patches)
    cross_attn_every: int = 0  # vlm: cross-attn layer stride
    mtp: bool = False  # deepseek multi-token prediction head

    # training defaults
    dtype: str = "bfloat16"
    qkv_fused: bool = True  # fused QKV projection (build_model may unset for
    # TP divisibility; see launch/steps.py)

    # ------------------------------------------------------------------ api
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab_size, 256)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kind string: 'attn' | 'ssm' mixer, '+moe' / '+cross'."""
        kinds = []
        for i in range(self.n_layers):
            if self.ssm and self.attn_every:
                mixer = "attn" if (i % self.attn_every) == (self.attn_every // 2) else "ssm"
            elif self.ssm:
                mixer = "ssm"
            else:
                mixer = "attn"
            moe = (
                self.is_moe
                and i >= self.first_k_dense
                and ((i - self.first_k_dense) % self.moe_every == 0)
            )
            cross = self.cross_attn_every > 0 and (
                self.cross_attn_every == 1
                or (i % self.cross_attn_every) == self.cross_attn_every - 2
            )
            kinds.append(mixer + ("+moe" if moe else "") + ("+cross" if cross else ""))
        return tuple(kinds)

    def reduced(self) -> "ArchConfig":
        """Smoke-scale twin: same wiring, tiny dims."""
        small = {
            "n_layers": min(self.n_layers, 4 if not (self.ssm and self.attn_every) else 8),
            "d_model": 64,
            "n_heads": 4,
            "n_kv_heads": min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            "d_ff": 128,
            "vocab_size": 503,
            "head_dim": 16,
            "max_seq": 256,
        }
        if self.is_moe:
            small.update(
                n_experts=8, experts_top_k=min(self.experts_top_k, 2),
                d_ff_expert=64,
                n_shared_experts=min(self.n_shared_experts, 1),
                first_k_dense=min(self.first_k_dense, 1),
            )
        if self.mla:
            small.update(
                q_lora_rank=32 if self.q_lora_rank else 0, kv_lora_rank=32,
                qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, head_dim=0,
            )
        if self.ssm:
            small.update(ssm_state=16, ssm_headdim=16)
        if self.encoder_layers:
            small.update(encoder_layers=2, encoder_seq=32)
        return replace(self, **small)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether the (arch, shape) cell runs; reason if skipped."""
    if shape.name == "long_500k" and not arch.ssm:
        return False, "long_500k needs sub-quadratic attention (SSM/hybrid only)"
    return True, ""


def input_specs(arch: ArchConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """Abstract model inputs for the dry-run (no allocation): ``meta``
    tensors with the reference's shapes and dtypes.

    train:   tokens/labels (B, S) [+ modality stub embeddings]
    prefill: tokens (B, S) [+ stubs]
    decode:  tokens (B, 1) + KV/SSM cache structs are built by the model's
             cache_specs (the launcher composes them).
    """
    B, S = shape.global_batch, shape.seq_len

    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    i32 = torch.int32
    specs: Dict[str, torch.Tensor] = {}
    if shape.kind == "train":
        specs["tokens"] = spec((B, S), i32)
        specs["labels"] = spec((B, S), i32)
    elif shape.kind == "prefill":
        specs["tokens"] = spec((B, S), i32)
    else:  # decode
        specs["tokens"] = spec((B, 1), i32)
    if arch.family == "audio":
        # conv frontend is a STUB: precomputed frame embeddings
        specs["frames"] = spec((B, arch.encoder_seq, arch.d_model), torch.bfloat16)
    if arch.family == "vlm":
        specs["patches"] = spec((B, arch.encoder_seq, arch.d_model), torch.bfloat16)
    return specs
