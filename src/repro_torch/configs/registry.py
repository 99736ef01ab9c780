"""Registry of the 10 assigned architectures (exact public configs).

Sources per the assignment brackets; any assignment-internal inconsistency is
resolved toward the published model card and noted in DESIGN.md.
"""

from __future__ import annotations

from typing import Dict

from .base import ArchConfig

ARCHS: Dict[str, ArchConfig] = {}


def _reg(cfg: ArchConfig) -> ArchConfig:
    ARCHS[cfg.name] = cfg
    return cfg


# --- MoE -------------------------------------------------------------------

deepseek_v3_671b = _reg(ArchConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=18432,  # dense layers (first 3)
    vocab_size=129280,
    n_experts=256, experts_top_k=8, d_ff_expert=2048, n_shared_experts=1,
    first_k_dense=3,
    mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    mtp=True, rope_theta=10000.0,
))

deepseek_v2_lite_16b = _reg(ArchConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10944,  # first dense layer
    vocab_size=102400,
    n_experts=64, experts_top_k=6, d_ff_expert=1408, n_shared_experts=2,
    first_k_dense=1,
    mla=True, q_lora_rank=0, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
))

# --- dense -----------------------------------------------------------------

stablelm_1_6b = _reg(ArchConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=5632, vocab_size=100352,
    norm="layernorm", act="swiglu", partial_rotary=0.25,
    rope_theta=10000.0,
))

qwen2_1_5b = _reg(ArchConfig(
    name="qwen2-1.5b", family="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab_size=151936,
    qkv_bias=True, rope_theta=1000000.0, tie_embeddings=True,
))

mistral_nemo_12b = _reg(ArchConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=131072,
    rope_theta=1000000.0, max_seq=131072,
))

starcoder2_3b = _reg(ArchConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2,
    d_ff=12288, vocab_size=49152,
    norm="layernorm", act="gelu", mlp_bias=True, qkv_bias=True,
    rope_theta=999999.4,
))

# --- audio (enc-dec backbone; conv frontend stubbed) -------------------------

whisper_base = _reg(ArchConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab_size=51865,
    norm="layernorm", act="gelu", mlp_bias=True,
    encoder_layers=6, encoder_seq=1500, cross_attn_every=1,
))

# --- hybrid / ssm ------------------------------------------------------------

jamba_1_5_large_398b = _reg(ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab_size=65536,
    n_experts=16, experts_top_k=2, d_ff_expert=24576, moe_every=2,
    ssm=True, ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_conv=4,
    attn_every=8,
))

mamba2_1_3b = _reg(ArchConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm=True, ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_conv=4,
    tie_embeddings=True,
))

# --- vlm (vision encoder stubbed as patch embeddings) ------------------------

llama_3_2_vision_11b = _reg(ArchConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=128256,
    rope_theta=500000.0,
    encoder_seq=1601, cross_attn_every=5,
))


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
