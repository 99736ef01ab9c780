"""Step builders for LM serving: the serving half of
``repro.launch.steps`` on one device.

The reference jits its steps with production shardings over a mesh; here a
step is a plain function on the port's :class:`Model`. Sharding over ranks
(``--data-par``/``--model-par``) is not ported yet: :class:`ParallelismNotPorted`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ..configs.base import ArchConfig
from ..device import DeviceLike
from ..models.transformer import Model


class ParallelismNotPorted(NotImplementedError):
    """Data or model parallelism over ranks: A14c of the port's roadmap
    (``models/sharding``, ``launch/mesh``, MoE's exchange under torchrun)."""


def data_axes_for(axis_names: Sequence[str]) -> Tuple[str, ...]:
    """The batch axes of a mesh with these axis names."""
    return ("pod", "data") if "pod" in axis_names else ("data",)


def pad_heads_for_tp(cfg: ArchConfig, tp: int) -> ArchConfig:
    """Pad the query-head count to a multiple of the TP width so attention
    shards instead of replicating (Megatron-style padding). head_dim is
    frozen first so padding doesn't change it."""
    if cfg.n_heads == 0 or tp <= 1 or cfg.mla:
        return cfg
    out = cfg
    if cfg.n_heads % tp != 0:
        padded = ((cfg.n_heads + tp - 1) // tp) * tp
        out = dataclasses.replace(out, head_dim=out.hd, n_heads=padded)
    # fused QKV only when the fused head dim still shards over TP
    if (out.n_heads + 2 * out.n_kv_heads) % tp != 0:
        out = dataclasses.replace(out, qkv_fused=False)
    return out


def build_model(cfg: ArchConfig, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None) -> Model:
    """The model of ``cfg`` on one device (no mesh), its weights drawn from
    ``generator`` (unset without one)."""
    return Model(cfg, device=device, generator=generator)


def make_prefill_step(model: Model):
    def prefill_step(params, batch):
        extras = {k: v for k, v in batch.items() if k in ("frames", "patches")}
        return model.prefill(batch["tokens"], extras=extras or None, params=params)

    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, tokens, cache, extras=None):
        logits, cache = model.decode_step(tokens, cache, extras=extras, params=params)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_tok, cache

    return decode_step
