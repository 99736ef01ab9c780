"""Step builders for LM training and serving; the port of
``repro.launch.steps``.

The reference jits its steps with production shardings over a mesh; here a
step is a plain function on the port's :class:`Model`, its backward
autograd's. On a mesh (a ``DeviceMesh`` from ``launch/mesh.py``) the model's
parameters are DTensors with the reference's placements, and the steps take
and give global batches (``models/parallel.py``). The reference's dry-run
tooling (``abstract_state``, ``jitted_train_step``, ``jitted_serve_step``)
has no twin yet (A14d of the port's roadmap).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch

from ..configs.base import ArchConfig
from ..device import DeviceLike
from ..models.sharding import data_axes_for  # noqa: F401 (the reference's steps.data_axes_for)
from ..models.transformer import Model
from ..optim import adamw


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
                generator: Optional[torch.Generator] = None, remat: bool = True,
                mesh=None, pad_heads: bool = True) -> Model:
    """The model of ``cfg`` on ``device``, its weights drawn from
    ``generator`` (unset without one); ``remat``: recompute each body
    unit's activations in a training step's backward pass. ``mesh``: a
    ``DeviceMesh`` to shard it on (every rank draws the same weights and
    keeps its slices), with the reference's policy: with a model axis above
    1, the query heads are padded for TP (:func:`pad_heads_for_tp`), or with
    ``pad_heads=False`` (the decode policy) QKV fusion is turned off."""
    if mesh is not None and "model" in mesh.mesh_dim_names:
        tp = mesh.shape[mesh.mesh_dim_names.index("model")]
        if pad_heads:
            cfg = pad_heads_for_tp(cfg, tp)
        elif not cfg.mla and cfg.n_heads:
            cfg = dataclasses.replace(cfg, qkv_fused=False)
    return Model(cfg, device=device, generator=generator, remat=remat, mesh=mesh)


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig, microbatches: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradients (summed over ``microbatches``
    equal slices of the batch, then divided by their count, as the
    reference's ``lax.scan`` does), then one AdamW update. ``params`` maps
    parameter names to tensors (``dict(model.named_parameters())``); the
    update writes them and ``opt_state``'s moments in place and returns
    them. ``metrics`` are tensors on the device (nothing waits for them):
    the loss's metrics (``loss``, ``ce_loss``, ``aux_loss``, ``mtp_loss``
    where the config has MTP) with one microbatch, only ``ce_loss`` (the
    mean total loss) with several; then ``grad_norm``, ``lr`` and ``loss``.

    On a mesh the parameters (and moments) are DTensors, ``batch`` is the
    global batch, and each microbatch is the reference's (a slice of the
    global batch, then each data shard's rows of it); the gradients come
    back on their parameters' placements, averaged over the data shards,
    and the metrics are the reference's global ones, on every rank."""

    def value_and_grad(leaves: Dict[str, torch.Tensor], batch: Mapping[str, torch.Tensor]):
        loss, metrics = model.loss(batch, params=model.tree(leaves))
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), metrics, dict(zip(leaves, grads))

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, metrics, grads = value_and_grad(params, batch)
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            def microbatch(x, i):
                b = x.shape[0]
                return x.reshape((microbatches, b // microbatches) + tuple(x.shape[1:]))[i]

            grads = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
            loss = 0.0
            for i in range(microbatches):
                mb = {k: microbatch(x, i) for k, x in batch.items()}
                l_i, _, g = value_and_grad(params, mb)
                for k, acc in grads.items():
                    acc.add_(g[k])
                del g
                loss = loss + l_i
            for acc in grads.values():
                acc.div_(microbatches)
            loss = loss / microbatches
            metrics = {"ce_loss": loss}
        params, opt_state, om = adamw.update(opt_cfg, grads, opt_state, params)
        metrics.update(om)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


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
