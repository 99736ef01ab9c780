"""Step builders for LM training and serving; the port of
``repro.launch.steps``.

The reference jits its steps with production shardings over a mesh; here a
step is a plain function on the port's :class:`Model`, its backward
autograd's. On a mesh (a ``DeviceMesh`` from ``launch/mesh.py``) the model's
parameters are DTensors with the reference's placements, and the steps take
and give global batches (``models/parallel.py``).

The dry run's builders (:func:`abstract_state`, :func:`jitted_train_step`,
:func:`jitted_serve_step`) keep the reference's names, but nothing is
jitted: each returns ``(fn, args)``, ``fn`` the plain step and ``args``
``meta`` tensors (shapes and dtypes, no storage; DTensors with meta local
shards on a mesh). Calling ``fn(*args)`` under
:class:`~repro_torch.launch.hlo_analysis.Census` is the port's
``lower(...).compile()``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch

from ..configs.base import ArchConfig, ShapeConfig, input_specs
from ..device import DeviceLike
from ..models import sharding
from ..models.transformer import Model
from ..optim import adamw
from .hlo_analysis import section


def data_axes_for(mesh) -> Tuple[str, ...]:
    """The batch axes of ``mesh`` (a ``DeviceMesh``), over which FSDP shards
    too: ``("pod", "data")`` with a pod axis, else ``("data",)``."""
    return sharding.data_axes_for(mesh.mesh_dim_names)


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


# ------------------------------------------------------------------ dry-run


def _on_meta(model: Model) -> Model:
    """``model`` where it lives on ``meta``, else a twin there with the same
    config, remat and mesh (nothing allocated)."""
    if model.device.type == "meta":
        return model
    return Model(model.cfg, device="meta", remat=model.remat, mesh=model.mesh)


def _check_mesh(model: Model, mesh, multi_pod: bool) -> None:
    if mesh is not model.mesh:
        raise ValueError("the model is not on this mesh: build it with build_model(..., mesh=mesh)")
    if mesh is not None and multi_pod != ("pod" in data_axes_for(mesh)):
        raise ValueError(f"multi_pod={multi_pod} on a mesh with axes {mesh.mesh_dim_names}")


def abstract_state(model: Model, opt_cfg: Optional[adamw.AdamWConfig] = None):
    """The parameters by name as ``meta`` tensors (those of ``model`` on
    ``meta``, else of a twin there: :func:`build_model` with
    ``device="meta"``), and with ``opt_cfg`` the AdamW state of them; on a
    mesh, DTensors with the reference's placements. Nothing is allocated."""
    params = dict(_on_meta(model).named_parameters())
    return params, (adamw.init(opt_cfg, params) if opt_cfg is not None else None)


def jitted_train_step(
    model: Model, opt_cfg: adamw.AdamWConfig, mesh, shape: ShapeConfig, multi_pod: bool,
    microbatches: int = 1,
):
    """Returns ``(train_step, (params, opt_state, batch))`` on ``meta``: the
    parameters and moments (updated in place, as the reference donates
    them) and ``input_specs`` at the global batch. No jit: call it under a
    census."""
    _check_mesh(model, mesh, multi_pod)
    model = _on_meta(model)
    params, opt_state = abstract_state(model, opt_cfg)
    batch = dict(input_specs(model.cfg, shape))
    return make_train_step(model, opt_cfg, microbatches), (params, opt_state, batch)


def jitted_serve_step(model: Model, mesh, shape: ShapeConfig, multi_pod: bool):
    """Prefill (``shape.kind == "prefill"``) or one decode step (``"decode"``)
    on ``meta``, as ``launch/serve_llm.py`` runs them: ``fn`` casts the
    parameters (``Model.cast_params``, counted under the census section
    ``"weights"``; on a mesh each rank's local shards, no collective), then
    steps, and the step gathers each layer's weights at its use, as the
    reference's jitted step casts inside it and keeps the FSDP shards at
    rest. Prefill's ``args`` are ``(params, batch)``;
    decode's ``(params, tokens [B, 1], cache[, extras])`` with the cache of
    ``shape.seq_len`` made for the data shard's rows where the data axes
    divide the batch (else the whole batch), as ``cache_shardings`` says."""
    _check_mesh(model, mesh, multi_pod)
    model = _on_meta(model)
    params, _ = abstract_state(model)
    batch = dict(input_specs(model.cfg, shape))

    def weights(p):
        with section("weights"):
            return model.cast_params(p)

    if shape.kind == "prefill":
        prefill = make_prefill_step(model)
        return (lambda p, b: prefill(weights(p), b)), (params, batch)

    tokens = batch["tokens"]
    rows = tokens.shape[0] if model.par is None else model.par.rows(tokens).shape[0]
    cache = model.init_cache(rows, shape.seq_len)
    extras = {k: v for k, v in batch.items() if k in ("frames", "patches")}
    decode = make_decode_step(model)

    def fn(p, t, c, e=None):
        return decode(weights(p), t, c, e)

    return fn, (params, tokens, cache) + ((extras,) if extras else ())
