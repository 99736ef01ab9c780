"""What each rank of ``tests/test_torch_lm_tp.py`` runs (imports no JAX, so
the spawned ranks start quickly): the port's LM on a ``data x model`` mesh
of gloo CPU ranks, on the reference's weights, with its layers tensor
parallel over the model axis. Rank 0 returns whole arrays (logits, caches,
gradients); every rank returns its scalars, to check that all ranks agree.
The serving and training jobs are ``tests/_torch_lm_sharding_ranks.py``'s."""

from __future__ import annotations

import os

import numpy as np
import torch

import _torch_lm_sharding_ranks as base


def _placement(model, name: str) -> str:
    par = model.par
    return repr(dict(model.named_parameters())[name].placements[par.names.index("model")])


def leaves(mesh, name: str, params, over: dict, pad: bool = False):
    """Which parameters compute with the rank's own model-axis chunk, each
    parameter's model-axis placement, the collectives (calls and bytes by
    kind) of the cast tree made ready whole (``parallel.full``) and each of
    its leaves' shape beside its whole shape.
    ``pad``: build with ``build_model``'s head policy."""
    from repro_torch.launch.steps import build_model
    from repro_torch.models import parallel
    from repro_torch.models.transformer import flatten_tree

    cfg = base._cfg(name, **over)
    if pad:
        cfg = build_model(cfg, "meta", mesh=mesh).cfg
    model = base._model(cfg, params, mesh)
    par = model.par
    rest = model.cast_params()  # each rank's shards at rest, no collective
    parallel.reset_collectives()
    cast = flatten_tree(parallel.full(rest))  # made ready whole, once
    moved = {k: list(v) for k, v in parallel.COLLECTIVES.items()}
    named = dict(model.named_parameters())
    return {"local": sorted(k for k in named if par.local_on_model(k)),
            "model_placement": {k: _placement(model, k) for k in named},
            "cast_collectives": moved,
            "shapes": {k: [list(cast[k].shape), list(named[k].shape),
                           list(named[k].to_local().shape)] for k in named},
            "flags": {"attn_tp": par.attn_tp, "mla_tp": par.mla_tp, "ssm_tp": par.ssm_tp,
                      "vocab_tp": par.vocab_tp, "mlp_tp": par.mlp_tp},
            "n_heads": cfg.n_heads, "qkv_fused": cfg.qkv_fused}


def grads(mesh, name: str, params, tokens: np.ndarray, labels: np.ndarray, over: dict,
          extras=None):
    """The loss, its metrics and the gradient of every parameter (made whole:
    averaged over the data shards, joined over the model axis) of one
    training forward (remat, as training runs it) on the global batch."""
    from repro_torch.models.parallel import gather_full

    cfg = base._cfg(name, **over)
    model = base._model(cfg, params, mesh)
    batch = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels),
             **(base._extras(extras) or {})}
    named = dict(model.named_parameters())
    loss, metrics = model.loss(batch)
    got = torch.autograd.grad(loss, list(named.values()), allow_unused=True,
                              materialize_grads=True)
    return {"loss": float(loss), "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {k: base._np(gather_full(g)) for k, g in zip(named, got)}}


def main(rank: int, jobs: list) -> list:
    """Each job ``(kind, (data, model), kwargs)`` on a ``data x model`` mesh
    of the job's ranks; rank 0 returns the results, the others only their
    scalars."""
    os.nice(10)  # leave the suite's other workers their cores
    from repro_torch.launch.mesh import make_host_mesh

    meshes = {}
    out = []
    for kind, shape, kwargs in jobs:
        if shape not in meshes:
            meshes[shape] = make_host_mesh(data=shape[0], model=shape[1], device="cpu")
        res = {"serve": base.serve, "train": base.train, "leaves": leaves,
               "grads": grads}[kind](meshes[shape], **kwargs)
        if rank != 0:
            res = base._scalars(res)
        out.append(res)
    return out
