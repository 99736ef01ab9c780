"""What each rank of ``tests/test_torch_lm_at_rest.py`` runs (imports no
JAX, so the spawned ranks start quickly): one reduced arch on a ``data x
model`` mesh of gloo CPU ranks, served twice on the same weights and
tokens: with the weights at rest (``Model.cast_params``: each rank's cast
local shards, every layer made ready at its use) and with the gathered tree
(``parallel.full`` of it, made ready once). Rank 0 returns whole arrays
(logits and caches gathered over the data shards); every rank returns its
byte counts, to check each rank's own shards."""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

B, PROMPT, DECODE, SEED = 4, 8, 3, 5


def _cfg(name: str, dtype: str):
    from repro_torch.configs.registry import get_arch

    return dataclasses.replace(get_arch(name).reduced(), dtype=dtype)


def _bits(t: torch.Tensor) -> np.ndarray:
    """``t``'s values as float32 numpy (exact for bf16 and float32)."""
    return t.detach().to(torch.float32).numpy().copy()


def _serve(model, params, tokens, extras) -> dict:
    """Prefill of ``PROMPT`` tokens, then ``DECODE`` teacher-forced decode
    steps, each step's logits and the caches after prefill and at the end
    (gathered over the data shards), and the greedy token of each step."""
    from _torch_lm_sharding_ranks import _gathered_cache

    b = tokens.shape[0]
    logits, cache = model.prefill(tokens[:, :PROMPT], extras=extras, cache_len=PROMPT + DECODE,
                                  params=params)
    out = {"prefill": _bits(logits), "prefill_cache": _gathered_cache(model, cache, b)}
    greedy = [torch.argmax(logits, -1)]
    for i in range(DECODE):
        logits, cache = model.decode_step(tokens[:, PROMPT + i:PROMPT + i + 1], cache,
                                          extras=extras, params=params)
        out[f"decode{i}"] = _bits(logits)
        greedy.append(torch.argmax(logits, -1))
    out["decode_cache"] = _gathered_cache(model, cache, b)
    out["greedy"] = torch.stack(greedy, 1).numpy()
    return out


def _placed_bytes(model, name: str, dtype: torch.dtype) -> int:
    """Leaf ``name``'s bytes on one rank at ``dtype``, reckoned from its
    whole shape and its placements: the whole's over each sharding axis's
    size."""
    from torch.distributed.tensor import Shard

    p = dict(model.named_parameters())[name]
    n = p.numel()
    for axis, pl in zip(model.par.names, p.placements):
        if isinstance(pl, Shard):
            n //= model.par.sizes[axis]
    return n * torch.empty((), dtype=dtype).element_size()


def at_rest(mesh, name: str, dtype: str) -> dict:
    """Serve ``name`` in ``dtype`` at rest and gathered. Returns both runs'
    results, the at-rest cast's collectives, and per leaf: whether the cast
    leaf is the rank's local shard (a ``Sharded`` leaf of the parameter's
    local shape), its bytes, the bytes its placements give it, the whole
    leaf's bytes at the cast dtype, and the gathered leaf's bytes."""
    from repro_torch.launch.steps import build_model
    from repro_torch.models import parallel
    from repro_torch.models.transformer import flatten_tree

    cfg = _cfg(name, dtype)
    model = build_model(cfg, "cpu", torch.Generator().manual_seed(SEED), remat=False, mesh=mesh)
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, PROMPT + DECODE))
                              .astype(np.int32))
    key = {"audio": "frames", "vlm": "patches"}.get(cfg.family)
    extras = None if key is None else {key: torch.from_numpy(rng.normal(
        size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)}

    parallel.reset_collectives()
    rest = model.cast_params()
    cast_moved = {k: list(v) for k, v in parallel.COLLECTIVES.items()}
    whole = parallel.full(rest)
    named = dict(model.named_parameters())
    leaves = {}
    for k, leaf in flatten_tree(rest).items():
        local = isinstance(leaf, parallel.Sharded) and \
            tuple(leaf.local.shape) == tuple(named[k].to_local().shape)
        t = leaf.local if isinstance(leaf, parallel.Sharded) else leaf
        leaves[k] = {"local": local, "bytes": t.numel() * t.element_size(),
                     "placed": _placed_bytes(model, k, t.dtype),
                     "whole": named[k].numel() * t.element_size()}
    for k, t in flatten_tree(whole).items():
        leaves[k]["gathered"] = t.numel() * t.element_size()
    return {"rest": _serve(model, rest, tokens, extras),
            "gathered": _serve(model, whole, tokens, extras),
            "cast_moved": cast_moved, "leaves": leaves}


def main(rank: int, jobs: list) -> list:
    """Each job ``((data, model), kwargs)`` on a ``data x model`` mesh of
    the job's ranks; rank 0 returns the results, the others their byte
    counts alone."""
    os.nice(10)  # leave the suite's other workers their cores
    from repro_torch.launch.mesh import make_host_mesh

    meshes = {}
    out = []
    for shape, kwargs in jobs:
        if shape not in meshes:
            meshes[shape] = make_host_mesh(data=shape[0], model=shape[1], device="cpu")
        res = at_rest(meshes[shape], **kwargs)
        if rank != 0:
            res = {k: res[k] for k in ("cast_moved", "leaves")}
        out.append(res)
    return out
