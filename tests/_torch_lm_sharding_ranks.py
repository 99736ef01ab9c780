"""What each rank of ``tests/test_torch_lm_sharding_ranks.py`` runs (imports
no JAX, so the spawned ranks start quickly): the port's LM on a mesh of
gloo CPU ranks, on the reference's weights (numpy, carried by
``repro_torch.convert``). Each job's results come back from rank 0 (whole
arrays: gathered logits, caches, parameters) and, as scalars, from every
rank, to check that all ranks agree."""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch


def _cfg(name: str, dtype: str = "float32", **over):
    from repro_torch.configs.registry import get_arch

    return dataclasses.replace(get_arch(name).reduced(), dtype=dtype, **over)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy().copy()


def _model(cfg, params, mesh):
    from repro_torch.convert import lm_params_from_reference
    from repro_torch.models.transformer import Model

    return lm_params_from_reference(Model(cfg, device="cpu"), params, mesh=mesh)


def _gathered_cache(model, cache, b: int) -> dict:
    """The cache's leaves with every data shard's rows (``len`` as an int)."""
    from repro_torch.models.transformer import flatten_tree

    out = {}
    for k, v in flatten_tree(cache).items():
        if not torch.is_tensor(v):
            out[k] = int(v)
            continue
        dim = 1 if k.startswith("body.") else 0  # stacked body caches: [reps, B, ...]
        x = v.movedim(dim, 0).contiguous()
        out[k] = _np(model.par.gather_rows(x, b).movedim(0, dim))
    return out


def _extras(extras):
    """The audio/vision stub input (float32 numpy holding bf16 values) as
    the model takes it, or None."""
    if not extras:
        return None
    return {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in extras.items()}


def serve(mesh, name: str, params, tokens: np.ndarray, prompt: int, steps: int, over: dict,
          extras=None):
    """The forward's logits and loss metrics, prefill's last logits and
    cache, then ``steps`` teacher-forced decode steps and the cache."""
    cfg = _cfg(name, **over)
    model = _model(cfg, params, mesh)
    toks = torch.from_numpy(tokens)
    ex = _extras(extras)
    b = toks.shape[0]
    out = {"placements": {k: str(p.placements) for k, p in model.named_parameters()}}
    with torch.no_grad():
        logits = model.forward(toks, extras=ex)[0]
        out["logits"] = _np(model.par.gather_rows(logits, b))
        _, metrics = model.loss({"tokens": toks, "labels": torch.roll(toks, -1, 1), **(ex or {})})
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    pl, cache = model.prefill(toks[:, :prompt], extras=ex, cache_len=tokens.shape[1])
    out["prefill"] = _np(pl)
    out["prefill_cache"] = _gathered_cache(model, cache, b)
    for i in range(steps):
        pl, cache = model.decode_step(toks[:, prompt + i: prompt + i + 1], cache, extras=ex)
        out[f"decode{i}"] = _np(pl)
    out["decode_cache"] = _gathered_cache(model, cache, b)
    return out


def _params(model) -> dict:
    """The model's whole parameters (a collective: every rank calls it)."""
    from repro_torch.models.parallel import gather_full

    return {k: _np(gather_full(p)) for k, p in model.named_parameters()}


def train(mesh, name: str, params, moment_dtype: str, microbatches: int, steps: int,
          lr: float, start: int = 0, save: str = "", restore: str = "", extras=None):
    """``steps`` training steps from step ``start`` on the synthetic batches
    (4 rows of 16, with ``extras`` where the arch takes them); each step's
    metrics and whole parameters. ``save``: write a checkpoint there at the
    end; ``restore``: start from the checkpoint there (saved at step
    ``start``, on whatever mesh)."""
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw
    from repro_torch.train.checkpoint import CheckpointManager

    cfg = _cfg(name)
    model = _model(cfg, params, mesh)
    opt = adamw.AdamWConfig(lr=lr, warmup_steps=2, total_steps=10, moment_dtype=moment_dtype)
    pp = dict(model.named_parameters())
    ps = adamw.init(opt, pp)
    if restore:
        state = CheckpointManager(restore).restore(start, {"params": pp, "opt": ps})
        with torch.no_grad():
            for k, p in pp.items():
                p.copy_(state["params"][k])
        ps = state["opt"]
        assert int(ps.step) == start
    step = make_train_step(model, opt, microbatches)
    data = SyntheticDataset(SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                            global_batch=4, seed=3))
    out = []
    for i in range(start, start + steps):
        batch = {k: torch.from_numpy(v) for k, v in data.batch(i).items()}
        pp, ps, m = step(pp, ps, {**batch, **(_extras(extras) or {})})
        out.append(({k: float(v) for k, v in m.items()}, _params(model)))
    if save:
        CheckpointManager(save).save(start + steps, {"params": pp, "opt": ps}, blocking=True)
    return {"steps": out, "placements": {k: str(p.placements) for k, p in pp.items()},
            "moment_placements": {k: str(v.placements) for k, v in ps.m.items()}}


def exchange(mesh, p: dict, x: np.ndarray, w: np.ndarray, over: dict):
    """``moe_apply`` on the mesh: each rank its data shard's rows and its
    experts (the shared experts' ``d_ff`` columns when they run tensor
    parallel), then the gradient of ``sum(y * w) + aux``. Returns y and aux,
    and the gradients made whole: x's, and each weight's averaged over the
    data shards and joined over the model axis."""
    import torch.distributed as dist

    from repro_torch.models.moe import moe_apply
    from repro_torch.models.parallel import MeshPlan

    cfg = _cfg("deepseek-v2-lite-16b", **over)
    plan = MeshPlan(mesh, cfg)
    b = x.shape[0]
    e_loc = cfg.n_experts // plan.tp
    mine = slice(plan.tp_index * e_loc, (plan.tp_index + 1) * e_loc)
    fs = cfg.d_ff_expert * cfg.n_shared_experts
    f_loc = fs // plan.tp if plan.shared_tp else fs
    cols = slice(plan.tp_index * f_loc, (plan.tp_index + 1) * f_loc)
    local = {
        "router": torch.tensor(p["router"]),
        "wi": torch.tensor(p["wi"][mine]), "wg": torch.tensor(p["wg"][mine]),
        "wo": torch.tensor(p["wo"][mine]),
        "shared": {"wi": torch.tensor(p["shared"]["wi"][:, cols]),
                   "wg": torch.tensor(p["shared"]["wg"][:, cols]),
                   "wo": torch.tensor(p["shared"]["wo"][cols])}}
    leaves = [local["router"], local["wi"], local["wg"], local["wo"],
              local["shared"]["wi"], local["shared"]["wg"], local["shared"]["wo"]]
    for t in leaves:
        t.requires_grad_(True)
    xl = plan.rows(torch.tensor(x)).requires_grad_(True)
    y, aux = moe_apply(local, xl, cfg, plan)
    # sum(y * w) over the whole batch, + aux: each data shard's objective is
    # its rows' share scaled so that their mean is the whole's
    scale = plan.ndp if plan.batch_sharded(b) else 1
    total = plan.data_mean((y * plan.rows(torch.tensor(w))).sum()) * scale + aux
    grads = torch.autograd.grad(total, [xl] + leaves)
    model_group = plan.groups["model"]

    def data_avg(g):
        g = g.clone()
        if plan.ndp > 1:
            dist.all_reduce(g, group=plan.dp_group)
            g /= plan.ndp
        return g

    def join(g, dim):
        parts = [torch.empty_like(g) for _ in range(plan.tp)]
        dist.all_gather(parts, g.contiguous(), group=model_group)
        return torch.cat(parts, dim)

    gx = plan.gather_rows(grads[0] / scale, b)
    g = [data_avg(t) for t in grads[1:]]
    sh = plan.shared_tp
    return {
        "y": _np(plan.gather_rows(y.detach(), b)), "aux": float(aux.detach()),
        "total": float(total.detach()),
        "grad_x": _np(gx), "grad_router": _np(g[0]),
        "grad_wi": _np(join(g[1], 0)), "grad_wg": _np(join(g[2], 0)), "grad_wo": _np(join(g[3], 0)),
        "grad_shared_wi": _np(join(g[4], 1) if sh else g[4]),
        "grad_shared_wg": _np(join(g[5], 1) if sh else g[5]),
        "grad_shared_wo": _np(join(g[6], 0) if sh else g[6]),
        "shared_tp": sh, "batch_sharded": plan.batch_sharded(b)}


def policy(mesh):
    """``build_model``'s policy on the mesh's model axis: the configs it
    builds, with the head padding and without (the decode policy)."""
    from repro_torch.launch.steps import build_model

    out = {}
    for name, over in (("qwen2-1.5b", {}), ("qwen2-1.5b", {"n_heads": 3}),
                       ("deepseek-v2-lite-16b", {})):
        cfg = _cfg(name, **over)
        for pad in (True, False):
            got = build_model(cfg, "cpu", mesh=mesh, pad_heads=pad).cfg
            out[f"{name}{over}-{pad}"] = (got.n_heads, got.hd, got.qkv_fused)
    return out


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
        res = {"serve": serve, "train": train, "exchange": exchange,
               "policy": policy}[kind](meshes[shape], **kwargs)
        if rank != 0:
            res = _scalars(res)
        out.append(res)
    return out


def _scalars(res):
    if isinstance(res, dict):
        return {k: _scalars(v) for k, v in res.items() if not isinstance(v, np.ndarray)}
    if isinstance(res, (list, tuple)):
        return [_scalars(v) for v in res]
    return res
