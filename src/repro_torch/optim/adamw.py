"""AdamW with dtype-configurable moments and a cosine/linear-warmup schedule.

The twin of ``repro/optim/adamw.py`` on torch tensors: the same gradient
clip, schedule, bias correction, weight decay and moment dtype, with the
update math in float32. Parameters are a tensor, a list of tensors, or a
mapping from name to tensor (an LM's parameters, named as
``Model.named_parameters()`` names them: the reference's tree paths joined
by ``.``); the moments mirror them. ``torch.optim.AdamW`` is not used: its
clipping and schedule are not the reference's.

The VQE loop of :mod:`repro_torch.launch.simulate` optimises a handful of
circuit angles (a tensor, on the CPU). LM training passes a mapping: its
update writes each parameter and moment in place, as the reference's
jitted step donates them, a chunk of ``CHUNK`` elements at a time, so a
full-width model's update holds a few chunks of float32 temporaries and
never a second copy of a stacked leaf. The step count stays on the CPU, so
the schedule and bias corrections are host scalars and cost the device no
synchronisation.

On a mesh the parameters are DTensors (``repro_torch.models.sharding``'s
placements), and so are their gradients and moments: the update runs on
each rank's local shards, and the gradient norm counts each element once
(a shard held by several ranks is divided by their number before one
all-reduce over the job).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Mapping, NamedTuple, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..models.parallel import all_reduce_

Params = Union[torch.Tensor, Sequence[torch.Tensor], Mapping[str, torch.Tensor]]
Moments = Union[List[torch.Tensor], Dict[str, torch.Tensor]]

CHUNK = 1 << 26  # elements of one leaf updated at a time (256 MB of float32)


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar, on the CPU
    m: Moments  # a list, or a mapping with the parameters' names
    v: Moments


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    moment_dtype: str = "bfloat16"  # or "float32"


def _moment_dtype(cfg: AdamWConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32


def _as_list(params: Params) -> List[torch.Tensor]:
    return [params] if isinstance(params, torch.Tensor) else list(params)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (float32): linear warmup to ``lr``, then
    a cosine decay to ``min_lr_frac * lr`` at ``total_steps``."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init(cfg: AdamWConfig, params: Params) -> AdamWState:
    mdt = _moment_dtype(cfg)
    if isinstance(params, Mapping):
        def zeros():
            return {k: (torch.zeros_like(p, dtype=mdt) if isinstance(p, DTensor)
                        else torch.zeros(p.shape, dtype=mdt, device=p.device))
                    for k, p in params.items()}
        return AdamWState(step=torch.zeros((), dtype=torch.int32), m=zeros(), v=zeros())
    ps = _as_list(params)
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32),
        m=[torch.zeros(p.shape, dtype=mdt, device=p.device) for p in ps],
        v=[torch.zeros(p.shape, dtype=mdt, device=p.device) for p in ps],
    )


def _local(x: torch.Tensor) -> torch.Tensor:
    return x.to_local() if isinstance(x, DTensor) else x


def _replication(x: torch.Tensor) -> int:
    """How many ranks hold each element of ``x`` (1 for a plain tensor)."""
    if not isinstance(x, DTensor):
        return 1
    n = 1
    for size, p in zip(x.device_mesh.shape, x.placements):
        if not p.is_shard():
            n *= size
    return n


def global_norm(tensors: Params) -> torch.Tensor:
    if isinstance(tensors, Mapping):
        sq = sum(sum(torch.sum(torch.square(c.to(torch.float32))) for c in _chunks(_local(x)))
                 / _replication(x) for x in tensors.values())
        if any(isinstance(x, DTensor) for x in tensors.values()):
            all_reduce_(sq, None, dist.get_world_size())  # the mesh spans the job
        return torch.sqrt(sq)
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in _as_list(tensors)))


def _chunks(x: torch.Tensor, write: bool = False) -> List[torch.Tensor]:
    """``x`` flattened, in pieces of at most ``CHUNK`` elements; views of
    ``x`` itself where ``write`` (which a non-contiguous ``x`` refuses)."""
    return list((x.view(-1) if write else x.reshape(-1)).split(CHUNK))


def update(cfg: AdamWConfig, grads: Params, state: AdamWState, params: Params
           ) -> Tuple[Params, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step: ``(new params, new state, {"grad_norm", "lr"})``. The
    new parameters have the form of ``params`` (a tensor or a list: new
    tensors; a mapping: ``params`` itself and ``state``'s moments, written
    in place, with ``grads`` a mapping of the same names)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    mdt = _moment_dtype(cfg)

    def upd(p, g, m, v, ndim):
        g = g.to(torch.float32) * scale
        m32 = b1 * m.to(torch.float32) + (1 - b1) * g
        v32 = b2 * v.to(torch.float32) + (1 - b2) * g * g
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        decay = cfg.weight_decay if ndim >= 2 else 0.0
        newp = p.to(torch.float32) * (1 - lr * decay) - lr * delta
        return newp.to(p.dtype), m32.to(mdt), v32.to(mdt)

    if isinstance(params, Mapping):
        with torch.no_grad():
            for name, p in params.items():
                g, m, v = grads[name], state.m[name], state.v[name]
                if isinstance(p, DTensor) and not (
                        g.placements == m.placements == v.placements == p.placements):
                    raise ValueError(f"{name}: gradient or moments not on the parameter's "
                                     "placements")
                for pc, gc, mc, vc in zip(_chunks(_local(p), True), _chunks(_local(g)),
                                          _chunks(_local(m), True), _chunks(_local(v), True)):
                    for dst, new in zip((pc, mc, vc), upd(pc, gc, mc, vc, p.dim())):
                        dst.copy_(new)
        return params, AdamWState(step=step, m=state.m, v=state.v), {"grad_norm": gnorm, "lr": lr}

    out = [upd(p, g, m, v, p.dim()) for p, g, m, v in
           zip(_as_list(params), _as_list(grads), state.m, state.v)]
    new_p = [o[0] for o in out]
    new_state = AdamWState(step=step, m=[o[1] for o in out], v=[o[2] for o in out])
    metrics = {"grad_norm": gnorm, "lr": lr}
    return (new_p[0] if isinstance(params, torch.Tensor) else new_p), new_state, metrics
