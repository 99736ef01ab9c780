"""AdamW with dtype-configurable moments and a cosine/linear-warmup schedule.

The twin of ``repro/optim/adamw.py`` on torch tensors: the same gradient
clip, schedule, bias correction, weight decay and moment dtype, with the
update math in float32. Parameters are a tensor or a list of tensors (no
pytrees); the moments mirror them. ``torch.optim.AdamW`` is not used: its
clipping and schedule are not the reference's.

The VQE loop of :mod:`repro_torch.launch.simulate` optimises a handful of
circuit angles, so its parameters and this state live on the CPU.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Sequence, Tuple, Union

import torch

Params = Union[torch.Tensor, Sequence[torch.Tensor]]


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: List[torch.Tensor]
    v: List[torch.Tensor]


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
    ps = _as_list(params)
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32),
        m=[torch.zeros(p.shape, dtype=mdt, device=p.device) for p in ps],
        v=[torch.zeros(p.shape, dtype=mdt, device=p.device) for p in ps],
    )


def global_norm(tensors: Params) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in _as_list(tensors)))


def update(cfg: AdamWConfig, grads: Params, state: AdamWState, params: Params
           ) -> Tuple[Params, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step: ``(new params, new state, {"grad_norm", "lr"})``. The
    new parameters have the form of ``params`` (a tensor or a list)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    mdt = _moment_dtype(cfg)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m32 = b1 * m.to(torch.float32) + (1 - b1) * g
        v32 = b2 * v.to(torch.float32) + (1 - b2) * g * g
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        decay = cfg.weight_decay if p.dim() >= 2 else 0.0
        newp = p.to(torch.float32) * (1 - lr * decay) - lr * delta
        return newp.to(p.dtype), m32.to(mdt), v32.to(mdt)

    out = [upd(p, g, m, v) for p, g, m, v in
           zip(_as_list(params), _as_list(grads), state.m, state.v)]
    new_p = [o[0] for o in out]
    new_state = AdamWState(step=step, m=[o[1] for o in out], v=[o[2] for o in out])
    metrics = {"grad_norm": gnorm, "lr": lr}
    return (new_p[0] if isinstance(params, torch.Tensor) else new_p), new_state, metrics
