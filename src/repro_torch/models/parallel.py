"""The LM on a mesh of ranks: how a sharded model computes.

The reference declares shardings (``models/sharding.py``) and lets XLA
partition the computation. The port stores each parameter as a DTensor with
the reference's placements (``repro_torch.models.sharding``), so parameters,
gradients, AdamW moments and checkpoints are sharded as the reference's
are, and runs each layer on plain local tensors with explicit collectives:

* **Data (and pod) axes.** Each data shard takes its rows of the batch (all
  rows when the batch does not divide the data axes: the reference's
  ``_wsc`` then replicates the residual stream). A weight sharded over a
  data axis (FSDP) is all-gathered at its use, one layer at a time; in the
  backward pass its gradient is averaged over the data shards and each rank
  keeps its own slice. Each rank's objective is its rows' loss, and the
  mean over the data shards is the reference's.
* **Model axis.** An MLP whose ``d_ff`` the model axis divides runs
  Megatron-style tensor parallel: each rank holds its ``d_ff / tp``
  columns, and one all-reduce sums the partial outputs. MoE experts run
  expert parallel: each rank holds ``E / ep`` experts, runs its share of
  the tokens' assignments (``moe.moe_slice``) and one all-reduce sums the
  shares, the reference's ``psum``. Every other weight sharded over the
  model axis (attention heads, the vocabulary, Mamba-2's channels) is
  gathered at use, and that layer's compute is repeated on each rank of the
  model axis.

Gradient convention: outside a tensor- or expert-parallel region every rank
of a model axis computes the same values and holds the same gradients.
``MeshPlan.enter_tp`` (identity; its backward all-reduces over the model
axis) opens a region and ``MeshPlan.exit_tp`` (all-reduce; identity
backward) closes it. Every collective is an all-gather, an all-reduce or a
reduce-scatter (gloo runs all three on CUDA tensors) and counts its bytes
in :data:`COLLECTIVES`.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from . import sharding

# per kind: [calls, bytes]; bytes are what one rank moves (an all-gather of
# b bytes a rank over n ranks receives (n - 1) b; ring-wise, an all-reduce
# of b bytes sends 2 (n - 1) / n b and a reduce-scatter (n - 1) / n b)
COLLECTIVES: Dict[str, List[int]] = {"all_gather": [0, 0], "all_reduce": [0, 0],
                                     "reduce_scatter": [0, 0]}


def reset_collectives() -> None:
    for v in COLLECTIVES.values():
        v[0] = v[1] = 0


def collective_bytes() -> int:
    return sum(v[1] for v in COLLECTIVES.values())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_gather_cat(x: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    COLLECTIVES["all_gather"][0] += 1
    COLLECTIVES["all_gather"][1] += (size - 1) * _nbytes(x)
    return torch.cat(parts, dim)


def all_reduce_(x: torch.Tensor, group, size: int) -> torch.Tensor:
    dist.all_reduce(x, group=group)
    COLLECTIVES["all_reduce"][0] += 1
    COLLECTIVES["all_reduce"][1] += 2 * (size - 1) * _nbytes(x) // size
    return x


def reduce_scatter(x: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    """The sum of ``x`` over ``group``, this rank's slice of ``dim`` (the
    rank's index in the group picks the slice, as in :func:`all_gather_cat`)."""
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((xs.shape[0] // size,) + tuple(xs.shape[1:]))
    dist.reduce_scatter_tensor(out, xs, group=group)
    COLLECTIVES["reduce_scatter"][0] += 1
    COLLECTIVES["reduce_scatter"][1] += (size - 1) * _nbytes(x) // size
    return out.movedim(0, dim).contiguous()


# ------------------------------------------------------------ autograd ops


class _GatherDim(torch.autograd.Function):
    """Forward: this rank's slice of ``dim`` all-gathered over ``group``.
    Backward: this rank's slice of the gradient, averaged over the group by
    one reduce-scatter (``avg``), or taken as it is (every rank of the group
    computed the same one)."""

    @staticmethod
    def forward(ctx, x, group, size, index, dim, avg):
        ctx.group, ctx.size, ctx.index, ctx.dim, ctx.avg = group, size, index, dim, avg
        return all_gather_cat(x, group, size, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.avg:
            g = reduce_scatter(g, ctx.group, ctx.size, ctx.dim).div_(ctx.size)
        else:
            g = g.chunk(ctx.size, ctx.dim)[ctx.index].contiguous()
        return g, None, None, None, None, None


class _AvgGrad(torch.autograd.Function):
    """Identity; the backward averages the gradient over ``group``."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group, ctx.size).div_(ctx.size), None, None


class _EnterTP(torch.autograd.Function):
    """Identity; the backward sums the ranks' partial gradients."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group, ctx.size), None, None


class _ExitTP(torch.autograd.Function):
    """The ranks' partial results summed; identity backward (what follows is
    computed alike on every rank)."""

    @staticmethod
    def forward(ctx, x, group, size):
        return all_reduce_(x.contiguous().clone(), group, size)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Mean(torch.autograd.Function):
    """The mean over ``group``, forward and backward: each rank's objective
    is its own shard's, and the reference's is their mean."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        return all_reduce_(x.contiguous().clone(), group, size).div_(size)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group, ctx.size).div_(ctx.size), None, None


# ------------------------------------------------------------ sharded leaves


class Sharded:
    """A parameter's local shard and how to make it whole for compute:
    ``steps`` are ``(axis, dim)`` pairs in the order they run: gather
    ``dim`` over ``axis`` (``dim`` None: the axis replicates the leaf, and
    only its gradient is averaged, on data axes). Casts and the unbinding
    of a stacked leaf act on the local shard."""

    def __init__(self, local: torch.Tensor, steps: Tuple, plan: "MeshPlan"):
        self.local, self.steps, self.plan = local, steps, plan

    @property
    def dtype(self):
        return self.local.dtype

    def dim(self) -> int:
        return self.local.dim()

    def to(self, dtype) -> "Sharded":
        return Sharded(self.local.to(dtype), self.steps, self.plan)

    def unbind(self) -> List["Sharded"]:
        steps = tuple((a, None if d is None else d - 1) for a, d in self.steps)
        if any(d is not None and d < 0 for _, d in steps):
            raise ValueError("a stacked leaf sharded on its reps dim")
        return [Sharded(t, steps, self.plan) for t in torch.unbind(self.local)]

    def full(self) -> torch.Tensor:
        x = self.local
        p = self.plan
        for axis, dim in self.steps:
            avg = axis in p.data_axes
            if dim is None:
                if avg and p.sizes[axis] > 1:
                    x = _AvgGrad.apply(x, p.groups[axis], p.sizes[axis])
            else:
                x = _GatherDim.apply(x, p.groups[axis], p.sizes[axis], p.coord[axis], dim, avg)
        return x


def full(tree):
    """``tree`` with every :class:`Sharded` leaf made whole (the identity on
    a one-device tree)."""
    if isinstance(tree, dict):
        return {k: full(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [full(v) for v in tree]
    return tree.full() if isinstance(tree, Sharded) else tree


# ---------------------------------------------------------------- the plan


def _expert_leaf(parts: Sequence[str], ndim: int, stacked: bool) -> bool:
    return "ffn" in parts and parts[-1] in ("wi", "wg", "wo") and ndim - stacked == 3


def _mlp_leaf(parts: Sequence[str], ndim: int, stacked: bool) -> bool:
    return "ffn" in parts and parts[-1] in ("wi", "wg", "wo") and ndim - stacked == 2


class MeshPlan:
    """A model's mesh: the axes (the batch's,
    :func:`~repro_torch.models.sharding.data_axes_for`, and ``"model"``),
    this rank's coordinates and groups, each parameter's placements and how
    it is made whole, and the row rule for batches. Every rank builds it at
    the same time (it may create process groups)."""

    def __init__(self, mesh, cfg):
        self.mesh = mesh
        self.names = tuple(mesh.mesh_dim_names)
        self.sizes = sharding.axis_sizes(mesh)
        self.data_axes = sharding.data_axes_for(self.names)
        self.model_axis = "model"
        coord = mesh.get_coordinate()
        self.coord = dict(zip(self.names, coord))
        self.groups = {a: mesh.get_group(a) for a in self.names}
        self.tp = self.sizes.get(self.model_axis, 1)
        self.tp_index = self.coord.get(self.model_axis, 0)
        self.ndp = 1
        self.dp_index = 0
        for a in self.data_axes:
            self.ndp *= self.sizes[a]
            self.dp_index = self.dp_index * self.sizes[a] + self.coord[a]
        self.dp_group = self._dp_group()
        # an MLP runs tensor parallel when the model axis divides its d_ff
        # (and it has no bias: a replicated d_ff bias would need slicing)
        tp = self.tp
        self.mlp_tp = tp > 1 and cfg.d_ff % tp == 0 and not cfg.mlp_bias
        fs = cfg.d_ff_expert * cfg.n_shared_experts
        self.shared_tp = tp > 1 and fs > 0 and fs % tp == 0
        if cfg.n_experts and cfg.n_experts % tp:
            raise ValueError(f"{cfg.n_experts} experts do not split over a model axis of {tp}")
        self.placements: Dict[str, Tuple] = {}
        self.steps: Dict[str, Tuple] = {}

    def _dp_group(self):
        if len(self.data_axes) == 1:
            return self.groups[self.data_axes[0]]
        # the data axes together: one group per coordinate of the other axes,
        # every rank creating every group in the same order
        ranks = self.mesh.mesh
        others = [a for a in self.names if a not in self.data_axes]
        mine = None
        for idx in itertools.product(*(range(self.sizes[a]) for a in others)):
            sel = [slice(None)] * len(self.names)
            for a, i in zip(others, idx):
                sel[self.names.index(a)] = i
            members = sorted(int(r) for r in ranks[tuple(sel)].flatten())
            g = dist.new_group(members)
            if dist.get_rank() in members:
                mine = g
        return mine

    # ------------------------------------------------------------- params
    def add(self, name: str, shape: Sequence[int]) -> Tuple:
        """Record parameter ``name``'s placements and gather steps; returns
        the placements."""
        spec = sharding.param_spec(name, tuple(shape), self.sizes, self.data_axes)
        pl = sharding.placements(spec, self.names)
        parts = name.split(".")
        stacked = any(n in ("body", "encoder") for n in parts)
        keep_model = (_expert_leaf(parts, len(shape), stacked)
                      or (_mlp_leaf(parts, len(shape), stacked) and "encoder" not in parts
                          and (self.shared_tp if "shared" in parts else self.mlp_tp)))
        # the data axes first (innermost first: a dim split over pod and data
        # is data's chunks within pod's), the model axis last, so the
        # backward's average over the data shards runs on a tensor the model
        # axis has already sliced
        order = [a for a in reversed(self.names) if a in self.data_axes] + \
            [a for a in reversed(self.names) if a not in self.data_axes]
        steps = []
        for axis in order:
            if axis == self.model_axis and keep_model:
                continue
            p = pl[self.names.index(axis)]
            steps.append((axis, p.dim if isinstance(p, Shard) else None))
        self.placements[name] = pl
        self.steps[name] = tuple(steps)
        return pl

    def distribute(self, name: str, full_tensor: torch.Tensor) -> DTensor:
        """``full_tensor`` (the same on every rank) as a DTensor with
        ``name``'s placements: each rank keeps its slice, no collective."""
        return _distribute(full_tensor, self.mesh, self.placements[name])

    def local(self, tree, prefix: str = ""):
        """A tree of DTensor parameters as :class:`Sharded` leaves (their
        local shards, linked to the parameters for autograd); other leaves
        pass through."""
        if isinstance(tree, dict):
            return {k: self.local(v, f"{prefix}{k}.") for k, v in tree.items()}
        if isinstance(tree, list):
            return [self.local(v, f"{prefix}{i}.") for i, v in enumerate(tree)]
        if isinstance(tree, DTensor):
            return Sharded(tree.to_local(), self.steps[prefix[:-1]], self)
        return tree

    # ------------------------------------------------------------ batches
    def batch_sharded(self, b: int) -> bool:
        return self.ndp > 1 and b % self.ndp == 0

    def rows(self, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """This data shard's rows of a global batch (all of them when the
        batch does not divide the data axes)."""
        if x is None or not self.batch_sharded(x.shape[0]):
            return x
        n = x.shape[0] // self.ndp
        return x[self.dp_index * n:(self.dp_index + 1) * n]

    def gather_rows(self, x: torch.Tensor, b: int) -> torch.Tensor:
        """The global batch of ``b`` rows from each shard's (no gradient)."""
        if not self.batch_sharded(b):
            return x
        return all_gather_cat(x, self.dp_group, self.ndp, 0)

    # -------------------------------------------------------- collectives
    def data_mean(self, x: torch.Tensor) -> torch.Tensor:
        if self.ndp == 1:
            return x
        return _Mean.apply(x, self.dp_group, self.ndp)

    def enter_tp(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp == 1:
            return x
        return _EnterTP.apply(x, self.groups[self.model_axis], self.tp)

    def exit_tp(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp == 1:
            return x
        return _ExitTP.apply(x, self.groups[self.model_axis], self.tp)


# ------------------------------------------------------- whole DTensors


def gather_full(t: DTensor) -> torch.Tensor:
    """The whole tensor of a DTensor, on every rank (no gradient): an
    all-gather per sharded mesh axis, innermost first."""
    mesh = t.device_mesh
    names = mesh.mesh_dim_names
    x = t.to_local().detach()
    for i in reversed(range(len(names))):
        p = t.placements[i]
        if isinstance(p, Shard):
            x = all_gather_cat(x, mesh.get_group(names[i]), mesh.shape[i], p.dim)
        elif not isinstance(p, Replicate):
            raise ValueError(f"placement {p} of a stored tensor")
    return x


def _distribute(full_tensor: torch.Tensor, mesh, placements) -> DTensor:
    dt = distribute_tensor(full_tensor, mesh, placements, src_data_rank=None)
    # a slice of its own, not a view keeping the whole tensor alive
    return DTensor.from_local(dt.to_local().clone(), mesh, dt.placements, run_check=False,
                              shape=dt.shape, stride=dt.stride())


def distribute_like(full_tensor: torch.Tensor, like: DTensor) -> DTensor:
    """``full_tensor`` (the same on every rank) placed as ``like`` is: each
    rank keeps its slice, no collective."""
    return _distribute(full_tensor, like.device_mesh, like.placements)
