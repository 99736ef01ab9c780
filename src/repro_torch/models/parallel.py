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
* **Model axis.** A layer runs tensor parallel when the model axis divides
  its heads, its channels or its padded vocabulary; each rank holds and
  computes only its share (the reference's ``sanitize`` replicates the
  leaf otherwise, and the layer is gathered whole and repeated on every
  rank of the model axis, as for qwen2's 12 heads on 16 ranks):

  - an MLP's ``d_ff`` columns (Megatron, no bias), closed by one
    all-reduce; MoE experts, ``E / ep`` a rank (``moe.moe_slice``), summed
    by one all-reduce, the reference's ``psum``;
  - attention's query heads (GQA, cross-attention, the whisper encoder,
    MLA's up-projections) and the kv heads they read, with ``wo``
    row-parallel; a step's new k/v (and Mamba-2 state) is all-gathered
    over the model axis before it is cached, so caches keep the
    reference's placement, whole over the model axis;
  - Mamba-2's heads of ``ssm_headdim`` channels, its gated norm's sum of
    squares all-reduced over the model axis;
  - the vocabulary: the embedding's rows (a lookup outside a rank's rows
    gives zeros, then one all-reduce), the head's columns, and a
    vocabulary-parallel cross-entropy.

  A leaf whose stored chunk is not the slice its rank computes (a fused
  ``wqkv`` stored as chunks of ``[q | k | v]``, ``wkv`` as ``[k | v]``, a
  replicated bias or Mamba-2 vector, kv heads fewer than the ranks) is
  gathered over the model axis at use and the rank takes its slice
  (:class:`_GatherTake`); its backward sums the ranks' partial gradients
  and keeps the rank's chunk by one reduce-scatter (one all-reduce for a
  replicated leaf).

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


def all_reduce_(x: torch.Tensor, group, size: int, op=dist.ReduceOp.SUM) -> torch.Tensor:
    dist.all_reduce(x, op=op, group=group)
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


def _narrowed(x: torch.Tensor, dim: int, ranges) -> torch.Tensor:
    """The ``ranges`` of ``dim`` joined, in a tensor of their own (no view
    keeps the whole alive)."""
    return torch.cat([x.narrow(dim, lo, hi - lo) for lo, hi in ranges], dim)


class _GatherTake(torch.autograd.Function):
    """Forward: this rank's compute slice of a leaf, ``take = (dim,
    ranges)`` (the ranges of ``dim`` joined), from the leaf stored split on
    ``gdim`` over ``group`` (all-gathered first) or replicated over it
    (``gdim`` None). Backward: the slice's gradient placed in a zero leaf,
    the ranks' partial gradients summed and this rank's stored chunk kept,
    by one reduce-scatter (one all-reduce for a replicated leaf): the ranks
    computed different slices, so no rank's gradient is whole."""

    @staticmethod
    def forward(ctx, x, group, size, gdim, take):
        whole = x if gdim is None else all_gather_cat(x, group, size, gdim)
        ctx.group, ctx.size, ctx.gdim, ctx.take = group, size, gdim, take
        ctx.shape = whole.shape
        return _narrowed(whole, *take)

    @staticmethod
    def backward(ctx, g):
        dim, ranges = ctx.take
        whole = g.new_zeros(ctx.shape)
        at = 0
        for lo, hi in ranges:
            whole.narrow(dim, lo, hi - lo).copy_(g.narrow(dim, at, hi - lo))
            at += hi - lo
        if ctx.gdim is None:
            g = all_reduce_(whole, ctx.group, ctx.size)
        else:
            g = reduce_scatter(whole, ctx.group, ctx.size, ctx.gdim)
        return g, None, None, None, None


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
    """A parameter's local shard and how to make it ready for compute:
    ``steps`` are ``(axis, dim, take)`` in the order they run: gather
    ``dim`` over ``axis`` (``dim`` None: the axis replicates the leaf, and
    only its gradient is averaged, on data axes); on the model axis,
    ``take = (dim, ranges)`` is the slice this rank computes
    (:class:`_GatherTake`). A model-axis shard that is the rank's slice
    has no step: it stays local. Casts and the unbinding of a stacked leaf
    act on the local shard."""

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
        steps = tuple((a, None if d is None else d - 1, t and (t[0] - 1, t[1]))
                      for a, d, t in self.steps)
        if any(d is not None and d < 0 for _, d, _ in steps):
            raise ValueError("a stacked leaf sharded on its reps dim")
        return [Sharded(t, steps, self.plan) for t in torch.unbind(self.local)]

    def full(self) -> torch.Tensor:
        """The leaf as the rank computes with it: whole, or its slice on the
        model axis."""
        x = self.local
        p = self.plan
        for axis, dim, take in self.steps:
            avg = axis in p.data_axes
            if take is not None:
                x = _GatherTake.apply(x, p.groups[axis], p.sizes[axis], dim, take)
            elif dim is None:
                if avg and p.sizes[axis] > 1:
                    x = _AvgGrad.apply(x, p.groups[axis], p.sizes[axis])
            else:
                x = _GatherDim.apply(x, p.groups[axis], p.sizes[axis], p.coord[axis], dim, avg)
        return x


def full(tree):
    """``tree`` with every :class:`Sharded` leaf made ready for compute
    (:meth:`Sharded.full`; the identity on a one-device tree)."""
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


_GQA_LEAVES = ("wq", "bq", "wkv", "bkv", "wqkv", "bqkv", "wo")
_MLA_LEAVES = ("wuq", "wuk", "wuv", "wo")
_SSM_CHANNELS = {"wz": 1, "wx": 1, "conv_x": 1, "w_out": 0, "conv_bx": 0, "norm_w": 0}
_SSM_HEADS = ("dt_bias", "A_log", "D")


class MeshPlan:
    """A model's mesh: the axes (the batch's,
    :func:`~repro_torch.models.sharding.data_axes_for`, and ``"model"``),
    this rank's coordinates and groups, each parameter's placements and how
    it is made ready for compute, which layer families run tensor parallel
    over the model axis, and the row rule for batches. Every rank builds it
    at the same time (it may create process groups)."""

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
        # one flag a layer family, each where the model axis divides what it
        # splits: an MLP's d_ff (and no bias: a replicated d_ff bias would
        # need slicing), the shared experts' columns, the query heads (GQA:
        # and each rank's query heads read whole kv heads of their own or
        # one kv head alone), Mamba-2's heads, the padded vocabulary
        tp, r = self.tp, self.tp_index
        self.mlp_tp = tp > 1 and cfg.d_ff % tp == 0 and not cfg.mlp_bias
        fs = cfg.d_ff_expert * cfg.n_shared_experts
        self.shared_tp = tp > 1 and fs > 0 and fs % tp == 0
        if cfg.n_experts and cfg.n_experts % tp:
            raise ValueError(f"{cfg.n_experts} experts do not split over a model axis of {tp}")
        h, hkv = cfg.n_heads, cfg.n_kv_heads
        heads = tp > 1 and h > 0 and h % tp == 0
        self.mla_tp = heads and cfg.mla
        self.attn_tp = heads and not cfg.mla and hkv > 0 and (hkv % tp == 0 or tp % hkv == 0)
        d_in = cfg.ssm_expand * cfg.d_model
        ssm_heads = d_in // cfg.ssm_headdim
        self.ssm_tp = (tp > 1 and ssm_heads % tp == 0
                       and any(k.startswith("ssm") for k in cfg.layer_kinds()))
        self.vocab_tp = tp > 1 and cfg.padded_vocab % tp == 0
        # this rank's slices: (first, count)
        self._h, self._hkv, self._mla = h, hkv, cfg.mla
        if heads:
            hl = h // tp
            self.q_heads = (r * hl, hl)
            if hkv:
                self.kv_heads = ((r * hl) // (h // hkv), max(hkv // tp, 1))
        if self.ssm_tp:
            nl = ssm_heads // tp
            self.ssm_heads = (r * nl, nl)
            self.ssm_channels = (r * nl * cfg.ssm_headdim, nl * cfg.ssm_headdim)
        if self.vocab_tp:
            vl = cfg.padded_vocab // tp
            self.vocab = (r * vl, vl)
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
    def _take(self, parts: Sequence[str], ndim: int, stacked: bool) -> Optional[Tuple]:
        """The slice of leaf ``parts`` this rank computes on, ``(dim,
        ranges)``, where its layer runs tensor parallel over the model axis;
        None where it computes with the whole leaf (or an MLP's or the
        experts' stored chunk)."""
        leaf, nd = parts[-1], ndim - stacked

        def at(dim, *spans):
            return dim + stacked, tuple((lo, lo + n) for lo, n in spans)

        if leaf == "embed" and self.vocab_tp:
            return at(0, self.vocab)
        if leaf == "lm_head" and self.vocab_tp:
            return at(1, self.vocab)
        if "mixer" not in parts and "cross" not in parts:
            return None
        if self.ssm_tp and leaf in _SSM_CHANNELS:
            return at(_SSM_CHANNELS[leaf], self.ssm_channels)
        if self.ssm_tp and leaf in _SSM_HEADS:
            return at(0, self.ssm_heads)
        if self._mla and "mixer" in parts:
            if self.mla_tp and leaf in _MLA_LEAVES and nd == 3:
                return at(0 if leaf == "wo" else 1, self.q_heads)
            return None
        if not self.attn_tp or leaf not in _GQA_LEAVES or (leaf == "wo" and nd != 3):
            return None
        q, (k0, kl), h, hkv = self.q_heads, self.kv_heads, self._h, self._hkv
        dim = 0 if leaf in ("bq", "bkv", "bqkv", "wo") else 1
        if leaf in ("wq", "bq", "wo"):
            return at(dim, q)
        if leaf in ("wkv", "bkv"):
            return at(dim, (k0, kl), (hkv + k0, kl))
        return at(dim, q, (h + k0, kl), (h + hkv + k0, kl))

    def add(self, name: str, shape: Sequence[int]) -> Tuple:
        """Record parameter ``name``'s placements and compute steps; returns
        the placements."""
        spec = sharding.param_spec(name, tuple(shape), self.sizes, self.data_axes)
        pl = sharding.placements(spec, self.names)
        parts = name.split(".")
        stacked = any(n in ("body", "encoder") for n in parts)
        keep_model = (_expert_leaf(parts, len(shape), stacked)
                      or (_mlp_leaf(parts, len(shape), stacked) and "encoder" not in parts
                          and (self.shared_tp if "shared" in parts else self.mlp_tp)))
        take = self._take(parts, len(shape), stacked)
        # the data axes first (innermost first: a dim split over pod and data
        # is data's chunks within pod's), the model axis last, so the
        # backward's average over the data shards runs on a tensor the model
        # axis has already sliced
        order = [a for a in reversed(self.names) if a in self.data_axes] + \
            [a for a in reversed(self.names) if a not in self.data_axes]
        steps = []
        for axis in order:
            p = pl[self.names.index(axis)]
            dim = p.dim if isinstance(p, Shard) else None
            if axis == self.model_axis and (keep_model or take is not None):
                n = shape[dim] // self.tp if dim is not None else 0
                chunk = (dim, ((self.tp_index * n, (self.tp_index + 1) * n),))
                if keep_model or take == chunk:
                    continue  # the stored chunk is the rank's slice: it stays local
                steps.append((axis, dim, take))
                continue
            steps.append((axis, dim, None))
        self.placements[name] = pl
        self.steps[name] = tuple(steps)
        return pl

    def local_on_model(self, name: str) -> bool:
        """Whether parameter ``name`` computes with the rank's own model-axis
        chunk (no model-axis gather)."""
        pl = self.placements[name][self.names.index(self.model_axis)] \
            if self.model_axis in self.names else Replicate()
        return isinstance(pl, Shard) and all(a != self.model_axis for a, _, _ in self.steps[name])

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

    def max_tp(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max over the model axis (no gradient)."""
        return all_reduce_(x.detach().contiguous().clone(), self.groups[self.model_axis],
                           self.tp, dist.ReduceOp.MAX)

    def gather_tp(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' ``x`` joined on ``dim`` in model-axis order, on every
        rank; the backward takes the rank's own part (what follows is
        computed alike on every rank)."""
        g = self.groups[self.model_axis]
        return _GatherDim.apply(x, g, self.tp, self.tp_index, dim % x.dim(), False)

    def gather_kv(self, x: torch.Tensor) -> torch.Tensor:
        """A step's new k or v, ``[B, s, kv heads of this rank, hd]``, made
        whole over the model axis for the cache (no gradient; ranks that
        share a kv head gave the same one)."""
        whole = all_gather_cat(x, self.groups[self.model_axis], self.tp, 2)
        return whole[:, :, ::self.tp // self._hkv] if self.tp > self._hkv else whole


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
