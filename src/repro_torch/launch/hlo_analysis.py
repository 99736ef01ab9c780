"""Per-device FLOP / byte / collective / memory census + roofline; the port
of ``repro.launch.hlo_analysis``.

The port has no HLO: a step is eager PyTorch, so :class:`Census` (a
``TorchDispatchMode``) counts the aten ops that a step dispatches on this
rank's local tensors, as they run. Per op it accumulates:

* ``flops`` — 2·|result|·K for the matmul-class ops (``mm``, ``bmm``,
  ``addmm``, ``baddbmm``, convolutions, attention: the formulas of
  ``torch.utils.flop_counter``), ×4 for a complex result;
* ``bytes_upper`` — operand plus result bytes of every op that does device
  work. Eager PyTorch fuses nothing, so this tier is what the card reads and
  writes. Ops in :data:`NO_WORK` (views, aliases, ``detach``, metadata and
  bare allocations) and every view op move nothing and are not counted;
* ``bytes`` — the reference's "fused" tier: matmuls, copies,
  gather/scatter/index, sort, cat and convolutions (:data:`FUSED_TIER`),
  and collectives;
* ``ops`` — the count of ops that do device work;
* per-collective ``count``/``bytes``/``traffic``/``moved``: every c10d and
  ``_c10d_functional`` all-gather, all-reduce, reduce-scatter, all-to-all,
  send/recv (the twin of ``collective-permute``) and broadcast. ``bytes`` is
  the result buffer (the reference's count), ``traffic`` is ``bytes`` ×
  :data:`_FACTOR`, and ``moved`` is what one rank moves, ring-wise, as
  ``models/parallel.py`` counts it (an all-gather of b bytes a rank over n
  ranks receives (n - 1) b; an all-reduce of b bytes sends 2 (n - 1) b / n
  and a reduce-scatter of b input bytes (n - 1) b / n);
* memory — every storage off the CPU, live from its creation to its
  release (a weak reference on ``untyped_storage()``): storages that existed
  before the census (first seen as an input) are its ``argument``; the
  ``peak`` of live bytes, ``temp = peak - argument``, ``output`` (storages
  made inside and alive at the end) and ``alias``, the argument bytes
  written in place (the reference's donated buffers).

Only work on tensors off the CPU is counted (a dry run's ``meta`` tensors,
or the card's): a 0-d CPU tensor such as AdamW's step count is the host's.
All numbers are per device, as the reference's are.

What the reference has and the port does not: the HLO text parser
(``parse_hlo``, ``_trip_count``, ``_cond_trips``, ``analyze_hlo``), which
reads XLA's output, which the port never produces; its loop trip-count
correction (eager dispatch sees every iteration of a loop); and its bf16
halving of f32 collectives (the port's collectives move their real dtypes).
"""

from __future__ import annotations

import contextlib
import functools
import weakref
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils.flop_counter import flop_registry
from torch.distributed.tensor import DTensor

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# per-device traffic factor relative to the result buffer size
_FACTOR = {
    "all-gather": 1.0,
    "all-reduce": 2.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}
# c10d's broadcast, which XLA's SPMD programs never emitted: its buffer moves once
_TRAFFIC = dict(_FACTOR, broadcast=1.0)

# aten / c10d op name -> collective kind
_COLLECTIVE_OPS = {
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all", "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
    "broadcast_": "broadcast", "broadcast": "broadcast",
}

# ops that move no bytes: views, aliases, detach, metadata and bare
# allocations (any other op whose schema makes it a view is one too)
NO_WORK = frozenset({
    "view", "_unsafe_view", "view_as", "reshape", "_reshape_alias", "permute", "transpose",
    "t", "expand", "expand_as", "squeeze", "unsqueeze", "select", "slice", "narrow",
    "as_strided", "alias", "detach", "split", "split_with_sizes", "unbind", "chunk",
    "diagonal", "unfold", "view_as_real", "view_as_complex", "movedim", "lift_fresh",
    "_local_scalar_dense", "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
    "is_same_size", "promote_types", "result_type", "empty", "empty_like", "empty_strided",
    "new_empty", "new_empty_strided", "set_", "resize_",
})

# the reference's "fused" tier: what moves HBM bytes even under perfect fusion
FUSED_TIER = frozenset({
    "copy_", "_to_copy", "clone", "index", "index_put_", "_index_put_impl_", "index_select",
    "index_add", "index_add_", "gather", "scatter", "scatter_", "scatter_add", "scatter_add_",
    "scatter_reduce", "embedding", "embedding_dense_backward", "sort", "topk", "cat",
})


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x, out: Optional[List[torch.Tensor]] = None) -> List[torch.Tensor]:
    """The tensors in ``x`` (nested lists, tuples and dicts, as an op's
    arguments and results hold them)."""
    out = [] if out is None else out
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    return out


@functools.lru_cache(maxsize=None)
def _op_info(func) -> Tuple[str, Tuple[int, ...]]:
    """How the census counts ``func``: ``"collective"``, ``"none"`` (no
    device work), ``"flops"`` (a flop formula), ``"fused"`` (the fused byte
    tier) or ``"work"``; and the positions of the arguments it writes."""
    name = func._overloadpacket.__name__
    if func.namespace in ("c10d", "_c10d_functional"):
        kind = "collective" if name in _COLLECTIVE_OPS else "none"  # barrier, wait_tensor
    elif name in NO_WORK or func.is_view:
        kind = "none"
    elif func._overloadpacket in flop_registry:
        kind = "flops"
    elif name in FUSED_TIER or name.startswith("convolution"):
        kind = "fused"
    else:
        kind = "work"
    written = tuple(i for i, a in enumerate(func._schema.arguments)
                    if a.alias_info is not None and a.alias_info.is_write)
    return kind, written


@dataclass
class Tally:
    """One section's counts (see the module docstring)."""

    flops: float = 0.0
    bytes: float = 0.0
    bytes_upper: float = 0.0
    ops: int = 0
    collectives: Dict[str, Dict[str, float]] = field(default_factory=dict)
    dtensor_ops: int = 0  # ops dispatched on DTensors (their local ops are not seen)

    @property
    def coll_traffic(self) -> float:
        return sum(d["traffic"] for d in self.collectives.values())

    @property
    def moved(self) -> int:
        return int(sum(d["moved"] for d in self.collectives.values()))

    def as_dict(self) -> Dict:
        return {"flops": self.flops, "bytes": self.bytes, "bytes_upper": self.bytes_upper,
                "ops": self.ops, "collectives": self.collectives,
                "coll_traffic": self.coll_traffic, "moved": self.moved,
                "dtensor_ops": self.dtensor_ops}


class Census(TorchDispatchMode):
    """``with Census() as c: step(...)``: the counts of the module docstring,
    under the section ``"step"`` unless :meth:`section` (or the module's
    :func:`section`) names another; memory is one timeline over all
    sections."""

    def __init__(self):
        super().__init__()
        self.sections: Dict[str, Tally] = {}
        self._current = "step"
        # a live storage's StorageImpl address -> its entry, and a weak
        # reference whose callback drops both when it is released
        self._seen: Dict[int, List] = {}
        self._refs: Dict[int, weakref.ref] = {}
        self._on = False
        self.argument = self.alias = self.live = self.peak = self.made_live = 0

    # ------------------------------------------------------------ sections
    @property
    def step(self) -> Tally:
        return self.sections.setdefault("step", Tally())

    def __getitem__(self, name: str) -> Tally:
        return self.sections.setdefault(name, Tally())

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator["Census"]:
        prev, self._current = self._current, name
        try:
            yield self
        finally:
            self._current = prev

    # -------------------------------------------------------------- memory
    @property
    def memory(self) -> Dict[str, int]:
        return {"argument": self.argument, "output": self.made_live, "temp": self.peak -
                self.argument, "peak": self.peak, "alias": self.alias}

    def _died(self, key: int, entry: List, _ref) -> None:
        self._seen.pop(key, None)
        self._refs.pop(key, None)
        if self._on:
            self.live -= entry[0]
            if entry[1]:
                self.made_live -= entry[0]

    def _storage(self, t: torch.Tensor, made: bool) -> Optional[List]:
        """The entry ``[bytes, made here, written in place]`` of ``t``'s
        storage, recorded at its first sight (None on the CPU)."""
        if t.device.type == "cpu" or t.layout != torch.strided:
            return None
        st = t.untyped_storage()
        key = st._cdata
        entry = self._seen.get(key)
        if entry is not None and self._refs[key]() is not st:
            # an address reused before the release of the storage that had
            # it was seen: that storage is gone, and this is a new one
            self._died(key, entry, None)
            entry = None
        if entry is None:
            entry = [st.nbytes(), made, False]
            self._seen[key] = entry
            self._refs[key] = weakref.ref(st, functools.partial(self._died, key, entry))
            self.live += entry[0]
            if made:
                self.made_live += entry[0]
            else:  # alive since before the census: at its peak too
                self.argument += entry[0]
                self.peak += entry[0]
        elif st.nbytes() != entry[0]:  # resized in place
            delta = st.nbytes() - entry[0]
            entry[0] += delta
            self.live += delta
            if entry[1]:
                self.made_live += delta
        self.peak = max(self.peak, self.live)
        return entry

    # ------------------------------------------------------------ dispatch
    def __enter__(self):
        self._on = True
        return super().__enter__()

    def __exit__(self, *exc):
        self._on = False
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        tally = self[self._current]
        if any(issubclass(t, DTensor) for t in types):
            tally.dtensor_ops += 1
            return func(*args, **kwargs)
        kind, written = _op_info(func)
        ins = _tensors(kwargs, _tensors(args))
        if written:
            ids = {id(t) for i in written if i < len(args) for t in _tensors(args[i])}
        for t in ins:
            entry = self._storage(t, made=False)
            if written and entry is not None and not entry[1] and not entry[2] and id(t) in ids:
                entry[2] = True
                self.alias += entry[0]
        out = func(*args, **kwargs)
        outs = _tensors(out)
        for t in outs:
            self._storage(t, made=True)
        if kind == "collective":
            self._collective(tally, func, args, kwargs, ins, outs)
        elif kind != "none" and any(t.device.type != "cpu" for t in ins + outs):
            moved = float(sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs))
            tally.ops += 1
            tally.bytes_upper += moved
            if kind == "flops":
                f = float(flop_registry[func._overloadpacket](*args, **kwargs, out_val=out))
                tally.flops += 4 * f if outs and outs[0].is_complex() else f
            if kind in ("flops", "fused"):
                tally.bytes += moved
        return out

    def _collective(self, tally: Tally, func, args, kwargs, ins, outs) -> None:
        kind = _COLLECTIVE_OPS[func._overloadpacket.__name__]
        named = dict(zip((a.name for a in func._schema.arguments), args))
        named.update(kwargs)
        n = _group_size(named)
        src = [t for k in ("input_tensors", "input_tensor", "input", "inputs", "tensors", "self")
               for t in _tensors(named.get(k))]
        dst = [t for k in ("output_tensors", "output_tensor", "output", "out")
               for t in _tensors(named.get(k))] or \
            [t for t in outs if not any(t is s for s in src)] or src
        result = sum(_nbytes(t) for t in dst)
        if kind == "all-gather":
            moved = sum((n - 1) * _nbytes(t) for t in src)
        elif kind == "all-reduce":
            moved = sum(2 * (n - 1) * _nbytes(t) // n for t in src)
        elif kind in ("reduce-scatter", "all-to-all"):
            moved = sum((n - 1) * _nbytes(t) // n for t in src)
        else:
            moved = sum(_nbytes(t) for t in src)
        d = tally.collectives.setdefault(kind, {"count": 0, "bytes": 0.0, "traffic": 0.0,
                                                "moved": 0})
        d["count"] += 1
        d["bytes"] += result
        d["traffic"] += result * _TRAFFIC[kind]
        d["moved"] += moved
        tally.ops += 1
        tally.bytes_upper += 2 * result
        tally.bytes += 2 * result


def _group_size(named: Dict) -> int:
    """The size of a collective's group: c10d ops carry the group (a
    ``ScriptObject``), functional ones its size or its name."""
    from torch._C._distributed_c10d import ProcessGroup
    from torch.distributed.distributed_c10d import _resolve_process_group

    if "group_size" in named:
        return int(named["group_size"])
    if "process_group" in named:
        return ProcessGroup.unbox(named["process_group"]).size()
    return _resolve_process_group(named["group_name"]).size()


@contextlib.contextmanager
def section(name: str) -> Iterator[None]:
    """Count what runs inside under section ``name`` in every active
    :class:`Census` (none active: nothing happens); the step builders mark
    a serving step's weight cast ``"weights"`` with it."""
    with contextlib.ExitStack() as stack:
        for mode in _get_current_dispatch_mode_stack():
            if isinstance(mode, Census):
                stack.enter_context(mode.section(name))
        yield


def collective_stats(census: Census) -> Dict[str, Dict[str, float]]:
    """The step's collectives, kind -> count / bytes / traffic / moved."""
    return census.step.collectives


# --------------------------------------------------------------------------
# Roofline
# --------------------------------------------------------------------------


@dataclass
class HardwareSpec:
    """One NVIDIA H100 SXM at its 700 W limit: NVIDIA's data-sheet peaks,
    dense (no sparsity). ``nvlink_bw`` is NVLink's 450 GB/s each way, and
    the roofline assumes every collective stays within NVLink (the cards of
    one host); a mesh that spans hosts crosses slower links, which this
    spec does not model."""

    name: str = "NVIDIA H100 SXM (data sheet, 700 W)"
    peak_flops: float = 989e12  # bf16 tensor cores
    tf32_flops: float = 495e12  # TF32 tensor cores
    fp32_flops: float = 67e12  # float32 outside the tensor cores
    hbm_bw: float = 3.35e12  # bytes/s
    nvlink_bw: float = 450e9  # bytes/s each way
    hbm_bytes: float = 80e9
    power_limit_w: float = 700.0  # the limit the peaks assume


@dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    coll_bytes: float
    coll_detail: Dict[str, Dict[str, float]]
    t_compute: float
    t_memory: float
    t_collective: float
    dominant: str
    model_flops: float = 0.0
    useful_ratio: float = 0.0
    hbm_bytes_upper: float = 0.0
    peak_bytes: float = 0.0
    fits: bool = True

    def as_dict(self):
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "hbm_bytes_upper": self.hbm_bytes_upper,
            "coll_bytes": self.coll_bytes,
            "coll_detail": self.coll_detail,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "peak_bytes": self.peak_bytes,
            "fits": self.fits,
        }


def roofline_from_census(
    census: Census,
    n_chips: int,
    hw: HardwareSpec = HardwareSpec(),
    model_flops: float = 0.0,
    peak: Optional[float] = None,
) -> Roofline:
    """The step's three-term roofline (compute, HBM at the fused tier,
    collective traffic over NVLink) and whether its peak fits in HBM."""
    a = census.step
    peak = peak or hw.peak_flops
    t_comp = a.flops / peak
    t_mem = a.bytes / hw.hbm_bw
    t_coll = a.coll_traffic / hw.nvlink_bw
    dom = max(
        (("compute", t_comp), ("memory", t_mem), ("collective", t_coll)),
        key=lambda kv: kv[1],
    )[0]
    per_dev_model = model_flops / max(n_chips, 1)
    return Roofline(
        flops=a.flops,
        hbm_bytes=a.bytes,
        hbm_bytes_upper=a.bytes_upper,
        coll_bytes=a.coll_traffic,
        coll_detail=a.collectives,
        t_compute=t_comp,
        t_memory=t_mem,
        t_collective=t_coll,
        dominant=dom,
        model_flops=model_flops,
        useful_ratio=(per_dev_model / a.flops) if a.flops else 0.0,
        peak_bytes=census.peak,
        fits=census.peak <= hw.hbm_bytes,
    )


def model_flops_train(cfg, shape) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE) global FLOPs for one train step."""
    n_active = active_params(cfg)
    tokens = shape.seq_len * shape.global_batch
    return 6.0 * n_active * tokens


def model_flops_serve(cfg, shape) -> float:
    n_active = active_params(cfg)
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # one token per sequence


def active_params(cfg) -> float:
    """Parameters touched per token (MoE counts top-k + shared experts)."""
    d = cfg.d_model
    total = 2 * cfg.padded_vocab * d  # embed + head
    kinds = cfg.layer_kinds()
    for kind in kinds:
        if kind.startswith("ssm"):
            d_in = cfg.ssm_expand * d
            nheads = d_in // cfg.ssm_headdim
            total += 2 * d * d_in + 2 * d * cfg.ssm_state + d * nheads + d_in * d
        elif cfg.mla:
            h = cfg.n_heads
            r = cfg.kv_lora_rank
            qdim = h * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
            total += (cfg.q_lora_rank * qdim + d * cfg.q_lora_rank
                      if cfg.q_lora_rank else d * qdim)
            total += d * r + d * cfg.qk_rope_head_dim
            total += r * h * cfg.qk_nope_head_dim + r * h * cfg.v_head_dim
            total += h * cfg.v_head_dim * d
        else:
            hd = cfg.hd
            total += d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
            total += cfg.n_heads * hd * d
        if "+cross" in kind:
            hd = cfg.hd
            total += 2 * (d * cfg.n_heads * hd + d * cfg.n_kv_heads * hd)
        if "+moe" in kind:
            f = cfg.d_ff_expert
            total += 3 * d * f * (cfg.experts_top_k + cfg.n_shared_experts)
        elif cfg.d_ff:  # dense MLP (incl. jamba's non-MoE layers)
            nfac = 3 if cfg.act == "swiglu" else 2
            total += nfac * d * cfg.d_ff
    return float(total)
