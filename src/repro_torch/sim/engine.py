"""Execution engine: the planned statevector path on one device, and the
compile cache in front of it.

The twin of ``repro/sim/engine.py`` for the meshless single-device case:

* :class:`ExecutionEngine` owns the compiled program
  (:class:`repro_torch.sim.compile.CompiledCircuit`), the op-tensor
  **constant registry** keyed by the stable ``Op.uid``, the **stage loop**
  (initial remap -> per-stage ops + remap -> optional final remap) and the
  public ``bind`` / ``run`` / ``run_packed`` / ``run_batch`` /
  ``run_sweep`` / ``measurement_frame`` API;
* :class:`CudaBackend` holds the packed ``[2^G, 2^R, 2^L]`` state as one
  flat tensor on the device (index bit ``p`` = physical bit ``p``) and
  applies each stage's ops and each remap to it. A batch of B initial
  states, or a sweep of P bindings, is one flat tensor of ``B * 2^(G+R)``
  (``P * 2^(G+R)``) shards run through the same stage loop: every op is
  one launch for the whole batch;
* :class:`OffloadBackend` keeps the state in host memory as shards of
  ``2^L`` amplitudes and streams every shard through the device once a
  stage, through the same op application (and so the same kernels) as
  :class:`CudaBackend`; remaps are bit permutations on the host;
* :class:`ShardMapBackend` is the explicit-collective path: one
  ``torch.distributed`` rank per device of the bit-mesh runs the stage loop
  on its ``2^L`` shard through the same kernels, and each inter-stage remap
  is the reference's choreography (:class:`RemapPlan`, copied with
  :func:`_build_remap_plan`): a local transpose, one grouped all-to-all,
  one permute of the residual device bits, a local transpose
  (:mod:`repro_torch.sim.collective` moves the bytes);
* :class:`DenseBackend` is the per-gate oracle behind the same API;
* ``value_and_grad`` / ``grad_sweep`` differentiate ``<ψ(θ)|H|ψ(θ)>`` by
  the adjoint reverse sweep (:mod:`repro_torch.sim.adjoint`) over the
  forward state, on the engine's device; on the shardmap backend each rank
  sweeps its own shard back through the plan's stages
  (:class:`~repro_torch.sim.adjoint.ShardedAdjointProgram`);
* :func:`engine_for` is the serving entry point: a structural
  :class:`CircuitKey` -> engine LRU (:class:`CompileCache`) that rebinds a
  cached engine to new angles instead of planning again. With no explicit
  cost model it plans on the device's calibration
  (:func:`repro_torch.sim.profiler.resolve_cost_model`: measured on the
  card by the profiler, or the reference's analytic constants when there
  is none) and records its source in ``provenance["calibration"]``;
* ``run`` / ``run_packed`` / ``run_sweep`` take ``verify=``: the
  reference's post-run norm guard. A norm off by more than 1e-2 or not
  finite gets ONE retry, recorded in ``provenance``; a retry that is
  poisoned too raises :class:`~repro_torch.sim.faults.IntegrityError`.
  Where the reference retries on its dense per-gate oracle, the port
  re-runs the same plan through its own backend and kernels, so a guarded
  run on the card never gives way to the plain per-gate path.

With ``use_kernels`` (the default) every ``fused`` op goes to the
hand-written ``fused_apply`` kernel and every ``shm`` group to
``shm_apply``, one launch each (on the CPU the wrappers run their plain
versions); ``diag``/``scalar`` ops and remaps are plain tensor code. With
``use_kernels=False`` the engine runs the reference's non-kernel path: every
op, and every member of an shm group, as tensor code. Ops update the state
in place; a remap writes one new state, so a run holds at most two states.

The reference's degradation ladder keeps only its planning rungs here
(:func:`_plan_resilient`) and the one retry of a failed ``compile_plan``
(:func:`build_engine`). Its backend rungs (``pjit -> dense``,
``offload -> dense``) and its retry without the kernels are not ported: a
backend or kernel that fails to build raises its typed error
(``XlaTraceError`` from a backend's setup, ``PallasLoweringError`` when the
kernels do not build or load). The fault sites are the reference's, named
as in :mod:`repro_torch.sim.faults`. Not in this module: the reference's
meshed ``PjitBackend`` (GSPMD has no torch twin).
"""

from __future__ import annotations

import hashlib
import math
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field, fields as _dc_fields
from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..core import optimize as copt
from ..core.circuit import Circuit
from ..core.cost_model import CostModel
from ..core.gates import UnboundParameterError
from ..core.partition import SimulationPlan, partition
from ..device import DeviceLike, resolve_device
from ..kernels import ops as kops
from .apply import apply_matrix_bits, mul_bits_, permute_bits
from .compile import (
    CompiledCircuit, Op, RemapSpec, StageProgram, bind_tensors, bind_tensors_sweep, compile_plan,
)
from . import collective, faults, profiler
from .faults import (
    BackendBuildError, FaultError, IntegrityError, KernelizationError, PallasLoweringError,
    StagingError,
)
from .journal import RunJournal, StragglerMonitor
from .shard_store import ShardStore, StorageConfig

if TYPE_CHECKING:
    from .adjoint import AdjointProgram


# ======================================================================
# Shared op application (flat packed state: index bit p = physical bit p)
# ======================================================================


def _dep_index(op: Op, G: int, R: int, L: int) -> Optional[np.ndarray]:
    """Per-shard variant index ``[2^(G+R)]`` of a dep-batched op (shard
    ``s`` = ``g * 2^R + r``, so physical bit ``p >= L`` is bit ``p - L`` of
    ``s``), or None when the op has no dep bits."""
    if not op.dep_bits:
        return None
    s = np.arange(1 << (G + R), dtype=np.int64)
    idx = np.zeros_like(s)
    for j, p in enumerate(op.dep_bits):
        idx |= ((s >> (p - L)) & 1) << j
    return idx.astype(np.int32)


def apply_op(x: torch.Tensor, op: Op, L: int, consts: Dict[int, torch.Tensor],
             vidx_of: Callable[[Op], Optional[torch.Tensor]]) -> torch.Tensor:
    """Non-kernel path: apply one op to the flat state ``x`` in place.
    ``consts[uid]`` is an op's tensor (leading variant axis) and
    ``vidx_of(op)`` its variant index for every shard of ``x``, or None for
    variant 0. An shm group applies its members in order."""
    if op.kind == "shm":
        for m in op.gates:
            apply_op(x, m, L, consts, vidx_of)
        return x
    T, vidx = consts[op.uid], vidx_of(op)
    sel = T[vidx.long()] if vidx is not None else T[:1]  # [S or 1, ...]
    xs = x.view(-1, 1 << L)
    if op.kind == "scalar":
        xs.mul_(sel.reshape(-1, 1))
    elif op.kind == "diag":
        mul_bits_(xs, sel, op.local_bits, lead=1)
    else:
        x.copy_(apply_matrix_bits(xs, sel, op.local_bits, lead=1).view(-1))
    return x


def apply_remap(x: torch.Tensor, spec: RemapSpec, rows: int = 1) -> torch.Tensor:
    """Full bit permutation of each of the ``rows`` states of the flat
    tensor ``x`` (flips first, on the old bits), as one new tensor. A batch
    carries its row axis as one more leading axis of the permutation."""
    if rows == 1:
        return permute_bits(x, spec.src_bit_of, spec.flip_bits)
    return permute_bits(x.view(rows, -1), spec.src_bit_of, spec.flip_bits, lead=1).view(-1)


def to_frame(psi: torch.Tensor, frame) -> torch.Tensor:
    """A logical-order state re-stored in ``frame``'s physical order (what
    ``run_packed`` returns): physical bit ``p`` holds logical qubit
    ``frame.layout[p]``, flipped where ``p`` carries a pending flip."""
    layout = frame.layout
    return permute_bits(psi.reshape(-1), layout, [layout[p] for p in frame.flip_bits])


# ======================================================================
# Explicit-collective remap choreography (shardmap backend)
# ======================================================================


@dataclass
class RemapPlan:
    """Host-precomputed choreography for one inter-stage remap."""

    local_flip_axes: Tuple[int, ...]  # view axes to flip (old local pending flips)
    pre_perm: Tuple[int, ...]  # local transpose before a2a (view axes)
    a2a_axes: Tuple[str, ...]  # mesh axis names (desc bit order), may be empty
    m: int
    ppermute: Optional[Tuple[Tuple[int, int], ...]]  # full-group (src, dst) pairs
    post_flip_axes: Tuple[int, ...]  # chunk axes to flip after a2a (flipped
    # old nonlocal bits that moved into the local tier)
    post_perm: Tuple[int, ...]  # local transpose after a2a (view axes)


def _build_remap_plan(spec: RemapSpec, n: int, L: int,
                      pair_by_target: bool = False) -> RemapPlan:
    """The reference's plan of ``spec``. It pairs the outgoing local bits
    with the incoming device bits in descending order, so a local bit may
    land on another device bit than its target and the residual permute
    moves it. ``pair_by_target`` sends each outgoing local bit straight to
    the device bit that is its target, so only device-to-device moves and
    flips on device bits are left for the permute (the inverse remaps of
    the sharded gradient sweep; the forward keeps the reference's plan)."""
    src = spec.src_bit_of
    flips = set(spec.flip_bits)
    nonlocal_bits = list(range(L, n))

    s_out = sorted({src[p] for p in nonlocal_bits if src[p] < L}, reverse=True)
    s_in = sorted({src[p] for p in range(L) if src[p] >= L}, reverse=True)
    if pair_by_target:  # device bit s_in[t] takes its own target where that is local
        direct = {t: src[s] for t, s in enumerate(s_in) if src[s] < L}
        rest = [b for b in s_out if b not in direct.values()]
        s_out = [direct[t] if t in direct else rest.pop(0) for t in range(len(s_in))]
    m = len(s_out)
    assert len(s_in) == m, "local<->nonlocal exchange must be balanced"

    # --- step A: local flips (old local bits with pending flips)
    local_flip_axes = tuple(L - 1 - s for s in sorted(flips) if s < L)

    # --- step B: pre-transpose: [S_out desc..., remaining local desc...]
    remaining = [b for b in range(L - 1, -1, -1) if b not in s_out]
    pre_order_bits = list(s_out) + remaining  # bit ids, new axis order
    pre_perm = tuple(L - 1 - b for b in pre_order_bits)

    # --- step C/D: after a2a, device bit s_in[t] holds old local bit s_out[t];
    # local chunk bit (m-1-t) holds old nonlocal bit s_in[t].
    holder = {s: s for s in nonlocal_bits if s not in s_in}
    for t in range(m):
        holder[("chunk", t)] = s_in[t]  # local chunk slot t holds old bit s_in[t]
        holder[s_in[t]] = s_out[t]  # device axis s_in[t] now holds old local bit

    # ppermute: new device bit p must hold old bit src[p]
    cur_of = {}  # old bit -> device bit currently holding it
    for s in nonlocal_bits:
        cur_of[holder[s]] = s
    perm_map = {}  # for each device bit position p: source device bit h
    flip_out = set()
    for p in nonlocal_bits:
        h = cur_of[src[p]]
        perm_map[p] = h
        if src[p] in flips and src[p] >= L:
            flip_out.add(p)
    # flips on old nonlocal bits that move INTO the local tier: apply after
    # the a2a, when the bit has become local chunk axis t (free local flip).
    post_flip_axes = tuple(t for t in range(m) if s_in[t] in flips)

    identity = all(perm_map[p] == p for p in nonlocal_bits) and not flip_out
    pairs: Optional[Tuple[Tuple[int, int], ...]] = None
    if not identity:
        nb = n - L
        pair_list = []
        for d in range(1 << nb):
            # device rank d: mesh axes desc bit order => rank bit (p-L) is bit p
            tgt = 0
            for p in nonlocal_bits:
                bit = (d >> (perm_map[p] - L)) & 1
                if p in flip_out:
                    bit ^= 1
                tgt |= bit << (p - L)
            pair_list.append((d, tgt))
        pairs = tuple(pair_list)

    # --- step E: final local transpose
    # current local axes (after a2a, viewed as (2,)*L):
    #   axes 0..m-1   <- old nonlocal bits s_in[0..m-1] (chunk bits desc)
    #   axes m..L-1   <- `remaining` old local bits (desc order)
    cur_axis_of_old_bit = {}
    for t in range(m):
        cur_axis_of_old_bit[s_in[t]] = t
    for j, b in enumerate(remaining):
        cur_axis_of_old_bit[b] = m + j
    post = []
    for i in range(L):  # new view axis i <- new local bit L-1-i
        p = L - 1 - i
        post.append(cur_axis_of_old_bit[src[p]])
    return RemapPlan(
        local_flip_axes=local_flip_axes,
        pre_perm=pre_perm,
        a2a_axes=tuple(f"b{s}" for s in s_in),
        m=m,
        ppermute=pairs,
        post_flip_axes=post_flip_axes,
        post_perm=tuple(post),
    )


def _view_step(perm: Tuple[int, ...], flip_axes: Tuple[int, ...], L: int):
    """A flip of ``(2,)*L`` view axes followed by a transpose, as the
    ``(src_bit_of, flip_bits)`` of :func:`permute_bits` (view axis ``a`` is
    index bit ``L - 1 - a``)."""
    return ([L - 1 - perm[L - 1 - q] for q in range(L)], [L - 1 - a for a in flip_axes])


def remap_pre(x: torch.Tensor, rp: RemapPlan, L: int) -> torch.Tensor:
    """The local step before the exchange: ``rp``'s local flips and
    ``pre_perm`` on the flat ``[2^L]`` shard, as a new ``[2^m, 2^(L-m)]``
    tensor whose rows are the values of the ``m`` outgoing bits."""
    src, flips = _view_step(rp.pre_perm, rp.local_flip_axes, L)
    return permute_bits(x, src, flips).view(1 << rp.m, -1)


def remap_post(x: torch.Tensor, rp: RemapPlan, L: int,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The local step after the exchange: ``post_flip_axes``, then
    ``post_perm``, from the exchanged ``[2^m, 2^(L-m)]`` tensor to the flat
    ``[2^L]`` shard of the new layout (into ``out`` when given)."""
    src, flips = _view_step(rp.post_perm, rp.post_flip_axes, L)
    return permute_bits(x.reshape(-1), src, flips, out=out)


def remap_local(x: torch.Tensor, rp: RemapPlan, L: int) -> torch.Tensor:
    """A remap with nothing to exchange (``m == 0``, no permute): the pre
    and post steps composed into one pass over the shard."""
    pre_src, pre_flips = _view_step(rp.pre_perm, rp.local_flip_axes, L)
    post_src, post_flips = _view_step(rp.post_perm, rp.post_flip_axes, L)
    flips = set(pre_flips) ^ {pre_src[b] for b in post_flips}
    return permute_bits(x, [pre_src[post_src[q]] for q in range(L)], sorted(flips))


def remap_exchange(x: torch.Tensor, rp: RemapPlan, rank: int, L: int, transport,
                   spare: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exchange of rank ``rank``: the grouped all-to-all of the
    pre-step's ``[2^m, 2^(L-m)]`` rows, then the residual permute of the
    whole shard, through ``transport``
    (:class:`repro_torch.sim.collective.Transport`). ``spare`` is a buffer of
    ``x``'s size; each collective writes into whichever of the two does not
    hold its input. Returns ``(result, the other buffer)``."""
    peers, pair = collective.exchange_pattern(rp, rank, L)
    cur = x
    if peers is not None:
        cur, spare = transport.all_to_all(cur, peers, spare.view(cur.shape)), cur
    if pair is not None:
        cur, spare = transport.permute(cur, pair[0], pair[1], spare.view(cur.shape)), cur
    return cur, spare


def batch_columns(psi0s, n: int, lo: int, hi: int) -> torch.Tensor:
    """Amplitudes ``[lo, hi)`` of every row of a batch of initial states:
    ``psi0s`` is a ``[B, 2^n]`` array, or a callable ``rows(lo, hi)`` that
    builds only those columns (``[B, hi - lo]``), so a shardmap rank need
    not hold whole rows on its host."""
    if callable(psi0s):
        return torch.as_tensor(psi0s(lo, hi)).reshape(-1, hi - lo)
    return torch.as_tensor(psi0s).reshape(-1, 1 << n)[:, lo:hi]


def _program_digest(cc: CompiledCircuit) -> np.ndarray:
    """What a compiled program makes a rank do, hashed: its widths, every
    op's kind, bits and variant count (``shm`` members included), every
    stage's layout and every remap's spec. Ranks with different digests
    would issue different collectives."""
    def op(o: Op):
        return (o.kind, tuple(map(int, o.local_bits)), tuple(map(int, o.dep_bits)),
                tuple(o.tensor.shape), tuple(op(m) for m in o.gates))

    def spec(r: Optional[RemapSpec]):
        return None if r is None else (tuple(map(int, r.src_bit_of)),
                                       tuple(map(int, r.flip_bits)))

    sig = (cc.n, cc.L, cc.R, cc.G, spec(cc.initial_remap), spec(cc.final_remap),
           tuple((tuple(op(o) for o in p.ops), tuple(map(int, p.layout)), spec(p.remap_after))
                 for p in cc.programs))
    return np.frombuffer(hashlib.sha256(repr(sig).encode()).digest(), dtype=np.uint8).copy()


def _shm_operands(op: Op, select: Callable):
    """Collect the (local_bits, tensor) operand list for one shm group.

    ``select(member)`` resolves a member op to its per-shard ``[S, ...]``
    tensor. 1-D rows = diagonal member, 2-D = unitary member. Standalone
    scalar members accumulate into a product that folds into the first
    operand so they never cost an extra pass; the product is returned
    unfolded only when the group has no other members."""
    gate_list = []
    scal = None
    for m in op.gates:
        Tsel = select(m)
        if m.kind == "scalar":
            scal = Tsel if scal is None else scal * Tsel
        else:
            gate_list.append((m.local_bits, Tsel))
    if scal is not None and gate_list:
        bits0, mat0 = gate_list[0]
        w = scal.reshape(scal.shape + (1,) * (mat0.dim() - scal.dim()))
        gate_list[0] = (bits0, mat0 * w)
        scal = None
    return gate_list, scal


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _load_kernels() -> None:
    """Build (if needed) and load the hand kernels. A build or load that
    fails (nvcc missing or failing, a library that does not load or
    disagrees with :mod:`repro_torch.kernels.ops`) raises
    :class:`PallasLoweringError`, the taxonomy's "kernel lowering failed",
    chained from the cause."""
    try:
        kops.load()
    except (RuntimeError, OSError, ValueError) as e:
        raise PallasLoweringError(f"the CUDA kernels did not build or load: "
                                  f"{type(e).__name__}: {e}") from e


# ======================================================================
# Backends
# ======================================================================


class Backend:
    """One execution substrate under the engine's stage loop.

    ``prepare`` places a flat logical ``[2^n]`` state (or a ``[B, 2^n]``
    batch) on the engine's device; ``execute`` runs the stage loop over it
    and returns a flat ``[2^n]`` state; ``execute_batch`` returns
    ``[B, 2^n]`` and defaults to one ``execute`` per element."""

    name = "?"
    engine: "ExecutionEngine"
    # False where each process holds only its shard of the state (shardmap)
    holds_whole_state = True

    def setup(self, engine: "ExecutionEngine") -> None:
        self.engine = engine
        if faults._ACTIVE is not None and self.name != "dense":
            faults.maybe_inject("xla_trace_error", site=f"{self.name}.setup")

    def on_rebind(self) -> None:
        """Called after the engine installs a new binding. Anything derived
        from tensor values must be dropped here; nothing structural."""

    def supports_fused_sweep(self) -> bool:
        """True when ``execute_sweep`` runs every binding in one pass; the
        engine rebinds point by point otherwise."""
        return False

    def supports_fused_grad(self) -> bool:
        """True when ``grad_sweep`` runs the reverse sweeps of all its
        bindings at once (``[P, 2^n]`` states, one launch per gate
        application for all P). Backends whose states do not live as one
        device tensor (host offload) report False, and the engine sweeps
        point by point."""
        return False

    def prepare(self, psi0, batch: bool = False) -> torch.Tensor:
        eng = self.engine
        if batch:
            x = batch_columns(psi0, eng.n, 0, 1 << eng.n).to(device=eng.device, dtype=eng.dtype)
            x = x.clone()  # the run updates its state in place
            if x.shape[0] == 0:
                raise ValueError("empty batch")
            return x
        if psi0 is None:
            x = torch.zeros(1 << eng.n, dtype=eng.dtype, device=eng.device)
            x[0] = 1.0
            return x
        x = torch.as_tensor(psi0).to(device=eng.device, dtype=eng.dtype)
        x = x.reshape(-1).clone()
        if x.numel() != 1 << eng.n:
            raise ValueError(f"psi0 has {x.numel()} amplitudes, expected 2^{eng.n}")
        return x

    def execute(self, state: torch.Tensor, apply_final: bool = True) -> torch.Tensor:
        raise NotImplementedError

    def execute_batch(self, states: torch.Tensor, apply_final: bool = True) -> torch.Tensor:
        return torch.stack([self.execute(states[b], apply_final)
                            for b in range(states.shape[0])])

    def extract(self, out: torch.Tensor, batch: bool = False) -> torch.Tensor:
        """An ``execute`` result as the engine returns it: flat ``[2^n]``
        (the rank's ``[2^L]`` on the shardmap backend), or ``[B, 2^n]``
        with ``batch``."""
        return out.reshape(out.shape[0], -1) if batch else out.reshape(-1)

    def finalize(self, packed: torch.Tensor) -> torch.Tensor:
        """The final remap of a ``run_packed`` result (``[2^n]``, or a
        ``[B, 2^n]`` batch of them), as a new tensor."""
        rows = packed.shape[0] if packed.dim() == 2 else 1
        out = apply_remap(packed.reshape(-1), self.engine.cc.final_remap, rows)
        return out.view(packed.shape)

    def norms(self, rows: torch.Tensor) -> torch.Tensor:
        """The 2-norm of each of the ``[P, N]`` output rows (the guard's)."""
        return ExecutionEngine._sq_norms(rows).sqrt()

    def slowest(self, values: Sequence[float]) -> Sequence[float]:
        """Each of ``values`` (this process's times) at its largest over the
        processes that run the engine together: the values themselves on
        one device."""
        return values


@dataclass
class _Pass:
    """What one run of the stage loop reads: ``rows`` states of 2^n
    amplitudes (1, a batch of B, or P sweep points) held as one flat tensor
    of ``rows * S`` shards, the op tables ``consts`` (the engine's
    registry, or a sweep's ``[P * V, ...]`` stacks, point ``p``'s variants
    at rows ``p * V ...``), and the shm operand lists built from them.

    An offload pass holds ONE shard of each row (``rows`` shards of 2^L);
    ``shard_vidx`` then maps every op uid to that shard's variant index
    (int32 ``[rows]``, :meth:`OffloadBackend.resolve`)."""

    rows: int
    consts: Dict[int, torch.Tensor]
    sweep: bool = False
    members: Dict[int, List] = field(default_factory=dict)
    shard_vidx: Optional[Dict[int, torch.Tensor]] = None


class CudaBackend(Backend):
    """The packed state as one flat tensor on one device (CUDA, or the CPU
    when asked for): the single-device twin of the reference's meshless
    ``PjitBackend``. Eager: ops run as they are dispatched. Batches and
    sweeps run every op once over all their shards, as the reference's
    vmapped stage loop does."""

    name = "cuda"

    def setup(self, engine: "ExecutionEngine") -> None:
        super().setup(engine)
        G, R, L = engine.G, engine.R, engine.L
        self.S = 1 << engine.n_nonlocal
        self._dep: Dict[int, Optional[np.ndarray]] = {}
        for prog in engine.cc.programs:
            for op in prog.ops:
                for o in (op,) + op.gates:
                    idx = _dep_index(o, G, R, L)
                    if (idx is not None and o.tensor.size
                            and o.tensor.shape[0] not in (1, 1 << len(o.dep_bits))):
                        raise ValueError(f"op {o.uid}: {o.tensor.shape[0]} variants for "
                                         f"{len(o.dep_bits)} dep bits")
                    self._dep[o.uid] = idx
        # device index tensors, by what they index: structural, kept for good
        self._indices: Dict[tuple, torch.Tensor] = {}
        # shm operands of the engine's registry, until the next bind (a
        # sweep's live in its own pass, and go with it)
        self._members: Dict[int, List] = {}

    def on_rebind(self) -> None:
        self._members.clear()  # operands derived from tensor values

    def supports_fused_sweep(self) -> bool:
        return True

    def supports_fused_grad(self) -> bool:
        return True

    # ------------------------------------------------------------ indices
    def _device_index(self, key: tuple, make: Callable[[], np.ndarray]) -> torch.Tensor:
        t = self._indices.get(key)
        if t is None:
            t = kops.to_device(np.ascontiguousarray(make(), dtype=np.int32), self.engine.device)
            self._indices[key] = t
        return t

    def _variants(self, op: Op, ps: _Pass) -> Optional[np.ndarray]:
        """Host variant index of ``op`` for each distinct operand row of the
        pass: ``[S]``, or None when every shard reads variant 0, for a run
        or a batch (whose states share their operands); ``[P * S]`` for a
        sweep, where point ``p`` reads the rows ``p * V ...`` of the stack."""
        V = ps.consts[op.uid].shape[0] // (ps.rows if ps.sweep else 1)
        dep = self._dep[op.uid] if V > 1 else None
        if not ps.sweep:
            return dep
        v = dep if dep is not None else np.zeros(self.S, dtype=np.int32)
        return (np.arange(ps.rows)[:, None] * V + v[None, :]).reshape(-1)

    def vidx(self, op: Op, ps: Optional[_Pass] = None) -> Optional[torch.Tensor]:
        """Variant index of every shard of the pass (int32 ``[rows * S]``),
        or None when every shard uses variant 0."""
        ps = ps or self.pass_of()
        if ps.shard_vidx is not None:
            return ps.shard_vidx[op.uid]
        v = self._variants(op, ps)
        if v is None:
            return None
        key = ("vidx", op.uid, ps.rows, ps.sweep, ps.consts[op.uid].shape[0])
        return self._device_index(key, lambda: v if ps.sweep else np.tile(v, ps.rows))

    def kernel_vidx(self, op: Op, ps: Optional[_Pass] = None) -> torch.Tensor:
        """Variant index as the fused kernel takes it (int32 ``[rows * S]``)."""
        ps = ps or self.pass_of()
        idx = self.vidx(op, ps)
        if idx is not None:
            return idx
        return self._device_index(("zeros", ps.rows),
                                  lambda: np.zeros(ps.rows * self.S, dtype=np.int32))

    # ---------------------------------------------------------- shm groups
    def pass_of(self, rows: int = 1,
                sweep_consts: Optional[Dict[int, torch.Tensor]] = None) -> _Pass:
        """What a run of ``rows`` states reads: the engine's registry (one
        state, or a batch), or the ``[rows * V, ...]`` tables of a sweep of
        ``rows`` points (:meth:`ExecutionEngine.sweep_tables`)."""
        if sweep_consts is None:
            return _Pass(rows, self.engine.consts, False, self._members)
        return _Pass(rows, sweep_consts, True)

    def shm_members(self, op: Op, ps: Optional[_Pass] = None) -> List:
        """The ``(kind, bits, operand, vidx)`` list the shm kernel takes for
        one group. The operands hold one row per distinct operand row of the
        pass (``S``; ``P * S`` in a sweep) and are kept until the next bind
        (a sweep's in its pass, so they go when the sweep ends); ``vidx`` maps every shard of the
        pass to its row. Scalars fold into the first operand, as in the
        reference."""
        ps = ps or self.pass_of()
        S = self.S if ps.shard_vidx is None else 1
        U = S * (ps.rows if ps.sweep else 1)
        built = ps.members.get(op.uid)
        if built is None:
            def select(m: Op) -> torch.Tensor:
                T = ps.consts[m.uid]
                if ps.shard_vidx is not None:  # one shard: its rows share a variant
                    return T[ps.shard_vidx[m.uid][:U].long()]
                v = self._variants(m, ps)
                if v is None:
                    return T[:1].expand((U,) + tuple(T.shape[1:]))
                key = ("rows", m.uid, ps.rows, ps.sweep, T.shape[0])
                return T[self._device_index(key, lambda: v).long()]

            gate_list, scal = _shm_operands(op, select)
            if not gate_list:  # only scalars: one 0-bit diagonal member
                gate_list = [((), scal.reshape(U, 1))]
            built = [("mat" if T.dim() == 3 else "diag", tuple(bits), T.contiguous())
                     for bits, T in gate_list]
            ps.members[op.uid] = built
        total = ps.rows * S
        rows = self._device_index(("shard_row", U, total),
                                  lambda: np.arange(total) % U)
        return [(kind, bits, T, rows) for kind, bits, T in built]

    # ------------------------------------------------------------ ops
    def apply_ops(self, x: torch.Tensor, prog: StageProgram,
                  ps: Optional[_Pass] = None) -> torch.Tensor:
        eng = self.engine
        ps = ps or self.pass_of()
        L = eng.L
        for op in prog.ops:
            if eng.use_kernels and op.kind == "fused":
                kops.fused_apply(x, ps.consts[op.uid], self.kernel_vidx(op, ps), op.local_bits, L)
            elif eng.use_kernels and op.kind == "shm":
                kops.shm_apply(x, op.local_bits, self.shm_members(op, ps), L)
            else:
                apply_op(x, op, L, ps.consts, lambda o: self.vidx(o, ps))
        return x

    def _loop(self, held: List[torch.Tensor], ps: _Pass, apply_final: bool) -> torch.Tensor:
        """The stage loop over the state in ``held`` (a one-element list
        that this empties): no frame keeps the initial state, so a remap
        frees the state it read and a run holds at most two states."""
        return self.engine.stage_loop(
            held.pop(), lambda v, prog: self.apply_ops(v, prog, ps),
            lambda v, slot, spec: apply_remap(v, spec, ps.rows), apply_final)

    # ------------------------------------------------------------ api
    def execute(self, state: torch.Tensor, apply_final: bool = True) -> torch.Tensor:
        held = [state]
        del state
        return self._loop(held, self.pass_of(), apply_final)

    def execute_batch(self, states: torch.Tensor, apply_final: bool = True) -> torch.Tensor:
        """``states``: ``[B, 2^n]``; every op is one launch for all B."""
        B = states.shape[0]
        held = [states.reshape(-1)]
        del states
        return self._loop(held, self.pass_of(B), apply_final).view(B, -1)

    def execute_sweep(self, state: torch.Tensor, consts: Dict[int, torch.Tensor], P: int,
                      apply_final: bool = True) -> torch.Tensor:
        """One initial state against P bindings: ``consts[uid]`` stacks the
        P points' tables as ``[P * V, ...]``. The state is broadcast to
        ``[P, 2^n]`` and every op is one launch for all P points."""
        held = [state.reshape(1, -1).expand(P, -1).contiguous().view(-1)]
        del state
        return self._loop(held, self.pass_of(P, consts), apply_final).view(P, -1)


def _flat_ops(ops) -> List[Op]:
    """Ops in operand order: shm groups contribute their members."""
    flat: List[Op] = []
    for op in ops:
        flat.extend(op.gates if op.kind == "shm" else (op,))
    return flat


# device shard buffers of one offload run: shard s uploads, s-1 computes and
# s-2 downloads at once, so three is the least that lets every copy engine
# and the SMs work together
COPY_BUFFERS = 3


class _ShardRing:
    """The shard traffic of one offload run between the host state and
    :data:`COPY_BUFFERS` device buffers of ``[rows, 2^L]`` (slot ``s %
    COPY_BUFFERS`` for shard ``s``).

    On CUDA the uploads run on one copy stream, the stage's ops on the
    current (compute) stream and the downloads on a second copy stream,
    ordered by events: a slot uploads only after its previous shard has
    downloaded, computes only after it has uploaded, and downloads only
    after it has computed. So while shard s computes, s+1 uploads and s-1
    downloads, each direction on its own copy engine. Every copy moves one
    contiguous row of pinned host memory. On the CPU each step is a plain
    copy between CPU tensors."""

    def __init__(self, device: torch.device, rows: int, L: int, streams):
        self.bufs = [torch.empty((rows, 1 << L), dtype=torch.complex64, device=device)
                     for _ in range(COPY_BUFFERS)]
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.h2d, self.d2h = streams
            for buf in self.bufs:
                # used on both copy streams: the caching allocator must not
                # hand a buffer out again before their work on it is done
                buf.record_stream(self.h2d)
                buf.record_stream(self.d2h)
            self.uploaded = [torch.cuda.Event() for _ in self.bufs]
            self.computed = [torch.cuda.Event() for _ in self.bufs]
            self.downloaded = [torch.cuda.Event() for _ in self.bufs]

    def upload(self, s: int, host: torch.Tensor) -> torch.Tensor:
        """Shard ``s`` (``host``: its ``[rows, 2^L]`` view of the host
        state) into its slot; returns the slot, ready on the compute stream."""
        i = s % COPY_BUFFERS
        buf = self.bufs[i]
        if not self.cuda:
            buf.copy_(host)
            return buf
        with torch.cuda.stream(self.h2d):
            # a slot's first use waits on an event never recorded: no wait
            self.h2d.wait_event(self.downloaded[i])
            for b in range(host.shape[0]):
                buf[b].copy_(host[b], non_blocking=True)
            self.uploaded[i].record(self.h2d)
        torch.cuda.current_stream(buf.device).wait_event(self.uploaded[i])
        return buf

    def download(self, s: int, host: torch.Tensor) -> None:
        """Shard ``s``'s slot back into ``host`` once the compute stream's
        work on it so far is done."""
        i = s % COPY_BUFFERS
        buf = self.bufs[i]
        if not self.cuda:
            host.copy_(buf)
            return
        self.computed[i].record(torch.cuda.current_stream(buf.device))
        with torch.cuda.stream(self.d2h):
            self.d2h.wait_event(self.computed[i])
            for b in range(host.shape[0]):
                host[b].copy_(buf[b], non_blocking=True)
            self.downloaded[i].record(self.d2h)

    def wait(self, s: int) -> None:
        """Wait (on the host) for shard ``s``'s download."""
        if self.cuda:
            self.downloaded[s % COPY_BUFFERS].synchronize()

    def drain(self) -> None:
        """Wait (on the host) for the last download."""
        if self.cuda:
            self.d2h.synchronize()


@dataclass
class _OffloadRun:
    """What one offload run streams with: ``rows`` states (1, a batch of B,
    or P sweep points), the op tables (the engine's registry, or a sweep's
    ``[P * V, ...]`` stacks), the per-shard variant indices resolved so far
    (``slices``: the backend's own, kept until the next bind, or a sweep's),
    each shard's shm operands, the device ring, and on a shard store the
    :data:`COPY_BUFFERS` host staging blocks of ``[rows, 2^L]`` (pinned on
    CUDA) that shards are decoded into and encoded from."""

    rows: int
    consts: Dict[int, torch.Tensor]
    sweep: bool
    slices: Dict[tuple, torch.Tensor]
    members: Dict[int, Dict[int, List]]
    ring: _ShardRing
    staging: List[torch.Tensor] = field(default_factory=list)


class OffloadBackend(CudaBackend):
    """Host-DRAM streaming path (paper §VII-C): the twin of the reference's
    ``HostOffloadBackend``. The state lives in host memory as ``2^(R+G)``
    shards of ``2^L`` amplitudes per row (``[rows, 2^n]``; pinned when the
    engine's device is CUDA); each stage streams every shard through the
    device once (:class:`_ShardRing`) and runs the stage's ops on it with
    :meth:`CudaBackend.apply_ops`, so ``fused`` ops and ``shm`` groups go
    to the same hand kernels as on the in-card path, one launch per op and
    shard. Remaps are bit permutations of the host state into a second
    host buffer. A batch or a sweep streams ``[B, 2^L]`` (``[P, 2^L]``)
    blocks: one pass over the host covers every row.

    Pinned buffers come from PyTorch's caching host allocator, which pins a
    block of a size once and hands it out again once it is freed: a warm
    run, or a run after a rebind, pins no state buffer as long as the
    caller has let go of the last result (``torch.cuda.host_memory_stats()``
    shows it). A run holds at most two host states. A pin, a kernel build
    or a launch that fails raises; with ``device="cpu"`` the state is an
    ordinary CPU tensor and each copy a CPU copy.

    ``storage`` (a :class:`repro_torch.sim.shard_store.StorageConfig`, a
    spec string like ``"int8:dram_kib=64"`` or a dict) keeps the state at
    rest in a tiered :class:`ShardStore` instead of a host tensor: each
    stage decodes shard s+1 (from DRAM or disk) into a host staging block on
    the store's prefetch worker while shard s computes, and encodes shard
    s-1 once its download has landed; remaps run out of core
    (:meth:`ShardStore.remap`); the run ends with the tolerance check and
    the decoded state gathered into a host tensor. ``checkpoint_dir``
    snapshots the host state after every stage (fsync'd tmp + rename, with
    a :class:`RunJournal`), so a killed run resumes in a fresh engine. The
    two are mutually exclusive. A failed spill raises ``SpillIOError``, a
    bound over the tolerance ``StorageToleranceError``: nothing falls back
    to an exact state."""

    name = "offload"

    def __init__(self, storage=None, checkpoint_dir: Optional[str] = None):
        self.storage: Optional[StorageConfig] = StorageConfig.coerce(storage)
        self.checkpoint_dir = checkpoint_dir
        if self.storage is not None and checkpoint_dir is not None:
            raise ValueError("storage= and checkpoint_dir= are mutually exclusive: the "
                             "shard store is the run's at-rest form, a checkpoint would "
                             "gather it every stage")

    def setup(self, engine: "ExecutionEngine") -> None:
        super().setup(engine)
        self.stats = {
            "shard_transfers": 0,  # shard round trips host -> device -> host
            "host_remaps": 0,
            "tensor_uploads": 0,  # ops whose table a run read since the last bind
            "tensor_slice_reuse": 0,  # per-shard variant indices served from the memo
            "overlapped_dispatches": 0,  # shard s+1 dispatched before s is waited on
            "stage_streams": 0,  # streamed stages (one drain each)
            "memory_passes": 0,  # device passes (top-level ops)
            "checkpointed_stages": 0,  # stage snapshots written (checkpoint_dir)
            "resumed_stages": 0,  # stages skipped on the last resume
            "straggler_stages": 0,  # stages flagged by the EWMA monitor
        }
        self._uploaded: set = set()
        # (op uid, variant, rows) -> device int32 [rows] variant index of a
        # shard; and shard -> {group uid: shm operands}. Operands hold tensor
        # values, so both go at the next bind.
        self._dev_slices: Dict[tuple, torch.Tensor] = {}
        self._shard_members: Dict[int, Dict[int, List]] = {}
        self._streams = ((torch.cuda.Stream(engine.device), torch.cuda.Stream(engine.device))
                         if engine.device.type == "cuda" else None)
        # what the last run did, in order: each streamed stage, host remap
        # and checkpoint with its wall seconds (the CLI and chip_smoke.py
        # print it); on a store, each stage and remap also carries the
        # store's codec and disk seconds and bytes spent in it
        self.trace: List[Dict] = []

    def on_rebind(self) -> None:
        super().on_rebind()
        self._uploaded.clear()
        self._dev_slices.clear()
        self._shard_members.clear()

    def supports_fused_grad(self) -> bool:
        # the state streams from host memory: a [P, 2^n] batch of gradient
        # sweeps would need P whole states on the device at once
        return False

    # ------------------------------------------------------------ shards
    def _host(self, shape) -> torch.Tensor:
        return torch.empty(shape, dtype=self.engine.dtype,
                           pin_memory=self.engine.device.type == "cuda")

    def new_run(self, rows: int, sweep_consts: Optional[Dict[int, torch.Tensor]] = None
                ) -> _OffloadRun:
        """The context of one run of ``rows`` states (a sweep of ``rows``
        points when ``sweep_consts`` is given), with its device ring."""
        ring = _ShardRing(self.engine.device, rows, self.engine.L, self._streams)
        if sweep_consts is None:
            return _OffloadRun(rows, self.engine.consts, False, self._dev_slices,
                               self._shard_members, ring)
        return _OffloadRun(rows, sweep_consts, True, {}, {}, ring)

    def resolve(self, op: Op, s: int, run: _OffloadRun) -> torch.Tensor:
        """Variant index of flat op ``op`` for shard ``s``: int32 ``[rows]``
        on the device (the shard's dep-bit variant, at ``p * V + v`` for
        sweep point ``p``). Memoised by ``(uid, variant, rows)``, as the
        reference memoises its per-shard tensor slices; the tables stay one
        upload per op in the engine's registry."""
        T = run.consts[op.uid]
        V = T.shape[0] // (run.rows if run.sweep else 1)
        dep = self._dep[op.uid]
        v = int(dep[s]) if dep is not None and V > 1 else 0
        if not run.sweep and op.uid not in self._uploaded:
            self._uploaded.add(op.uid)
            self.stats["tensor_uploads"] += 1
        key = (op.uid, v, run.rows)
        idx = run.slices.get(key)
        if idx is None:
            vals = np.arange(run.rows) * V + v if run.sweep else np.full(run.rows, v)
            idx = kops.to_device(vals.astype(np.int32), self.engine.device)
            run.slices[key] = idx
        else:
            self.stats["tensor_slice_reuse"] += 1
        return idx

    def shard_pass(self, s: int, ops: List[Op], run: _OffloadRun) -> _Pass:
        """The pass :meth:`apply_ops` runs ``ops`` with on shard ``s`` of
        every row."""
        shard_vidx = {op.uid: self.resolve(op, s, run) for op in _flat_ops(ops)}
        return _Pass(run.rows, run.consts, run.sweep, run.members.setdefault(s, {}), shard_vidx)

    def _begin_stage(self, prog: StageProgram) -> float:
        if faults._ACTIVE is not None:
            faults.maybe_inject("slow_stage", site="offload.stage")
        self.stats["memory_passes"] += prog.n_passes
        self.stats["stage_streams"] += 1
        return time.perf_counter()

    def _end_stage(self, prog: StageProgram, t0: float, nbytes: int, **extra) -> None:
        dt = time.perf_counter() - t0
        self.engine._record_time("offload_stage", dt * 1e6)
        self.trace.append(dict({"kind": "stage", "ops": prog.n_passes, "seconds": dt,
                                "bytes": nbytes}, **extra))

    @staticmethod
    def _shard_fault(s: int) -> None:
        if faults._ACTIVE is not None:
            faults.maybe_inject("shard_transfer_error", site=f"offload.shard{s}")

    def stream_stage(self, state, prog: StageProgram, run: _OffloadRun):
        """Stream every shard of the host state ``[rows, 2^n]`` (or of a
        :class:`ShardStore`) through the device once, running ``prog``'s
        ops on it; updates the state in place and returns it."""
        if isinstance(state, ShardStore):
            return self._stream_stage_store(state, prog, run)
        L = self.engine.L
        t0 = self._begin_stage(prog)
        try:
            for s in range(self.S):
                self._shard_fault(s)
                host = state[:, s << L:(s + 1) << L]
                ps = self.shard_pass(s, prog.ops, run)
                buf = run.ring.upload(s, host)
                self.apply_ops(buf.view(-1), prog, ps)
                run.ring.download(s, host)
                if s:  # dispatched while shard s-1 is still in flight
                    self.stats["overlapped_dispatches"] += 1
                self.stats["shard_transfers"] += 1
        finally:
            run.ring.drain()
        self._end_stage(prog, t0, 2 * state.numel() * state.element_size())
        return state

    def _stream_stage_store(self, store: ShardStore, prog: StageProgram, run: _OffloadRun
                            ) -> ShardStore:
        """The same loop over a tiered :class:`ShardStore`, in the store's
        :meth:`ShardStore.stream_order` (resident shards first: the least
        disk traffic under its LRU budget). The i-th shard goes through host
        staging block ``i % COPY_BUFFERS``: decoded into it (by the store's
        prefetch worker while shard i-1 computes), uploaded from it,
        downloaded back into it, and encoded into the store once that
        download has landed, while shard i+1 computes. A block is decoded
        into again only after its previous shard was encoded."""
        L = self.engine.L
        t0 = self._begin_stage(prog)
        timing0 = dict(store.timing)
        if not run.staging:
            run.staging = [self._host((run.rows, 1 << L)) for _ in range(COPY_BUFFERS)]
        shape = store.lead_shape + (1 << L,)

        def block(i: int) -> torch.Tensor:
            return run.staging[i % COPY_BUFFERS].view(shape)

        order = store.stream_order()
        S = len(order)
        fetch = store.prefetch(order[0], block(0))
        try:
            for i, s in enumerate(order):
                self._shard_fault(s)
                if fetch is not None:
                    fetch.result()
                else:
                    store.get_decoded(s, block(i))
                host = run.staging[i % COPY_BUFFERS]
                ps = self.shard_pass(s, prog.ops, run)
                buf = run.ring.upload(i, host)
                self.apply_ops(buf.view(-1), prog, ps)
                run.ring.download(i, host)
                # block i+1 held shard i-2, encoded in the last iteration
                fetch = store.prefetch(order[i + 1], block(i + 1)) if i + 1 < S else None
                if i:  # shard i-1 is encoded while i computes and i+1 decodes
                    run.ring.wait(i - 1)
                    store.put(order[i - 1], block(i - 1))
                    self.stats["overlapped_dispatches"] += 1
                self.stats["shard_transfers"] += 1
            run.ring.drain()
            store.put(order[-1], block(S - 1))
        finally:
            run.ring.drain()
        self._end_stage(prog, t0, 2 * store.total_amps * store.dtype.itemsize,
                        store={k: v - timing0[k] for k, v in store.timing.items()})
        return store

    def host_remap(self, state, slot, spec: RemapSpec):
        """The bit permutation ``spec`` of every row of the host state, into
        a new host buffer; or of a :class:`ShardStore`, out of core."""
        t0 = time.perf_counter()
        extra = {}
        if isinstance(state, ShardStore):
            timing0 = dict(state.timing)
            out = state.remap(spec, self.engine.n)
            extra["store"] = {k: v - timing0[k] for k, v in state.timing.items()}
        else:
            out = permute_bits(state, spec.src_bit_of, spec.flip_bits, lead=1,
                               out=self._host(state.shape))
        self.stats["host_remaps"] += 1
        dt = time.perf_counter() - t0
        self.engine._record_time("offload_remap", dt * 1e6)
        self.trace.append(dict({"kind": "remap", "slot": slot, "seconds": dt}, **extra))
        return out

    @property
    def overlap_ratio(self) -> float:
        """Share of the dispatches that could overlap their predecessor (all
        but the first shard of each stage) that did; a vacuous 1.0 when no
        stage has more than one shard."""
        possible = self.stats["shard_transfers"] - self.stats["stage_streams"]
        if possible <= 0:
            return 1.0
        return self.stats["overlapped_dispatches"] / possible

    # ------------------------------------------------------------ api
    def prepare(self, psi0, batch: bool = False):
        """The host state ``[rows, 2^n]``: a batch, the given state, or
        |0..0>; with ``storage``, a :class:`ShardStore` filled with it."""
        eng = self.engine
        src = None
        if batch:
            src = batch_columns(psi0, eng.n, 0, 1 << eng.n).to(dtype=eng.dtype)
            if src.shape[0] == 0:
                raise ValueError("empty batch")
        elif psi0 is not None:
            src = torch.as_tensor(psi0).to(dtype=eng.dtype).reshape(1, -1)
            if src.shape[1] != 1 << eng.n:
                raise ValueError(f"psi0 has {src.shape[1]} amplitudes, expected 2^{eng.n}")
        rows = 1 if src is None else src.shape[0]
        if self.storage is not None:
            lead = (rows,) if batch else ()  # the reference's store layout
            store = ShardStore(self.S, 1 << eng.L, lead, eng.dtype, self.storage)
            try:
                return store.fill(None if src is None else src.view(lead + (-1,)))
            except BaseException:
                store.close()
                raise
        x = self._host((rows, 1 << eng.n))
        if src is None:
            x.zero_()
            x[0, 0] = 1.0
        else:
            x.copy_(src)
        return x

    def _run(self, held: List[torch.Tensor], run: _OffloadRun, apply_final: bool
             ) -> torch.Tensor:
        """The stage loop over the host state in ``held`` (a one-element
        list that this empties, so a remap frees the state it read)."""
        self.trace = []
        return self.engine.stage_loop(
            held.pop(), lambda st, prog: self.stream_stage(st, prog, run),
            self.host_remap, apply_final)

    def _execute(self, held: List, run: _OffloadRun, apply_final: bool, shape: Tuple
                 ) -> torch.Tensor:
        """One run over the state in ``held`` (a host tensor or a store; the
        list is emptied): through the store, the checkpoints, or plainly.
        ``shape``: the run's logical state shape (its identity for a
        checkpoint)."""
        if isinstance(held[0], ShardStore):
            return self._execute_store(held.pop(), run, apply_final)
        if self.checkpoint_dir is not None:
            return self._execute_checkpointed(held, run, apply_final, shape)
        return self._run(held, run, apply_final)

    def execute(self, state, apply_final: bool = True) -> torch.Tensor:
        held = [state]
        del state
        return self._execute(held, self.new_run(1), apply_final, (1 << self.engine.n,)).view(-1)

    def execute_batch(self, states, apply_final: bool = True) -> torch.Tensor:
        """``states``: ``[B, 2^n]`` on the host (or a store of B rows);
        every shard moves as one ``[B, 2^L]`` block and every op is one
        launch per shard for all B."""
        rows = states.lead_shape[0] if isinstance(states, ShardStore) else states.shape[0]
        held = [states]
        del states
        return self._execute(held, self.new_run(rows), apply_final, (rows, 1 << self.engine.n))

    def execute_sweep(self, state, consts: Dict[int, torch.Tensor], P: int,
                      apply_final: bool = True) -> torch.Tensor:
        """One initial state against P bindings (``consts[uid]``: the
        ``[P * V, ...]`` stacks): the state is tiled to ``[P, 2^n]`` on the
        host (a store to a store of P rows, :meth:`ShardStore.tile`) and
        every op is one launch per shard for all P points. Not
        checkpointed."""
        run = self.new_run(P, consts)
        if isinstance(state, ShardStore):
            try:
                states = state.tile(P)
            finally:
                state.close()
            return self._execute_store(states, run, apply_final)
        states = self._host((P, state.shape[-1]))
        states.copy_(state.reshape(1, -1).expand(P, -1))
        held = [states]
        del state, states
        return self._run(held, run, apply_final)

    # ------------------------------------------------------------ the store
    def _execute_store(self, store: ShardStore, run: _OffloadRun, apply_final: bool
                       ) -> torch.Tensor:
        """The stage loop over a tiered :class:`ShardStore`, then the
        storage contract: reject the run if the accumulated quantization
        error bound exceeds the tolerance (typed ``StorageToleranceError``,
        never a silently less accurate result), record the store's summary
        in ``engine.provenance["storage"]``, and gather the decoded state
        into a host tensor ``[rows, 2^n]``. The store is closed (its spill
        files removed) however the run ends."""
        try:
            store = self._run([store], run, apply_final)
            store.check_tolerance()
            self.engine.provenance["storage"] = store.snapshot()
            t0 = time.perf_counter()
            out = store.gather(self._host(store.lead_shape + (store.n_shards * store.shard_len,)))
            self.trace.append({"kind": "gather", "seconds": time.perf_counter() - t0})
            return out
        finally:
            store.close()

    def storage_snapshot(self) -> Optional[Dict]:
        """The last store run's summary (None when the store is off or no
        run has completed): what serving statistics read."""
        return self.engine.provenance.get("storage")

    # ------------------------------------------------------ stage checkpoints
    def _run_sig(self, state: torch.Tensor, shape: Tuple) -> str:
        """Identity of one run: structure + binding + (n, L, R, G, dtype,
        logical shape) + the initial state's bytes. A journal written under
        another signature is ignored (never resumed into the wrong run)."""
        eng = self.engine
        h = hashlib.sha256()
        h.update(repr(eng.circuit.structure_fingerprint()).encode())
        h.update(repr(eng.bound_circuit.binding_signature()).encode())
        # the shape is part of the identity: a [B, 2^n] batch and a flat
        # state of the same bytes must never resume into each other
        h.update(repr((eng.n, eng.L, eng.R, eng.G, str(eng.np_dtype), tuple(shape))).encode())
        h.update(state.contiguous().numpy().view(np.uint8))
        return h.hexdigest()

    @staticmethod
    def _save_state(path: str, state: torch.Tensor) -> None:
        """Write the host state to ``path`` durably: a temporary file,
        fsync, then rename."""
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.save(f, state.numpy())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def _execute_checkpointed(self, held: List[torch.Tensor], run: _OffloadRun,
                              apply_final: bool, shape: Tuple) -> torch.Tensor:
        """The stage loop with durability: after each completed stage unit
        (ops + the remap after them) the host state is saved
        (:meth:`_save_state`) and the :class:`RunJournal` records the stage
        index; per-stage wall times feed a :class:`StragglerMonitor`. On
        entry, a journal whose run signature matches resumes after its last
        completed stage. A completed run deletes its checkpoint, so stale
        state never leaks into a later run."""
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        state = held.pop()
        sig = self._run_sig(state, shape)
        jpath = os.path.join(self.checkpoint_dir, "journal.json")
        spath = os.path.join(self.checkpoint_dir, "state.npy")
        journal = RunJournal(jpath)
        rec = journal.read()
        start = 0
        self.trace = []
        if (rec.get("run_sig") == sig and rec.get("last_step", -1) >= 0
                and os.path.exists(spath)):
            t0 = time.perf_counter()
            state.copy_(torch.from_numpy(np.load(spath)).view(state.shape))
            start = int(rec["last_step"]) + 1
            journal.mark_restart()
            self.stats["resumed_stages"] = start
            self.trace.append({"kind": "resume", "stage": start,
                               "seconds": time.perf_counter() - t0})
        monitor = StragglerMonitor()
        began = [0.0]

        def ops(st, prog):
            began[0] = time.monotonic()
            return self.stream_stage(st, prog, run)

        def save(i, st):
            if monitor.record(i, time.monotonic() - began[0]):
                self.stats["straggler_stages"] += 1
            t1 = time.perf_counter()
            self._save_state(spath, st)
            journal.update(i, run_sig=sig)
            self.stats["checkpointed_stages"] += 1
            self.trace.append({"kind": "checkpoint", "stage": i,
                               "seconds": time.perf_counter() - t1,
                               "bytes": st.numel() * st.element_size()})

        held.append(state)
        del state  # the loop's frame holds the state alone, so a remap frees it
        state = self.engine.stage_loop(held.pop(), ops, self.host_remap, apply_final,
                                       start=start, after_stage=save)
        for p in (jpath, spath):  # completed: drop the checkpoint
            if os.path.exists(p):
                os.remove(p)
        return state


class DenseBackend(Backend):
    """Per-gate dense oracle behind the engine API, on the engine's device.

    Deliberately a different algorithm: it ignores the compiled program and
    applies the currently bound circuit's gates one by one
    (:func:`repro_torch.sim.statevector.simulate`), so an engine-vs-dense
    comparison checks the whole compile + bind + execute pipeline. With
    ``apply_final=False`` it re-stores the state in the compiled frame's
    physical order, comparable to the planned backends' ``run_packed``.
    Chosen by name only: it is never a fallback."""

    name = "dense"

    def execute(self, state: torch.Tensor, apply_final: bool = True) -> torch.Tensor:
        return self.engine.dense_reference(psi0=state, apply_final=apply_final)


class ShardMapBackend(CudaBackend):
    """The explicit-collective path: the twin of the reference's
    ``ShardMapBackend``, one ``torch.distributed`` rank per device of the
    bit-mesh. Rank ``d`` holds shard ``d``, the ``2^L`` amplitudes whose
    device bits (physical bits ``p >= L``, bit ``p - L`` of ``d``) spell
    ``d``, on the engine's device, and runs the stage loop on it: ``fused``
    ops and ``shm`` groups through the hand kernels (:meth:`CudaBackend.apply_ops`
    on one shard, a dep-batched op reading the variant its rank's bits
    select), ``diag``/``scalar`` ops as tensor code. Each inter-stage remap
    is the reference's choreography (:func:`remap_pre`, :func:`remap_exchange`,
    :func:`remap_post`): a local transpose, one grouped all-to-all, one
    permute, a local transpose; the rank holds two shard buffers.

    ``group``: the process group of the bit-mesh (the default group when
    None); its size must be ``2^(R+G)``, and every rank must have compiled
    the same program (checked at setup, before any other collective: a rank
    that planned otherwise would issue other collectives and hang or
    corrupt the state; inside :func:`~repro_torch.sim.collective.agreement_by_caller`
    the caller checks it instead). ``run``, ``run_packed`` and
    ``finalize`` return the rank's shard. Every rank of the group makes the
    same calls in the same order. Batches run one element at a time, as in
    the reference; there is no fused sweep, and gradients run one binding at
    a time (:class:`~repro_torch.sim.adjoint.ShardedAdjointProgram`).
    ``trace`` holds the last run's remaps, then those of a gradient sweep
    after it: slot, ``m``, whether a permute ran, the bytes this rank sent,
    and seconds; ``totals`` counts every run and remap since the setup
    (``runs``, ``remaps``, ``bytes_sent``, ``seconds``)."""

    name = "shardmap"
    holds_whole_state = False

    def __init__(self, group=None):
        self.group = group

    def setup(self, engine: "ExecutionEngine") -> None:
        super().setup(engine)
        n, L, nb = engine.n, engine.L, engine.n_nonlocal
        if not (dist.is_available() and dist.is_initialized()):
            raise BackendBuildError("the shardmap backend needs an initialised torch.distributed "
                                    "process group, one rank per device of the bit-mesh")
        try:
            self.transport = collective.Transport(self.group, engine.device)
        except ValueError as e:
            raise BackendBuildError(str(e)) from e
        self.rank = self.transport.rank
        if not collective.caller_agrees():
            collective.agree_build(self.transport, _program_digest(engine.cc))
        world = self.transport.world
        if world != 1 << nb:
            raise BackendBuildError(f"the shardmap bit-mesh needs {1 << nb} ranks (2^(R+G)), "
                                    f"the process group has {world}")
        cc = engine.cc
        self._plans: Dict = {}
        if cc.initial_remap is not None:
            self._plans["init"] = _build_remap_plan(cc.initial_remap, n, L)
        for i, prog in enumerate(cc.programs):
            if prog.remap_after is not None:
                self._plans[i] = _build_remap_plan(prog.remap_after, n, L)
        if cc.final_remap is not None:
            self._plans["final"] = _build_remap_plan(cc.final_remap, n, L)
        # the variant each op reads on this rank's shard (structural: a
        # rebind keeps every table's variant count)
        self._shard_vidx = {}
        for uid, T in engine.consts.items():
            dep = self._dep.get(uid)
            v = int(dep[self.rank]) if dep is not None and T.shape[0] > 1 else 0
            self._shard_vidx[uid] = kops.to_device(np.array([v], dtype=np.int32), engine.device)
        self.trace: List[Dict] = []
        self.totals = {"runs": 0, "remaps": 0, "bytes_sent": 0, "seconds": 0.0}

    def supports_fused_sweep(self) -> bool:
        return False

    def supports_fused_grad(self) -> bool:
        return False

    def _shard(self, psi: torch.Tensor) -> torch.Tensor:
        """This rank's ``2^L`` slice of the last axis of ``psi``, a new
        contiguous tensor on the engine's device."""
        eng = self.engine
        lo = self.rank << eng.L
        return psi[..., lo:lo + (1 << eng.L)].to(
            device=eng.device, dtype=eng.dtype, copy=True).contiguous()

    def prepare(self, psi0, batch: bool = False) -> torch.Tensor:
        """This rank's shard of the logical initial state(s): ``|0…0⟩`` puts
        1 on rank 0 only; a ``[2^n]`` ``psi0`` (or a ``[B, 2^n]`` batch)
        gives each rank its amplitudes ``[d·2^L, (d+1)·2^L)``. A batch may
        be a callable ``rows(lo, hi)`` (:func:`batch_columns`): the rank
        then builds only its own ``[B, 2^L]`` columns."""
        eng = self.engine
        if batch:
            lo = self.rank << eng.L
            x = batch_columns(psi0, eng.n, lo, lo + (1 << eng.L)).to(
                device=eng.device, dtype=eng.dtype, copy=True).contiguous()
            if x.shape[0] == 0:
                raise ValueError("empty batch")
            return x
        if psi0 is None:
            x = torch.zeros(1 << eng.L, dtype=eng.dtype, device=eng.device)
            if self.rank == 0:
                x[0] = 1.0
            return x
        psi = torch.as_tensor(psi0).reshape(-1)
        if psi.numel() != 1 << eng.n:
            raise ValueError(f"psi0 has {psi.numel()} amplitudes, expected 2^{eng.n}")
        return self._shard(psi)

    def remap(self, x: torch.Tensor, slot, reuse: bool = False,
              rp: Optional[RemapPlan] = None) -> torch.Tensor:
        """Remap ``slot``'s choreography (or ``rp``'s, recorded under
        ``slot``) on this rank's shard ``x``; with ``reuse`` the exchange may
        overwrite ``x``."""
        rp = self._plans[slot] if rp is None else rp
        L, dev = self.engine.L, self.engine.device
        _sync(dev)
        t0 = time.perf_counter()
        sent = collective.COLLECTIVE_CALLS["bytes_sent"]
        if rp.m == 0 and rp.ppermute is None:
            out = remap_local(x, rp, L)
        else:
            pre = remap_pre(x, rp, L)
            cur, spare = remap_exchange(pre, rp, self.rank, L, self.transport,
                                        x if reuse else torch.empty_like(x))
            out = remap_post(cur, rp, L, out=spare.view(-1))
        _sync(dev)
        t = {"slot": slot, "m": rp.m, "permute": rp.ppermute is not None,
             "bytes_sent": collective.COLLECTIVE_CALLS["bytes_sent"] - sent,
             "seconds": time.perf_counter() - t0}
        self.trace.append(t)
        self.totals["remaps"] += 1
        self.totals["bytes_sent"] += t["bytes_sent"]
        self.totals["seconds"] += t["seconds"]
        return out

    def pass_of(self, rows: int = 1,
                sweep_consts: Optional[Dict[int, torch.Tensor]] = None) -> _Pass:
        """What a run reads: this rank's one shard, each op at the variant
        the rank's device bits select."""
        if rows != 1 or sweep_consts is not None:
            raise ValueError("the shardmap backend runs one state at a time")
        return _Pass(1, self.engine.consts, False, self._members, self._shard_vidx)

    def execute(self, state: torch.Tensor, apply_final: bool = True) -> torch.Tensor:
        ps = self.pass_of()
        self.trace = []
        self.totals["runs"] += 1
        held = [state]  # no frame keeps the initial shard: a remap reuses it
        del state
        return self.engine.stage_loop(held.pop(), lambda v, prog: self.apply_ops(v, prog, ps),
                                      lambda v, slot, spec: self.remap(v, slot, reuse=True),
                                      apply_final)

    def execute_batch(self, states: torch.Tensor, apply_final: bool = True) -> torch.Tensor:
        """One run per element: the collectives preclude one pass over all."""
        return Backend.execute_batch(self, states, apply_final)

    def finalize(self, packed: torch.Tensor) -> torch.Tensor:
        rows = packed.reshape(-1, 1 << self.engine.L)
        return torch.stack([self.remap(r, "final") for r in rows]).view(packed.shape)

    def norms(self, rows: torch.Tensor) -> torch.Tensor:
        """Each row's norm over the whole state: the rank's float64 sums of
        squares, summed over the ranks, so every rank takes the same
        decision (a NaN on one rank is a NaN on all)."""
        return self.transport.all_reduce_sum(ExecutionEngine._sq_norms(rows)).sqrt()

    def slowest(self, values: Sequence[float]) -> np.ndarray:
        """The largest of each value over the ranks, so that every rank
        decides alike on times it took alone."""
        return self.transport.all_reduce_max(
            torch.as_tensor(np.asarray(values, dtype=np.float64))).numpy()


BACKENDS: Dict[str, Callable[[], Backend]] = {
    "cuda": CudaBackend,
    "offload": OffloadBackend,
    "dense": DenseBackend,
    "shardmap": ShardMapBackend,
}


# ======================================================================
# The engine
# ======================================================================


class ExecutionEngine:
    """Staged executor: one stage loop, one constant registry, one public
    API. ``device`` defaults to CUDA (raises when it is absent); pass
    ``device="cpu"`` to run on the CPU. ``backend``: ``"cuda"`` (the
    planned path with the state on the device), ``"offload"`` (the planned
    path with the state in host memory, streamed through the device stage
    by stage), ``"shardmap"`` (one ``torch.distributed`` rank per device
    of the bit-mesh, each holding its ``2^L`` shard: :class:`ShardMapBackend`)
    or ``"dense"`` (the per-gate oracle)."""

    def __init__(
        self,
        circuit: Circuit,
        plan: SimulationPlan,
        use_kernels: bool = True,
        device: DeviceLike = None,
        *,
        backend: Union[str, Backend] = "cuda",
        peephole: bool = True,
        compiled: Optional[CompiledCircuit] = None,
    ):
        self.circuit = circuit  # structural reference; may carry free Params
        self.plan = plan
        # bind/run* mutate shared state (the registry, ``bound_circuit``,
        # the backend's shm operands): concurrent callers hold this around
        # every bind+execute sequence
        self.lock = threading.RLock()
        self.device = resolve_device(device)
        self.dtype = torch.complex64  # the kernels' type
        self.np_dtype = np.dtype(np.complex64)
        self.use_kernels = use_kernels
        self.peephole = peephole
        # degradation provenance: build_engine records the planning rungs and
        # the compile retry here, the integrity guard its retries
        self.provenance: Dict = {"degraded": False}
        if use_kernels:
            if faults._ACTIVE is not None:
                faults.maybe_inject("pallas_lowering_error", site="engine.init")
            if self.device.type == "cuda":
                _load_kernels()  # a kernel that does not build fails here, typed
        self.cc: CompiledCircuit = (
            compiled if compiled is not None
            else compile_plan(circuit, plan, dtype=self.np_dtype, peephole=peephole))
        self.n, self.L, self.R, self.G = self.cc.n, self.cc.L, self.cc.R, self.cc.G
        self.bound_circuit: Optional[Circuit] = circuit if circuit.is_bound else None
        self.bind_count = 0
        # per-entry-point wall times (count/total/last/max in us)
        self.timings: Dict[str, Dict[str, float]] = {}
        self._struct_cache: Dict = {}  # binding-independent build artifacts
        # observable -> AdjointProgram, and the programs built so far (a
        # rebind builds none)
        self._adjoint_progs: Dict[str, "AdjointProgram"] = {}
        self.adjoint_builds = 0
        # op-tensor registry, keyed by stable ``Op.uid``: one device tensor
        # per op (a leading variant axis for dep-batched ops)
        self.consts: Dict[int, torch.Tensor] = {}
        for prog in self.cc.programs:
            for op in prog.ops:
                for o in (op,) + op.gates:
                    if o.tensor.size:
                        self.consts[o.uid] = self._upload(o.tensor)
        self.backend = BACKENDS[backend]() if isinstance(backend, str) else backend
        self.backend.setup(self)
        self.provenance.update(backend=self.backend.name, use_kernels=use_kernels)

    def _upload(self, t: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(t, dtype=self.np_dtype, order="C")).to(self.device)

    # --------------------------------------------------------- parameters
    @property
    def param_names(self) -> Tuple[str, ...]:
        return self.circuit.param_names

    def bind(self, params) -> "ExecutionEngine":
        """Bind the circuit parameters (dict or flat vector ordered by
        :attr:`param_names`) and swap the materialized op tensors into the
        constant registry: host numpy plus uploads, no re-planning."""
        return self.bind_circuit(self.circuit.bind(params))

    def bind_circuit(self, bound: Circuit) -> "ExecutionEngine":
        """Install a fully bound same-structure circuit as the current
        binding (the compile cache calls this on a structural hit with new
        angles)."""
        if bound.structure_fingerprint() != self.circuit.structure_fingerprint():
            raise ValueError("bind_circuit: circuit structure does not match "
                             "this engine's compiled structure")
        with self.lock:
            table = bind_tensors(bound, self.plan, dtype=self.np_dtype, peephole=self.peephole,
                                 expect=self.cc, struct_cache=self._struct_cache)
            self.load_consts(table)
            self.bound_circuit = bound
            self.bind_count += 1
        return self

    def load_consts(self, table: Dict[int, np.ndarray]) -> None:
        """Install a ``{uid: tensor}`` table (e.g. the reference engine's
        constant registry, see :mod:`repro_torch.convert`). Every uid and
        shape must match the compiled program's."""
        if set(table) != set(self.consts):
            raise ValueError("constant table uids do not match the compiled program")
        new = {}
        for uid, t in table.items():
            arr = np.asarray(t)
            if tuple(arr.shape) != tuple(self.consts[uid].shape):
                raise ValueError(f"op {uid}: shape {arr.shape} != "
                                 f"{tuple(self.consts[uid].shape)}")
            new[uid] = self._upload(arr)
        with self.lock:
            self.consts = new
            self.backend.on_rebind()

    def _require_bound(self) -> None:
        if self.bound_circuit is None:
            raise UnboundParameterError(
                f"engine has unbound parameters {self.param_names}; call "
                "bind(params) (or run_sweep) before executing")

    def _sweep_points(self, params_batch) -> List[dict]:
        names = self.param_names
        if isinstance(params_batch, (list, tuple)) and params_batch and \
                isinstance(params_batch[0], dict):
            return list(params_batch)
        arr = np.asarray(params_batch, dtype=np.float64)
        if arr.ndim == 1:
            arr = arr[:, None]
        if arr.shape[1] != len(names):
            raise ValueError(f"params_batch has {arr.shape[1]} columns; circuit has "
                             f"{len(names)} parameters {names}")
        return [dict(zip(names, row)) for row in arr]

    # --------------------------------------------------------------- timing
    def _record_time(self, name: str, wall_us: float) -> None:
        t = self.timings.setdefault(
            name, {"count": 0, "total_us": 0.0, "last_us": 0.0, "max_us": 0.0})
        t["count"] += 1
        t["total_us"] += wall_us
        t["last_us"] = wall_us
        t["max_us"] = max(t["max_us"], wall_us)
        profiler.record_observation(name, wall_us=wall_us, backend=self.backend.name, n=self.n,
                                    L=self.L, n_stages=len(self.cc.programs))

    def timing_snapshot(self) -> Dict[str, Dict[str, float]]:
        """JSON-able copy of the per-entry-point wall times, with means.
        Each time runs from the call to the device's last op of it (the
        device is synchronised before the clock is read)."""
        snap: Dict[str, Dict[str, float]] = {}
        for k, t in self.timings.items():
            d = dict(t)
            d["mean_us"] = d["total_us"] / max(d["count"], 1)
            snap[k] = d
        return snap

    def _timed(self, name: str, fn: Callable[[], torch.Tensor]) -> torch.Tensor:
        t0 = time.perf_counter()
        out = fn()
        _sync(self.device)
        self._record_time(name, (time.perf_counter() - t0) * 1e6)
        return out

    # ------------------------------------------------------------- shared
    @property
    def n_nonlocal(self) -> int:
        """The device bits of the packed state, ``R + G``: it has
        ``2^(R+G)`` shards."""
        return self.R + self.G

    def stage_loop(self, x, ops_fn, remap_fn, apply_final: bool = True, start: int = 0,
                   after_stage: Optional[Callable] = None):
        """The stage loop: ``ops_fn(x, prog)`` applies one stage's op list;
        ``remap_fn(x, slot, spec)`` applies one inter-stage remap, where
        ``slot`` is ``"init"``, the stage index, or ``"final"``. ``start``
        skips the stages before it (and the initial remap with them: ``x``
        is the state after stage ``start - 1``); ``after_stage(i, x)`` runs
        after stage ``i``'s ops and the remap after them."""
        cc = self.cc
        if start == 0 and cc.initial_remap is not None:
            x = remap_fn(x, "init", cc.initial_remap)
        for i, prog in enumerate(cc.programs[start:], start):
            x = ops_fn(x, prog)
            if prog.remap_after is not None:
                x = remap_fn(x, i, prog.remap_after)
            if after_stage is not None:
                after_stage(i, x)
        if apply_final and cc.final_remap is not None:
            x = remap_fn(x, "final", cc.final_remap)
        return x

    def op_counts(self) -> Dict[str, int]:
        """Top-level ops of the compiled program by kind."""
        counts: Dict[str, int] = {}
        for prog in self.cc.programs:
            for op in prog.ops:
                counts[op.kind] = counts.get(op.kind, 0) + 1
        return counts

    # --------------------------------------------------- integrity guard
    def dense_reference(self, bound: Optional[Circuit] = None, psi0=None,
                        apply_final: bool = True) -> torch.Tensor:
        """The per-gate dense oracle's state for ``bound`` (the current
        binding by default), on the engine's device; with
        ``apply_final=False`` re-stored in the compiled frame's physical
        order (comparable to :meth:`run_packed`). The guard does not use it:
        its retry runs the plan again through the kernels (:meth:`_rerun`)."""
        from .statevector import simulate

        if bound is None:
            self._require_bound()
            bound = self.bound_circuit
        psi = simulate(bound, psi0=psi0, dtype=self.dtype, device=self.device).reshape(-1)
        return psi if apply_final else to_frame(psi, self.measurement_frame)

    def _rerun(self, bound: Circuit, psi0, apply_final: bool) -> torch.Tensor:
        """The integrity guard's one retry: the same plan under ``bound``,
        through the engine's own backend and kernels, on the device the
        run's output lives on. The engine's binding is left as it was."""
        with self.lock:
            prev = self.bound_circuit
            if bound is not prev:
                self.bind_circuit(bound)
            try:
                out = self.backend.extract(self.backend.execute(self.backend.prepare(psi0),
                                                                apply_final))
                _sync(self.device)
                return out
            finally:
                if prev is None:
                    self.bound_circuit = None  # an unbound engine stays unbound
                elif prev is not bound:
                    self.bind_circuit(prev)

    @staticmethod
    def _sq_norms(rows: torch.Tensor, chunk: int = 1 << 24) -> torch.Tensor:
        """The squared 2-norm of every row of ``rows`` (``[P, N]``), reduced
        where the rows live, ``chunk`` amplitudes of a row at a time, the
        squares summed in float64. A non-finite amplitude makes its row's
        norm non-finite."""
        acc = torch.zeros(rows.shape[0], dtype=torch.float64, device=rows.device)
        for i in range(0, rows.shape[1], chunk):
            part = torch.view_as_real(rows[:, i:i + chunk])
            acc += part.square().sum(dim=(1, 2), dtype=torch.float64)
        return acc

    @staticmethod
    def _norm_ok(norm: float, expected: float, rtol: float = 1e-2) -> bool:
        return math.isfinite(norm) and abs(norm - expected) <= rtol * max(expected, 1e-30)

    def _norm_of(self, arr) -> float:
        arr = torch.as_tensor(arr)
        return float(self._sq_norms(arr.reshape(1, -1)).sqrt()[0])

    def _expected_norm(self, psi0) -> float:
        return 1.0 if psi0 is None else self._norm_of(psi0)

    def _out_norm(self, out: torch.Tensor) -> float:
        """The norm of a run's output as the backend reduces it (a shard's
        across every rank on the shardmap backend)."""
        return float(self.backend.norms(out.reshape(1, -1))[0])

    def _guard(self, out: torch.Tensor, psi0, apply_final: bool = True,
               bound: Optional[Circuit] = None) -> torch.Tensor:
        """Post-run ||psi|| =~ ||psi0|| check: unitary evolution keeps the
        input norm, so a NaN/denormal blowup shows in one pass. On failure,
        re-run the plan ONCE (:meth:`_rerun`); if that is poisoned too,
        raise a typed :class:`IntegrityError`."""
        expected = self._expected_norm(psi0)
        norm = self._out_norm(out)
        if self._norm_ok(norm, expected):
            return out
        self.provenance["integrity_retries"] = self.provenance.get("integrity_retries", 0) + 1
        retry = self._rerun(self.bound_circuit if bound is None else bound, psi0, apply_final)
        if not self._norm_ok(self._out_norm(retry), expected):
            raise IntegrityError(
                f"state norm {norm:.6g} != {expected:.6g} and the retry is also poisoned — "
                "numerically corrupt circuit/binding")
        self.provenance["integrity_recovered"] = (
            self.provenance.get("integrity_recovered", 0) + 1)
        return retry

    @staticmethod
    def _poison(out: torch.Tensor) -> torch.Tensor:
        """The ``nan_amplitudes`` fault: NaN into the run's own output
        (amplitude 0), in place (a copy would be a second state)."""
        out.view(-1)[0] = float("nan")
        return out

    def _corrupt(self, out: torch.Tensor, site: str) -> torch.Tensor:
        if faults._ACTIVE is not None and faults.should_corrupt(site):
            return self._poison(out)
        return out

    # ---------------------------------------------------------------- api
    def run(self, psi0=None, params=None, *, verify: bool = False) -> torch.Tensor:
        """psi0: flat [2^n] in logical order (defaults to |0..0>). Returns
        the final flat state in logical order, on the engine's device.
        ``params`` rebinds first: a tensor swap, never a re-plan.
        ``verify`` turns on the post-run norm guard (a NaN blowup becomes
        one re-run of the plan, then a typed :class:`IntegrityError`)."""
        with self.lock:
            if params is not None:
                self.bind(params)
            self._require_bound()
            bound = self.bound_circuit
            if faults._ACTIVE is not None:
                faults.maybe_inject("slow_stage", site="engine.run")
            out = self._timed("run", lambda: self.backend.extract(self.backend.execute(
                self.backend.prepare(psi0), True)))
        out = self._corrupt(out, "engine.run")
        return self._guard(out, psi0, True, bound) if verify else out

    def run_packed(self, psi0=None, params=None, *, verify: bool = False) -> torch.Tensor:
        """Run but skip the final inter-stage remap: the state stays in the
        last stage's physical layout (lazy flips pending). Pair with
        :attr:`measurement_frame` and :mod:`repro_torch.sim.measure`.
        ``verify``: as in :meth:`run`."""
        with self.lock:
            if params is not None:
                self.bind(params)
            self._require_bound()
            bound = self.bound_circuit
            if faults._ACTIVE is not None:
                faults.maybe_inject("slow_stage", site="engine.run")
            out = self._timed("run_packed", lambda: self.backend.extract(self.backend.execute(
                self.backend.prepare(psi0), False)))
        out = self._corrupt(out, "engine.run")
        return self._guard(out, psi0, False, bound) if verify else out

    def run_batch(self, psi0s, apply_final: bool = True) -> torch.Tensor:
        """Run a batch of initial states ``psi0s: [B, 2^n]`` (any B), or a
        callable ``rows(lo, hi)`` giving amplitudes ``[lo, hi)`` of each row
        (:func:`batch_columns`; a shardmap rank asks only for its own).
        Returns ``[B, 2^n]`` in logical order, or in the last stage's
        physical layout when ``apply_final=False`` (measure each element
        with :func:`repro_torch.sim.measure.measure_batch`)."""
        with self.lock:
            self._require_bound()
            return self._timed("run_batch", lambda: self.backend.extract(
                self.backend.execute_batch(self.backend.prepare(psi0s, batch=True), apply_final),
                batch=True))

    def run_sweep(self, psi0, params_batch, apply_final: bool = True, *,
                  verify: bool = False) -> torch.Tensor:
        """Run ONE initial state against a batch of parameter bindings.

        ``params_batch``: a ``[P, n_params]`` array (columns ordered by
        :attr:`param_names`) or a list of ``{name: value}`` dicts. The P
        points' tensor tables are built on the host in one pass (no
        re-planning) and the ``cuda`` backend runs them all at once: every
        op is one launch over ``P * 2^(G+R)`` shards. The ``dense`` backend
        rebinds point by point. Returns ``[P, 2^n]`` in logical order (or
        packed when ``apply_final=False``); the engine's own binding is
        left as it was by the fused path. ``verify``: the norm guard row by
        row; only a poisoned row pays the retry."""
        points = self._sweep_points(params_batch)
        if not points:
            raise ValueError("empty params_batch")
        with self.lock:
            if self.backend.supports_fused_sweep():
                if faults._ACTIVE is not None:
                    faults.maybe_inject("slow_stage", site="engine.run_sweep")
                stacked = self.sweep_tables(points)
                out = self._timed("run_sweep", lambda: self.backend.extract(
                    self.backend.execute_sweep(self.backend.prepare(psi0), stacked, len(points),
                                               apply_final), batch=True))
            else:
                t0 = time.perf_counter()
                outs = []
                for pt in points:
                    self.bind(pt)
                    outs.append(self.run(psi0) if apply_final else self.run_packed(psi0))
                out = torch.stack(outs)
                self._record_time("run_sweep", (time.perf_counter() - t0) * 1e6)
        if faults._ACTIVE is not None and faults.should_corrupt("engine.run_sweep"):
            out = self._poison_row(out, len(points))
        return self._guard_sweep(out, psi0, points, apply_final) if verify else out

    def _poison_row(self, out: torch.Tensor, n_rows: int) -> torch.Tensor:
        """NaN into one row of a sweep's own output, the row drawn from the
        active plan's generator as the reference draws it (one seed poisons
        the same row in both packages)."""
        plan = faults._ACTIVE
        row = plan._rng.randrange(n_rows) if plan is not None else 0
        out.reshape(out.shape[0], -1)[row, 0] = float("nan")
        return out

    def _guard_sweep(self, out: torch.Tensor, psi0, points: List[dict],
                     apply_final: bool) -> torch.Tensor:
        """Per-row norm guard for a sweep: only poisoned rows pay the retry
        (:meth:`_rerun` under that row's binding), written into the sweep's
        output; a row whose retry is poisoned too raises."""
        flat = out.reshape(out.shape[0], -1)
        expected = self._expected_norm(psi0)
        norms = self.backend.norms(flat).tolist()
        bad = [i for i in range(len(points)) if not self._norm_ok(norms[i], expected)]
        if not bad:
            return out
        self.provenance["integrity_retries"] = (
            self.provenance.get("integrity_retries", 0) + len(bad))
        for i in bad:
            retry = self._rerun(self.circuit.bind(points[i]), psi0, apply_final)
            if not self._norm_ok(self._out_norm(retry), expected):
                raise IntegrityError(f"sweep row {i}: norm check failed and the retry is also "
                                     "poisoned")
            flat[i].copy_(retry)
            del retry
        self.provenance["integrity_recovered"] = (
            self.provenance.get("integrity_recovered", 0) + len(bad))
        return out

    def sweep_tables(self, points: List[dict]) -> Dict[int, torch.Tensor]:
        """The op tables of the P bindings ``points``, built on the host in
        one pass and stacked on the device as ``[P * V, ...]`` (point ``p``'s
        variants at rows ``p * V ...``): what a fused sweep runs on."""
        with self.lock:
            tables = bind_tensors_sweep(
                [self.circuit.bind(pt) for pt in points], self.plan, dtype=self.np_dtype,
                peephole=self.peephole, expect=self.cc, struct_cache=self._struct_cache)
            return {uid: self._upload(t.reshape((-1,) + t.shape[2:]))
                    for uid, t in tables.items()}

    def finalize(self, packed: torch.Tensor) -> torch.Tensor:
        """Logical-order state(s) from a ``run_packed`` result, or from a
        ``[B, 2^n]`` batch of them (the final remap)."""
        if self.cc.final_remap is None:
            return packed
        return self.backend.finalize(packed)

    @property
    def measurement_frame(self):
        from .measure import Frame

        return Frame.from_compiled(self.cc)

    # ---------------------------------------------------- adjoint gradients
    def adjoint_program(self, observable) -> "AdjointProgram":
        """The cached :class:`repro_torch.sim.adjoint.AdjointProgram` for
        this engine's structure and ``observable``, on the engine's device
        and kernel setting (a :class:`~repro_torch.sim.adjoint.ShardedAdjointProgram`
        on a backend whose ranks hold shards); every binding reuses it (each
        one built counts into :attr:`adjoint_builds`)."""
        from .adjoint import AdjointProgram, ShardedAdjointProgram
        from .measure import PauliSum

        key = str(PauliSum.coerce(observable))
        with self.lock:
            prog = self._adjoint_progs.get(key)
            if prog is None:
                if self.backend.holds_whole_state:
                    prog = AdjointProgram(self.circuit, observable, device=self.device,
                                          use_kernels=self.use_kernels)
                else:
                    prog = ShardedAdjointProgram(self.circuit, observable, self.backend)
                self._adjoint_progs[key] = prog
                self.adjoint_builds += 1
            return prog

    def _on_device(self, states: torch.Tensor) -> torch.Tensor:
        """A run's output as the reverse sweep takes it: ``[rows, 2^n]`` on
        the engine's device. An offload run's host state is uploaded (the
        sweep needs whole states on the device); a state already there is
        the run's own output, which the sweep consumes."""
        return states.to(self.device).reshape(-1, 1 << self.n)

    def value_and_grad(self, observable, params=None, psi0=None) -> Tuple[float, np.ndarray]:
        """``(E, ∂E/∂θ)`` for ``E = <ψ(θ)|H|ψ(θ)>`` by adjoint
        differentiation: the backend's forward run produces |ψ⟩, then one
        reverse sweep over the gate list (:mod:`repro_torch.sim.adjoint`)
        gives every parameter's gradient — three state passes, however many
        parameters. ``params`` (optional) rebinds first; gradients are
        ordered by :attr:`param_names` (float64). No solver call and no new
        adjoint program after the first call per observable. On the
        shardmap backend every rank calls it and returns the same numbers:
        the forward run stops before its final remap and each rank sweeps
        its shard (:class:`~repro_torch.sim.adjoint.ShardedAdjointProgram`)."""
        with self.lock:
            if params is not None:
                self.bind(params)
            self._require_bound()
            t0 = time.perf_counter()
            prog = self.adjoint_program(observable)
            if self.backend.holds_whole_state:
                psi = self._on_device(self.run(psi0))
            else:
                psi = self.run_packed(psi0).view(1, -1)
            values, grads = prog.sweep_(psi, *prog.tensors(self.bound_circuit))
            self._record_time("value_and_grad", (time.perf_counter() - t0) * 1e6)
        return float(values[0]), grads[0]

    def grad_sweep(self, params_batch, observable, psi0=None) -> Tuple[np.ndarray, np.ndarray]:
        """``value_and_grad`` over a batch of bindings: ``(values [P],
        grads [P, n_params])``. The forward states come from
        :meth:`run_sweep`; when the backend reports ``supports_fused_grad``
        the reverse sweeps run on all P states at once (every gate
        application one launch for all P), otherwise point by point (on the
        shardmap backend each point's forward run and sweep before the
        next's). Either way through one cached adjoint program."""
        points = self._sweep_points(params_batch)
        if not points:
            raise ValueError("empty params_batch")
        with self.lock:
            if not self.backend.holds_whole_state:
                rows = [self.value_and_grad(observable, pt, psi0) for pt in points]
                return np.asarray([v for v, _ in rows]), np.stack([g for _, g in rows])
            prog = self.adjoint_program(observable)
            bounds = [self.circuit.bind(pt) for pt in points]
            states = self.run_sweep(psi0, points)
            if self.backend.supports_fused_grad():
                return prog.sweep_(self._on_device(states), *prog.stacked_tensors(bounds))
            vals, gs = [], []
            for p, bound in enumerate(bounds):
                v, g = prog.sweep_(self._on_device(states[p]), *prog.tensors(bound))
                vals.append(v[0])
                gs.append(g[0])
            return np.asarray(vals), np.stack(gs)


# ======================================================================
# Compile cache (serving: plan once, run many)
# ======================================================================


def _canon(v):
    """Canonicalize a cache-key component into a stable, reprable value."""
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if isinstance(v, (tuple, list)):
        return tuple(_canon(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _canon(x)) for k, x in v.items()))
    return v


def _resolve_cost_model(cm: Optional[CostModel], device: DeviceLike = None) -> CostModel:
    """``cost_model=None`` (the serving default) means "whatever the
    device is calibrated to": the profiler's memoized resolution — the
    measured model when a calibration file whose fingerprint matches
    ``device`` exists, the analytic defaults otherwise. Explicit models pass
    through untouched."""
    if cm is not None:
        return cm
    return profiler.resolve_cost_model(device=device)


def _placement_fingerprint(device: DeviceLike) -> Tuple:
    """Where an engine's tensors live: its device, with the index made
    explicit, and in a ``torch.distributed`` job the default group's size,
    this process's rank and the group's backend. Engines on two devices, or
    two ranks, never share a cache entry."""
    dev = torch.device("cuda" if device is None else device)
    index = dev.index
    if index is None and dev.type == "cuda":
        index = torch.cuda.current_device() if torch.cuda.is_available() else 0
    mesh = ()
    if dist.is_available() and dist.is_initialized():
        mesh = (dist.get_world_size(), dist.get_rank(), str(dist.get_backend()))
    return (dev.type, index) + mesh


@dataclass(frozen=True)
class CircuitKey:
    """Stable fingerprint of (circuit STRUCTURE, architecture split, plan and
    compile knobs): equal keys => the same plan and compiled program.

    Deliberately parameter-blind: planning and stage compilation depend only
    on circuit structure, so two circuits that differ only in rotation
    angles share one cached engine, which rebinds its tensors."""

    digest: str

    @staticmethod
    def make(
        circuit: Circuit,
        L: int,
        R: int = 0,
        G: int = 0,
        *,
        backend: str = "cuda",
        use_kernels: bool = True,
        peephole: bool = True,
        staging_method: str = "ilp",
        kernelize_method: str = "dp",
        cost_model: Optional[CostModel] = None,
        optimize=False,
        extra=(),
    ) -> "CircuitKey":
        cost_model = _resolve_cost_model(cost_model)
        cm = tuple((f.name, _canon(getattr(cost_model, f.name))) for f in _dc_fields(cost_model))
        # an optimized plan and the literal plan of one structure never collide
        ofp = copt.optimize_fingerprint(optimize)
        payload = (
            circuit.structure_fingerprint(), (L, R, G), str(backend), bool(use_kernels),
            bool(peephole), staging_method, kernelize_method, cm, ofp, _canon(extra),
        )
        return CircuitKey(hashlib.sha256(repr(payload).encode()).hexdigest())


class CompileCache:
    """LRU of :class:`CircuitKey` -> built :class:`ExecutionEngine`.

    A cached engine keeps its plan, compiled stage programs, device
    constants and the kernels' step tables, so a repeat of the same
    structure skips staging, kernelization and stage compilation.

    Thread-safe: every LRU mutation happens under an internal lock. With
    ``evict_scan > 1`` the victim is the least-*hit* entry among the
    ``evict_scan`` oldest (plain LRU by default). Per-key hit counts persist
    across eviction and feed :meth:`stats`."""

    def __init__(self, maxsize: int = 32, evict_scan: int = 1):
        self.maxsize = maxsize
        self.evict_scan = max(1, evict_scan)
        self._d: "OrderedDict[CircuitKey, ExecutionEngine]" = OrderedDict()
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.key_hits: Dict[str, int] = {}  # digest -> lifetime hit count

    def get(self, key: CircuitKey) -> Optional[ExecutionEngine]:
        with self._lock:
            eng = self._d.get(key)
            if eng is None:
                self.misses += 1
                return None
            self.hits += 1
            self.key_hits[key.digest] = self.key_hits.get(key.digest, 0) + 1
            self._d.move_to_end(key)
            return eng

    def peek(self, key: CircuitKey) -> Optional[ExecutionEngine]:
        """Counter-neutral lookup (the double-checked probe of
        :func:`engine_for`, whose outer :meth:`get` already counted)."""
        with self._lock:
            return self._d.get(key)

    def put(self, key: CircuitKey, engine: ExecutionEngine) -> None:
        with self._lock:
            self._d[key] = engine
            self._d.move_to_end(key)
            self.key_hits.setdefault(key.digest, 0)
            while len(self._d) > self.maxsize:
                tail = list(self._d.keys())[: min(self.evict_scan, len(self._d) - 1)]
                victim = min(tail, key=lambda k: self.key_hits.get(k.digest, 0))
                del self._d[victim]
                self.evictions += 1

    def clear(self) -> None:
        with self._lock:
            self._d.clear()
            self.hits = self.misses = self.evictions = 0
            self.key_hits.clear()

    def stats(self) -> Dict:
        """JSON-able counters: size, hits, misses, evictions and per-key
        hit counts keyed by truncated digest."""
        with self._lock:
            return {
                "size": len(self._d),
                "maxsize": self.maxsize,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "key_hits": {d[:12]: c for d, c in self.key_hits.items()},
            }

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def __contains__(self, key: CircuitKey) -> bool:
        with self._lock:
            return key in self._d


DEFAULT_CACHE = CompileCache()

_BUILD_LOCKS: Dict[Tuple[int, str], threading.Lock] = {}
_BUILD_LOCKS_GUARD = threading.Lock()


def _build_lock(cache: CompileCache, key: CircuitKey) -> threading.Lock:
    """Per-(cache, key) build lock: two threads missing on the same key do
    not both plan; the second waits and takes the cache hit."""
    with _BUILD_LOCKS_GUARD:
        if len(_BUILD_LOCKS) > 4096:  # bounded: locks are tiny but not free
            _BUILD_LOCKS.clear()
        return _BUILD_LOCKS.setdefault((id(cache), key.digest), threading.Lock())


def circuit_key_for(
    circuit: Circuit,
    L: int,
    R: int = 0,
    G: int = 0,
    *,
    backend: str = "cuda",
    use_kernels: bool = True,
    peephole: bool = True,
    staging_method: str = "ilp",
    kernelize_method: str = "dp",
    cost_model: Optional[CostModel] = None,
    optimize=False,
    device: DeviceLike = None,
    storage=None,
    checkpoint_dir: Optional[str] = None,
    _pre_optimized: bool = False,
    **plan_kw,
) -> CircuitKey:
    """The exact :class:`CircuitKey` :func:`engine_for` uses for these
    arguments. With ``optimize`` on, the key covers the OPTIMIZED circuit's
    structure and the optimizer's fingerprint (``_pre_optimized=True``: the
    circuit already is the optimizer's output). The device is part of the
    key, and so are the offload backend's ``storage`` (through
    :meth:`StorageConfig.fingerprint`: compressed and exact plans never
    share an engine) and ``checkpoint_dir``; both need ``backend="offload"``."""
    storage = StorageConfig.coerce(storage)
    if (storage is not None or checkpoint_dir is not None) and backend != "offload":
        raise ValueError(f"storage= and checkpoint_dir= need backend='offload' (got "
                         f"{backend!r}): the shard store and stage checkpoints exist only "
                         "under the host-offload path")
    ocfg = copt.resolve_config(optimize)
    if ocfg is not None and not _pre_optimized:
        circuit = copt.optimize_circuit(circuit, ocfg).circuit
    cost_model = _resolve_cost_model(cost_model, device)
    extra = (tuple(sorted((k, _canon(v)) for k, v in plan_kw.items())),
             _placement_fingerprint(device))
    if storage is not None:
        extra += (storage.fingerprint(),)
    if checkpoint_dir is not None:
        extra += (("checkpoint_dir", str(checkpoint_dir)),)
    return CircuitKey.make(
        circuit, L, R, G, backend=backend, use_kernels=use_kernels, peephole=peephole,
        staging_method=staging_method, kernelize_method=kernelize_method,
        cost_model=cost_model, optimize=ocfg, extra=extra,
    )


# ======================================================================
# The degradation ladder: planning rungs and the build
# ======================================================================

# No backend rungs: the reference walks ``pjit -> dense`` and
# ``offload -> dense`` on a typed build failure, and first retries a failed
# Pallas lowering with ``use_pallas=False``. The port takes neither: a run
# that asked for the hand kernels on the card never lands on torch ops,
# another backend or the CPU unasked. A backend or kernel that fails to
# build raises its typed error (which the serving layer's breaker counts).


def _record_fallback(prov: Dict, from_: str, to: str, err: Exception) -> None:
    prov["degraded"] = True
    prov.setdefault("fallbacks", []).append({
        "from": from_, "to": to, "error": f"{type(err).__name__}: {err}",
    })


def _plan_resilient(circuit, L, R, G, *, staging_method, kernelize_method,
                    cost_model, provenance, **plan_kw):
    """Partition with the planning rungs of the reference's ladder: a typed
    :class:`StagingError` retries with greedy staging, a typed
    :class:`KernelizationError` with greedy kernelization. Both are host
    choices of plan; nothing here changes where or how the plan runs.
    Returns ``(plan, staging_method, kernelize_method)`` actually used."""
    sm, km = staging_method, kernelize_method
    while True:
        try:
            plan = partition(circuit, L, R, G, staging_method=sm, kernelize_method=km,
                             cost_model=cost_model, **plan_kw)
            return plan, sm, km
        except StagingError as e:
            if sm == "greedy":
                raise
            _record_fallback(provenance, f"staging:{sm}", "staging:greedy", e)
            sm = "greedy"
        except KernelizationError as e:
            if km == "greedy":
                raise
            _record_fallback(provenance, f"kernelize:{km}", "kernelize:greedy", e)
            km = "greedy"


def build_engine(
    circuit: Circuit,
    plan: SimulationPlan,
    *,
    backend: str = "cuda",
    use_kernels: bool = True,
    peephole: bool = True,
    device: DeviceLike = None,
    provenance: Optional[Dict] = None,
    storage=None,
    checkpoint_dir: Optional[str] = None,
) -> ExecutionEngine:
    """Compile ``plan`` and build an engine on it. A typed ``compile_plan``
    failure gets ONE retry (then it propagates). Nothing else degrades: a
    backend or a kernel that fails to build raises, so a run never lands on
    another backend, the CPU, or the kernels' plain versions unasked.
    ``storage`` / ``checkpoint_dir`` go to the offload backend."""
    prov: Dict = provenance if provenance is not None else {}
    be: Union[str, Backend] = backend
    if storage is not None or checkpoint_dir is not None:
        if backend != "offload":
            raise ValueError(f"storage= and checkpoint_dir= need backend='offload' (got "
                             f"{backend!r}): the shard store and stage checkpoints exist "
                             "only under the host-offload path")
        be = OffloadBackend(storage=storage, checkpoint_dir=checkpoint_dir)
    cc = None
    for attempt in range(2):
        try:
            cc = compile_plan(circuit, plan, dtype=np.complex64, peephole=peephole)
            break
        except FaultError as e:
            if attempt:
                raise
            _record_fallback(prov, "compile", "compile(retry)", e)
    eng = ExecutionEngine(circuit, plan, use_kernels, device, backend=be,
                          peephole=peephole, compiled=cc)
    eng.provenance.update(prov)
    return eng


def engine_for(
    circuit: Circuit,
    L: int,
    R: int = 0,
    G: int = 0,
    *,
    backend: str = "cuda",
    use_kernels: bool = True,
    peephole: bool = True,
    staging_method: str = "ilp",
    kernelize_method: str = "dp",
    cost_model: Optional[CostModel] = None,
    optimize=False,
    cache: Optional[CompileCache] = DEFAULT_CACHE,
    plan: Optional[SimulationPlan] = None,
    device: DeviceLike = None,
    storage=None,
    checkpoint_dir: Optional[str] = None,
    **plan_kw,
) -> ExecutionEngine:
    """The serving entry point: partition + compile + build an engine, or
    return the cached engine of a structurally identical request.

    The key is **structural**: two requests whose circuits differ only in
    gate angles share one engine, which is *rebound* to the request's
    parameters (``bind_circuit``: host numpy plus uploads; no staging, no
    kernelization, no ``compile_plan``, no kernel build). Symbolic circuits
    come back unbound; call ``bind``/``run_sweep`` on the engine. A symbolic
    request that hits an engine built for other Param names or scales makes
    the engine adopt the requested skeleton.

    ``optimize`` (bool, pass names, or an ``OptimizerConfig``) runs the
    pre-staging optimizer first; planning, caching and execution all see the
    optimized circuit, and ``engine.provenance["optimize"]`` records the
    rewrite. ``cache=None`` forces a fresh build; an explicit ``plan``
    bypasses the cache (and cannot be combined with ``optimize``). The
    engine's device is part of the key, and so is the backend: offload
    engines are cached apart from ``cuda`` ones.

    ``storage`` turns on the offload backend's tiered shard store (a
    :class:`repro_torch.sim.shard_store.StorageConfig`, a spec string like
    ``"int8:dram_kib=64"``, or a dict; needs ``backend="offload"``); the
    ``REPRO_STORAGE`` environment variable supplies one for offload engines
    that pass neither ``storage`` nor ``checkpoint_dir``. The cost model is
    then re-priced for the tier the shards sit in
    (:meth:`StorageConfig.apply_to_cost_model`). ``checkpoint_dir`` turns on
    the offload backend's stage checkpoints (needs ``backend="offload"``;
    not with ``storage``). Both are part of the key.

    ``cost_model=None`` plans on the device's calibration
    (:func:`_resolve_cost_model`); the resolved model is part of the key,
    so a calibrated and an analytic engine never share a slot, and
    ``provenance["calibration"]`` records its source."""
    device = resolve_device(device)
    storage = StorageConfig.coerce(storage)
    if storage is None and backend == "offload" and checkpoint_dir is None:
        storage = StorageConfig.from_env()
    if storage is not None and backend != "offload":
        raise ValueError(f"storage= requires backend='offload' (got {backend!r}); the "
                         "tiered shard store only exists under the host-offload path")
    base_cost_model = cost_model
    if storage is not None:
        cost_model = storage.apply_to_cost_model(_resolve_cost_model(cost_model, device),
                                                 circuit.n_qubits, L)
    ocfg = copt.resolve_config(optimize)
    if plan is not None:
        if ocfg is not None:
            raise ValueError("engine_for: optimize= cannot be combined with an explicit "
                             "plan (the plan was computed for the literal circuit)")
        return build_engine(circuit, plan, backend=backend, use_kernels=use_kernels,
                            peephole=peephole, device=device, storage=storage,
                            checkpoint_dir=checkpoint_dir)
    source_circuit = circuit
    opt_result = None
    if ocfg is not None:
        opt_result = copt.optimize_circuit(circuit, ocfg)
        circuit = opt_result.circuit
    explicit_cm = base_cost_model is not None
    cost_model = _resolve_cost_model(cost_model, device)
    key = circuit_key_for(
        circuit, L, R, G, backend=backend, use_kernels=use_kernels, peephole=peephole,
        staging_method=staging_method, kernelize_method=kernelize_method,
        cost_model=cost_model, optimize=optimize, device=device, storage=storage,
        checkpoint_dir=checkpoint_dir, _pre_optimized=True, **plan_kw)
    eng = cache.get(key) if cache is not None else None
    if eng is None:
        blk = _build_lock(cache, key) if cache is not None else threading.Lock()
        with blk:
            # double-checked: a concurrent builder may have landed it
            eng = cache.peek(key) if cache is not None else None
            if eng is None:
                prov: Dict = {}
                plan, _, _ = _plan_resilient(
                    circuit, L, R, G, staging_method=staging_method,
                    kernelize_method=kernelize_method, cost_model=cost_model,
                    provenance=prov, **plan_kw)
                eng = build_engine(circuit, plan, backend=backend, use_kernels=use_kernels,
                                   peephole=peephole, device=device, provenance=prov,
                                   storage=storage, checkpoint_dir=checkpoint_dir)
                eng.provenance["calibration"] = (
                    {"source": "explicit"} if explicit_cm
                    else profiler.resolve_calibration(device=device)[1])
                if opt_result is not None:
                    # the engine serves the OPTIMIZED circuit; the config lets
                    # an aliased hit map a literal request through the passes
                    eng.opt_config = ocfg
                    eng.provenance["optimize"] = dict(
                        opt_result.to_dict(), passes=list(ocfg.passes),
                        source_fingerprint=source_circuit.structure_fingerprint()[:12])
                if cache is not None:
                    cache.put(key, eng)
                return eng
    with eng.lock:
        same_structure = (eng.circuit.structure_fingerprint()
                          == circuit.structure_fingerprint())
        if not same_structure:
            # a key hit with another structure only comes from plan
            # aliasing (an optimized engine installed under a literal key):
            # map the request through the engine's own optimizer config
            ecfg = getattr(eng, "opt_config", None)
            if ecfg is not None:
                mapped = copt.optimize_circuit(source_circuit, ecfg).circuit
                if mapped.structure_fingerprint() == eng.circuit.structure_fingerprint():
                    circuit = mapped
                    same_structure = True
        if same_structure:
            if circuit.is_bound and (
                    eng.bound_circuit is None
                    or eng.bound_circuit.binding_signature() != circuit.binding_signature()):
                # structural hit with other angles: rebind, don't re-plan
                eng.bind_circuit(circuit)
            elif not circuit.is_bound and (
                    eng.circuit.is_bound
                    or eng.circuit.binding_signature() != circuit.binding_signature()):
                # symbolic request on an engine whose skeleton is concrete or
                # carries other Param names / scales (the key is blind to
                # both): adopt the REQUESTED skeleton so the caller's names
                # and scales resolve; the current binding is untouched.
                # Adjoint programs wired to the old names and scales go.
                eng.circuit = circuit
                eng._adjoint_progs.clear()
    if not same_structure:
        # an aliased engine in another circuit space: never rebind across
        # structures; build fresh, un-cached
        return engine_for(
            source_circuit, L, R, G, backend=backend, use_kernels=use_kernels,
            peephole=peephole, staging_method=staging_method,
            kernelize_method=kernelize_method,
            cost_model=base_cost_model, optimize=optimize, cache=None,
            device=device, storage=storage, checkpoint_dir=checkpoint_dir,
            **plan_kw)
    return eng
