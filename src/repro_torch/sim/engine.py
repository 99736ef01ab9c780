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
* :class:`DenseBackend` is the per-gate oracle behind the same API;
* :func:`engine_for` is the serving entry point: a structural
  :class:`CircuitKey` -> engine LRU (:class:`CompileCache`) that rebinds a
  cached engine to new angles instead of planning again.

With ``use_kernels`` (the default) every ``fused`` op goes to the
hand-written ``fused_apply`` kernel and every ``shm`` group to
``shm_apply``, one launch each (on the CPU the wrappers run their plain
versions); ``diag``/``scalar`` ops and remaps are plain tensor code. With
``use_kernels=False`` the engine runs the reference's non-kernel path: every
op, and every member of an shm group, as tensor code. Ops update the state
in place; a remap writes one new state, so a run holds at most two states.

The reference's degradation ladder keeps only its planning rungs here
(:func:`_plan_resilient`) and the one retry of a failed ``compile_plan``
(:func:`build_engine`): a backend or kernel that fails raises. Not in this
module yet: host offload (``storage=``), the multi-device backends, adjoint
gradients, the norm guard and the device calibration.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field, fields as _dc_fields
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core import optimize as copt
from ..core.circuit import Circuit
from ..core.cost_model import CostModel, DEFAULT_COST_MODEL
from ..core.gates import UnboundParameterError
from ..core.partition import SimulationPlan, partition
from ..device import DeviceLike, resolve_device
from ..kernels import ops as kops
from .apply import apply_matrix_bits, mul_bits_, permute_bits
from .compile import (
    CompiledCircuit, Op, RemapSpec, StageProgram, bind_tensors, bind_tensors_sweep, compile_plan,
)
from .faults import FaultError, KernelizationError, StagingError


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

    def setup(self, engine: "ExecutionEngine") -> None:
        self.engine = engine

    def on_rebind(self) -> None:
        """Called after the engine installs a new binding. Anything derived
        from tensor values must be dropped here; nothing structural."""

    def supports_fused_sweep(self) -> bool:
        """True when ``execute_sweep`` runs every binding in one pass; the
        engine rebinds point by point otherwise."""
        return False

    def prepare(self, psi0, batch: bool = False) -> torch.Tensor:
        eng = self.engine
        if batch:
            x = torch.as_tensor(psi0).to(device=eng.device, dtype=eng.dtype)
            x = x.reshape(-1, 1 << eng.n).clone()  # the run updates its state in place
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


@dataclass
class _Pass:
    """What one run of the stage loop reads: ``rows`` states of 2^n
    amplitudes (1, a batch of B, or P sweep points) held as one flat tensor
    of ``rows * S`` shards, the op tables ``consts`` (the engine's
    registry, or a sweep's ``[P * V, ...]`` stacks, point ``p``'s variants
    at rows ``p * V ...``), and the shm operand lists built from them."""

    rows: int
    consts: Dict[int, torch.Tensor]
    sweep: bool = False
    members: Dict[int, List] = field(default_factory=dict)


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
        self.S = 1 << (G + R)
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

    # ------------------------------------------------------------ indices
    def _device_index(self, key: tuple, make: Callable[[], np.ndarray]) -> torch.Tensor:
        t = self._indices.get(key)
        if t is None:
            t = torch.from_numpy(np.ascontiguousarray(make(), dtype=np.int32))
            t = t.to(self.engine.device)
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
        U = self.S * (ps.rows if ps.sweep else 1)
        built = ps.members.get(op.uid)
        if built is None:
            def select(m: Op) -> torch.Tensor:
                T = ps.consts[m.uid]
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
        total = ps.rows * self.S
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
        from .statevector import simulate

        eng = self.engine
        psi = simulate(eng.bound_circuit, psi0=state, dtype=eng.dtype, device=eng.device)
        return psi if apply_final else to_frame(psi, eng.measurement_frame)


BACKENDS: Dict[str, Callable[[], Backend]] = {
    "cuda": CudaBackend,
    "dense": DenseBackend,
}


# ======================================================================
# The engine
# ======================================================================


class ExecutionEngine:
    """Staged executor: one stage loop, one constant registry, one public
    API. ``device`` defaults to CUDA (raises when it is absent); pass
    ``device="cpu"`` to run on the CPU. ``backend``: ``"cuda"`` (the
    planned path, on whichever device) or ``"dense"`` (the per-gate
    oracle)."""

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
        self.provenance: Dict = {}
        self.cc: CompiledCircuit = (
            compiled if compiled is not None
            else compile_plan(circuit, plan, dtype=self.np_dtype, peephole=peephole))
        self.n, self.L, self.R, self.G = self.cc.n, self.cc.L, self.cc.R, self.cc.G
        self.bound_circuit: Optional[Circuit] = circuit if circuit.is_bound else None
        self.bind_count = 0
        # per-entry-point wall times (count/total/last/max in us)
        self.timings: Dict[str, Dict[str, float]] = {}
        self._struct_cache: Dict = {}  # binding-independent build artifacts
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
    def stage_loop(self, x, ops_fn, remap_fn, apply_final: bool = True):
        """The stage loop: ``ops_fn(x, prog)`` applies one stage's op list;
        ``remap_fn(x, slot, spec)`` applies one inter-stage remap, where
        ``slot`` is ``"init"``, the stage index, or ``"final"``."""
        cc = self.cc
        if cc.initial_remap is not None:
            x = remap_fn(x, "init", cc.initial_remap)
        for i, prog in enumerate(cc.programs):
            x = ops_fn(x, prog)
            if prog.remap_after is not None:
                x = remap_fn(x, i, prog.remap_after)
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

    # ---------------------------------------------------------------- api
    def run(self, psi0=None, params=None) -> torch.Tensor:
        """psi0: flat [2^n] in logical order (defaults to |0..0>). Returns
        the final flat state in logical order, on the engine's device.
        ``params`` rebinds first: a tensor swap, never a re-plan."""
        with self.lock:
            if params is not None:
                self.bind(params)
            self._require_bound()
            return self._timed("run", lambda: self.backend.execute(
                self.backend.prepare(psi0), True))

    def run_packed(self, psi0=None, params=None) -> torch.Tensor:
        """Run but skip the final inter-stage remap: the state stays in the
        last stage's physical layout (lazy flips pending). Pair with
        :attr:`measurement_frame` and :mod:`repro_torch.sim.measure`."""
        with self.lock:
            if params is not None:
                self.bind(params)
            self._require_bound()
            return self._timed("run_packed", lambda: self.backend.execute(
                self.backend.prepare(psi0), False))

    def run_batch(self, psi0s, apply_final: bool = True) -> torch.Tensor:
        """Run a batch of initial states ``psi0s: [B, 2^n]`` (any B).
        Returns ``[B, 2^n]`` in logical order, or in the last stage's
        physical layout when ``apply_final=False`` (measure each element
        with :func:`repro_torch.sim.measure.measure_batch`)."""
        with self.lock:
            self._require_bound()
            return self._timed("run_batch", lambda: self.backend.execute_batch(
                self.backend.prepare(psi0s, batch=True), apply_final))

    def run_sweep(self, psi0, params_batch, apply_final: bool = True) -> torch.Tensor:
        """Run ONE initial state against a batch of parameter bindings.

        ``params_batch``: a ``[P, n_params]`` array (columns ordered by
        :attr:`param_names`) or a list of ``{name: value}`` dicts. The P
        points' tensor tables are built on the host in one pass (no
        re-planning) and the ``cuda`` backend runs them all at once: every
        op is one launch over ``P * 2^(G+R)`` shards. The ``dense`` backend
        rebinds point by point. Returns ``[P, 2^n]`` in logical order (or
        packed when ``apply_final=False``); the engine's own binding is
        left as it was by the fused path."""
        points = self._sweep_points(params_batch)
        if not points:
            raise ValueError("empty params_batch")
        with self.lock:
            if self.backend.supports_fused_sweep():
                stacked = self.sweep_tables(points)
                return self._timed("run_sweep", lambda: self.backend.execute_sweep(
                    self.backend.prepare(psi0), stacked, len(points), apply_final))
            t0 = time.perf_counter()
            outs = []
            for pt in points:
                self.bind(pt)
                outs.append(self.run(psi0) if apply_final else self.run_packed(psi0))
            out = torch.stack(outs)
            self._record_time("run_sweep", (time.perf_counter() - t0) * 1e6)
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
        rows = packed.shape[0] if packed.dim() == 2 else 1
        out = apply_remap(packed.reshape(-1), self.cc.final_remap, rows)
        return out.view(packed.shape)

    @property
    def measurement_frame(self):
        from .measure import Frame

        return Frame.from_compiled(self.cc)


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


def _resolve_cost_model(cm: Optional[CostModel]) -> CostModel:
    """``cost_model=None`` means the analytic defaults
    (:data:`repro_torch.core.cost_model.DEFAULT_COST_MODEL`, the
    reference's constants): the port has no calibration of this card yet,
    so there is no measured model to resolve to. Explicit models pass
    through untouched."""
    return DEFAULT_COST_MODEL if cm is None else cm


def _placement_fingerprint(device: DeviceLike) -> Tuple:
    """Where an engine's tensors live: its device, with the index made
    explicit. Engines on two devices never share a cache entry."""
    dev = torch.device("cuda" if device is None else device)
    index = dev.index
    if index is None and dev.type == "cuda":
        index = torch.cuda.current_device() if torch.cuda.is_available() else 0
    return (dev.type, index)


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


def _no_storage(storage) -> None:
    if storage is not None:
        raise ValueError("storage= is the host-offload shard store, which the port "
                         "does not have yet")


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
    _pre_optimized: bool = False,
    **plan_kw,
) -> CircuitKey:
    """The exact :class:`CircuitKey` :func:`engine_for` uses for these
    arguments. With ``optimize`` on, the key covers the OPTIMIZED circuit's
    structure and the optimizer's fingerprint (``_pre_optimized=True``: the
    circuit already is the optimizer's output). The device is part of the
    key."""
    _no_storage(storage)
    ocfg = copt.resolve_config(optimize)
    if ocfg is not None and not _pre_optimized:
        circuit = copt.optimize_circuit(circuit, ocfg).circuit
    return CircuitKey.make(
        circuit, L, R, G, backend=backend, use_kernels=use_kernels, peephole=peephole,
        staging_method=staging_method, kernelize_method=kernelize_method,
        cost_model=cost_model, optimize=ocfg,
        extra=(tuple(sorted((k, _canon(v)) for k, v in plan_kw.items())),
               _placement_fingerprint(device)),
    )


# ======================================================================
# Planning rungs and the build
# ======================================================================


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
) -> ExecutionEngine:
    """Compile ``plan`` and build an engine on it. A typed ``compile_plan``
    failure gets ONE retry (then it propagates). Nothing else degrades: a
    backend or a kernel that fails to build raises, so a run never lands on
    another backend, the CPU, or the kernels' plain versions unasked."""
    prov: Dict = provenance if provenance is not None else {}
    cc = None
    for attempt in range(2):
        try:
            cc = compile_plan(circuit, plan, dtype=np.complex64, peephole=peephole)
            break
        except FaultError as e:
            if attempt:
                raise
            _record_fallback(prov, "compile", "compile(retry)", e)
    eng = ExecutionEngine(circuit, plan, use_kernels, device, backend=backend,
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
    engine's device is part of the key. ``storage`` (host offload) is not
    ported yet and raises."""
    _no_storage(storage)
    device = resolve_device(device)
    ocfg = copt.resolve_config(optimize)
    if plan is not None:
        if ocfg is not None:
            raise ValueError("engine_for: optimize= cannot be combined with an explicit "
                             "plan (the plan was computed for the literal circuit)")
        return build_engine(circuit, plan, backend=backend, use_kernels=use_kernels,
                            peephole=peephole, device=device)
    source_circuit = circuit
    opt_result = None
    if ocfg is not None:
        opt_result = copt.optimize_circuit(circuit, ocfg)
        circuit = opt_result.circuit
    explicit_cm = cost_model is not None
    cost_model = _resolve_cost_model(cost_model)
    key = circuit_key_for(
        circuit, L, R, G, backend=backend, use_kernels=use_kernels, peephole=peephole,
        staging_method=staging_method, kernelize_method=kernelize_method,
        cost_model=cost_model, optimize=optimize, device=device, _pre_optimized=True,
        **plan_kw)
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
                                   peephole=peephole, device=device, provenance=prov)
                eng.provenance["calibration"] = {
                    "source": "explicit" if explicit_cm else "analytic defaults"}
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
                # and scales resolve; the current binding is untouched
                eng.circuit = circuit
    if not same_structure:
        # an aliased engine in another circuit space: never rebind across
        # structures; build fresh, un-cached
        return engine_for(
            source_circuit, L, R, G, backend=backend, use_kernels=use_kernels,
            peephole=peephole, staging_method=staging_method,
            kernelize_method=kernelize_method,
            cost_model=cost_model if explicit_cm else None, optimize=optimize, cache=None,
            device=device, **plan_kw)
    return eng
