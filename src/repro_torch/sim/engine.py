"""Execution engine: the planned statevector path on one device.

The twin of ``repro/sim/engine.py`` for the meshless single-device case:

* :class:`ExecutionEngine` owns the compiled program
  (:class:`repro_torch.sim.compile.CompiledCircuit`), the op-tensor
  **constant registry** keyed by the stable ``Op.uid``, the **stage loop**
  (initial remap -> per-stage ops + remap -> optional final remap) and the
  public ``bind`` / ``run`` / ``run_packed`` / ``measurement_frame`` API;
* :class:`CudaBackend` holds the packed ``[2^G, 2^R, 2^L]`` state as one
  flat tensor on the device (index bit ``p`` = physical bit ``p``) and
  applies each stage's ops and each remap to it.

With ``use_kernels`` (the default) every ``fused`` op goes to the
hand-written ``fused_apply`` kernel and every ``shm`` group to
``shm_apply``, one launch each (on the CPU the wrappers run their plain
versions); ``diag``/``scalar`` ops and remaps are plain tensor code. With
``use_kernels=False`` the engine runs the reference's non-kernel path: every
op, and every member of an shm group, as tensor code. Ops update the state
in place; a remap writes one new state, so a run holds at most two states.

Not in this module yet: the compile cache, host offload, the multi-device
backends, adjoint gradients and the fault-degradation ladder.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.circuit import Circuit
from ..core.gates import UnboundParameterError
from ..core.partition import SimulationPlan
from ..device import DeviceLike, resolve_device
from ..kernels import ops as kops
from .apply import apply_matrix_bits, mul_bits_, permute_bits
from .compile import CompiledCircuit, Op, RemapSpec, StageProgram, bind_tensors, compile_plan


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
    ``vidx_of(op)`` its per-shard variant index, or None for variant 0. An
    shm group applies its members in order."""
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


def apply_remap(x: torch.Tensor, spec: RemapSpec) -> torch.Tensor:
    """Full bit permutation of the flat state (flips first, on the old
    bits), as one new tensor."""
    return permute_bits(x, spec.src_bit_of, spec.flip_bits)


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


# ======================================================================
# Backend
# ======================================================================


class CudaBackend:
    """The packed state as one flat tensor on one device (CUDA, or the CPU
    when asked for): the single-device twin of the reference's meshless
    ``PjitBackend``. Eager: ops run as they are dispatched."""

    def setup(self, engine: "ExecutionEngine") -> None:
        self.engine = engine
        G, R, L = engine.G, engine.R, engine.L
        self.S = 1 << (G + R)
        dev = engine.device
        self._all_shards = torch.arange(self.S, dtype=torch.int32, device=dev)
        self._vidx: Dict[int, Optional[torch.Tensor]] = {}
        for prog in engine.cc.programs:
            for op in prog.ops:
                for o in (op,) + op.gates:
                    idx = _dep_index(o, G, R, L)
                    if (idx is not None and o.tensor.size
                            and o.tensor.shape[0] not in (1, 1 << len(o.dep_bits))):
                        raise ValueError(f"op {o.uid}: {o.tensor.shape[0]} variants for "
                                         f"{len(o.dep_bits)} dep bits")
                    self._vidx[o.uid] = None if idx is None else torch.from_numpy(idx).to(dev)
        self._members: Dict[int, List] = {}

    def on_rebind(self) -> None:
        self._members.clear()  # operands derived from tensor values

    # ------------------------------------------------------------ ops
    def vidx(self, op: Op) -> Optional[torch.Tensor]:
        """Per-shard variant index, or None when every shard uses variant 0."""
        idx = self._vidx[op.uid]
        if idx is not None and self.engine.consts[op.uid].shape[0] == 1:
            return None
        return idx

    def kernel_vidx(self, op: Op) -> torch.Tensor:
        """Per-shard variant index as the fused kernel takes it (int32 [S])."""
        idx = self.vidx(op)
        return idx if idx is not None else torch.zeros_like(self._all_shards)

    def _select(self, m: Op) -> torch.Tensor:
        """[S, ...] per-shard tensor of one shm member."""
        T = self.engine.consts[m.uid]
        idx = self.vidx(m)
        if idx is not None:
            return T[idx.long()]
        return T[:1].expand((self.S,) + tuple(T.shape[1:]))

    def shm_members(self, op: Op) -> List:
        """The ``(kind, bits, operand, vidx)`` list the shm kernel takes for
        one group (cached until the next bind). Scalars fold into the first
        operand, as in the reference; the folded operands are per shard."""
        mem = self._members.get(op.uid)
        if mem is None:
            gate_list, scal = _shm_operands(op, self._select)
            if not gate_list:  # only scalars: one 0-bit diagonal member
                gate_list = [((), scal.reshape(self.S, 1))]
            mem = [("mat" if T.dim() == 3 else "diag", tuple(bits),
                    T.contiguous(), self._all_shards)
                   for bits, T in gate_list]
            self._members[op.uid] = mem
        return mem

    def apply_ops(self, x: torch.Tensor, prog: StageProgram) -> torch.Tensor:
        eng = self.engine
        L = eng.L
        for op in prog.ops:
            if eng.use_kernels and op.kind == "fused":
                kops.fused_apply(x, eng.consts[op.uid], self.kernel_vidx(op), op.local_bits, L)
            elif eng.use_kernels and op.kind == "shm":
                kops.shm_apply(x, op.local_bits, self.shm_members(op), L)
            else:
                apply_op(x, op, L, eng.consts, self.vidx)
        return x

    def remap(self, x: torch.Tensor, slot, spec: RemapSpec) -> torch.Tensor:
        return apply_remap(x, spec)

    # ------------------------------------------------------------ api
    def prepare(self, psi0=None) -> torch.Tensor:
        eng = self.engine
        if psi0 is None:
            x = torch.zeros(1 << eng.n, dtype=eng.dtype, device=eng.device)
            x[0] = 1.0
            return x
        x = torch.as_tensor(psi0).to(device=eng.device, dtype=eng.dtype)
        x = x.reshape(-1).clone()  # the run updates its state in place
        if x.numel() != 1 << eng.n:
            raise ValueError(f"psi0 has {x.numel()} amplitudes, expected 2^{eng.n}")
        return x

    def execute(self, state: torch.Tensor, apply_final: bool = True) -> torch.Tensor:
        return self.engine.stage_loop(state, self.apply_ops, self.remap, apply_final)


# ======================================================================
# The engine
# ======================================================================


class ExecutionEngine:
    """Staged executor: one stage loop, one constant registry, one public
    API. ``device`` defaults to CUDA (raises when it is absent); pass
    ``device="cpu"`` to run on the CPU."""

    def __init__(
        self,
        circuit: Circuit,
        plan: SimulationPlan,
        use_kernels: bool = True,
        device: DeviceLike = None,
    ):
        self.circuit = circuit  # structural reference; may carry free Params
        self.plan = plan
        self.device = resolve_device(device)
        self.dtype = torch.complex64  # the kernels' type
        self.np_dtype = np.dtype(np.complex64)
        self.use_kernels = use_kernels
        self.cc: CompiledCircuit = compile_plan(circuit, plan, dtype=self.np_dtype)
        self.n, self.L, self.R, self.G = self.cc.n, self.cc.L, self.cc.R, self.cc.G
        self.bound_circuit: Optional[Circuit] = circuit if circuit.is_bound else None
        self.bind_count = 0
        self._struct_cache: Dict = {}
        # op-tensor registry, keyed by stable ``Op.uid``: one device tensor
        # per op (a leading variant axis for dep-batched ops)
        self.consts: Dict[int, torch.Tensor] = {}
        for prog in self.cc.programs:
            for op in prog.ops:
                for o in (op,) + op.gates:
                    if o.tensor.size:
                        self.consts[o.uid] = self._upload(o.tensor)
        self.backend = CudaBackend()
        self.backend.setup(self)

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
        if bound.structure_fingerprint() != self.circuit.structure_fingerprint():
            raise ValueError("bind_circuit: circuit structure does not match "
                             "this engine's compiled structure")
        table = bind_tensors(bound, self.plan, dtype=self.np_dtype, expect=self.cc,
                             struct_cache=self._struct_cache)
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
        self.consts = new
        self.backend.on_rebind()

    def _require_bound(self) -> None:
        if self.bound_circuit is None:
            raise UnboundParameterError(
                f"engine has unbound parameters {self.param_names}; call "
                "bind(params) before executing")

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
        the final flat state in logical order, on the engine's device."""
        if params is not None:
            self.bind(params)
        self._require_bound()
        return self.backend.execute(self.backend.prepare(psi0), True)

    def run_packed(self, psi0=None, params=None) -> torch.Tensor:
        """Run but skip the final inter-stage remap: the state stays in the
        last stage's physical layout (lazy flips pending). Pair with
        :attr:`measurement_frame` and :mod:`repro_torch.sim.measure`."""
        if params is not None:
            self.bind(params)
        self._require_bound()
        return self.backend.execute(self.backend.prepare(psi0), False)

    def finalize(self, packed: torch.Tensor) -> torch.Tensor:
        """Logical-order state from a ``run_packed`` result (the final remap)."""
        if self.cc.final_remap is None:
            return packed
        return apply_remap(packed, self.cc.final_remap)

    @property
    def measurement_frame(self):
        from .measure import Frame

        return Frame.from_compiled(self.cc)
