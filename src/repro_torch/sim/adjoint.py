"""Adjoint-mode gradients: every parameter's gradient from one reverse walk
over the gate list.

The twin of ``repro/sim/adjoint.py``. For ``E(θ) = <ψ(θ)|H|ψ(θ)>``:

    |ψ⟩  = U_N … U_1 |ψ_0⟩                (the engine's forward run)
    |λ⟩  = H |ψ⟩                          (the observable as a Pauli op stream)
    for k = N … 1:
        |ψ⟩ ← U_k† |ψ⟩                    (now ψ = ψ_{k-1})
        ∂E/∂θ ⊇ scale · 2·Re ⟨λ| ∂U_k |ψ⟩  (the gate-generator rule, per slot)
        |λ⟩ ← U_k† |λ⟩

The sweep walks the gate list, not the compiled op stream: a fused tensor
erases the per-gate boundaries the generator rule contracts through. Every
application (``U_k†``, ``∂U_k``, each Pauli op) is one call of the per-gate
apply :func:`apply_gate_`: the hand-written ``fused_apply`` kernel on the
state viewed as shards of ``2^n`` amplitudes (one shard a row), or with
``use_kernels=False`` its plain version. ψ and λ are updated in place and
``μ = ∂U_k ψ`` is computed in one scratch state, so the sweep holds three
states: 24 GiB of complex64 at n=30, and ``3·P`` states for a batch of P
bindings, which runs every application as one launch for all P rows.

Structure and binding are split as in the engine: the gate wiring and the
symbolic-slot wiring (``Gate.param_slots``) are fixed per program, and the
per-binding tables ``U_k†`` / ``∂U_k/∂slot`` come from the numpy pass
:meth:`AdjointProgram.tensors`, so a rebind builds no new program.

:class:`ShardedAdjointProgram` is the same sweep on the shardmap backend's
bit-mesh, where each rank holds one ``2^L`` shard and no rank the state. It
walks the forward plan's stages backwards in their own stored frames: the
forward run stops before its final remap, λ is built in the last stage's
frame, each stage's gates are undone on the rank's shard (every ``U_k†``
and ``∂U_k`` one ``fused_apply`` launch at the variant the rank's device
bits select), and ψ and λ go back to the previous stage through the
inverse of the remap between them (:meth:`RemapSpec.inverse`, the same
choreography). The partial sums of every rank meet in one all-reduce.

:func:`adjoint_gradients_np` and its helpers are the reference's complex128
numpy oracle, copied unchanged.
"""

from __future__ import annotations

import time
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core import gates as G
from ..core.circuit import Circuit
from ..core.gates import UnboundParameterError
from ..device import DeviceLike, resolve_device
from ..kernels import ops as kops
from ..kernels import ref as kref
from .apply import specialize_gate
from .measure import Frame, PauliSum, apply_pauli_sum, pauli_sum_ops

if TYPE_CHECKING:
    from .engine import ShardMapBackend


def apply_gate_(x: torch.Tensor, u: torch.Tensor, vidx: torch.Tensor, bits: Sequence[int],
                n: int, use_kernels: bool = True) -> torch.Tensor:
    """In place: row ``r`` of the flat state ``x`` (``[rows * 2^n]``, each row
    a logical-order state) gets ``u[vidx[r]]`` (complex64 ``[V, 2^k, 2^k]``)
    applied on qubits ``bits`` (matrix index bit ``j`` binds to ``bits[j]``,
    as for a gate's ``qubits``). Each row is one shard of ``2^n`` amplitudes
    for ``fused_apply``, so one call is one launch for all rows; with
    ``use_kernels=False`` the kernel's plain version runs instead."""
    apply = kops.fused_apply if use_kernels else kref.fused_apply_ref
    return apply(x, u, vidx, bits, n)


class AdjointProgram:
    """The reverse sweep for ONE (circuit structure, observable) pair on one
    device.

    :meth:`value_and_grad` returns ``(E, ∂E/∂θ)`` with ``θ`` ordered by the
    structure's :attr:`Circuit.param_names`, for a forward state in logical
    order (any backend's ``run`` output). :meth:`sweep_` is the same sweep
    over ``[P, 2^n]`` states against ``P`` bindings' tables, each gate
    application one launch for all rows; it consumes its states."""

    def __init__(self, structure: Circuit, observable, device: DeviceLike = None,
                 use_kernels: bool = True):
        self.structure = structure
        self.obs = PauliSum.coerce(observable)
        if self.obs.max_qubit >= structure.n_qubits:
            raise ValueError(
                f"observable {self.obs} acts on qubit {self.obs.max_qubit}; "
                f"circuit has {structure.n_qubits} qubits"
            )
        self.device = resolve_device(device)
        self.use_kernels = use_kernels
        self.n = structure.n_qubits
        self.np_dtype = np.dtype(np.complex64)
        self.param_names: Tuple[str, ...] = structure.param_names
        self._pidx = {nm: i for i, nm in enumerate(self.param_names)}
        # static wiring: per gate (qubits, ((slot, pidx, scale), ...))
        self._gates = [
            (g.qubits, tuple((s, self._pidx[nm], sc) for s, nm, sc in g.param_slots))
            for g in structure.gates
        ]
        self.n_params = len(self.param_names)

    # ------------------------------------------------------------ binding
    def tensors(self, bound: Circuit):
        """The parameter-binding pass (pure numpy): ``(inv, d)`` tensor
        tuples for one fully-bound same-structure circuit — ``inv[k]`` is
        gate k's ``U†``, ``d`` holds one ``∂U/∂slot`` per symbolic slot in
        gate order."""
        self._check_bound(bound)
        inv = tuple(
            g.inverse_matrix.astype(self.np_dtype) for g in bound.gates
        )
        d: List[np.ndarray] = []
        for k, (_, wires) in enumerate(self._gates):
            for slot, _, _ in wires:
                d.append(bound.gates[k].adjoint_generator(slot)
                         .astype(self.np_dtype))
        return inv, tuple(d)

    def _check_bound(self, bound: Circuit) -> None:
        if not bound.is_bound:
            raise UnboundParameterError(
                f"adjoint tensors need a bound circuit; free params "
                f"{bound.param_names}"
            )
        if bound.structure_fingerprint() != self.structure.structure_fingerprint():
            raise ValueError("bound circuit does not match this program's "
                             "compiled structure")

    def stacked_tensors(self, bounds: Sequence[Circuit]):
        """Per-binding :meth:`tensors` stacked along a leading axis (``[P,
        2^k, 2^k]`` each) for a batched :meth:`sweep_`."""
        per = [self.tensors(b) for b in bounds]
        inv = tuple(np.stack([p[0][k] for p in per])
                    for k in range(len(per[0][0])))
        d = tuple(np.stack([p[1][j] for p in per])
                  for j in range(len(per[0][1])))
        return inv, d

    def _upload(self, mats: Sequence[np.ndarray], rows: int) -> List[torch.Tensor]:
        """The tables on the device as ``[rows, 2^k, 2^k]`` tensors: one
        upload per width k, each table a contiguous slice of it."""
        out: List[Optional[torch.Tensor]] = [None] * len(mats)
        by_k: Dict[int, List[int]] = {}
        for i, m in enumerate(mats):
            by_k.setdefault(m.shape[-1], []).append(i)
        for K, idx in by_k.items():
            block = np.ascontiguousarray(np.stack([mats[i].reshape(rows, K, K) for i in idx]))
            dev = kops.to_device(block, self.device)
            for j, i in enumerate(idx):
                out[i] = dev[j]
        return out

    # -------------------------------------------------------------- sweep
    def sweep_(self, states: torch.Tensor, inv: Sequence[np.ndarray],
               d: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
        """The reverse sweep over ``states`` (``[P, 2^n]`` complex64 on the
        program's device, contiguous; updated in place and left holding the
        initial states) against the tables of P bindings (:meth:`tensors`
        for P=1, else :meth:`stacked_tensors`). Returns ``(values [P],
        grads [P, n_params])`` as float64 numpy, after one host sync."""
        P = states.shape[0]
        if states.dim() != 2 or states.shape[1] != 1 << self.n:
            raise ValueError(f"states of shape {tuple(states.shape)}, expected [P, 2^{self.n}]")
        if states.device.type != self.device.type or states.dtype != torch.complex64:
            raise ValueError(f"states must be complex64 on {self.device}")
        n, use = self.n, self.use_kernels
        psi = states.view(-1)
        vidx = kops.to_device(np.arange(P, dtype=np.int32), self.device)
        lam = apply_pauli_sum(states, self.obs, use_kernels=use)
        value = torch.stack([torch.vdot(states[r], lam[r]).real for r in range(P)])
        # gradients accumulate in float64 on the device (the reference adds
        # float32 terms): the float32 inner products are what bound them
        grads = torch.zeros((P, self.n_params), dtype=torch.float64, device=self.device)
        if self.n_params:
            inv_t = self._upload(inv, P)
            d_t = self._upload(d, P)
            mu = torch.empty_like(states)
            di = len(d_t)
            for k in range(len(self._gates) - 1, -1, -1):
                qubits, wires = self._gates[k]
                apply_gate_(psi, inv_t[k], vidx, qubits, n, use)   # ψ_{k-1}
                for slot, pidx, scale in reversed(wires):
                    di -= 1
                    mu.copy_(states)
                    apply_gate_(mu.view(-1), d_t[di], vidx, qubits, n, use)  # ∂U_k ψ_{k-1}
                    g = torch.stack([torch.vdot(lam[r], mu[r]).real for r in range(P)])
                    grads[:, pidx].add_(g.double(), alpha=2.0 * scale)
                apply_gate_(lam.view(-1), inv_t[k], vidx, qubits, n, use)  # λ_{k-1}
        return (value.double().cpu().numpy(), grads.cpu().numpy())

    # ---------------------------------------------------------------- api
    def value_and_grad(self, psi, bound: Circuit) -> Tuple[float, np.ndarray]:
        """``(E, ∂E/∂θ)`` for the forward state ``psi`` (flat ``[2^n]``,
        logical order) of ``bound``; ``psi`` itself is left as it was."""
        x = torch.as_tensor(psi).to(device=self.device, dtype=torch.complex64)
        x = x.reshape(1, -1).clone()
        values, grads = self.sweep_(x, *self.tensors(bound))
        return float(values[0]), grads[0]


_PAULI = {"X": G.X, "Y": G.Y, "Z": G.Z}


class ShardedAdjointProgram(AdjointProgram):
    """:class:`AdjointProgram`'s sweep on one rank of the shardmap backend
    (``backend``, set up by its engine): the rank's ``2^L`` shard in, the
    whole state's ``(E, ∂E/∂θ)`` out, the same on every rank.

    The forward run ends in the last stage's stored frame (``run_packed``:
    its layout, lazy flips pending). From there the sweep walks the stages
    backwards. In stage ``s``'s frame every gate's non-insular qubits are
    local, so gate ``k`` acts on the shard as the local block its device
    bits select: ``U_k`` restricted to the rank's values of those bits
    (stored bit XOR the flip pending before ``k``), which is what the
    forward applied, with an anti-diagonal device bit leaving the data in
    place and toggling its flip. So ``U_k†`` is that block's adjoint and
    ``∂U_k`` the same restriction of ``∂U_k/∂slot``; a gate whose qubits are
    all on device bits is a per-rank scalar, applied as that scalar times
    the identity on local bit 0. Between stages ψ and λ go through the
    inverse of the forward remap (which leaves each exactly as the forward
    held it at the end of the earlier stage, flips included).

    Within a stage the gates run in circuit order, the order the compiler
    derived their flips in. The staging may move commuting insular gates
    across stages; the walk's order is then not the circuit's, but the
    product of the gates is the same for every angle of every slot, so its
    derivative in each slot is too, and the adjoint rule holds for it.

    The structural schedule (each gate's local bits and the rank's variant,
    the inverse remaps' :class:`RemapPlan`, the observable's per-rank
    form) is built here, once per (structure, observable); :meth:`tensors`
    makes a binding's tables on the host. Partial sums are taken in float64
    on the rank and summed over the ranks by one all-reduce at the end.
    ``last_sweep`` holds the last sweep's figures on this rank: the seconds
    of λ, of the gate applications and of the remaps, and the bytes the
    rank sent and received (remaps and λ's permutes)."""

    def __init__(self, structure: Circuit, observable, backend: "ShardMapBackend"):
        from .engine import _build_remap_plan

        eng = backend.engine
        super().__init__(structure, observable, device=eng.device, use_kernels=eng.use_kernels)
        self.backend, self.rank, self.L = backend, backend.rank, eng.L
        n, L, cc = self.n, self.L, eng.cc
        self._vidx = kops.to_device(np.zeros(1, dtype=np.int32), self.device)
        # per stage: its gates as the rank applies them, and the plan taking
        # ψ and λ back to the stage before
        self._stages = []
        for si, (st, prog) in enumerate(zip(eng.plan.stages, cc.programs)):
            phys_of = {q: p for p, q in enumerate(prog.layout)}
            flips: Dict[int, int] = {}
            walk = []
            for gid in sorted(st.gate_ids):
                g = structure.gates[gid]
                nl = tuple(j for j, q in enumerate(g.qubits) if phys_of[q] >= L)
                values = tuple(((self.rank >> (phys_of[g.qubits[j]] - L)) & 1)
                               ^ flips.get(g.qubits[j], 0) for j in nl)
                bits = tuple(phys_of[q] for q in g.qubits if phys_of[q] < L)
                walk.append((gid, nl, values, bits or (0,), not bits))
                if nl:  # the compiler's flip schedule (compile_plan, pass 1)
                    for j in specialize_gate(g.structural_matrix, nl, [0] * len(nl))[1]:
                        flips[g.qubits[j]] = flips.get(g.qubits[j], 0) ^ 1
            undo = (None if si == 0 else
                    _build_remap_plan(cc.programs[si - 1].remap_after.inverse(), n, L,
                                      pair_by_target=True))
            self._stages.append((walk, undo))
        # H in the last stage's stored frame, per term: the factor on this
        # rank (coefficient, device-bit phases and signs), the device bits
        # whose X/Y sends the shard to rank ^ mask, and the local 2x2 ops
        frame = Frame.from_compiled(cc)
        phys_of, flipped = frame.phys_of, set(frame.flip_bits)
        self._terms = []
        for t in self.obs.terms:
            per_bit: Dict[int, np.ndarray] = {}
            for q, p in t.ops:  # applied in order: a later op multiplies from the left
                b = phys_of[q]
                m = _PAULI[p] if b not in flipped else G.X @ _PAULI[p] @ G.X
                per_bit[b] = m @ per_bit.get(b, np.eye(2))
            factor, mask, local = complex(t.coeff), 0, []
            for b, m in sorted(per_bit.items()):
                if b < L:
                    local.append((b, kops.to_device(m.astype(np.complex64).reshape(1, 2, 2),
                                                    self.device)))
                    continue
                v = (self.rank >> (b - L)) & 1
                if abs(m[v, v]) > 0:
                    factor *= complex(m[v, v])
                else:  # anti-diagonal: the amplitude comes from the other value
                    factor *= complex(m[v, 1 - v])
                    mask |= 1 << (b - L)
            self._terms.append((factor, mask, tuple(local)))
        self.pauli_launches = sum(len(local) for _, _, local in self._terms)
        self.last_sweep: Dict[str, float] = {}

    def sweep_bytes_bound(self) -> int:
        """The most bytes this rank sends, or receives, in one sweep: twice
        the forward run's remaps by Eq. 2 (``(1 - 2^-m)`` of a shard in the
        all-to-all, the shard in a permute), one shard for each Pauli term
        with X or Y on device bits, and the float64 value and gradient."""
        shard = 8 << self.L
        fwd = sum((shard - (shard >> rp.m) if rp.m else 0) + (shard if rp.ppermute else 0)
                  for slot, rp in self.backend._plans.items() if slot != "final")
        permutes = sum(1 for _, mask, _ in self._terms if mask)
        return 2 * fwd + shard * permutes + 8 * (1 + self.n_params)

    # ------------------------------------------------------------ binding
    def tensors(self, bound: Circuit):
        """The rank's tables for one fully-bound same-structure circuit, in
        the order the sweep consumes them: ``inv`` one block ``U†`` per gate
        and ``d`` one block ``∂U/∂slot`` per symbolic slot, stages last to
        first, gates and slots last to first."""
        self._check_bound(bound)
        inv: List[np.ndarray] = []
        d: List[np.ndarray] = []
        for walk, _ in reversed(self._stages):
            for gid, nl, values, _, scalar in reversed(walk):
                g = bound.gates[gid]
                inv.append(self._block(g.matrix, g, nl, values, scalar).conj().T)
                for slot, _, _ in reversed(self._gates[gid][1]):
                    d.append(self._block(g.adjoint_generator(slot), g, nl, values, scalar))
        return tuple(inv), tuple(d)

    def _block(self, mat: np.ndarray, g, nl, values, scalar: bool) -> np.ndarray:
        """``mat`` (one of gate ``g``'s ``2^k x 2^k`` matrices) as the rank
        applies it: restricted to the rank's values of the device bits
        ``nl``, branch-classified by the structural matrix as the compiler
        does; a scalar as that scalar on one local bit."""
        if nl:
            mat = specialize_gate(mat, nl, values, classify=g.structural_matrix)[0]
        if scalar:
            mat = mat[0, 0] * np.eye(2)
        return np.ascontiguousarray(mat, dtype=self.np_dtype)

    # -------------------------------------------------------------- sweep
    def _apply_obs(self, psi: torch.Tensor) -> torch.Tensor:
        """``H|ψ⟩`` on this rank's shard in the last stage's frame: a term
        with X/Y on device bits reads the shard of rank ``rank ^ mask`` (one
        permute), its local ops are ``fused_apply`` launches, its device
        Y/Z a per-rank factor. Holds ψ, the sum and one working shard."""
        L, use, tr = self.L, self.use_kernels, self.backend.transport
        acc = torch.zeros_like(psi)
        work = None
        for factor, mask, local in self._terms:
            if not mask and not local:
                acc.add_(psi, alpha=factor)
                continue
            if work is None:
                work = torch.empty_like(psi)
            if mask:
                peer = self.rank ^ mask
                tr.permute(psi, peer, peer, work)
            else:
                work.copy_(psi)
            for b, u in local:
                apply_gate_(work, u, self._vidx, (b,), L, use)
            acc.add_(work, alpha=factor)
        return acc

    def sweep_(self, states: torch.Tensor, inv: Sequence[np.ndarray],
               d: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
        """The reverse sweep over this rank's shard ``states`` (``[1, 2^L]``
        complex64, the forward run's ``run_packed`` output; consumed) with
        the rank's tables (:meth:`tensors`). Returns the whole state's
        ``(values [1], grads [1, n_params])`` as float64 numpy, the same on
        every rank. Each inverse remap is recorded in the backend's
        ``trace`` under the slot ``"undo <s> psi"`` / ``"undo <s> lam"``,
        ``s`` the forward remap it undoes."""
        from .collective import COLLECTIVE_CALLS
        from .engine import _sync

        L, use, be = self.L, self.use_kernels, self.backend
        if states.dim() != 2 or tuple(states.shape) != (1, 1 << L):
            raise ValueError(f"states of shape {tuple(states.shape)}, expected [1, 2^{L}]: "
                             "one rank's shard of one state")
        if states.device.type != self.device.type or states.dtype != torch.complex64:
            raise ValueError(f"states must be complex64 on {self.device}")
        psi = states.view(-1)
        sent, received = COLLECTIVE_CALLS["bytes_sent"], COLLECTIVE_CALLS["bytes_received"]
        t0 = time.perf_counter()
        lam = self._apply_obs(psi)
        part = torch.zeros(1 + self.n_params, dtype=torch.float64, device=self.device)
        part[0] = torch.vdot(psi, lam).real.double()
        _sync(self.device)
        t1 = time.perf_counter()
        remap_s = 0.0
        if self.n_params:
            inv_t = self._upload(inv, 1)
            d_t = self._upload(d, 1)
            vidx, ii, di, mu = self._vidx, 0, 0, None
            for si in range(len(self._stages) - 1, -1, -1):
                walk, undo = self._stages[si]
                for gid, _, _, bits, _ in reversed(walk):
                    apply_gate_(psi, inv_t[ii], vidx, bits, L, use)   # ψ_{k-1}
                    for _, pidx, scale in reversed(self._gates[gid][1]):
                        if mu is None:
                            mu = torch.empty_like(psi)
                        mu.copy_(psi)
                        apply_gate_(mu, d_t[di], vidx, bits, L, use)  # ∂U_k ψ_{k-1}
                        part[1 + pidx] += torch.vdot(lam, mu).real.double() * (2.0 * scale)
                        di += 1
                    apply_gate_(lam, inv_t[ii], vidx, bits, L, use)   # λ_{k-1}
                    ii += 1
                if undo is not None:
                    mu = None  # a remap's buffer takes its place
                    # ψ goes back into its own buffer (one device copy): the
                    # caller's frame still holds the forward state, so a new
                    # ψ would be a fourth shard
                    psi.copy_(be.remap(psi, f"undo {si - 1} psi", reuse=True, rp=undo))
                    lam = be.remap(lam, f"undo {si - 1} lam", reuse=True, rp=undo)
                    remap_s += be.trace[-2]["seconds"] + be.trace[-1]["seconds"]
        _sync(self.device)
        t2 = time.perf_counter()
        total = be.transport.all_reduce_sum(part).cpu().numpy()
        self.last_sweep = {"lambda_s": t1 - t0, "kernels_s": t2 - t1 - remap_s,
                           "remaps_s": remap_s,
                           "bytes_sent": COLLECTIVE_CALLS["bytes_sent"] - sent,
                           "bytes_received": COLLECTIVE_CALLS["bytes_received"] - received}
        return total[:1], total[1:].reshape(1, -1)


# ======================================================================
# complex128 oracle (pure numpy — the reference the tests diff against)
# ======================================================================


def _np_apply(view: np.ndarray, mat: np.ndarray, qubits: Sequence[int]) -> np.ndarray:
    n = view.ndim
    k = len(qubits)
    mat_t = np.asarray(mat, dtype=np.complex128).reshape((2,) * (2 * k))
    state_axes = [n - 1 - b for b in qubits]
    in_axes = [2 * k - 1 - j for j in range(k)]
    out = np.tensordot(mat_t, view, axes=(in_axes, state_axes))
    dest = [state_axes[k - 1 - i] for i in range(k)]
    return np.moveaxis(out, list(range(k)), dest)


def _np_apply_pauli_sum(view: np.ndarray, obs) -> np.ndarray:
    acc = np.zeros_like(view)
    for coeff, ops in pauli_sum_ops(obs):
        w = view
        for q, mat in ops:
            w = _np_apply(w, mat, [q])
        acc = acc + coeff * w
    return acc


def adjoint_gradients_np(
    structure: Circuit,
    params: Union[Dict[str, float], Sequence[float], None],
    observable,
    psi0: Optional[np.ndarray] = None,
) -> Tuple[float, np.ndarray]:
    """float64 gate-level adjoint oracle: ``(E, ∂E/∂θ)`` in complex128.

    Same sweep as :class:`AdjointProgram` but pure numpy at full precision —
    the reference both for the engine's f32 gradients and for the
    finite-difference cross-checks in ``tests/test_grad.py``."""
    bound = structure.bind(params) if not structure.is_bound or params is not None \
        else structure
    n = structure.n_qubits
    names = structure.param_names
    pidx = {nm: i for i, nm in enumerate(names)}
    if psi0 is None:
        psi = np.zeros(1 << n, dtype=np.complex128)
        psi[0] = 1.0
    else:
        psi = np.asarray(psi0, dtype=np.complex128).reshape(-1)
    v = psi.reshape((2,) * n)
    for g in bound.gates:
        v = _np_apply(v, g.matrix, g.qubits)
    lam = _np_apply_pauli_sum(v, observable)
    value = float(np.real(np.vdot(v.reshape(-1), lam.reshape(-1))))
    grads = np.zeros(len(names), dtype=np.float64)
    for k in range(len(bound.gates) - 1, -1, -1):
        g = bound.gates[k]
        v = _np_apply(v, g.inverse_matrix, g.qubits)
        for slot, nm, scale in structure.gates[k].param_slots:
            mu = _np_apply(v, g.adjoint_generator(slot), g.qubits)
            grads[pidx[nm]] += scale * 2.0 * float(
                np.real(np.vdot(lam.reshape(-1), mu.reshape(-1)))
            )
        lam = _np_apply(lam, g.inverse_matrix, g.qubits)
    return value, grads
