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

:func:`adjoint_gradients_np` and its helpers are the reference's complex128
numpy oracle, copied unchanged.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.circuit import Circuit
from ..core.gates import UnboundParameterError
from ..device import DeviceLike, resolve_device
from ..kernels import ops as kops
from ..kernels import ref as kref
from .measure import PauliSum, apply_pauli_sum, pauli_sum_ops


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
        if not bound.is_bound:
            raise UnboundParameterError(
                f"adjoint tensors need a bound circuit; free params "
                f"{bound.param_names}"
            )
        if bound.structure_fingerprint() != self.structure.structure_fingerprint():
            raise ValueError("bound circuit does not match this program's "
                             "compiled structure")
        inv = tuple(
            g.inverse_matrix.astype(self.np_dtype) for g in bound.gates
        )
        d: List[np.ndarray] = []
        for k, (_, wires) in enumerate(self._gates):
            for slot, _, _ in wires:
                d.append(bound.gates[k].adjoint_generator(slot)
                         .astype(self.np_dtype))
        return inv, tuple(d)

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
