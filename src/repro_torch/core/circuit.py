"""Quantum circuit IR.

(Copied from ``repro/core/circuit.py`` so this package imports nothing of the
JAX package; only imports differ, and ``is_equivalent_order`` is left
out because the pre-staging optimizer it relies on is not ported.)

A :class:`Circuit` is a sequence of :class:`Gate`\\ s over ``n_qubits`` logical
qubits. Gate qubit order convention: ``gate.qubits[j]`` is the circuit qubit
bound to *gate bit* ``j`` (bit 0 = least significant of the gate's ``2^k``
index space; controls occupy the most-significant gate bits, see
:func:`repro.core.gates.controlled`).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Set, Tuple, Union

import numpy as np

from . import gates as G
from .gates import Param, UnboundParameterError


def _coerce_param(p) -> "G.ParamValue":
    if isinstance(p, Param):
        return p
    if isinstance(p, str):
        return Param(p)
    if isinstance(p, dict):  # JSON form: {"param": name, "scale":, "shift":}
        return Param(p["param"], float(p.get("scale", 1.0)), float(p.get("shift", 0.0)))
    return float(p)


@dataclass(frozen=True)
class Gate:
    name: str
    qubits: Tuple[int, ...]  # circuit qubit per gate bit (low -> high)
    params: Tuple["G.ParamValue", ...] = ()  # floats and/or symbolic Params
    gid: int = -1  # position in the circuit sequence

    def __post_init__(self):
        if len(set(self.qubits)) != len(self.qubits):
            raise ValueError(f"duplicate qubits in gate {self.name}: {self.qubits}")

    @property
    def n_qubits(self) -> int:
        return len(self.qubits)

    @property
    def n_controls(self) -> int:
        return G.GATE_DEFS[self.name].n_controls

    @property
    def is_bound(self) -> bool:
        return not G.is_symbolic(self.params)

    @property
    def free_params(self) -> Tuple[str, ...]:
        """Names of unbound symbolic parameters, in slot order."""
        return tuple(p.name for p in self.params if isinstance(p, Param))

    def bind(self, values: Mapping[str, float]) -> "Gate":
        if self.is_bound:
            return self
        return Gate(
            self.name,
            self.qubits,
            tuple(p.resolve(values) if isinstance(p, Param) else p for p in self.params),
            gid=self.gid,
        )

    @property
    def matrix(self) -> np.ndarray:
        """Concrete unitary; raises :class:`UnboundParameterError` when the
        gate still carries symbolic params (use :attr:`structural_matrix`
        for parameter-independent structure analysis)."""
        return G.gate_matrix(self.name, self.params)

    @property
    def inverse_matrix(self) -> np.ndarray:
        """Concrete ``U†`` (unitarity: the adjoint IS the inverse). The
        reverse sweep (:mod:`repro.sim.adjoint`, ``CompiledCircuit.reverse``)
        walks gates backwards through this."""
        return self.matrix.conj().T

    def adjoint_generator(self, slot: int) -> np.ndarray:
        """Analytic ``∂U/∂params[slot]`` at this gate's bound values (the
        gate-generator rule: ``-i/2·G·U`` for rotations, target-block-only
        for controlled rotations). Chain-rule scaling for affine
        :class:`Param` slots (``scale*θ+shift``) is the CALLER's job — this
        differentiates with respect to the slot angle itself."""
        return G.gate_derivative(self.name, self.params, slot)

    @property
    def param_slots(self) -> Tuple[Tuple[int, str, float], ...]:
        """``(slot, param_name, d(slot_angle)/d(param))`` for every symbolic
        slot — the static wiring the adjoint sweep contracts gradients
        through."""
        return tuple(
            (j, p.name, p.scale)
            for j, p in enumerate(self.params) if isinstance(p, Param)
        )

    @property
    def structural_matrix(self) -> np.ndarray:
        """Matrix at generic probe angles — depends on (name) only. All
        structural predicates (insularity, diagonality, staging/compile
        classification) go through this so they are identical across
        parameter bindings."""
        return G.structural_matrix(self.name)

    @property
    def insular(self) -> Tuple[bool, ...]:
        """Per-gate-bit insularity mask (paper Def. 2). Structural: evaluated
        at generic probe angles, so it is the same for every binding (special
        concrete angles can only *shrink* the nonzero pattern, which keeps
        every insularity classification valid)."""
        return G.insular_mask(self.structural_matrix, self.n_controls)

    @property
    def non_insular_qubits(self) -> Tuple[int, ...]:
        ins = self.insular
        return tuple(q for j, q in enumerate(self.qubits) if not ins[j])

    @property
    def insular_qubits(self) -> Tuple[int, ...]:
        ins = self.insular
        return tuple(q for j, q in enumerate(self.qubits) if ins[j])

    @property
    def is_diagonal(self) -> bool:
        """Structurally diagonal (true for every binding)."""
        return G.is_diagonal(self.structural_matrix)

    def to_dict(self) -> dict:
        params = [
            {"param": p.name, "scale": p.scale, "shift": p.shift}
            if isinstance(p, Param)
            else p
            for p in self.params
        ]
        return {"name": self.name, "qubits": list(self.qubits), "params": params}


@dataclass
class Circuit:
    n_qubits: int
    gates: List[Gate] = field(default_factory=list)
    #: set by :meth:`subcircuit`: ``parent_gids[j]`` is the gid, in the
    #: parent circuit, of this circuit's gate ``j`` (local gids are
    #: renumbered consecutively — this is the map back)
    parent_gids: Optional[Tuple[int, ...]] = None

    # ------------------------------------------------------------------ build
    def add(self, name: str, *qubits: int, params: Sequence = ()) -> "Circuit":
        """Append a gate. ``params`` entries may be floats, :class:`Param`
        objects, or bare strings (coerced to ``Param(name)``).

        Raises :class:`ValueError` for a gate name outside the registry —
        a typed, self-describing error (malformed serve requests surface it
        verbatim) instead of a bare ``KeyError``.
        """
        gd = G.GATE_DEFS.get(name)
        if gd is None:
            raise ValueError(
                f"unknown gate {name!r}; known gates: "
                f"{', '.join(sorted(G.GATE_DEFS))}")
        if len(qubits) != gd.n_qubits:
            raise ValueError(f"gate {name} expects {gd.n_qubits} qubits, got {len(qubits)}")
        for q in qubits:
            if not (0 <= q < self.n_qubits):
                raise ValueError(f"qubit {q} out of range [0, {self.n_qubits})")
        self.gates.append(
            Gate(name=name, qubits=tuple(qubits),
                 params=tuple(_coerce_param(p) for p in params), gid=len(self.gates))
        )
        return self

    # ------------------------------------------------------------ parameters
    @property
    def is_bound(self) -> bool:
        return all(g.is_bound for g in self.gates)

    @property
    def param_names(self) -> Tuple[str, ...]:
        """Distinct free parameter names, in order of first appearance. This
        is the canonical ordering of a flat params vector for
        :meth:`bind` / ``ExecutionEngine.run_sweep``."""
        seen: List[str] = []
        for g in self.gates:
            for nm in g.free_params:
                if nm not in seen:
                    seen.append(nm)
        return tuple(seen)

    def bind(self, params: Union[Mapping[str, float], Sequence[float], None]) -> "Circuit":
        """Return a new circuit with every symbolic parameter bound.

        ``params`` is a ``{name: value}`` mapping or a flat vector ordered by
        :attr:`param_names`. Unknown names and missing values raise.
        """
        names = self.param_names
        if params is None:
            params = {}
        if not isinstance(params, Mapping):
            vec = list(np.asarray(params, dtype=np.float64).reshape(-1))
            if len(vec) != len(names):
                raise ValueError(
                    f"flat params vector has {len(vec)} entries; circuit has "
                    f"{len(names)} free parameters {names}"
                )
            params = dict(zip(names, vec))
        else:
            unknown = set(params) - set(names)
            if unknown:
                raise ValueError(f"unknown parameter names {sorted(unknown)}; "
                                 f"circuit parameters are {names}")
        missing = set(names) - set(params)
        if missing:
            raise UnboundParameterError(f"missing values for {sorted(missing)}")
        out = Circuit(self.n_qubits)
        out.gates = [g.bind(params) for g in self.gates]
        return out

    def binding_signature(self) -> Tuple:
        """Hashable fingerprint of the concrete parameter values (and any
        still-symbolic slots). Two same-structure circuits with equal binding
        signatures execute identically — used by the serving cache to decide
        whether a cached engine needs a rebinding pass."""
        return tuple(
            (repr(p) if isinstance(p, Param) else float(p))
            for g in self.gates for p in g.params
        )

    def structure_fingerprint(self) -> str:
        """Stable digest of the circuit *structure* — gate names and qubit
        wiring only, ignoring concrete angles and symbolic parameter names.
        Everything the Atlas pipeline computes ahead of parameter binding
        (ILP staging, DP kernelization, stage compilation, XLA executables)
        is a pure function of this fingerprint plus the compile knobs."""
        payload = (self.n_qubits, tuple((g.name, g.qubits) for g in self.gates))
        return hashlib.sha256(repr(payload).encode()).hexdigest()

    # ------------------------------------------------------------- structure
    @property
    def n_gates(self) -> int:
        return len(self.gates)

    def qubit_sets(self) -> List[Set[int]]:
        return [set(g.qubits) for g in self.gates]

    def dependencies(self) -> List[Tuple[int, int]]:
        """Adjacent gate pairs on the same qubit (paper's edge set E).

        Returns (g1, g2) pairs with g1 earlier, such that g2 is the *next* gate
        touching one of g1's qubits.
        """
        last: Dict[int, int] = {}
        edges: List[Tuple[int, int]] = []
        for i, g in enumerate(self.gates):
            for q in g.qubits:
                if q in last and last[q] != i:
                    edges.append((last[q], i))
                last[q] = i
        return sorted(set(edges))

    def dag_predecessors(self) -> List[List[int]]:
        preds: List[List[int]] = [[] for _ in self.gates]
        for a, b in self.dependencies():
            preds[b].append(a)
        return preds

    def subcircuit(self, gate_ids: Iterable[int]) -> "Circuit":
        """Circuit restricted to ``gate_ids`` (in the given order).

        Gates are renumbered to consecutive local gids, and the original
        ids are recorded in :attr:`parent_gids` (``parent_gids[j]`` is the
        parent gid of local gate ``j``) so plan provenance and error
        messages can always name the gate in the caller's circuit.
        """
        sub = Circuit(self.n_qubits)
        ids = [int(gid) for gid in gate_ids]
        for gid in ids:
            g = self.gates[gid]
            sub.gates.append(Gate(g.name, g.qubits, g.params, gid=len(sub.gates)))
        sub.parent_gids = tuple(ids)
        return sub

    # ---------------------------------------------------------- equivalence
    def is_topologically_equivalent(self, order: Sequence[int]) -> bool:
        """True iff executing gates in ``order`` (a permutation of gate ids)
        keeps the EXACT relative order of every same-qubit gate pair.

        This is the conservative check (sufficient for equivalence, used by
        the staging correctness tests). Reorderings of *commuting* same-qubit
        pairs — e.g. two diagonal gates sharing a qubit — are rejected here.
        """
        if sorted(order) != list(range(self.n_gates)):
            return False
        pos = {gid: i for i, gid in enumerate(order)}
        for q in range(self.n_qubits):
            ids = [g.gid for g in self.gates if q in g.qubits]
            for a, b in zip(ids, ids[1:]):
                if pos[a] > pos[b]:
                    return False
        return True

    # -------------------------------------------------------------- (de)ser
    def to_json(self) -> str:
        return json.dumps(
            {"n_qubits": self.n_qubits, "gates": [g.to_dict() for g in self.gates]}
        )

    @staticmethod
    def from_json(s: str) -> "Circuit":
        d = json.loads(s)
        c = Circuit(d["n_qubits"])
        for g in d["gates"]:
            c.add(g["name"], *g["qubits"], params=g["params"])
        return c

    # --------------------------------------------------------------- analyse
    def unitary(self) -> np.ndarray:
        """Dense 2^n x 2^n unitary (small n only; testing aid)."""
        n = self.n_qubits
        if n > 12:
            raise ValueError("unitary() only for small circuits")
        dim = 2**n
        u = np.eye(dim, dtype=np.complex128)
        for g in self.gates:
            u = full_matrix(g, n) @ u
        return u


def full_matrix(g: Gate, n: int) -> np.ndarray:
    """Embed gate ``g``'s matrix into the full 2^n space (testing aid)."""
    k = g.n_qubits
    m = g.matrix
    dim = 2**n
    out = np.zeros((dim, dim), dtype=np.complex128)
    mask = 0
    for q in g.qubits:
        mask |= 1 << q
    rest = [q for q in range(n) if not (mask >> q) & 1]
    for base_bits in range(2 ** len(rest)):
        base = 0
        for j, q in enumerate(rest):
            if (base_bits >> j) & 1:
                base |= 1 << q
        for r in range(2**k):
            ri = base
            for j, q in enumerate(g.qubits):
                if (r >> j) & 1:
                    ri |= 1 << q
            for c in range(2**k):
                if abs(m[r, c]) < 1e-16:
                    continue
                ci = base
                for j, q in enumerate(g.qubits):
                    if (c >> j) & 1:
                        ci |= 1 << q
                out[ri, ci] = m[r, c]
    return out
