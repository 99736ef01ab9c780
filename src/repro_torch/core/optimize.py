"""Pre-staging circuit optimizer: a verified pass pipeline over the gate IR.

(Copied from ``repro/core/optimize.py`` so this package imports nothing of the
JAX package; only imports differ.)

Every gate the planner never sees is ILP staging cost, DP kernel count and
device FLOPs saved before a single amplitude moves. This module rewrites a
:class:`~repro.core.circuit.Circuit` ahead of :func:`repro.core.partition.
partition` through four passes:

* ``cancel``  — adjacent inverse pairs drop (h·h, x·x, cx·cx, s·sdg, ...);
  "adjacent" means *DAG-adjacent*: gates on disjoint qubits in between do
  not block the cancellation.
* ``merge``   — adjacent same-axis rotations on the same qubits fold into
  one gate (rx/ry/rz/p/cp/crx/cry/crz/rzz/rxx/ryy). Symbolic
  :class:`~repro.core.gates.Param` angles fold via exact affine
  combination (same-name Params add scale/shift; Param+float shifts);
  folding *bails out* when the sum is not exactly representable (two
  different Param names), keeping both gates.
* ``drop``    — identity elimination: ``i`` gates, and bound rotations
  whose full matrix is the identity up to a global phase (θ≈0, θ≈4π,
  rz(2π) = -I, ...). Symbolic gates are never value-dropped — the rewrite
  must stay valid for every binding.
* ``reorder`` — commutation-aware rescheduling over the real
  :func:`gates_commute` predicate: a topological order of the
  non-commuting-pairs DAG that sinks diagonal gates into contiguous runs
  (packing shared-memory windows and exposing new cancel/merge
  adjacencies), correct by the trace-monoid argument — any such order is
  reachable by adjacent transpositions of commuting pairs.

Binding independence: every structural decision (commutation, diagonality,
cancellation) goes through name-level tables and
:func:`repro.core.gates.structural_matrix` classifications, and parametric
folding preserves parameter *names* (a fold whose scales sum to zero stays a
``Param`` with scale 0 rather than becoming a float). Optimizing a symbolic
circuit therefore commutes with binding:
``optimize(c).bind(v) ≡ optimize(c.bind(v))`` up to value-dependent identity
drops — which is what lets ``engine_for(..., optimize=True)`` keep the
zero-solve / zero-retrace warm-rebinding contract.

Equivalence is verified two ways in the test suite: dense
``Circuit.unitary()`` comparison up to global phase
(:func:`unitaries_equivalent`) per pass, and end-to-end state equivalence
through every backend in the differential fuzzer.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import gates as G
from .circuit import Circuit
from .gates import Param

#: Pass names in default execution order. ``cancel``/``merge``/``drop`` run
#: as a fixpoint loop, then ``reorder`` once, then the loop again (reordering
#: exposes new adjacencies).
ALL_PASSES: Tuple[str, ...] = ("cancel", "merge", "drop", "reorder")

#: Version tag baked into :func:`optimize_fingerprint`: bump on any change to
#: pass semantics so cached plans keyed on the old rewrite never alias.
OPTIMIZER_VERSION = 1

# gates equal to their own inverse (U·U = I) — constant matrices only, so
# the cancellation is valid for every binding by construction
SELF_INVERSE = frozenset({"h", "x", "y", "z", "cx", "cy", "cz", "swap", "ccx"})

# name pairs with U_a·U_b = I (checked both adjacency orders)
INVERSE_NAMES = frozenset({("s", "sdg"), ("sdg", "s"), ("t", "tdg"), ("tdg", "t")})

# gates invariant under reversing their qubit tuple: qubit-set matching is
# enough for cancel/merge (cz(a,b) == cz(b,a), rzz(a,b) == rzz(b,a), ...)
SYMMETRIC = frozenset({"cz", "cp", "swap", "rzz", "rxx", "ryy"})

# one-parameter gate families with U(a)·U(b) = U(a+b) on the same qubits
MERGEABLE = frozenset(
    {"rx", "ry", "rz", "p", "cp", "crx", "cry", "crz", "rzz", "rxx", "ryy"})


@dataclass(frozen=True)
class OptimizerConfig:
    """Which passes run and their resource caps. Hashable; the pass list is
    the cache-key fingerprint (:func:`optimize_fingerprint`)."""

    passes: Tuple[str, ...] = ALL_PASSES
    #: fixpoint iterations of the cancel/merge/drop loop (each side of the
    #: reorder pass) — a safety bound, convergence is typically 2-3 rounds
    max_rounds: int = 8
    #: the reorder pass builds the non-commuting-pairs DAG with O(chain^2)
    #: predicate calls per qubit chain; above this many pairs it skips
    #: (recorded in the pass stats) instead of stalling planning
    reorder_pair_cap: int = 2_000_000

    def __post_init__(self):
        unknown = set(self.passes) - set(ALL_PASSES)
        if unknown:
            raise ValueError(
                f"unknown optimizer passes {sorted(unknown)}; "
                f"known passes: {list(ALL_PASSES)}")


def resolve_config(optimize) -> Optional[OptimizerConfig]:
    """Normalize the ``optimize=`` knob: ``False``/``None`` -> off (None),
    ``True`` -> default config, a pass-name sequence -> that subset, an
    :class:`OptimizerConfig` -> itself."""
    if optimize is None or optimize is False:
        return None
    if optimize is True:
        return OptimizerConfig()
    if isinstance(optimize, OptimizerConfig):
        return optimize
    if isinstance(optimize, (list, tuple)):
        return OptimizerConfig(passes=tuple(optimize))
    raise TypeError(
        f"optimize= expects bool, pass-name sequence or OptimizerConfig, "
        f"got {type(optimize).__name__}")


def optimize_fingerprint(config) -> Tuple:
    """Stable hashable fingerprint of an optimizer configuration — the
    component :class:`repro.sim.engine.CircuitKey` mixes in so optimized and
    literal plans can never collide in the compile cache."""
    cfg = resolve_config(config)
    if cfg is None:
        return ("off",)
    return ("v%d" % OPTIMIZER_VERSION,) + tuple(cfg.passes)


# ---------------------------------------------------------------------------
# Commutation predicate (structural, binding-independent)
# ---------------------------------------------------------------------------


def _diagonal_qubits(gate) -> frozenset:
    """Circuit qubits on which ``gate`` acts diagonally (structurally)."""
    mask = G.structural_diagonal_bits(gate.name)
    return frozenset(q for j, q in enumerate(gate.qubits) if mask[j])


def gates_commute(a, b) -> bool:
    """Structural sufficient test that ``U_a U_b == U_b U_a``.

    True for (accepts :class:`~repro.core.circuit.Gate` or anything with
    ``.name``/``.qubits``):

    * **disjoint support** — no shared qubits;
    * **shared-diagonal** — every shared qubit is a *diagonal bit* of BOTH
      gates (:func:`repro.core.gates.structural_diagonal_bits`). Decomposing
      over the shared-qubit basis, both unitaries are block-diagonal with
      residual blocks on disjoint qubit sets, so they commute blockwise.
      This covers diagonal/diagonal pairs (cz, cp, rz, rzz, p, ...) and the
      control-commuting cases (a control bit is always a diagonal bit, so
      e.g. cx and rz sharing only the cx *control* commute);
    * **same family, same wiring** — identical ``(name, qubits)`` for every
      registry gate except ``u3``: one-generator rotation families commute
      at any two angles and constant gates are equal matrices.

    Conservative ``False`` otherwise — the reorder pass then simply keeps
    the original relative order. Binding-independent by construction: only
    names, qubit tuples and probe-angle structure are consulted.
    """
    sa, sb = set(a.qubits), set(b.qubits)
    shared = sa & sb
    if not shared:
        return True
    if a.name == b.name and a.qubits == b.qubits and a.name != "u3":
        return True
    return shared <= _diagonal_qubits(a) and shared <= _diagonal_qubits(b)


# ---------------------------------------------------------------------------
# Working representation + pass machinery
# ---------------------------------------------------------------------------


class _WG:
    """Mutable working gate: IR fields + provenance (source gids)."""

    __slots__ = ("name", "qubits", "params", "srcs")

    def __init__(self, name, qubits, params, srcs):
        self.name = name
        self.qubits = qubits
        self.params = params
        self.srcs = srcs


def _qubits_match(p: _WG, g: _WG) -> bool:
    if p.qubits == g.qubits:
        return True
    return g.name in SYMMETRIC and set(p.qubits) == set(g.qubits)


def _peephole(gates: List[_WG], combine) -> Tuple[List[_WG], int]:
    """Generic DAG-adjacent peephole walk.

    For each gate ``g``, find the unique previous surviving gate that is the
    most recent on ALL of ``g``'s qubits (then everything between them
    commutes past ``g``, so they are multiplicatively adjacent) and ask
    ``combine(prev, g)`` for a rewrite: ``None`` (keep both), ``"cancel"``
    (drop both) or a replacement ``_WG`` (fuse in place). Cancellation pops
    per-qubit stacks so cascades (h·x·x·h) resolve in one walk.
    """
    out: List[Optional[_WG]] = []
    stacks: Dict[int, List[int]] = {}
    count = 0
    for g in gates:
        tops = {stacks[q][-1] if stacks.get(q) else -1 for q in g.qubits}
        if len(tops) == 1:
            i = tops.pop()
            if i >= 0:
                prev = out[i]
                res = combine(prev, g)
                if res == "cancel":
                    out[i] = None
                    for q in prev.qubits:
                        stacks[q].pop()
                    count += 2
                    continue
                if res is not None:
                    out[i] = res
                    count += 1
                    continue
        idx = len(out)
        out.append(g)
        for q in g.qubits:
            stacks.setdefault(q, []).append(idx)
    return [g for g in out if g is not None], count


def _cancel_combine(p: _WG, g: _WG):
    if not _qubits_match(p, g):
        return None
    if p.name == g.name and p.name in SELF_INVERSE:
        return "cancel"
    if (p.name, g.name) in INVERSE_NAMES:
        return "cancel"
    return None


def _fold_angles(a, b):
    """``a + b`` when exactly representable, else None (fold bails out).

    float+float and Param+float always fold; Param+Param folds only for the
    SAME parameter name (affine coefficients add). A zero-scale result stays
    a ``Param`` so the circuit's parameter-name surface — and with it the
    rebinding contract — is preserved across optimization.
    """
    if isinstance(a, Param) and isinstance(b, Param):
        if a.name != b.name:
            return None
        return Param(a.name, a.scale + b.scale, a.shift + b.shift)
    if isinstance(a, Param):
        return Param(a.name, a.scale, a.shift + float(b))
    if isinstance(b, Param):
        return Param(b.name, b.scale, b.shift + float(a))
    return float(a) + float(b)


def _merge_combine(p: _WG, g: _WG):
    if p.name != g.name or p.name not in MERGEABLE:
        return None
    if not _qubits_match(p, g):
        return None
    folded = _fold_angles(p.params[0], g.params[0])
    if folded is None:
        return None
    return _WG(p.name, p.qubits, (folded,), p.srcs + g.srcs)


_IDENTITY_TOL = 1e-9


def _drop_identities(gates: List[_WG]) -> Tuple[List[_WG], int]:
    out: List[_WG] = []
    removed = 0
    for g in gates:
        if g.name == "i":
            removed += 1
            continue
        if g.params and not G.is_symbolic(g.params):
            m = G.gate_matrix(g.name, g.params)
            d = m[0, 0]
            # the FULL matrix equal to d·I (|d| = 1) is a pure global phase;
            # a controlled gate whose target block alone is a phase does NOT
            # qualify (crz(2π) = diag(1,1,-1,-1)) and is kept
            if abs(abs(d) - 1.0) < _IDENTITY_TOL and np.allclose(
                    m, d * np.eye(m.shape[0]), atol=_IDENTITY_TOL):
                removed += 1
                continue
        out.append(g)
    return out, removed


def _reorder(gates: List[_WG], pair_cap: int) -> Tuple[List[_WG], int, bool]:
    """Diagonal-sinking topological reschedule. Returns
    ``(gates, moved, skipped)``.

    Edges: for every qubit chain, ALL pairs (i earlier than j) with
    ``not gates_commute`` — all pairs, not just adjacent ones, because
    commutation is not transitive. Kahn's algorithm then emits the lowest-gid
    ready gate, except that once a diagonal gate has been emitted it keeps
    draining ready diagonal gates first — clustering diagonal runs so the
    compiler's peephole fuses them into single shared-memory passes and the
    cancel/merge rerun sees new adjacencies.
    """
    n = len(gates)
    chains: Dict[int, List[int]] = {}
    for i, g in enumerate(gates):
        for q in g.qubits:
            chains.setdefault(q, []).append(i)
    work = sum(len(ch) * (len(ch) - 1) // 2 for ch in chains.values())
    if work > pair_cap:
        return gates, 0, True

    succ: List[set] = [set() for _ in range(n)]
    indeg = [0] * n
    for ch in chains.values():
        for x in range(len(ch)):
            a = ch[x]
            for y in range(x + 1, len(ch)):
                b = ch[y]
                if b not in succ[a] and not gates_commute(gates[a], gates[b]):
                    succ[a].add(b)
                    indeg[b] += 1

    import heapq

    diag = [G.is_diagonal(G.structural_matrix(g.name)) for g in gates]
    ready_d: List[int] = []
    ready_n: List[int] = []
    for i in range(n):
        if indeg[i] == 0:
            heapq.heappush(ready_d if diag[i] else ready_n, i)
    order: List[int] = []
    last_diag = False
    while ready_d or ready_n:
        if ready_d and (last_diag or not ready_n):
            i = heapq.heappop(ready_d)
        else:
            i = heapq.heappop(ready_n)
        last_diag = diag[i]
        order.append(i)
        for j in succ[i]:
            indeg[j] -= 1
            if indeg[j] == 0:
                heapq.heappush(ready_d if diag[j] else ready_n, j)
    assert len(order) == n, "reorder produced a non-permutation (cycle?)"
    moved = sum(1 for k, i in enumerate(order) if i != k)
    return [gates[i] for i in order], moved, False


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------


@dataclass
class OptimizeResult:
    """Optimized circuit + per-pass stats + gid provenance."""

    circuit: Circuit
    source: Circuit
    #: ordered pass log: one entry per executed pass instance
    stats: List[Dict] = field(default_factory=list)
    #: output gid -> tuple of source gids it was built from (a merged gate
    #: carries every folded source gid)
    provenance: Tuple[Tuple[int, ...], ...] = ()

    @property
    def gates_removed(self) -> int:
        return self.source.n_gates - self.circuit.n_gates

    @property
    def dropped_gids(self) -> Tuple[int, ...]:
        """Source gids with no surviving output gate (cancelled/eliminated)."""
        alive = {s for srcs in self.provenance for s in srcs}
        return tuple(g.gid for g in self.source.gates if g.gid not in alive)

    def pass_counts(self) -> Dict[str, int]:
        """Aggregate rewrite count per pass name (JSON-able provenance)."""
        agg: Dict[str, int] = {}
        for s in self.stats:
            agg[s["pass"]] = agg.get(s["pass"], 0) + int(s["count"])
        return agg

    def to_dict(self) -> Dict:
        return {
            "gates_before": self.source.n_gates,
            "gates_after": self.circuit.n_gates,
            "gates_removed": self.gates_removed,
            "pass_counts": self.pass_counts(),
            "dropped_gids": list(self.dropped_gids),
        }


def optimize_circuit(circuit: Circuit, config=True) -> OptimizeResult:
    """Run the pass pipeline over ``circuit`` and return the rewrite.

    ``config`` is anything :func:`resolve_config` accepts. The input circuit
    is never mutated. With the optimizer off (``config=False``) the result
    wraps the input unchanged.
    """
    cfg = resolve_config(config)
    identity_prov = tuple((g.gid,) for g in circuit.gates)
    if cfg is None:
        return OptimizeResult(circuit=circuit, source=circuit,
                              provenance=identity_prov)

    work = [_WG(g.name, g.qubits, g.params, (g.gid,)) for g in circuit.gates]
    enabled = set(cfg.passes)
    stats: List[Dict] = []

    def fixpoint(gates: List[_WG]) -> List[_WG]:
        for _ in range(max(cfg.max_rounds, 1)):
            changed = 0
            if "cancel" in enabled:
                gates, k = _peephole(gates, _cancel_combine)
                if k:
                    stats.append({"pass": "cancel", "count": k})
                changed += k
            if "merge" in enabled:
                gates, k = _peephole(gates, _merge_combine)
                if k:
                    stats.append({"pass": "merge", "count": k})
                changed += k
            if "drop" in enabled:
                gates, k = _drop_identities(gates)
                if k:
                    stats.append({"pass": "drop", "count": k})
                changed += k
            if not changed:
                break
        return gates

    work = fixpoint(work)
    if "reorder" in enabled:
        work, moved, skipped = _reorder(work, cfg.reorder_pair_cap)
        stats.append({"pass": "reorder", "count": moved, "skipped": skipped})
        if moved:
            work = fixpoint(work)

    out = Circuit(circuit.n_qubits)
    for g in work:
        out.add(g.name, *g.qubits, params=g.params)
    return OptimizeResult(circuit=out, source=circuit, stats=stats,
                          provenance=tuple(g.srcs for g in work))


# ---------------------------------------------------------------------------
# Verification helper (tests/benchmarks)
# ---------------------------------------------------------------------------


def unitaries_equivalent(c1: Circuit, c2: Circuit, atol: float = 1e-7) -> bool:
    """Dense small-n check that two bound circuits implement the same unitary
    up to a global phase: ``U1† U2 == e^{iφ} I``."""
    if c1.n_qubits != c2.n_qubits:
        return False
    m = c1.unitary().conj().T @ c2.unitary()
    d = m[0, 0]
    if abs(abs(d) - 1.0) > atol:
        return False
    return bool(np.allclose(m, d * np.eye(m.shape[0]), atol=atol))
