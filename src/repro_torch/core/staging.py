"""Circuit staging (paper §IV): ILP formulation (Eq. 3-11) + STAGE loop (Alg. 2).

(Copied from ``repro/core/staging.py`` so this package imports nothing of the
JAX package; only imports differ.)

A *stage* is ``(gate_ids, QubitPartition)`` such that every gate in the stage
has all of its non-insular qubits mapped to local physical qubits. Fully
insular gates (all qubits insular, e.g. cp/rzz/cz-with-diagonal-action) are
excluded from the ILP (they never constrain locality) and re-attached to the
earliest dependency-feasible stage afterwards — this is the key size reduction
that makes qft (mostly cp gates) stage with a tiny ILP, mirroring the paper's
insular-qubit insight.

Backends: scipy's HiGHS MILP (default, in-process) or PuLP/CBC (fallback).
A SnuQS-style greedy heuristic is provided as the paper's comparison baseline
(Fig. 9/12).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import scipy.sparse as sp
from scipy.optimize import Bounds, LinearConstraint, milp

from ..sim import faults
from ..sim.faults import StagingError
from .circuit import Circuit, Gate

# Module-level solver-call accounting. The parametric serving path asserts
# that rebinding a cached engine performs ZERO new solves; tests snapshot and
# diff these counters around rebind + run.
SOLVER_CALLS: Dict[str, int] = {"ilp": 0, "greedy": 0}


@dataclass(frozen=True)
class QubitPartition:
    """Map of logical qubits -> physical tiers for one stage.

    ``local`` qubits occupy the low L physical bits (one accelerator shard),
    ``regional`` the next R bits (intra-pod ICI), ``global`` the top G bits
    (inter-pod DCN). ``layout`` is the full physical order: element i is the
    logical qubit mapped to physical bit i.
    """

    local: Tuple[int, ...]
    regional: Tuple[int, ...]
    global_: Tuple[int, ...]

    @property
    def layout(self) -> Tuple[int, ...]:
        return tuple(self.local) + tuple(self.regional) + tuple(self.global_)

    def tier_of(self, q: int) -> str:
        if q in self.local:
            return "local"
        if q in self.regional:
            return "regional"
        return "global"


@dataclass
class Stage:
    gate_ids: List[int]
    partition: QubitPartition


@dataclass
class StagingResult:
    stages: List[Stage]
    objective: float  # Eq. 2 communication cost
    solve_time_s: float
    method: str
    ilp_stats: Dict[str, float] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def _retained_and_edges(circuit: Circuit):
    """Retained (non-fully-insular) gates + transitive dependency edges
    (through insular gates) among them."""
    retained: List[int] = []
    retained_idx: Dict[int, int] = {}
    nonins: List[Tuple[int, ...]] = []
    edges: Set[Tuple[int, int]] = set()
    # frontier[q]: set of retained-gate indices that must precede future gates on q
    frontier: Dict[int, Set[int]] = {}
    for g in circuit.gates:
        ni = g.non_insular_qubits
        front = set()
        for q in g.qubits:
            front |= frontier.get(q, set())
        if ni:
            i = len(retained)
            retained_idx[g.gid] = i
            retained.append(g.gid)
            nonins.append(ni)
            for j in front:
                edges.add((j, i))
            for q in g.qubits:
                frontier[q] = {i}
        else:
            for q in g.qubits:
                frontier[q] = set(front)
    return retained, nonins, sorted(edges)


def eq2_cost(stages: Sequence[Stage], c: float) -> float:
    """Paper Eq. 2 communication cost of a staging."""
    total = 0.0
    for i in range(1, len(stages)):
        prev, cur = stages[i - 1].partition, stages[i].partition
        total += len(set(cur.local) - set(prev.local))
        total += c * len(set(cur.global_) - set(prev.global_))
    return total


def validate_staging(circuit: Circuit, stages: Sequence[Stage], L: int, R: int, G: int) -> None:
    """Raises AssertionError if the staging is invalid."""
    n = circuit.n_qubits
    assert L + R + G == n, f"L+R+G={L+R+G} != n={n}"
    seen: List[int] = []
    for st in stages:
        p = st.partition
        assert len(p.local) == L and len(p.regional) == R and len(p.global_) == G
        assert sorted(p.layout) == list(range(n)), "layout must be a permutation"
        for gid in st.gate_ids:
            g = circuit.gates[gid]
            for q in g.non_insular_qubits:
                assert q in p.local, (
                    f"gate {gid} ({g.name}) non-insular qubit {q} not local in stage"
                )
        seen.extend(st.gate_ids)
    assert sorted(seen) == list(range(circuit.n_gates)), "each gate exactly once"
    assert circuit.is_topologically_equivalent(seen) or _dep_ok(circuit, seen)


def _dep_ok(circuit: Circuit, order: Sequence[int]) -> bool:
    pos = {gid: i for i, gid in enumerate(order)}
    return all(pos[a] < pos[b] for a, b in circuit.dependencies())


def _fill_partition(
    n: int, L: int, R: int, G: int,
    local: Set[int], global_: Set[int],
    prev: Optional[QubitPartition],
) -> QubitPartition:
    """Order tier members to maximize overlap with the previous stage layout."""
    regional = set(range(n)) - local - global_
    assert len(local) == L and len(global_) == G and len(regional) == R

    def order_tier(members: Set[int], prev_tier: Sequence[int]) -> Tuple[int, ...]:
        out: List[Optional[int]] = [None] * len(members)
        rest = set(members)
        if prev is not None:
            for i, q in enumerate(prev_tier):
                if q in rest:
                    out[i] = q
                    rest.remove(q)
        pool = sorted(rest)
        for i in range(len(out)):
            if out[i] is None:
                out[i] = pool.pop(0)
        return tuple(out)  # type: ignore[arg-type]

    return QubitPartition(
        local=order_tier(local, prev.local if prev else ()),
        regional=order_tier(regional, prev.regional if prev else ()),
        global_=order_tier(global_, prev.global_ if prev else ()),
    )


def _attach_insular(circuit: Circuit, retained: List[int], stage_of_retained: List[int],
                    n_stages: int) -> List[List[int]]:
    """Distribute ALL gates to stages: retained per ILP, insular gates to the
    earliest stage allowed by dependencies. Returns gate-id lists per stage,
    each internally in original circuit order."""
    stage_of: Dict[int, int] = {
        circuit.gates[retained[i]].gid: stage_of_retained[i] for i in range(len(retained))
    }
    # earliest feasible stage for insular gates = max over predecessors' stages
    preds = circuit.dag_predecessors()
    for g in circuit.gates:
        if g.gid in stage_of:
            continue
        s = 0
        for p in preds[g.gid]:
            s = max(s, stage_of.get(p, 0))
        stage_of[g.gid] = s
    out: List[List[int]] = [[] for _ in range(n_stages)]
    for g in circuit.gates:  # original order within each stage
        out[stage_of[g.gid]].append(g.gid)
    return out


# ---------------------------------------------------------------------------
# ILP (Eq. 3-11)
# ---------------------------------------------------------------------------


def solve_ilp(
    circuit: Circuit, L: int, R: int, G: int, s: int, c: float = 3.0,
    time_limit: float = 120.0, feasibility_only: bool = False,
) -> Optional[Tuple[List[int], List[Set[int]], List[Set[int]], Dict[str, float]]]:
    """Solve the staging ILP for exactly ``s`` stages.

    ``feasibility_only`` drops the S/T update variables and the objective
    (used to find the minimum feasible s cheaply; a zero objective makes the
    MIP stop at the first incumbent). Returns
    (stage_of_retained_gate, local_sets, global_sets, stats) or None.
    """
    n = circuit.n_qubits
    retained, nonins, edges = _retained_and_edges(circuit)
    m = len(retained)

    for ni in nonins:
        if len(ni) > L:
            raise ValueError(f"gate with {len(ni)} non-insular qubits > L={L}: unstageable")

    # variable layout
    nA = n * s
    nB = n * s
    nF = m * s
    nS = 0 if feasibility_only else n * max(s - 1, 0)
    N = nA + nB + nF + 2 * nS

    def A(q, k):
        return q * s + k

    def B(q, k):
        return nA + q * s + k

    def F(i, k):
        return nA + nB + i * s + k

    def Svar(q, k):
        return nA + nB + nF + q * (s - 1) + k

    def Tvar(q, k):
        return nA + nB + nF + nS + q * (s - 1) + k

    obj = np.zeros(N)
    if not feasibility_only:
        for q in range(n):
            for k in range(s - 1):
                obj[Svar(q, k)] = 1.0
                obj[Tvar(q, k)] = c

    rows: List[int] = []
    cols: List[int] = []
    vals: List[float] = []
    lb: List[float] = []
    ub: List[float] = []
    r = 0

    def add_row(terms, lo, hi):
        nonlocal r
        for col, v in terms:
            rows.append(r)
            cols.append(col)
            vals.append(v)
        lb.append(lo)
        ub.append(hi)
        r += 1

    INF = np.inf
    # (4) A[q,k+1] - A[q,k] - S[q,k] <= 0 ; (5) same for B/T
    if not feasibility_only:
        for q in range(n):
            for k in range(s - 1):
                add_row([(A(q, k + 1), 1), (A(q, k), -1), (Svar(q, k), -1)], -INF, 0)
                add_row([(B(q, k + 1), 1), (B(q, k), -1), (Tvar(q, k), -1)], -INF, 0)
    # (6) F[i,k] - F[i,k+1] <= 0
    for i in range(m):
        for k in range(s - 1):
            add_row([(F(i, k), 1), (F(i, k + 1), -1)], -INF, 0)
    # (7) F[i,k] - F[i,k-1] - A[q,k] <= 0 for each non-insular qubit q
    for i in range(m):
        for q in nonins[i]:
            add_row([(F(i, 0), 1), (A(q, 0), -1)], -INF, 0)
            for k in range(1, s):
                add_row([(F(i, k), 1), (F(i, k - 1), -1), (A(q, k), -1)], -INF, 0)
    # (8) F[g1,k] >= F[g2,k]
    for (i1, i2) in edges:
        for k in range(s):
            add_row([(F(i1, k), 1), (F(i2, k), -1)], 0, INF)
    # (9) F[i,s-1] = 1
    for i in range(m):
        add_row([(F(i, s - 1), 1)], 1, 1)
    # (10) A + B <= 1
    for q in range(n):
        for k in range(s):
            add_row([(A(q, k), 1), (B(q, k), 1)], -INF, 1)
    # (11) sum_q A[q,k] = L, sum_q B[q,k] = G
    for k in range(s):
        add_row([(A(q, k), 1) for q in range(n)], L, L)
        add_row([(B(q, k), 1) for q in range(n)], G, G)

    mat = sp.csr_matrix((vals, (rows, cols)), shape=(r, N))
    t0 = time.time()
    try:
        res = milp(
            c=obj,
            constraints=LinearConstraint(mat, np.array(lb), np.array(ub)),
            integrality=np.ones(N),
            bounds=Bounds(0, 1),
            options={"time_limit": time_limit, "presolve": True},
        )
    except Exception as e:
        # scipy/HiGHS internals must not leak raw to the caller: the
        # degradation ladder catches StagingError and reruns greedy
        raise StagingError(f"ILP solver error (s={s}): {e}") from e
    dt = time.time() - t0
    if res.status != 0 or res.x is None:
        return None
    x = np.round(res.x).astype(int)
    stage_of = []
    for i in range(m):
        ks = [k for k in range(s) if x[F(i, k)] == 1]
        stage_of.append(min(ks))
    local_sets = [set(q for q in range(n) if x[A(q, k)] == 1) for k in range(s)]
    global_sets = [set(q for q in range(n) if x[B(q, k)] == 1) for k in range(s)]
    stats = {
        "solve_time_s": dt,
        "n_vars": float(N),
        "n_constraints": float(r),
        "n_retained_gates": float(m),
        "objective": float(res.fun if res.fun is not None else 0.0),
    }
    return stage_of, local_sets, global_sets, stats


def stage_count_lower_bound(circuit: Circuit, L: int) -> int:
    """Valid lower bound on the number of stages: along any dependency chain the
    stage index is non-decreasing, and a single stage's chain segment has at
    most L distinct non-insular qubits; greedy segmentation of the longest
    chain (by that measure) is therefore a lower bound."""
    retained, nonins, edges = _retained_and_edges(circuit)
    m = len(retained)
    if m == 0:
        return 1
    succ: List[List[int]] = [[] for _ in range(m)]
    for a, b in edges:
        succ[a].append(b)

    # dp[i] = max #segments needed for a chain starting at i, tracked greedily:
    # we propagate (segments_so_far, current_union) backwards along one
    # heuristic longest path; exact chain-max is NP-ish, so walk the longest
    # dependency path by edge count and segment it.
    indeg = [0] * m
    for a, b in edges:
        indeg[b] += 1
    # longest path by #gates (DAG DP)
    order = list(range(m))  # edges always go forward (a < b by construction)
    best_len = [1] * m
    best_next = [-1] * m
    for i in reversed(order):
        for j in succ[i]:
            if 1 + best_len[j] > best_len[i]:
                best_len[i] = 1 + best_len[j]
                best_next[i] = j
    start = max(range(m), key=lambda i: best_len[i])
    # greedy segmentation of that path
    segs, union = 1, set()
    i = start
    while i != -1:
        u2 = union | set(nonins[i])
        if len(u2) > L:
            segs += 1
            union = set(nonins[i])
        else:
            union = u2
        i = best_next[i]
    return max(1, segs)


def stage_ilp(
    circuit: Circuit, L: int, R: int, G: int, c: float = 3.0,
    max_stages: int = 64, time_limit: float = 120.0,
) -> StagingResult:
    """Alg. 2: try s = lb, lb+1, ... and return the first feasible ILP solution
    (minimum #stages by Thm. 1 — the chain lower bound only skips provably
    infeasible s — min Eq. 2 cost among those)."""
    t0 = time.time()
    SOLVER_CALLS["ilp"] += 1
    if faults._ACTIVE is not None:
        faults.maybe_inject("ilp_timeout", site="staging.stage_ilp")
    s_lo = stage_count_lower_bound(circuit, L)
    # Alg. 2: scan s upward from the chain lower bound. Probes are
    # feasibility-only (zero objective => the MIP stops at its first
    # incumbent); the Eq. 3 objective is optimized once, at the minimal s.
    best: Optional[Tuple[int, tuple]] = None
    for s in range(s_lo, max_stages + 1):
        probe = solve_ilp(circuit, L, R, G, s, c=c, time_limit=time_limit,
                          feasibility_only=True)
        if probe is None:
            continue
        sol = solve_ilp(circuit, L, R, G, s, c=c, time_limit=time_limit)
        best = (s, sol if sol is not None else probe)
        break
    if best is None:
        raise StagingError(f"no feasible staging within {max_stages} stages")
    s, (stage_of, local_sets, global_sets, stats) = best
    retained, _, _ = _retained_and_edges(circuit)
    per_stage = _attach_insular(circuit, retained, stage_of, s)
    stages: List[Stage] = []
    prev: Optional[QubitPartition] = None
    for k in range(s):
        part = _fill_partition(circuit.n_qubits, L, R, G, local_sets[k], global_sets[k], prev)
        stages.append(Stage(per_stage[k], part))
        prev = part
    return StagingResult(
        stages=stages,
        objective=eq2_cost(stages, c),
        solve_time_s=time.time() - t0,
        method="ilp",
        ilp_stats=stats,
    )


# ---------------------------------------------------------------------------
# SnuQS-style greedy baseline (paper §VII-D)
# ---------------------------------------------------------------------------


def stage_greedy(circuit: Circuit, L: int, R: int, G: int, c: float = 3.0) -> StagingResult:
    """Greedy heuristic: pick the L qubits with the most remaining non-insular
    gate references as local (total gate count as tiebreaker), execute the
    maximal dependency-closed prefix, repeat."""
    t0 = time.time()
    SOLVER_CALLS["greedy"] += 1
    n = circuit.n_qubits
    remaining: List[Gate] = list(circuit.gates)
    stages: List[Stage] = []
    prev: Optional[QubitPartition] = None
    while remaining:
        ni_count = np.zeros(n)
        tot_count = np.zeros(n)
        for g in remaining:
            for q in g.non_insular_qubits:
                ni_count[q] += 1
            for q in g.qubits:
                tot_count[q] += 1
        score = ni_count * (circuit.n_gates + 1) + tot_count
        # force-include the first remaining gate's non-insular qubits (progress)
        first_ni: Tuple[int, ...] = ()
        for g in remaining:
            if g.non_insular_qubits:
                first_ni = g.non_insular_qubits
                break
        order = sorted(range(n), key=lambda q: (-score[q], q))
        local = set(first_ni)
        for q in order:
            if len(local) >= L:
                break
            local.add(q)
        # non-local tiers: most-referenced non-locals become regional
        nonlocal_qs = [q for q in order if q not in local]
        regional = set(nonlocal_qs[:R])
        global_ = set(q for q in range(n) if q not in local and q not in regional)

        execed: List[int] = []
        blocked: Set[int] = set()
        rest: List[Gate] = []
        for g in remaining:
            if any(q in blocked for q in g.qubits):
                rest.append(g)
                blocked.update(g.qubits)
            elif all(q in local for q in g.non_insular_qubits):
                execed.append(g.gid)
            else:
                rest.append(g)
                blocked.update(g.qubits)
        assert execed, "greedy staging failed to make progress"
        part = _fill_partition(n, L, R, G, local, global_, prev)
        stages.append(Stage(execed, part))
        prev = part
        remaining = rest
    return StagingResult(
        stages=stages,
        objective=eq2_cost(stages, c),
        solve_time_s=time.time() - t0,
        method="greedy",
    )


def stage(circuit: Circuit, L: int, R: int, G: int, c: float = 3.0,
          method: str = "ilp", **kw) -> StagingResult:
    if method == "ilp":
        return stage_ilp(circuit, L, R, G, c=c, **kw)
    if method == "greedy":
        return stage_greedy(circuit, L, R, G, c=c)
    raise ValueError(f"unknown staging method {method!r}")
