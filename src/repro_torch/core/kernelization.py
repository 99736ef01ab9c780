"""Circuit kernelization (paper §V + §VI-A + App. A/B).

(Copied from ``repro/core/kernelization.py`` so this package imports nothing of the
JAX package; only imports differ.)

Implements:

* :func:`kernelize` — the KERNELIZE dynamic program (Alg. 3) with the
  extensible-qubit-set state reduction (Alg. 4 / Thm. 4), fusion vs
  shared-memory kernel typing (§VI-B), the subsume transition optimization
  (App. B-b), single-qubit gate attachment (App. B-d), greedy post-processing
  merge (App. B-e) and cost-based pruning with threshold ``T`` (App. B-f).
* :func:`ordered_kernelize` — Alg. 5 (contiguous-segment DP, "Atlas-Naive").
* :func:`greedy_kernelize` — the paper's evaluation baseline: greedily pack
  gates into fusion kernels of up to 5 qubits.

Qubit sets are int bitmasks over *physical local* qubit indices. Gates enter
as :class:`Item`\\ s — a multi-qubit gate plus any attached single-qubit gates
(App. B-d) — produced by :func:`items_from_gates`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..sim import faults
from .circuit import Circuit, Gate
from .cost_model import FUSION, SHM, CostModel, DEFAULT_COST_MODEL

# DP-solve accounting (see repro.core.staging.SOLVER_CALLS): the parametric
# serving path asserts rebinding performs zero new kernelization solves.
SOLVER_CALLS: Dict[str, int] = {"dp": 0}


@dataclass(frozen=True)
class Item:
    """A DP unit: one multi-qubit gate with attached 1q gates (App. B-d)."""

    mask: int  # bitmask of (physical local) qubits
    gate_ids: Tuple[int, ...]  # member gate positions, ascending
    shm_cost: float  # sum of per-gate shm costs for the members
    gate_masks: Tuple[int, ...] = ()  # per-member qubit masks (same order)


@dataclass
class Kernel:
    kind: int  # FUSION or SHM
    qubits: Tuple[int, ...]
    gate_ids: List[int]
    cost: float = 0.0

    @property
    def n_qubits(self) -> int:
        return len(self.qubits)


@dataclass
class KernelizationResult:
    kernels: List[Kernel]
    total_cost: float
    method: str
    stats: Dict[str, float] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# Item construction (App. B-d single-qubit attachment)
# ---------------------------------------------------------------------------


def items_from_gates(
    gates: Sequence[Gate],
    qubit_map: Optional[Dict[int, int]] = None,
    cm: CostModel = DEFAULT_COST_MODEL,
) -> List[Item]:
    """Convert a gate sequence into DP items.

    ``qubit_map`` maps logical gate qubits to physical local indices; qubits
    not in the map (non-local insular qubits) are excluded from the kernel
    footprint (they are handled by shard specialization at execution time).
    Single-qubit(-footprint) gates attach to the previous multi-qubit item on
    their qubit, else the next one, else stand alone.
    """

    def local_mask(g: Gate) -> int:
        m = 0
        for q in g.qubits:
            p = qubit_map.get(q) if qubit_map is not None else q
            if p is not None:
                m |= 1 << p
        return m

    def gcost(g: Gate) -> float:
        return cm.shm_gate_cost(g.is_diagonal)

    entries = [(i, g, local_mask(g)) for i, g in enumerate(gates)]
    multi = [(i, g, m) for (i, g, m) in entries if m.bit_count() >= 2]
    items: List[Dict] = []  # mutable item records
    pos_to_item: Dict[int, int] = {}
    for i, g, m in multi:
        pos_to_item[i] = len(items)
        items.append({"mask": m, "gids": [i], "cost": gcost(g), "gmasks": {i: m},
                      "host": i})

    multi_pos = [i for (i, _, _) in multi]
    for i, g, m in entries:
        if m.bit_count() >= 2:
            continue
        host = None
        if m:
            # previous multi item sharing a qubit, else next
            for j in reversed(multi_pos):
                if j < i and (items[pos_to_item[j]]["mask"] & m):
                    host = pos_to_item[j]
                    break
            if host is None:
                for j in multi_pos:
                    if j > i and (items[pos_to_item[j]]["mask"] & m):
                        host = pos_to_item[j]
                        break
        if host is None:
            items.append({"mask": m, "gids": [i], "cost": gcost(g), "gmasks": {i: m},
                          "host": i})
        else:
            items[host]["gids"].append(i)
            items[host]["cost"] += gcost(g)
            items[host]["gmasks"][i] = m

    # DP order = host-gate position: a forward-attached 1q gate only shares its
    # qubit with its host (the next multi-qubit gate on that qubit), so
    # ordering items by host position respects every item-level dependency.
    items.sort(key=lambda it: it["host"])
    out = [
        Item(
            mask=it["mask"],
            gate_ids=tuple(sorted(it["gids"])),
            shm_cost=it["cost"],
            gate_masks=tuple(it["gmasks"][g] for g in sorted(it["gids"])),
        )
        for it in items
    ]
    return [it for it in out if it.mask]  # zero-footprint gates have no kernel work


# ---------------------------------------------------------------------------
# KERNELIZE (Alg. 3 + 4)
# ---------------------------------------------------------------------------

# descriptor: (kind, qmask, extmask); extmask == FULL means "AllQubits"


def _close_cost(cm: CostModel, kind: int, qmask: int) -> float:
    return cm.kernel_close_cost(kind, qmask.bit_count())


def _prune_score(cm: CostModel, cost: float, state: Tuple) -> float:
    """cost + post-processed estimate for closing the open kernels (App. B-f):
    fusion kernels are first-fit-decreasing packed to the most cost-efficient
    size; shm kernels to the max shm size."""
    best_k = cm.max_fusion_qubits
    fus = sorted((q.bit_count() for (kd, q, _) in state if kd == FUSION), reverse=True)
    shm = sorted(
        ((q | ((1 << cm.io_qubits) - 1)).bit_count() for (kd, q, _) in state if kd == SHM),
        reverse=True,
    )
    extra = 0.0
    for sizes, cap, cost_fn in (
        (fus, best_k, lambda k: cm.fusion_cost(k)),
        (shm, cm.max_shm_qubits, lambda k: cm.shm_open_cost()),
    ):
        bins: List[int] = []
        for s in sizes:
            for bi in range(len(bins)):
                if bins[bi] + s <= cap:
                    bins[bi] += s
                    break
            else:
                bins.append(s)
        extra += sum(cost_fn(b) for b in bins)
    return cost + extra


def kernelize(
    items: Sequence[Item],
    n_qubits: int,
    cm: CostModel = DEFAULT_COST_MODEL,
    prune_T: int = 500,
) -> KernelizationResult:
    SOLVER_CALLS["dp"] += 1
    if faults._ACTIVE is not None:
        faults.maybe_inject("dp_solve_error", site="kernelization.kernelize")
    FULL = (1 << n_qubits) - 1
    io_mask = (1 << cm.io_qubits) - 1

    # DP[state] = cost ; parents[(i, state)] = (prev_state, action)
    dp: Dict[Tuple, float] = {(): 0.0}
    parents: Dict[Tuple[int, Tuple], Tuple[Tuple, Tuple]] = {}
    n_states_peak = 0

    for i, item in enumerate(items):
        gm = item.mask
        ndp: Dict[Tuple, float] = {}
        for state, cost in dp.items():
            # enumerate candidate placements for this item
            joins: List[int] = []
            subsume: Optional[int] = None
            for idx, (kind, qm, em) in enumerate(state):
                if gm & ~em:
                    continue  # not all qubits extensible (Constraint 1)
                nq = qm | gm
                if kind == FUSION and nq.bit_count() > cm.max_fusion_qubits:
                    continue
                if kind == SHM and (nq | io_mask).bit_count() > cm.max_shm_qubits:
                    continue
                joins.append(idx)
                if subsume is None and (gm & ~qm == 0 or qm & ~gm == 0):
                    subsume = idx
            if subsume is not None:
                choices: List[Tuple[str, int]] = [("join", subsume)]  # App. B-b
            else:
                choices = [("join", j) for j in joins]
                if gm.bit_count() <= cm.max_fusion_qubits:
                    choices.append(("new", FUSION))
                if (gm | io_mask).bit_count() <= cm.max_shm_qubits:
                    choices.append(("new", SHM))

            for what, arg in choices:
                ncost = cost
                new_descs: List[Tuple[int, int, int]] = []
                if what == "join":
                    kind, qm, em = state[arg]
                    tgt = (kind, qm | gm, em if em != FULL else FULL)
                    if kind == SHM:
                        ncost += item.shm_cost
                    others = [d for k2, d in enumerate(state) if k2 != arg]
                else:
                    kind = arg
                    tgt = (kind, gm, FULL)
                    if kind == SHM:
                        ncost += item.shm_cost
                    others = list(state)
                new_descs.append(tgt)
                # Alg. 4 extensible-set update for the other kernels
                for kind2, qm2, em2 in others:
                    if em2 == FULL:
                        em_new = (qm2 & ~gm) if (qm2 & gm) else FULL
                    else:
                        em_new = em2 & ~gm
                    if em_new == 0:
                        ncost += _close_cost(cm, kind2, qm2)  # no longer extensible
                    else:
                        new_descs.append((kind2, qm2, em_new))
                nstate = tuple(sorted(new_descs))
                if ncost < ndp.get(nstate, float("inf")):
                    ndp[nstate] = ncost
                    parents[(i + 1, nstate)] = (state, (what, arg))
        # pruning (App. B-f)
        if len(ndp) > prune_T:
            scored = sorted(ndp.items(), key=lambda kv: _prune_score(cm, kv[1], kv[0]))
            ndp = dict(scored[: max(prune_T // 2, 1)])
        n_states_peak = max(n_states_peak, len(ndp))
        dp = ndp
        if not dp:
            raise RuntimeError("kernelize DP dead-ended (should be impossible)")

    # final: close all remaining kernels
    best_state, best_cost = None, float("inf")
    for state, cost in dp.items():
        tot = cost + sum(_close_cost(cm, kd, qm) for (kd, qm, _) in state)
        if tot < best_cost:
            best_state, best_cost = state, tot

    kernels = _reconstruct(items, parents, best_state, len(items), n_qubits, cm)
    kernels = _postprocess_merge(kernels, items, cm)
    total = sum(k.cost for k in kernels)
    return KernelizationResult(
        kernels=kernels,
        total_cost=total,
        method="kernelize_dp",
        stats={"dp_states_peak": float(n_states_peak), "pre_merge_cost": best_cost},
    )


def _replay_path(parents, final_state, n_items) -> List[Tuple[str, int]]:
    actions: List[Tuple[str, int]] = []
    state = final_state
    for i in range(n_items, 0, -1):
        prev, act = parents[(i, state)]
        actions.append(act)
        state = prev
    actions.reverse()
    return actions


def _reconstruct(items, parents, final_state, n_items, n_qubits, cm) -> List[Kernel]:
    """Replay the DP decisions to recover kernel gate memberships."""
    FULL = (1 << n_qubits) - 1
    actions = _replay_path(parents, final_state, n_items)
    live: List[Dict] = []  # {kind, qm, em, gids}
    closed: List[Kernel] = []

    def close(rec):
        shm_extra = rec["shm_cost"] if rec["kind"] == SHM else 0.0
        closed.append(
            Kernel(
                kind=rec["kind"],
                qubits=tuple(q for q in range(n_qubits) if (rec["qm"] >> q) & 1),
                gate_ids=sorted(rec["gids"]),
                cost=_close_cost(cm, rec["kind"], rec["qm"]) + shm_extra,
            )
        )

    for i, (what, arg) in enumerate(actions):
        item = items[i]
        gm = item.mask
        if what == "new":
            tgt = {"kind": arg, "qm": gm, "em": FULL, "gids": list(item.gate_ids),
                   "shm_cost": item.shm_cost}
            others = live
            live = [tgt] + others
            tgt_rec = tgt
        else:
            # `arg` indexes the *sorted descriptor tuple* of the previous DP
            # state; our live list is unordered, so match by descriptor.
            prev_descs = sorted((r["kind"], r["qm"], r["em"]) for r in live)
            want = prev_descs[arg]
            tgt_rec = next(
                r for r in live if (r["kind"], r["qm"], r["em"]) == want
            )
            tgt_rec["qm"] |= gm
            tgt_rec["gids"].extend(item.gate_ids)
            tgt_rec["shm_cost"] += item.shm_cost
        # extensible-set updates + eager closes
        still: List[Dict] = []
        for r in live:
            if r is tgt_rec:
                still.append(r)
                continue
            if r["em"] == FULL:
                em_new = (r["qm"] & ~gm) if (r["qm"] & gm) else FULL
            else:
                em_new = r["em"] & ~gm
            if em_new == 0:
                close(r)
            else:
                r["em"] = em_new
                still.append(r)
        live = still
    for r in live:
        close(r)
    return _toposort_kernels(closed, items)


def _toposort_kernels(kernels: List[Kernel], items: Sequence[Item]) -> List[Kernel]:
    """Order kernels so concatenation is topologically equivalent to the input
    sequence (Thm. 2 guarantees a valid order exists)."""
    # dependency: K1 -> K2 if exists g1 in K1, g2 in K2, g1 < g2 sharing a qubit
    pos_mask: Dict[int, int] = {}
    for it in items:
        gmasks = it.gate_masks or (it.mask,) * len(it.gate_ids)
        for gid, gmask in zip(it.gate_ids, gmasks):
            pos_mask[gid] = gmask
    idx_of: Dict[int, int] = {}
    for ki, k in enumerate(kernels):
        for gid in k.gate_ids:
            idx_of[gid] = ki
    n = len(kernels)
    succ: List[set] = [set() for _ in range(n)]
    indeg = [0] * n
    last_on_qubit: Dict[int, int] = {}
    for gid in sorted(pos_mask):
        ki = idx_of[gid]
        m = pos_mask[gid]
        q = 0
        while m:
            if m & 1:
                prev = last_on_qubit.get(q)
                if prev is not None and prev != ki and ki not in succ[prev]:
                    succ[prev].add(ki)
                    indeg[ki] += 1
                last_on_qubit[q] = ki
            m >>= 1
            q += 1
    import heapq

    first_gate = [min(k.gate_ids) for k in kernels]
    heap = [(first_gate[i], i) for i in range(n) if indeg[i] == 0]
    heapq.heapify(heap)
    order: List[int] = []
    while heap:
        _, i = heapq.heappop(heap)
        order.append(i)
        for j in succ[i]:
            indeg[j] -= 1
            if indeg[j] == 0:
                heapq.heappush(heap, (first_gate[j], j))
    assert len(order) == n, "kernel dependency graph has a cycle (Constraint 1 bug)"
    return [kernels[i] for i in order]


def _postprocess_merge(kernels: List[Kernel], items: Sequence[Item], cm: CostModel) -> List[Kernel]:
    """Greedy adjacent-merge (App. B-e): merging adjacent kernels in the
    sequence is always order-safe; merge when it reduces cost."""
    out: List[Kernel] = []
    for k in kernels:
        if out:
            prev = out[-1]
            if prev.kind == k.kind:
                union = sorted(set(prev.qubits) | set(k.qubits))
                nq = len(union)
                ok = (
                    (k.kind == FUSION and nq <= cm.max_fusion_qubits)
                    or (
                        k.kind == SHM
                        and len(set(union) | set(range(cm.io_qubits))) <= cm.max_shm_qubits
                    )
                )
                if ok:
                    if k.kind == FUSION:
                        merged_cost = cm.fusion_cost(nq)
                        saves = merged_cost < prev.cost + k.cost
                    else:
                        merged_cost = prev.cost + k.cost - cm.shm_open_cost()
                        saves = True
                    if saves:
                        out[-1] = Kernel(
                            kind=k.kind,
                            qubits=tuple(union),
                            gate_ids=sorted(prev.gate_ids + k.gate_ids),
                            cost=merged_cost,
                        )
                        continue
        out.append(k)
    return out


# ---------------------------------------------------------------------------
# Alg. 5: ORDEREDKERNELIZE ("Atlas-Naive")
# ---------------------------------------------------------------------------


def ordered_kernelize(
    items: Sequence[Item],
    n_qubits: int,
    cm: CostModel = DEFAULT_COST_MODEL,
) -> KernelizationResult:
    m = len(items)
    io_mask = (1 << cm.io_qubits) - 1
    INF = float("inf")
    dp = [INF] * (m + 1)
    choice: List[Tuple[int, int]] = [(-1, FUSION)] * (m + 1)  # (start j, kind)
    dp[0] = 0.0
    for i in range(m):
        union = 0
        shm_sum = 0.0
        for j in range(i, -1, -1):  # segment items[j..i]
            union |= items[j].mask
            shm_sum += items[j].shm_cost
            k = union.bit_count()
            k_shm = (union | io_mask).bit_count()
            if k > cm.max_fusion_qubits and k_shm > cm.max_shm_qubits:
                break
            cands = []
            if k <= cm.max_fusion_qubits:
                cands.append((cm.fusion_cost(k), FUSION))
            if k_shm <= cm.max_shm_qubits:
                cands.append((cm.shm_open_cost() + shm_sum, SHM))
            cseg, kind = min(cands)
            if dp[j] + cseg < dp[i + 1]:
                dp[i + 1] = dp[j] + cseg
                choice[i + 1] = (j, kind)
    # reconstruct
    kernels: List[Kernel] = []
    i = m
    while i > 0:
        j, kind = choice[i]
        seg = items[j:i]
        union = 0
        gids: List[int] = []
        for it in seg:
            union |= it.mask
            gids.extend(it.gate_ids)
        shm_extra = sum(it.shm_cost for it in seg) if kind == SHM else 0.0
        kernels.append(
            Kernel(
                kind=kind,
                qubits=tuple(q for q in range(n_qubits) if (union >> q) & 1),
                gate_ids=sorted(gids),
                cost=(cm.fusion_cost(union.bit_count()) if kind == FUSION
                      else cm.shm_open_cost() + shm_extra),
            )
        )
        i = j
    kernels.reverse()
    return KernelizationResult(
        kernels=kernels,
        total_cost=sum(k.cost for k in kernels),
        method="ordered_dp",
    )


# ---------------------------------------------------------------------------
# Greedy baseline (§VII-E): pack into fusion kernels of up to 5 qubits
# ---------------------------------------------------------------------------


def greedy_kernelize(
    items: Sequence[Item],
    n_qubits: int,
    cm: CostModel = DEFAULT_COST_MODEL,
    max_qubits: int = 5,
) -> KernelizationResult:
    kernels: List[Kernel] = []
    cur_mask, cur_gids = 0, []  # type: int, List[int]

    def flush():
        nonlocal cur_mask, cur_gids
        if cur_gids:
            kernels.append(
                Kernel(
                    kind=FUSION,
                    qubits=tuple(q for q in range(n_qubits) if (cur_mask >> q) & 1),
                    gate_ids=sorted(cur_gids),
                    cost=cm.fusion_cost(cur_mask.bit_count()),
                )
            )
        cur_mask, cur_gids = 0, []

    for it in items:
        if (cur_mask | it.mask).bit_count() > max_qubits:
            flush()
        cur_mask |= it.mask
        cur_gids.extend(it.gate_ids)
    flush()
    return KernelizationResult(
        kernels=kernels,
        total_cost=sum(k.cost for k in kernels),
        method="greedy_pack",
    )


def validate_kernelization(gates_or_circuit, kernels: List[Kernel], n_gates: int) -> None:
    """Kernels partition all gates; concatenation respects dependencies."""
    order: List[int] = []
    for k in kernels:
        order.extend(k.gate_ids)
    assert sorted(order) == list(range(n_gates)), "kernels must partition the gates"
    if isinstance(gates_or_circuit, Circuit):
        pos = {gid: i for i, gid in enumerate(order)}
        for a, b in gates_or_circuit.dependencies():
            assert pos[a] < pos[b], f"dependency {a}->{b} violated by kernel order"
