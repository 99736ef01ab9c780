"""Stage compiler: SimulationPlan -> executable StageProgram list.

(Copied from ``repro/sim/compile.py`` so this package imports nothing of the
JAX package; only imports differ.)

Turns each planned stage into a sequence of data-parallel ops over the local
shard, with all non-local (regional/global) qubit interaction reduced to:

* **dep-batched tensors** — a kernel whose member gates have insular non-local
  qubits becomes a tensor ``T[2^d, 2^k, 2^k]`` indexed by the *stored* values
  of the d non-local bits (diagonal action -> entry selection, control ->
  U-vs-I selection);
* **scalar diagonals** — fully non-local diagonal gates become per-shard
  scalars ``[2^d]``;
* **lazy flips** — anti-diagonal action on a non-local qubit never moves data:
  it toggles a flip bit (Häner-Steiger relabeling, paper Def. 2/App. B-a) that
  (a) re-specializes every later gate referencing that qubit and (b) is
  materialized for free inside the next inter-stage remap.

The executors (pjit / offload / Pallas) consume StagePrograms unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.circuit import Circuit, Gate
from ..core.cost_model import FUSION, SHM
from ..core.gates import UnboundParameterError
from ..core.partition import SimulationPlan
from . import faults
from .apply import embed_matrix, gather_bits, scatter_bits, specialize_gate

INSULAR_KIND = 2  # kernel.kind for zero-footprint bookkeeping kernels


def _value_matrix(g: Gate) -> np.ndarray:
    """Matrix supplying tensor VALUES: the bound matrix for concrete
    parametric gates, the structural (probe) matrix otherwise. All
    *classification* decisions use ``g.structural_matrix`` regardless, so the
    emitted op stream (kinds, bits, shapes, flips, uids) is identical for
    every binding of one structure — only the tensor values differ. An
    unbound circuit compiles with probe-value placeholder tensors
    (``CompiledCircuit.needs_binding``)."""
    if not g.params or not g.is_bound:
        return g.structural_matrix
    return g.matrix


@dataclass
class Op:
    """One data-parallel operation on the sharded state.

    kind: 'fused' (tensor [2^d, 2^k, 2^k]), 'diag' (tensor [2^d, 2^k]),
    'scalar' (tensor [2^d]), 'shm' (a whole shared-memory kernel: ``gates``
    holds the member ops, applied in order inside ONE memory pass).
    ``local_bits``: physical local bit positions (ascending), len k; for
    'shm' this is the kernel's VMEM window (union of member local bits).
    ``dep_bits``: physical non-local bit positions (ascending), len d.
    """

    kind: str
    local_bits: Tuple[int, ...]
    dep_bits: Tuple[int, ...]
    tensor: np.ndarray
    gate_ids: Tuple[int, ...] = ()
    shm_group: int = -1  # >=0: index of the VMEM(SHM) kernel this op belongs to
    gates: Tuple["Op", ...] = ()  # 'shm' only: member ops in application order
    uid: int = -1  # stable per-CompiledCircuit id, assigned by compile_plan
    # (cache keys must use `uid`, never `id(op)`: CPython reuses object ids
    # after GC, which can silently serve a stale tensor)

    @property
    def n_gates(self) -> int:
        return len(self.gate_ids)


@dataclass
class RemapSpec:
    """Bit permutation between two layouts (+ flips to materialize).

    ``src_bit_of[p]`` = old physical bit feeding new physical bit p.
    ``flip_bits``: old physical bit positions whose axis must be reversed
    (pending lazy flips), applied before the permutation.
    """

    src_bit_of: Tuple[int, ...]
    flip_bits: Tuple[int, ...]

    @property
    def is_identity(self) -> bool:
        return not self.flip_bits and all(i == p for p, i in enumerate(self.src_bit_of))

    def inverse(self) -> "RemapSpec":
        """The spec undoing this one. Forward is flips-then-permute
        (``F = P∘Φ_f``); the inverse ``Φ_f∘P⁻¹`` re-expressed in
        flips-first form is ``P⁻¹∘Φ_g`` with ``g = P(f)`` — the positions
        the flipped bits landed on."""
        src_inv = [0] * len(self.src_bit_of)
        for p, b in enumerate(self.src_bit_of):
            src_inv[b] = p
        flips = set(self.flip_bits)
        g = tuple(sorted(p for p, b in enumerate(self.src_bit_of) if b in flips))
        return RemapSpec(src_bit_of=tuple(src_inv), flip_bits=g)


@dataclass
class StageProgram:
    ops: List[Op]
    layout: Tuple[int, ...]  # physical bit p holds logical qubit layout[p]
    remap_after: Optional[RemapSpec]  # None for last stage (see final_remap)
    n_shm_groups: int = 0

    @property
    def n_passes(self) -> int:
        """HBM read+write passes this stage costs: one per top-level op (an
        'shm' op is ONE pass regardless of its gate count)."""
        return len(self.ops)

    @property
    def n_gates(self) -> int:
        return sum(op.n_gates for op in self.ops)


@dataclass
class CompiledCircuit:
    n: int
    L: int
    R: int
    G: int
    programs: List[StageProgram]
    initial_remap: Optional[RemapSpec]  # identity layout -> stage-0 layout
    final_remap: Optional[RemapSpec]  # last layout (+pending flips) -> identity
    dtype: np.dtype = np.complex64
    needs_binding: bool = False  # True: tensors are probe placeholders (the
    # circuit had unbound symbolic params); bind before executing

    @property
    def total_passes(self) -> int:
        return sum(p.n_passes for p in self.programs)

    @property
    def total_gates(self) -> int:
        return sum(p.n_gates for p in self.programs)

    def reverse(self) -> "CompiledCircuit":
        """The reverse-ordered inverse op stream: a CompiledCircuit computing
        ``U†`` for this circuit's ``U``, executable by every backend
        unchanged.

        Mechanical inversion of the *executed* linear maps: stages run in
        reverse order, each stage's ops in reverse order with inverted
        tensors (``T[v]†`` per dep combo — dep bits only select, so the
        block-diagonal inverse is per-variant), shm members reversed inside
        their single pass, and every remap replaced by its
        :meth:`RemapSpec.inverse`. Lazy-flip bookkeeping needs no special
        casing: flips were materialized inside the remaps being inverted.
        The adjoint gradient sweep (:mod:`repro.sim.adjoint`) is the prime
        consumer (undoing the forward state); ``initial``/``final`` remaps
        swap roles.
        """
        rev_programs: List[StageProgram] = []
        progs = self.programs
        for i in range(len(progs) - 1, -1, -1):
            prog = progs[i]
            remap = progs[i - 1].remap_after.inverse() if i > 0 else None
            rev_programs.append(StageProgram(
                ops=[_invert_op(op) for op in reversed(prog.ops)],
                layout=prog.layout,
                remap_after=remap,
                n_shm_groups=prog.n_shm_groups,
            ))
        cc = CompiledCircuit(
            n=self.n, L=self.L, R=self.R, G=self.G, programs=rev_programs,
            initial_remap=(self.final_remap.inverse()
                           if self.final_remap is not None else None),
            final_remap=(self.initial_remap.inverse()
                         if self.initial_remap is not None else None),
            dtype=self.dtype, needs_binding=self.needs_binding,
        )
        uid = 0
        for prog in cc.programs:
            for op in prog.ops:
                for o in (op,) + op.gates:
                    o.uid = uid
                    uid += 1
        return cc


def _invert_op(op: Op) -> Op:
    """Invert one op (fresh Op; uids reassigned by the caller)."""
    if op.kind == "shm":
        members = tuple(_invert_op(m) for m in reversed(op.gates))
        return Op("shm", op.local_bits, op.dep_bits,
                  np.zeros((0,), dtype=op.tensor.dtype), op.gate_ids,
                  shm_group=op.shm_group, gates=members)
    if op.kind == "fused":
        T = np.ascontiguousarray(np.conj(np.swapaxes(op.tensor, -1, -2)))
    else:  # 'diag' [2^d, 2^k] / 'scalar' [2^d]: unitary diagonal -> conj
        T = np.conj(op.tensor)
    return Op(op.kind, op.local_bits, op.dep_bits, T, op.gate_ids,
              shm_group=op.shm_group)


MAX_DEP_ENTRIES = 1 << 24  # cap on 2^d * 4^k tensor entries per op


def _remap_spec(
    old_layout: Sequence[int], new_layout: Sequence[int], flips_logical: Dict[int, int]
) -> RemapSpec:
    phys_old = {q: p for p, q in enumerate(old_layout)}
    src = tuple(phys_old[q] for q in new_layout)
    flip_bits = tuple(sorted(phys_old[q] for q, f in flips_logical.items() if f))
    return RemapSpec(src_bit_of=src, flip_bits=flip_bits)


def compile_plan(
    circuit: Circuit, plan: SimulationPlan, dtype=np.complex64,
    peephole: bool = True, struct_cache: Optional[Dict] = None,
) -> CompiledCircuit:
    """``struct_cache`` (optional, engine-owned, persists across parameter
    rebindings of ONE structure+plan): memoizes every binding-independent
    artifact of the op build — structural classifications (diag/fused/drop),
    per-combo variant indices, and constant gates' embedded matrix stacks —
    so a rebinding pass only re-specializes the parametric gates and redoes
    the value matmuls, in the same order (bit-identical results)."""
    if faults._ACTIVE is not None:
        faults.maybe_inject("xla_trace_error", site="compile.compile_plan")
    n, L = plan.n_qubits, plan.L
    programs: List[StageProgram] = []
    flips: Dict[int, int] = {}  # logical qubit -> pending lazy flip (non-local only)

    for si, st in enumerate(plan.stages):
        layout = st.layout
        phys_of = {q: p for p, q in enumerate(layout)}

        # --- pass 1: flip schedule in original gate order -------------------
        order = sorted(st.gate_ids)
        flip_before: Dict[int, Dict[int, int]] = {}
        for gid in order:
            g = circuit.gates[gid]
            flip_before[gid] = dict(flips)
            nl_bits = [j for j, q in enumerate(g.qubits) if phys_of[q] >= L]
            if nl_bits:
                # structural flip detection: which non-local matrix bits are
                # anti-diagonal (combo- and binding-independent)
                _, flipped = specialize_gate(
                    g.structural_matrix, nl_bits, [0] * len(nl_bits)
                )
                for j in flipped:
                    q = g.qubits[j]
                    flips[q] = flips.get(q, 0) ^ 1

        # --- pass 2: build ops per kernel -----------------------------------
        ops: List[Op] = []
        shm_groups = 0
        for kern in st.kernels:
            gids = sorted(kern.gate_ids)
            if kern.kind == FUSION:
                built = _build_fused(circuit, gids, kern.qubits, phys_of, L,
                                     flip_before, dtype, struct_cache)
                ops.extend(built)
            elif kern.kind == SHM:
                members: List[Op] = []
                for gid in gids:
                    members.extend(_build_fused(circuit, [gid], None, phys_of, L,
                                                flip_before, dtype, struct_cache))
                if peephole:
                    members = _peephole(members, dtype)
                if len(members) <= 1 or all(m.kind == "scalar" for m in members):
                    ops.extend(members)  # degenerate group: no kernel needed
                else:
                    grp = shm_groups
                    shm_groups += 1
                    window = sorted({b for m in members for b in m.local_bits})
                    dep = sorted({p for m in members for p in m.dep_bits})
                    all_gids = tuple(sorted(g for m in members for g in m.gate_ids))
                    ops.append(Op(
                        "shm", tuple(window), tuple(dep),
                        np.zeros((0,), dtype=dtype), all_gids,
                        shm_group=grp, gates=tuple(members),
                    ))
            else:  # INSULAR_KIND: zero-footprint gates -> scalars (flips done)
                for gid in gids:
                    op = _build_scalar(circuit, gid, phys_of, L, flip_before,
                                       dtype, struct_cache)
                    if op is not None:
                        ops.append(op)
        if peephole:
            ops = _peephole(ops, dtype)

        # --- remap to next stage --------------------------------------------
        if si + 1 < len(plan.stages):
            remap = _remap_spec(layout, plan.stages[si + 1].layout, flips)
            flips = {}
        else:
            remap = None
        programs.append(
            StageProgram(ops=ops, layout=layout, remap_after=remap,
                         n_shm_groups=shm_groups)
        )

    first_layout = plan.stages[0].layout
    identity = tuple(range(n))
    initial = None
    if tuple(first_layout) != identity:
        initial = _remap_spec(identity, first_layout, {})
    final = None
    last_layout = plan.stages[-1].layout
    if tuple(last_layout) != identity or any(flips.values()):
        final = _remap_spec(last_layout, identity, flips)
    uid = 0
    for prog in programs:
        for op in prog.ops:
            for o in (op,) + op.gates:
                o.uid = uid
                uid += 1
    return CompiledCircuit(
        n=n, L=L, R=plan.R, G=plan.G, programs=programs,
        initial_remap=initial, final_remap=final, dtype=np.dtype(dtype),
        needs_binding=not circuit.is_bound,
    )


def _gate_bit_split(g: Gate, phys_of: Dict[int, int], L: int):
    loc = [(j, phys_of[g.qubits[j]]) for j in range(g.n_qubits) if phys_of[g.qubits[j]] < L]
    nl = [(j, phys_of[g.qubits[j]]) for j in range(g.n_qubits) if phys_of[g.qubits[j]] >= L]
    return loc, nl


def _gate_variants(g: Gate, nl_idx: Sequence[int]) -> List[np.ndarray]:
    """Bound-value specializations of one gate over its non-local bits,
    branch-classified by the structural matrix."""
    sm = g.structural_matrix
    bm = _value_matrix(g)
    nv = len(nl_idx)
    if bm is sm:
        return [
            specialize_gate(sm, nl_idx, [(v >> jj) & 1 for jj in range(nv)])[0]
            for v in range(1 << nv)
        ]
    return [
        specialize_gate(bm, nl_idx, [(v >> jj) & 1 for jj in range(nv)],
                        classify=sm)[0]
        for v in range(1 << nv)
    ]


def _build_fused(
    circuit: Circuit,
    gids: Sequence[int],
    kernel_qubits: Optional[Tuple[int, ...]],
    phys_of: Dict[int, int],
    L: int,
    flip_before: Dict[int, Dict[int, int]],
    dtype,
    struct_cache: Optional[Dict] = None,
) -> List[Op]:
    """Build the dep-batched fused tensor for one fusion kernel (or a single
    gate when ``gids`` has one element). Splits the kernel if the dep set is
    too large."""
    gates = [circuit.gates[g] for g in gids]
    # kernel local bits
    if kernel_qubits is None:
        kq: List[int] = sorted(
            {phys_of[q] for g in gates for q in g.qubits if phys_of[q] < L}
        )
    else:
        kq = sorted(kernel_qubits)
    k = len(kq)
    pos_in_kernel = {p: i for i, p in enumerate(kq)}
    # dep bits: union of non-local physical bits
    dep = sorted({phys_of[q] for g in gates for q in g.qubits if phys_of[q] >= L})
    d = len(dep)
    if k == 0:
        # fully non-local kernel (can happen for 1-gate builds)
        out = []
        for gid in gids:
            op = _build_scalar(circuit, gid, phys_of, L, flip_before, dtype,
                               struct_cache)
            if op is not None:
                out.append(op)
        return out
    if (1 << d) * (1 << (2 * k)) > MAX_DEP_ENTRIES and len(gids) > 1:
        # too many dep combos: apply member gates individually
        out = []
        for gid in gids:
            out.extend(_build_fused(circuit, [gid], None, phys_of, L,
                                    flip_before, dtype, struct_cache))
        return out
    dep_pos = {p: i for i, p in enumerate(dep)}

    ckey = ("f", tuple(gids))
    cached = None if struct_cache is None else struct_cache.get(ckey)
    if cached is not None:
        const_ops = cached.get("ops")
        if const_ops is not None:
            # constant kernel: every gate's values are binding-independent,
            # so the first build's tensors are exact for ALL bindings —
            # fresh Op shells share them (uids are reassigned per compile)
            return [Op(o.kind, o.local_bits, o.dep_bits, o.tensor,
                       o.gate_ids) for o in const_ops]
        # rebinding fast path: run the kernel's folded program (consecutive
        # constant gates pre-multiplied ONCE into shared segment products,
        # local parametric gates applied as small bit-axis contractions).
        # The same executor serves the batched sweep path with P > 1, so a
        # rebind here is bit-identical to slice p of a coalesced sweep.
        T = _exec_kernel([circuit], cached, k, d)[0]
        if cached["kind"] == "diag":
            diag = np.ascontiguousarray(np.einsum("dii->di", T)).astype(dtype)
            return [Op("diag", tuple(kq), tuple(dep), diag, tuple(gids))]
        return [Op("fused", tuple(kq), tuple(dep), T.astype(dtype), tuple(gids))]

    # Batched build over all dep combos: each gate is specialized once per
    # combination of ITS OWN non-local bits (2^d_g variants, not 2^d), the
    # variants are gathered per-combo with index arithmetic, and the product
    # over gates is one batched matmul per gate. The product is built twice
    # when the kernel contains parametric gates: T carries the bound VALUES,
    # Ts the structural (generic-probe) values — the diagonal-vs-fused
    # classification runs on Ts so the op kind is the same for every binding
    # (structurally-diagonal products stay numerically diagonal at all
    # bindings; the converse coincidence at special angles is ignored).
    combos = np.arange(1 << d)
    T = np.broadcast_to(np.eye(1 << k, dtype=np.complex128),
                        (1 << d, 1 << k, 1 << k)).copy()
    Ts = T.copy()
    scal = np.ones(1 << d, dtype=np.complex128)
    scal_s = np.ones(1 << d, dtype=np.complex128)
    parametric = False
    per_gate = []  # (gid, vg, nl_idx, positions|None, E_const|None)
    for g, gid in zip(gates, gids):
        loc, nl = _gate_bit_split(g, phys_of, L)
        fb = flip_before[gid]
        # per-combo variant index over this gate's own non-local bits
        vg = np.zeros(1 << d, dtype=np.int64)
        for jj, (j, p) in enumerate(nl):
            bit = ((combos >> dep_pos[p]) & 1) ^ fb.get(g.qubits[j], 0)
            vg |= bit << jj
        nl_idx = [j for j, _ in nl]
        sm = g.structural_matrix
        bm = _value_matrix(g)
        variants_s = [
            specialize_gate(sm, nl_idx, [(v >> jj) & 1 for jj in range(len(nl))])[0]
            for v in range(1 << len(nl))
        ]
        if bm is sm:
            variants = variants_s
        else:
            parametric = True
            variants = [
                specialize_gate(bm, nl_idx,
                                [(v >> jj) & 1 for jj in range(len(nl))],
                                classify=sm)[0]
                for v in range(1 << len(nl))
            ]
        if not loc:
            scal *= np.array([m[0, 0] for m in variants])[vg]
            scal_s *= np.array([m[0, 0] for m in variants_s])[vg]
            per_gate.append((gid, vg, nl_idx, None, None))
            continue
        positions = [pos_in_kernel[p] for _, p in loc]
        E = np.stack([embed_matrix(m, positions, k) for m in variants])
        T = np.matmul(E[vg], T)
        if variants is variants_s:
            Es = E
        else:
            Es = np.stack([embed_matrix(m, positions, k) for m in variants_s])
        Ts = np.matmul(Es[vg], Ts)
        per_gate.append(
            (gid, vg, nl_idx, positions, E if variants is variants_s else None)
        )
    T *= scal[:, None, None]
    Ts *= scal_s[:, None, None]
    if not parametric:
        Ts = T
    # diagonal detection (structural: same classification for every binding)
    off = Ts - np.einsum("dij,ij->dij", Ts, np.eye(1 << k))
    is_diag = np.abs(off).max() < 1e-12
    if struct_cache is not None:
        struct_cache[ckey] = {
            "kind": "diag" if is_diag else "fused",
            "per_gate": per_gate,
        }
        if parametric:
            # re-derive the values through the folded program so the FIRST
            # binding is bit-identical to every later rebind and to every
            # slice of a coalesced sweep (the gate-by-gate product above is
            # only needed for the structural diag/fused classification)
            T = _exec_kernel([circuit], struct_cache[ckey], k, d)[0]
    if is_diag:
        diag = np.ascontiguousarray(np.einsum("dii->di", T)).astype(dtype)
        out = [Op("diag", tuple(kq), tuple(dep), diag, tuple(gids))]
    else:
        out = [Op("fused", tuple(kq), tuple(dep), T.astype(dtype),
                  tuple(gids))]
    if struct_cache is not None and not parametric:
        struct_cache[ckey]["ops"] = out
    return out


def _kernel_prog(circuit: Circuit, cached: Dict, k: int) -> List[Tuple]:
    """Fold a kernel's cached per-gate sequence into an execution program.

    Consecutive constant gates collapse into ONE pre-multiplied segment
    product (computed here, once per structure, and shared by every
    subsequent rebind AND every sweep slice — so the fold introduces no
    cross-path rounding differences). Parametric gates stay as explicit
    steps. Step forms:

    * ``("C", C)``  — const segment product, ``[2^d, K, K]``
    * ``("CS", v)`` — folded const scalar factors, ``[2^d]``
    * ``("PL", members, idx, u)`` — a RUN of fully-local parametric gates
      (union footprint <= 3 bits): each gate's bound value matrix is masked
      to its structural nonzero pattern (``specialize_gate(bm, [], [],
      classify=sm)``), embedded into the run's small union space, chained
      into one ``[P, 2^u, 2^u]`` product, and applied by contracting the
      union's row-bit axes (``idx`` partitions the ``K`` rows into
      ``rest x sub``) — ONE ``O(K^2 2^u)`` pass over the kernel tensor
      instead of a full ``K^3`` matmul per gate
    * ``("PS", gid, vg, nl_idx)`` — parametric scalar factor
    * ``("PN", gid, vg, nl_idx, positions)`` — parametric gate with
      non-local bits: per-point specialize + embed + full matmul
    """
    prog: List[Tuple] = []
    seg = None
    pend: List[Tuple] = []  # pending (gid, rows, cols, positions) PL run
    upos: List[int] = []    # the run's union footprint (kernel bit indices)

    def _flush_pl():
        nonlocal pend, upos
        if not pend:
            return
        if len(pend) == 1:
            # single gate: keep ITS bit order so the masked matrix applies
            # directly (no union-space embedding)
            upos = list(pend[0][3])
        u = len(upos)
        rest = [b for b in range(k) if b not in upos]
        base = scatter_bits(np.arange(1 << len(rest)), rest)
        sub = scatter_bits(np.arange(1 << u), upos)
        idx = base[:, None] | sub[None, :]  # [K/2^u, 2^u] row partition
        members = []
        for gid, rows, cols, positions_ in pend:
            rel = [upos.index(p) for p in positions_]
            rest_u = [b for b in range(u) if b not in rel]
            base_u = scatter_bits(np.arange(1 << len(rest_u)), rest_u)
            sub_u = scatter_bits(np.arange(1 << len(rel)), rel)
            Rg = base_u[:, None, None] | sub_u[None, :, None]
            Cg = base_u[:, None, None] | sub_u[None, None, :]
            members.append((gid, rows, cols, Rg, Cg))
        prog.append(("PL", members, idx, u))
        pend, upos = [], []

    for gid, vg, nl_idx, positions, E_const in cached["per_gate"]:
        if E_const is not None:
            _flush_pl()
            sel = E_const[vg]
            seg = sel.copy() if seg is None else np.matmul(sel, seg)
            continue
        g = circuit.gates[gid]
        if positions is None:
            # scalar factors commute with everything: no flush needed
            if not g.params:
                vec = np.array([m[0, 0] for m in _gate_variants(g, nl_idx)])[vg]
                prog.append(("CS", vec))
            else:
                prog.append(("PS", gid, vg, nl_idx))
            continue
        if seg is not None:
            prog.append(("C", seg))
            seg = None
        if not nl_idx:
            sm = g.structural_matrix
            rows, cols = np.nonzero(np.abs(sm) > 1e-14)
            positions_ = list(positions)
            union = sorted(set(upos) | set(positions_))
            if pend and len(union) > 3:
                _flush_pl()
                union = sorted(positions_)
            pend.append((gid, rows, cols, positions_))
            upos = union
        else:
            _flush_pl()
            prog.append(("PN", gid, vg, nl_idx, list(positions)))
    _flush_pl()
    if seg is not None:
        prog.append(("C", seg))
    return prog


def _exec_kernel(circuits: Sequence[Circuit], cached: Dict,
                 k: int, d: int) -> np.ndarray:
    """Run one kernel's folded program for ``P`` bindings at once, returning
    the ``[P, 2^d, K, K]`` complex128 product. The per-point rebind path
    calls this with ``P = 1`` and the sweep path with the full batch, so both
    produce bit-identical values (same arrays, same operations, and numpy's
    batched matmul is bitwise-identical per slice)."""
    P, K, D = len(circuits), 1 << k, 1 << d
    prog = cached.get("prog")
    if prog is None:
        prog = cached["prog"] = _kernel_prog(circuits[0], cached, k)
    T = None
    scal = None
    for step in prog:
        tag = step[0]
        if tag == "C":
            Cm = step[1]
            T = (np.broadcast_to(Cm, (P,) + Cm.shape).copy() if T is None
                 else np.matmul(Cm[None], T))
        elif tag == "CS":
            vec = step[1]
            scal = (np.broadcast_to(vec, (P, D)).copy() if scal is None
                    else scal * vec[None])
        elif tag == "PS":
            _, gid, vg, nl_idx = step
            vals = np.stack([
                np.array([m[0, 0] for m in
                          _gate_variants(c.gates[gid], nl_idx)])[vg]
                for c in circuits
            ])
            scal = vals if scal is None else scal * vals
        elif tag == "PL":
            _, members, idx, u = step
            U = 1 << u
            comb = None
            for gid, rows, cols, Rg, Cg in members:
                mats = np.stack([
                    np.asarray(_value_matrix(c.gates[gid]),
                               dtype=np.complex128)
                    for c in circuits
                ])
                spec = np.zeros_like(mats)
                spec[:, rows, cols] = mats[:, rows, cols]
                if len(members) == 1:
                    comb = spec
                    break
                E = np.zeros((P, U, U), dtype=np.complex128)
                E[:, Rg, Cg] = spec[:, None, :, :]
                comb = E if comb is None else np.matmul(E, comb)
            if T is None:
                # E @ I == E bitwise: seed T with the embedded run directly
                E = np.zeros((P, K, K), dtype=np.complex128)
                E[:, idx[:, :, None], idx[:, None, :]] = comb[:, None, :, :]
                T = np.broadcast_to(E[:, None], (P, D, K, K)).copy()
            else:
                # contract the union's row-bit axes: rows K -> (rest, sub),
                # out[.., base|sub_a, :] = sum_b comb[a, b] T[.., base|sub_b, :]
                Tg = T[:, :, idx, :]                       # [P, D, rest, U, K]
                out = np.matmul(comb[:, None, None], Tg)   # [P, D, rest, U, K]
                Tn = np.empty_like(T)
                Tn[:, :, idx, :] = out
                T = Tn
        else:  # "PN"
            _, gid, vg, nl_idx, positions = step
            if T is None:
                T = np.broadcast_to(np.eye(K, dtype=np.complex128),
                                    (P, D, K, K)).copy()
            for p, c in enumerate(circuits):
                E = np.stack([
                    embed_matrix(m, positions, k)
                    for m in _gate_variants(c.gates[gid], nl_idx)
                ])
                T[p] = np.matmul(E[vg], T[p])
    if T is None:
        T = np.broadcast_to(np.eye(K, dtype=np.complex128),
                            (P, D, K, K)).copy()
    if scal is not None:
        T = T * scal[:, :, None, None]
    return T


def _build_scalar(
    circuit: Circuit, gid: int, phys_of: Dict[int, int], L: int,
    flip_before: Dict[int, Dict[int, int]], dtype,
    struct_cache: Optional[Dict] = None,
) -> Optional[Op]:
    g = circuit.gates[gid]
    loc, nl = _gate_bit_split(g, phys_of, L)
    assert not loc, "scalar build requires zero local footprint"
    dep = sorted(p for _, p in nl)
    dep_pos = {p: i for i, p in enumerate(dep)}
    fb = flip_before[gid]
    nl_idx = [j for j, _ in nl]

    ckey = ("s", gid)
    cached = None if struct_cache is None else struct_cache.get(ckey)
    if cached is not None:
        if cached["drop"]:
            return None
        vg = cached["vg"]
        if cached["variants"] is not None:  # constant gate
            vec = cached["variants"][vg]
        else:
            variants = np.array([m[0, 0] for m in _gate_variants(g, nl_idx)])
            vec = variants[vg]
        return Op("scalar", (), tuple(dep), vec.astype(dtype), (gid,))

    sm = g.structural_matrix
    bm = _value_matrix(g)
    variants_s = np.array([
        specialize_gate(sm, nl_idx, [(v >> jj) & 1 for jj in range(len(nl))])[0][0, 0]
        for v in range(1 << len(nl))
    ])
    if bm is sm:
        variants = variants_s
    else:
        variants = np.array([
            specialize_gate(bm, nl_idx, [(v >> jj) & 1 for jj in range(len(nl))],
                            classify=sm)[0][0, 0]
            for v in range(1 << len(nl))
        ])
    combos = np.arange(1 << len(dep))
    vg = np.zeros(1 << len(dep), dtype=np.int64)
    for jj, (j, p) in enumerate(nl):
        vg |= (((combos >> dep_pos[p]) & 1) ^ fb.get(g.qubits[j], 0)) << jj
    vec = variants[vg]
    # identity drop is decided structurally (e.g. pure control selection with
    # U=I) so the op stream is binding-independent; a binding-specific
    # identity (theta=0) keeps its op and multiplies by ones.
    drop = bool(np.allclose(variants_s[vg], 1.0))
    if struct_cache is not None:
        struct_cache[ckey] = {
            "drop": drop,
            "vg": vg,
            "variants": variants_s if bm is sm else None,
        }
    if drop:
        return None
    return Op("scalar", (), tuple(dep), vec.astype(dtype), (gid,))


# ---------------------------------------------------------------------------
# Peephole op-stream fusion: every top-level op costs one HBM read+write pass
# over the shard, so folding adjacent scalar/diag ops into their neighbors is
# a direct pass-count reduction (Fatima & Markov-style fusion, applied to the
# compiled op stream instead of the gate stream).
# ---------------------------------------------------------------------------


def _dep_expand(op: Op, dep_union: Sequence[int]) -> np.ndarray:
    """Re-index ``op.tensor`` from its own dep combos to the union combos."""
    pos = {p: i for i, p in enumerate(dep_union)}
    # union combo -> op's own combo: gather the op's dep bits
    idx = gather_bits(np.arange(1 << len(dep_union)),
                      [pos[p] for p in op.dep_bits])
    return op.tensor.astype(np.complex128)[idx]


def _diag_vals(op: Op, dep_union: Sequence[int], local_union: Sequence[int]) -> np.ndarray:
    """Diagonal weights of a scalar/diag op, expanded to the union dep combos
    and broadcast over the union local index space: [2^du, 2^ku]."""
    e = _dep_expand(op, dep_union)  # [2^du] or [2^du, 2^k_own]
    if op.kind == "scalar":
        return e[:, None]
    pos = {p: i for i, p in enumerate(local_union)}
    lidx = gather_bits(np.arange(1 << len(local_union)),
                       [pos[p] for p in op.local_bits])
    return e[:, lidx]


def _try_merge(a: Op, b: Op, dtype) -> Optional[Op]:
    """Merge two adjacent ops (``a`` applied first) into one, or None."""
    if a.kind in ("shm", "fused") and b.kind in ("shm", "fused"):
        return None
    if a.kind == "shm" or b.kind == "shm":
        return None
    dep_union = sorted(set(a.dep_bits) | set(b.dep_bits))
    gids = tuple(sorted(a.gate_ids + b.gate_ids))

    if a.kind != "fused" and b.kind != "fused":
        # scalar/diag x scalar/diag -> diag (or scalar if no local bits)
        local_union = sorted(set(a.local_bits) | set(b.local_bits))
        if (1 << len(dep_union)) * (1 << len(local_union)) > MAX_DEP_ENTRIES:
            return None
        vals = (_diag_vals(a, dep_union, local_union)
                * _diag_vals(b, dep_union, local_union))
        if not local_union:
            return Op("scalar", (), tuple(dep_union),
                      vals[:, 0].astype(dtype), gids)
        return Op("diag", tuple(local_union), tuple(dep_union),
                  vals.astype(dtype), gids)

    # one side is fused: fold the diagonal side in when its bits are covered
    fused, other, other_first = (b, a, True) if b.kind == "fused" else (a, b, False)
    if other.kind == "diag" and not set(other.local_bits) <= set(fused.local_bits):
        return None
    k = len(fused.local_bits)
    if (1 << len(dep_union)) * (1 << (2 * k)) > MAX_DEP_ENTRIES:
        return None
    T = _dep_expand(fused, dep_union)  # [2^du, K, K]
    dv = _diag_vals(other, dep_union, fused.local_bits)  # [2^du, K] or [2^du, 1]
    # diagonal-first scales the columns (T @ D); diagonal-last the rows (D @ T)
    T = T * dv[:, None, :] if other_first else T * dv[:, :, None]
    return Op("fused", fused.local_bits, tuple(dep_union), T.astype(dtype), gids)


# ---------------------------------------------------------------------------
# Structure/parameter split: the structural plan (stages, kernels, layouts, op
# kinds/bits/shapes/uids, remap specs) is a pure function of the circuit
# STRUCTURE + compile knobs, because every classification above evaluates
# gates at generic probe angles. Rebinding parameters therefore re-materializes
# tensor VALUES only — `bind_tensors` below — without re-running ILP staging,
# DP kernelization, or invalidating XLA executables that take the tensors as
# inputs (see repro.sim.engine).
# ---------------------------------------------------------------------------


def structural_signature(cc: CompiledCircuit) -> Tuple:
    """Hashable signature of everything about a CompiledCircuit EXCEPT tensor
    values. Two compiles of same-structure circuits (any bindings) must agree
    on this; `bind_tensors` asserts it before swapping tensors in. Memoized
    on the CompiledCircuit (op streams are immutable after compile) — the
    serving path recomputes it per rebinding / per sweep point otherwise."""
    sig = getattr(cc, "_sig_memo", None)
    if sig is not None:
        return sig
    progs = []
    for prog in cc.programs:
        ops = []
        for op in prog.ops:
            for o in (op,) + op.gates:
                ops.append((o.uid, o.kind, o.local_bits, o.dep_bits,
                            tuple(o.tensor.shape), o.gate_ids, o.shm_group))
        remap = (prog.remap_after.src_bit_of, prog.remap_after.flip_bits) \
            if prog.remap_after is not None else None
        progs.append((tuple(ops), prog.layout, remap, prog.n_shm_groups))
    edge = tuple(
        (r.src_bit_of, r.flip_bits) if r is not None else None
        for r in (cc.initial_remap, cc.final_remap)
    )
    sig = (cc.n, cc.L, cc.R, cc.G, str(cc.dtype), tuple(progs), edge)
    cc._sig_memo = sig
    return sig


def bind_tensors(
    circuit: Circuit,
    plan: SimulationPlan,
    dtype=np.complex64,
    peephole: bool = True,
    expect: Optional[CompiledCircuit] = None,
    struct_cache: Optional[Dict] = None,
) -> Dict[int, np.ndarray]:
    """The parameter-binding pass: materialize every op tensor for a (fully
    bound) circuit against an existing structural plan.

    Re-runs the numpy tensor-building of :func:`compile_plan` — classification
    is structural, so the op stream comes out identical to ``expect``'s and
    the result is a flat ``Op.uid -> tensor`` table the engine swaps into its
    constant registry. Cost: pure host numpy; no ILP, no DP, no XLA.
    """
    if not circuit.is_bound:
        raise UnboundParameterError(
            f"cannot bind tensors: unbound parameters {circuit.param_names}"
        )
    cc = compile_plan(circuit, plan, dtype=dtype, peephole=peephole,
                      struct_cache=struct_cache)
    if expect is not None and structural_signature(cc) != structural_signature(expect):
        raise ValueError(
            "parameter binding changed the structural op stream — the cached "
            "plan does not match this circuit (structure drift or compile bug)"
        )
    table: Dict[int, np.ndarray] = {}
    for prog in cc.programs:
        for op in prog.ops:
            for o in (op,) + op.gates:
                if o.tensor.size:
                    table[o.uid] = o.tensor
    return table


# ---------------------------------------------------------------------------
# Batched sweep binding: materialize [P, ...] tensor tables for P bindings of
# ONE structure in a single pass. The serving/run_sweep hot path — a per-point
# `bind_tensors` loop pays the full Python op-build overhead P times, which
# dominates the fused sweep's cost. Here the structural walk (flip schedule,
# kernel scaffolding, peephole merging) runs ONCE, constant kernels broadcast
# their single tensor over P, constant gates inside parametric kernels apply
# as one broadcast batched matmul, and parametric local gates specialize and
# embed vectorized over the binding axis. Every value op mirrors the
# per-point fast path exactly (same order, same dtypes, and numpy batched
# matmul is bitwise-identical per slice), so the result equals P stacked
# `bind_tensors` calls bit for bit — `bind_tensors_sweep` cross-checks point
# 0 against the reference path and falls back per-point on any divergence.
# ---------------------------------------------------------------------------


class _SweepFallback(Exception):
    """Batched build can't proceed (cold cache / unexpected shape); the
    caller falls back to per-point `bind_tensors`."""


def bind_tensors_sweep(
    circuits: Sequence[Circuit],
    plan: SimulationPlan,
    dtype=np.complex64,
    peephole: bool = True,
    expect: Optional[CompiledCircuit] = None,
    struct_cache: Optional[Dict] = None,
) -> Dict[int, np.ndarray]:
    """Batched :func:`bind_tensors` over ``P`` same-structure bound circuits.

    Returns ``Op.uid -> [P, ...]`` arrays, bit-identical to stacking the
    per-point tables. Point 0 always runs through the reference per-point
    path (populating ``struct_cache`` and validating the structural
    signature); the remaining points ride the batched builder when possible.
    """
    if not circuits:
        raise ValueError("empty circuit batch")
    P = len(circuits)
    if struct_cache is not None and P > 1 \
            and struct_cache.get("_sweep_ok", 0) >= 2:
        # steady state: the batched builder has already reproduced the
        # reference path bit-for-bit twice for this structure — skip the
        # per-point reference pass and go straight to the batched build
        try:
            return _bind_sweep_batched(circuits, plan, dtype, peephole,
                                       struct_cache)
        except _SweepFallback:
            pass
    t0 = bind_tensors(circuits[0], plan, dtype=dtype, peephole=peephole,
                      expect=expect, struct_cache=struct_cache)
    if P == 1:
        return {uid: t[None] for uid, t in t0.items()}

    def _per_point():
        tables = [t0] + [
            bind_tensors(c, plan, dtype=dtype, peephole=peephole,
                         expect=expect, struct_cache=struct_cache)
            for c in circuits[1:]
        ]
        return {uid: np.stack([t[uid] for t in tables]) for uid in t0}

    if struct_cache is None:
        return _per_point()
    try:
        table = _bind_sweep_batched(circuits, plan, dtype, peephole,
                                    struct_cache)
    except _SweepFallback:
        return _per_point()
    # bitwise insurance: the batched build must reproduce the reference
    # point-0 table exactly (cheap: a few dozen small-array compares)
    if set(table) != set(t0) or any(
            not np.array_equal(table[uid][0], t0[uid]) for uid in t0):
        return _per_point()
    struct_cache["_sweep_ok"] = struct_cache.get("_sweep_ok", 0) + 1
    return table


def _bind_sweep_batched(
    circuits: Sequence[Circuit],
    plan: SimulationPlan,
    dtype,
    peephole: bool,
    struct_cache: Dict,
) -> Dict[int, np.ndarray]:
    """The batched mirror of :func:`compile_plan`'s stage walk (values only:
    remaps and uids carry no tensors, so only the op stream is rebuilt)."""
    c0 = circuits[0]
    n, L = plan.n_qubits, plan.L
    table: Dict[int, np.ndarray] = {}
    uid = 0
    flips: Dict[int, int] = {}
    for si, st in enumerate(plan.stages):
        layout = st.layout
        phys_of = {q: p for p, q in enumerate(layout)}
        # pass 1: flip schedule — structural, identical for every binding
        order = sorted(st.gate_ids)
        flip_before: Dict[int, Dict[int, int]] = {}
        for gid in order:
            g = c0.gates[gid]
            flip_before[gid] = dict(flips)
            nl_bits = [j for j, q in enumerate(g.qubits) if phys_of[q] >= L]
            if nl_bits:
                _, flipped = specialize_gate(
                    g.structural_matrix, nl_bits, [0] * len(nl_bits))
                for j in flipped:
                    q = g.qubits[j]
                    flips[q] = flips.get(q, 0) ^ 1
        # pass 2: batched ops per kernel
        ops: List[Op] = []
        for kern in st.kernels:
            gids = sorted(kern.gate_ids)
            if kern.kind == FUSION:
                ops.extend(_build_fused_b(circuits, gids, kern.qubits,
                                          phys_of, L, flip_before, dtype,
                                          struct_cache))
            elif kern.kind == SHM:
                members: List[Op] = []
                for gid in gids:
                    members.extend(_build_fused_b(circuits, [gid], None,
                                                  phys_of, L, flip_before,
                                                  dtype, struct_cache))
                if peephole:
                    members = _peephole_b(members, dtype)
                if len(members) <= 1 or all(m.kind == "scalar"
                                            for m in members):
                    ops.extend(members)
                else:
                    window = sorted({b for m in members for b in m.local_bits})
                    dep = sorted({p for m in members for p in m.dep_bits})
                    all_gids = tuple(sorted(g for m in members
                                            for g in m.gate_ids))
                    ops.append(Op("shm", tuple(window), tuple(dep),
                                  np.zeros((0,), dtype=dtype), all_gids,
                                  gates=tuple(members)))
            else:  # INSULAR_KIND
                for gid in gids:
                    op = _build_scalar_b(circuits, gid, phys_of, L,
                                         flip_before, dtype, struct_cache)
                    if op is not None:
                        ops.append(op)
        if peephole:
            ops = _peephole_b(ops, dtype)
        if si + 1 < len(plan.stages):
            flips = {}
        # uid walk matches compile_plan: parents then shm members, in order
        for op in ops:
            for o in (op,) + op.gates:
                if o.tensor.size:
                    table[uid] = o.tensor
                uid += 1
    return table


def _build_fused_b(
    circuits: Sequence[Circuit],
    gids: Sequence[int],
    kernel_qubits: Optional[Tuple[int, ...]],
    phys_of: Dict[int, int],
    L: int,
    flip_before: Dict[int, Dict[int, int]],
    dtype,
    struct_cache: Dict,
) -> List[Op]:
    """Batched mirror of :func:`_build_fused`'s cached fast path (op tensors
    carry a leading binding axis)."""
    P = len(circuits)
    c0 = circuits[0]
    gates0 = [c0.gates[g] for g in gids]
    if kernel_qubits is None:
        kq: List[int] = sorted(
            {phys_of[q] for g in gates0 for q in g.qubits if phys_of[q] < L}
        )
    else:
        kq = sorted(kernel_qubits)
    k = len(kq)
    dep = sorted({phys_of[q] for g in gates0 for q in g.qubits
                  if phys_of[q] >= L})
    d = len(dep)
    if k == 0:
        out = []
        for gid in gids:
            op = _build_scalar_b(circuits, gid, phys_of, L, flip_before,
                                 dtype, struct_cache)
            if op is not None:
                out.append(op)
        return out
    if (1 << d) * (1 << (2 * k)) > MAX_DEP_ENTRIES and len(gids) > 1:
        out = []
        for gid in gids:
            out.extend(_build_fused_b(circuits, [gid], None, phys_of, L,
                                      flip_before, dtype, struct_cache))
        return out

    cached = struct_cache.get(("f", tuple(gids)))
    if cached is None:
        raise _SweepFallback
    const_ops = cached.get("ops")
    if const_ops is not None:
        return [Op(o.kind, o.local_bits, o.dep_bits,
                   np.broadcast_to(o.tensor, (P,) + o.tensor.shape),
                   o.gate_ids) for o in const_ops]

    T = _exec_kernel(circuits, cached, k, d)
    if cached["kind"] == "diag":
        diag = np.ascontiguousarray(np.einsum("pdii->pdi", T)).astype(dtype)
        return [Op("diag", tuple(kq), tuple(dep), diag, tuple(gids))]
    return [Op("fused", tuple(kq), tuple(dep), T.astype(dtype), tuple(gids))]


def _build_scalar_b(
    circuits: Sequence[Circuit],
    gid: int,
    phys_of: Dict[int, int],
    L: int,
    flip_before: Dict[int, Dict[int, int]],
    dtype,
    struct_cache: Dict,
) -> Optional[Op]:
    """Batched mirror of :func:`_build_scalar`'s cached fast path."""
    P = len(circuits)
    g0 = circuits[0].gates[gid]
    loc, nl = _gate_bit_split(g0, phys_of, L)
    assert not loc, "scalar build requires zero local footprint"
    dep = sorted(p for _, p in nl)
    nl_idx = [j for j, _ in nl]
    cached = struct_cache.get(("s", gid))
    if cached is None:
        raise _SweepFallback
    if cached["drop"]:
        return None
    vg = cached["vg"]
    if cached["variants"] is not None:  # constant gate: broadcast
        vec = cached["variants"][vg].astype(dtype)
        return Op("scalar", (), tuple(dep),
                  np.broadcast_to(vec, (P,) + vec.shape), (gid,))
    vals = np.stack([
        np.array([m[0, 0] for m in _gate_variants(c.gates[gid], nl_idx)])[vg]
        for c in circuits
    ])
    return Op("scalar", (), tuple(dep), vals.astype(dtype), (gid,))


def _dep_expand_b(op: Op, dep_union: Sequence[int]) -> np.ndarray:
    """Batched :func:`_dep_expand` (dep axis shifts to axis 1)."""
    pos = {p: i for i, p in enumerate(dep_union)}
    idx = gather_bits(np.arange(1 << len(dep_union)),
                      [pos[p] for p in op.dep_bits])
    return op.tensor.astype(np.complex128)[:, idx]


def _diag_vals_b(op: Op, dep_union: Sequence[int],
                 local_union: Sequence[int]) -> np.ndarray:
    """Batched :func:`_diag_vals`: ``[P, 2^du, 2^ku]``."""
    e = _dep_expand_b(op, dep_union)  # [P, 2^du] or [P, 2^du, 2^k_own]
    if op.kind == "scalar":
        return e[:, :, None]
    pos = {p: i for i, p in enumerate(local_union)}
    lidx = gather_bits(np.arange(1 << len(local_union)),
                       [pos[p] for p in op.local_bits])
    return e[:, :, lidx]


def _try_merge_b(a: Op, b: Op, dtype) -> Optional[Op]:
    """Batched :func:`_try_merge` — identical merge decisions (structural)
    and identical elementwise value math, per binding."""
    if a.kind in ("shm", "fused") and b.kind in ("shm", "fused"):
        return None
    if a.kind == "shm" or b.kind == "shm":
        return None
    dep_union = sorted(set(a.dep_bits) | set(b.dep_bits))
    gids = tuple(sorted(a.gate_ids + b.gate_ids))

    if a.kind != "fused" and b.kind != "fused":
        local_union = sorted(set(a.local_bits) | set(b.local_bits))
        if (1 << len(dep_union)) * (1 << len(local_union)) > MAX_DEP_ENTRIES:
            return None
        vals = (_diag_vals_b(a, dep_union, local_union)
                * _diag_vals_b(b, dep_union, local_union))
        if not local_union:
            return Op("scalar", (), tuple(dep_union),
                      vals[:, :, 0].astype(dtype), gids)
        return Op("diag", tuple(local_union), tuple(dep_union),
                  vals.astype(dtype), gids)

    fused, other, other_first = (b, a, True) if b.kind == "fused" else (a, b, False)
    if other.kind == "diag" and not set(other.local_bits) <= set(fused.local_bits):
        return None
    k = len(fused.local_bits)
    if (1 << len(dep_union)) * (1 << (2 * k)) > MAX_DEP_ENTRIES:
        return None
    T = _dep_expand_b(fused, dep_union)  # [P, 2^du, K, K]
    dv = _diag_vals_b(other, dep_union, fused.local_bits)
    T = T * dv[:, :, None, :] if other_first else T * dv[:, :, :, None]
    return Op("fused", fused.local_bits, tuple(dep_union), T.astype(dtype),
              gids)


def _peephole_b(ops: List[Op], dtype) -> List[Op]:
    """Batched :func:`_peephole`: same left-to-right fold."""
    out: List[Op] = []
    for op in ops:
        while out:
            merged = _try_merge_b(out[-1], op, dtype)
            if merged is None:
                break
            out.pop()
            op = merged
        out.append(op)
    return out


def _peephole(ops: List[Op], dtype) -> List[Op]:
    """Left-to-right fold of adjacent ops (merging preserves application
    order, so it is always sound — diagonal factors compose by elementwise
    multiply, and folding into a fused tensor multiplies on the matching
    side)."""
    out: List[Op] = []
    for op in ops:
        while out:
            merged = _try_merge(out[-1], op, dtype)
            if merged is None:
                break
            out.pop()
            op = merged
        out.append(op)
    return out
