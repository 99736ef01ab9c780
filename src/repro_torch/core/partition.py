"""PARTITION (Alg. 1): STAGE the circuit, then KERNELIZE each stage.

(Copied from ``repro/core/partition.py`` so this package imports nothing of the
JAX package; only imports differ.)

Produces a :class:`SimulationPlan` — the artifact the distributed executor
consumes. The plan is architecture-parameterized by (L, R, G): L local qubits
per shard, R regional (intra-pod) qubits, G global (inter-pod) qubits.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .circuit import Circuit
from .cost_model import CostModel, DEFAULT_COST_MODEL
from .kernelization import (
    Item,
    Kernel,
    KernelizationResult,
    greedy_kernelize,
    items_from_gates,
    kernelize,
    ordered_kernelize,
    validate_kernelization,
)
from .staging import (
    QubitPartition,
    Stage,
    StagingResult,
    stage as run_stage,
    validate_staging,
)


@dataclass
class PlannedStage:
    gate_ids: List[int]
    layout: Tuple[int, ...]  # physical bit i holds logical qubit layout[i]
    local: Tuple[int, ...]
    regional: Tuple[int, ...]
    global_: Tuple[int, ...]
    kernels: List[Kernel]  # kernel qubits are PHYSICAL local indices
    kernel_cost: float


@dataclass
class SimulationPlan:
    n_qubits: int
    L: int
    R: int
    G: int
    stages: List[PlannedStage]
    staging_method: str
    kernelize_method: str
    staging_objective: float
    total_kernel_cost: float
    preprocess_time_s: float
    meta: Dict[str, float] = field(default_factory=dict)

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    def to_json(self) -> str:
        return json.dumps(
            {
                "n_qubits": self.n_qubits,
                "L": self.L,
                "R": self.R,
                "G": self.G,
                "staging_method": self.staging_method,
                "kernelize_method": self.kernelize_method,
                "staging_objective": self.staging_objective,
                "total_kernel_cost": self.total_kernel_cost,
                "preprocess_time_s": self.preprocess_time_s,
                "stages": [
                    {
                        "gate_ids": st.gate_ids,
                        "layout": list(st.layout),
                        "local": list(st.local),
                        "regional": list(st.regional),
                        "global": list(st.global_),
                        "kernels": [
                            {
                                "kind": k.kind,
                                "qubits": list(k.qubits),
                                "gate_ids": list(k.gate_ids),
                                "cost": k.cost,
                            }
                            for k in st.kernels
                        ],
                        "kernel_cost": st.kernel_cost,
                    }
                    for st in self.stages
                ],
            }
        )

    @staticmethod
    def from_json(s: str) -> "SimulationPlan":
        d = json.loads(s)
        stages = [
            PlannedStage(
                gate_ids=st["gate_ids"],
                layout=tuple(st["layout"]),
                local=tuple(st["local"]),
                regional=tuple(st["regional"]),
                global_=tuple(st["global"]),
                kernels=[
                    Kernel(
                        kind=k["kind"],
                        qubits=tuple(k["qubits"]),
                        gate_ids=list(k["gate_ids"]),
                        cost=k["cost"],
                    )
                    for k in st["kernels"]
                ],
                kernel_cost=st["kernel_cost"],
            )
            for st in d["stages"]
        ]
        return SimulationPlan(
            n_qubits=d["n_qubits"],
            L=d["L"],
            R=d["R"],
            G=d["G"],
            stages=stages,
            staging_method=d["staging_method"],
            kernelize_method=d["kernelize_method"],
            staging_objective=d["staging_objective"],
            total_kernel_cost=d["total_kernel_cost"],
            preprocess_time_s=d["preprocess_time_s"],
        )


_KERNELIZERS = {
    "dp": kernelize,
    "ordered": ordered_kernelize,
    "greedy": greedy_kernelize,
}


def partition(
    circuit: Circuit,
    L: int,
    R: int = 0,
    G: int = 0,
    c: Optional[float] = None,
    staging_method: str = "ilp",
    kernelize_method: str = "dp",
    cost_model: CostModel = DEFAULT_COST_MODEL,
    prune_T: int = 500,
    time_limit: float = 120.0,
    validate: bool = True,
) -> SimulationPlan:
    """Alg. 1 PARTITION: hierarchical staging + per-stage kernelization.

    ``c`` (the Eq. 2 global-swap weight) defaults to the cost model's
    ``comm_weight`` so a calibrated/autotuned model steers the ILP
    objective too, not just the kernelizer."""
    assert L + R + G == circuit.n_qubits, "L+R+G must equal n_qubits"
    if c is None:
        c = cost_model.comm_weight
    t0 = time.time()
    if G + R == 0:
        # single-shard simulation: one trivial stage containing everything
        sres = StagingResult(
            stages=[
                Stage(
                    list(range(circuit.n_gates)),
                    QubitPartition(tuple(range(L)), (), ()),
                )
            ],
            objective=0.0,
            solve_time_s=0.0,
            method="trivial",
        )
    else:
        sres = run_stage(circuit, L, R, G, c=c, method=staging_method,
                         **({"time_limit": time_limit} if staging_method == "ilp" else {}))
        if validate:
            validate_staging(circuit, sres.stages, L, R, G)

    kfn = _KERNELIZERS[kernelize_method]
    planned: List[PlannedStage] = []
    total_cost = 0.0
    for st in sres.stages:
        part = st.partition
        qubit_map = {q: i for i, q in enumerate(part.local)}  # logical -> phys local
        gates = [circuit.gates[gid] for gid in st.gate_ids]
        items = items_from_gates(gates, qubit_map=qubit_map, cm=cost_model)
        if items:
            if kernelize_method == "dp":
                kres: KernelizationResult = kfn(items, L, cm=cost_model, prune_T=prune_T)
            else:
                kres = kfn(items, L, cm=cost_model)
            # kernel gate_ids are stage-local positions; lift to circuit gids
            covered = set()
            kernels = []
            for k in kres.kernels:
                gids = [st.gate_ids[i] for i in k.gate_ids]
                covered.update(k.gate_ids)
                kernels.append(Kernel(k.kind, k.qubits, gids, k.cost))
            # zero-footprint gates (all qubits non-local & insular) need no
            # kernel; they execute as shard-wise scalar/relabel ops. Attach
            # them for bookkeeping as a zero-cost "insular" kernel.
            leftovers = [st.gate_ids[i] for i in range(len(gates)) if i not in covered]
        else:
            kernels, leftovers = [], list(st.gate_ids)
        if leftovers:
            kernels.append(Kernel(kind=2, qubits=(), gate_ids=leftovers, cost=0.0))
        cost = sum(k.cost for k in kernels)
        total_cost += cost
        planned.append(
            PlannedStage(
                gate_ids=st.gate_ids,
                layout=part.layout,
                local=part.local,
                regional=part.regional,
                global_=part.global_,
                kernels=kernels,
                kernel_cost=cost,
            )
        )

    plan = SimulationPlan(
        n_qubits=circuit.n_qubits,
        L=L,
        R=R,
        G=G,
        stages=planned,
        staging_method=sres.method,
        kernelize_method=kernelize_method,
        staging_objective=sres.objective,
        total_kernel_cost=total_cost,
        preprocess_time_s=time.time() - t0,
        meta={"comm_weight": float(c),
              "staging_solve_time_s": sres.solve_time_s},
    )
    if validate:
        validate_plan(circuit, plan)
    return plan


def validate_plan(circuit: Circuit, plan: SimulationPlan) -> None:
    order: List[int] = []
    insular_gids = set()  # gates executed as per-shard scalars / deferred flips
    for st in plan.stages:
        st_order: List[int] = []
        for k in st.kernels:
            st_order.extend(k.gate_ids)
            if k.kind == 2:
                insular_gids.update(k.gate_ids)
        assert sorted(st_order) == sorted(st.gate_ids), "stage kernels must cover stage gates"
        order.extend(st_order)
    assert sorted(order) == list(range(circuit.n_gates)), "plan must cover all gates"
    pos = {gid: i for i, gid in enumerate(order)}
    # Zero-footprint (fully non-local insular) gates execute as per-shard
    # scalar multiplies / relabelings specialized against the ORIGINAL gate
    # order by the executor; scalars commute with everything, so they are
    # exempt from the sequence-position check (but stage assignment still
    # respects dependencies via staging's transitive edges).
    for a, b in circuit.dependencies():
        if a in insular_gids or b in insular_gids:
            continue
        assert pos[a] < pos[b], f"plan violates dependency {a}->{b}"
    # locality: every non-insular qubit of every gate is local in its stage
    for st in plan.stages:
        local = set(st.local)
        for gid in st.gate_ids:
            for q in circuit.gates[gid].non_insular_qubits:
                assert q in local, f"gate {gid} non-insular qubit {q} not local"
