"""What each rank of ``tests/test_torch_shardmap_grad.py`` runs (imports no
JAX, so the spawned ranks start quickly), and the 4-rank card test of
``tests/test_torch_gpu.py``. :func:`main` differentiates every case on one
rank of a gloo group through ``backend="shardmap"`` and returns what it
found; a case that raises records its traceback, so the tests that read it
fail alone."""

from __future__ import annotations

import os
import traceback

import numpy as np

from repro_torch.core import kernelization, staging
from repro_torch.core.circuit import Circuit
from repro_torch.core.partition import SimulationPlan
from repro_torch.kernels import ops
from repro_torch.sim import collective
from repro_torch.sim.engine import ExecutionEngine


def _warm_counts(eng):
    return (dict(staging.SOLVER_CALLS), dict(kernelization.SOLVER_CALLS),
            sorted(map(repr, eng._struct_cache)), ops.SCHEDULE_CALLS["shm"], eng.adjoint_builds)


def _gathered_bytes(eng, rank):
    """The bytes each rank moves when the forward state is gathered to rank
    0 (every other rank sends its shard there): what the sweep must never
    do."""
    tr = eng.backend.transport
    shard = eng.run_packed().cpu().numpy().view(np.float32)
    collective.reset_collective_counters()
    if rank:
        tr.send(shard, 0)
    else:
        for src in range(1, tr.world):
            tr.recv(shard, src)
    c = collective.collective_counts()
    return {"bytes_sent": c["bytes_sent"], "bytes_received": c["bytes_received"]}


def run_case(rank, case, device):
    eng = ExecutionEngine(Circuit.from_json(case["circuit"]),
                          SimulationPlan.from_json(case["plan"]), device=device,
                          backend="shardmap")
    obs = case["obs"]
    ops.reset_kernel_counters()
    collective.reset_collective_counters()
    value, grads = eng.value_and_grad(obs, params=np.asarray(case["theta"]))
    prog = eng.adjoint_program(obs)
    out = {"value": value, "grads": grads, "launches": ops.kernel_call_counts(),
           "op_counts": eng.op_counts(), "n_gates": len(eng.circuit.gates),
           "n_slots": sum(len(g.param_slots) for g in eng.circuit.gates),
           "pauli_launches": prog.pauli_launches, "sweep": dict(prog.last_sweep),
           "bound": prog.sweep_bytes_bound(), "trace": [dict(t) for t in eng.backend.trace],
           "forward_plans": {str(slot): (rp.m, rp.ppermute is not None)
                             for slot, rp in eng.backend._plans.items()},
           "undo_plans": [None if undo is None else (undo.m, undo.ppermute is not None)
                          for _, undo in prog._stages],
           "walk": [gid for walk, _ in prog._stages for gid, *_ in walk]}
    # a rebind builds nothing and plans nothing
    before = _warm_counts(eng)
    out["rebound"] = eng.value_and_grad(obs, params=np.asarray(case["points"][0]))
    out["rebind_builds_nothing"] = _warm_counts(eng) == before
    out["adjoint_builds"] = eng.adjoint_builds
    out["grad_sweep"] = eng.grad_sweep(np.asarray(case["points"]), obs)
    out["points"] = [eng.value_and_grad(obs, params=np.asarray(p)) for p in case["points"]]
    out["gathered"] = _gathered_bytes(eng, rank)
    return out


def main(rank, cases, device="cpu"):
    # the ranks keep every core busy: at a lower priority they leave the
    # suite's other workers (whose own spawned ranks have tight timeouts)
    # their share
    os.nice(10)
    if device == "cuda":
        import torch

        torch.cuda.set_device(0)
    found = {}
    for name, case in cases.items():
        try:
            found[name] = run_case(rank, case, device)
        except Exception:
            found[name] = {"error": traceback.format_exc()}
    return found
