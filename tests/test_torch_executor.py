"""The port's ``StagedExecutor`` and ``simulate_partitioned`` shims on the
CPU, against the reference's meshless ones (``repro.sim.executor``): the
same plan gives the same state within complex64 tolerance, attributes
reach the engine, and a mesh is refused (the port has no GSPMD mesh; its
multi-device path is the shardmap executor)."""

import numpy as np
import pytest
import torch

from repro.core.generators import FAMILIES, random_circuit
from repro.core.partition import partition
from repro.sim import executor as rexec
from repro_torch.core.circuit import Circuit
from repro_torch.core.partition import SimulationPlan
from repro_torch.sim import executor as texec

STATE_ATOL = 1e-5  # complex64 through a few dozen gates, against the reference
CASES = {
    "qft": (FAMILIES["qft"](9), 6, 2, 1),
    "ising": (FAMILIES["ising"](9), 6, 2, 1),
    "wstate": (FAMILIES["wstate"](8), 8, 0, 0),
    "random": (random_circuit(8, 45, seed=1), 5, 2, 1),
}


def _port(circ, plan):
    return Circuit.from_json(circ.to_json()), SimulationPlan.from_json(plan.to_json())


@pytest.mark.parametrize("name", sorted(CASES))
def test_staged_executor_matches_the_reference(name):
    circ, L, R, G = CASES[name]
    plan = partition(circ, L, R, G)
    want = np.asarray(rexec.StagedExecutor(circ, plan).run()).reshape(-1)
    ex = texec.StagedExecutor(*_port(circ, plan), device="cpu")
    got = ex.run()
    assert ex.backend.name == "cuda" and got.device.type == "cpu"
    assert np.abs(got.numpy() - want).max() <= STATE_ATOL
    # forwarded to the engine: the packed run and its frame, the program
    assert torch.equal(ex.finalize(ex.run_packed()), got)
    assert ex.measurement_frame.n == circ.n_qubits and ex.cc.L == L


@pytest.mark.parametrize("name", sorted(CASES))
def test_simulate_partitioned_matches_the_reference(name):
    circ, L, R, G = CASES[name]
    rng = np.random.default_rng(7)
    psi0 = rng.normal(size=1 << circ.n_qubits) + 1j * rng.normal(size=1 << circ.n_qubits)
    psi0 = (psi0 / np.linalg.norm(psi0)).astype(np.complex64)
    want, rplan = rexec.simulate_partitioned(circ, L, R, G, psi0=psi0)
    got, plan = texec.simulate_partitioned(Circuit.from_json(circ.to_json()), L, R, G,
                                           psi0=psi0, device="cpu")
    assert (plan.L, plan.R, plan.G, plan.n_stages) == (rplan.L, rplan.R, rplan.G, rplan.n_stages)
    assert np.abs(got.numpy() - np.asarray(want).reshape(-1)).max() <= STATE_ATOL


def test_a_mesh_is_refused():
    circ, L, R, G = CASES["qft"]
    plan = partition(circ, L, R, G)
    with pytest.raises(ValueError, match="ShardMapExecutor"):
        texec.StagedExecutor(*_port(circ, plan), mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="--executor shardmap"):
        texec.simulate_partitioned(Circuit.from_json(circ.to_json()), L, R, G, mesh=object(),
                                   device="cpu")
    with pytest.raises(ValueError, match="complex64"):
        texec.StagedExecutor(*_port(circ, plan), dtype=torch.complex128, device="cpu")
