"""The last public functions of ``src/repro`` the port took on, each against
its reference twin on the CPU, on inputs drawn from a seed with numpy:
``statevector.probabilities`` (rtol 1e-6) and ``measure`` (the same shots
for a seed), ``apply.axis_of_bit`` and ``ExecutionEngine.n_nonlocal``
(exactly), ``ExecutionEngine.dense_reference`` (within 1e-5), the
backends' ``extract``, ``ShardStore.ndim`` and ``steps.data_axes_for`` on
a fake mesh (exactly)."""

import types

import jax
import numpy as np
import pytest
import torch

from repro.core.generators import qft as r_qft
from repro.core.generators import random_circuit as r_random_circuit
from repro.core.partition import partition as r_partition
from repro.launch import steps as r_steps
from repro.sim import apply as r_apply
from repro.sim import shard_store as r_store
from repro.sim import statevector as r_sv
from repro.sim.engine import ExecutionEngine as RefEngine
from repro_torch.core.generators import qft, random_circuit
from repro_torch.core.partition import partition
from repro_torch.launch import steps
from repro_torch.sim import apply, shard_store, statevector
from repro_torch.sim.engine import ExecutionEngine

OBS = "Z0 Z1 + 0.5*X2 - 0.25*Y3"


def random_psi(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    return (psi / np.linalg.norm(psi)).astype(np.complex64)


@pytest.mark.parametrize("seed", [0, 1])
def test_probabilities(seed):
    psi = random_psi(10, seed)
    ref = r_sv.probabilities(psi)
    for x in (psi, torch.from_numpy(psi)):
        got = statevector.probabilities(x)
        assert got.dtype == np.float64 and got.shape == (1 << 10,)
        np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 3])
def test_measure_gives_the_references_shots(seed):
    psi = random_psi(9, seed)
    ref = r_sv.measure(psi, shots=300, seed=seed, marginals=[(0, 1, 2)], observables=OBS)
    got = statevector.measure(torch.from_numpy(psi), shots=300, seed=seed,
                              marginals=[(0, 1, 2)], observables=OBS)
    assert got.backend == ref.backend == "dense" and got.n_qubits == 9
    np.testing.assert_array_equal(got.samples, ref.samples)
    np.testing.assert_allclose(got.marginal((0, 1, 2)), ref.marginal((0, 1, 2)), atol=1e-6)
    assert abs(got.expectation(OBS) - ref.expectation(OBS)) < 1e-6


def test_axis_of_bit():
    for n in range(1, 12):
        for p in range(n):
            assert apply.axis_of_bit(n, p) == r_apply.axis_of_bit(n, p)


@pytest.mark.parametrize("n,L,R,G", [(8, 5, 2, 1), (9, 6, 3, 0), (7, 7, 0, 0), (10, 6, 2, 2)])
def test_n_nonlocal(n, L, R, G):
    ref = RefEngine(r_qft(n), r_partition(r_qft(n), L, R, G))
    got = ExecutionEngine(qft(n), partition(qft(n), L, R, G), device="cpu")
    assert got.n_nonlocal == ref.n_nonlocal == R + G
    assert got.backend.S == 1 << got.n_nonlocal


@pytest.mark.parametrize("apply_final", [True, False])
@pytest.mark.parametrize("seed", [5, 8])
def test_dense_reference(seed, apply_final):
    n, L, R, G = 9, 6, 2, 1
    rc, c = r_random_circuit(n, 40, seed=seed), random_circuit(n, 40, seed=seed)
    ref = RefEngine(rc, r_partition(rc, L, R, G))
    eng = ExecutionEngine(c, partition(c, L, R, G), device="cpu")
    psi0 = random_psi(n, seed)
    for p0 in (None, psi0):
        want = ref.dense_reference(psi0=p0, apply_final=apply_final)
        got = eng.dense_reference(psi0=p0, apply_final=apply_final)
        assert got.device.type == "cpu" and got.dtype == torch.complex64
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # the dense backend runs it: the engine against its own oracle
    dense = ExecutionEngine(c, partition(c, L, R, G), device="cpu", backend="dense")
    assert torch.equal(dense.run_packed(psi0) if not apply_final else dense.run(psi0),
                       eng.dense_reference(psi0=psi0, apply_final=apply_final))
    # within the planned engine's own tolerance of what it runs
    run = eng.run(psi0) if apply_final else eng.run_packed(psi0)
    assert (run - eng.dense_reference(psi0=psi0, apply_final=apply_final)).abs().max() < 1e-5


@pytest.mark.parametrize("backend", ["cuda", "offload", "dense"])
def test_extract(backend):
    n = 7
    eng = ExecutionEngine(qft(n), partition(qft(n), 4, 2, 1), device="cpu", backend=backend)
    rows = torch.from_numpy(np.stack([random_psi(n, s) for s in range(3)]))
    x = eng.backend.prepare(rows[0])
    flat = eng.backend.extract(eng.backend.execute(x))
    assert flat.shape == (1 << n,) and torch.equal(flat, eng.run(rows[0]))
    batch = eng.backend.extract(eng.backend.execute_batch(eng.backend.prepare(rows, batch=True)),
                                batch=True)
    assert batch.shape == (3, 1 << n) and torch.equal(batch, eng.run_batch(rows))
    assert torch.equal(eng.backend.extract(batch.reshape(3, 2, -1), batch=True), batch)


@pytest.mark.parametrize("lead", [(), (3,), (2, 2)])
def test_shard_store_ndim(lead):
    ref = r_store.ShardStore(4, 16, lead, np.complex64, r_store.StorageConfig())
    got = shard_store.ShardStore(4, 16, lead, torch.complex64, shard_store.StorageConfig())
    try:
        assert got.ndim == ref.ndim == len(lead) + 1
    finally:
        ref.close()
        got.close()


@pytest.mark.parametrize("names", [("data", "model"), ("pod", "data", "model"), ("data",)])
def test_data_axes_for_a_mesh(names):
    mesh = jax.sharding.AbstractMesh((1,) * len(names), names)
    fake = types.SimpleNamespace(mesh_dim_names=names)  # a DeviceMesh's axis names
    assert steps.data_axes_for(fake) == r_steps.data_axes_for(mesh)
