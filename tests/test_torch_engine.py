"""The port's engine on the CPU, given the reference's plan and op tensors
through ``repro_torch.convert``, against the reference's
``ExecutionEngine(backend="pjit", use_pallas=True)``: ``run`` and
``run_packed`` states, kernel-dispatch counts, the non-kernel path, and the
split that keeps PyTorch under its 25-axis limit."""

import numpy as np
import pytest
import torch

from conftest import assert_states_close
from repro.core.generators import FAMILIES, random_circuit
from repro.core.partition import partition
from repro.sim.engine import ExecutionEngine as RefEngine
from repro.sim.statevector import simulate_np
from repro_torch import convert
from repro_torch.kernels import ops
from repro_torch.sim import apply as tapply

# qft(10) at L=8 has an shm group with dep bits (per-shard member variants)
CASES = [("qft", 8, 6, 2, 0), ("ising", 8, 6, 2, 0), ("ghz", 8, 6, 2, 0),
         ("qsvm", 8, 6, 2, 0), ("wstate", 8, 5, 2, 1), ("qft", 10, 8, 2, 0)]


def _reference(circ, L, R, G):
    plan = partition(circ, L, R, G)
    ref = RefEngine(circ, plan, backend="pjit", use_pallas=True)
    tensors = {uid: np.asarray(t) for uid, t in ref.consts.items()}
    return plan, ref, tensors


def _port(circ, plan, tensors, use_kernels=True):
    return convert.engine_from_reference(circ.to_json(), plan.to_json(), tensors,
                                         use_kernels=use_kernels, device="cpu")


@pytest.mark.parametrize("name,n,L,R,G", CASES)
def test_engine_matches_reference(name, n, L, R, G):
    circ = FAMILIES[name](n)
    plan, ref, tensors = _reference(circ, L, R, G)
    eng = _port(circ, plan, tensors)
    ops.reset_kernel_counters()
    got = eng.run().numpy()
    counts = eng.op_counts()
    assert ops.kernel_call_counts() == {"fused": counts.get("fused", 0),
                                        "shm": counts.get("shm", 0)}
    assert_states_close(got, np.asarray(ref.run()), atol=1e-5, msg=name)
    assert_states_close(got, simulate_np(circ), atol=1e-5, msg=name)
    got_packed = eng.run_packed().numpy()
    assert_states_close(got_packed, np.asarray(ref.run_packed()).reshape(-1), atol=1e-5)
    assert_states_close(eng.finalize(torch.from_numpy(got_packed)).numpy(), got, atol=1e-6)


def test_engine_random_circuit_with_flips():
    """Lazy flips (anti-diagonal action on non-local qubits) and a
    non-trivial initial state."""
    circ = random_circuit(8, 40, seed=4)
    plan, ref, tensors = _reference(circ, 5, 2, 1)
    eng = _port(circ, plan, tensors)
    assert eng.cc.programs[0].remap_after.flip_bits and eng.cc.final_remap.flip_bits
    rng = np.random.default_rng(2)
    psi0 = rng.normal(size=256) + 1j * rng.normal(size=256)
    psi0 = (psi0 / np.linalg.norm(psi0)).astype(np.complex64)
    assert_states_close(eng.run(psi0).numpy(), np.asarray(ref.run(psi0)), atol=1e-5)
    assert_states_close(eng.run_packed(psi0).numpy(),
                        np.asarray(ref.run_packed(psi0)).reshape(-1), atol=1e-5)


def test_bind_matches_reference():
    """A symbolic circuit: binding swaps op tensors, as in the reference."""
    from repro.core.generators import PARAM_FAMILIES
    from repro_torch.core.circuit import Circuit
    from repro_torch.core.partition import SimulationPlan
    from repro_torch.sim.engine import ExecutionEngine

    circ = PARAM_FAMILIES["isingparam"](8)
    plan = partition(circ, 6, 2, 0)
    ref = RefEngine(circ, plan, backend="pjit", use_pallas=True)
    eng = ExecutionEngine(Circuit.from_json(circ.to_json()),
                          SimulationPlan.from_json(plan.to_json()), device="cpu")
    assert eng.param_names == circ.param_names
    for point in ({"J": 0.35, "h": 0.8}, {"J": -1.1, "h": 0.2}):
        assert_states_close(eng.run(params=point).numpy(),
                            np.asarray(ref.run(params=point)), atol=1e-5)
    assert eng.bind_count == 2


@pytest.mark.parametrize("name", ["qft", "ising"])
def test_non_kernel_path_matches(name):
    circ = FAMILIES[name](8)
    plan, ref, tensors = _reference(circ, 6, 2, 0)
    eng = _port(circ, plan, tensors, use_kernels=False)
    ops.reset_kernel_counters()
    got = eng.run().numpy()
    assert ops.kernel_call_counts() == {"fused": 0, "shm": 0}
    assert_states_close(got, np.asarray(ref.run()), atol=1e-5)


def test_engine_plans_itself_on_cpu():
    from repro_torch.core.generators import FAMILIES as PF
    from repro_torch.core.partition import partition as port_partition
    from repro_torch.sim.engine import ExecutionEngine

    circ = PF["qft"](9)
    eng = ExecutionEngine(circ, port_partition(circ, 7, 2, 0), device="cpu")
    assert_states_close(eng.run().numpy(), simulate_np(FAMILIES["qft"](9)), atol=1e-5)


@pytest.mark.parametrize("bits", [[3], [0, 5], [6, 1, 2], [2, 3, 4]])
def test_apply_matrix_and_diag_match_reference(bits):
    import jax.numpy as jnp
    from repro.sim.apply import apply_diag as ref_diag, apply_matrix as ref_matrix

    rng = np.random.default_rng(len(bits))
    n, k = 7, len(bits)
    psi = (rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)).astype(np.complex64)
    m = (rng.normal(size=(1 << k, 1 << k)) + 1j * rng.normal(size=(1 << k, 1 << k)))
    d = rng.normal(size=1 << k) + 1j * rng.normal(size=1 << k)
    m, d = m.astype(np.complex64), d.astype(np.complex64)
    view = torch.from_numpy(psi.copy()).view((2,) * n)
    jview = jnp.asarray(psi).reshape((2,) * n)
    np.testing.assert_allclose(
        tapply.apply_matrix(view, torch.from_numpy(m), bits).numpy(),
        np.asarray(ref_matrix(jview, jnp.asarray(m), bits)), atol=1e-5)
    np.testing.assert_allclose(
        tapply.apply_diag(view, torch.from_numpy(d), bits).numpy(),
        np.asarray(ref_diag(jview, jnp.asarray(d), bits)), atol=1e-5)


def test_axis_limit_split(monkeypatch):
    """With the axis limit lowered to 3, every permute, flip, broadcast and
    reduction is split into pieces; results are unchanged."""
    circ = random_circuit(8, 40, seed=4)
    plan, ref, tensors = _reference(circ, 5, 2, 1)
    want = np.asarray(ref.run())
    monkeypatch.setattr(tapply, "MAX_DIMS", 3)
    for use_kernels in (True, False):
        got = _port(circ, plan, tensors, use_kernels).run().numpy()
        assert_states_close(got, want, atol=1e-5)
    rng = np.random.default_rng(0)
    x = (rng.normal(size=1 << 9) + 1j * rng.normal(size=1 << 9)).astype(np.complex64)
    src = [int(b) for b in rng.permutation(9)]
    flips = [0, 3, 8]
    full = x.reshape((2,) * 9)
    for p in flips:
        full = np.flip(full, axis=8 - p)
    want = np.transpose(full, [8 - src[8 - i] for i in range(9)]).reshape(-1)
    got = tapply.permute_bits(torch.from_numpy(x), src, flips).numpy()
    assert np.array_equal(got, want)
    p2 = np.abs(x) ** 2
    marg = tapply.sum_bits(torch.from_numpy(p2), [1, 4, 6]).numpy()
    from repro.sim.measure import marginal_np

    np.testing.assert_allclose(marg, marginal_np(x, [1, 4, 6]), rtol=1e-6)  # float32 |x|^2


def test_entry_points_default_to_cuda():
    from repro_torch.core.circuit import Circuit
    from repro_torch.core.partition import SimulationPlan
    from repro_torch.sim.engine import ExecutionEngine
    from repro_torch.sim.statevector import zero_state

    if torch.cuda.is_available():
        pytest.skip("the default device is available here")
    circ = Circuit.from_json(FAMILIES["ghz"](4).to_json())
    plan = SimulationPlan.from_json(partition(FAMILIES["ghz"](4), 4).to_json())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ExecutionEngine(circ, plan)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        zero_state(3)
