"""The port's adjoint gradients and VQE on the CPU, against the JAX package's
(the mirror of ``tests/test_grad.py``):

* ``apply_pauli_sum`` against ``repro.sim.measure.apply_pauli_sum`` and the
  complex128 ``expectation_np``;
* ``AdjointProgram.tensors`` bit for bit the reference's, and its
  rejections;
* ``value_and_grad`` on the ``cuda`` (run on the CPU), ``offload`` and
  ``dense`` backends against the reference engine's, the complex128
  ``adjoint_gradients_np`` and central finite differences (value 2e-5,
  gradients 1e-4: float32 sweeps, as the reference's tolerances);
* ``grad_sweep`` (fused on ``cuda``, point by point elsewhere) within 2e-4
  of the oracle, the fused path at one ``fused_apply`` call per gate
  application for all rows;
* the rebind contract: no solver call, no structural-cache miss, no ``shm``
  program scheduled, no adjoint program built;
* ``CompiledCircuit.reverse`` undoing a forward run;
* AdamW against ``repro.optim.adamw`` and the ``--vqe`` CLI against the
  reference CLI (1e-4).
"""

import numpy as np
import pytest
import torch

import strategies as strat
from conftest import assert_states_close
from repro.core.generators import PARAM_FAMILIES
from repro.core.partition import partition
from repro.launch import simulate as ref_cli
from repro.optim import adamw as ref_adamw
from repro.sim import adjoint as ref_adjoint
from repro.sim.engine import ExecutionEngine as RefEngine
from repro.sim.measure import apply_pauli_sum as ref_apply_pauli_sum, expectation_np
from repro.sim.statevector import simulate_np
from repro_torch.core import kernelization, staging
from repro_torch.core.circuit import Circuit as PCircuit
from repro_torch.core.gates import UnboundParameterError
from repro_torch.core.partition import SimulationPlan
from repro_torch.kernels import ops
from repro_torch.launch.simulate import main as cli
from repro_torch.optim import adamw
from repro_torch.sim.adjoint import AdjointProgram, adjoint_gradients_np
from repro_torch.sim.engine import ExecutionEngine
from repro_torch.sim.measure import apply_pauli_sum
from test_grad import OBS, _ansatz, _fd_grad

REF_BACKEND = {"cuda": "pjit", "offload": "offload", "dense": "dense"}
VQE_OBS = "Z0 Z1 + Z1 Z2 + 0.5*X0"


def _port(c):
    return PCircuit.from_json(c.to_json())


def _plan(plan):
    return SimulationPlan.from_json(plan.to_json())


def _case(name):
    """(reference circuit, L, R): the reference test's ansatz, and a wider
    one with 80 ``cx`` and 40 rotations."""
    if name == "ansatz4":
        return _ansatz(4), 3, 1
    return PARAM_FAMILIES["su2param"](10, reps=1), 8, 2


def _solve_counts():
    return (staging.SOLVER_CALLS["ilp"], staging.SOLVER_CALLS["greedy"],
            kernelization.SOLVER_CALLS["dp"])


def _fused_per_grad(eng, obs):
    """``fused_apply`` calls of one value_and_grad: the forward plan's fused
    ops, one per non-identity Pauli op, and per gate ``U†`` on ψ and on λ
    plus one ``∂U`` per symbolic slot."""
    from repro_torch.sim.measure import PauliSum

    pauli = sum(len(t.ops) for t in PauliSum.coerce(obs).terms)
    gates = eng.circuit.gates
    slots = sum(len(g.param_slots) for g in gates)
    return eng.op_counts().get("fused", 0) + pauli + 2 * len(gates) + slots


# ------------------------------------------------------------ H|psi>
@pytest.mark.parametrize("n,obs", [(4, OBS), (7, "X6 Y0 Z3 - 0.4*Z5 + 1.5")])
def test_apply_pauli_sum_matches_reference(n, obs):
    c = strat.build_circuit(n, 10, seed=2)
    psi = simulate_np(c)
    want = np.asarray(ref_apply_pauli_sum(psi.astype(np.complex64), obs))
    x = torch.from_numpy(psi.astype(np.complex64))
    got = apply_pauli_sum(x, obs).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert float(np.real(np.vdot(psi, got))) == pytest.approx(expectation_np(psi, obs), abs=1e-5)
    # rows: each row on its own, the input untouched
    rows = torch.stack([x, x.flip(0)])
    got_rows = apply_pauli_sum(rows, obs, use_kernels=False).numpy()
    np.testing.assert_allclose(got_rows[0], want, atol=1e-5)
    np.testing.assert_allclose(
        got_rows[1], np.asarray(ref_apply_pauli_sum(psi[::-1].astype(np.complex64), obs)),
        atol=1e-5)
    np.testing.assert_array_equal(x.numpy(), psi.astype(np.complex64))


# --------------------------------------------------------- the program
@pytest.mark.parametrize("name", ["ansatz4", "su2param10"])
def test_adjoint_tensors_match_reference_bit_for_bit(name):
    sym, _, _ = _case(name)
    theta = np.random.default_rng(3).uniform(0.2, 2.0, len(sym.param_names))
    ref = ref_adjoint.AdjointProgram(sym, OBS if name == "ansatz4" else VQE_OBS)
    prog = AdjointProgram(_port(sym), OBS if name == "ansatz4" else VQE_OBS, device="cpu")
    assert prog.param_names == ref.param_names and prog._gates == ref._gates
    pairs = [(ref.tensors(sym.bind(theta)), prog.tensors(_port(sym).bind(theta))),
             (ref.stacked_tensors([sym.bind(theta), sym.bind(theta[::-1])]),
              prog.stacked_tensors([_port(sym).bind(theta), _port(sym).bind(theta[::-1])]))]
    for (rinv, rd), (inv, d) in pairs:
        assert len(inv) == len(rinv) and len(d) == len(rd)
        for a, b in zip(inv + d, rinv + rd):
            assert a.dtype == b.dtype == np.complex64
            np.testing.assert_array_equal(a, b)


def test_adjoint_program_rejects_mismatches():
    sym = _port(_ansatz(4))
    prog = AdjointProgram(sym, OBS, device="cpu")
    with pytest.raises(UnboundParameterError):
        prog.tensors(sym)  # unbound
    with pytest.raises(ValueError):
        prog.tensors(_port(strat.build_circuit(4, 6, seed=0)))
    with pytest.raises(ValueError):
        AdjointProgram(PCircuit(2), "Z5", device="cpu")  # observable out of range
    with pytest.raises(ValueError):
        prog.sweep_(torch.zeros(1, 8, dtype=torch.complex64), *prog.tensors(
            sym.bind(np.ones(len(sym.param_names)))))  # 2^3 amplitudes, not 2^4


# ------------------------------------------------------ engine, per backend
@pytest.mark.parametrize("backend", ["cuda", "offload", "dense"])
@pytest.mark.parametrize("name", ["ansatz4", "su2param10"])
def test_value_and_grad_matches_reference_per_backend(backend, name):
    sym, L, R = _case(name)
    obs = OBS if name == "ansatz4" else VQE_OBS
    names = sym.param_names
    theta = np.random.default_rng(1).uniform(0.2, 2.0, len(names))
    plan = partition(sym, L, R, 0)
    eng = ExecutionEngine(_port(sym), _plan(plan), device="cpu", backend=backend)
    ops.reset_kernel_counters()
    value, grads = eng.value_and_grad(obs, params=theta)
    assert isinstance(value, float) and grads.dtype == np.float64 and grads.shape == (len(names),)
    # the forward run's launches (none on the dense oracle, one per op and
    # shard offloaded), then the sweep's
    forward = {"cuda": 1, "offload": getattr(eng.backend, "S", 0), "dense": 0}[backend]
    plan_fused = eng.op_counts().get("fused", 0)
    assert ops.kernel_call_counts()["fused"] == (
        forward * plan_fused + _fused_per_grad(eng, obs) - plan_fused)
    vref, gref = adjoint_gradients_np(sym, theta, obs)
    assert value == pytest.approx(vref, abs=2e-5)
    np.testing.assert_allclose(grads, gref, atol=1e-4)
    reng = RefEngine(sym, plan, backend=REF_BACKEND[backend])
    rv, rg = reng.value_and_grad(obs, params=theta)
    assert value == pytest.approx(rv, abs=2e-5)
    np.testing.assert_allclose(grads, rg, atol=1e-4)
    np.testing.assert_allclose(grads, _fd_grad(sym, names, theta, obs), atol=1e-4)


def test_port_oracle_is_the_reference_oracle():
    sym = _ansatz(4)
    theta = np.random.default_rng(0).uniform(0.2, 2.0, len(sym.param_names))
    rng = np.random.default_rng(4)
    psi0 = rng.normal(size=16) + 1j * rng.normal(size=16)
    v, g = adjoint_gradients_np(_port(sym), theta, OBS, psi0=psi0)
    rv, rg = ref_adjoint.adjoint_gradients_np(sym, theta, OBS, psi0=psi0)
    assert v == rv
    np.testing.assert_array_equal(g, rg)


def test_value_and_grad_from_an_initial_state_leaves_it_alone():
    sym = _port(_ansatz(4))
    theta = np.random.default_rng(7).uniform(0.2, 2.0, len(sym.param_names))
    rng = np.random.default_rng(8)
    psi0 = rng.normal(size=16) + 1j * rng.normal(size=16)
    psi0 = (psi0 / np.linalg.norm(psi0)).astype(np.complex64)
    eng = ExecutionEngine(sym, _plan(partition(_ansatz(4), 3, 1, 0)), device="cpu")
    x = torch.from_numpy(psi0.copy())
    v, g = eng.value_and_grad(OBS, params=theta, psi0=x)
    vref, gref = adjoint_gradients_np(sym, theta, OBS, psi0=psi0)
    assert v == pytest.approx(vref, abs=2e-5)
    np.testing.assert_allclose(g, gref, atol=1e-4)
    np.testing.assert_array_equal(x.numpy(), psi0)
    # the program's own entry point does not consume the state it is given
    state = eng.run()
    before = state.clone()
    prog = eng.adjoint_program(OBS)
    v2, g2 = prog.value_and_grad(state, eng.bound_circuit)
    assert torch.equal(state, before)
    v3, g3 = eng.value_and_grad(OBS)
    assert v2 == pytest.approx(v3, abs=1e-6)
    np.testing.assert_allclose(g2, g3, atol=1e-6)


# --------------------------------------------------------- batched sweeps
@pytest.mark.parametrize("backend,fused", [("cuda", True), ("offload", False), ("dense", False)])
def test_grad_sweep_fused_vs_sequential(backend, fused):
    sym = _ansatz(4)
    plan = partition(sym, 3, 1, 0)
    rng = np.random.default_rng(6)
    batch = rng.uniform(0.2, 2.0, (3, len(sym.param_names)))
    eng = ExecutionEngine(_port(sym), _plan(plan), device="cpu", backend=backend)
    assert eng.backend.supports_fused_grad() == fused
    ops.reset_kernel_counters()
    vals, grads = eng.grad_sweep(batch, OBS)
    assert vals.shape == (3,) and grads.shape == (3, len(sym.param_names))
    for p in range(3):
        vref, gref = adjoint_gradients_np(sym, batch[p], OBS)
        assert vals[p] == pytest.approx(vref, abs=2e-5)
        np.testing.assert_allclose(grads[p], gref, atol=2e-4)
    if backend == "cuda":
        # one call per gate application for all 3 rows: a single point's count
        assert ops.kernel_call_counts()["fused"] == _fused_per_grad(eng, OBS)
        assert eng.adjoint_builds == 1


def test_grad_sweep_rows_equal_single_points():
    sym, L, R = _case("su2param10")
    plan = partition(sym, L, R, 0)
    eng = ExecutionEngine(_port(sym), _plan(plan), device="cpu")
    batch = np.random.default_rng(9).uniform(0.0, 2 * np.pi, (2, len(sym.param_names)))
    vals, grads = eng.grad_sweep(batch, VQE_OBS)
    for p in range(2):
        v, g = eng.value_and_grad(VQE_OBS, params=batch[p])
        assert vals[p] == pytest.approx(v, abs=2e-5)
        np.testing.assert_allclose(grads[p], g, atol=2e-4)
    with pytest.raises(ValueError):
        eng.grad_sweep(np.zeros((0, len(sym.param_names))), VQE_OBS)


# ------------------------------------------------- serving contract (warm)
@pytest.mark.parametrize("backend", ["cuda", "offload"])
def test_grad_is_binding_smooth_with_no_rebuild(backend):
    sym = _ansatz(4)
    names = sym.param_names
    plan = partition(sym, 3, 1, 0)
    eng = ExecutionEngine(_port(sym), _plan(plan), device="cpu", backend=backend)
    theta = np.random.default_rng(5).uniform(0.2, 2.0, len(names))
    eng.value_and_grad(OBS, params=theta)  # warm-up: the first bind, the program
    counts = (_solve_counts(), set(eng._struct_cache), ops.SCHEDULE_CALLS["shm"],
              eng.adjoint_builds)
    prev = None
    for step in range(6):
        v, g = eng.value_and_grad(OBS, params=theta + 1e-3 * step)
        if prev is not None:
            assert np.abs(g - prev).max() < 0.05  # a 1e-3 nudge moves the gradient a little
        prev = g
    assert (_solve_counts(), set(eng._struct_cache), ops.SCHEDULE_CALLS["shm"],
            eng.adjoint_builds) == counts
    assert eng.adjoint_builds == 1
    eng.value_and_grad("Z0", params=theta)  # another observable: its own program
    assert eng.adjoint_builds == 2


def test_engine_without_params_has_empty_grad():
    c = strat.build_circuit(4, 8, seed=4)  # concrete circuit
    plan = partition(c, 4, 0, 0)
    eng = ExecutionEngine(_port(c), _plan(plan), device="cpu")
    value, grads = eng.value_and_grad("Z0 + Z1")
    assert grads.shape == (0,)
    assert value == pytest.approx(expectation_np(simulate_np(c), "Z0 + Z1"), abs=2e-5)


# -------------------------------------------------- compiled reverse stream
@pytest.mark.parametrize("cm", [None, strat.SHM_CM], ids=["fused", "shm"])
def test_compiled_reverse_undoes_forward(cm):
    """run(cc) then run(cc.reverse()) is the identity: remap inversion,
    per-variant tensor adjoints and shm member reversal."""
    c = strat.build_circuit(6, 18, seed=9)
    plan = _plan(partition(c, 4, 2, 0, **({"cost_model": cm} if cm is not None else {})))
    pc = _port(c)
    eng = ExecutionEngine(pc, plan, device="cpu")
    if cm is not None:
        assert eng.op_counts().get("shm", 0) > 0
    rng = np.random.default_rng(8)
    psi0 = rng.normal(size=64) + 1j * rng.normal(size=64)
    psi0 /= np.linalg.norm(psi0)
    fwd = eng.run(psi0.astype(np.complex64))
    rev = ExecutionEngine(pc, plan, device="cpu", compiled=eng.cc.reverse())
    assert_states_close(rev.run(fwd).numpy(), psi0, atol=1e-4)


# ------------------------------------------------------------------ AdamW
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference(moment_dtype):
    cfg = dict(lr=0.05, warmup_steps=3, total_steps=20, moment_dtype=moment_dtype,
               clip_norm=1.0, weight_decay=0.1)
    rcfg, pcfg = ref_adamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    rng = np.random.default_rng(0)
    params = [rng.normal(size=(3, 4)).astype(np.float32), rng.normal(size=5).astype(np.float32)]
    rp, pp = list(params), [torch.from_numpy(p.copy()) for p in params]
    rs, ps = ref_adamw.init(rcfg, rp), adamw.init(pcfg, pp)
    for _ in range(20):
        g = [3 * rng.normal(size=p.shape).astype(np.float32) for p in params]
        rp, rs, rm = ref_adamw.update(rcfg, g, rs, rp)
        pp, ps, pm = adamw.update(pcfg, [torch.from_numpy(x) for x in g], ps, pp)
        assert float(pm["lr"]) == pytest.approx(float(rm["lr"]), abs=1e-9)
        assert float(pm["grad_norm"]) == pytest.approx(float(rm["grad_norm"]), rel=1e-6)
        for a, b in zip(rp, pp):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
        for a, b in zip(rs.m + rs.v, ps.m + ps.v):
            a = np.asarray(a, dtype=np.float32)
            b = b.to(torch.float32).numpy()
            if moment_dtype == "float32":
                np.testing.assert_allclose(b, a, atol=1e-6)
            else:  # one bf16 ulp: 2^-7 of the magnitude
                np.testing.assert_array_less(np.abs(b - a), 2.0 ** -7 * np.abs(a) + 1e-30)
    assert int(ps.step) == int(rs.step) == 20


def test_adamw_takes_a_single_tensor():
    cfg = adamw.AdamWConfig(lr=0.1, warmup_steps=0, moment_dtype="float32")
    theta = torch.tensor([0.5, -1.0], dtype=torch.float32)
    new, state, _ = adamw.update(cfg, torch.tensor([1.0, -2.0]), adamw.init(cfg, theta), theta)
    assert isinstance(new, torch.Tensor) and new.shape == (2,)
    assert bool(torch.all(torch.sign(theta - new) == torch.tensor([1.0, -1.0])))


# -------------------------------------------------------------------- CLI
@pytest.mark.parametrize("executor", ["cuda", "offload"])
def test_vqe_cli_matches_reference(executor, capsys):
    argv = ["--circuit", "isingparam", "--n", "8", "--L", "6", "--R", "2", "--vqe", VQE_OBS,
            "--vqe-steps", "6", "--vqe-seed", "3"]
    ref = ref_cli.main(argv + ["--executor", REF_BACKEND[executor]])
    run = cli(argv + ["--executor", executor, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "VQE done" in out and "no adjoint program built" in out
    assert run.param_names == tuple(ref["param_names"])
    assert run.energies[-1] == pytest.approx(ref["energy"], abs=1e-4)
    np.testing.assert_allclose(run.theta, np.asarray(ref["theta"]), atol=1e-4)
    assert len(run.energies) == len(run.grad_seconds) == 7
    assert run.engine.adjoint_builds == 1 and run.engine.backend.name == executor


@pytest.mark.parametrize("argv", [
    ["--circuit", "qft"],  # a concrete circuit has nothing to optimise
    ["--circuit", "isingparam", "--executor", "pergate"],
])
def test_vqe_cli_refusals(argv):
    with pytest.raises(SystemExit) as e:
        cli(["--n", "6", "--L", "4", "--R", "2", "--vqe", "Z0", "--device", "cpu"] + argv)
    assert e.value.code == 2
