"""The port's engine entry point on the CPU against the JAX package's: batched
runs, parameter sweeps, batch and sweep measurement, the structural compile
cache (``engine_for``, ``CircuitKey``, ``CompileCache``), warm rebinding,
the pre-staging optimizer, the dense backend and the CLI flags that reach
them. The reference runs as ``backend="pjit"`` without a mesh, with
``use_pallas=True`` where shm groups make it apply.

Tolerances: states within ``atol=1e-5`` (complex64 through a few dozen
gates, as ``tests/test_torch_engine.py``); shots identical; marginals and
expectations within 1e-5."""

import json
import threading

import numpy as np
import pytest
import torch

from conftest import assert_states_close
from repro.core import generators as gen
from repro.core.partition import partition
from repro.sim import measure as RM
from repro.sim.compile import bind_tensors_sweep as ref_bind_sweep
from repro.sim.engine import ExecutionEngine as RefEngine, engine_for as ref_engine_for
from repro.sim.statevector import simulate_np
from repro_torch import convert
from repro_torch.core import kernelization, staging
from repro_torch.core.circuit import Circuit as PCircuit
from repro_torch.core.partition import SimulationPlan
from repro_torch.kernels import ops
from repro_torch.launch.simulate import main as cli
from repro_torch.sim import apply as tapply, compile as tcompile, measure as TM
from repro_torch.sim.engine import (
    CircuitKey, CompileCache, ExecutionEngine, circuit_key_for, engine_for,
)
from strategies import SHM_CM
from test_params import _ansatz, _vals

OBS = ["Z0 Z1 + 0.5*X2", "Y3 X5 - 0.25*Z4"]
MARGINALS = [(0, 1, 2), (5, 3)]


def _port(c):
    return PCircuit.from_json(c.to_json())


def _plan(plan):
    return SimulationPlan.from_json(plan.to_json())


def _basis_batch(n, B):
    psi0s = np.zeros((B, 1 << n), dtype=np.complex64)
    psi0s[np.arange(B), (np.arange(B) * 37) % (1 << n)] = 1.0
    return psi0s


def _random_batch(n, B, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, 1 << n)) + 1j * rng.normal(size=(B, 1 << n))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.complex64)


def _solve_counts():
    return (staging.SOLVER_CALLS["ilp"], staging.SOLVER_CALLS["greedy"],
            kernelization.SOLVER_CALLS["dp"])


def _sweep_case(n=7, L=5):
    sym = _ansatz(n)
    plan = partition(sym, L, 2, 0, cost_model=SHM_CM)
    ref = RefEngine(sym, plan, backend="pjit", use_pallas=True)
    eng = ExecutionEngine(_port(sym), _plan(plan), device="cpu")
    assert eng.op_counts().get("shm", 0) > 0, "the case must exercise the shm kernel"
    return sym, ref, eng


def _launches_equal_ops(eng):
    counts = eng.op_counts()
    assert ops.kernel_call_counts() == {"fused": counts.get("fused", 0),
                                        "shm": counts.get("shm", 0)}


# ------------------------------------------------------------------ batches
@pytest.mark.parametrize("B", [1, 2, 3, 4])
@pytest.mark.parametrize("apply_final", [True, False])
def test_run_batch_matches_reference(B, apply_final):
    """A random circuit with lazy flips on L=5, R=2, G=1: any batch size is
    one kernel launch per compiled op, in both layouts."""
    circ = gen.random_circuit(8, 40, seed=4)
    plan = partition(circ, 5, 2, 1)
    ref = RefEngine(circ, plan, backend="pjit", use_pallas=True)
    eng = convert.engine_from_reference(
        circ.to_json(), plan.to_json(), {u: np.asarray(t) for u, t in ref.consts.items()},
        device="cpu")
    psi0s = _random_batch(8, B, seed=B)
    ops.reset_kernel_counters()
    got = eng.run_batch(psi0s, apply_final=apply_final)
    _launches_equal_ops(eng)
    want = np.asarray(ref.run_batch(psi0s, apply_final=apply_final)).reshape(B, -1)
    assert got.shape == (B, 256)
    for b in range(B):
        assert_states_close(got[b].numpy(), want[b], atol=1e-5, msg=f"row {b}")
        if apply_final:
            assert_states_close(got[b].numpy(), simulate_np(circ, psi0s[b]), atol=1e-5)
        else:
            single = eng.run_packed(psi0s[b]).numpy()
            assert_states_close(got[b].numpy(), single, atol=1e-6)
    if not apply_final:
        assert_states_close(eng.finalize(got)[B - 1].numpy(),
                            simulate_np(circ, psi0s[B - 1]), atol=1e-5)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_run_batch_with_dep_variants_and_axis_split(monkeypatch, use_kernels):
    """qft(10) at L=8 has dep-batched variants inside an shm group; with
    the axis limit lowered every batched remap and broadcast is split."""
    circ = gen.qft(10)
    plan = partition(circ, 8, 2, 0)
    ref = RefEngine(circ, plan, backend="pjit", use_pallas=True)
    eng = convert.engine_from_reference(
        circ.to_json(), plan.to_json(), {u: np.asarray(t) for u, t in ref.consts.items()},
        use_kernels=use_kernels, device="cpu")
    assert any(m.dep_bits for p in eng.cc.programs for op in p.ops if op.kind == "shm"
               for m in op.gates)
    psi0s = _basis_batch(10, 3)
    monkeypatch.setattr(tapply, "MAX_DIMS", 3)
    got = eng.run_batch(psi0s).numpy()
    want = np.asarray(ref.run_batch(psi0s))
    for b in range(3):
        assert_states_close(got[b], want[b], atol=1e-5)


# ------------------------------------------------------------------- sweeps
@pytest.mark.parametrize("form", ["array", "dicts"])
def test_run_sweep_oracle_equivalence(form):
    """Both ``params_batch`` forms, special angles included: one launch per
    op for all points, states equal to the reference's sweep and to the
    oracle; a second sweep and a plain run after it stay correct."""
    sym, ref, eng = _sweep_case()
    n = sym.n_qubits
    batch = np.stack([_vals(n, s) for s in (7, 8, 9)])
    batch[2] = 0.0  # identity rotations must stay valid
    pts = batch if form == "array" else [dict(zip(sym.param_names, row)) for row in batch]
    ops.reset_kernel_counters()
    got = eng.run_sweep(None, pts)
    _launches_equal_ops(eng)
    want = np.asarray(ref.run_sweep(None, batch))
    assert got.shape == (3, 1 << n)
    for p in range(3):
        assert_states_close(got[p].numpy(), want[p], atol=1e-5, msg=f"point {p}")
        assert_states_close(got[p].numpy(), simulate_np(_ansatz(n, list(batch[p]))), atol=1e-5)
    packed = eng.run_sweep(None, batch + 0.1, apply_final=False)
    want = np.asarray(ref.run_sweep(None, batch + 0.1, apply_final=False)).reshape(3, -1)
    for p in range(3):
        assert_states_close(packed[p].numpy(), want[p], atol=1e-5)
    eng.bind(dict(zip(sym.param_names, _vals(n, 3))))
    assert_states_close(eng.run().numpy(), simulate_np(_ansatz(n, _vals(n, 3))), atol=1e-5)


def test_sweep_tables_equal_reference():
    """The port's batched binding pass builds the reference's ``[P, ...]``
    tables, uid by uid."""
    sym = _ansatz(7)
    plan = partition(sym, 5, 2, 0, cost_model=SHM_CM)
    batch = [_vals(7, s) for s in (1, 2, 3)]
    want = ref_bind_sweep([sym.bind(v) for v in batch], plan)
    psym, pplan = _port(sym), _plan(plan)
    cache = {}
    for _ in range(3):  # cold, then the batched builder's steady state
        got = tcompile.bind_tensors_sweep([psym.bind(v) for v in batch], pplan,
                                          struct_cache=cache)
        assert set(got) == set(want)
        for uid in want:
            assert got[uid].dtype == want[uid].dtype and np.array_equal(got[uid], want[uid]), uid


def test_stale_sweep_state_cleared_on_rebind():
    """A sweep's tables live in its own pass: a sweep cut off mid-run leaves
    nothing behind, so a run before and after a rebind matches the
    reference."""
    sym, ref, eng = _sweep_case(n=6, L=4)
    n = 6
    first = dict(zip(sym.param_names, _vals(n, 3)))
    eng.bind(first)
    orig = eng.backend.apply_ops
    swept = []

    def cut(x, prog, ps=None):
        out = orig(x, prog, ps)
        if ps is not None and ps.sweep:
            swept.append(ps.rows)
            raise RuntimeError("sweep cut off")
        return out

    eng.backend.apply_ops = cut
    with pytest.raises(RuntimeError, match="sweep cut off"):
        eng.run_sweep(None, np.stack([_vals(n, s) for s in (7, 8)]))
    del eng.backend.apply_ops
    assert swept == [2], "the sweep must have run one stage of its own pass"
    assert_states_close(eng.run().numpy(), np.asarray(ref.run(params=first)), atol=1e-5)
    second = dict(zip(sym.param_names, _vals(n, 9)))
    eng.bind(second)
    assert_states_close(eng.run().numpy(), np.asarray(ref.run(params=second)), atol=1e-5)
    assert_states_close(eng.run().numpy(), simulate_np(_ansatz(n, _vals(n, 9))), atol=1e-5)


def test_concurrent_sweep_and_run_stay_correct():
    """run and run_sweep on one engine from two threads: the engine lock
    serializes them."""
    sym, _, eng = _sweep_case(n=6, L=4)
    n = 6
    vals = _vals(n, 3)
    eng.bind(dict(zip(sym.param_names, vals)))
    ref_run = simulate_np(_ansatz(n, vals))
    batch = np.stack([_vals(n, s) for s in (7, 8)])
    refs = [simulate_np(_ansatz(n, list(batch[p]))) for p in range(2)]
    for _ in range(3):
        results, errs = {}, []

        def worker(name, fn):
            try:
                results[name] = fn().numpy()
            except Exception as e:  # noqa: BLE001 - surfaced via errs
                errs.append(e)

        ts = [threading.Thread(target=worker, args=("sweep", lambda: eng.run_sweep(None, batch))),
              threading.Thread(target=worker, args=("run", eng.run))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not any(t.is_alive() for t in ts) and not errs, errs
        for p in range(2):
            assert_states_close(results["sweep"][p], refs[p], atol=1e-5)
        assert_states_close(results["run"], ref_run, atol=1e-5)


# -------------------------------------------------------------- measurement
def test_measure_batch_matches_reference():
    circ = gen.random_circuit(8, 40, seed=4)
    plan = partition(circ, 5, 2, 1)
    ref = RefEngine(circ, plan, backend="pjit", use_pallas=True)
    eng = convert.engine_from_reference(
        circ.to_json(), plan.to_json(), {u: np.asarray(t) for u, t in ref.consts.items()},
        device="cpu")
    psi0s = _random_batch(8, 3, seed=5)
    kw = dict(shots=256, seed=11, marginals=MARGINALS, observables=OBS)
    want = RM.measure_batch(ref, psi0s, **kw)
    got = TM.measure_batch(eng, psi0s, **kw)
    assert len(got) == 3
    for b in range(3):
        np.testing.assert_array_equal(got[b].samples, want[b].samples)
        for qs in MARGINALS:
            np.testing.assert_allclose(got[b].marginals[qs], want[b].marginals[qs], atol=1e-5)
        for key in want[b].expectations:
            assert abs(got[b].expectations[key] - want[b].expectations[key]) < 1e-5
        assert got[b].meta == {"batch_index": b, "batch_size": 3}
    assert not np.array_equal(got[0].samples, got[1].samples)  # seed + b


def test_measure_sweep_matches_reference():
    sym, ref, eng = _sweep_case()
    batch = np.stack([_vals(7, s) for s in (14, 15)])
    kw = dict(shots=128, seed=3, marginals=MARGINALS, observables=OBS)
    want = RM.measure_sweep(ref, batch, **kw)
    got = TM.measure_sweep(eng, batch, **kw)
    for p in range(2):
        np.testing.assert_array_equal(got[p].samples, want[p].samples)
        for qs in MARGINALS:
            np.testing.assert_allclose(got[p].marginals[qs], want[p].marginals[qs], atol=1e-5)
        for key in want[p].expectations:
            assert abs(got[p].expectations[key] - want[p].expectations[key]) < 1e-5


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_simulate_and_measure_matches_reference(backend):
    sym = _ansatz(7)
    params = dict(zip(sym.param_names, _vals(7, 21)))
    kw = dict(shots=200, seed=4, marginals=MARGINALS, observables=OBS, params=params)
    plan = partition(sym, 5, 2, 0)
    if backend == "ref":
        want = RM.simulate_and_measure(sym, backend="ref", **kw)
        got = TM.simulate_and_measure(_port(sym), backend="ref", device="cpu", **kw)
    else:
        want = RM.simulate_and_measure(sym, backend="pjit", plan=plan, use_pallas=True, **kw)
        got = TM.simulate_and_measure(_port(sym), backend="cuda", plan=_plan(plan),
                                      device="cpu", **kw)
        assert got.meta["n_stages"] == plan.n_stages
    np.testing.assert_array_equal(got.samples, want.samples)
    for qs in MARGINALS:
        np.testing.assert_allclose(got.marginals[qs], want.marginals[qs], atol=1e-5)
    for key in want.expectations:
        assert abs(got.expectations[key] - want.expectations[key]) < 1e-5
    with pytest.raises(ValueError, match="unknown backend"):
        TM.simulate_and_measure(_port(sym), backend="pjit", device="cpu", params=params)
    # the shardmap backend is the port's now; outside a process group it
    # refuses to build, typed
    from repro_torch.sim.faults import BackendBuildError

    with pytest.raises(BackendBuildError, match="process group"):
        TM.simulate_and_measure(_port(sym), backend="shardmap", plan=_plan(plan),
                                device="cpu", params=params)


def test_dense_measurer_shots_equal_torch_measurer():
    circ = gen.random_circuit(8, 40, seed=4)
    plan = partition(circ, 5, 2, 1)
    eng = ExecutionEngine(_port(circ), _plan(plan), device="cpu")
    packed, frame = eng.run_packed(), eng.measurement_frame
    a = TM.measure_to_result(TM.TorchMeasurer(packed, frame), backend="t", shots=300, seed=2,
                             marginals=MARGINALS, observables=OBS)
    b = TM.measure_to_result(TM.measurer_for(packed.numpy(), frame), backend="t", shots=300,
                             seed=2, marginals=MARGINALS, observables=OBS)
    dense = TM.DenseMeasurer.with_frame(simulate_np(circ), frame)
    c = TM.measure_to_result(dense, backend="t", shots=300, seed=2, marginals=MARGINALS,
                             observables=OBS)
    for other in (b, c):
        np.testing.assert_array_equal(other.samples, a.samples)
        for qs in MARGINALS:
            np.testing.assert_allclose(other.marginals[qs], a.marginals[qs], atol=1e-5)
        for key in a.expectations:
            assert abs(other.expectations[key] - a.expectations[key]) < 1e-5


# ------------------------------------------------------------ dense backend
def test_dense_backend_packed_order():
    """The dense oracle's ``run_packed`` is in the compiled frame's order,
    equal to the planned backend's and to the reference dense backend's."""
    circ = gen.random_circuit(8, 40, seed=4)
    plan = partition(circ, 5, 2, 1)
    pc, pp = _port(circ), _plan(plan)
    dense = ExecutionEngine(pc, pp, device="cpu", backend="dense")
    cuda = ExecutionEngine(pc, pp, device="cpu")
    ref = RefEngine(circ, plan, backend="dense")
    assert dense.backend.name == "dense" and dense.cc.final_remap.flip_bits
    assert_states_close(dense.run_packed().numpy(), cuda.run_packed().numpy(), atol=1e-5)
    assert_states_close(dense.run_packed().numpy(), np.asarray(ref.run_packed()), atol=1e-5)
    assert_states_close(dense.run().numpy(), simulate_np(circ), atol=1e-5)
    psi0s = _basis_batch(8, 3)
    got = dense.run_batch(psi0s, apply_final=False)
    want = cuda.run_batch(psi0s, apply_final=False)
    for b in range(3):
        assert_states_close(got[b].numpy(), want[b].numpy(), atol=1e-5)


def test_unbound_engine_refuses_to_run():
    from repro_torch.core.gates import UnboundParameterError

    sym = _port(_ansatz(4))
    eng = ExecutionEngine(sym, _plan(partition(_ansatz(4), 4, 0, 0)), device="cpu")
    for call in (eng.run, eng.run_packed, lambda: eng.run_batch(_basis_batch(4, 2))):
        with pytest.raises(UnboundParameterError):
            call()
    eng.bind(dict(zip(sym.param_names, _vals(4, 6))))
    assert_states_close(eng.run().numpy(), simulate_np(_ansatz(4, _vals(4, 6))), atol=1e-5)


# ----------------------------------------------------------- compile cache
@pytest.mark.parametrize("backend", ["cuda", "dense"])
def test_rebind_zero_solves_zero_compiles(backend):
    """A structural cache hit with new angles re-runs no staging and no
    kernelization. The first rebind fills the engine's structural cache;
    from then on a binding pass compiles nothing structural: every lookup
    hits, so the cache gains no entry."""
    n = 6
    cache = CompileCache()
    e1 = engine_for(_port(_ansatz(n, _vals(n, 0))), 4, 2, 0, backend=backend, cache=cache,
                    device="cpu")
    out0 = e1.run().numpy()
    solves = _solve_counts()
    structural = None
    for seed in (1, 2):
        vals = _vals(n, seed)
        e2 = engine_for(_port(_ansatz(n, vals)), 4, 2, 0, backend=backend, cache=cache,
                        device="cpu")
        assert e2 is e1, "same structure must hit the cache"
        assert_states_close(e2.run().numpy(), simulate_np(_ansatz(n, vals)), atol=1e-5)
        assert structural is None or set(e1._struct_cache) == structural, \
            "a warm rebind must not compile anything structural"
        structural = set(e1._struct_cache)
    assert structural and _solve_counts() == solves
    assert e1.bind_count == 2
    assert cache.misses == 1 and cache.hits == 2
    assert_states_close(out0, simulate_np(_ansatz(n, _vals(n, 0))), atol=1e-5)
    assert set(e1.timing_snapshot()) == {"run"} and e1.timing_snapshot()["run"]["count"] == 3


def test_rebind_builds_no_new_shm_schedule(monkeypatch):
    """The shm step-table program is memoised by layout and member shapes:
    a rebind (new operand tensors) fills in the operand words only."""
    sym, _, eng = _sweep_case()
    calls = []
    real = ops.shm_schedule
    monkeypatch.setattr(ops, "shm_schedule", lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(ops, "_TEMPLATES", type(ops._TEMPLATES)())
    groups = [op for p in eng.cc.programs for op in p.ops if op.kind == "shm"]

    def tables():
        out = []
        for op in groups:
            mem = eng.backend.shm_members(op)
            out.append((ops.shm_descriptors(ops.shm_layout(eng.L, eng.L, op.local_bits), mem),
                        mem))
        return out

    counted = ops.SCHEDULE_CALLS["shm"]
    eng.bind(dict(zip(sym.param_names, _vals(7, 1))))
    first = tables()
    assert 0 < len(calls) <= len(groups)
    assert ops.SCHEDULE_CALLS["shm"] - counted == len(calls)
    scheduled = len(calls)
    eng.bind(dict(zip(sym.param_names, _vals(7, 2))))
    second = tables()
    assert len(calls) == scheduled, "a rebind must not schedule again"
    for (d1, _), (d2, _) in zip(first, second):
        assert np.array_equal(d1[:, :6], d2[:, :6]) and not np.array_equal(d1, d2)
    # the tables are what a fresh schedule of the new operands gives
    monkeypatch.setattr(ops, "_TEMPLATES", type(ops._TEMPLATES)())
    for op, (desc, mem) in zip(groups, second):
        lay = ops.shm_layout(eng.L, eng.L, op.local_bits)
        assert np.array_equal(ops.shm_descriptors(lay, mem), desc)


def test_circuit_key_stability_and_parameter_blindness():
    from dataclasses import replace

    k1 = CircuitKey.make(_port(gen.qft(8)), 5, 2, 1)
    assert CircuitKey.make(_port(gen.qft(8)), 5, 2, 1) == k1
    c3 = gen.qft(8)
    gi = next(i for i, g in enumerate(c3.gates) if g.params)
    g = c3.gates[gi]
    c3.gates[gi] = replace(g, params=(g.params[0] + 1e-3,) + g.params[1:])
    assert CircuitKey.make(_port(c3), 5, 2, 1) == k1  # angles: same key
    c4 = gen.qft(8)
    c4.gates[gi] = replace(c4.gates[gi], qubits=(c4.gates[gi].qubits[0],
                                                 (c4.gates[gi].qubits[1] + 1) % 8))
    assert CircuitKey.make(_port(c4), 5, 2, 1) != k1  # wiring: another key
    # symbolic and bound circuits of one structure share a key
    assert CircuitKey.make(_port(_ansatz(5)), 4, 1, 0) == CircuitKey.make(
        _port(_ansatz(5, _vals(5, 1))), 4, 1, 0)
    c = _port(gen.qft(8))
    base = CircuitKey.make(c, 5, 2, 1)
    assert CircuitKey.make(c, 6, 1, 1) != base
    for knob, val in [("backend", "dense"), ("use_kernels", False), ("peephole", False),
                      ("staging_method", "greedy"), ("kernelize_method", "greedy"),
                      ("optimize", True)]:
        assert CircuitKey.make(c, 5, 2, 1, **{knob: val}) != base, knob
    from repro_torch.core.cost_model import CostModel

    assert CircuitKey.make(c, 5, 2, 1, cost_model=CostModel(shm_gate_us=1.0)) != base


def test_compile_cache_hit_and_eviction():
    cache = CompileCache(maxsize=2)
    c = _port(gen.qft(7))
    e1 = engine_for(c, 5, 2, 0, cache=cache, device="cpu")
    e2 = engine_for(c, 5, 2, 0, cache=cache, device="cpu")
    assert e2 is e1 and cache.hits == 1 and cache.misses == 1
    assert_states_close(e2.run().numpy(), simulate_np(gen.qft(7)), atol=1e-5)
    engine_for(c, 4, 3, 0, cache=cache, device="cpu")
    engine_for(_port(gen.ising(7)), 5, 2, 0, cache=cache, device="cpu")
    assert len(cache) == 2 and cache.evictions == 1
    misses = cache.misses
    e4 = engine_for(c, 5, 2, 0, cache=cache, device="cpu")
    assert e4 is not e1 and cache.misses == misses + 1
    stats = cache.stats()
    assert stats["size"] == 2 and stats["hits"] == 1 and stats["evictions"] == 2


def test_compile_cache_is_placement_aware():
    """The device is part of the key: engines on two devices never share
    an entry."""
    c = _port(gen.qft(7))
    keys = {circuit_key_for(c, 5, 2, 0, device=d) for d in ("cpu", "cuda:0", "cuda:1")}
    assert len(keys) == 3
    assert circuit_key_for(c, 5, 2, 0, device="cuda:0") == circuit_key_for(
        c, 5, 2, 0, device=torch.device("cuda", 0))
    cache = CompileCache()
    e1 = engine_for(c, 5, 2, 0, cache=cache, device="cpu")
    key = circuit_key_for(c, 5, 2, 0, device="cpu")
    assert key in cache and cache.peek(key) is e1
    assert circuit_key_for(c, 5, 2, 0, device="cuda:1") not in cache


def test_symbolic_hit_adopts_requested_skeleton():
    """The key is blind to Param names and affine scales, so a symbolic
    request that hits a symbolic-built entry adopts the requested skeleton."""
    from repro.core.circuit import Circuit
    from repro.core.gates import Param

    n = 4
    cache = CompileCache()

    def skel(scale=1.0, prefix="t"):
        c = Circuit(n)
        for q in range(n):
            c.add("ry", q, params=[Param(f"{prefix}{q}") * scale])
        for q in range(n - 1):
            c.add("cx", q + 1, q)
        return c

    e1 = engine_for(_port(skel(1.0)), n, 0, 0, backend="dense", cache=cache, device="cpu")
    e2 = engine_for(_port(skel(2.0)), n, 0, 0, backend="dense", cache=cache, device="cpu")
    assert e2 is e1 and cache.misses == 1
    vals = {f"t{q}": 0.2 + 0.1 * q for q in range(n)}
    assert_states_close(e2.run(params=vals).numpy(), simulate_np(skel(2.0).bind(vals)),
                        atol=1e-5, msg="scale-variant skeleton not adopted")
    e3 = engine_for(_port(skel(1.0, "b")), n, 0, 0, backend="dense", cache=cache, device="cpu")
    assert e3 is e1
    bvals = {f"b{q}": 0.5 for q in range(n)}
    assert_states_close(e3.run(params=bvals).numpy(), simulate_np(skel(1.0, "b").bind(bvals)),
                        atol=1e-5)
    # a bound request on the same entry rebinds it
    e4 = engine_for(_port(skel(1.0).bind(vals)), n, 0, 0, backend="dense", cache=cache,
                    device="cpu")
    assert e4 is e1 and e4.bound_circuit.is_bound


def test_explicit_plan_bypasses_the_cache():
    c = gen.qft(8)
    plan = _plan(partition(c, 5, 2, 1))
    cache = CompileCache()
    e1 = engine_for(_port(c), 5, 2, 1, plan=plan, cache=cache, device="cpu")
    e2 = engine_for(_port(c), 5, 2, 1, plan=plan, cache=cache, device="cpu")
    assert e1 is not e2 and len(cache) == 0 and cache.misses == 0
    assert_states_close(e1.run().numpy(), simulate_np(c), atol=1e-5)
    with pytest.raises(ValueError, match="optimize"):
        engine_for(_port(c), 5, 2, 1, plan=plan, optimize=True, device="cpu")


def test_optimized_plans_equal_reference():
    """``optimize=True`` plans the optimizer's rewrite: the port's plan and
    provenance equal the reference's, the key differs from the literal
    one, and the state is the literal circuit's."""
    c = gen.redundant(8)
    cache = CompileCache()
    ref = ref_engine_for(c, 6, 2, 0, backend="pjit", optimize=True, cache=None)
    eng = engine_for(_port(c), 6, 2, 0, optimize=True, cache=cache, device="cpu")
    a, b = json.loads(eng.plan.to_json()), json.loads(ref.plan.to_json())
    a.pop("preprocess_time_s"), b.pop("preprocess_time_s")
    assert a == b
    prov, ref_prov = eng.provenance["optimize"], ref.provenance["optimize"]
    for k in ("gates_before", "gates_after", "gates_removed", "pass_counts", "passes",
              "source_fingerprint"):
        assert prov[k] == ref_prov[k], k
    assert eng.circuit.n_gates < c.n_gates
    assert_states_close(eng.run().numpy(), simulate_np(c), atol=1e-5)
    literal = engine_for(_port(c), 6, 2, 0, cache=cache, device="cpu")
    assert literal is not eng and cache.misses == 2


def test_storage_raises():
    c = _port(gen.qft(6))
    for call in (lambda: engine_for(c, 4, 2, 0, storage="int8", device="cpu"),
                 lambda: circuit_key_for(c, 4, 2, 0, storage="int8")):
        with pytest.raises(ValueError, match="storage"):
            call()


def test_build_engine_has_no_backend_fallback(monkeypatch):
    """A backend that fails to build raises; the build does not move to
    another backend, and a failed compile is retried once."""
    from repro_torch.sim import engine as teng
    from repro_torch.sim.faults import XlaTraceError

    c = _port(gen.qft(6))
    plan = _plan(partition(gen.qft(6), 4, 2, 0))

    class Broken(teng.CudaBackend):
        def setup(self, engine):
            raise RuntimeError("kernel library failed to load")

    monkeypatch.setitem(teng.BACKENDS, "cuda", Broken)
    with pytest.raises(RuntimeError, match="failed to load"):
        teng.build_engine(c, plan, device="cpu")
    monkeypatch.undo()
    real, fails = teng.compile_plan, [1]

    def flaky(*a, **k):
        if fails:
            fails.pop()
            raise XlaTraceError("transient")
        return real(*a, **k)

    monkeypatch.setattr(teng, "compile_plan", flaky)
    eng = teng.build_engine(c, plan, device="cpu")
    assert eng.provenance["fallbacks"][0]["from"] == "compile"
    assert eng.backend.name == "cuda"


# ---------------------------------------------------------------------- CLI
def test_cli_engine_bind_check(capsys):
    run = cli(["--circuit", "isingparam", "--n", "12", "--L", "10", "--R", "2", "--engine",
               "--bind", "J=0.35", "--bind", "h=0.8", "--check", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "fidelity vs dense reference: 1.000000" in out
    assert "bound 2 params in" in out and "cache: " in out
    assert run.engine.bound_circuit.is_bound


@pytest.mark.parametrize("form", ["list", "columns"])
def test_cli_sweep_check(tmp_path, capsys, form):
    pts = [{"J": 0.35, "h": 0.8}, {"J": -1.1, "h": 0.2}, {"J": 0.0, "h": 0.0}]
    data = pts if form == "list" else {k: [p[k] for p in pts] for k in ("J", "h")}
    path = tmp_path / "points.json"
    path.write_text(json.dumps(data))
    ops.reset_kernel_counters()
    run = cli(["--circuit", "isingparam", "--n", "12", "--L", "10", "--R", "2",
               "--sweep", str(path), "--check", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("vs dense reference: 1.000000") == 3
    assert run.state.shape == (3, 1 << 12)
    _launches_equal_ops(run.engine)


def test_cli_batch_check_and_measure(capsys):
    run = cli(["--circuit", "qft", "--n", "12", "--L", "10", "--R", "2", "--batch", "3",
               "--check", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("vs dense reference: 1.000000") == 3 and len(run.fidelities) == 3
    run = cli(["--circuit", "ghz", "--n", "8", "--L", "6", "--R", "2", "--batch", "3",
               "--shots", "64", "--observable", "Z0 Z7", "--device", "cpu"])
    assert len(run.results) == 3
    for b, res in enumerate(run.results):
        psi0 = np.zeros(256, dtype=np.complex64)
        psi0[b] = 1.0
        want = RM.expectation_np(simulate_np(gen.ghz(8), psi0), "Z0 Z7")
        assert abs(res.expectations["1*Z0 Z7"] - want) < 1e-5


def test_cli_dense_executor_and_opt(capsys):
    run = cli(["--circuit", "redundant", "--n", "8", "--L", "6", "--R", "2", "--opt",
               "--executor", "dense", "--check", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "engine[dense]" in out and "optimizer: " in out
    assert "fidelity vs dense reference: 1.000000" in out
    run = cli(["--circuit", "redundant", "--n", "8", "--L", "6", "--R", "2", "--opt",
               "--check", "--device", "cpu"])
    assert round(run.fidelity, 6) == 1.0


@pytest.mark.parametrize("argv", [
    ["--autotune", "--executor", "pergate"], ["--vqe", "Z0"], ["--storage", "int8"],
    ["--executor", "shardmap"],
    ["--executor", "pergate", "--engine"], ["--circuit", "isingparam", "--device", "cpu"],
    ["--batch", "2", "--shots", "8", "--check", "--device", "cpu"],
])
def test_cli_refuses_what_is_not_ported(argv):
    with pytest.raises(SystemExit) as e:
        cli(["--n", "6", "--L", "4", "--R", "2"] + argv)
    assert e.value.code == 2


def test_aliased_optimized_engine():
    """An optimized engine installed under the literal key (as an autotuner
    would): a literal request maps through the engine's optimizer config
    and shares it; a request whose angles optimize to another structure
    gets a fresh, un-cached engine."""
    from repro.core.circuit import Circuit

    def circ(theta):
        c = Circuit(6)
        for q in range(6):
            c.add("h", q)
            c.add("h", q)
            c.add("rz", q, params=[theta + 0.1 * q])
        for q in range(5):
            c.add("cx", q, q + 1)
        return c

    cache = CompileCache()
    c1 = _port(circ(0.3))
    eng = engine_for(c1, 4, 2, 0, optimize=True, cache=cache, device="cpu")
    assert eng.circuit.n_gates < c1.n_gates
    cache.put(circuit_key_for(c1, 4, 2, 0, device="cpu"), eng)
    hit = engine_for(_port(circ(0.7)), 4, 2, 0, cache=cache, device="cpu")
    assert hit is eng
    assert_states_close(hit.run().numpy(), simulate_np(circ(0.7)), atol=1e-5)
    size = len(cache)
    other = engine_for(_port(circ(0.0)), 4, 2, 0, cache=cache, device="cpu")  # rz(0) drops
    assert other is not eng and len(cache) == size
    assert_states_close(other.run().numpy(), simulate_np(circ(0.0)), atol=1e-5)


def test_engine_for_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine_for(_port(gen.qft(6)), 4, 2, 0, cache=None)
