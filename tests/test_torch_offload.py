"""The port's host-offload path on the CPU against the JAX package's: the
offload backend (``ExecutionEngine(..., backend="offload")``), the
``OffloadedExecutor`` and ``PerGateOffloadExecutor`` entry points, the
``StreamingMeasurer``, ``engine_for`` with ``backend="offload"`` and the CLI
flags that reach them. The port runs with ``device="cpu"``: its "stream" is
a copy between CPU tensors and its kernels' plain versions run.

Tolerances: states within ``atol=1e-5`` (complex64 through a few dozen
gates, as ``tests/test_engine.py``); counters equal; shots identical;
marginals and expectations within 1e-5."""

import json
import threading

import numpy as np
import pytest
import torch

from conftest import assert_states_close
from repro.core import generators as gen
from repro.core.partition import partition
from repro.sim import measure as RM
from repro.sim.engine import ExecutionEngine as RefEngine
from repro.sim.offload import (
    OffloadedExecutor as RefOffloaded, PerGateOffloadExecutor as RefPerGate,
)
from repro.sim.statevector import simulate_np
from repro_torch import convert
from repro_torch.core.circuit import Circuit as PCircuit
from repro_torch.core.partition import SimulationPlan
from repro_torch.kernels import ops
from repro_torch.launch.simulate import main as cli
from repro_torch.sim import apply as tapply, measure as TM
from repro_torch.sim.engine import (
    BACKENDS, CompileCache, ExecutionEngine, circuit_key_for, engine_for,
)
from repro_torch.sim.offload import OffloadedExecutor, PerGateOffloadExecutor
from strategies import SHM_CM
from test_params import _ansatz, _vals

COUNTERS = ("shard_transfers", "host_remaps", "stage_streams", "memory_passes",
            "tensor_uploads", "overlapped_dispatches")

CASES = {
    "qft9": (lambda: gen.qft(9), 6, 3, 0, {}),
    "random_flips": (lambda: gen.random_circuit(8, 40, seed=4), 5, 2, 1, {}),
    "ising10_shm": (lambda: gen.ising(10), 6, 4, 0, {"cost_model": SHM_CM}),
    "qft10_dep": (lambda: gen.qft(10), 8, 2, 0, {}),
}


def _port(c):
    return PCircuit.from_json(c.to_json())


def _pair(name, use_kernels=True):
    """The reference's offload engine and the port's, on one plan and one
    set of op tensors."""
    make, L, R, G, kw = CASES[name]
    circ = make()
    plan = partition(circ, L, R, G, **kw)
    ref = RefEngine(circ, plan, backend="offload")
    eng = convert.engine_from_reference(
        circ.to_json(), plan.to_json(), {u: np.asarray(t) for u, t in ref.consts.items()},
        use_kernels=use_kernels, device="cpu", backend="offload")
    return circ, ref, eng


def _counters(stats):
    return {k: stats[k] for k in COUNTERS}


def _random_batch(n, B, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, 1 << n)) + 1j * rng.normal(size=(B, 1 << n))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.complex64)


# ------------------------------------------------------------ the backend
@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("name", sorted(CASES))
def test_offload_matches_reference(name, use_kernels):
    """run, then run_packed: the same states and the same counters as the
    reference's offload backend, and one kernel launch per op and shard."""
    circ, ref, eng = _pair(name, use_kernels)
    ops.reset_kernel_counters()
    got = eng.run()
    counts = eng.op_counts()
    S = eng.backend.S
    assert ops.kernel_call_counts() == (
        {"fused": S * counts.get("fused", 0), "shm": S * counts.get("shm", 0)}
        if use_kernels else {"fused": 0, "shm": 0})
    assert not got.is_pinned() and got.device.type == "cpu"
    assert_states_close(got.numpy(), np.asarray(ref.run()), atol=1e-5)
    assert_states_close(got.numpy(), simulate_np(circ), atol=1e-5)
    assert_states_close(eng.run_packed().numpy(), np.asarray(ref.run_packed()), atol=1e-5)
    assert _counters(eng.backend.stats) == _counters(ref.backend.stats)
    assert eng.backend.overlap_ratio == ref.backend.overlap_ratio
    kinds = [t["kind"] for t in eng.backend.trace]
    assert kinds.count("stage") == len(eng.cc.programs)


def test_cases_exercise_both_kernels_and_dep_variants():
    kinds, dep = set(), False
    for name in CASES:
        _, _, eng = _pair(name)
        kinds |= set(eng.op_counts())
        dep |= any(v is not None for v in eng.backend._dep.values())
    assert {"fused", "shm"} <= kinds and dep


@pytest.mark.parametrize("B", [1, 2, 3])
@pytest.mark.parametrize("apply_final", [True, False])
def test_offload_batch_matches_reference_and_cuda(B, apply_final):
    """A batch streams [B, 2^L] blocks: one launch per op and shard for all
    B, the reference's states and counters, the cuda backend's states."""
    circ, ref, eng = _pair("random_flips")
    cud = ExecutionEngine(eng.circuit, eng.plan, device="cpu")
    psi0s = _random_batch(8, B, seed=B)
    ops.reset_kernel_counters()
    got = eng.run_batch(psi0s, apply_final=apply_final)
    counts = eng.op_counts()
    assert ops.kernel_call_counts()["fused"] == eng.backend.S * counts.get("fused", 0)
    assert got.shape == (B, 256)
    want = np.asarray(ref.run_batch(psi0s, apply_final=apply_final)).reshape(B, -1)
    on_card = cud.run_batch(psi0s, apply_final=apply_final).numpy()
    for b in range(B):
        assert_states_close(got[b].numpy(), want[b], atol=1e-5, msg=f"row {b}")
        assert_states_close(got[b].numpy(), on_card[b], atol=1e-6, msg=f"row {b} vs cuda")
    assert _counters(eng.backend.stats) == _counters(ref.backend.stats)


@pytest.mark.parametrize("apply_final", [True, False])
def test_offload_sweep_matches_reference_and_cuda(apply_final):
    """A sweep of P bindings streams [P, 2^L] blocks with the stacked
    tables (vidx = p * V + v): the reference's and the cuda backend's
    states, the reference's counters; the engine's own binding untouched."""
    n = 7
    sym = _ansatz(n)
    plan = partition(sym, 5, 2, 0, cost_model=SHM_CM)
    ref = RefEngine(sym, plan, backend="offload")
    eng = ExecutionEngine(_port(sym), SimulationPlan.from_json(plan.to_json()), device="cpu",
                          backend="offload")
    cud = ExecutionEngine(eng.circuit, eng.plan, device="cpu")
    assert eng.op_counts().get("shm", 0) > 0
    batch = np.stack([_vals(n, s) for s in (7, 8, 9, 10)])
    got = eng.run_sweep(None, batch, apply_final=apply_final)
    want = np.asarray(ref.run_sweep(None, batch, apply_final=apply_final)).reshape(4, -1)
    on_card = cud.run_sweep(None, batch, apply_final=apply_final).numpy()
    for p in range(4):
        assert_states_close(got[p].numpy(), want[p], atol=1e-5, msg=f"point {p}")
        assert_states_close(got[p].numpy(), on_card[p], atol=1e-6, msg=f"point {p} vs cuda")
        if apply_final:
            assert_states_close(got[p].numpy(), simulate_np(_ansatz(n, list(batch[p]))),
                                atol=1e-5)
    assert _counters(eng.backend.stats) == _counters(ref.backend.stats)
    assert eng.bound_circuit is None  # the fused sweep binds nothing on the engine


# ------------------------------------------------ per-shard indices and rebinds
def test_rebind_drops_per_shard_indices():
    """The per-shard variant indices and shm operands are dropped on a
    rebind (operands hold tensor values), so a run after a sweep and a
    rebind matches the reference, and the table uploads count again."""
    n = 6
    sym = _ansatz(n)
    plan = partition(sym, 4, 2, 0, cost_model=SHM_CM)
    ref = RefEngine(sym, plan, backend="offload")
    eng = ExecutionEngine(_port(sym), SimulationPlan.from_json(plan.to_json()), device="cpu",
                          backend="offload")
    vals = _vals(n, 3)
    for e in (ref, eng):
        e.bind(dict(zip(sym.param_names, vals)))
        e.run()
        e.run_sweep(None, np.stack([_vals(n, s) for s in (7, 8)]))
    be = eng.backend
    assert be._dev_slices and be._shard_members
    before = be.stats["tensor_uploads"]
    vals2 = _vals(n, 9)
    for e in (ref, eng):
        e.bind(dict(zip(sym.param_names, vals2)))
    assert not be._dev_slices and not be._shard_members
    got = eng.run().numpy()
    np.asarray(ref.run())
    assert be.stats["tensor_uploads"] > before
    assert_states_close(got, simulate_np(_ansatz(n, vals2)), atol=1e-5)
    assert _counters(be.stats) == _counters(ref.backend.stats)


def test_concurrent_sweep_and_run_stay_correct():
    """run and run_sweep on one offload engine from two threads: the sweep's
    tables live in its own run, so the plain run never reads them."""
    n = 6
    sym = _ansatz(n)
    plan = SimulationPlan.from_json(partition(sym, 4, 2, 0).to_json())
    eng = ExecutionEngine(_port(sym), plan, device="cpu", backend="offload")
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


def test_overlap_ratio_single_shard_is_vacuous_one():
    c = _port(gen.random_circuit(6, 16, seed=2))
    eng = engine_for(c, 6, 0, 0, backend="offload", cache=None, device="cpu")
    out = eng.run().numpy()
    assert eng.backend.stats["shard_transfers"] > 0
    assert eng.backend.stats["overlapped_dispatches"] == 0
    assert eng.backend.overlap_ratio == 1.0
    assert_states_close(out, simulate_np(gen.random_circuit(6, 16, seed=2)), atol=1e-5)


# ------------------------------------------------------------ executors
@pytest.mark.parametrize("name,L", [("qft", 6), ("random", 5)])
def test_per_gate_baseline_matches_reference(name, L):
    """The per-gate baseline: the reference's state and shard transfers,
    at least 5x the staged offload's (the QDAO comparison)."""
    circ = gen.qft(9) if name == "qft" else gen.random_circuit(8, 40, seed=4)
    n = circ.n_qubits
    ref_pg = RefPerGate(circ, L)
    want = ref_pg.run()
    pg = PerGateOffloadExecutor(_port(circ), L, device="cpu")
    ops.reset_kernel_counters()
    got = pg.run()
    assert_states_close(got.numpy(), want, atol=1e-5)
    assert_states_close(got.numpy(), simulate_np(circ), atol=1e-5)
    assert pg.stats["shard_transfers"] == ref_pg.stats["shard_transfers"]
    passes = sum(len(p.ops) for p in pg.engine.cc.programs)
    assert pg.stats["shard_transfers"] == passes * (1 << (n - L))
    fused = sum(op.kind == "fused" for p in pg.engine.cc.programs for op in p.ops)
    assert ops.kernel_call_counts()["fused"] == fused * (1 << (n - L))
    plan = partition(circ, L, n - L, 0)
    staged = OffloadedExecutor(_port(circ), SimulationPlan.from_json(plan.to_json()),
                               device="cpu")
    assert_states_close(staged.run().numpy(), simulate_np(circ), atol=1e-5)
    ref_staged = RefOffloaded(circ, plan)
    ref_staged.run()
    assert staged.stats["shard_transfers"] == ref_staged.stats["shard_transfers"]
    assert staged.stats["shard_transfers"] * 5 < pg.stats["shard_transfers"]


def test_offloaded_executor_packed_run():
    circ, ref, _ = _pair("random_flips")
    plan = partition(circ, 5, 2, 1)
    ex = OffloadedExecutor(_port(circ), SimulationPlan.from_json(plan.to_json()), device="cpu")
    assert_states_close(ex.run(apply_final_remap=False).numpy(),
                        np.asarray(RefOffloaded(circ, plan).run(apply_final_remap=False)),
                        atol=1e-5)
    assert ex.measurement_frame.layout == ref.measurement_frame.layout


# ------------------------------------------------------------ measurement
def _nonlocal_obs(frame, L):
    nl = [q for q in range(frame.n) if frame.phys_of[q] >= L]
    loc = [q for q in range(frame.n) if frame.phys_of[q] < L]
    return [f"X{nl[0]} + 0.5*Y{nl[1]} Z{loc[0]}",
            f"X{nl[0]} Y{nl[1]} X{loc[1]} - 0.25*Z{nl[0]} Z{loc[2]}",
            f"Y{loc[0]} X{loc[3]} + Z{nl[1]}"]


@pytest.mark.parametrize("name,seed", [("qft9", 0), ("random_flips", 5), ("ising10_shm", 3)])
def test_streaming_measurer_matches_reference(name, seed):
    """The same shots for a seed, marginals and expectations (X/Y on
    non-local bits among them: shard groups rotated on the device) within
    1e-5 of the reference's StreamingMeasurer and of the oracles."""
    circ, ref, eng = _pair(name)
    frame = eng.measurement_frame
    obs = _nonlocal_obs(frame, eng.L)
    marginals = [(0, 1, 2), (circ.n_qubits - 1, 3)]
    ref_res = RM.measure_to_result(
        RM.measurer_for(np.asarray(ref.run_packed()), ref.measurement_frame), backend="offload",
        shots=400, seed=seed, marginals=marginals, observables=obs)
    m = TM.measurer_for(eng.run_packed(), frame, eng)
    assert isinstance(m, TM.StreamingMeasurer)
    res = TM.measure_to_result(m, backend="offload", shots=400, seed=seed,
                               marginals=marginals, observables=obs)
    np.testing.assert_array_equal(res.samples, ref_res.samples)
    psi = simulate_np(circ)
    for qs in marginals:
        np.testing.assert_allclose(res.marginals[qs], ref_res.marginals[qs], atol=1e-5)
        np.testing.assert_allclose(res.marginals[qs], TM.marginal_np(psi, qs), atol=1e-5)
    for key, o in zip(res.expectations, obs):
        assert abs(res.expectations[key] - ref_res.expectations[key]) < 1e-5
        assert abs(res.expectations[key] - TM.expectation_np(psi, o)) < 1e-5


@pytest.mark.parametrize("shift", [0, 1, 2])
@pytest.mark.parametrize("name", ["qft9", "ising10_shm"])
def test_streaming_measurer_rotates_groups_in_chunks(name, shift, monkeypatch):
    """Terms with m = 1..3 non-local X/Y bits (and local X/Y, local and
    non-local Z): every group product holds at most ``2^(L - shift)``
    amplitudes (a whole shard, half a shard as by default, a quarter), and
    the expectations agree with the reference's StreamingMeasurer and with
    the complex128 oracle within 1e-6."""
    circ, ref, eng = _pair(name)
    frame, L = eng.measurement_frame, eng.L
    nl = [q for q in range(frame.n) if frame.phys_of[q] >= L]
    loc = [q for q in range(frame.n) if frame.phys_of[q] < L]
    obs = [f"X{nl[0]} Y{nl[1]} Z{loc[0]}", f"Y{nl[0]} X{nl[1]} X{nl[2]} Y{loc[1]} Z{loc[4]}",
           f"X{nl[2]} Z{nl[0]} X{loc[0]} Y{loc[2]} Z{loc[3]}", f"Z{nl[1]} Z{loc[1]}",
           f"0.5*X{nl[0]} Y{nl[1]} Y{nl[2]} + Z{loc[0]}"]
    state = eng.run_packed()
    monkeypatch.setattr(TM, "GROUP_CHUNK_SHIFT", shift)
    m = TM.StreamingMeasurer(state, frame, "cpu")
    limit = 1 << (L - shift)
    seen = []
    real_matmul = torch.matmul

    def spy(a, b, *args, **kw):
        seen.append(b.numel())
        return real_matmul(a, b, *args, **kw)

    monkeypatch.setattr(TM.torch, "matmul", spy)
    ref_m = RM.StreamingMeasurer(np.asarray(ref.run_packed()), ref.measurement_frame)
    psi = simulate_np(circ)
    for o in obs:
        got = m.expectation(o)
        assert abs(got - ref_m.expectation(o)) < 1e-6, o
        assert abs(got - TM.expectation_np(psi, o)) < 1e-6, o
    assert seen and max(seen) <= limit


@pytest.mark.parametrize("name", ["qft9", "random_flips", "ising10_shm"])
def test_shard_masses_match_the_reference_mass_row(name):
    """The port sums each shard's mass as fp32 squares in an fp64
    accumulation; the reference through one jitted fp32 ``_jnp_mass_row``,
    whose own reduction order depends on XLA's backend. They agree within
    fp32 rounding, and a fixed seed gives the reference's shots on these
    states."""
    import jax.numpy as jnp

    _, ref, eng = _pair(name)
    state = eng.run_packed()
    host = np.asarray(ref.run_packed())
    L = eng.L
    want = np.array([float(RM._jnp_mass_row(jnp.asarray(host[s << L:(s + 1) << L])))
                     for s in range(eng.backend.S)])
    for m in (TM.StreamingMeasurer(state, eng.measurement_frame, "cpu"),
              TM.TorchMeasurer(state, eng.measurement_frame),
              TM.DenseMeasurer(state.numpy(), eng.measurement_frame)):
        np.testing.assert_allclose(m._shard_masses(), want, rtol=1e-6, atol=1e-12)
    ref_m = RM.StreamingMeasurer(host, ref.measurement_frame)
    got_m = TM.StreamingMeasurer(state, eng.measurement_frame, "cpu")
    for seed in (0, 1, 2):
        np.testing.assert_array_equal(got_m.sample(500, seed=seed), ref_m.sample(500, seed=seed))


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_probs64_matches_the_reference_bit_for_bit(dtype, as_tensor, monkeypatch):
    """The local CDF's float64 ``|amp|^2``, worked in chunks through torch,
    equals the reference's numpy ``_probs64`` bit for bit on amplitudes
    spanning 1e-30..1e5, over a ragged last chunk."""
    monkeypatch.setattr(TM, "_PROBS_CHUNK", 1000)
    rng = np.random.default_rng(5)
    n = 5 * 1000 + 37
    mag = 10.0 ** rng.uniform(-30, 5, n)
    row = (mag * np.exp(2j * np.pi * rng.random(n))).astype(dtype)
    got = TM._probs64(torch.from_numpy(row) if as_tensor else row)
    want = RM._probs64(row)
    assert got.dtype == np.float64 and got.shape == (n,)
    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))


def test_streaming_measurer_group_cap():
    st = torch.zeros(1 << 12, dtype=torch.complex64)
    st[0] = 1
    m = TM.StreamingMeasurer(st, TM.Frame.identity(12, L=2), "cpu")
    assert m.expectation("Z0 Z11") == pytest.approx(1.0)
    m.MAX_GROUP_BITS = 2
    with pytest.raises(ValueError, match="working-set cap"):
        m.expectation("X2 X3 X4")


def test_measurer_follows_the_backend_not_the_device():
    """On the CPU both backends hand back CPU tensors: the engine that made
    the state picks the measurer, and both measure alike."""
    circ, _, off = _pair("random_flips")
    cud = ExecutionEngine(off.circuit, off.plan, device="cpu")
    a, b = off.run_packed(), cud.run_packed()
    assert a.device == b.device
    ma = TM.measurer_for(a, off.measurement_frame, off)
    mb = TM.measurer_for(b, cud.measurement_frame, cud)
    assert isinstance(ma, TM.StreamingMeasurer) and isinstance(mb, TM.TorchMeasurer)
    assert isinstance(TM.measurer_for(a, off.measurement_frame), TM.TorchMeasurer)
    np.testing.assert_array_equal(ma.sample(200, seed=4), mb.sample(200, seed=4))
    assert ma.expectation("X0 Y5 + Z7") == pytest.approx(mb.expectation("X0 Y5 + Z7"), abs=1e-6)


@pytest.mark.parametrize("what", ["batch", "sweep"])
def test_measure_batch_and_sweep_on_offload(what):
    n = 6
    sym = _ansatz(n)
    plan = SimulationPlan.from_json(partition(sym, 4, 2, 0).to_json())
    off = ExecutionEngine(_port(sym), plan, device="cpu", backend="offload")
    cud = ExecutionEngine(_port(sym), plan, device="cpu")
    kw = dict(shots=64, seed=3, marginals=[(0, 1)], observables=["X0 Z5 + Y4"])
    if what == "batch":
        vals = _vals(n, 3)
        for e in (off, cud):
            e.bind(dict(zip(sym.param_names, vals)))
        psi0s = _random_batch(n, 2, seed=1)
        got, want = TM.measure_batch(off, psi0s, **kw), TM.measure_batch(cud, psi0s, **kw)
    else:
        batch = np.stack([_vals(n, s) for s in (7, 8, 9)])
        got, want = TM.measure_sweep(off, batch, **kw), TM.measure_sweep(cud, batch, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.backend == "offload"
        np.testing.assert_array_equal(g.samples, w.samples)
        np.testing.assert_allclose(g.marginals[(0, 1)], w.marginals[(0, 1)], atol=1e-5)
        for k in g.expectations:
            assert abs(g.expectations[k] - w.expectations[k]) < 1e-5


def test_simulate_and_measure_offload():
    circ = gen.ghz(8)
    res = TM.simulate_and_measure(_port(circ), backend="offload", L=5, R=3, shots=256, seed=1,
                                  marginals=[(0, 7)], observables=["Z0 Z7", "X0 X1 X2 X3 X4 X5 X6 X7"],
                                  device="cpu")
    assert set(np.unique(res.samples)) <= {0, 255}
    np.testing.assert_allclose(res.marginals[(0, 7)], [0.5, 0, 0, 0.5], atol=1e-6)
    for v in res.expectations.values():
        assert v == pytest.approx(1.0, abs=1e-5)


# ------------------------------------------------------------ compile cache
def test_engine_for_caches_offload_apart_from_cuda():
    cache = CompileCache()
    c = _port(gen.qft(8))
    off = engine_for(c, 5, 3, 0, backend="offload", cache=cache, device="cpu")
    cud = engine_for(c, 5, 3, 0, backend="cuda", cache=cache, device="cpu")
    assert off is not cud and off.backend.name == "offload" and cud.backend.name == "cuda"
    assert engine_for(c, 5, 3, 0, backend="offload", cache=cache, device="cpu") is off
    assert cache.stats()["hits"] == 1 and len(cache) == 2
    assert (circuit_key_for(c, 5, 3, 0, backend="offload", device="cpu")
            != circuit_key_for(c, 5, 3, 0, backend="cuda", device="cpu"))
    assert_states_close(off.run().numpy(), cud.run().numpy(), atol=1e-6)


def test_engine_for_offload_warm_rebind():
    """A structural hit with other angles rebinds the cached offload engine:
    no new plan, and its next run matches the reference."""
    cache = CompileCache()
    n = 7
    e1 = engine_for(_port(_ansatz(n, _vals(n, 1))), 5, 2, 0, backend="offload", cache=cache,
                    device="cpu")
    e1.run()
    e2 = engine_for(_port(_ansatz(n, _vals(n, 2))), 5, 2, 0, backend="offload", cache=cache,
                    device="cpu")
    assert e2 is e1 and e1.bind_count == 1 and cache.stats()["hits"] == 1
    assert not e1.backend._dev_slices
    assert_states_close(e1.run().numpy(), simulate_np(_ansatz(n, _vals(n, 2))), atol=1e-5)


def test_no_fallback_and_no_pinning_on_the_cpu(monkeypatch):
    """The CPU branch is the caller's choice: without CUDA the default
    device raises (no CPU fallback), and a CPU run pins nothing."""
    assert "offload" in BACKENDS
    c = _port(gen.qft(6))
    plan = SimulationPlan.from_json(partition(gen.qft(6), 4, 2, 0).to_json())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ExecutionEngine(c, plan, backend="offload")
    pins = []
    real = torch.empty

    def spy(*a, **kw):
        pins.append(kw.get("pin_memory", False))
        return real(*a, **kw)

    monkeypatch.setattr(torch, "empty", spy)
    eng = ExecutionEngine(c, plan, device="cpu", backend="offload")
    eng.run()
    assert pins and not any(pins)


def test_permute_bits_into_a_given_buffer():
    x = torch.randn(3, 1 << 6, dtype=torch.complex64)
    src, flips = [2, 0, 5, 1, 4, 3], [0, 4]
    want = tapply.permute_bits(x, src, flips, lead=1)
    out = torch.empty_like(x)
    got = tapply.permute_bits(x, src, flips, lead=1, out=out)
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        tapply.permute_bits(x, src, flips, lead=1, out=x)


# ------------------------------------------------------------ the CLI
@pytest.mark.parametrize("argv", [
    ["--circuit", "qft", "--n", "10", "--L", "7", "--R", "3", "--executor", "offload"],
    ["--circuit", "ising", "--n", "10", "--L", "6", "--R", "4", "--executor", "offload",
     "--engine"],
    ["--circuit", "qft", "--n", "10", "--L", "7", "--R", "3", "--executor", "pergate"],
    ["--circuit", "qft", "--n", "9", "--L", "6", "--R", "3", "--executor", "offload",
     "--batch", "2"],
])
def test_cli_offload_check(argv):
    run = cli(argv + ["--check", "--device", "cpu"])
    assert run.fidelities and all(round(f, 6) == 1.0 for f in run.fidelities)


def test_cli_offload_measures_like_the_reference():
    argv = ["--circuit", "ising", "--n", "10", "--L", "6", "--R", "4", "--shots", "128",
            "--seed", "5", "--marginal", "0,1,2", "--observable", "Z0 Z1 + 0.5*X2"]
    from repro.launch.simulate import main as ref_cli

    ref_res = ref_cli(argv + ["--executor", "offload"])
    run = cli(argv + ["--executor", "offload", "--device", "cpu"])
    np.testing.assert_array_equal(run.result.samples, ref_res.samples)
    np.testing.assert_allclose(run.result.marginals[(0, 1, 2)], ref_res.marginals[(0, 1, 2)],
                               atol=1e-5)
    for k, v in run.result.expectations.items():
        assert abs(v - ref_res.expectations[k]) < 1e-5


def test_cli_offload_sweep(tmp_path):
    points = [{"J": 0.35, "h": 0.8}, {"J": -1.1, "h": 0.2}]
    path = tmp_path / "points.json"
    path.write_text(json.dumps(points))
    run = cli(["--circuit", "isingparam", "--n", "9", "--L", "6", "--R", "3", "--executor",
               "offload", "--sweep", str(path), "--check", "--device", "cpu"])
    assert run.engine.backend.name == "offload" and len(run.fidelities) == 2
    assert all(round(f, 6) == 1.0 for f in run.fidelities)


@pytest.mark.parametrize("argv", [["--executor", "pergate", "--engine"],
                                  ["--executor", "cuda", "--storage", "int8"]])
def test_cli_refuses(argv):
    with pytest.raises(SystemExit):
        cli(["--circuit", "qft", "--n", "8", "--L", "5", "--R", "3", "--device", "cpu"] + argv)
