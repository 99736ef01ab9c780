"""The port's integrity guard, fault sites and degradation ladder on the CPU,
against the JAX package's (``tests/test_faults.py``'s engine tests).

The same circuits and the same seeded ``FaultPlan`` go through
``repro.sim.engine.engine_for`` (``backend="pjit"`` without a mesh, or
``"offload"``) and ``repro_torch.sim.engine.engine_for`` (``device="cpu"``).
The port keeps the reference's planning rungs and its one compile retry;
it has no backend rung and no retry without the kernels: where the
reference degrades to the dense oracle, the port raises the same typed
error. Where the reference's integrity guard retries on its dense per-gate
oracle, the port re-runs the plan through its own backend and kernels.

Tolerances: recovered and clean states within ``atol=1e-5`` of the
reference's and of ``simulate_np`` (complex64 through a few dozen gates);
provenance counters and the poisoned sweep row equal.
"""

import time

import numpy as np
import pytest
import torch

from conftest import assert_states_close
from repro.core.generators import PARAM_FAMILIES as REF_PARAM_FAMILIES, random_circuit
from repro.sim import faults as rfaults
from repro.sim.engine import engine_for as ref_engine_for
from repro.sim.statevector import simulate_np
from repro_torch.core.circuit import Circuit as PCircuit
from repro_torch.kernels import build as kbuild, ops
from repro_torch.sim import engine as teng, faults, statevector
from repro_torch.sim.engine import engine_for
from repro_torch.sim.faults import (
    BackendBuildError, FaultPlan, IntegrityError, PallasLoweringError, XlaTraceError,
)

C8 = random_circuit(8, 20, seed=3)
C6 = random_circuit(6, 14, seed=3)
SPLIT8 = dict(L=5, R=3)  # n > L: real staging, a non-trivial packed frame
SPLIT6 = dict(L=4, R=2)
REF_BACKEND = {"cuda": "pjit", "offload": "offload"}


def _port(c):
    return PCircuit.from_json(c.to_json())


def _np(x):
    return np.asarray(x).reshape(-1) if not hasattr(x, "cpu") else x.cpu().numpy().reshape(-1)


def _engines(circ, split, backend="cuda", **kw):
    ref = ref_engine_for(circ, **split, backend=REF_BACKEND[backend], cache=None, **kw)
    port = engine_for(_port(circ), **split, backend=backend, cache=None, device="cpu", **kw)
    return ref, port


def _plan(seed=3, **kw):
    return (rfaults.FaultPlan(seed=seed).add("nan_amplitudes", **kw),
            FaultPlan(seed=seed).add("nan_amplitudes", **kw))


# ==========================================================================
# post-run integrity guard
# ==========================================================================

@pytest.mark.parametrize("backend", ["cuda", "offload"])
@pytest.mark.parametrize("entry", ["run", "run_packed"])
def test_nan_with_verify_recovers_like_the_reference(backend, entry):
    ref, port = _engines(C8, SPLIT8, backend)
    rplan, pplan = _plan(count=1)
    with rfaults.inject(rplan):
        want = _np(getattr(ref, entry)(verify=True))
    with faults.inject(pplan):
        got = _np(getattr(port, entry)(verify=True))
    np.testing.assert_allclose(got, want, atol=1e-5)
    if entry == "run":
        np.testing.assert_allclose(got, simulate_np(C8), atol=1e-5)
    for key in ("integrity_retries", "integrity_recovered"):
        assert port.provenance[key] == ref.provenance[key] == 1
    assert pplan.fires == rplan.fires == {"nan_amplitudes": 1}


def test_nan_without_verify_passes_through():
    ref, port = _engines(C6, SPLIT6)
    rplan, pplan = _plan(count=1)
    with rfaults.inject(rplan):
        want = _np(ref.run())
    with faults.inject(pplan):
        got = _np(port.run())
    assert not np.all(np.isfinite(want)) and not np.all(np.isfinite(got))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert "integrity_retries" not in port.provenance


def test_clean_run_with_verify_records_no_retry():
    ref, port = _engines(C8, SPLIT8)
    got = port.run_packed(verify=True)
    np.testing.assert_allclose(_np(got), _np(ref.run_packed(verify=True)), atol=1e-5)
    assert "integrity_retries" not in port.provenance
    assert "integrity_retries" not in ref.provenance


def test_verify_holds_the_initial_states_norm():
    """An initial state of norm 2 ends at norm 2: no retry (the guard holds
    ||psi0||, not 1)."""
    rng = np.random.default_rng(1)
    psi0 = rng.normal(size=1 << 6) + 1j * rng.normal(size=1 << 6)
    psi0 = (2 * psi0 / np.linalg.norm(psi0)).astype(np.complex64)
    _, port = _engines(C6, SPLIT6)
    out = port.run(psi0, verify=True)
    np.testing.assert_allclose(_np(out), simulate_np(C6, psi0), atol=1e-5)
    assert "integrity_retries" not in port.provenance


def _nan_binding(sym):
    return dict.fromkeys(sym.param_names, float("nan"))


@pytest.mark.parametrize("entry", ["run", "run_packed", "run_sweep"])
def test_unrecoverable_integrity_raises_typed_in_both(entry):
    """A binding that is numerically corrupt poisons the reference's dense
    oracle and the port's re-run alike: one retry each, then the typed
    error."""
    sym = REF_PARAM_FAMILIES["su2param"](6)
    ref, port = _engines(sym, SPLIT6)
    bad = _nan_binding(sym)
    for eng, err in ((ref, rfaults.IntegrityError), (port, IntegrityError)):
        with pytest.raises(err):
            if entry == "run_sweep":
                eng.run_sweep(None, [bad], verify=True)
            else:
                getattr(eng, entry)(params=bad, verify=True)
    assert port.provenance["integrity_retries"] == ref.provenance["integrity_retries"] == 1
    assert "integrity_recovered" not in port.provenance


@pytest.mark.parametrize("backend", ["cuda", "offload", "dense"])
def test_guard_retry_reruns_the_plan_not_the_per_gate_oracle(monkeypatch, backend):
    """The one retry is the engine's own backend again (its kernels on the
    card), never the per-gate oracle, and its state comes back where the
    run's did."""
    port = engine_for(_port(C8), **SPLIT8, backend=backend, cache=None, device="cpu")
    calls, real = [], port.backend.execute

    def execute(*a, **k):
        calls.append(1)
        return real(*a, **k)

    def no_oracle(*a, **k):
        raise AssertionError("the guard fell back to the per-gate oracle")

    monkeypatch.setattr(port.backend, "execute", execute)
    if backend != "dense":  # the dense backend's own path IS the per-gate one
        monkeypatch.setattr(statevector, "simulate", no_oracle)
    clean = port.run()
    with faults.inject(FaultPlan(seed=3).add("nan_amplitudes", count=1)):
        out = port.run(verify=True)
    assert len(calls) == 3 and out.device == clean.device
    np.testing.assert_allclose(_np(out), _np(clean), atol=1e-5)
    assert port.provenance["integrity_recovered"] == 1


def test_sweep_retry_leaves_the_engines_binding():
    """A poisoned sweep row is re-run under its own binding; the engine's
    binding (here: none, a symbolic engine) is as it was."""
    sym = REF_PARAM_FAMILIES["su2param"](6)
    pts = _sweep_points(sym, P=3)
    _, port = _engines(sym, SPLIT6)
    assert port.bound_circuit is None
    with faults.inject(FaultPlan(seed=5).add("nan_amplitudes", count=1,
                                             site="engine.run_sweep")):
        port.run_sweep(None, pts, verify=True)
    assert port.bound_circuit is None and port.provenance["integrity_recovered"] == 1
    port.bind(pts[0])
    with faults.inject(FaultPlan(seed=5).add("nan_amplitudes", count=1,
                                             site="engine.run_sweep")):
        port.run_sweep(None, pts, verify=True)
    assert port.bound_circuit.binding_signature() == sym.bind(pts[0]).binding_signature()


def _sweep_points(sym, P=4):
    names = sym.param_names
    return [dict(zip(names, np.full(len(names), 0.1 * (i + 1)))) for i in range(P)]


@pytest.mark.parametrize("seed", [5, 6, 7, 11])
def test_sweep_poisoned_row_is_the_references_and_alone_retried(seed):
    sym = REF_PARAM_FAMILIES["su2param"](6)
    pts = _sweep_points(sym)
    ref, port = _engines(sym, SPLIT6)
    clean = _np(port.run_sweep(None, pts)).reshape(len(pts), -1)
    np.testing.assert_allclose(clean, np.asarray(ref.run_sweep(None, pts)).reshape(len(pts), -1),
                               atol=1e-5)
    rplan, pplan = _plan(seed, count=1, site="engine.run_sweep")
    with rfaults.inject(rplan):
        rbad = np.asarray(ref.run_sweep(None, pts)).reshape(len(pts), -1)
    with faults.inject(pplan):
        pbad = _np(port.run_sweep(None, pts)).reshape(len(pts), -1)
    rows = [i for i in range(len(pts)) if not np.all(np.isfinite(pbad[i]))]
    assert len(rows) == 1
    assert rows == [i for i in range(len(pts)) if not np.all(np.isfinite(rbad[i]))]
    rplan, pplan = _plan(seed, count=1, site="engine.run_sweep")
    with rfaults.inject(rplan):
        rout = np.asarray(ref.run_sweep(None, pts, verify=True)).reshape(len(pts), -1)
    with faults.inject(pplan):
        pout = _np(port.run_sweep(None, pts, verify=True)).reshape(len(pts), -1)
    np.testing.assert_allclose(pout, clean, atol=1e-5)
    np.testing.assert_allclose(pout, rout, atol=1e-5)
    for i in range(len(pts)):
        if i not in rows:  # the clean rows are the sweep's own, untouched
            np.testing.assert_array_equal(pout[i], pbad[i])
    for key in ("integrity_retries", "integrity_recovered"):
        assert port.provenance[key] == ref.provenance[key] == 1


def test_sweep_poison_recovered_on_the_dense_backend():
    """The dense backend sweeps point by point through ``run``; the poisoned
    row is still the reference's draw and alone retried."""
    sym = REF_PARAM_FAMILIES["su2param"](6)
    pts = _sweep_points(sym, P=3)
    port = engine_for(_port(sym), **SPLIT6, backend="dense", cache=None, device="cpu")
    clean = _np(port.run_sweep(None, pts)).reshape(3, -1)
    with faults.inject(FaultPlan(seed=5).add("nan_amplitudes", count=1,
                                             site="engine.run_sweep")):
        out = _np(port.run_sweep(None, pts, verify=True)).reshape(3, -1)
    np.testing.assert_allclose(out, clean, atol=1e-5)
    assert port.provenance["integrity_recovered"] == 1


@pytest.mark.parametrize("site", ["engine.run", "engine.run_sweep"])
def test_slow_stage_injects_latency_at_the_engine(site):
    sym = REF_PARAM_FAMILIES["su2param"](6)
    port = engine_for(_port(sym), **SPLIT6, cache=None, device="cpu")
    pts = _sweep_points(sym, P=2)
    port.bind(pts[0])
    plan = FaultPlan(seed=1).add("slow_stage", delay_s=0.05, site=site)
    with faults.inject(plan):
        t0 = time.perf_counter()
        if site == "engine.run":
            port.run()
        else:
            port.run_sweep(None, pts)
        took = time.perf_counter() - t0
    assert plan.fires == {"slow_stage": 1} and took >= 0.05


# ==========================================================================
# planning rungs of the ladder
# ==========================================================================

@pytest.mark.parametrize("point", ["ilp_timeout", "dp_solve_error"])
def test_planning_rungs_give_the_references_fallbacks(point):
    with rfaults.inject(rfaults.FaultPlan(seed=1).add(point)):
        ref = ref_engine_for(C8, L=5, G=3, cache=None)
    with faults.inject(FaultPlan(seed=1).add(point)):
        port = engine_for(_port(C8), L=5, G=3, cache=None, device="cpu")
    assert port.provenance["degraded"] and ref.provenance["degraded"]
    route = [(f["from"], f["to"]) for f in port.provenance["fallbacks"]]
    assert route == [(f["from"], f["to"]) for f in ref.provenance["fallbacks"]]
    assert port.plan.n_stages == ref.plan.n_stages
    np.testing.assert_allclose(_np(port.run()), simulate_np(C8), atol=1e-5)
    np.testing.assert_allclose(_np(port.run()), np.asarray(ref.run()).reshape(-1), atol=1e-5)


def test_transient_compile_fault_gets_one_retry():
    spec = dict(count=1, site="compile.compile_plan")
    with rfaults.inject(rfaults.FaultPlan(seed=2).add("xla_trace_error", **spec)):
        ref = ref_engine_for(C6, L=6, cache=None)
    with faults.inject(FaultPlan(seed=2).add("xla_trace_error", **spec)):
        port = engine_for(_port(C6), L=6, cache=None, device="cpu")
    assert port.provenance["backend"] == "cuda"
    assert [f["from"] for f in port.provenance["fallbacks"]] == \
        [f["from"] for f in ref.provenance["fallbacks"]] == ["compile"]
    np.testing.assert_allclose(_np(port.run()), simulate_np(C6), atol=1e-5)


def test_persistent_compile_fault_raises_typed():
    spec = dict(site="compile.compile_plan")
    with rfaults.inject(rfaults.FaultPlan(seed=2).add("xla_trace_error", **spec)):
        with pytest.raises(rfaults.XlaTraceError):
            ref_engine_for(C6, L=6, cache=None)
    with faults.inject(FaultPlan(seed=2).add("xla_trace_error", **spec)) as plan:
        with pytest.raises(XlaTraceError):
            engine_for(_port(C6), L=6, cache=None, device="cpu")
    assert plan.fires["xla_trace_error"] == 2


# ==========================================================================
# build faults: typed, and no other backend built
# ==========================================================================

def _built(monkeypatch):
    """The (backend, use_kernels) of every engine construction."""
    seen, real = [], teng.ExecutionEngine.__init__

    def init(self, circuit, plan, use_kernels=True, device=None, **kw):
        be = kw.get("backend", "cuda")
        seen.append((be if isinstance(be, str) else be.name, use_kernels))
        real(self, circuit, plan, use_kernels, device, **kw)

    monkeypatch.setattr(teng.ExecutionEngine, "__init__", init)
    return seen


@pytest.mark.parametrize("backend", ["cuda", "offload"])
def test_backend_setup_fault_raises_typed_with_no_other_backend(monkeypatch, backend):
    site = f"{backend}.setup"
    with rfaults.inject(rfaults.FaultPlan(seed=2).add("xla_trace_error",
                                                      site=f"{REF_BACKEND[backend]}.setup")):
        ref = ref_engine_for(C8, L=5, G=3, backend=REF_BACKEND[backend], cache=None)
    assert ref.provenance["backend"] == "dense"  # the reference degrades
    seen = _built(monkeypatch)
    with faults.inject(FaultPlan(seed=2).add("xla_trace_error", site=site)) as plan:
        with pytest.raises(XlaTraceError) as ei:
            engine_for(_port(C8), L=5, G=3, backend=backend, cache=None, device="cpu")
    assert ei.value.injected and isinstance(ei.value, BackendBuildError)
    assert seen == [(backend, True)] and plan.fires == {"xla_trace_error": 1}


def test_dense_backend_setup_is_exempt():
    with faults.inject(FaultPlan(seed=2).add("xla_trace_error", site="dense.setup")) as plan:
        eng = engine_for(_port(C6), **SPLIT6, backend="dense", cache=None, device="cpu")
    assert plan.fires == {} and eng.provenance["backend"] == "dense"


def test_kernel_fault_raises_typed_with_no_retry_without_kernels(monkeypatch):
    with rfaults.inject(rfaults.FaultPlan(seed=4).add("pallas_lowering_error")):
        ref = ref_engine_for(C6, L=6, cache=None, use_pallas=True)
    assert ref.provenance["use_pallas"] is False  # the reference retries without
    seen = _built(monkeypatch)
    with faults.inject(FaultPlan(seed=4).add("pallas_lowering_error")) as plan:
        with pytest.raises(PallasLoweringError):
            engine_for(_port(C6), L=6, cache=None, device="cpu")
    assert seen == [("cuda", True)] and plan.fires == {"pallas_lowering_error": 1}


def test_kernel_probe_only_when_the_kernels_are_asked_for():
    with faults.inject(FaultPlan(seed=4).add("pallas_lowering_error")) as plan:
        eng = engine_for(_port(C6), L=6, cache=None, device="cpu", use_kernels=False)
    assert plan.fires == {}
    np.testing.assert_allclose(_np(eng.run()), simulate_np(C6), atol=1e-5)


def _fail_nvcc(monkeypatch, tmp_path):
    def boom(names=kbuild.SOURCES):
        raise RuntimeError("nvcc failed for fused_apply.cu (exit 1)")
    monkeypatch.setattr(kbuild, "build", boom)


def _no_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(kbuild.shutil, "which", lambda name: None)


def _bad_library(monkeypatch, tmp_path):
    (tmp_path / "lib.so").write_bytes(b"not a shared object")
    monkeypatch.setattr(kbuild, "build", lambda names=kbuild.SOURCES: {
        "fused_apply": tmp_path / "lib.so", "shm_apply": tmp_path / "lib.so"})


@pytest.mark.parametrize("cause,breaks", [
    (RuntimeError, _fail_nvcc), (RuntimeError, _no_nvcc), (OSError, _bad_library)])
def test_kernel_build_failure_is_typed_and_chained(monkeypatch, tmp_path, cause, breaks):
    """The engine's kernel load (what it runs at construction on the card)
    turns a failed build or load into the taxonomy's typed error."""
    monkeypatch.setattr(ops, "_LIBS", {})
    breaks(monkeypatch, tmp_path)
    with pytest.raises(PallasLoweringError) as ei:
        teng._load_kernels()
    assert isinstance(ei.value, BackendBuildError) and not ei.value.injected
    assert isinstance(ei.value.__cause__, cause)
    assert ops._LIBS == {}  # nothing half-loaded


def test_clean_build_clean_provenance():
    ref, port = _engines(C6, SPLIT6)
    assert port.provenance["degraded"] is False and ref.provenance["degraded"] is False
    assert "fallbacks" not in port.provenance
    assert port.provenance["backend"] == "cuda" and port.provenance["use_kernels"] is True
    # the suite runs with REPRO_CALIBRATION=off (conftest): the analytic model
    assert port.provenance["calibration"] == {"source": "disabled", "path": None}
    assert_states_close(port.run(), simulate_np(C6))
