"""The port's profiler, calibration files and plan autotuner on the CPU,
against the JAX package's (``tests/test_autotune.py``).

The same measurements and cost models go through ``repro`` and
``repro_torch``: ``CostModel.from_calibration``, ``default_candidates`` and
``partition`` under a calibrated model must give the reference's models,
candidate lists and plans. Calibration files: the port writes the
reference's schema under a file name of its own, resolves every ``source``
the reference does, and takes a file the JAX package wrote as a
``mismatch``. Each test pins the calibration directory (the suite's
``REPRO_CALIBRATION=off`` is lifted here, as in the reference's tests).

Tolerances: states within ``atol=1e-5`` of ``simulate_np`` (complex64
through a few dozen gates, ``assert_states_close``); models, candidate lists
and plans equal.
"""

import json
import math
import re

import pytest

from conftest import assert_states_close
from repro.core import autotune as rautotune, cost_model as rcm
from repro.core.generators import ising as ref_ising, qft as ref_qft, su2random as ref_su2random
from repro.core.partition import partition as ref_partition
from repro.sim import profiler as rprofiler
from repro.sim.statevector import simulate_np
from repro_torch.core import autotune, kernelization, staging
from repro_torch.core.autotune import (
    PlanCandidate, autotune_engine, clear_tuned, default_candidates, tuned_outcomes,
)
from repro_torch.core.circuit import Circuit as PCircuit
from repro_torch.core.cost_model import CostModel, DEFAULT_COST_MODEL
from repro_torch.core.generators import PARAM_FAMILIES, qft, su2random
from repro_torch.core.partition import partition
from repro_torch.launch.simulate import main as cli
from repro_torch.sim import profiler
from repro_torch.sim.engine import CompileCache, circuit_key_for, engine_for

MEASURED = {
    "pass_us": 1234.5,
    "mxu_us_per_2k": 17.25,
    "launch_us": 4.0,
    "shm_gate_us": 150.0,
    "shm_diag_gate_us": 60.0,
    "host_link_gbps": 12.5,
    "comm_weight": 2.0,
}
# an H100-like calibration: a fast memory pass, a dear fusion slope
CARD_LIKE = {"pass_us": 1400.0, "mxu_us_per_2k": 185.0, "launch_us": 12.0,
             "shm_gate_us": 90.0, "shm_diag_gate_us": 30.0, "host_link_gbps": 55.0,
             "disk_gbps": 0.6}
MEASUREMENT_SETS = [MEASURED, CARD_LIKE, {"shm_gate_us": 0.0, "pass_us": float("nan")},
                    {"max_fusion_qubits": 5.0, "io_qubits": 2.0}]


def _port(c):
    return PCircuit.from_json(c.to_json())


def _calib(fingerprint=None, measurements=MEASURED, version=profiler.CALIBRATION_VERSION):
    return {
        "version": version,
        "fingerprint": fingerprint or profiler.device_fingerprint(device="cpu"),
        "measurements": dict(measurements),
        "cost_model": CostModel.from_calibration(measurements).to_dict(),
        "meta": {"fast": True},
    }


def _solves():
    return (staging.SOLVER_CALLS["ilp"], staging.SOLVER_CALLS["greedy"],
            kernelization.SOLVER_CALLS["dp"])


@pytest.fixture(autouse=True)
def _clean_resolution(monkeypatch, tmp_path):
    """Pin resolution to an empty calibration directory unless a test opts
    in, and leave no memoized state behind."""
    monkeypatch.delenv("REPRO_CALIBRATION", raising=False)
    monkeypatch.setenv("REPRO_CALIBRATION_DIR", str(tmp_path / "calib"))
    for mod in (profiler, rprofiler):
        mod.clear_resolved_cache()
    clear_tuned()
    yield
    for mod in (profiler, rprofiler):
        mod.clear_resolved_cache()
    clear_tuned()


# ======================================================================
# against the reference: models, candidates, plans
# ======================================================================


@pytest.mark.parametrize("measurements", MEASUREMENT_SETS)
def test_from_calibration_is_the_references(measurements):
    got = CostModel.from_calibration(measurements).to_dict()
    want = rcm.CostModel.from_calibration(measurements).to_dict()
    assert got == want


@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("R,G", [(0, 0), (2, 0), (1, 1)])
def test_default_candidates_are_the_references(calibrated, R, G):
    base = CostModel.from_calibration(CARD_LIKE) if calibrated else DEFAULT_COST_MODEL
    rbase = rcm.CostModel.from_calibration(CARD_LIKE) if calibrated else rcm.DEFAULT_COST_MODEL
    got = [c.describe() for c in default_candidates(base, R=R, G=G)]
    want = [c.describe() for c in rautotune.default_candidates(rbase, R=R, G=G)]
    assert got == want and got[0]["name"] == "default"
    assert ("analytic" in [c["name"] for c in got]) == calibrated


def _structural(plan):
    d = json.loads(plan.to_json())
    d.pop("preprocess_time_s")  # wall time, not plan content
    return d


@pytest.mark.parametrize("make,L,R", [(ref_qft, 6, 2), (ref_su2random, 6, 2), (ref_ising, 7, 2)])
@pytest.mark.parametrize("measurements", [MEASURED, CARD_LIKE])
def test_partition_under_a_calibration_is_the_references(make, L, R, measurements):
    circ = make(L + R)
    got = partition(_port(circ), L, R, 0, cost_model=CostModel.from_calibration(measurements))
    want = ref_partition(circ, L, R, 0,
                         cost_model=rcm.CostModel.from_calibration(measurements))
    assert _structural(got) == _structural(want)


# ======================================================================
# profiles and calibration files
# ======================================================================


def test_fast_profile_has_the_references_schema_and_feeds_a_model():
    calib = profiler.run_profile(fast=True, L=6, repeats=1, device="cpu")
    ref = rprofiler.run_profile(fast=True, L=6, repeats=1)
    assert set(calib) == set(ref)
    assert set(calib["measurements"]) == set(ref["measurements"])
    assert set(calib["meta"]) == set(ref["meta"]) and set(calib["meta"]["raw"]) == \
        set(ref["meta"]["raw"])
    for sec in ref["meta"]["raw"]:
        assert set(calib["meta"]["raw"][sec]) == set(ref["meta"]["raw"][sec]), sec
    assert set(calib["fingerprint"]) == {"platform", "device_kind", "device_count", "dtype",
                                         "torch_version", "cuda_version"}
    assert calib["fingerprint"]["platform"] == "cpu" and calib["version"] == 2
    for v in calib["measurements"].values():
        assert v > 0 and math.isfinite(v)
    assert set(calib["meta"]["raw"]["fusion"]["per_k_us"]) == {str(k) for k in range(1, 6)}
    cm = CostModel.from_calibration(calib["measurements"])
    assert cm.best_fusion_size() >= 1
    assert partition(qft(6), 4, 2, 0, cost_model=cm).n_stages >= 1


def test_profile_launches_both_kernel_wrappers():
    from repro_torch.kernels import ops

    ops.reset_kernel_counters()
    profiler.profile_fusion(6, repeats=1, device="cpu")
    profiler.profile_shm(6, repeats=1, device="cpu")
    calls = ops.kernel_call_counts()
    assert calls["fused"] == 5 * 2 and calls["shm"] == 4 * 2  # warm-up + one timed each
    assert ops.fused_call_counts_by_k() == {k: 2 for k in range(1, 6)}


def test_shard_bits_default_to_the_reference_shard_on_cuda_only():
    assert profiler.default_shard_bits(True, "cpu") == 8
    assert profiler.default_shard_bits(False, "cpu") == 14
    assert profiler.REFERENCE_L == rprofiler.REFERENCE_L == 28


def test_save_load_resolve_calibrated(tmp_path):
    path = str(tmp_path / "c.json")
    calib = _calib()
    profiler.save_calibration(path, calib)
    assert profiler.load_calibration(path) == calib
    cm, info = profiler.resolve_calibration(path, refresh=True, device="cpu")
    assert info["source"] == "calibrated" and cm == CostModel.from_calibration(MEASURED)


def test_resolve_every_other_source(tmp_path, monkeypatch):
    other = dict(profiler.device_fingerprint(device="cpu"), device_kind="TPU v5e",
                 platform="tpu")
    cases = {
        "mismatch": _calib(fingerprint=other),
        "version_mismatch": _calib(version=1),
    }
    for source, calib in cases.items():
        path = str(tmp_path / f"{source}.json")
        profiler.save_calibration(path, calib)
        cm, info = profiler.resolve_calibration(path, refresh=True, device="cpu")
        assert (info["source"], cm) == (source, DEFAULT_COST_MODEL)
    assert profiler.resolve_calibration(str(tmp_path / "none.json"), device="cpu")[1][
        "source"] == "analytic"
    (tmp_path / "bad.json").write_text("{not json")
    cm, info = profiler.resolve_calibration(str(tmp_path / "bad.json"), device="cpu")
    assert info["source"] == "error" and cm == DEFAULT_COST_MODEL
    monkeypatch.setenv("REPRO_CALIBRATION", "off")
    assert profiler.resolve_calibration() == (DEFAULT_COST_MODEL,
                                              {"source": "disabled", "path": None})


def test_a_file_the_reference_wrote_is_a_mismatch(tmp_path):
    path = str(tmp_path / "calibration.json")
    rcal = {"version": rprofiler.CALIBRATION_VERSION,
            "fingerprint": rprofiler.device_fingerprint(),
            "measurements": dict(MEASURED), "meta": {}}
    rprofiler.save_calibration(path, rcal)
    assert rprofiler.resolve_calibration(path, refresh=True)[1]["source"] == "calibrated"
    cm, info = profiler.resolve_calibration(path, refresh=True, device="cpu")
    assert info["source"] == "mismatch" and cm == DEFAULT_COST_MODEL


def test_the_port_never_reads_or_writes_the_references_default_file(tmp_path):
    assert profiler.default_calibration_dir() == rprofiler.default_calibration_dir()
    assert profiler.default_calibration_path() != rprofiler.default_calibration_path()
    # even a port calibration at the reference's default path is not the port's
    profiler.save_calibration(rprofiler.default_calibration_path(), _calib())
    assert profiler.resolve_calibration(device="cpu")[1]["source"] == "analytic"
    assert profiler.main(["--fast", "--L", "6", "--repeats", "1", "--device", "cpu"]) == 0
    assert json.load(open(rprofiler.default_calibration_path()))["fingerprint"][
        "platform"] == "cpu"  # untouched: still the file written above
    assert profiler.resolve_calibration(device="cpu")[1]["source"] == "calibrated"


def test_resolution_is_memoized_per_device(tmp_path, monkeypatch):
    path = str(tmp_path / "c.json")
    profiler.save_calibration(path, _calib())
    monkeypatch.setenv("REPRO_CALIBRATION", path)
    first = profiler.resolve_cost_model(device="cpu")
    profiler.save_calibration(path, _calib(measurements={**MEASURED, "pass_us": 9999.0}))
    assert profiler.resolve_cost_model(device="cpu") == first
    profiler.clear_resolved_cache()
    assert profiler.resolve_cost_model(device="cpu") != first


def test_cli_writes_and_verifies(tmp_path, capsys):
    out = str(tmp_path / "cal.json")
    assert profiler.main(["--fast", "--L", "6", "--repeats", "1", "--device", "cpu",
                          "--out", out, "--verify"]) == 0
    text = capsys.readouterr().out
    assert f"calibration -> {out}" in text and "verify: OK" in text
    assert profiler.load_calibration(out)["meta"]["L"] == 6


# ======================================================================
# the engine side: calibrated planning, keys, observations, timings
# ======================================================================


def test_calibration_auto_loads_into_engine_for(tmp_path, monkeypatch):
    path = str(tmp_path / "c.json")
    profiler.save_calibration(path, _calib(measurements=CARD_LIKE))
    monkeypatch.setenv("REPRO_CALIBRATION", path)
    circ = _port(ref_qft(8))
    eng = engine_for(circ, 6, 2, 0, cache=None, device="cpu")
    assert eng.provenance["calibration"]["source"] == "calibrated"
    want = partition(circ, 6, 2, 0, cost_model=CostModel.from_calibration(CARD_LIKE))
    assert _structural(eng.plan) == _structural(want)
    assert circuit_key_for(circ, 6, 2, 0, device="cpu") != circuit_key_for(
        circ, 6, 2, 0, device="cpu", cost_model=DEFAULT_COST_MODEL)
    assert_states_close(eng.run(), simulate_np(ref_qft(8)))


def test_no_calibration_leaves_plans_and_keys_unchanged():
    circ = _port(ref_su2random(8))
    assert circuit_key_for(circ, 6, 2, 0, device="cpu") == circuit_key_for(
        circ, 6, 2, 0, device="cpu", cost_model=DEFAULT_COST_MODEL)
    eng = engine_for(circ, 6, 2, 0, cache=None, device="cpu")
    assert eng.provenance["calibration"]["source"] == "analytic"
    assert _structural(eng.plan) == _structural(partition(circ, 6, 2, 0))


def test_observation_ring():
    profiler.clear_observations()
    eng = engine_for(qft(6), 4, 2, 0, cache=None, device="cpu")
    eng.run()
    eng.run_packed()
    summary = profiler.observation_summary()
    assert summary["run"]["count"] == 1 and summary["run_packed"]["count"] == 1
    assert summary["run"]["mean_us"] > 0
    ob = profiler.OBSERVATIONS[-1]
    assert ob == dict(ob, kind="run_packed", backend="cuda", n=6, L=4,
                      n_stages=len(eng.cc.programs))


def test_offload_timings_count_every_stage():
    eng = engine_for(qft(6), 4, 2, 0, backend="offload", cache=None, device="cpu")
    eng.run()
    snap = eng.timing_snapshot()
    assert snap["run"]["count"] == 1
    assert snap["offload_stage"]["count"] == eng.plan.n_stages
    assert profiler.observation_summary()["offload_stage"]["count"] >= eng.plan.n_stages


# ======================================================================
# the autotuner
# ======================================================================


def test_candidates_default_first_and_unique():
    cands = default_candidates(R=2, G=0, device="cpu")
    names = [c.name for c in cands]
    assert names[0] == "default" and len(names) == len(set(names))
    assert not any(c.name.startswith("comm_weight")
                   for c in default_candidates(R=0, G=0, device="cpu"))


def test_winner_cached_with_no_solver_call():
    circ = su2random(8)
    cache = CompileCache(maxsize=8)
    res = autotune_engine(circ, 6, 2, 0, repeats=2, cache=cache, device="cpu")
    assert res.chosen in res.replay_us and len(res.replay_us) == len(res.candidates)
    s0 = _solves()
    eng = engine_for(circ, 6, 2, 0, cache=cache, device="cpu")
    assert _solves() == s0, "a tuned hit must not solve staging or kernelization"
    assert eng is res.engine
    assert_states_close(eng.run(), simulate_np(circ))
    assert eng.provenance["autotune"]["chosen"] == res.chosen


def test_memoized_retune_is_free():
    circ = qft(7)
    cache = CompileCache(maxsize=8)
    cands = [PlanCandidate("default", DEFAULT_COST_MODEL),
             PlanCandidate("greedy", DEFAULT_COST_MODEL, kernelize_method="greedy")]
    autotune_engine(circ, 5, 2, 0, candidates=cands, repeats=1, cache=cache, device="cpu")
    s0 = _solves()
    res2 = autotune_engine(circ, 5, 2, 0, candidates=cands, repeats=1, cache=cache,
                           device="cpu")
    assert res2.cached and res2.engine is not None
    assert _solves() == s0, "a memoized retune must not plan anything"
    assert len(tuned_outcomes()) == 1 and tuned_outcomes()[0]["cached"] is False


def test_hysteresis_keeps_default_on_marginal_win():
    res = autotune_engine(
        qft(7), 5, 2, 0, cache=CompileCache(maxsize=8), repeats=2, device="cpu",
        candidates=[PlanCandidate("default", DEFAULT_COST_MODEL),
                    PlanCandidate("same", DEFAULT_COST_MODEL.with_overrides(launch_us=10.001))],
        min_speedup=1e9)  # nothing can clear this bar
    assert res.chosen == "default"


def test_symbolic_circuit_tunable():
    sym = PARAM_FAMILIES["su2param"](8)
    cache = CompileCache(maxsize=8)
    res = autotune_engine(sym, 6, 2, 0, repeats=1, cache=cache, device="cpu",
                          candidates=default_candidates(R=2, G=0, device="cpu")[:2])
    theta = {n: 0.3 for n in sym.param_names}
    eng = engine_for(sym.bind(theta), 6, 2, 0, cache=cache, device="cpu")
    assert eng is res.engine  # a structural hit rebinds the tuned engine
    assert_states_close(eng.run(), simulate_np(sym.bind(theta)))


def test_empty_candidates_raise():
    with pytest.raises(ValueError, match="empty candidate list"):
        autotune_engine(qft(6), 4, 2, 0, candidates=[], device="cpu")


def test_cli_autotune_prints_the_references_line(capsys):
    run = cli(["--circuit", "qft", "--n", "8", "--L", "6", "--R", "2", "--autotune", "--check",
               "--device", "cpu"])
    out = capsys.readouterr().out
    m = re.search(r"^autotune: chose '([^']+)' \(([0-9.]+)x vs default, (\d+) candidates, "
                  r"([0-9.]+)s\)$", out, re.M)
    assert m and int(m.group(3)) == len(default_candidates(R=2, device="cpu"))
    assert run.engine.provenance["autotune"]["chosen"] == m.group(1)
    assert "fidelity vs dense reference: 1.000000" in out
    assert autotune.TUNED
