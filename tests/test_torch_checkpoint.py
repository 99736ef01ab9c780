"""The offload backend's stage checkpoints (``engine_for(...,
checkpoint_dir=)``), its two fault sites and the run journal on the CPU,
held to the JAX package's (``tests/test_faults.py``: the kill-and-resume
tests and the journal's fsync).

Tolerances: states within atol 1e-5 of the oracle (complex64 through 80
gates); a resumed state equal to the uninterrupted run's bit for bit (the
same ops on the same saved bytes); counters equal to the reference's."""

import os
import time

import numpy as np
import pytest

from repro.core.generators import random_circuit
from repro.sim import faults as ref_faults
from repro.sim.engine import engine_for as ref_engine_for
from repro.sim.statevector import simulate_np
from repro.train.fault_tolerance import RunJournal as RefJournal
from repro.train.fault_tolerance import StragglerMonitor as RefMonitor
from repro_torch.core.circuit import Circuit as PCircuit
from repro_torch.launch.simulate import main as cli
from repro_torch.sim import faults
from repro_torch.sim.engine import OffloadBackend, circuit_key_for, engine_for
from repro_torch.sim.faults import FaultPlan, ShardTransferError
from repro_torch.sim.journal import RunJournal, StragglerMonitor

CIRC = random_circuit(9, 80, seed=7)
OTHER = random_circuit(9, 80, seed=8)
REF = simulate_np(CIRC).astype(np.complex64)
C8 = random_circuit(8, 40, seed=5)


def _port(c):
    return PCircuit.from_json(c.to_json())


def _kw(path):
    return dict(L=7, R=2, G=0, backend="offload", cache=None, checkpoint_dir=str(path),
                device="cpu")


def _batch_states(n, B, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((B, 1 << n)) + 1j * rng.standard_normal((B, 1 << n))
    return (z / np.linalg.norm(z, axis=1, keepdims=True)).astype(np.complex64)


def _kill(eng, run, after=5):
    """``run(eng)`` killed by one injected shard transfer error after
    ``after`` shard probes."""
    with faults.inject(FaultPlan(seed=1).add("shard_transfer_error", after=after, count=1)):
        with pytest.raises(ShardTransferError) as ei:
            run(eng)
    assert ei.value.injected


def test_offload_checkpoint_kill_and_resume(tmp_path):
    """Killed in stage 1, after the first checkpoint: a fresh engine resumes
    from the journal, its state equals the uninterrupted run's bit for bit
    and the oracle's, its counters equal the reference's on the same kill,
    and no checkpoint is left after success."""
    eng = engine_for(_port(CIRC), **_kw(tmp_path))
    _kill(eng, lambda e: e.run())
    assert eng.backend.stats["checkpointed_stages"] > 0
    assert os.path.exists(tmp_path / "journal.json") and os.path.exists(tmp_path / "state.npy")
    eng2 = engine_for(_port(CIRC), **_kw(tmp_path))
    out = eng2.run().numpy()
    assert eng2.backend.stats["resumed_stages"] > 0
    assert [t["kind"] for t in eng2.backend.trace][0] == "resume"
    np.testing.assert_allclose(out, REF, atol=1e-5)
    plain = engine_for(_port(CIRC), 7, 2, 0, backend="offload", cache=None, device="cpu")
    assert np.array_equal(out, plain.run().numpy())
    assert not os.path.exists(tmp_path / "journal.json")
    assert not os.path.exists(tmp_path / "state.npy")
    # the reference on the same plan and the same kill
    rdir = tmp_path / "ref"
    rkw = dict(L=7, R=2, G=0, backend="offload", cache=None,
               backend_kw={"checkpoint_dir": str(rdir)})
    with ref_faults.inject(ref_faults.FaultPlan(seed=1).add("shard_transfer_error", after=5,
                                                            count=1)):
        ref = ref_engine_for(CIRC, **rkw)
        with pytest.raises(ref_faults.ShardTransferError):
            ref.run()
    assert ref.backend.stats["checkpointed_stages"] == eng.backend.stats["checkpointed_stages"]
    ref2 = ref_engine_for(CIRC, **rkw)
    ref2.run()
    for k in ("checkpointed_stages", "resumed_stages", "shard_transfers", "stage_streams"):
        assert eng2.backend.stats[k] == ref2.backend.stats[k], k


def test_offload_checkpoint_ignores_other_runs_journal(tmp_path):
    _kill(engine_for(_port(CIRC), **_kw(tmp_path)), lambda e: e.run())
    eng = engine_for(_port(OTHER), **_kw(tmp_path))
    out = eng.run().numpy()
    assert eng.backend.stats["resumed_stages"] == 0
    np.testing.assert_allclose(out, simulate_np(OTHER).astype(np.complex64), atol=1e-5)


def test_offload_checkpoint_kill_and_resume_batched(tmp_path):
    """Batched [B, 2^n] runs checkpoint and resume like flat ones."""
    psi0s = _batch_states(9, 2)
    refs = [simulate_np(CIRC, psi0=psi0s[b]).astype(np.complex64) for b in range(2)]
    eng = engine_for(_port(CIRC), **_kw(tmp_path))
    _kill(eng, lambda e: e.run_batch(psi0s))
    assert eng.backend.stats["checkpointed_stages"] > 0
    assert os.path.exists(tmp_path / "journal.json")
    eng2 = engine_for(_port(CIRC), **_kw(tmp_path))
    outs = eng2.run_batch(psi0s).numpy()
    assert eng2.backend.stats["resumed_stages"] > 0
    for b in range(2):
        np.testing.assert_allclose(outs[b], refs[b], atol=1e-5)
    assert not os.path.exists(tmp_path / "journal.json")


def test_offload_checkpoint_batch_shape_is_run_identity(tmp_path):
    """A flat run never adopts a batched run's journal, and a batch of one
    never adopts a flat run's: the logical shape is part of the run's
    signature."""
    _kill(engine_for(_port(CIRC), **_kw(tmp_path)), lambda e: e.run_batch(_batch_states(9, 2)))
    assert os.path.exists(tmp_path / "journal.json")
    eng = engine_for(_port(CIRC), **_kw(tmp_path))
    out = eng.run().numpy()
    assert eng.backend.stats["resumed_stages"] == 0
    np.testing.assert_allclose(out, REF, atol=1e-5)
    psi0 = np.zeros((1, 1 << 9), dtype=np.complex64)
    psi0[0, 0] = 1
    _kill(engine_for(_port(CIRC), **_kw(tmp_path)), lambda e: e.run())
    eng = engine_for(_port(CIRC), **_kw(tmp_path))
    eng.run_batch(psi0)
    assert eng.backend.stats["resumed_stages"] == 0


def test_offload_checkpoint_ignores_another_binding(tmp_path):
    """The binding is part of the signature: a killed run at one binding
    is not resumed at another."""
    from test_params import _ansatz, _vals

    n = 7
    sym = _port(_ansatz(n))
    eng = engine_for(sym, 5, 2, 0, backend="offload", cache=None, device="cpu",
                     checkpoint_dir=str(tmp_path))
    eng.bind(dict(zip(sym.param_names, _vals(n, 1))))
    _kill(eng, lambda e: e.run(), after=3)
    eng.bind(dict(zip(sym.param_names, _vals(n, 2))))
    out = eng.run().numpy()
    assert eng.backend.stats["resumed_stages"] == 0
    np.testing.assert_allclose(out, simulate_np(_ansatz(n, _vals(n, 2))), atol=1e-5)


def test_run_journal_fsyncs_before_rename(tmp_path, monkeypatch):
    calls = []
    real_fsync = os.fsync
    monkeypatch.setattr(os, "fsync", lambda fd: (calls.append(fd), real_fsync(fd))[1])
    j = RunJournal(str(tmp_path / "journal.json"))
    j.update(3, run_sig="abc")
    assert len(calls) == 1
    assert j.read()["last_step"] == 3 and j.read()["run_sig"] == "abc"
    j.mark_restart()
    assert len(calls) == 2
    assert j.read()["restarts"] == 1
    rj = RefJournal(str(tmp_path / "ref.json"))
    rj.update(3, run_sig="abc")
    rj.mark_restart()
    assert rj.read() == j.read()


def test_save_state_fsyncs_before_rename(tmp_path, monkeypatch):
    """Each stage's snapshot is written to a temporary file, fsync'd, then
    renamed: one fsync per save and per journal update, and no temporary
    file is left."""
    events = []
    real_fsync, real_replace = os.fsync, os.replace
    monkeypatch.setattr(os, "fsync", lambda fd: (events.append("fsync"), real_fsync(fd))[1])
    monkeypatch.setattr(os, "replace", lambda a, b: (events.append(("replace", os.path.basename(b))),
                                                     real_replace(a, b))[1])
    eng = engine_for(_port(CIRC), **_kw(tmp_path))
    eng.run()
    stages = eng.backend.stats["checkpointed_stages"]
    assert stages == len(eng.cc.programs)
    saves = [i for i, e in enumerate(events) if e == ("replace", "state.npy")]
    assert len(saves) == stages and all(events[i - 1] == "fsync" for i in saves)
    assert events.count("fsync") == 2 * stages
    assert not os.listdir(tmp_path)


def test_straggler_monitor_matches_reference():
    rng = np.random.default_rng(4)
    times = list(rng.uniform(0.5, 1.0, 30))
    times[10] = times[20] = 5.0
    got, ref = StragglerMonitor(), RefMonitor()
    for i, dt in enumerate(times):
        assert got.record(i, dt) == ref.record(i, dt)
    assert got.flagged == ref.flagged == [10, 20]


def test_offload_shard_transfer_error_is_typed():
    with faults.inject(FaultPlan(seed=1).add("shard_transfer_error")):
        eng = engine_for(_port(C8), 5, 3, 0, backend="offload", cache=None, device="cpu")
        with pytest.raises(ShardTransferError) as ei:
            eng.run()
    assert ei.value.injected and "offload.shard0" in str(ei.value)


def test_offload_slow_stage_injects_latency():
    eng = engine_for(_port(C8), 5, 3, 0, backend="offload", cache=None, device="cpu")
    eng.run()  # warm
    t0 = time.perf_counter()
    base = eng.run().numpy()
    dt_clean = time.perf_counter() - t0
    plan = FaultPlan(seed=2).add("slow_stage", delay_s=0.15, site="offload.stage")
    with faults.inject(plan):
        t0 = time.perf_counter()
        out = eng.run().numpy()
        dt = time.perf_counter() - t0
    assert dt >= dt_clean + 0.1
    assert plan.stats()["fires"]["slow_stage"] == len(eng.cc.programs)
    np.testing.assert_allclose(out, base, atol=1e-6)


def test_checkpoint_dir_is_part_of_the_key(tmp_path):
    base = dict(L=7, R=2, G=0, backend="offload", device="cpu")
    keys = {circuit_key_for(_port(CIRC), checkpoint_dir=d, **base).digest
            for d in (None, str(tmp_path / "a"), str(tmp_path / "b"))}
    assert len(keys) == 3
    be = OffloadBackend(checkpoint_dir=str(tmp_path))
    assert be.storage is None and be.checkpoint_dir == str(tmp_path)


def test_cli_checkpoint_dir(capsys, tmp_path):
    run = cli(["--circuit", "qft", "--n", "9", "--L", "6", "--R", "3", "--executor", "offload",
               "--checkpoint-dir", str(tmp_path), "--check", "--device", "cpu"])
    out = capsys.readouterr().out
    assert round(run.fidelity, 6) == 1.0
    assert run.engine.backend.stats["checkpointed_stages"] == len(run.engine.cc.programs)
    assert "checkpoint after stage 0" in out
    assert not os.listdir(tmp_path)
    for extra in (["--executor", "cuda"], ["--executor", "offload", "--storage", "int8"]):
        with pytest.raises(SystemExit):
            cli(["--circuit", "qft", "--n", "8", "--L", "5", "--R", "3", "--checkpoint-dir",
                 str(tmp_path), "--device", "cpu"] + extra)
