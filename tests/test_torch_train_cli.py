"""The port's LM training entry point, ``repro_torch.launch.train``, on the
CPU: the reference test's learning criterion (``tests/test_train.py::
test_training_loss_decreases``) and its resume after a stop
(``::test_resume_after_simulated_failure``), which are red in the reference
(its mesh under jax 0.9); a crash injected mid-run whose resume ends bit
for bit where an uninterrupted run ends; the printed lines and
``--metrics-out``; the refusals."""

import json
import os
import re

import numpy as np
import pytest
import torch

from repro_torch.launch import train
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault_tolerance import RunJournal

SMALL = ["--arch", "qwen2-1.5b", "--reduced", "--global-batch", "4", "--seq", "32",
         "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The models here are tiny: one intra-op thread, so the suite's other
    workers, and the rank processes that other test files run under
    ``nice``, keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_training_loss_decreases(tmp_path):
    hist = train.main([
        "--arch", "qwen2-1.5b", "--reduced", "--steps", "120",
        "--global-batch", "8", "--seq", "64", "--lr", "2e-3",
        "--log-every", "10", "--metrics-out", str(tmp_path / "m.json"), "--device", "cpu",
    ])
    first = np.mean([h["loss"] for h in hist[:3]])
    last = np.mean([h["loss"] for h in hist[-3:]])
    assert last < first - 0.3, f"no learning: {first:.3f} -> {last:.3f}"
    doc = json.loads((tmp_path / "m.json").read_text())
    assert doc["history"] == hist and doc["tok_per_s"] > 0
    assert [h["step"] for h in hist] == list(range(0, 120, 10)) + [119]


def test_resume_after_simulated_failure(tmp_path, capsys):
    ck = str(tmp_path / "ckpt")
    train.main([*SMALL, "--steps", "20", "--ckpt-dir", ck, "--ckpt-every", "10",
                "--log-every", "10"])
    # "crash" happened; resume to 30
    train.main([*SMALL, "--steps", "30", "--ckpt-dir", ck, "--ckpt-every", "10",
                "--log-every", "10"])
    j = RunJournal(os.path.join(ck, "journal.json")).read()
    assert j["restarts"] == 1
    assert j["last_step"] == 30
    assert CheckpointManager(ck).all_steps() == [10, 20, 30]
    assert "[resume] from step 20 (restart #1)" in capsys.readouterr().out


class _Crash(RuntimeError):
    pass


def test_a_crash_mid_run_resumes_bit_for_bit(tmp_path, monkeypatch):
    """30 steps uninterrupted, against 30 steps killed when step 20's batch
    is drawn (the save of step 20 in flight) and resumed: the same final
    parameters, moments and step, bit for bit, and the same losses from
    step 20 on."""
    args = [*SMALL, "--steps", "30", "--ckpt-every", "10", "--log-every", "1", "--lr", "2e-3"]
    whole = train.run([*args, "--ckpt-dir", str(tmp_path / "whole")])

    managers = []

    class Recorded(CheckpointManager):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            managers.append(self)

    class Crashing(train.SyntheticDataset):
        def batch(self, step):
            if step == 20:
                raise _Crash(f"killed at step {step}")
            return super().batch(step)

    ck = str(tmp_path / "crashed")
    with monkeypatch.context() as m:
        m.setattr(train, "CheckpointManager", Recorded)
        m.setattr(train, "SyntheticDataset", Crashing)
        with pytest.raises(_Crash):
            train.run([*args, "--ckpt-dir", ck])
    for mgr in managers:
        mgr.wait()  # the save of step 20, still being written when the run died
    assert CheckpointManager(ck).all_steps() == [10, 20]
    resumed = train.run([*args, "--ckpt-dir", ck])
    assert resumed.start_step == 20
    assert RunJournal(os.path.join(ck, "journal.json")).read() == {"restarts": 1,
                                                                   "last_step": 30}
    assert [h["loss"] for h in resumed.history] == [h["loss"] for h in whole.history[20:]]
    got, want = dict(resumed.model.named_parameters()), dict(whole.model.named_parameters())
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
        torch.testing.assert_close(resumed.opt_state.m[k], whole.opt_state.m[k], rtol=0,
                                   atol=0, msg=k)
        torch.testing.assert_close(resumed.opt_state.v[k], whole.opt_state.v[k], rtol=0,
                                   atol=0, msg=k)
    assert int(resumed.opt_state.step) == int(whole.opt_state.step) == 30


def test_printed_lines_and_microbatches(capsys):
    hist = train.main([*SMALL, "--steps", "3", "--log-every", "2", "--microbatches", "2"])
    lines = capsys.readouterr().out.splitlines()
    step = r"step +\d+ loss +\d+\.\d{4} gnorm +\d+\.\d{3} lr \d\.\d{2}e[-+]\d\d +\d+ ms"
    assert [re.fullmatch(step, line) is not None for line in lines[:2]] == [True, True]
    assert re.fullmatch(r"done: 3 steps in \d+\.\ds \([\d,]+ tok/s\); stragglers flagged: "
                        r"\[\]", lines[2]), lines[2]
    assert [h["step"] for h in hist] == [0, 2] and all(np.isfinite(h["loss"]) for h in hist)


@pytest.mark.parametrize("flag", ["--model-par", "--data-par"])
def test_cli_refuses_parallelism_by_name(flag, capsys):
    """Outside torchrun, a mesh flag is refused before any process group,
    naming the flags and the launcher, for any arch
    (tests/test_torch_lm_sharding_cli.py runs the mesh under torchrun)."""
    other = [a if a != "qwen2-1.5b" else "mamba2-1.3b" for a in SMALL]
    with pytest.raises(SystemExit):
        train.main([*other, "--steps", "1", flag, "2"])
    err = capsys.readouterr().err
    assert "--data-par/--model-par above 1" in err and "start it with torchrun" in err
    assert "--arch mamba2-1.3b" in err


def test_cli_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", "qwen2-1.5b", "--reduced", "--steps", "1"])
