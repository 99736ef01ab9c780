"""The twins of ``examples/`` (``repro_torch.examples``) on the CPU, at the
reference's defaults where they are small and narrower where they are not:

* ``quickstart``: the reference example's stage lines, word for word, and
  a state within 1e-5 of ``repro.sim.executor.StagedExecutor`` on the same
  plan;
* ``simulate_qft`` at ``qft(12)``, L=9 on 8 spawned gloo ranks (one thread
  each, under ``nice``, in a subprocess): every path's fidelity > 0.9999,
  each backend's ``<obs>`` within 1e-4 and its marginal within 1e-5 of
  ``repro.sim.measure.expectation_np``/``marginal_np`` on
  ``repro.sim.statevector.simulate_np``; and in a group it is given (one
  gloo rank, R = G = 0);
* ``serve_lm`` at its own flags: ``OK`` and tokens of ``[4, 16]``;
* ``train_lm`` at a few steps and a narrow width: the loss falls and the
  checkpoint is written;
* each twin at its default device, CUDA, raises on a machine without it.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.generators import qft as r_qft
from repro.core.partition import partition as r_partition
from repro.sim.executor import StagedExecutor as RefStagedExecutor
from repro.sim.measure import expectation_np, marginal_np
from repro.sim.statevector import simulate_np
from repro_torch.configs import registry
from repro_torch.examples import quickstart, serve_lm, simulate_qft, train_lm
from repro_torch.train.checkpoint import CheckpointManager

ROOT = Path(__file__).resolve().parents[1]
QFT = {"n": 12, "L": 9}
SPAWN_TIMEOUT_S = 240


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reference_example(name: str) -> str:
    """The reference example's stdout (its ``main`` in this process)."""
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        mod = __import__(name)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main()
        return buf.getvalue()
    finally:
        sys.path.remove(str(ROOT / "examples"))


def test_quickstart_prints_the_references_stages_and_state():
    ref_out = _reference_example("quickstart")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = quickstart.main(["--device", "cpu"])
    out = buf.getvalue().splitlines()
    want = ref_out.splitlines()
    # every line up to the fidelity's, word for word
    head = [line for line in want if line.startswith(("qft(", "staging:", "  stage", "modeled"))]
    assert out[:len(head)] == head and len(head) >= 4
    assert out[-1] == "OK" and want[-1] == "OK"
    assert got["fidelity"] > 0.9999
    assert got["launches"]["fused"] + got["launches"]["shm"] > 0
    c = r_qft(12)
    ref_state = np.asarray(RefStagedExecutor(c, r_partition(c, L=9, R=2, G=1)).run())
    assert np.abs(got["state"].numpy() - ref_state).max() < 1e-5


def _figures_against_numpy(out: dict, n: int) -> None:
    psi = simulate_np(r_qft(n))
    e_ref = expectation_np(psi, simulate_qft.OBS)
    m_ref = marginal_np(psi, simulate_qft.MARGINAL)
    for name, f in out["fidelities"].items():
        assert f > 0.9999, name
    for backend, m in out["measured"].items():
        assert abs(m["expectation"] - e_ref) < 1e-4, backend
        assert np.abs(np.asarray(m["marginal"]) - m_ref).max() < 1e-5, backend


def test_simulate_qft_on_eight_spawned_ranks():
    code = ("import json, sys; from repro_torch.examples import simulate_qft as s; "
            "out = s.run(n={n}, L={L}, device='cpu', timeout=200); "
            "print('FIGURES ' + json.dumps(out))".format(**QFT))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(["nice", "-n", "10", sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.splitlines()
    out = json.loads(next(line for line in lines if line.startswith("FIGURES "))[8:])
    assert set(out["fidelities"]) == {"cuda", "shardmap", "shardmap+kernels", "offloaded"}
    assert set(out["measured"]) == {"shardmap", "cuda", "offload"}
    _figures_against_numpy(out, QFT["n"])
    # both kernels' plain versions ran: shm groups on every path, a fused
    # op on the offload plan
    assert out["launches"]["shm"] > 0 and out["launches"]["fused"] > 0
    assert out["rank"] == 0 and out["launch_s"] > 0
    assert any(line.startswith("  fidelity[shardmap+kernels] = ") for line in lines)
    assert any(line.startswith("launch: 8 ranks joined their group") for line in lines)


def test_simulate_qft_in_a_group_it_is_given(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                            world_size=1)
    try:
        out = simulate_qft.run(n=8, L=8, R=0, G=0, shots=64, device="cpu")
        assert dist.is_initialized()  # the caller's group is left as it was
    finally:
        dist.destroy_process_group()
    assert out["rank"] == 0 and out["launch_s"] is None
    _figures_against_numpy(out, 8)


def test_serve_lm_ends_with_ok(capsys):
    tokens = serve_lm.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.splitlines()[-1] == "OK"
    assert tuple(tokens.shape) == (4, 16) and tokens.dtype == torch.int32
    assert "kernel launches: " in out and "decode: 4x15 tokens" in out


def test_train_lm_lowers_the_loss_and_checkpoints(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    try:
        out = train_lm.run(steps=10, d_model=64, layers=2, device="cpu", global_batch=4, seq=32,
                           log_every=1, ckpt_dir=ckpt)
    finally:
        registry.ARCHS.pop("qwen2-100m", None)
    assert out["last"] < out["first"] and len(out["history"]) == 10
    assert CheckpointManager(ckpt).latest_step() == 10


@pytest.mark.parametrize("name", ["quickstart", "simulate_qft", "serve_lm", "train_lm"])
def test_without_cuda_each_twin_raises_by_default(name, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device would be used")
    mod = {"quickstart": quickstart, "simulate_qft": simulate_qft, "serve_lm": serve_lm,
           "train_lm": train_lm}[name]
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.main([])
    finally:
        registry.ARCHS.pop("qwen2-100m", None)
    assert "OK" not in capsys.readouterr().out.splitlines()
