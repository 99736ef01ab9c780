"""The LM entry points on a mesh: ``repro_torch.launch.serve_llm`` and
``repro_torch.launch.train`` with ``--data-par``/``--model-par`` under real
``torchrun`` launches of 4 CPU ranks (gloo, under ``nice``), against the
same CLI on one rank: the served tokens equal, the training history within
bf16's bound (the reduced configs compute in bf16, where the mesh's
partial sums round otherwise: ``tests/test_torch_lm_bf16.py``'s 2e-2); only
rank 0 prints and writes; and the refusals: a world of another size (on
every rank), NCCL on the CPU, no launcher and ``--dist-backend`` without
a mesh."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch import serve_llm, train

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
TIMEOUT = 300  # each torchrun launch
NICE = ["nice", "-n", "10"]  # leave the suite's other workers their cores
SERVE = ["--arch", "qwen2-1.5b", "--reduced", "--batch", "4", "--prompt-len", "8",
         "--gen-len", "6", "--device", "cpu"]
TRAIN = ["--arch", "qwen2-1.5b", "--reduced", "--steps", "4", "--global-batch", "4",
         "--seq", "16", "--lr", "2e-3", "--log-every", "1", "--device", "cpu"]
BF16_RTOL = 2e-2


def _torchrun(nproc: int, module: str, *argv: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    return subprocess.run(
        NICE + [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", str(nproc), "-m", module, *argv],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=TIMEOUT)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _generations(stdout: str):
    lines = stdout.splitlines()
    i = lines.index("sample generations (token ids):")
    return [json.loads(line.strip()) for line in lines[i + 1:i + 4]]


def test_serve_llm_on_2x2_serves_the_one_rank_tokens(capsys):
    one = serve_llm.main(SERVE)
    one_out = capsys.readouterr().out
    proc = _torchrun(4, "repro_torch.launch.serve_llm", *SERVE, "--data-par", "2",
                     "--model-par", "2")
    assert proc.returncode == 0, proc.stderr[-3000:]
    # rank 0 alone prints: one copy of each line
    assert proc.stdout.count("prefill: 4x8 tokens") == 1
    assert proc.stdout.count("mesh: data 2 x model 2 on 4 ranks (gloo)") == 1
    assert _generations(proc.stdout) == _generations(one_out) == one[:3, :16].tolist()


def test_train_on_2x2_follows_the_one_rank_history(tmp_path):
    one = train.main(TRAIN)
    ck, metrics = tmp_path / "ckpt", tmp_path / "metrics.json"
    # --data-par 0: the world (4) over --model-par 2
    proc = _torchrun(4, "repro_torch.launch.train", *TRAIN, "--model-par", "2",
                     "--ckpt-dir", str(ck), "--ckpt-every", "2", "--metrics-out", str(metrics))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("mesh: data 2 x model 2 on 4 ranks (gloo)") == 1
    assert len(re.findall(r"^step +3 loss", proc.stdout, re.M)) == 1
    hist = json.loads(metrics.read_text())["history"]
    assert [h["step"] for h in hist] == [h["step"] for h in one] == [0, 1, 2, 3]
    np.testing.assert_allclose([h["loss"] for h in hist], [h["loss"] for h in one],
                               rtol=BF16_RTOL)
    # rank 0 wrote the checkpoints (the one-device format) and the journal
    assert sorted(os.listdir(ck)) == ["journal.json", "step_00000002", "step_00000004"]
    assert json.loads((ck / "journal.json").read_text())["last_step"] == 4


def test_a_world_of_another_size_is_refused_on_every_rank():
    proc = _torchrun(2, "repro_torch.launch.serve_llm", *SERVE, "--data-par", "2",
                     "--model-par", "2")
    assert proc.returncode != 0
    msg = "--data-par 2 --model-par 2 is a mesh of 4 ranks, and the job has 2"
    assert proc.stderr.count(msg) == 2, proc.stderr[-3000:]


@pytest.mark.parametrize("cli,argv", [(serve_llm, SERVE), (train, TRAIN)])
def test_refusals_before_any_rank_starts(cli, argv, capsys):
    with pytest.raises(SystemExit):
        cli.main([*argv, "--data-par", "2", "--dist-backend", "nccl"])
    assert "NCCL moves CUDA tensors only" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli.main([*argv, "--model-par", "2"])
    assert "start it with torchrun" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli.main([*argv, "--dist-backend", "gloo"])
    assert "--dist-backend needs" in capsys.readouterr().err
