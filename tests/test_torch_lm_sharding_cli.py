"""The LM entry points on a mesh: ``repro_torch.launch.serve_llm`` and
``repro_torch.launch.train`` with ``--data-par``/``--model-par`` under real
``torchrun`` launches of 4 CPU ranks (gloo, under ``nice``), against the
same CLI on one rank: every served token a greedy choice of the one-rank
model within bf16's bound (the one token wherever one alone lies within
it), the training history within that bound
(the reduced configs compute in bf16, where the mesh's tensor-parallel
partial sums round otherwise: ``tests/test_torch_lm_bf16.py``'s 2e-2);
only rank 0 prints and writes; and the refusals: a world of another size
(on every rank), NCCL on the CPU, no launcher and ``--dist-backend``
without a mesh."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.launch import serve_llm, train
from repro_torch.launch.steps import build_model

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


def _one_rank_logits(tokens: torch.Tensor) -> torch.Tensor:
    """The one-rank CLI's model and prompts, teacher-forced with ``tokens``
    ([B, G]): the float32 logits [B, G, V] of each greedy decision, the
    one that chose ``tokens[:, i]`` after the prompts and ``tokens[:, :i]``."""
    cfg = get_arch("qwen2-1.5b").reduced()
    model = build_model(cfg, "cpu", torch.Generator().manual_seed(0), remat=False)
    prompts = torch.randint(0, cfg.vocab_size, (4, 8), generator=torch.Generator().manual_seed(0),
                            dtype=torch.int32)
    params = model.cast_params()
    logits, cache = model.prefill(prompts, cache_len=8 + tokens.shape[1], params=params)
    steps = []
    for i in range(tokens.shape[1]):
        steps.append(logits.float())
        if i + 1 < tokens.shape[1]:
            logits, cache = model.decode_step(tokens[:, i:i + 1], cache, params=params)
    return torch.stack(steps, 1)


def test_serve_llm_on_2x2_serves_the_one_rank_tokens(capsys):
    """Every token the mesh serves is a greedy choice of the one-rank model
    fed the mesh's own tokens: its logit lies within bf16's bound of that
    decision's largest. Where one token alone lies there, the mesh must
    serve it; only where the one-rank model's two best lie within bf16
    rounding of each other may the mesh's partial sums, rounded in another
    order, pick the other (the generations part after it)."""
    one = serve_llm.main(SERVE)
    one_out = capsys.readouterr().out
    proc = _torchrun(4, "repro_torch.launch.serve_llm", *SERVE, "--data-par", "2",
                     "--model-par", "2")
    assert proc.returncode == 0, proc.stderr[-3000:]
    # rank 0 alone prints: one copy of each line
    assert proc.stdout.count("prefill: 4x8 tokens") == 1
    assert proc.stdout.count("mesh: data 2 x model 2 on 4 ranks (gloo)") == 1
    assert _generations(one_out) == one[:3, :16].tolist()
    mesh = one.clone()  # rows 3.. are not printed: they stand in at the one rank's
    mesh[:3] = torch.tensor(_generations(proc.stdout), dtype=mesh.dtype)
    logits = _one_rank_logits(mesh)[:3]
    best = logits.max(-1).values
    chosen = logits.gather(-1, mesh[:3, :, None].long())[..., 0]
    gap = ((best - chosen) / best.abs()).numpy()
    assert (gap <= BF16_RTOL).all(), (mesh[:3].tolist(), one[:3].tolist(), gap)
    # the check binds: most decisions admit one token alone
    admitted = (logits >= best[..., None] - BF16_RTOL * best.abs()[..., None]).sum(-1)
    assert (admitted == 1).float().mean() >= 0.5, admitted.tolist()


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
