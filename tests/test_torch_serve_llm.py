"""The port's LM serving entry point, ``repro_torch.launch.serve_llm``, and
its steps (``repro_torch.launch.steps``) on the CPU: the CLI for every
arch, its printed lines against the reference CLI's, its refusals, and the
greedy serving loop against the reference's steps on the same weights."""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import configs, extras_for, np32, port_model, ref_params
from repro.launch import serve_llm as r_serve_llm
from repro.launch import steps as r_steps
from repro.models.transformer import Model as RefModel
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import serve_llm, steps

ROOT = Path(__file__).resolve().parents[1]
LINES = [r"prefill: 2x8 tokens in \d+\.\d{3}s \([\d,]+ tok/s\)",
         r"decode: 2x3 tokens in \d+\.\d{3}s \([\d,]+ tok/s\)",
         r"sample generations \(token ids\):",
         r"   \[\d+(, \d+){3}\]",
         r"   \[\d+(, \d+){3}\]"]
ARGS = ["--reduced", "--batch", "2", "--prompt-len", "8", "--gen-len", "4", "--seed", "3"]


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_cli_serves_every_arch_reduced_on_the_cpu(name, capsys):
    tokens = serve_llm.main(["--arch", name, *ARGS, "--device", "cpu"])
    assert tokens.shape == (2, 4) and tokens.dtype == torch.int32
    assert int(tokens.min()) >= 0 and int(tokens.max()) < ARCHS[name].reduced().padded_vocab
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(LINES)
    for pattern, line in zip(LINES, lines):
        assert re.fullmatch(pattern, line), line


def test_cli_prints_what_the_reference_cli_prints(capsys, monkeypatch):
    # the reference's host mesh has Explicit axes under jax 0.9, which its
    # Model._wsc rejects (the fault of the meshed pjit path); its CLI runs
    # meshless, as the port's does
    monkeypatch.setattr(r_serve_llm, "make_host_mesh", lambda **kw: None)
    ref = r_serve_llm.main(["--arch", "whisper-base", *ARGS])
    ref_lines = capsys.readouterr().out.splitlines()
    got = serve_llm.main(["--arch", "whisper-base", *ARGS, "--device", "cpu"])
    got_lines = capsys.readouterr().out.splitlines()
    assert tuple(ref.shape) == tuple(got.shape)
    assert [re.sub(r"[\d.,]+", "#", s) for s in ref_lines] == \
        [re.sub(r"[\d.,]+", "#", s) for s in got_lines]


def test_cli_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_llm.main(["--arch", "qwen2-1.5b", "--reduced"])


@pytest.mark.parametrize("flag", ["--model-par", "--data-par"])
def test_cli_refuses_parallelism_by_name(flag, capsys):
    """Outside torchrun, a mesh flag is refused before any process group,
    naming the flags and the launcher, for any arch
    (tests/test_torch_lm_sharding_cli.py runs the mesh under torchrun)."""
    with pytest.raises(SystemExit):
        serve_llm.main(["--arch", "mamba2-1.3b", "--reduced", flag, "2", "--device", "cpu"])
    err = capsys.readouterr().err
    assert "--data-par/--model-par above 1" in err and "start it with torchrun" in err
    assert "--arch mamba2-1.3b" in err


@pytest.mark.parametrize("name", ["qwen2-1.5b", "whisper-base", "mamba2-1.3b",
                                  "deepseek-v2-lite-16b"])
def test_greedy_serving_steps_match_the_references(name):
    """float32, the reference's weights: ``make_prefill_step`` then seven
    ``make_decode_step`` steps give the reference's tokens, one by one."""
    ref_cfg, cfg = configs(name, "float32")
    params = ref_params(ref_cfg)
    ref, port = RefModel(ref_cfg, remat=False), port_model(cfg, params)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    ex_ref, ex_port = extras_for(cfg, rng, 2)
    ref_logits, ref_cache = jax.jit(r_steps.make_prefill_step(ref))(
        params, {"tokens": jnp.asarray(toks), **(ex_ref or {})})
    logits, cache = steps.make_prefill_step(port)(
        port.cast_params(), {"tokens": torch.from_numpy(toks), **(ex_port or {})})
    # float32 through a few layers, summed in other orders: 1e-4 of the
    # largest logit, as tests/test_torch_lm_models.py holds every arch
    np.testing.assert_allclose(np32(logits), np32(ref_logits), rtol=0,
                               atol=1e-4 * float(np.abs(np32(ref_logits)).max()))
    # the prefill step's cache holds the prompt alone: decode into a longer one
    ref_cache = jax.jit(lambda p, t: ref.prefill(p, t, extras=ex_ref, cache_len=16))(
        params, jnp.asarray(toks))[1]
    cache = port.prefill(torch.from_numpy(toks), extras=ex_port, cache_len=16)[1]
    ref_step = jax.jit(r_steps.make_decode_step(ref))
    step = steps.make_decode_step(port)
    ref_tok = jnp.argmax(ref_logits, -1).astype(jnp.int32)[:, None]
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    params_c = port.cast_params()
    for _ in range(7):
        np.testing.assert_array_equal(np.asarray(ref_tok), tok.numpy())
        ref_tok, ref_cache = ref_step(params, ref_tok, ref_cache, ex_ref)
        tok, cache = step(params_c, tok, cache, ex_port)
    np.testing.assert_array_equal(np.asarray(ref_tok), tok.numpy())
    assert cache["len"] == int(ref_cache["len"]) == 15


def test_serving_process_imports_no_jax():
    code = (
        "import sys\n"
        "from repro_torch.launch import serve_llm\n"
        "serve_llm.main(['--arch', 'jamba-1.5-large-398b', '--reduced', '--gen-len', '2',"
        " '--prompt-len', '4', '--device', 'cpu'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "decode: 4x1 tokens" in proc.stdout
