"""The dry run's census repeats to the byte: a cell's memory figures do not
depend on what ran before it in the process.

A serving cell (``decode_32k`` on 2x16x16, the fake group of 512 ranks) is
censused twice in one process, after a RoPE table of the same width was
cached there on ``meta`` (what an earlier cell of the sweep leaves), and
once in a fresh process; the three ``memory`` dicts (argument, output,
temp, peak, alias bytes) and every section's byte tallies must be equal.
Before ``run_cell`` cleared the RoPE cache, the cached table counted as an
argument in every cell after the first that used it, and as an output in
the first: argument and output moved by its 128 or 256 bytes, with the
peak, depending on the cells before. The three processes run at once, one
thread each."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CELLS = ("qwen2-1.5b", "deepseek-v2-lite-16b")
TIMEOUT_S = 240

SCRIPT = """
import json, sys
import torch
torch.set_num_threads(1)
from repro_torch.configs.registry import get_arch
from repro_torch.launch import dryrun
from repro_torch.models import layers

archs, repeat = sys.argv[1].split(","), int(sys.argv[2])
if repeat > 1:  # the history: a table an earlier cell would have cached
    for a in archs:
        cfg = get_arch(a)
        dim = cfg.qk_rope_head_dim if cfg.mla else cfg.hd
        frac = 1.0 if cfg.mla else cfg.partial_rotary
        layers.rope_freqs(dim, cfg.rope_theta, frac, device="meta")
for _ in range(repeat):
    for a in archs:
        r = dryrun.run_cell(a, "decode_32k", True)
        tally = {k: [v["bytes"], v["bytes_upper"], v["moved"]] for k, v in r["census"].items()}
        print("CELL " + json.dumps({"arch": a, "memory": r["memory"], "tally": tally}))
"""


@pytest.fixture(scope="module")
def runs():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")

    def start(archs, repeat):
        return subprocess.Popen([sys.executable, "-c", SCRIPT, ",".join(archs), str(repeat)],
                                env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    procs = {"twice": start(CELLS, 2)}
    procs.update({a: start((a,), 1) for a in CELLS})
    out = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=TIMEOUT_S)
        assert p.returncode == 0, stderr[-4000:]
        out[name] = [json.loads(line[5:]) for line in stdout.splitlines()
                     if line.startswith("CELL ")]
    return out


@pytest.mark.parametrize("arch", CELLS)
def test_a_cell_censused_thrice_gives_equal_figures(runs, arch):
    twice = [c for c in runs["twice"] if c["arch"] == arch]
    fresh = runs[arch]
    assert len(twice) == 2 and len(fresh) == 1
    first, second, alone = twice[0], twice[1], fresh[0]
    assert first["memory"] == second["memory"] == alone["memory"]
    assert first["tally"] == second["tally"] == alone["tally"]
    mem = alone["memory"]
    assert mem["peak"] == mem["argument"] + mem["temp"] and mem["output"] > 0
