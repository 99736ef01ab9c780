"""The port's CLI on the CPU, and the port's import hygiene: it imports
torch, never JAX or anything of the JAX package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.launch.simulate import main

ROOT = Path(__file__).resolve().parents[1]


def test_check_prints_full_fidelity(capsys):
    run = main(["--circuit", "qft", "--n", "9", "--L", "7", "--R", "2", "--check",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "fidelity vs dense reference: 1.000000" in out
    assert run.fidelity > 1 - 1e-5 and run.state.device.type == "cpu"


def test_measured_run_with_check(capsys):
    run = main(["--circuit", "ghz", "--n", "8", "--L", "5", "--R", "2", "--G", "1",
                "--shots", "200", "--marginal", "0,7", "--observable", "Z0 Z7",
                "--check", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "fidelity vs dense reference: 1.000000" in out
    assert abs(run.result.expectations["1*Z0 Z7"] - 1.0) < 1e-5
    assert set(run.result.counts()) <= {"0" * 8, "1" * 8}


def test_cli_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--circuit", "ghz", "--n", "4"])


def test_no_jax_in_the_port_process():
    code = (
        "import sys\n"
        "import repro_torch.launch.simulate as s\n"
        "import repro_torch.sim.profiler, repro_torch.core.autotune\n"
        "import repro_torch.launch.train, repro_torch.train.compression\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.hlo_analysis\n"
        "s.main(['--circuit', 'ghz', '--n', '6', '--L', '4', '--R', '2', '--shots', '8',"
        " '--check', '--device', 'cpu'])\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_no_jax():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    launch = ROOT / "src" / "repro_torch" / "launch"
    assert {launch / "dryrun.py", launch / "hlo_analysis.py", launch / "steps.py"} <= set(files)
    for path in files:
        for mod in _imports(path):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "repro", "ml_dtypes"), \
                f"{path}: {mod}"
