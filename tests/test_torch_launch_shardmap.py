"""The port's CLI on the explicit-collective executor (``--executor
shardmap``) on the CPU, against the reference CLI's.

8 gloo ranks, spawned once for the module (``tests/_torch_launch_ranks.py``),
each call ``repro_torch.launch.simulate.main([... "--executor", "shardmap",
"--device", "cpu"])`` on the cases below (L=7, R=2, G=1); the reference,
``repro.launch.simulate.main([... "--executor", "shardmap"])``, runs the same
cases on 8 virtual devices in an ``XLA_FLAGS`` subprocess before them (at
the suite's priority; the ranks run under ``nice``) and returns its results
as JSON. Held: the reference's shots for the seed,
marginals and expectations within 1e-6, states within 1e-5, fidelity
``>= 1 - 1e-6``, and the same result (and autotune choice) on every rank;
only rank 0 prints, with one line per remap whose bytes are Eq. 2's.
``--vqe`` gives the reference CLI's energies and angles within 1e-4 (its
tolerance in ``tests/test_torch_grad.py``) on every rank. Then the
refusals (a world size other than 2^(R+G), NCCL on the CPU, no launcher, a
rank that planned otherwise), a batch built column-wise per rank, and two
real launches under ``torchrun``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import _torch_launch_ranks as rank_side
from repro.sim.statevector import fidelity
from repro_torch.launch import dist as launch_dist
from repro_torch.launch.simulate import main
from repro_torch.sim.ranks import run_ranks

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
WORLD = 8
BASE = ["--L", "7", "--R", "2", "--G", "1", "--executor", "shardmap"]
OBS = "Z0 Z1 + 0.5*X9"
# qubits 0, 1 and 3 are the device qubits of isingparam(10)'s last stage
# (L=7, R=2, G=1): Z on them, X/Y on them alone and beside a local X
VQE = ["--vqe", "Z0 Z1 + Z1 Z2 + 0.5*X5 - 0.4*X1 Y3 + 0.3*Y0 X8", "--vqe-steps", "4",
       "--vqe-seed", "3"]
VQE_ATOL = 1e-4  # tests/test_torch_grad.py::test_vqe_cli_matches_reference's
POINTS = [{"J": 0.35, "h": 0.8}, {"J": -1.1, "h": 0.2}]
STATE_ATOL = 1e-5  # complex64 through a few dozen gates, against the reference
MEASURE_ATOL = 1e-6
FIDELITY_MIN = 1 - 1e-6
MISMATCH_RANK = 5
TIMEOUT = 300  # every spawn, subprocess and torchrun launch
NICE = ["nice", "-n", "10"]  # as the ranks: leave the suite's other workers their cores


def _cases(sweep_file):
    measured = ["--circuit", "qft", "--n", "10", "--shots", "64", "--marginal", "0,1",
                "--observable", OBS]
    return {
        # the reference's --check re-runs and returns the state, not the
        # result: it measures without --check
        "measured": (measured + ["--check"], measured),
        "sweep": (["--circuit", "isingparam", "--n", "10", "--sweep", sweep_file, "--check"],) * 2,
        "batch": (["--circuit", "qft", "--n", "10", "--batch", "3", "--shots", "32"],) * 2,
        "engine": (["--circuit", "isingparam", "--n", "10", "--engine", "--bind", "J=0.35",
                    "--bind", "h=0.8"],) * 2,
        "opt": (["--circuit", "qft", "--n", "10", "--opt", "--check"],) * 2,
        "autotune": (["--circuit", "qft", "--n", "10", "--autotune", "--check"],) * 2,
        "vqe": (["--circuit", "isingparam", "--n", "10"] + VQE,) * 2,
        # a refusal, on every rank
        "world": (["--circuit", "qft", "--n", "10", "--L", "8", "--R", "1", "--G", "1",
                   "--executor", "shardmap"], None),
    }


REFERENCE = r"""
import io, json, sys
from contextlib import redirect_stdout
import numpy as np
from repro.launch.simulate import main

def enc(out):
    if isinstance(out, dict):  # --vqe
        return {"energy": out["energy"], "theta": np.asarray(out["theta"]).tolist(),
                "param_names": list(out["param_names"])}
    if isinstance(out, list):
        return {"results": [{"samples": r.samples.tolist(),
                             "marginals": {",".join(map(str, q)): m.tolist()
                                           for q, m in r.marginals.items()},
                             "expectations": r.expectations} for r in out]}
    if hasattr(out, "expectations"):
        return enc([out])
    a = np.asarray(out)
    return {"state": [a.real.tolist(), a.imag.tolist()]}

found = {}
for name, argv in json.loads(sys.argv[1]).items():
    with redirect_stdout(io.StringIO()):
        found[name] = enc(main(argv))
print(json.dumps(found))
"""


@pytest.fixture(scope="module")
def sweep_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("sweep") / "points.json"
    path.write_text(json.dumps(POINTS))
    return str(path)


@pytest.fixture(scope="module")
def runs(sweep_file, tmp_path_factory):
    """``(reference, ranks)``: the reference CLI's results by case, and every
    rank's findings."""
    cases = _cases(sweep_file)
    port = {name: argv + ["--device", "cpu"] + (BASE if name != "world" else [])
            for name, (argv, _) in cases.items()}
    ref = {name: argv + BASE for name, (_, argv) in cases.items() if argv is not None}
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    # the reference runs first, at the suite's priority (under nice, after
    # the ranks, among the suite's workers, it overran its limit), then the
    # ranks, under nice
    proc = subprocess.run([sys.executable, "-c", REFERENCE, json.dumps(ref)], env=env,
                          capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ranks = run_ranks(rank_side.main, WORLD, str(tmp_path_factory.mktemp("rendezvous")),
                      args=(port, MISMATCH_RANK), threads=1, timeout=TIMEOUT, init_timeout=120)
    return json.loads(proc.stdout.strip().splitlines()[-1]), ranks


def _part(ranks, part):
    for r, found in enumerate(ranks):
        assert "error" not in found[part], f"rank {r}, {part}:\n{found[part]['error']}"
    return [found[part] for found in ranks]


def _case(runs, name):
    """The reference's result and every rank's, each rank's run finished."""
    reference, ranks = runs
    got = [c[name] for c in _part(ranks, "cases")]
    for d, g in enumerate(got):
        assert "exit" not in g, f"rank {d}: exit {g['exit']}\n{g['stderr']}"
    return reference.get(name), got


def _ref_state(ref):
    re, im = (np.asarray(part) for part in ref["state"])
    return (re + 1j * im).astype(np.complex64)


def _gathered(got):
    """The logical state(s) from the ranks' shards, in rank order."""
    return np.concatenate([g["state"] for g in got], axis=-1)


def _same_on_every_rank(got, key):
    for d, g in enumerate(got[1:], 1):
        a, b = g[key], got[0][key]
        if key == "results":
            for ra, rb in zip(a, b):
                assert np.array_equal(ra["samples"], rb["samples"]), d
                assert ra["expectations"] == rb["expectations"], d
                assert all(np.array_equal(ra["marginals"][q], rb["marginals"][q])
                           for q in rb["marginals"]), d
        else:
            assert a == b, (key, d)


def _hold_results(ref, got):
    assert len(got[0]["results"]) == len(ref["results"])
    for mine, want in zip(got[0]["results"], ref["results"]):
        if want["samples"]:
            assert np.array_equal(mine["samples"], want["samples"])
        for q, m in want["marginals"].items():
            key = tuple(int(x) for x in q.split(","))
            assert np.abs(mine["marginals"][key] - np.asarray(m)).max() <= MEASURE_ATOL
        for name, value in want["expectations"].items():
            assert abs(mine["expectations"][name] - value) <= MEASURE_ATOL
    _same_on_every_rank(got, "results")


# ----------------------------------------------------------------------
# the cases, against the reference CLI
# ----------------------------------------------------------------------


def test_measured_state_matches_the_reference(runs):
    ref, got = _case(runs, "measured")
    _hold_results(ref, got)
    assert got[0]["results"][0]["samples"].shape == (64,)
    assert got[0]["fidelities"][0] >= FIDELITY_MIN
    _same_on_every_rank(got, "fidelities")


@pytest.mark.parametrize("name", ["sweep", "engine", "opt", "autotune"])
def test_states_match_the_reference(runs, name):
    ref, got = _case(runs, name)
    want = _ref_state(ref)
    state = _gathered(got)
    assert state.shape == want.shape
    assert np.abs(state - want).max() <= STATE_ATOL
    for f in got[0]["fidelities"]:
        assert f >= FIDELITY_MIN
    assert len(got[0]["fidelities"]) == {"sweep": 2, "engine": 0}.get(name, 1)
    _same_on_every_rank(got, "fidelities")


def test_sweep_fidelities_against_the_dense_reference(runs):
    """The gathered sweep rows are each point's state (the CLI's own check,
    rank 0's, broadcast to the others)."""
    ref, got = _case(runs, "sweep")
    want = _ref_state(ref)
    for p in range(len(POINTS)):
        assert fidelity(_gathered(got)[p], want[p]) >= FIDELITY_MIN


def test_measured_batch_matches_the_reference(runs):
    ref, got = _case(runs, "batch")
    _hold_results(ref, got)
    assert [r["samples"].shape for r in got[0]["results"]] == [(32,)] * 3


def test_autotune_chooses_alike_on_every_rank(runs):
    """Every rank replays every candidate; the choice reads the slowest
    rank's time, so every rank installs the same plan."""
    _, got = _case(runs, "autotune")
    tuned = [g["autotune"] for g in got]
    assert tuned[0] is not None and len(tuned[0]["replay_us"]) >= 2
    for d, t in enumerate(tuned):
        assert t["chosen"] == tuned[0]["chosen"], d
        assert t["replay_us"] == tuned[0]["replay_us"], d
        assert t["speedup_vs_default"] == tuned[0]["speedup_vs_default"], d
        assert f"autotune: chose '{t['chosen']}'" in got[0]["stdout"]


# ----------------------------------------------------------------------
# what the ranks print and count
# ----------------------------------------------------------------------


@pytest.mark.parametrize("name", ["measured", "sweep", "batch", "engine", "opt", "autotune"])
def test_only_rank_zero_prints(runs, name):
    _, got = _case(runs, name)
    assert "torch.distributed gloo, world size 8; devices by rank: " + ", ".join(
        ["cpu"] * WORLD) in got[0]["stdout"]
    assert all(g["stdout"] == "" for g in got[1:])


@pytest.mark.parametrize("name", ["measured", "engine", "opt"])
def test_launches_and_remaps_per_rank(runs, name):
    """Each rank launched one kernel per compiled op; each remap line gives
    the bytes every rank sent, Eq. 2's: ``(1 - 2^-m)`` of a shard in the
    all-to-all and, unless the rank keeps its shard, one shard in the
    permute."""
    _, got = _case(runs, name)
    counts = got[0]["op_counts"]
    launches = got[0]["launches"]
    assert len(launches) == WORLD
    for d, c in enumerate(launches):
        assert (c["fused"], c["shm"]) == (counts.get("fused", 0), counts.get("shm", 0)), d
        assert sum(c["by_k"].values()) == c["fused"], d
        assert c["fused"] + c["shm"] > 0, d
    shard_bytes = 8 << 7
    remaps = got[0]["remaps"]
    assert remaps and all(g["remaps"] == remaps for g in got)
    lines = [ln for ln in got[0]["stdout"].splitlines() if ln.startswith("  remap ")]
    assert len(lines) == len(remaps)
    for r, line in zip(remaps, lines):
        a2a = shard_bytes - (shard_bytes >> r["m"]) if r["m"] else 0
        perm = shard_bytes if r["permute"] else 0
        assert all(b in (a2a, a2a + perm) for b in r["bytes_sent"]), r
        assert f"bytes sent per rank {r['bytes_sent']}" in line


# ----------------------------------------------------------------------
# refusals, and a batch built rank by rank
# ----------------------------------------------------------------------


def test_wrong_world_size_is_refused_on_every_rank(runs):
    _, ranks = runs
    for d, c in enumerate(_part(ranks, "cases")):
        assert c["world"]["exit"] == 2, d
        assert "launch 4 ranks" in c["world"]["stderr"] and "not 8" in c["world"]["stderr"], d


def test_vqe_is_refused_on_every_rank(runs):
    """``--vqe`` on the 8 ranks: no rank refuses or exits; every rank ends
    with the reference CLI's energy and angles (within 1e-4) and the same
    trajectory as rank 0, builds one adjoint program, and rank 0 prints the
    loop, each rank's sweep (its bytes within the bound) and one line per
    inverse remap."""
    ref, got = _case(runs, "vqe")
    for d, g in enumerate(got):
        assert g["param_names"] == ref["param_names"], d
        assert abs(g["energies"][-1] - ref["energy"]) <= VQE_ATOL, d
        assert np.abs(g["theta"] - np.asarray(ref["theta"])).max() <= VQE_ATOL, d
        assert len(g["energies"]) == 5 and g["adjoint_builds"] == 1, d
        assert g["energies"] == got[0]["energies"] and np.array_equal(g["theta"], got[0]["theta"])
        assert g["sweeps"] == got[0]["sweeps"] and len(g["sweeps"]) == WORLD, d
    out = got[0]["stdout"]
    assert "VQE done" in out and "no adjoint program built" in out
    assert all(w["bytes_sent"] <= w["bound"] and w["bytes_received"] <= w["bound"]
               for w in got[0]["sweeps"])
    undo = [r for r in got[0]["remaps"] if str(r["slot"]).startswith("undo ")]
    assert undo and sum(ln.startswith("  remap undo ") for ln in out.splitlines()) == len(undo)
    assert sum(ln.startswith("  sweep on rank ") for ln in out.splitlines()) == WORLD


def test_a_rank_that_planned_otherwise_stops_every_rank(runs):
    _, ranks = runs
    for d, c in enumerate(_part(ranks, "checks")):
        kind, msg = c["mismatch"]
        assert kind == "BackendBuildError" and f"ranks [{MISMATCH_RANK}]" in msg, d


def test_batch_rows_are_built_per_rank(runs):
    _, ranks = runs
    for d, c in enumerate(_part(ranks, "checks")):
        rows = c["batch_rows"]
        assert rows["equal"] and rows["shape"] == (5, 1 << 7), d
        assert rows["asked"] == [(d << 7, (d + 1) << 7)], d


def test_nccl_on_the_cpu_is_refused(capsys):
    with pytest.raises(SystemExit) as e:
        main(["--circuit", "qft", "--n", "10"] + BASE + ["--dist-backend", "nccl",
                                                          "--device", "cpu"])
    assert e.value.code == 2
    assert "NCCL moves CUDA tensors only" in capsys.readouterr().err


def test_no_launcher_is_refused(monkeypatch, capsys):
    for var in launch_dist.TORCHRUN_VARS:
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit) as e:
        main(["--circuit", "qft", "--n", "10"] + BASE + ["--device", "cpu"])
    assert e.value.code == 2
    assert "torchrun" in capsys.readouterr().err


def test_dist_backend_needs_shardmap(capsys):
    with pytest.raises(SystemExit):
        main(["--circuit", "qft", "--n", "8", "--dist-backend", "gloo", "--device", "cpu"])
    assert "--dist-backend needs --executor shardmap" in capsys.readouterr().err


@pytest.mark.parametrize("local_world,cards,want", [
    (1, 1, "cuda:0"), (4, 4, "cuda:2"), (4, 1, "refused"), (2, 1, "refused")])
def test_nccl_takes_one_rank_per_card(local_world, cards, want):
    """NCCL refuses two ranks on one card ('Duplicate GPU detected'), so the
    placement is refused before the group starts; gloo shares the card."""
    local_rank = min(2, local_world - 1)
    if want == "refused":
        with pytest.raises(launch_dist.LaunchError, match="--dist-backend gloo"):
            launch_dist.rank_device("nccl", "cuda", local_rank, local_world, cards)
    else:
        assert str(launch_dist.rank_device("nccl", "cuda", local_rank, local_world,
                                           cards)) == want
    gloo = launch_dist.rank_device("gloo", "cuda", local_rank, local_world, cards)
    assert gloo.index == local_rank % cards


# ----------------------------------------------------------------------
# real launches under torchrun
# ----------------------------------------------------------------------


def _torchrun(nproc: int, *argv: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    return subprocess.run(
        NICE + [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), "-m", "repro_torch.launch.simulate",
         "--circuit", "qft", "--qubits", "10", "--L", "8", "--R", "2", "--executor", "shardmap",
         "--device", "cpu", *argv],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=TIMEOUT)


def test_torchrun_launch_checks_the_state():
    proc = _torchrun(4, "--check")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "fidelity vs dense reference: 1.000000" in proc.stdout
    assert proc.stdout.count("fidelity vs dense reference") == 1  # rank 0 alone prints


def test_torchrun_with_the_wrong_world_size_fails():
    proc = _torchrun(2, "--check")
    assert proc.returncode != 0
    assert "launch 4 ranks" in proc.stderr and "fidelity" not in proc.stdout
