"""The port's simulation service on the explicit-collective backend
(``ServeConfig(backend="shardmap")``, ``serve_sim --backend shardmap``) on
the CPU, against the reference's (``repro.serve`` with
``backend="shardmap"``).

8 gloo ranks (n=10, L=7, R=2, G=1), spawned once for the module under
``nice`` (``tests/_torch_serve_ranks.py``): in each scenario rank 0 runs the
service and every other rank follows it until the stop step. The
reference serves the same requests on 8 virtual devices in one
``XLA_FLAGS`` subprocess before them, at the suite's priority (one heavy
job at a time), and returns JSON. Held against it: the same batches (members, sizes, flush reasons,
coalesce factor) of a seeded burst with device-X observables, marginals,
shots, digest-only and state-returning requests and a ``qft(10)`` dedup
group; expectations and marginals within 1e-6, the same counts for each
seed, ``amp0`` and states within 1e-5; a rider with a bad binding failing
alone; a NaN row (the same fault plan on every rank) recovered with
``integrity_retries`` 1. The port's own: a deadline expired before dispatch
reaches no rank; a build failure on rank 5 alone fails the batch with the
typed error on rank 0, opens the breaker after its threshold and leaves
every rank alive; the followers outlive an idle gap twice a short group
timeout; ``stats()["ranks"]`` holds every rank's launches (the plan's ops
times the rows run) and remaps (Eq. 2's bytes); ``stop()`` ends every rank;
the refusals; one real ``torchrun`` of the demo on 8 CPU ranks.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import _torch_serve_ranks as rank_side
from repro_torch.launch import dist as launch_dist
from repro_torch.launch.serve_sim import build_parser, main as serve_sim
from repro_torch.serve import ServeConfig, SimulationService
from repro_torch.sim.ranks import run_ranks

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
TESTS = os.path.dirname(os.path.abspath(__file__))
WORLD = rank_side.WORLD
MEASURE_ATOL = 1e-6
STATE_ATOL = 1e-5  # complex64 through a few dozen gates, against the reference
TIMEOUT = 300  # the spawn, the reference's subprocess and the torchrun launch
NICE = ["nice", "-n", "10"]  # as the ranks: leave the suite's other workers their cores
SCENARIOS = ("burst", "nan", "riders", "build_failure", "idle")

REFERENCE = r"""
import asyncio, json
from repro.core.generators import FAMILIES, PARAM_FAMILIES
from repro.serve import ServeConfig, SimRequest, SimulationService
from repro.sim import faults
import _torch_serve_ranks as rs

async def scenario(reqs):
    svc = SimulationService(ServeConfig(backend="shardmap", use_pallas=False, **rs.CONFIG))
    async with svc:
        batches, resps = await rs.serve_recorded(svc, reqs)
        stats = svc.stats()
    return {"batches": batches, "responses": resps, "counters": stats["counters"],
            "coalesce_factor": stats["coalesce_factor"]}

async def main():
    out = {"burst": await scenario(rs.burst(PARAM_FAMILIES, FAMILIES, SimRequest)),
           "riders": await scenario(rs.bad_rider(PARAM_FAMILIES, SimRequest))}
    with faults.inject(rs.nan_plan(faults)):
        out["nan"] = await scenario(rs.nan_batch(PARAM_FAMILIES, SimRequest))
    return out

print(json.dumps(asyncio.run(main())))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(reference, ranks)``: the reference's findings by scenario, and
    every rank's. The reference runs first, at the suite's priority (under
    nice, after the ranks, among the suite's six workers it overran its
    300 s limit), then the ranks, under nice."""
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}",
               PYTHONPATH=os.pathsep.join([SRC, TESTS]), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", REFERENCE], env=env,
                          capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ranks = run_ranks(rank_side.main, WORLD, str(tmp_path_factory.mktemp("rendezvous")),
                      threads=1, timeout=TIMEOUT, init_timeout=120)
    return json.loads(proc.stdout.strip().splitlines()[-1]), ranks


def _scenario(runs, name):
    """The reference's findings (None where it has none) and rank 0's."""
    reference, ranks = runs
    found = ranks[0][name]
    assert "error" not in found, found["error"]
    return reference.get(name), found


def _hold(got, want):
    """One response against the reference's."""
    assert got["ok"] == want["ok"]
    if not want["ok"]:
        assert got["error"] == want["error"]
        return
    assert got["batch_size"] == want["batch_size"]
    assert got["integrity_retries"] == want["integrity_retries"]
    assert ("amp0" in got) == ("amp0" in want) and ("state" in got) == ("state" in want)
    if "amp0" in want:
        assert abs(complex(*got["amp0"]) - complex(*want["amp0"])) <= STATE_ATOL
    if "state" in want:
        assert np.abs(np.asarray(got["state"]) - np.asarray(want["state"])).max() <= STATE_ATOL
    assert ("expectations" in got) == ("expectations" in want)
    if "expectations" not in want:
        return
    assert got["samples"] == want["samples"]
    assert set(got["expectations"]) == set(want["expectations"])
    for k, v in want["expectations"].items():
        assert abs(got["expectations"][k] - v) <= MEASURE_ATOL, k
    assert set(got["marginals"]) == set(want["marginals"])
    for q, m in want["marginals"].items():
        assert np.abs(np.asarray(got["marginals"][q]) - np.asarray(m)).max() <= MEASURE_ATOL, q


# ----------------------------------------------------------------------
# the burst, against the reference
# ----------------------------------------------------------------------


def test_burst_forms_the_references_batches(runs):
    want, got = _scenario(runs, "burst")
    assert got["batches"] == want["batches"]
    counters = got["stats"]["counters"]
    for k in ("batches_total", "requests_executed", "responses_total", "flush_size",
              "flush_deadline", "cache_hits", "cache_misses"):
        assert counters.get(k) == want["counters"].get(k), k
    assert got["stats"]["coalesce_factor"] == want["coalesce_factor"]
    assert max(len(b) for b in got["batches"]) == rank_side.CONFIG["max_batch_size"]


@pytest.mark.parametrize("kind", ["measured", "digest", "state", "dedup"])
def test_burst_answers_match_the_reference(runs, kind):
    """Measured rows (X/Y on device qubits, marginals, shots), digest-only
    rows (``amp0``), a returned state, and the dedup group (one of whose
    members is measured on its returned state)."""
    want, got = _scenario(runs, "burst")
    picks = {"measured": [0, 1, 2, 4, 5, 6], "digest": [3], "state": [7],
             "dedup": [8, 9, 10, 11]}[kind]
    for i in picks:
        _hold(got["responses"][i], want["responses"][i])
    if kind == "measured":
        assert any(got["responses"][i]["samples"] for i in picks)


def test_dedup_group_is_one_run_on_every_rank(runs):
    _, got = _scenario(runs, "burst")
    assert [8, 9, 10, 11] in got["batches"]
    dedup = [h for h in got["stats"]["ranks"]["history"] if h["dedup"]]
    assert len(dedup) == 1 and dedup[0]["requests"] == 4
    assert all(r["runs"] == 1 for r in dedup[0]["per_rank"])


def test_stats_hold_every_ranks_launches_and_remaps(runs):
    """Every batch step: on each rank, one launch per compiled op per row
    run, and each remap of its last run Eq. 2's bytes: ``(1 - 2^-m)`` of a
    shard in the all-to-all and, unless the rank keeps its shard, one shard
    in the permute. The totals are the steps' sums."""
    _, got = _scenario(runs, "burst")
    ranks = got["stats"]["ranks"]
    assert ranks["world"] == WORLD and ranks["steps"] == len(got["batches"])
    shard = 8 << rank_side.L
    for h in ranks["history"]:
        counts = got["op_counts"]["qft" if h["dedup"] else "isingparam"]
        assert len(h["per_rank"]) == WORLD
        for d, r in enumerate(h["per_rank"]):
            assert r["runs"] >= 1, d
            assert r["launches"]["fused"] == counts.get("fused", 0) * r["runs"], (h, d)
            assert r["launches"]["shm"] == counts.get("shm", 0) * r["runs"], (h, d)
            assert sum(r["launches"]["by_k"].values()) == r["launches"]["fused"]
        assert h["remaps"]
        for rp in h["remaps"]:
            a2a = shard - (shard >> rp["m"]) if rp["m"] else 0
            perm = shard if rp["permute"] else 0
            assert all(b in (a2a, a2a + perm) for b in rp["bytes_sent"]), rp
    for d, tot in enumerate(ranks["per_rank"]):
        assert tot["launches"]["fused"] == sum(h["per_rank"][d]["launches"]["fused"]
                                               for h in ranks["history"])
        assert tot["remap_bytes_sent"] > 0 and tot["cache_misses"] == 2, d
        assert tot["solver_calls"]["ilp"] + tot["solver_calls"]["greedy"] >= 2, d


# ----------------------------------------------------------------------
# faults
# ----------------------------------------------------------------------


def test_a_rider_with_a_bad_binding_fails_alone(runs):
    want, got = _scenario(runs, "riders")
    assert got["batches"] == want["batches"] == [[0, 1, 2]]
    for g, w in zip(got["responses"], want["responses"]):
        _hold(g, w)
    assert got["responses"][1]["error"] == "ValueError"
    assert "binding vector has 3 entries" in got["responses"][1]["message"]


def test_an_expired_deadline_reaches_no_rank(runs):
    _, got = _scenario(runs, "riders")
    assert got["expired"]["error"] == "RequestTimeout"
    before, after = got["steps"]
    assert before == after == 1
    assert got["last"]["ok"] and got["stats"]["ranks"]["steps"] == 2
    _, ranks = runs
    assert all(r["riders"] == {"batch": 2, "idle": 0} for r in ranks[1:])


def test_a_nan_row_is_recovered_on_every_rank(runs):
    want, got = _scenario(runs, "nan")
    assert got["batches"] == want["batches"] == [[0, 1, 2, 3]]
    for g, w in zip(got["responses"], want["responses"]):
        _hold(g, w)
        assert g["integrity_retries"] == 1
    (spec,) = got["plan"]["specs"]
    assert spec["fired"] == 1
    h = got["stats"]["ranks"]["history"][0]
    assert all(r["runs"] == 5 for r in h["per_rank"])  # 4 rows and one re-run


def test_a_build_failure_on_one_rank_fails_the_batch_on_rank_zero(runs):
    _, got = _scenario(runs, "build_failure")
    threshold = ServeConfig().breaker_threshold
    fails, quarantined = got["outcomes"][:threshold], got["outcomes"][threshold]
    for o in fails:
        assert o["error"] == "PallasLoweringError", o
        assert f"rank {rank_side.BUILD_FAIL_RANK} could not build the engine" in o["message"]
    assert quarantined["error"] == "CircuitQuarantined"
    assert got["steps"] == list(range(1, threshold + 1)) + [threshold]  # no step quarantined
    assert got["last"]["ok"]
    counters = got["stats"]["counters"]
    assert counters["build_failures"] == threshold and counters["breaker_opened"] == 1
    _, ranks = runs
    assert all(r["build_failure"] == {"batch": threshold + 1, "idle": 0} for r in ranks[1:])


def test_followers_outlive_an_idle_gap(runs):
    """The group's timeout is cut to 4 s for the scenario; rank 0 admits
    nothing for 8 s and sends an idle step every 0.5 s."""
    _, got = _scenario(runs, "idle")
    idle = rank_side.IDLE
    assert got["gap_s"] >= 2 * idle["group_timeout_s"]
    _, ranks = runs
    for d, r in enumerate(ranks[1:], 1):
        assert r["idle"]["batch"] == 0, d
        assert r["idle"]["idle"] >= idle["gap_s"] / idle["step_s"] - 2, d


def test_stop_ends_every_rank(runs):
    """Each follower returned from every scenario's ``follow`` (the stop
    step), and the spawn ended with every rank's result."""
    _, ranks = runs
    assert len(ranks) == WORLD
    for d, r in enumerate(ranks[1:], 1):
        assert set(SCENARIOS) <= set(r), d
        assert all("error" not in r[s] for s in SCENARIOS), d


# ----------------------------------------------------------------------
# refusals and the front end
# ----------------------------------------------------------------------


def test_wrong_world_size_is_refused_on_every_rank(runs):
    _, ranks = runs
    for d, r in enumerate(ranks):
        assert r["refusals"]["exit"] == 2, d
        assert "launch 4 ranks" in r["refusals"]["stderr"] and "not 8" in r["refusals"]["stderr"]


def test_shardmap_serves_with_one_worker():
    with pytest.raises(ValueError, match="workers=1"):
        SimulationService(ServeConfig(backend="shardmap", device="cpu", workers=2))


def test_shardmap_needs_a_process_group():
    with pytest.raises(RuntimeError, match="torch.distributed group"):
        SimulationService(ServeConfig(backend="shardmap", device="cpu"))


def test_nccl_on_the_cpu_is_refused(capsys):
    with pytest.raises(SystemExit) as e:
        serve_sim(["--backend", "shardmap", "--dist-backend", "nccl", "--device", "cpu",
                   "--demo"])
    assert e.value.code == 2
    assert "NCCL moves CUDA tensors only" in capsys.readouterr().err


def test_no_launcher_is_refused(monkeypatch, capsys):
    for var in launch_dist.TORCHRUN_VARS:
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit) as e:
        serve_sim(["--backend", "shardmap", "--device", "cpu", "--demo"])
    assert e.value.code == 2
    assert "torchrun" in capsys.readouterr().err


def test_dist_backend_needs_shardmap(capsys):
    with pytest.raises(SystemExit):
        serve_sim(["--dist-backend", "gloo", "--device", "cpu", "--demo"])
    assert "--dist-backend needs --backend shardmap" in capsys.readouterr().err


def test_no_flag_is_a_prefix_of_a_torchrun_option():
    """Some Python versions' argparse (the card host's among them) reject,
    after the script name, a flag that is a prefix of one of
    ``torch.distributed.run``'s options (an ambiguous abbreviation, as the
    simulate CLI's ``--n`` is); others run the job, so this test reads both
    parsers."""
    from torch.distributed.run import get_args_parser

    ours = {s for a in build_parser()._actions if a.dest != "help"  # argparse's own, as theirs
            for s in a.option_strings if s.startswith("--")}
    theirs = {s for a in get_args_parser()._actions for s in a.option_strings}
    assert "--nproc-per-node" in theirs or "--nproc_per_node" in theirs
    clashes = sorted((f, o) for f in ours for o in theirs if o.startswith(f))
    assert not clashes


def test_torchrun_demo_on_eight_cpu_ranks():
    """``serve_sim --backend shardmap --demo`` under a real ``torchrun`` of 8
    CPU ranks: it exits 0 and only rank 0 prints."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1", REPRO_CALIBRATION="off")
    proc = subprocess.run(
        NICE + [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", str(WORLD), "-m", "repro_torch.launch.serve_sim",
                "--backend", "shardmap", "--device", "cpu", "--dist-backend", "gloo",
                "--R", "2", "--G", "1", "--demo", "--families", "isingparam:10",
                "--requests", "12", "--max-batch", "4", "--shots", "16"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("demo: 12 responses (0 rejected)") == 1
    stats = json.loads(proc.stdout[proc.stdout.index("{"):])
    assert len(stats["ranks"]["per_rank"]) == WORLD
    assert all(r["launches"]["fused"] > 0 for r in stats["ranks"]["per_rank"])
