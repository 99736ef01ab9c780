"""What each rank of ``tests/test_torch_launch_shardmap.py`` runs (imports no
JAX, so the spawned ranks start quickly). :func:`main` runs every case of
the CLI, ``repro_torch.launch.simulate.main(argv)``, on one rank of an
8-rank gloo group on the CPU, then the checks that need the group, and
returns what it found; a part that raises records its traceback, so the
tests that read it fail alone."""

from __future__ import annotations

import io
import os
import traceback
from contextlib import redirect_stderr, redirect_stdout

import torch

from repro_torch.core.generators import FAMILIES
from repro_torch.core.partition import partition
from repro_torch.launch.simulate import _basis_rows, main as cli
from repro_torch.sim import faults
from repro_torch.sim.engine import ExecutionEngine


def _summary(run) -> dict:
    results = [run.result] if run.result is not None else run.results
    return {
        "state": None if run.state is None else run.state.numpy().copy(),
        "results": [{"samples": r.samples, "marginals": dict(r.marginals),
                     "expectations": dict(r.expectations)} for r in results],
        "fidelities": list(run.fidelities),
        "launches": run.launches,
        "remaps": run.remaps,
        "op_counts": run.engine.op_counts(),
        "autotune": run.engine.provenance.get("autotune"),
        "energies": list(run.energies),
        "theta": run.theta,
        "param_names": list(run.param_names),
        "sweeps": run.sweeps,
        "adjoint_builds": run.engine.adjoint_builds,
    }


def _call(argv) -> dict:
    """One CLI call: its summary and what it printed, or how it exited."""
    out, err = io.StringIO(), io.StringIO()
    try:
        with redirect_stdout(out), redirect_stderr(err):
            found = _summary(cli(argv))
    except SystemExit as e:
        found = {"exit": e.code}
    found.update(stdout=out.getvalue(), stderr=err.getvalue())
    return found


def run_cases(rank, cases) -> dict:
    return {name: _call(argv) for name, argv in cases.items()}


def run_checks(rank, mismatch_rank) -> dict:
    out = {}
    circ = FAMILIES["qft"](10)
    # one rank planned otherwise (greedy staging: other stages, so other
    # collectives): every rank must refuse before the first exchange
    plan = partition(circ, 7, 2, 1, staging_method="greedy" if rank == mismatch_rank else "ilp")
    try:
        ExecutionEngine(circ, plan, device="cpu", backend="shardmap")
        out["mismatch"] = "no error"
    except faults.BackendBuildError as e:
        out["mismatch"] = (type(e).__name__, str(e))
    # a batch given as rows(lo, hi) builds only the rank's columns, and they
    # are the whole array's slice
    eng = ExecutionEngine(circ, partition(circ, 7, 2, 1), device="cpu", backend="shardmap")
    rows = _basis_rows(5, circ.n_qubits)
    asked = []

    def spy(lo, hi):
        asked.append((lo, hi))
        return rows(lo, hi)

    local = eng.backend.prepare(spy, batch=True)
    whole = eng.backend.prepare(torch.from_numpy(rows(0, 1 << circ.n_qubits)), batch=True)
    out["batch_rows"] = {"equal": bool(torch.equal(local, whole)), "asked": asked,
                         "shape": tuple(local.shape)}
    return out


def main(rank, cases, mismatch_rank):
    # the 8 ranks keep every core busy for half a minute: at a lower
    # priority they leave the suite's other workers (whose own spawned
    # ranks have tight timeouts) their share
    os.nice(10)
    found = {}
    for part, call in (("cases", lambda: run_cases(rank, cases)),
                       ("checks", lambda: run_checks(rank, mismatch_rank))):
        try:
            found[part] = call()
        except Exception:
            found[part] = {"error": traceback.format_exc()}
    return found
