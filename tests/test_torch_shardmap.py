"""The port's explicit-collective backend on the CPU, against the JAX
package's ``ShardMapBackend`` (``tests/test_distributed.py``'s cases).

The cases are the reference's: ``qft``, ``ising``, ``qsvm`` and ``wstate``
at n=9 with L=6, R=2, G=1, and ``random_circuit(8, 45, seed)`` for seeds
0-3 at L=5 (lazy flips on device bits). Their plans come from the
reference's ``partition``; the port compiles them with its own copy.

* ``_build_remap_plan`` equals the reference's field by field, and the
  choreography (:func:`remap_pre`, an in-process loopback of every rank's
  exchange, :func:`remap_post`) equals ``apply_remap`` bit for bit;
* 8 gloo ranks on the CPU, spawned once for the whole module
  (``tests/_torch_shardmap_ranks.py``), run every case through
  ``backend="shardmap"`` on the reference's op tensors and through
  ``ShardMapExecutor`` on the port's own: fidelity ``>= 1 - 1e-6`` against
  ``repro.sim.statevector.simulate`` and max |Δ| ``<= 1e-5`` against the
  reference's meshless pjit engine on the same plan (the meshed pjit
  reference is red, ROADMAP C); per rank, the all-to-all and permute counts
  and bytes are the ones the reference's ``RemapPlan``s give (Eq. 2), no
  other collective runs during ``execute``, and the kernel launches are the
  reference's ``KERNEL_CALLS`` under ``shard_map`` with ``use_pallas=True``;
* ``ShardedMeasurer``: the reference measurer's shots for a seed, marginals
  and expectations (X/Y terms on device bits included) within 1e-6 of
  ``marginal_np`` / ``expectation_np``; an X/Y term on device bits costs
  one permute of one shard, the others no shard traffic;
* the guard (no retry when clean; a NaN on one rank recovered on every rank
  by one re-run; a poisoned re-run raises on every rank), the typed setup
  errors, and ``value_and_grad``/``grad_sweep`` on every rank
  (``tests/test_torch_shardmap_grad.py`` holds the gradients at length).
"""

import os
import subprocess
import sys
from dataclasses import asdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_shardmap_ranks as rank_side
from repro.core.generators import FAMILIES, PARAM_FAMILIES, random_circuit
from repro.core.partition import partition
from repro.sim import engine as reng
from repro.sim.measure import ShardedMeasurer as RefShardedMeasurer
from repro.sim.statevector import fidelity, simulate
from repro_torch.core.circuit import Circuit
from repro_torch.core.partition import SimulationPlan
from repro_torch.sim import collective, engine as teng
from repro_torch.sim.compile import compile_plan
from repro_torch.sim.measure import PauliSum, expectation_np, marginal_np
from repro_torch.sim.ranks import RanksFailed, run_ranks

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORLD = 8
FAMILY_CASES = {fam: (FAMILIES[fam](9), 6, 2, 1) for fam in ("qft", "ising", "qsvm", "wstate")}
RANDOM_CASES = {f"random{s}": (random_circuit(8, 45, seed=s), 5, 2, 1) for s in range(4)}
CASES = {**FAMILY_CASES, **RANDOM_CASES}
NAMES = list(CASES)
STATE_ATOL = 1e-5  # complex64 through a few dozen gates, against the reference
FIDELITY_MIN = 1 - 1e-6
MEASURE_ATOL = 1e-6
MEASURE = {"cases": ["qft", "ising", "random1", "random3"], "shots": 256, "seed": 11,
           "marginals": [(0, 1, 2), (7, 3), (5,)],
           "observables": ["Z0 Z1 + 0.5*X7 - 0.3*Y6 X2 + 0.2*Y7 Y1 Z5",
                           "X0 X1 X2 X3 X4 X5 X6 X7 + Y3 - 0.7*Z4 Z7 + 0.25"]}
GRAD_OBS = "Z0 + 0.5*X8"  # gradients of ising(9), which has no parameters


def _remaps(cc):
    """``(slot, spec)`` of every remap of a compiled program, in run order."""
    out = [("init", cc.initial_remap)] if cc.initial_remap is not None else []
    out += [(i, p.remap_after) for i, p in enumerate(cc.programs) if p.remap_after is not None]
    if cc.final_remap is not None:
        out.append(("final", cc.final_remap))
    return out


@pytest.fixture(scope="module")
def refs():
    """Per case: the reference's plan, its meshless pjit engine's op tensors,
    states, and the port's compiled program on the same plan."""
    rng = np.random.default_rng(5)
    out = {}
    for name, (circ, L, R, G) in CASES.items():
        plan = partition(circ, L, R, G)
        ref = reng.ExecutionEngine(circ, plan, backend="pjit")
        psi0 = rng.normal(size=1 << circ.n_qubits) + 1j * rng.normal(size=1 << circ.n_qubits)
        psi0 = (psi0 / np.linalg.norm(psi0)).astype(np.complex64)
        out[name] = {
            "circ": circ, "plan": plan, "ref": ref,
            "tensors": {uid: np.asarray(t) for uid, t in ref.consts.items()},
            "run": np.asarray(ref.run()).reshape(-1),
            "packed": np.asarray(ref.run_packed()).reshape(-1),
            "psi0": psi0, "run_psi0": np.asarray(ref.run(psi0)).reshape(-1),
            "port_cc": compile_plan(Circuit.from_json(circ.to_json()),
                                    SimulationPlan.from_json(plan.to_json()),
                                    dtype=np.complex64),
        }
    return out


@pytest.fixture(scope="module")
def ranks(refs, tmp_path_factory):
    """Every rank's findings (``_torch_shardmap_ranks.main``), one spawn of
    8 gloo CPU ranks for the whole module."""
    cases = {name: {"circuit": r["circ"].to_json(), "plan": r["plan"].to_json(),
                    "tensors": r["tensors"], "psi0": r["psi0"]} for name, r in refs.items()}
    sym = PARAM_FAMILIES["isingparam"](9)
    guard_case = {"circuit": sym.to_json(), "plan": partition(sym, 6, 2, 1).to_json()}
    mismatched = partition(CASES["ising"][0], 7, 1, 1).to_json()  # 2^(R+G) = 4 ranks
    return run_ranks(rank_side.main, WORLD, str(tmp_path_factory.mktemp("rendezvous")),
                     args=(cases, MEASURE, guard_case, {"J": 0.7, "h": -0.4}, mismatched,
                           GRAD_OBS),
                     threads=1, timeout=300, init_timeout=120)


def _part(ranks, part):
    for r, found in enumerate(ranks):
        assert "error" not in found[part], f"rank {r}, {part}:\n{found[part]['error']}"
    return [found[part] for found in ranks]


# ----------------------------------------------------------------------
# (a) the remap plans, (b) the choreography with a loopback exchange
# ----------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_remap_plans_match_the_reference(refs, name):
    r = refs[name]
    ref_remaps, port_remaps = _remaps(r["ref"].cc), _remaps(r["port_cc"])
    assert [s for s, _ in ref_remaps] == [s for s, _ in port_remaps] and port_remaps
    n, L = r["port_cc"].n, r["port_cc"].L
    for (slot, rspec), (_, pspec) in zip(ref_remaps, port_remaps):
        want = asdict(reng._build_remap_plan(rspec, n, L))
        assert asdict(teng._build_remap_plan(pspec, n, L)) == want, slot


def _loopback(pre, rp, L):
    """Every rank's exchange in one process, from the reference's semantics:
    ``lax.all_to_all(tiled=True)`` over the mesh axes ``rp.a2a_axes`` (the
    first axis the most significant bit of a rank's index in its group;
    chunk ``c`` to the group's ``c``-th rank, received chunks in the same
    order), then ``lax.ppermute`` by ``rp.ppermute``'s ``(src, dst)``
    pairs. Also returns each rank's group, in chunk order."""
    world = len(pre)
    bits = [int(a[1:]) - L for a in rp.a2a_axes]

    def index_in_group(d):
        return sum(((d >> b) & 1) << (rp.m - 1 - t) for t, b in enumerate(bits))

    def member(d, c):
        for t, b in enumerate(bits):
            d = (d & ~(1 << b)) | (((c >> (rp.m - 1 - t)) & 1) << b)
        return d

    groups = [[member(d, c) for c in range(1 << rp.m)] for d in range(world)]
    cur = [p.view(1 << rp.m, -1) for p in pre]
    if rp.m:
        cur = [torch.stack([cur[g][index_in_group(d)] for g in groups[d]]) for d in range(world)]
    if rp.ppermute is not None:
        moved = [None] * world
        for src, dst in rp.ppermute:
            moved[dst] = cur[src]
        cur = moved
    return cur, groups


@pytest.mark.parametrize("name", NAMES)
def test_choreography_matches_apply_remap(refs, name):
    cc = refs[name]["port_cc"]
    n, L = cc.n, cc.L
    world = 1 << (n - L)
    rng = np.random.default_rng(3)
    for slot, spec in _remaps(cc):
        x = torch.from_numpy((rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n))
                             .astype(np.complex64))
        rp = teng._build_remap_plan(spec, n, L)
        shards = list(x.view(world, -1))
        if rp.m == 0 and rp.ppermute is None:
            got = torch.cat([teng.remap_local(s, rp, L) for s in shards])
        else:
            mid, groups = _loopback([teng.remap_pre(s, rp, L) for s in shards], rp, L)
            got = torch.cat([teng.remap_post(t, rp, L) for t in mid])
            for d in range(world):
                peers, pair = collective.exchange_pattern(rp, d, L)
                assert peers == (groups[d] if rp.m else None), (slot, d)
                want_pair = None if rp.ppermute is None else (
                    dict(rp.ppermute)[d], next(a for a, b in rp.ppermute if b == d))
                assert pair == want_pair, (slot, d)
        assert torch.equal(got, teng.apply_remap(x, spec)), slot


# ----------------------------------------------------------------------
# (c) states, (d) the collective schedule, (e) kernel launches
# ----------------------------------------------------------------------


def _gather(ranks, name, key):
    return np.concatenate([found["cases"][name][key] for found in ranks])


@pytest.mark.parametrize("name", NAMES)
def test_ranks_reproduce_the_reference(refs, ranks, name):
    _part(ranks, "cases")
    r = refs[name]
    oracle = np.asarray(simulate(r["circ"])).reshape(-1)
    got = _gather(ranks, name, "run")
    assert np.abs(got - r["run"]).max() <= STATE_ATOL
    assert fidelity(got, oracle) >= FIDELITY_MIN
    assert fidelity(_gather(ranks, name, "executor"), oracle) >= FIDELITY_MIN
    assert np.abs(_gather(ranks, name, "packed") - r["packed"]).max() <= STATE_ATOL
    assert np.array_equal(_gather(ranks, name, "finalized"), got)
    assert np.abs(_gather(ranks, name, "psi0") - r["run_psi0"]).max() <= STATE_ATOL
    batch = np.concatenate([found["cases"][name]["batch"] for found in ranks], axis=1)
    assert np.abs(batch[0] - r["run_psi0"]).max() <= STATE_ATOL
    second = np.asarray(r["ref"].run(np.roll(r["psi0"], 3))).reshape(-1)
    assert np.abs(batch[1] - second).max() <= STATE_ATOL


@pytest.mark.parametrize("name", NAMES)
def test_collective_schedule_is_the_references(refs, ranks, name):
    """Per rank: one all-to-all per remap with m > 0 sending (1 - 2^-m) of a
    shard, one permute per remap with a residual permutation sending the
    shard unless the rank keeps it (Eq. 2), and no other collective."""
    r = refs[name]
    cc = r["ref"].cc
    n, L = cc.n, cc.L
    shard_bytes = 8 << L
    plans = [reng._build_remap_plan(spec, n, L) for _, spec in _remaps(cc)]
    for d, found in enumerate(_part(ranks, "cases")):
        res = found[name]
        want_sent = sum(shard_bytes - (shard_bytes >> p.m) for p in plans if p.m)
        want_sent += sum(shard_bytes for p in plans
                         if p.ppermute is not None and dict(p.ppermute)[d] != d)
        got = res["collectives"]
        assert got["all_to_all"] == sum(1 for p in plans if p.m), d
        assert got["permute"] == sum(1 for p in plans if p.ppermute is not None), d
        assert got["bytes_sent"] == want_sent, d
        assert res["dist_calls"] == got["all_to_all"] + got["permute"], d
        assert all(got[k] == 0 for k in ("all_reduce", "all_gather", "broadcast", "send"))
        assert [(t["m"], t["permute"]) for t in res["trace"]] == \
            [(p.m, p.ppermute is not None) for p in plans]
    assert any(p.m for p in plans)


def _reference_kernel_calls(code: str) -> dict:
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return eval(proc.stdout.strip().splitlines()[-1])


def test_kernel_launches_per_rank_are_the_references(refs, ranks):
    """``ising(9)`` under the reference's ``ShardMapExecutor(use_pallas=True)``
    on 8 virtual devices: its per-device ``KERNEL_CALLS`` (counted while the
    shard program traces, once for every device) are every rank's launches;
    every case launches one kernel per compiled op on every rank."""
    want = _reference_kernel_calls(
        "from repro.core import generators as gen\n"
        "from repro.core.partition import partition\n"
        "from repro.sim.shardmap_executor import ShardMapExecutor\n"
        "from repro.kernels import ops\n"
        "c = gen.ising(9)\n"
        "ShardMapExecutor(c, partition(c, 6, 2, 1), use_pallas=True).run()\n"
        "print(dict(ops.KERNEL_CALLS))\n")
    found = _part(ranks, "cases")
    assert sum(want.values()) > 0
    for d in range(WORLD):
        assert found[d]["ising"]["executor_kernels"] == want, d
        for name in NAMES:
            ops_by_kind = found[d][name]["op_counts"]
            assert found[d][name]["kernels"] == {"fused": ops_by_kind.get("fused", 0),
                                                 "shm": ops_by_kind.get("shm", 0)}, (d, name)


# ----------------------------------------------------------------------
# (f) ShardedMeasurer
# ----------------------------------------------------------------------


def _ref_measurer(refs, ranks, name):
    """The reference's ShardedMeasurer on the ranks' own packed state."""
    return RefShardedMeasurer(jnp.asarray(_gather(ranks, name, "packed")),
                              refs[name]["ref"].measurement_frame)


@pytest.mark.parametrize("name", MEASURE["cases"])
def test_sharded_measurer_matches_the_reference(refs, ranks, name):
    found = [m[name] for m in _part(ranks, "measure")]
    ref = _ref_measurer(refs, ranks, name)
    for key in ("samples", "masses"):
        for d in range(1, WORLD):
            assert np.array_equal(found[d][key], found[0][key]), (key, d)
    np.testing.assert_allclose(found[0]["masses"], ref.shard_masses(), rtol=1e-6)
    assert np.array_equal(found[0]["samples"],
                          ref.sample(MEASURE["shots"], seed=MEASURE["seed"]))
    oracle = np.asarray(simulate(refs[name]["circ"])).reshape(-1)
    for qubits in MEASURE["marginals"]:
        want = marginal_np(oracle, qubits)
        for d in range(WORLD):
            np.testing.assert_allclose(found[d]["marginals"][tuple(qubits)], want,
                                       atol=MEASURE_ATOL)
    for obs in MEASURE["observables"]:
        want = expectation_np(oracle, obs)
        for d in range(WORLD):
            assert found[d][obs] == found[0][obs]
        assert abs(found[0][obs] - want) <= MEASURE_ATOL, obs


def test_simulate_and_measure_on_shardmap_ranks(refs, ranks):
    """``simulate_and_measure(backend="shardmap")`` on every rank: one result,
    the reference's ``backend="pjit"`` shots on the same plan, marginals and
    expectations within 1e-5 (the two engines' complex64 states)."""
    from repro.sim.measure import simulate_and_measure

    found = [m["simulate_and_measure"] for m in _part(ranks, "measure")]
    r = refs[MEASURE["cases"][0]]
    want = simulate_and_measure(r["circ"], backend="pjit", plan=r["plan"],
                                shots=MEASURE["shots"], seed=MEASURE["seed"],
                                marginals=MEASURE["marginals"],
                                observables=MEASURE["observables"])
    for samples, marginals, expectations in found:
        assert np.array_equal(samples, want.samples)
        for qs in MEASURE["marginals"]:
            np.testing.assert_allclose(marginals[tuple(qs)], want.marginals[tuple(qs)],
                                       atol=STATE_ATOL)
        for key, value in want.expectations.items():
            assert abs(expectations[key] - value) <= STATE_ATOL, key


@pytest.mark.parametrize("name", MEASURE["cases"])
def test_sharded_measurer_traffic(refs, ranks, name):
    """Sampling sends each sampled shard's float64 row once, to rank 0; an
    X/Y term on device bits is one permute of one shard per rank; a Z-only
    or local X/Y term moves no shard."""
    found = [m[name] for m in _part(ranks, "measure")]
    frame = refs[name]["ref"].measurement_frame
    L, row_bytes = frame.L, 8 << frame.L
    sampled = set((np.asarray(frame.logical_to_phys(found[0]["samples"])) >> L).tolist())
    phys_of = {q: p for p, q in enumerate(frame.layout)}
    device_terms = 0
    for d in range(WORLD):
        traffic = found[d]["sample_traffic"]
        sends = int(d in sampled and d != 0)
        assert traffic["send"] == sends and traffic["bytes_sent"] == sends * row_bytes, d
        assert traffic["permute"] == traffic["all_to_all"] == 0
        for obs in MEASURE["observables"]:
            for term in PauliSum.parse(obs).terms:
                value, counts = found[d]["terms"][str(term)]
                on_device = any(p in "XY" and phys_of[q] >= L for q, p in term.ops)
                device_terms += on_device
                assert counts["permute"] == int(on_device), (d, str(term))
                assert counts["bytes_sent"] == (row_bytes if on_device else 0), (d, str(term))
                assert counts["all_to_all"] == 0
    assert device_terms > 0


# ----------------------------------------------------------------------
# (g) the guard, (h) setup errors and what is not ported
# ----------------------------------------------------------------------


def test_guard_on_every_rank(ranks):
    for d, g in enumerate(_part(ranks, "guard")):
        assert "integrity_retries" not in g["clean_provenance"], d
        assert g["recovered_provenance"]["integrity_retries"] == 1, d
        assert g["recovered_provenance"]["integrity_recovered"] == 1, d
        assert g["recovered_equal"], d
        assert g["recovered_launches"] == 2 * g["clean_launches"] > 0, d
        assert g["poisoned"] == "IntegrityError", d
        assert g["poisoned_provenance"]["integrity_retries"] == 2, d
        assert g["poisoned_provenance"]["integrity_recovered"] == 1, d


def test_setup_errors_are_typed_with_no_rung(refs, ranks):
    """The typed setup errors, and gradients on every rank: ``value_and_grad``
    and ``grad_sweep`` of ``<Z0 + 0.5*X8>`` on the shardmap engine (no
    parameters: the value alone) give the oracle state's expectation, the
    same on every rank."""
    errors = _part(ranks, "errors")
    want = expectation_np(np.asarray(simulate(refs["ising"]["circ"])).reshape(-1), GRAD_OBS)
    for d, e in enumerate(errors):
        assert e["mismatch"][0] == "BackendBuildError" and "needs 4 ranks" in e["mismatch"][1]
        assert e["fault"] == ("XlaTraceError", True), d
        value, grads = e["value_and_grad"]
        values, sweep_grads = e["grad_sweep"]
        assert abs(value - want) <= STATE_ATOL and grads.shape == (0,), d
        assert values.tolist() == [value] and sweep_grads.shape == (1, 0), d
        assert (value, values.tolist()) == (errors[0]["value_and_grad"][0],
                                            errors[0]["grad_sweep"][0].tolist()), d
        assert e["cached"], d
    assert len({e["key"] for e in errors}) == WORLD  # the rank is part of the placement


def test_engine_for_runs_the_shardmap_backend(refs, ranks):
    got = np.concatenate([e["engine_for_state"] for e in _part(ranks, "errors")])
    oracle = np.asarray(simulate(refs["ising"]["circ"])).reshape(-1)
    assert fidelity(got, oracle) >= FIDELITY_MIN


def test_shardmap_needs_a_process_group():
    """In a process with no ``torch.distributed`` group the backend refuses
    to build, typed, and nothing else is tried."""
    from repro_torch.sim.faults import BackendBuildError

    circ, L, R, G = CASES["ising"]
    with pytest.raises(BackendBuildError, match="process group"):
        teng.ExecutionEngine(Circuit.from_json(circ.to_json()),
                             SimulationPlan.from_json(partition(circ, L, R, G).to_json()),
                             device="cpu", backend="shardmap")


@pytest.mark.parametrize("bad,match", [(1, "rank 1 fails on purpose"), (-1, "overran")])
def test_run_ranks_fails_on_a_failing_or_hung_rank(tmp_path, bad, match):
    """A rank that raises fails the run with its traceback as soon as it
    does (a limit that a slow spawn under load cannot reach); a hung rank
    fails it at the run's short limit, however long the spawn took."""
    limit = 10 if bad < 0 else 120
    with pytest.raises(RanksFailed, match=match):
        run_ranks(rank_side.fail_on_rank, 2, str(tmp_path), args=(bad,), threads=1,
                  timeout=limit, init_timeout=limit)
