"""Adjoint gradients on the port's shardmap backend on the CPU, against the
JAX package's complex128 oracle ``repro.sim.adjoint.adjoint_gradients_np``
and its meshless pjit engine on the same plan.

8 gloo ranks, spawned once for the module (``tests/_torch_shardmap_grad_ranks.py``,
at a lower priority), each hold one ``2^L`` shard and call
``ExecutionEngine.value_and_grad`` / ``grad_sweep`` with
``backend="shardmap"``. The cases, all at R=2, G=1:

* the reference test's ``_ansatz`` (``tests/test_grad.py``: fresh, shared
  and affine parameters) at n=8, L=5;
* ``isingparam(9)`` and ``su2param(9)`` at L=6;
* symbolic random circuits (``tests/strategies.py::build_circuit``) at
  n=8, L=5 whose plans leave lazy flips and put diagonal gates on device
  bits;

each with an observable that has X/Y, Z and mixed terms on the last
stage's device bits. Held, on every rank: the value within 2e-5 and every
gradient within 1e-4 of both references (``tests/test_grad.py``'s bounds),
the same numbers on every rank, ``grad_sweep`` rows equal to the points
alone, no adjoint build, solver call or structural-cache miss after a
rebind, the kernel launches of the sweep, and the sweep's bytes against
its bound (which a state gathered to one rank breaks). The inverse remaps'
choreography is held to ``apply_remap`` of the inverse spec bit for bit.
"""

import numpy as np
import pytest
import torch

import _torch_shardmap_grad_ranks as rank_side
import strategies as strat
from repro.core.generators import PARAM_FAMILIES
from repro.core.partition import partition
from repro.sim import engine as reng
from repro.sim.adjoint import adjoint_gradients_np
from repro_torch.core.circuit import Circuit
from repro_torch.core.partition import SimulationPlan
from repro_torch.sim import collective, engine as teng
from repro_torch.sim.apply import specialize_gate
from repro_torch.sim.compile import compile_plan
from repro_torch.sim.ranks import run_ranks
from test_grad import OBS, _ansatz
from test_torch_shardmap import _loopback

WORLD = 8
VALUE_ATOL, GRAD_ATOL = 2e-5, 1e-4  # tests/test_grad.py's, float32 against complex128
POINTS = 3  # grad_sweep's bindings
RANDOM_SEEDS = range(40)  # searched for plans with lazy flips and diagonals on device bits


def _port_cc(circ, plan):
    return compile_plan(Circuit.from_json(circ.to_json()),
                        SimulationPlan.from_json(plan.to_json()), dtype=np.complex64)


def _flips_and_device_diagonals(circ, plan) -> bool:
    """A plan in which some gate acts anti-diagonally on a device bit (a
    lazy flip: ``x``, ``y``, a controlled X or Y) and some gate diagonally
    (a diagonal gate, or a control, on a device bit)."""
    kinds = set()
    for st in plan.stages:
        phys_of = {q: p for p, q in enumerate(st.layout)}
        for gid in st.gate_ids:
            g = circ.gates[gid]
            nl = [j for j, q in enumerate(g.qubits) if phys_of[q] >= plan.L]
            flipped = set(specialize_gate(g.structural_matrix, nl, [0] * len(nl))[1])
            kinds.update("flip" if j in flipped else "diagonal" for j in nl)
    return kinds == {"flip", "diagonal"}


def _observable(cc) -> str:
    """``tests/test_grad.py``'s OBS plus terms on the last stage's device
    qubits (a flipped one first): X and Y together, Z alone and Z with a
    local X (one term needs the permute)."""
    last = cc.programs[-1].layout
    flipped = set(cc.final_remap.flip_bits) if cc.final_remap is not None else set()
    dev = sorted(range(cc.L, cc.n), key=lambda p: p not in flipped)
    a, b, c = (last[p] for p in dev[:3])
    return f"{OBS} + 0.4*X{a} Y{b} - 0.35*Z{c} + 0.3*Z{a} X{last[0]}"


def _cases():
    out = {"ansatz": (_ansatz(8), 5), "isingparam": (PARAM_FAMILIES["isingparam"](9), 6),
           "su2param": (PARAM_FAMILIES["su2param"](9), 6)}
    found = 0
    for seed in RANDOM_SEEDS:
        circ = strat.build_circuit(8, 40, seed=seed, param_mode="symbolic")
        if _flips_and_device_diagonals(circ, partition(circ, 5, 2, 1)):
            out[f"random{seed}"] = (circ, 5)
            found += 1
            if found == 2:
                break
    assert found == 2, "no random circuit put lazy flips and diagonals on device bits"
    return out


CASES = _cases()
NAMES = list(CASES)


@pytest.fixture(scope="module")
def refs():
    """Per case: the reference's plan, the observable, the angles and
    bindings, the complex128 oracle's and the pjit engine's answers."""
    out = {}
    for i, (name, (circ, L)) in enumerate(CASES.items()):
        plan = partition(circ, L, 2, 1)
        obs = _observable(_port_cc(circ, plan))
        rng = np.random.default_rng(10 + i)
        P = len(circ.param_names)
        theta = rng.uniform(0.2, 2.0, P)
        points = rng.uniform(0.0, 2 * np.pi, (POINTS, P))
        pjit = reng.ExecutionEngine(circ, plan, backend="pjit")
        out[name] = {"circ": circ, "plan": plan, "obs": obs, "theta": theta, "points": points,
                     "oracle": adjoint_gradients_np(circ, theta, obs),
                     "pjit": pjit.value_and_grad(obs, params=theta),
                     "oracle_points": [adjoint_gradients_np(circ, p, obs) for p in points]}
    return out


@pytest.fixture(scope="module")
def ranks(refs, tmp_path_factory):
    cases = {name: {"circuit": r["circ"].to_json(), "plan": r["plan"].to_json(),
                    "obs": r["obs"], "theta": r["theta"], "points": r["points"]}
             for name, r in refs.items()}
    return run_ranks(rank_side.main, WORLD, str(tmp_path_factory.mktemp("rendezvous")),
                     args=(cases,), threads=1, timeout=300, init_timeout=120)


def _found(ranks, name):
    for d, found in enumerate(ranks):
        assert "error" not in found[name], f"rank {d}, {name}:\n{found[name]['error']}"
    return [found[name] for found in ranks]


def _within(got, want):
    value, grads = got
    return abs(value - want[0]) <= VALUE_ATOL and np.abs(grads - want[1]).max() <= GRAD_ATOL


def _within_bytes(sweep: dict, bound: int) -> bool:
    """The bytes check: a rank sent and received at most the bound."""
    return sweep["bytes_sent"] <= bound and sweep["bytes_received"] <= bound


# ----------------------------------------------------------------------
# the answers
# ----------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_value_and_grad_matches_the_reference(refs, ranks, name):
    r = refs[name]
    found = _found(ranks, name)
    assert found[0]["grads"].shape == (len(r["circ"].param_names),)
    assert _within((r["pjit"][0], np.asarray(r["pjit"][1])), r["oracle"])
    for d, f in enumerate(found):
        assert _within((f["value"], f["grads"]), r["oracle"]), d
        assert _within((f["value"], f["grads"]), r["pjit"]), d
        assert f["value"] == found[0]["value"] and np.array_equal(f["grads"], found[0]["grads"]), d


@pytest.mark.parametrize("name", NAMES)
def test_grad_sweep_rows_are_the_points_alone(refs, ranks, name):
    r = refs[name]
    for d, f in enumerate(_found(ranks, name)):
        values, grads = f["grad_sweep"]
        assert values.shape == (POINTS,) and grads.shape == (POINTS, len(r["circ"].param_names))
        for p, (v, g) in enumerate(f["points"]):
            assert values[p] == v and np.array_equal(grads[p], g), (d, p)
            assert _within((v, g), r["oracle_points"][p]), (d, p)
        assert _within(f["rebound"], r["oracle_points"][0]), d


@pytest.mark.parametrize("name", NAMES)
def test_rebind_builds_and_plans_nothing(ranks, name):
    for d, f in enumerate(_found(ranks, name)):
        assert f["rebind_builds_nothing"], d
        assert f["adjoint_builds"] == 1, d


# ----------------------------------------------------------------------
# what the sweep runs and moves
# ----------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_sweep_launches_per_rank(ranks, name):
    """One ``fused_apply`` per forward ``fused`` op, per gate twice (``U†``
    on ψ and on λ), per slot once and per local Pauli op once; one
    ``shm_apply`` per forward ``shm`` op."""
    for d, f in enumerate(_found(ranks, name)):
        counts = f["op_counts"]
        want = counts.get("fused", 0) + 2 * f["n_gates"] + f["n_slots"] + f["pauli_launches"]
        assert f["launches"] == {"fused": want, "shm": counts.get("shm", 0)}, d
        assert f["pauli_launches"] > 0, d


@pytest.mark.parametrize("name", NAMES)
def test_sweep_bytes_within_the_bound(ranks, name):
    """Per rank, the sweep (λ's permutes and the inverse remaps) sends and
    receives at most twice the forward's remaps by Eq. 2, one shard per
    Pauli term with X/Y on device bits and the float64 results; each
    inverse remap exchanges as many bits as the remap it undoes, with a
    permute only where that one had one."""
    shard = 8 << CASES[name][1]
    for d, f in enumerate(_found(ranks, name)):
        sweep = f["sweep"]
        assert _within_bytes(sweep, f["bound"]), (d, sweep, f["bound"])
        assert sweep["bytes_sent"] > 0 and sweep["bytes_received"] > 0, d
        undone = [f["forward_plans"][str(s)] for s in range(len(f["undo_plans"]) - 1)]
        for (m, permute), (fm, fpermute) in zip(f["undo_plans"][1:], undone):
            assert m == fm and (fpermute or not permute), d
        undo = [t for t in f["trace"] if str(t["slot"]).startswith("undo ")]
        assert len(undo) == 2 * len(undone), d
        for t in undo:
            a2a = shard - (shard >> t["m"]) if t["m"] else 0
            assert a2a <= t["bytes_sent"] <= a2a + (shard if t["permute"] else 0), (d, t)


@pytest.mark.parametrize("name", ["isingparam", "random1"])
def test_a_gathered_state_breaks_the_bytes_bound(ranks, name):
    """Where the plan's own traffic is less than a gather (two stages here),
    the bytes check refuses the forward state gathered to rank 0: rank 0
    receives the other 7 shards, more than the sweep's bound."""
    shard = 8 << CASES[name][1]
    found = _found(ranks, name)
    assert found[0]["gathered"]["bytes_received"] == (WORLD - 1) * shard
    assert not _within_bytes(found[0]["gathered"], found[0]["bound"])
    for d, f in enumerate(found[1:], 1):
        assert f["gathered"] == {"bytes_sent": shard, "bytes_received": 0}, d


def test_walk_moves_commuting_gates_across_stages(ranks):
    """The plans stage some gates after later gates of the circuit
    (commuting insular ones): the sweep walks the stages in the plans'
    order, and the answers above hold for those cases too."""
    moved = [name for name in NAMES
             if _found(ranks, name)[0]["walk"] != sorted(_found(ranks, name)[0]["walk"])]
    assert moved, "no case moves a gate across a stage boundary"


@pytest.mark.parametrize("name", NAMES)
def test_inverse_remaps_choreography(refs, name):
    """Every inverse remap's plan (paired by target), run through the
    choreography on a loopback of all 8 ranks, is ``apply_remap`` of the
    inverse spec bit for bit."""
    cc = _port_cc(refs[name]["circ"], refs[name]["plan"])
    n, L = cc.n, cc.L
    rng = np.random.default_rng(4)
    specs = [p.remap_after.inverse() for p in cc.programs[:-1]]
    assert specs
    for spec in specs:
        x = torch.from_numpy((rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n))
                             .astype(np.complex64))
        rp = teng._build_remap_plan(spec, n, L, pair_by_target=True)
        shards = list(x.view(WORLD, -1))
        if rp.m == 0 and rp.ppermute is None:
            got = torch.cat([teng.remap_local(s, rp, L) for s in shards])
        else:
            mid, groups = _loopback([teng.remap_pre(s, rp, L) for s in shards], rp, L)
            got = torch.cat([teng.remap_post(t, rp, L) for t in mid])
            for d in range(WORLD):
                peers, _ = collective.exchange_pattern(rp, d, L)
                assert peers == (groups[d] if rp.m else None)
        assert torch.equal(got, teng.apply_remap(x, spec))
