"""The port's copied planner (gates, circuit, generators, cost model,
staging, kernelization, partition, stage compiler) against the JAX
package's: identical plans, op streams and tensors for every family."""

import dataclasses
import json

import numpy as np
import pytest

from repro.core import cost_model as ref_cm
from repro.core.generators import FAMILIES as REF_FAMILIES
from repro.core.partition import partition as ref_partition
from repro.sim.compile import compile_plan as ref_compile
from repro_torch.core import cost_model as port_cm
from repro_torch.core.generators import FAMILIES as PORT_FAMILIES
from repro_torch.core.partition import partition as port_partition
from repro_torch.sim.compile import compile_plan as port_compile

CASES = [(name, 8, 6, 2, 0) for name in sorted(REF_FAMILIES)] + [("qft", 8, 5, 2, 1)]


def _plan_dict(plan):
    d = json.loads(plan.to_json())
    d.pop("preprocess_time_s")  # wall time
    return d


def _remap(spec):
    return None if spec is None else (spec.src_bit_of, spec.flip_bits)


def _op_stream(cc):
    rows = []
    for prog in cc.programs:
        for op in prog.ops:
            for o in (op,) + op.gates:
                rows.append((o.kind, o.local_bits, o.dep_bits, o.uid, o.tensor))
    return rows


def test_families_match():
    assert sorted(PORT_FAMILIES) == sorted(REF_FAMILIES)


@pytest.mark.parametrize("name,n,L,R,G", CASES)
def test_plan_and_op_stream_match(name, n, L, R, G):
    ref_c, port_c = REF_FAMILIES[name](n), PORT_FAMILIES[name](n)
    assert port_c.to_json() == ref_c.to_json()
    ref_p = ref_partition(ref_c, L, R, G)
    port_p = port_partition(port_c, L, R, G)
    assert _plan_dict(port_p) == _plan_dict(ref_p)
    ref_cc, port_cc = ref_compile(ref_c, ref_p), port_compile(port_c, port_p)
    assert [p.layout for p in port_cc.programs] == [p.layout for p in ref_cc.programs]
    for slot in ("initial_remap", "final_remap"):
        assert _remap(getattr(port_cc, slot)) == _remap(getattr(ref_cc, slot)), slot
    assert [_remap(p.remap_after) for p in port_cc.programs] == [
        _remap(p.remap_after) for p in ref_cc.programs]
    ref_ops, port_ops = _op_stream(ref_cc), _op_stream(port_cc)
    assert [r[:4] for r in port_ops] == [r[:4] for r in ref_ops]
    for (_, _, _, uid, a), (_, _, _, _, b) in zip(ref_ops, port_ops):
        assert a.dtype == b.dtype and np.array_equal(a, b), f"op {uid} tensor differs"


def test_cost_model_constants_match():
    assert dataclasses.asdict(port_cm.DEFAULT_COST_MODEL) == dataclasses.asdict(
        ref_cm.DEFAULT_COST_MODEL)
    for name in ("PASS_US", "MXU_US_PER_2K", "LAUNCH_US", "SHM_GATE_US", "SHM_DIAG_GATE_US",
                 "MAX_FUSION_QUBITS", "MAX_SHM_QUBITS", "IO_QUBITS", "FUSION", "SHM"):
        assert getattr(port_cm, name) == getattr(ref_cm, name), name


def _optimizer_case(case):
    from repro.core.circuit import Circuit
    from repro.core.gates import Param
    from repro.core.generators import random_circuit, redundant

    if case == "redundant":
        return redundant(10)
    if case == "symbolic":  # Param folds and reorders, binding-independent
        c = Circuit(5)
        for q in range(5):
            c.add("rz", q, params=[Param(f"a{q}")])
            c.add("rz", q, params=[Param(f"a{q}") * 0.5 + 0.25])
            c.add("h", q)
            c.add("h", q)
        for q in range(4):
            c.add("cx", q, q + 1)
            c.add("cx", q, q + 1)
            c.add("rzz", q, q + 1, params=[Param("b")])
        return c
    return random_circuit(8, 60, seed=int(case[-1]))


@pytest.mark.parametrize("case", ["redundant", "symbolic", "random0", "random1", "random2"])
def test_optimizer_rewrites_match(case):
    """The port's copy of the pre-staging optimizer makes the reference's
    rewrite: the same gate list, pass counts, provenance and fingerprint."""
    from repro.core import optimize as ref_opt
    from repro_torch.core import optimize as port_opt
    from repro_torch.core.circuit import Circuit as PCircuit

    ref_c = _optimizer_case(case)
    port_c = PCircuit.from_json(ref_c.to_json())
    for config in (True, ("cancel", "merge"), ("reorder", "cancel")):
        want = ref_opt.optimize_circuit(ref_c, config)
        got = port_opt.optimize_circuit(port_c, config)
        assert got.circuit.to_json() == want.circuit.to_json()
        assert got.to_dict() == want.to_dict() and got.provenance == want.provenance
        assert port_opt.optimize_fingerprint(config) == ref_opt.optimize_fingerprint(config)
    if case == "redundant":
        assert got.gates_removed > 0
    order = list(range(port_c.n_gates))
    assert port_c.is_equivalent_order(order[::-1]) == ref_c.is_equivalent_order(order[::-1])
    assert port_opt.optimize_fingerprint(False) == ref_opt.optimize_fingerprint(False)
