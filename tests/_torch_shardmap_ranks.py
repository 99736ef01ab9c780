"""What each rank of ``tests/test_torch_shardmap.py`` runs (imports no JAX,
so the spawned ranks start quickly). :func:`main` runs every part on one
rank of an 8-rank gloo group on the CPU and returns its findings; a part
that raises records its traceback, so the tests that read it fail alone."""

from __future__ import annotations

import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.core.circuit import Circuit
from repro_torch.core.partition import SimulationPlan
from repro_torch.kernels import ops
from repro_torch.sim import collective, faults
from repro_torch.sim.engine import ExecutionEngine, circuit_key_for, engine_for
from repro_torch.sim.measure import PauliSum, measurer_for, simulate_and_measure
from repro_torch.sim.shardmap_executor import ShardMapExecutor

# every torch.distributed call the exchanges must not make
OTHER_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object",
                     "broadcast", "broadcast_object_list", "reduce", "reduce_scatter",
                     "reduce_scatter_tensor", "gather", "scatter", "all_to_all", "barrier",
                     "send", "recv", "isend", "irecv", "batch_isend_irecv")


class _Spy:
    """During ``with``: count ``all_to_all_single`` and raise on any other
    collective."""

    def __enter__(self):
        self.calls = 0
        self.saved = {name: getattr(dist, name) for name in OTHER_COLLECTIVES + (
            "all_to_all_single",)}
        real = self.saved["all_to_all_single"]

        def counted(*a, **kw):
            self.calls += 1
            return real(*a, **kw)

        def forbidden(name):
            def call(*a, **kw):
                raise AssertionError(f"dist.{name} called during execute")
            return call

        for name in OTHER_COLLECTIVES:
            setattr(dist, name, forbidden(name))
        dist.all_to_all_single = counted
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(dist, name, fn)


def _engine(case, **kw):
    return convert.engine_from_reference(case["circuit"], case["plan"], case["tensors"],
                                         device="cpu", backend="shardmap", **kw)


def run_cases(rank, cases):
    out = {}
    for name, case in cases.items():
        eng = _engine(case)
        ops.reset_kernel_counters()
        collective.reset_collective_counters()
        with _Spy() as spy:
            shard = eng.run()
        res = {"run": shard.numpy(), "kernels": ops.kernel_call_counts(),
               "collectives": collective.collective_counts(), "dist_calls": spy.calls,
               "trace": [dict(t) for t in eng.backend.trace], "op_counts": eng.op_counts()}
        packed = eng.run_packed()
        res["packed"] = packed.numpy().copy()
        res["finalized"] = eng.finalize(packed).numpy()
        # the shim, on the port's own op tensors and plan
        ex = ShardMapExecutor(Circuit.from_json(case["circuit"]),
                              SimulationPlan.from_json(case["plan"]), device="cpu")
        ops.reset_kernel_counters()
        res["executor"] = ex.run().numpy()
        res["executor_kernels"] = ops.kernel_call_counts()
        res["executor_fused_by_k"] = ops.fused_call_counts_by_k()
        batch = np.stack([case["psi0"], np.roll(case["psi0"], 3)])
        res["psi0"] = eng.run(case["psi0"]).numpy()
        res["batch"] = eng.run_batch(batch).numpy()
        out[name] = res
    return out


def run_measure(rank, cases, spec):
    out = {}
    for name in spec["cases"]:
        eng = _engine(cases[name])
        m = measurer_for(eng.run_packed(), eng.measurement_frame, eng)
        res = {"masses": m.shard_masses()}
        collective.reset_collective_counters()
        res["samples"] = m.sample(spec["shots"], seed=spec["seed"])
        res["sample_traffic"] = collective.collective_counts()
        res["marginals"] = {tuple(q): m.marginal(q) for q in spec["marginals"]}
        res["terms"] = {}
        for obs in spec["observables"]:
            for term in PauliSum.parse(obs).terms:
                collective.reset_collective_counters()
                value = m.expectation(term)
                res["terms"][str(term)] = (value, collective.collective_counts())
            res[obs] = m.expectation(obs)
        out[name] = res
    case = cases[spec["cases"][0]]
    result = simulate_and_measure(Circuit.from_json(case["circuit"]), backend="shardmap",
                                  plan=SimulationPlan.from_json(case["plan"]),
                                  shots=spec["shots"], seed=spec["seed"],
                                  marginals=spec["marginals"], observables=spec["observables"],
                                  device="cpu")
    out["simulate_and_measure"] = (result.samples, result.marginals, result.expectations)
    return out


def run_guard(rank, case, params):
    out = {}
    eng = ExecutionEngine(Circuit.from_json(case["circuit"]),
                          SimulationPlan.from_json(case["plan"]), device="cpu",
                          backend="shardmap")
    eng.bind(params)
    ops.reset_kernel_counters()
    clean = eng.run(verify=True)
    out["clean_launches"] = sum(ops.kernel_call_counts().values())
    out["clean_provenance"] = dict(eng.provenance)
    ops.reset_kernel_counters()
    plan = faults.FaultPlan(seed=7).add("nan_amplitudes", count=1, site="engine.run")
    if rank == 1:  # one rank's output poisoned
        with faults.inject(plan):
            got = eng.run(verify=True)
    else:
        got = eng.run(verify=True)
    out["recovered_equal"] = bool(torch.equal(got, clean))
    out["recovered_launches"] = sum(ops.kernel_call_counts().values())
    out["recovered_provenance"] = dict(eng.provenance)
    try:
        eng.run(params=dict.fromkeys(eng.param_names, float("nan")), verify=True)
        out["poisoned"] = "no error"
    except faults.IntegrityError as e:
        out["poisoned"] = type(e).__name__
    out["poisoned_provenance"] = dict(eng.provenance)
    return out


def run_errors(rank, cases, mismatched_plan, grad_obs):
    case = cases["ising"]
    out = {}
    try:
        convert.engine_from_reference(case["circuit"], mismatched_plan, {}, device="cpu",
                                      backend="shardmap")
        out["mismatch"] = "no error"
    except faults.BackendBuildError as e:
        out["mismatch"] = (type(e).__name__, str(e))
    with faults.inject(faults.FaultPlan(seed=1).add("xla_trace_error", site="shardmap.setup")):
        try:
            _engine(case)
            out["fault"] = "no error"
        except faults.BackendBuildError as e:
            out["fault"] = (type(e).__name__, e.injected)
    eng = _engine(case)
    out["value_and_grad"] = eng.value_and_grad(grad_obs)
    out["grad_sweep"] = eng.grad_sweep([[]], grad_obs)
    circ = Circuit.from_json(case["circuit"])
    plan = SimulationPlan.from_json(case["plan"])
    key = circuit_key_for(circ, plan.L, plan.R, plan.G, backend="shardmap", device="cpu")
    out["key"] = key.digest
    first = engine_for(circ, plan.L, plan.R, plan.G, backend="shardmap", device="cpu")
    again = engine_for(circ, plan.L, plan.R, plan.G, backend="shardmap", device="cpu")
    out["cached"] = first is again and first.backend.name == "shardmap"
    out["engine_for_state"] = again.run().numpy()
    return out


def main(rank, cases, measure_spec, guard_case, guard_params, mismatched_plan, grad_obs):
    found = {}
    for part, call in (("cases", lambda: run_cases(rank, cases)),
                       ("measure", lambda: run_measure(rank, cases, measure_spec)),
                       ("guard", lambda: run_guard(rank, guard_case, guard_params)),
                       ("errors", lambda: run_errors(rank, cases, mismatched_plan, grad_obs))):
        try:
            found[part] = call()
        except Exception:
            found[part] = {"error": traceback.format_exc()}
    return found


def fail_on_rank(rank, bad):
    """Raises on rank ``bad``; sleeps past any test's timeout when ``bad``
    is negative (a hung rank)."""
    if bad < 0:
        import time

        time.sleep(3600)
    if rank == bad:
        raise ValueError(f"rank {rank} fails on purpose")
    return rank
