"""What each rank of ``tests/test_torch_serve_shardmap.py`` runs (imports no
JAX, so the spawned ranks start quickly), and the requests both packages
serve.

:func:`main` runs the scenarios one after another on one rank of an 8-rank
gloo group on the CPU. Each scenario is one service lifetime: rank 0 runs
``repro_torch.serve.SimulationService(ServeConfig(backend="shardmap"))``
and returns what it found; every other rank runs
``repro_torch.serve.follower.follow`` until rank 0's stop step and returns
the steps it ran. A scenario that raises records its traceback, so the
tests that read it fail alone (a rank out of step fails the whole spawn).
"""

from __future__ import annotations

import asyncio
import io
import os
import time
import traceback
from contextlib import nullcontext, redirect_stderr, redirect_stdout
from datetime import timedelta

import numpy as np

N, L, R, G = 10, 7, 2, 1
WORLD = 1 << (R + G)
CONFIG = dict(R=R, G=G, max_batch_size=4, max_wait_ms=20.0, cache_size=8)
# qubits 1 and 3 are device qubits of isingparam(10)'s last stage at L=7,
# R=2, G=1 (tests/test_torch_launch_shardmap.py): X/Y on them alone and
# beside a local X
OBS = ("Z0 Z1 + 0.5*X3", "Y1 X8 - 0.25*Z4 + 0.3*X1 X3")
BUILD_FAIL_RANK = 5
NAN_SEED = 11
IDLE = {"step_s": 0.5, "group_timeout_s": 4.0, "gap_s": 8.0}
DEADLINE_S = 120.0  # each rank-0 scenario


# ----------------------------------------------------------------------
# the requests, in either package (``fams``/``fixed``: its PARAM_FAMILIES and
# FAMILIES; ``mk``: its SimRequest)
# ----------------------------------------------------------------------


def burst(fams, fixed, mk) -> list:
    """8 ``isingparam(10)`` requests (6 measured: observables with X/Y on
    device qubits, a marginal, shots on every third; 2 digest-only, one of
    them returning its state) and 4 identical ``qft(10)`` requests (a dedup
    group; one returns its state and is measured on it)."""
    sym = fams["isingparam"](N)
    rng = np.random.default_rng(7)
    reqs = []
    for i in range(8):
        measured = i % 4 != 3
        reqs.append(mk(circuit=sym, params=rng.uniform(-1.5, 1.5, 2), tenant=f"t{i % 2}", seed=i,
                       shots=64 if measured and i % 3 == 0 else 0,
                       marginals=((0, 1, 3),) if measured else (),
                       observables=OBS if measured else (), return_state=i == 7))
    qft = fixed["qft"](N)
    reqs += [mk(circuit=qft, tenant="t2") for _ in range(3)]
    reqs.append(mk(circuit=qft, tenant="t2", return_state=True, shots=32, seed=5,
                   observables=("X0 + 0.5*Z9",)))
    return reqs


def nan_batch(fams, mk) -> list:
    """4 measured ``isingparam(10)`` requests: one batch, one of whose rows
    the fault plan poisons."""
    sym = fams["isingparam"](N)
    rng = np.random.default_rng(13)
    return [mk(circuit=sym, params=rng.uniform(-1.5, 1.5, 2), seed=20 + i, shots=16,
               observables=OBS[:1]) for i in range(4)]


def bad_rider(fams, mk) -> list:
    """3 measured ``isingparam(10)`` requests, the second with a binding of
    the wrong length."""
    sym = fams["isingparam"](N)
    return [mk(circuit=sym, params=np.array(p), observables=OBS, marginals=((2, 9),))
            for p in ([0.3, -0.7], [0.1, 0.2, 0.3], [1.1, 0.4])]


def nan_plan(faults):
    return faults.FaultPlan(seed=NAN_SEED).add("nan_amplitudes", site="engine.run_sweep", count=1)


def encode(resp) -> dict:
    """A response (or the error a request got) as plain data."""
    if isinstance(resp, BaseException):
        return {"ok": False, "error": type(resp).__name__, "message": str(resp)}
    out = {"ok": True, "batch_size": resp.batch_size,
           "integrity_retries": (resp.provenance or {}).get("integrity_retries", 0)}
    if resp.amp0 is not None:
        out["amp0"] = [resp.amp0.real, resp.amp0.imag]
    if resp.state is not None:
        out["state"] = [np.real(resp.state).tolist(), np.imag(resp.state).tolist()]
    if resp.result is not None:
        r = resp.result
        out["samples"] = None if r.samples is None else np.asarray(r.samples).tolist()
        out["expectations"] = {k: float(v) for k, v in r.expectations.items()}
        out["marginals"] = {",".join(map(str, q)): np.asarray(m).tolist()
                            for q, m in r.marginals.items()}
    return out


async def serve_recorded(svc, reqs) -> tuple:
    """Submit every request before the scheduler runs (batch formation then
    depends only on the queue); each executed batch's members by position
    in ``reqs``, and every request's outcome."""
    index, batches = {}, []
    execute = svc.batcher.execute

    def recording(batch, pool, metrics):
        batches.append([index[r.request_id] for r in batch.requests])
        return execute(batch, pool, metrics)

    svc.batcher.execute = recording
    try:
        futs = []
        for i, r in enumerate(reqs):
            futs.append(svc.submit_nowait(r))
            index[r.request_id] = i
        out = await asyncio.gather(*futs, return_exceptions=True)
    finally:
        del svc.batcher.execute
    return batches, [encode(o) for o in out]


# ----------------------------------------------------------------------
# rank 0's scenarios (each returns plain data)
# ----------------------------------------------------------------------


def _port():
    from repro_torch.core.generators import FAMILIES, PARAM_FAMILIES
    from repro_torch.serve import ServeConfig, SimRequest, SimulationService

    return FAMILIES, PARAM_FAMILIES, ServeConfig, SimRequest, SimulationService


async def scenario_burst(cfg) -> dict:
    FAMILIES, PARAM_FAMILIES, _, SimRequest, SimulationService = _port()
    svc = SimulationService(cfg)
    async with svc:
        batches, resps = await serve_recorded(svc, burst(PARAM_FAMILIES, FAMILIES, SimRequest))
        stats = svc.stats()
        counts = {("qft" if e.circuit.is_bound else "isingparam"): e.op_counts()
                  for e in svc.pool.engines()}
    return {"batches": batches, "responses": resps, "stats": stats, "op_counts": counts}


async def scenario_nan(cfg) -> dict:
    """:func:`nan_batch` under :func:`nan_plan` (active on every rank)."""
    from repro_torch.sim import faults

    _, PARAM_FAMILIES, _, SimRequest, SimulationService = _port()
    svc = SimulationService(cfg)
    async with svc:
        batches, resps = await serve_recorded(svc, nan_batch(PARAM_FAMILIES, SimRequest))
        stats = svc.stats()
    return {"batches": batches, "responses": resps, "stats": stats,
            "plan": faults.active().stats()}


async def scenario_riders(cfg) -> dict:
    """A rider with a bad binding, then a request whose deadline expires
    before dispatch, then one more request."""
    _, PARAM_FAMILIES, _, SimRequest, SimulationService = _port()
    svc = SimulationService(cfg)
    sym = PARAM_FAMILIES["isingparam"](N)
    async with svc:
        batches, resps = await serve_recorded(svc, bad_rider(PARAM_FAMILIES, SimRequest))
        steps = svc.stats()["ranks"]["steps"]
        # a deadline far shorter than the batcher's wait: it expires in the queue
        expired = await asyncio.gather(svc.submit(SimRequest(
            circuit=sym, params=[0.2, 0.4], deadline_s=1e-4)), return_exceptions=True)
        after_expired = svc.stats()["ranks"]["steps"]
        last = await svc.submit(SimRequest(circuit=sym, params=[0.2, 0.4], observables=OBS))
        final = svc.stats()
    return {"batches": batches, "responses": resps, "steps": [steps, after_expired],
            "expired": encode(expired[0]), "last": encode(last), "stats": final}


async def scenario_build_failure(cfg) -> dict:
    """``su2param(10)`` fails to build on rank 5 alone, as many times as the
    breaker's threshold; the next request of it is quarantined on rank 0;
    then a request of another structure is served by every rank."""
    _, PARAM_FAMILIES, _, SimRequest, SimulationService = _port()
    svc = SimulationService(cfg)
    su2 = PARAM_FAMILIES["su2param"](N, reps=1)
    outcomes, steps = [], []
    async with svc:
        for _ in range(cfg.breaker_threshold + 1):
            got = await asyncio.gather(svc.submit(SimRequest(
                circuit=su2, params=np.full(len(su2.param_names), 0.3), observables=("Z0",))),
                return_exceptions=True)
            outcomes.append(encode(got[0]))
            steps.append(svc.stats()["ranks"]["steps"])
        ising = PARAM_FAMILIES["isingparam"](N)
        last = await svc.submit(SimRequest(circuit=ising, params=[0.2, 0.4], observables=OBS))
        stats = svc.stats()
    return {"outcomes": outcomes, "steps": steps, "last": encode(last), "stats": stats}


async def scenario_idle(cfg) -> dict:
    """No request for longer than the group's (shortened) timeout."""
    _, _, _, _, SimulationService = _port()
    svc = SimulationService(cfg)
    t0 = time.monotonic()
    async with svc:
        await asyncio.sleep(IDLE["gap_s"])
    return {"gap_s": time.monotonic() - t0}


def refusals(rank) -> dict:
    """``serve_sim --backend shardmap`` with a split whose mesh is not the
    group's: every rank exits 2 before serving."""
    from repro_torch.launch.serve_sim import main as serve_sim

    out, err = io.StringIO(), io.StringIO()
    try:
        with redirect_stdout(out), redirect_stderr(err):
            serve_sim(["--backend", "shardmap", "--device", "cpu", "--R", "1", "--G", "1",
                       "--demo", "--families", "isingparam:10", "--requests", "2"])
        code = 0
    except SystemExit as e:
        code = e.code
    return {"exit": code, "stdout": out.getvalue(), "stderr": err.getvalue()}


# ----------------------------------------------------------------------
# every rank
# ----------------------------------------------------------------------


def _scenarios(faults):
    from repro_torch.serve import ServeConfig

    base = dict(CONFIG, backend="shardmap", device="cpu")
    fail_plan = faults.FaultPlan().add("pallas_lowering_error", site="engine.init",
                                       count=ServeConfig().breaker_threshold)
    # (name, config, rank-0 scenario, plan for rank r or None, group timeout:
    # where given, the idle step is IDLE["step_s"] too)
    return [
        ("burst", ServeConfig(**base), scenario_burst, lambda r: None, None),
        ("nan", ServeConfig(**base), scenario_nan, lambda r: nan_plan(faults), None),
        ("riders", ServeConfig(**base), scenario_riders, lambda r: None, None),
        ("build_failure", ServeConfig(**base), scenario_build_failure,
         lambda r: fail_plan if r == BUILD_FAIL_RANK else None, None),
        ("idle", ServeConfig(**base), scenario_idle, lambda r: None, IDLE["group_timeout_s"]),
    ]


def main(rank) -> dict:
    # at a lower priority the ranks leave the suite's other workers (whose
    # own spawned ranks have tight timeouts) their share of the cores
    os.nice(10)
    from torch.distributed.distributed_c10d import _set_pg_timeout

    from repro_torch.launch import dist as launch_dist
    from repro_torch.serve import follower
    from repro_torch.sim import faults

    ctx = launch_dist.join("gloo", "cpu")
    found = {}
    idle_step_s = follower.IDLE_STEP_S
    for name, cfg, scenario, plan_for, timeout in _scenarios(faults):
        if timeout is not None:
            _set_pg_timeout(timedelta(seconds=timeout), None)
            follower.IDLE_STEP_S = IDLE["step_s"]
        plan = plan_for(rank)
        try:
            with faults.inject(plan) if plan is not None else nullcontext():
                if rank:
                    found[name] = follower.follow(cfg, ctx)
                else:
                    found[name] = asyncio.run(asyncio.wait_for(scenario(cfg), DEADLINE_S))
        except Exception:
            found[name] = {"error": traceback.format_exc()}
            if rank:
                raise  # a follower out of step: the spawn fails
        finally:
            if timeout is not None:
                _set_pg_timeout(timedelta(seconds=120), None)
                follower.IDLE_STEP_S = idle_step_s
    found["refusals"] = refusals(rank)
    return found


def card_main(rank, n: int, L: int, points: list, obs: str) -> dict:
    """One rank of the card test (``tests/test_torch_gpu.py``): a shardmap
    service of 4 gloo ranks on the card (``isingparam(n)`` at L, R=2);
    rank 0 serves one measured request per point (the first with 32 shots)
    and returns the answers with ``stats()["ranks"]``."""
    from repro_torch.launch import dist as launch_dist
    from repro_torch.serve.follower import follow

    FAMILIES, PARAM_FAMILIES, ServeConfig, SimRequest, SimulationService = _port()
    ctx = launch_dist.join("gloo", "cuda")
    cfg = ServeConfig(backend="shardmap", device=ctx.device, R=2, max_batch_size=4,
                      max_wait_ms=200.0)
    if rank:
        return follow(cfg, ctx)
    sym = PARAM_FAMILIES["isingparam"](n)

    async def go():
        async with SimulationService(cfg) as svc:
            reqs = [SimRequest(circuit=sym, params=p, L=L, observables=(obs,), seed=i,
                               shots=32 if i == 0 else 0) for i, p in enumerate(points)]
            _, resps = await serve_recorded(svc, reqs)
            return {"responses": resps, "ranks": svc.stats()["ranks"]}

    return asyncio.run(asyncio.wait_for(go(), 600))
