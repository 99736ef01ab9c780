"""The port's serving robustness on the CPU: the serving cases of
``tests/test_faults.py`` (deadlines, transient retries, blast-radius
isolation, the integrity guard, the circuit breaker, the ``serve_sim``
front end) run against ``repro_torch.serve``.

Where the reference's guard retries on its dense per-gate oracle, the
port's re-runs the plan through the engine's own backend and kernels (on
the CPU the kernels' plain versions, counted by the wrappers): the tests
hold the retry to one more run's launches. A kernel that fails to build
reaches the breaker typed; no other engine (plain versions, another
backend) is ever built in its place.

Every fault plan is scoped by ``faults.inject``, every service is stopped
(``async with`` or ``finally``), sockets bind port 0 on the loopback, and
each scenario is bounded by its own asyncio deadline.
"""

import asyncio
import json

import numpy as np
import pytest

from repro_torch.core.generators import PARAM_FAMILIES
from repro_torch.kernels import ops
from repro_torch.serve import ServeConfig, SimRequest, SimulationService
from repro_torch.sim import engine as teng, faults
from repro_torch.sim.faults import (
    CircuitQuarantined, FaultPlan, PallasLoweringError, RequestTimeout, ShardTransferError,
    XlaTraceError,
)

DEADLINE_S = 60.0


def run(coro):
    async def bounded():
        return await asyncio.wait_for(coro, DEADLINE_S)
    return asyncio.run(bounded())


def cfg(**kw):
    base = dict(device="cpu", use_kernels=False)
    base.update(kw)
    return ServeConfig(**base)


def _sym(n=6):
    return PARAM_FAMILIES["su2param"](n)


def _req(sym, scale=0.1, **kw):
    return SimRequest(circuit=sym, params=np.full(len(sym.param_names), scale), **kw)


# ==========================================================================
# deadlines
# ==========================================================================

def test_serve_negative_deadline_rejected_before_queue():
    async def go():
        async with SimulationService(cfg()) as svc:
            with pytest.raises(RequestTimeout) as ei:
                svc.submit_nowait(_req(_sym(), deadline_s=-1.0))
            assert ei.value.deadline_s == -1.0
            assert svc.metrics.snapshot()["counters"]["timeouts_total"] == 1
            assert svc.queue.depth == 0

    run(go())


def test_serve_deadline_expires_before_dispatch():
    async def go():
        # batch formation waits 200ms; a 5ms deadline expires in queue
        async with SimulationService(cfg(max_batch_size=8, max_wait_ms=200.0)) as svc:
            fut = svc.submit_nowait(_req(_sym(), deadline_s=0.005))
            with pytest.raises(RequestTimeout) as ei:
                await fut
            assert ei.value.elapsed >= 0.005
            # service is still healthy for deadline-free requests
            r = await svc.submit(_req(_sym(), scale=0.2))
            assert r.amp0 is not None

    run(go())


def test_serve_default_request_timeout_from_config():
    async def go():
        async with SimulationService(cfg(max_batch_size=8, max_wait_ms=200.0,
                                         request_timeout_s=0.005)) as svc:
            with pytest.raises(RequestTimeout):
                await svc.submit(_req(_sym()))

    run(go())


# ==========================================================================
# transient retries and blast-radius isolation
# ==========================================================================

def test_serve_transient_fault_retries_and_recovers():
    async def go():
        async with SimulationService(cfg(backend="offload", R=1, max_wait_ms=2.0,
                                         retry_max=2, retry_base_s=0.001)) as svc:
            sym = _sym()
            clean = await svc.submit(_req(sym))
            with faults.inject(FaultPlan(seed=1).add("shard_transfer_error", count=1)) as plan:
                r = await svc.submit(_req(sym))
            assert plan.fires == {"shard_transfer_error": 1}
            assert svc.metrics.snapshot()["counters"]["retries_total"] >= 1
            assert r.amp0 == clean.amp0  # the retried run is the same answer

    run(go())


def test_serve_retry_exhaustion_yields_typed_error_service_survives():
    async def go():
        async with SimulationService(cfg(backend="offload", R=1, max_wait_ms=2.0,
                                         retry_max=1, retry_base_s=0.001)) as svc:
            sym = _sym()
            await svc.submit(_req(sym))  # warm
            with faults.inject(FaultPlan(seed=1).add("shard_transfer_error")):
                with pytest.raises(ShardTransferError):
                    await svc.submit(_req(sym))
            assert svc.metrics.counter("retries_total") == 1
            r = await svc.submit(_req(sym, scale=0.3))
            assert r.amp0 is not None

    run(go())


def test_serve_poison_rider_fails_alone():
    async def go():
        async with SimulationService(cfg(max_batch_size=8, max_wait_ms=20.0)) as svc:
            sym = _sym()
            await svc.submit(_req(sym))  # warm
            good = [svc.submit(_req(sym, scale=0.1 * (i + 1))) for i in range(2)]
            bad = svc.submit(SimRequest(circuit=sym, params=[0.1, 0.2]))
            r_good = await asyncio.gather(*good)
            with pytest.raises(ValueError, match="entries"):
                await bad
            assert all(r.amp0 is not None for r in r_good)
            counters = svc.metrics.snapshot()["counters"]
            assert counters["request_errors"] == 1
            assert counters.get("batch_errors", 0) == 0

    run(go())


def test_serve_failed_fused_batch_splits_per_member():
    """A shared sweep that fails past its retries re-executes each member
    alone, and only members that fail alone get errors."""
    async def go():
        async with SimulationService(cfg(backend="offload", R=1, max_batch_size=4,
                                         max_wait_ms=30.0, retry_max=0)) as svc:
            sym = _sym()
            await svc.submit(_req(sym))  # warm
            with faults.inject(FaultPlan(seed=2).add("shard_transfer_error", count=1)):
                resps = await asyncio.gather(*[svc.submit(_req(sym, scale=0.1 * (i + 1)))
                                               for i in range(3)])
            assert [r.batch_size for r in resps] == [3, 3, 3]
            assert svc.metrics.counter("split_batches") == 1
            assert all(r.amp0 is not None for r in resps)

    run(go())


# ==========================================================================
# the integrity guard: a NaN is recovered by a re-run of the plan
# ==========================================================================

def test_serve_nan_recovery_reruns_the_plan_with_provenance():
    async def go():
        async with SimulationService(cfg(use_kernels=True, max_wait_ms=2.0)) as svc:
            sym = _sym()
            clean = await svc.submit(_req(sym, return_state=True))
            before = ops.kernel_call_counts()
            await svc.submit(_req(sym, scale=0.2, return_state=True))
            per_run = {k: v - before[k] for k, v in ops.kernel_call_counts().items()}
            before = ops.kernel_call_counts()
            with faults.inject(FaultPlan(seed=3).add(
                    "nan_amplitudes", count=1, site="engine.run_sweep")) as plan:
                r = await svc.submit(_req(sym, return_state=True))
            retried = {k: v - before[k] for k, v in ops.kernel_call_counts().items()}
            assert plan.fires == {"nan_amplitudes": 1}
            np.testing.assert_allclose(r.state, clean.state, atol=1e-6)
            assert r.provenance["integrity_retries"] == 1
            assert r.provenance["integrity_recovered"] == 1
            # the served sweep and one re-run of the plan through the kernels
            assert sum(per_run.values()) > 0
            assert retried == {k: 2 * v for k, v in per_run.items()}
            assert svc.stats()["warm_pool"]["degraded_engines"]
            assert svc.metrics.counter("degraded_responses") == 1

    run(go())


def test_serve_verify_opt_out_passes_nan_through():
    async def go():
        async with SimulationService(cfg(max_wait_ms=2.0, verify_norm=False)) as svc:
            sym = _sym()
            await svc.submit(_req(sym, return_state=True))  # warm
            with faults.inject(FaultPlan(seed=3).add(
                    "nan_amplitudes", count=1, site="engine.run_sweep")):
                r = await svc.submit(_req(sym, return_state=True))
            assert not np.all(np.isfinite(r.state))
            assert r.provenance is None

    run(go())


def test_serve_per_request_verify_overrides_the_opt_out():
    async def go():
        async with SimulationService(cfg(max_wait_ms=2.0, verify_norm=False)) as svc:
            sym = _sym()
            clean = await svc.submit(_req(sym, return_state=True))
            with faults.inject(FaultPlan(seed=3).add(
                    "nan_amplitudes", count=1, site="engine.run_sweep")):
                r = await svc.submit(_req(sym, return_state=True, verify=True))
            np.testing.assert_allclose(r.state, clean.state, atol=1e-6)

    run(go())


# ==========================================================================
# the circuit breaker: typed build failures, quarantine, half-open
# ==========================================================================

def test_serve_breaker_quarantines_then_half_opens():
    async def go():
        c = cfg(breaker_threshold=2, breaker_ttl_s=0.25, max_wait_ms=2.0)
        async with SimulationService(c) as svc:
            sym = _sym(5)
            # a persistent compile poison defeats the one compile retry: the
            # build fails typed, twice -> the breaker opens
            with faults.inject(FaultPlan(seed=7).add("xla_trace_error",
                                                     site="compile.compile_plan")):
                for _ in range(2):
                    with pytest.raises(XlaTraceError):
                        await svc.submit(_req(sym))
                with pytest.raises(CircuitQuarantined) as ei:
                    await svc.submit(_req(sym))
            assert ei.value.failures == 2
            assert 0 < ei.value.retry_after <= c.breaker_ttl_s
            br = svc.stats()["warm_pool"]["breaker"]
            assert any(v["state"] == "open" for v in br.values())
            # TTL expiry -> half-open -> a clean build closes the breaker
            await asyncio.sleep(0.3)
            r = await svc.submit(_req(sym))
            assert r.amp0 is not None
            assert not svc.stats()["warm_pool"]["breaker"]

    run(go())


def test_serve_kernel_build_failure_is_typed_and_never_falls_back(monkeypatch):
    """A kernel that does not build (``pallas_lowering_error`` at
    ``engine.init``) fails the request typed, ``breaker_threshold`` times
    quarantines the structure with a ``retry_after``; the only engines ever
    attempted are the requested ones — the kernels, the ``cuda`` backend —
    never the plain versions or another backend."""
    seen = []
    real = teng.ExecutionEngine.__init__

    def recording(eng, circuit, plan, use_kernels=True, device=None, **kw):
        be = kw.get("backend", "cuda")
        seen.append((be if isinstance(be, str) else be.name, use_kernels))
        real(eng, circuit, plan, use_kernels, device, **kw)

    monkeypatch.setattr(teng.ExecutionEngine, "__init__", recording)

    async def go():
        c = cfg(use_kernels=True, breaker_threshold=2, breaker_ttl_s=30.0, max_wait_ms=2.0)
        async with SimulationService(c) as svc:
            sym = _sym(5)
            with faults.inject(FaultPlan(seed=2).add("pallas_lowering_error",
                                                     site="engine.init")) as plan:
                for _ in range(2):
                    with pytest.raises(PallasLoweringError) as ei:
                        await svc.submit(_req(sym))
                    assert ei.value.injected
                with pytest.raises(CircuitQuarantined) as qi:
                    await svc.submit(_req(sym))
            assert plan.fires == {"pallas_lowering_error": 2}
            assert 0 < qi.value.retry_after <= 30.0
            counters = svc.metrics.snapshot()["counters"]
            assert counters["build_failures"] == 2 and counters["breaker_opened"] == 1
            assert counters["breaker_rejects"] == 1
            assert counters.get("responses_total", 0) == 0

    run(go())
    assert seen == [("cuda", True), ("cuda", True)]


# ==========================================================================
# serve_sim front end: flags, the wire format, structured errors on a socket
# ==========================================================================

def test_serve_sim_parser_has_robustness_and_port_flags():
    from repro_torch.launch.serve_sim import build_parser, config_from_args

    cfg1 = config_from_args(build_parser().parse_args(
        ["--request-timeout", "0.5", "--no-verify-norm", "--no-kernels", "--device", "cpu",
         "--backend", "offload", "--tenant-weight", "gold=4"]))
    assert cfg1.request_timeout_s == 0.5 and cfg1.verify_norm is False
    assert cfg1.use_kernels is False and cfg1.device == "cpu" and cfg1.backend == "offload"
    assert cfg1.tenant_weights == {"gold": 4.0}
    # defaults: the card, the kernels, no deadline, the guard on
    cfg2 = config_from_args(build_parser().parse_args([]))
    assert cfg2.request_timeout_s is None and cfg2.verify_norm is True
    assert cfg2.use_kernels is True and cfg2.device == "cuda" and cfg2.backend == "cuda"
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--backend", "pjit"])


def test_request_from_json_deadline_and_verify_fields():
    from repro_torch.launch.serve_sim import request_from_json

    names = _sym().param_names
    req = request_from_json({"family": "su2param", "n": 6, "params": [0.0] * len(names),
                             "timeout": 1.5, "verify": False, "marginals": [[0, 1]]})
    assert req.deadline_s == 1.5 and req.verify is False and req.marginals == ((0, 1),)
    req2 = request_from_json({"family": "su2param", "n": 6, "params": [0.0] * len(names)})
    assert req2.deadline_s is None and req2.verify is None
    req3 = request_from_json({"circuit_json": _sym(4).bind(
        {k: 0.1 for k in _sym(4).param_names}).to_json()})
    assert req3.circuit.is_bound and req3.params is None


def test_serve_sim_handle_client_survives_malformed_input():
    from repro_torch.launch.serve_sim import handle_client

    async def go():
        svc = SimulationService(cfg(max_wait_ms=2.0))
        await svc.start()
        server = await asyncio.start_server(
            lambda r, w: handle_client(svc, r, w), "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        writer = None
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1", port)

            async def rpc(line: bytes):
                writer.write(line + b"\n")
                await writer.drain()
                return json.loads(await asyncio.wait_for(reader.readline(), timeout=30))

            r = await rpc(b"{not json")
            assert r["ok"] is False and r["error"] == "bad_json" and "rid" in r
            r = await rpc(b"[1, 2, 3]")
            assert r["ok"] is False and r["error"] == "bad_request"
            r = await rpc(json.dumps({"id": 7, "family": "nope"}).encode())
            assert r["ok"] is False and r["error"] == "bad_request"
            assert r["rid"] == 7 and r["id"] == 7
            names = _sym().param_names
            r = await rpc(json.dumps({"id": 8, "family": "su2param", "n": 6,
                                      "params": [0.0] * len(names),
                                      "timeout": -1.0}).encode())
            assert r["ok"] is False and r["error"] == "timeout" and r["rid"] == 8
            r = await rpc(json.dumps({"id": 9, "family": "su2param", "n": 6,
                                      "params": [0.1] * len(names), "shots": 16,
                                      "observables": ["Z0 Z1"]}).encode())
            assert r["ok"] is True and r["rid"] == 9
            assert sum(r["counts"].values()) == 16 and "Z0 Z1" in " ".join(r["expectations"])
            r = await rpc(json.dumps({"cmd": "stats"}).encode())
            assert r["ok"] is True and r["stats"]["counters"]["responses_total"] == 1
        finally:
            if writer is not None:
                writer.close()
            server.close()
            await server.wait_closed()
            await svc.stop()

    run(go())
