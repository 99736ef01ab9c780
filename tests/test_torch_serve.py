"""The port's serving layer (``repro_torch.serve``) on the CPU, against the
JAX package's (``repro.serve``, ``tests/test_serve.py``).

* Pure-Python parts (histograms and counters, power-of-two buckets, the
  fair admission queue, the batcher's flush policies) run the same cases
  through both packages.
* The two services take the same seeded requests — the reference as
  ``backend="pjit"`` without Pallas, the port as ``backend="cuda"`` with
  ``use_kernels=False`` on ``device="cpu"`` — and must form the same batches
  and give the same answers.
* The reference's service tests are ported: the coalesced sweep equals
  sequential runs bit for bit, identical concrete requests dedup into one
  run, warm load runs no solver and schedules no shm program, a skeleton
  swap keeps adjoint programs working, ``stats()`` carries the planning
  provenance.

Tolerances: ``amp0``, states, marginals and expectations within 1e-5
(complex64 through a few dozen gates); counts and batch membership equal.

Every service here is stopped by ``async with``, every fault plan is
scoped by a context manager, and each scenario is bounded by its own
asyncio deadline.
"""

import asyncio
import time

import numpy as np
import pytest
import torch

from repro.core.generators import FAMILIES as REF_FAMILIES, PARAM_FAMILIES as REF_PARAM_FAMILIES
from repro.serve import batcher as rbatcher, metrics as rmetrics, queue as rqueue
from repro.serve import service as rservice
from repro.sim.adjoint import adjoint_gradients_np
from repro_torch.core import kernelization, staging
from repro_torch.core.circuit import Circuit
from repro_torch.core.gates import Param
from repro_torch.core.generators import FAMILIES, PARAM_FAMILIES, ghz
from repro_torch.serve import (
    ServeConfig, ServiceOverloaded, SimRequest, SimulationService, WarmPool,
)
from repro_torch.serve import batcher as tbatcher, metrics as tmetrics, queue as tqueue
from repro_torch.serve import service as tservice

N = 6  # qubits per family: real staging at L=5, R=1, and fast to plan
PKGS = {
    "repro": (rmetrics, rqueue, rbatcher),
    "repro_torch": (tmetrics, tqueue, tbatcher),
}
BOTH = pytest.mark.parametrize("pkg", sorted(PKGS))
DEADLINE_S = 60.0  # per-scenario bound: a hung service fails the test, not the run


def run(coro):
    async def bounded():
        return await asyncio.wait_for(coro, DEADLINE_S)
    return asyncio.run(bounded())


def port_config(**kw):
    base = dict(backend="cuda", use_kernels=False, device="cpu", R=1, max_batch_size=4,
                max_wait_ms=5.0, cache_size=8)
    base.update(kw)
    return ServeConfig(**base)


def _solves():
    return (staging.SOLVER_CALLS["ilp"], staging.SOLVER_CALLS["greedy"],
            kernelization.SOLVER_CALLS["dp"])


# ==========================================================================
# metrics, buckets, queue, batcher: the same cases through both packages
# ==========================================================================

@BOTH
def test_histogram_percentiles(pkg):
    h = PKGS[pkg][0].Histogram()
    for i in range(1, 101):  # 1ms .. 100ms, uniform
        h.observe(0.001 * i)
    assert h.count == 100
    assert h.min == pytest.approx(0.001) and h.max == pytest.approx(0.1)
    assert 0.038 <= h.percentile(0.50) <= 0.065
    assert 0.080 <= h.percentile(0.99) <= 0.125
    assert h.percentile(0.5) <= h.percentile(0.95) <= h.percentile(0.99)
    snap = h.snapshot()
    assert snap["count"] == 100 and snap["mean"] == pytest.approx(0.0505)
    assert PKGS[pkg][0].Histogram().percentile(0.5) == 0.0


def test_histograms_agree_bucket_for_bucket():
    rng = np.random.default_rng(0)
    vals = np.exp(rng.uniform(np.log(1e-7), np.log(1e3), 500))
    a, b = rmetrics.Histogram(), tmetrics.Histogram()
    for v in vals:
        a.observe(float(v))
        b.observe(float(v))
    assert a.counts == b.counts and a.snapshot() == b.snapshot()


@BOTH
def test_metrics_counters_timers_info_and_derived_ratios(pkg):
    m = PKGS[pkg][0].Metrics()
    m.inc("batches_total", 4)
    m.inc("requests_executed", 32)
    m.inc("responses_total", 30)
    m.inc("rejects_total", 2)
    with m.timer("execute_s") as t:
        pass
    assert t.elapsed >= 0.0
    assert m.counter("missing") == 0.0
    m.set_info("autotune", [{"chosen": "default"}])
    m.merge_counters({"hits": 3, "note": "text"})
    snap = m.snapshot()
    assert snap["coalesce_factor"] == pytest.approx(8.0)
    assert snap["reject_rate"] == pytest.approx(2 / 32)
    assert snap["timers"]["execute_s"]["count"] == 1
    assert snap["info"]["autotune"][0]["chosen"] == "default"
    assert snap["counters"]["hits"] == 3.0 and "note" not in snap["counters"]
    assert "info" not in PKGS[pkg][0].Metrics().snapshot()


@BOTH
def test_bucket_size_pads_to_pow2_capped(pkg):
    bucket_size = PKGS[pkg][2].bucket_size
    assert [bucket_size(p, 16) for p in (1, 2, 3, 4, 5, 8, 9, 16)] \
        == [1, 2, 4, 4, 8, 8, 16, 16]
    assert bucket_size(5, 6) == 6
    with pytest.raises(AssertionError):
        bucket_size(17, 16)


@BOTH
def test_queue_backpressure_at_capacity(pkg):
    q = PKGS[pkg][1].FairAdmissionQueue(capacity=2)
    q.push("a", tenant="t", key="K")
    q.push("b", tenant="t", key="K")
    with pytest.raises(PKGS[pkg][1].QueueFull) as ei:
        q.push("c", tenant="t", key="K")
    assert ei.value.depth == 2 and ei.value.capacity == 2
    assert len(q) == 2


@BOTH
def test_queue_fair_interleave_under_flood(pkg):
    q = PKGS[pkg][1].FairAdmissionQueue(capacity=64)
    for i in range(8):
        q.push(f"h{i}", tenant="hot", key="K")
    for i in range(2):
        q.push(f"l{i}", tenant="light", key="K")
    order = [q.pop_fair()[1] for _ in range(10)]
    assert {"l0", "l1"} <= set(order[:4])
    assert order[:1] == ["h0"]
    assert q.pop_fair() is None


@BOTH
def test_queue_weighted_fairness(pkg):
    q = PKGS[pkg][1].FairAdmissionQueue(capacity=64, weights={"light": 4.0})
    for i in range(8):
        q.push(f"h{i}", tenant="hot", key="K")
    for i in range(4):
        q.push(f"l{i}", tenant="light", key="K")
    order = [q.pop_fair()[1] for _ in range(6)]
    assert order[1:5] == ["l0", "l1", "l2", "l3"]
    q.set_weight("hot", 8.0)
    assert q.tenants() == {"hot": 6}


@BOTH
def test_queue_take_matching_harvests_only_key(pkg):
    q = PKGS[pkg][1].FairAdmissionQueue(capacity=16)
    q.push("a1", tenant="t0", key="A")
    q.push("b1", tenant="t0", key="B")
    q.push("a2", tenant="t1", key="A")
    q.push("a3", tenant="t0", key="A")
    assert q.take_matching("A", 0) == []
    got = q.take_matching("A", 2)
    assert len(got) == 2 and set(got) <= {"a1", "a2", "a3"}
    assert q.depth == 2
    assert len(q.take_matching("A", 8)) == 1
    assert q.pop_fair()[1] == "b1"
    assert q.tenants() == {}


def test_queue_matches_reference_on_a_random_trace():
    """A seeded trace of pushes, fair pops, harvests and weight changes
    gives the same items in the same order from both queues."""
    rng = np.random.default_rng(11)
    qs = [mod.FairAdmissionQueue(capacity=24, weights={"t0": 3.0}) for mod in (rqueue, tqueue)]
    outs = [[], []]
    for step in range(400):
        op = rng.integers(4)
        tenant, key = f"t{rng.integers(3)}", "AB"[rng.integers(2)]
        k = int(rng.integers(4))
        for q, out, mod in zip(qs, outs, (rqueue, tqueue)):
            if op == 0:
                try:
                    q.push(step, tenant=tenant, key=key)
                    out.append(("push", step))
                except mod.QueueFull as e:
                    out.append(("full", e.depth))
            elif op == 1:
                out.append(("pop", q.pop_fair()))
            elif op == 2:
                out.append(("take", q.take_matching(key, k)))
            else:
                q.set_weight(tenant, 0.5 + k)
            out.append(("depth", q.depth, q.tenants()))
    assert outs[0] == outs[1]
    assert qs[0].drain() == qs[1].drain()


def _mkreq(pkg, arrival):
    circuit = REF_FAMILIES["ghz"](2) if pkg == "repro" else ghz(2)
    r = PKGS[pkg][2].SimRequest(circuit=circuit)
    r.arrival_t = arrival
    return r


@BOTH
def test_batcher_deadline_flush(pkg):
    _, mq, mb = PKGS[pkg]

    async def go():
        q = mq.FairAdmissionQueue(capacity=16)
        b = mb.DynamicBatcher(max_batch_size=8, max_wait_s=0.03)
        now = time.monotonic()
        for _ in range(3):
            q.push(_mkreq(pkg, now), tenant="t", key="K")
        t0 = time.monotonic()
        batch = await b.form(q, asyncio.Event())
        assert batch.flush_reason == "deadline"
        assert len(batch.requests) == 3 and q.depth == 0
        assert time.monotonic() - t0 >= 0.015  # waited out the window
        assert all(r.picked_t >= now for r in batch.requests)
    run(go())


@BOTH
def test_batcher_size_flush_leaves_overflow_queued(pkg):
    _, mq, mb = PKGS[pkg]

    async def go():
        q = mq.FairAdmissionQueue(capacity=16)
        b = mb.DynamicBatcher(max_batch_size=4, max_wait_s=5.0)
        now = time.monotonic()
        for i in range(6):
            q.push(_mkreq(pkg, now), tenant=f"t{i % 2}", key="K")
        batch = await b.form(q, asyncio.Event())
        assert batch.flush_reason == "size"
        assert len(batch.requests) == 4 and q.depth == 2
    run(go())


@BOTH
def test_batcher_stale_leader_flushes_immediately(pkg):
    """The deadline anchors at the leader's ARRIVAL: a leader that sat out
    its wait in a backlog flushes with whatever riders exist, without a
    fresh wait (the window here is 2 s; the bound 1 s)."""
    _, mq, mb = PKGS[pkg]

    async def go():
        q = mq.FairAdmissionQueue(capacity=16)
        b = mb.DynamicBatcher(max_batch_size=8, max_wait_s=2.0)
        stale = time.monotonic() - 5.0
        q.push(_mkreq(pkg, stale), tenant="t", key="K")
        q.push(_mkreq(pkg, stale), tenant="t", key="K")
        t0 = time.monotonic()
        batch = await b.form(q, asyncio.Event())
        assert batch.flush_reason == "deadline"
        assert len(batch.requests) == 2
        assert time.monotonic() - t0 < 1.0
    run(go())


@BOTH
def test_batcher_harvests_only_matching_key_and_drains(pkg):
    _, mq, mb = PKGS[pkg]

    async def go():
        q = mq.FairAdmissionQueue(capacity=16)
        b = mb.DynamicBatcher(max_batch_size=8, max_wait_s=0.02)
        now = time.monotonic()
        q.push(_mkreq(pkg, now), tenant="a", key="K")
        q.push(_mkreq(pkg, now), tenant="a", key="J")
        q.push(_mkreq(pkg, now), tenant="b", key="K")
        batch = await b.form(q, asyncio.Event())
        assert len(batch.requests) == 2 and q.depth == 1
        batch = await b.form(q, asyncio.Event(), draining=True)
        assert batch.flush_reason == "drain" and len(batch.requests) == 1
    run(go())


@BOTH
def test_effective_verify_overrides(pkg):
    mb = PKGS[pkg][2]
    on, off = mb.DynamicBatcher(verify_norm=True), mb.DynamicBatcher(verify_norm=False)

    def reqs(*flags):
        out = []
        for f in flags:
            r = _mkreq(pkg, 0.0)
            r.verify = f
            out.append(r)
        return out

    assert on._effective_verify(reqs(None, None)) is True
    assert off._effective_verify(reqs(None, None)) is False
    assert off._effective_verify(reqs(None, True)) is True
    assert on._effective_verify(reqs(False, False)) is False
    assert on._effective_verify(reqs(False, None)) is True


# ==========================================================================
# keys, normalization, the warm pool, the device
# ==========================================================================

def test_group_key_structure_vs_binding():
    sym = PARAM_FAMILIES["su2param"](N)
    names = sym.param_names
    kw = dict(backend="cuda", use_kernels=True, staging_method="ilp", kernelize_method="dp",
              device="cpu")
    mk = lambda **a: SimRequest(L=N - 1, R=1, G=0, **a)  # noqa: E731
    k = len(names)
    g1 = tbatcher.group_key_for(mk(circuit=sym, params=np.zeros(k)), **kw)
    g2 = tbatcher.group_key_for(mk(circuit=sym, params=np.ones(k)), **kw)
    assert g1 == g2 and g1.binding is None
    p0, p1 = dict(zip(names, np.zeros(k))), dict(zip(names, np.ones(k)))
    c1 = tbatcher.group_key_for(mk(circuit=sym.bind(p0)), **kw)
    c2 = tbatcher.group_key_for(mk(circuit=sym.bind(p0)), **kw)
    c3 = tbatcher.group_key_for(mk(circuit=sym.bind(p1)), **kw)
    assert c1 == c2 and c1.binding is not None
    assert c1 != c3 and c1.digest == c3.digest
    s1 = tbatcher.group_key_for(mk(circuit=sym, params=np.zeros(k), shots=64), **kw)
    assert s1 != g1 and not s1.wants_state
    # the plain versions and the kernels never share an engine, nor two devices
    assert tbatcher.group_key_for(mk(circuit=sym, params=np.zeros(k)),
                                  **dict(kw, use_kernels=False)).digest != g1.digest
    assert tbatcher.group_key_for(mk(circuit=sym, params=np.zeros(k)),
                                  **dict(kw, device="cuda:0")).digest != g1.digest


def test_normalize_rejects_inconsistent_binding():
    svc = SimulationService(port_config(R=0))
    sym = PARAM_FAMILIES["su2param"](N)
    names = sym.param_names
    with pytest.raises(ValueError, match="free parameters"):
        svc._normalize(SimRequest(circuit=sym))
    bound = sym.bind(dict(zip(names, np.zeros(len(names)))))
    with pytest.raises(ValueError, match="fully-bound"):
        svc._normalize(SimRequest(circuit=bound, params=np.zeros(len(names))))
    r = svc._normalize(SimRequest(circuit=sym, params=np.zeros(len(names))))
    assert (r.L, r.R, r.G) == (N, 0, 0)


def test_warm_pool_admission_doorkeeper():
    """admit_after=2: the first request of a structure builds a throwaway
    engine (never pooled); the second pools it; the third hits."""
    from repro_torch.serve.metrics import Metrics

    pool = WarmPool(port_config(admit_after=2, cache_size=4), Metrics())
    sym = PARAM_FAMILIES["isingparam"](N)
    req = SimRequest(circuit=sym, params=np.zeros(2), L=N, R=0, G=0)
    e1, hit1 = pool.acquire(req)
    assert not hit1 and len(pool.cache) == 0
    assert pool.metrics.counter("cache_admission_denied") == 1
    e2, hit2 = pool.acquire(req)
    assert not hit2 and len(pool.cache) == 1 and e2 is not e1
    e3, hit3 = pool.acquire(req)
    assert hit3 and e3 is e2
    st = pool.stats()
    assert st["shm_schedules"] == WarmPool.shm_schedules() >= 0
    assert st["requests_by_key"] and st["breaker"] == {}


def test_service_runs_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    """The default config is the card: without CUDA the service refuses to
    start instead of carrying on on the CPU; ``device="cpu"`` is the ask."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ServeConfig().device is None and ServeConfig().use_kernels
    assert ServeConfig().backend == "cuda" and ServeConfig.dtype == torch.complex64
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SimulationService(ServeConfig())
    assert SimulationService(ServeConfig(device="cpu")).pool.device.type == "cpu"


# ==========================================================================
# the port's service against the reference's, on the same requests
# ==========================================================================

def _traffic(ref: bool):
    """Seeded mixed traffic: two parameterized families (some requests
    measured with shots, marginals and observables, some digest-only),
    three identical concrete qft requests, three tenants."""
    fams = REF_PARAM_FAMILIES if ref else PARAM_FAMILIES
    qft = (REF_FAMILIES if ref else FAMILIES)["qft"](N)
    mk = rbatcher.SimRequest if ref else SimRequest
    rng = np.random.default_rng(5)
    reqs = []
    for i in range(14):
        sym = fams[("su2param", "isingparam")[i % 2]](N)
        params = rng.uniform(0.1, 6.2, len(sym.param_names))
        measured = i % 3 != 2
        reqs.append(mk(
            circuit=sym, params=params, tenant=f"t{i % 3}", seed=i,
            shots=128 if i % 4 == 0 else 0,
            marginals=((0, 2),) if measured else (),
            observables=("Z0 Z1 + 0.5*X2", "Y3 X5 - 0.25*Z4") if measured else ()))
    for i in range(3):
        reqs.append(mk(circuit=qft, tenant=f"t{i}"))
    return reqs


async def _serve_recorded(svc, reqs):
    """Submit every request before the scheduler runs (so batch formation
    depends only on the queue), record each executed batch's members by
    their position in ``reqs``."""
    index = {}
    batches = []
    execute = svc.batcher.execute

    def recording(batch, pool, metrics):
        batches.append([index[r.request_id] for r in batch.requests])
        return execute(batch, pool, metrics)

    svc.batcher.execute = recording
    async with svc:
        futs = []
        for i, r in enumerate(reqs):
            futs.append(svc.submit_nowait(r))
            index[r.request_id] = i
        resps = await asyncio.gather(*futs)
    return batches, resps


def test_service_matches_reference_batches_and_answers():
    ref_svc = rservice.SimulationService(rservice.ServeConfig(
        backend="pjit", use_pallas=False, R=1, max_batch_size=4, max_wait_ms=5.0,
        cache_size=8))
    port_svc = SimulationService(port_config())
    ref_batches, ref_resps = run(_serve_recorded(ref_svc, _traffic(ref=True)))
    batches, resps = run(_serve_recorded(port_svc, _traffic(ref=False)))
    assert batches == ref_batches
    assert max(len(b) for b in batches) == 4
    assert [14, 15, 16] in [sorted(b) for b in batches]  # the qft dedup group
    for i, (got, want) in enumerate(zip(resps, ref_resps)):
        assert got.batch_size == want.batch_size, i
        assert (got.amp0 is None) == (want.amp0 is None), i
        if want.amp0 is not None:
            assert abs(got.amp0 - want.amp0) < 1e-5, i
        assert (got.result is None) == (want.result is None), i
        if want.result is None:
            continue
        assert set(got.result.expectations) == set(want.result.expectations)
        for k, v in want.result.expectations.items():
            assert abs(got.result.expectations[k] - v) < 1e-5, (i, k)
        for q, m in want.result.marginals.items():
            np.testing.assert_allclose(got.result.marginals[q], m, atol=1e-5)
        if want.result.samples is not None:
            assert got.result.counts() == want.result.counts(), i
    st, rst = port_svc.stats(), ref_svc.stats()
    for k in ("batches_total", "requests_executed", "responses_total", "flush_size",
              "flush_deadline", "cache_hits", "cache_misses"):
        assert st["counters"].get(k) == rst["counters"].get(k), k
    assert st["counters"]["sweep_rows"] - st["counters"]["sweep_rows_padding"] \
        == 14 + 1  # every parameterized request's row, and the one dedup run


# ==========================================================================
# the reference's service tests, on the port
# ==========================================================================

def _fams():
    return [(name, PARAM_FAMILIES[name](N)) for name in ("su2param", "isingparam")]


def _engine(svc, sym):
    req = svc._normalize(SimRequest(circuit=sym, params=np.zeros(len(sym.param_names))))
    eng, _ = svc.pool.acquire(req)
    return eng


def test_oracle_coalesced_bit_identical_to_sequential():
    """The serving oracle: rows of coalesced batches are bit for bit the
    states of sequential ``bind(point); run()`` on the same warm engine."""
    svc = SimulationService(port_config(max_batch_size=8, max_wait_ms=20.0))
    fams = _fams()

    async def go():
        async with svc:
            rng = np.random.default_rng(3)
            reqs = [SimRequest(circuit=fams[i % 2][1], tenant=f"t{i % 3}",
                               params=rng.uniform(0.1, 6.2, len(fams[i % 2][1].param_names)),
                               return_state=True) for i in range(12)]
            resps = await asyncio.gather(*[svc.submit(r) for r in reqs])
            assert max(r.batch_size for r in resps) >= 2
            for i, (req, resp) in enumerate(zip(reqs, resps)):
                sym = fams[i % 2][1]
                eng = _engine(svc, sym)
                with eng.lock:
                    eng.bind(dict(zip(sym.param_names, np.asarray(req.params))))
                    ref = eng.run(None).numpy().reshape(-1)
                assert resp.state.shape == ref.shape
                assert np.array_equal(resp.state, ref), f"request {i}: coalesced != sequential"
                assert resp.amp0 == complex(ref[0])
    run(go())


def test_dedup_identical_concrete_requests_share_one_run():
    svc = SimulationService(port_config(max_batch_size=8, max_wait_ms=20.0))
    sym = PARAM_FAMILIES["su2param"](N)
    pt = dict(zip(sym.param_names, np.linspace(0.2, 1.7, len(sym.param_names))))
    bound = sym.bind(pt)

    async def go():
        async with svc:
            reqs = [SimRequest(circuit=bound, tenant=f"t{i % 2}", return_state=True)
                    for i in range(5)]
            resps = await asyncio.gather(*[svc.submit(r) for r in reqs])
            assert all(r.batch_size == 5 for r in resps)
            for r in resps[1:]:
                assert np.array_equal(r.state, resps[0].state)
            eng = _engine(svc, sym)
            with eng.lock:
                eng.bind(pt)
                ref = eng.run(None).numpy().reshape(-1)
            assert np.array_equal(resps[0].state, ref)
            assert svc.metrics.counter("sweep_rows") == 1  # ONE run for five requests
    run(go())


def test_serving_steady_state_zero_solves_zero_shm_schedules():
    """Mixed families and tenants under load: after one warm wave, no ILP or
    DP solve, no shm program scheduled, every acquire a cache hit."""
    svc = SimulationService(port_config(max_batch_size=8, max_wait_ms=6.0))
    fams = _fams()

    async def go():
        async with svc:
            rng = np.random.default_rng(5)

            async def wave():
                reqs = [SimRequest(circuit=fams[i % 2][1], tenant=f"t{i % 4}",
                                   params=rng.uniform(0.1, 6.2,
                                                      len(fams[i % 2][1].param_names)))
                        for i in range(16)]
                return await asyncio.gather(*[svc.submit(r) for r in reqs])

            await wave()
            s0, sched0 = _solves(), WarmPool.shm_schedules()
            misses = svc.metrics.counter("cache_misses")
            for _ in range(2):
                resps = await wave()
                assert all(r.amp0 is not None and r.result is None for r in resps)
                assert all(r.cache_hit for r in resps)
            assert _solves() == s0, "steady-state serving re-solved ILP/DP"
            assert WarmPool.shm_schedules() == sched0, "steady state scheduled an shm program"
            assert svc.metrics.counter("cache_misses") == misses == 2
            st = svc.stats()
            assert st["coalesce_factor"] > 1.0
            assert st["queue"]["depth"] == 0
            assert st["warm_pool"]["size"] == 2
            assert st["warm_pool"]["shm_schedules"] == sched0
            assert st["solver_calls"]["ilp"] == s0[0]
            assert st["counters"]["responses_total"] == 48
    run(go())


def test_backpressure_rejects_with_retry_after():
    svc = SimulationService(port_config(max_batch_size=8, queue_depth=16))
    sym = PARAM_FAMILIES["isingparam"](N)

    async def go():
        async with svc:
            futs = [svc.submit_nowait(SimRequest(circuit=sym, params=np.zeros(2)))
                    for _ in range(16)]
            with pytest.raises(ServiceOverloaded) as ei:
                svc.submit_nowait(SimRequest(circuit=sym, params=np.zeros(2)))
            assert ei.value.depth == 16 and 0 < ei.value.retry_after <= 5.0
            resps = await asyncio.gather(*futs)
            assert len(resps) == 16 and all(r.amp0 is not None for r in resps)
            assert svc.metrics.counter("rejects_total") == 1
            assert svc.metrics.counter("flush_size") >= 1
    run(go())


def _skeleton(prefix: str, n: int = 4) -> Circuit:
    c = Circuit(n)
    for q in range(n):
        c.add("ry", q, params=[Param(f"{prefix}{q}")])
    for q in range(n - 1):
        c.add("cx", q + 1, q)
    for q in range(n):
        c.add("rz", q, params=[Param(f"{prefix}{q + n}")])
    return c


def test_skeleton_swap_after_an_adjoint_program_keeps_gradients_working():
    """A batch whose leader carries another skeleton of a pooled structure
    (other Param names) makes the engine adopt it and drop the adjoint
    programs wired to the old names; the engine's gradient machinery still
    works under the new names, against the complex128 oracle."""
    from repro.core.circuit import Circuit as RefCircuit

    svc = SimulationService(port_config(R=0))
    eng = _engine(svc, _skeleton("t"))
    vals_t = {f"t{q}": 0.1 * (q + 1) for q in range(8)}
    eng.bind(vals_t)
    eng.adjoint_program("Z0 Z1")
    assert len(eng._adjoint_progs) == 1
    req = svc._normalize(SimRequest(circuit=_skeleton("b"), params=np.zeros(8)))
    same, hit = svc.pool.acquire(req)
    assert same is eng and hit
    tbatcher.DynamicBatcher._ensure_binding(eng, req)
    assert eng.circuit.param_names == tuple(f"b{q}" for q in range(8))
    assert eng._adjoint_progs == {}
    vals_b = {f"b{q}": 0.3 + 0.05 * q for q in range(8)}
    value, grad = eng.value_and_grad("Z0 Z1", params=vals_b)
    ref = RefCircuit.from_json(_skeleton("b").to_json())
    want_v, want_g = adjoint_gradients_np(ref, vals_b, "Z0 Z1")
    assert abs(value - want_v) < 1e-5
    np.testing.assert_allclose(grad, want_g, atol=1e-5)
    assert eng.adjoint_builds == 2


def test_service_stats_expose_planning_provenance():
    async def go():
        async with SimulationService(port_config(R=0)) as svc:
            await svc.submit(SimRequest(circuit=FAMILIES["qft"](N)))
            return svc.stats()

    stats = run(go())
    assert stats["calibration"]["source"] in (
        "analytic", "calibrated", "disabled", "mismatch", "version_mismatch", "error")
    assert isinstance(stats["autotune"], list)
    assert stats["observations"]["run"]["count"] >= 1
    assert stats["warm_pool"]["engine_timings"]
    assert "fault_plan" not in stats
    assert {"ilp", "greedy", "dp"} <= set(stats["solver_calls"])


def test_serve_sim_demo_on_the_cpu(capsys):
    from repro_torch.launch.serve_sim import main

    stats = main(["--demo", "--device", "cpu", "--no-kernels", "--requests", "12",
                  "--families", "isingparam:5,su2param:5", "--max-batch", "4",
                  "--max-wait-ms", "5", "--shots", "16"])
    out = capsys.readouterr().out
    assert out.startswith("demo: 12 responses (0 rejected)")
    assert stats["counters"]["responses_total"] == 12
    assert stats["warm_pool"]["size"] == 2
