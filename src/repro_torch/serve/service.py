"""Async multi-tenant simulation service.

The request path, end to end::

    submit(SimRequest)
      └─ admission: bounded FairAdmissionQueue (reject + retry_after when
         full; weighted fair order across tenants)         [queue_wait_s]
    scheduler task (asyncio)
      └─ DynamicBatcher.form: fair leader + structure-matching riders,
         flush on max-batch-size or max-wait deadline      [batch_form_s]
    worker thread (ThreadPoolExecutor, `workers` wide)
      └─ WarmPool.acquire: structural CompileCache hit -> rebind (tensor
         swap), miss -> partition+compile (admission-gated) [bind_s]
      └─ ONE run_sweep / deduplicated run per batch: every compiled op one
         hand-kernel launch over all rows                  [execute_s]
      └─ per-request measurement on the engine's device    [measure_s]
    response futures resolved on the event loop             [e2e_s]

Everything expensive is front-loaded and cached: after warmup, steady-state
load performs ZERO ILP/DP solves and schedules ZERO shm programs (the
kernels' per-group programs, :data:`repro_torch.kernels.ops.SCHEDULE_CALLS`;
``tests/test_torch_serve.py`` asserts both).

The port of ``repro/serve/service.py``. Engines run on CUDA through the
hand kernels unless the config asks for the CPU (``device="cpu"``); a
service on a machine without CUDA and without that ask raises when it is
built. There is no fallback: a kernel that does not build reaches the
breaker as its typed :class:`PallasLoweringError`, never a run on the
kernels' plain versions, another backend or the CPU.
"""

from __future__ import annotations

import asyncio
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..sim.faults import CircuitQuarantined, FaultError, RequestTimeout
from .batcher import DynamicBatcher, SimRequest, SimResponse, group_key_for
from .metrics import Metrics
from .queue import FairAdmissionQueue, QueueFull

__all__ = [
    "CircuitQuarantined", "RequestTimeout", "ServeConfig", "ServiceOverloaded",
    "ServiceStopped", "SimulationService", "WarmPool",
]


class ServiceOverloaded(Exception):
    """Admission rejected under backpressure; retry after ``retry_after``
    seconds (estimated queue drain time at the current service rate)."""

    def __init__(self, retry_after: float, depth: int):
        super().__init__(
            f"service overloaded (queue depth {depth}); retry after "
            f"{retry_after:.3f}s"
        )
        self.retry_after = retry_after
        self.depth = depth


class ServiceStopped(Exception):
    """The service shut down before this request completed."""


@dataclass
class ServeConfig:
    """Serving knobs (see README "Serving" for the tuning guide)."""

    # engine / plan
    backend: str = "cuda"  # "cuda" | "offload" | "dense"
    use_kernels: bool = True
    staging_method: str = "ilp"
    kernelize_method: str = "dp"
    dtype = torch.complex64  # the kernels' type: every engine runs complex64
    device: DeviceLike = None  # None: CUDA (raises without it); "cpu" on the host
    R: int = 0  # default architecture split for requests that don't pin one
    G: int = 0
    # batching
    max_batch_size: int = 16
    max_wait_ms: float = 4.0
    # admission
    queue_depth: int = 256
    tenant_weights: Dict[str, float] = field(default_factory=dict)
    default_weight: float = 1.0
    # execution
    workers: int = 1
    # warm pool
    cache_size: int = 16
    evict_scan: int = 4
    admit_after: int = 1  # requests of a key before its engine is pooled
    # robustness (see README "Robustness")
    request_timeout_s: Optional[float] = None  # default per-request deadline
    verify_norm: bool = True  # post-run ||psi|| =~ 1 guard (per-request verify= overrides)
    retry_max: int = 2  # transient-failure retries per execution
    retry_base_s: float = 0.01  # backoff: min(cap, base * 2^attempt) * jitter
    retry_cap_s: float = 0.25
    breaker_threshold: int = 3  # consecutive build failures -> quarantine
    breaker_ttl_s: float = 30.0  # quarantine duration (then half-open)


class WarmPool:
    """Compile-cache warm pool with per-key admission control.

    Wraps a thread-safe :class:`repro_torch.sim.engine.CompileCache`.
    Admission: a structure is only *pooled* once it has been requested
    ``admit_after`` times — a scan of one-off structures builds throwaway
    engines instead of evicting the hot set (TinyLFU-style doorkeeper;
    ``admit_after=1`` degenerates to plain insert-always LRU). Eviction
    inside the cache is frequency-aware (least-hit of the LRU tail). Per-key
    request counts and the cache's hit/miss/eviction counters feed
    :meth:`stats`.

    A per-structure **circuit breaker** guards build time: a structure whose
    engine build fails ``breaker_threshold`` consecutive times with a typed
    error (a planning failure past its rungs, a compile failure past its
    retry, a backend or kernel that does not build) is quarantined for
    ``breaker_ttl_s`` — :meth:`acquire` raises :class:`CircuitQuarantined`
    (with ``retry_after``) without touching a worker-thread build. After the
    TTL the breaker is half-open: one build attempt is let through; success
    closes it, failure re-opens for another TTL.
    """

    def __init__(self, cfg: ServeConfig, metrics: Metrics):
        from ..sim.engine import CompileCache

        self.cfg = cfg
        self.metrics = metrics
        self.device = resolve_device(cfg.device)
        self.cache = CompileCache(maxsize=cfg.cache_size,
                                  evict_scan=cfg.evict_scan)
        self._seen: Dict[str, int] = {}  # digest -> lifetime request count
        # digest -> {"failures": consecutive build failures, "open_until":
        # monotonic quarantine expiry (0 = closed)}
        self._breaker: Dict[str, Dict[str, float]] = {}
        self._lock = threading.Lock()

    def acquire(self, req: SimRequest) -> Tuple[object, bool]:
        """Engine for one batch leader: ``(engine, cache_hit)``. Runs on a
        worker thread; compile cost (miss) or rebind cost (hit with new
        angles) both land in the caller's ``bind_s`` timer. Raises
        :class:`CircuitQuarantined` while the structure's breaker is open."""
        from ..sim.engine import circuit_key_for, engine_for

        cfg = self.cfg
        key = circuit_key_for(
            req.circuit, req.L, req.R, req.G, backend=cfg.backend,
            use_kernels=cfg.use_kernels, staging_method=cfg.staging_method,
            kernelize_method=cfg.kernelize_method, device=self.device,
        )
        now = time.monotonic()
        with self._lock:
            seen = self._seen.get(key.digest, 0) + 1
            self._seen[key.digest] = seen
            br = self._breaker.get(key.digest)
            if br is not None and now < br["open_until"]:
                self.metrics.inc("breaker_rejects")
                raise CircuitQuarantined(
                    f"structure {key.digest[:12]} quarantined after "
                    f"{int(br['failures'])} consecutive build failures",
                    digest=key.digest, failures=int(br["failures"]),
                    retry_after=br["open_until"] - now)
        hit = key in self.cache
        admitted = hit or seen >= self.cfg.admit_after
        try:
            eng = engine_for(
                req.circuit, req.L, req.R, req.G, backend=cfg.backend,
                use_kernels=cfg.use_kernels, staging_method=cfg.staging_method,
                kernelize_method=cfg.kernelize_method, device=self.device,
                cache=self.cache if admitted else None,
            )
        except FaultError as e:
            self._build_failed(key.digest, e)
            raise
        with self._lock:
            self._breaker.pop(key.digest, None)  # success closes the breaker
        self.metrics.inc("cache_hits" if hit else "cache_misses")
        if not admitted:
            self.metrics.inc("cache_admission_denied")
        return eng, hit

    def _build_failed(self, digest: str, err: Exception) -> None:
        with self._lock:
            br = self._breaker.setdefault(
                digest, {"failures": 0, "open_until": 0.0})
            br["failures"] += 1
            self.metrics.inc("build_failures")
            if br["failures"] >= self.cfg.breaker_threshold:
                br["open_until"] = time.monotonic() + self.cfg.breaker_ttl_s
                self.metrics.inc("breaker_opened")

    def engines(self):
        with self.cache._lock:
            return list(self.cache._d.values())

    @staticmethod
    def shm_schedules() -> int:
        """The shm programs scheduled in this process: the work a warm
        batch must not redo (steady-state load must not move this). The
        reference counts XLA retraces here; the port has none."""
        from ..kernels import ops

        return ops.SCHEDULE_CALLS["shm"]

    def stats(self) -> Dict:
        out = self.cache.stats()
        now = time.monotonic()
        with self._lock:
            out["requests_by_key"] = {d[:12]: c for d, c in self._seen.items()}
            out["breaker"] = {
                d[:12]: {
                    "failures": int(br["failures"]),
                    "state": ("open" if now < br["open_until"]
                              else "half-open"),
                    "retry_after_s": max(0.0, br["open_until"] - now),
                }
                for d, br in self._breaker.items()
            }
        out["shm_schedules"] = self.shm_schedules()
        out["degraded_engines"] = [
            e.provenance for e in self.engines()
            if e.provenance.get("degraded") or e.provenance.get("integrity_retries")
        ]
        # per-engine wall-time aggregates + autotune outcomes, keyed by
        # truncated CircuitKey digest (matches requests_by_key)
        with self.cache._lock:
            entries = list(self.cache._d.items())
        out["engine_timings"] = {
            k.digest[:12]: e.timing_snapshot() for k, e in entries if e.timings
        }
        # autotune outcomes, pre-staging optimizer outcomes and the offload
        # shard store's summaries (resident/spilled shards, the accumulated
        # quantization error bound of the last run) of pooled engines
        for name, field_ in (("autotuned_engines", "autotune"),
                             ("optimized_engines", "optimize"),
                             ("storage_engines", "storage")):
            out[name] = {k.digest[:12]: e.provenance[field_]
                         for k, e in entries if e.provenance.get(field_)}
        return out


class SimulationService:
    """The asyncio serving loop. Use as an async context manager::

        async with SimulationService(ServeConfig(max_batch_size=16)) as svc:
            resp = await svc.submit(SimRequest(circuit=sym, params=theta))

    ``submit`` raises :class:`ServiceOverloaded` under backpressure. All
    engine work runs on a bounded worker pool off the event loop; responses
    resolve in arrival-batch order.
    """

    def __init__(self, config: Optional[ServeConfig] = None,
                 metrics: Optional[Metrics] = None):
        self.cfg = config or ServeConfig()
        self.metrics = metrics or Metrics()
        self.pool = WarmPool(self.cfg, self.metrics)
        self.queue = FairAdmissionQueue(
            capacity=self.cfg.queue_depth,
            weights=self.cfg.tenant_weights,
            default_weight=self.cfg.default_weight,
        )
        self.batcher = DynamicBatcher(
            max_batch_size=self.cfg.max_batch_size,
            max_wait_s=self.cfg.max_wait_ms / 1e3,
            retry_max=self.cfg.retry_max,
            retry_base_s=self.cfg.retry_base_s,
            retry_cap_s=self.cfg.retry_cap_s,
            verify_norm=self.cfg.verify_norm,
        )
        self._futures: Dict[int, asyncio.Future] = {}
        self._arrival: Optional[asyncio.Event] = None
        self._scheduler: Optional[asyncio.Task] = None
        self._executor: Optional[ThreadPoolExecutor] = None
        self._inflight: Optional[asyncio.Semaphore] = None
        self._stopping = False
        self._ewma_req_s = 0.01  # EWMA seconds/request -> retry_after hint

    # ---------------------------------------------------------- lifecycle
    async def start(self) -> "SimulationService":
        assert self._scheduler is None, "service already started"
        self._stopping = False
        self._arrival = asyncio.Event()
        self._executor = ThreadPoolExecutor(
            max_workers=self.cfg.workers, thread_name_prefix="sim-serve")
        self._inflight = asyncio.Semaphore(self.cfg.workers)
        self._scheduler = asyncio.create_task(self._run(), name="sim-serve-sched")
        return self

    async def stop(self, drain: bool = True) -> None:
        """Stop the loop. With ``drain`` (default) queued requests execute
        first; otherwise they fail with :class:`ServiceStopped`."""
        if self._scheduler is None:
            return
        self._stopping = True
        if not drain:
            for _, req in self.queue.drain():
                fut = self._futures.pop(req.request_id, None)
                if fut is not None and not fut.done():
                    fut.set_exception(ServiceStopped())
        self._arrival.set()
        await self._scheduler
        self._scheduler = None
        self._executor.shutdown(wait=True)

    async def __aenter__(self) -> "SimulationService":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # ------------------------------------------------------------- submit
    def _normalize(self, req: SimRequest) -> SimRequest:
        cfg = self.cfg
        n = req.circuit.n_qubits
        if req.R is None:
            req.R = cfg.R
        if req.G is None:
            req.G = cfg.G
        if req.L is None:
            req.L = n - req.R - req.G
        if req.params is None and not req.circuit.is_bound:
            raise ValueError(
                f"request {req.request_id}: circuit has free parameters "
                f"{req.circuit.param_names}; pass params="
            )
        if req.params is not None and req.circuit.is_bound:
            raise ValueError(
                f"request {req.request_id}: params given for a fully-bound "
                "circuit (submit the symbolic skeleton to coalesce)"
            )
        if req.deadline_s is None:
            req.deadline_s = cfg.request_timeout_s
        return req

    def retry_after(self) -> float:
        """Client backoff hint: estimated time to drain the current queue at
        the EWMA per-request service rate."""
        est = self.queue.depth * self._ewma_req_s + self.batcher.max_wait_s
        return min(max(est, self.batcher.max_wait_s, 1e-3), 5.0)

    async def submit(self, req: SimRequest) -> SimResponse:
        """Admit one request and await its response. Raises
        :class:`ServiceOverloaded` (with ``retry_after``) when the admission
        queue is full."""
        fut = self.submit_nowait(req)
        return await fut

    def submit_nowait(self, req: SimRequest) -> "asyncio.Future[SimResponse]":
        """Open-loop submission: admit (or reject) now, return the response
        future without awaiting it."""
        assert self._scheduler is not None, "service not started"
        if self._stopping:
            raise ServiceStopped()
        req = self._normalize(req)
        cfg = self.cfg
        key = group_key_for(
            req, backend=cfg.backend, use_kernels=cfg.use_kernels,
            staging_method=cfg.staging_method,
            kernelize_method=cfg.kernelize_method, device=self.pool.device,
        )
        self.metrics.inc("requests_total")
        req.arrival_t = time.monotonic()
        if req.deadline_s is not None:
            if req.deadline_s <= 0:
                # a non-positive deadline can never be met — reject before
                # it consumes queue capacity
                self.metrics.inc("timeouts_total")
                raise RequestTimeout(
                    f"request {req.request_id}: non-positive deadline "
                    f"{req.deadline_s}s", request_id=req.request_id,
                    deadline_s=req.deadline_s, elapsed=0.0)
            req.deadline_t = req.arrival_t + req.deadline_s
        try:
            self.queue.push(req, tenant=req.tenant, key=key)
        except QueueFull as e:
            self.metrics.inc("rejects_total")
            raise ServiceOverloaded(self.retry_after(), e.depth) from None
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._futures[req.request_id] = fut
        self._arrival.set()
        return fut

    # ---------------------------------------------------------- scheduler
    async def _run(self) -> None:
        while True:
            if len(self.queue) == 0:
                if self._stopping:
                    break
                self._arrival.clear()
                # re-check after clear: a push may have raced the clear
                if len(self.queue) == 0:
                    await self._arrival.wait()
                continue
            with self.metrics.timer("form_s"):
                batch = await self.batcher.form(
                    self.queue, self._arrival, draining=self._stopping)
            if batch is None:
                continue
            # pre-dispatch deadline check: fail already-expired requests here
            # instead of wasting a worker dispatch on them
            self._reject_expired(batch)
            if not batch.requests:
                continue
            await self._inflight.acquire()
            loop = asyncio.get_running_loop()
            t0 = time.monotonic()
            task = loop.run_in_executor(
                self._executor, self.batcher.execute,
                batch, self.pool, self.metrics)
            task.add_done_callback(
                lambda t, b=batch, t0=t0: self._deliver(t, b, t0))
        # wait for in-flight batches before returning
        for _ in range(self.cfg.workers):
            await self._inflight.acquire()

    def _reject_expired(self, batch) -> None:
        """Drop requests already past their deadline from a formed batch,
        failing their futures with :class:`RequestTimeout` (runs on the
        event loop, before worker dispatch)."""
        now = time.monotonic()
        live = []
        for r in batch.requests:
            if r.deadline_t and now >= r.deadline_t:
                self.metrics.inc("timeouts_total")
                fut = self._futures.pop(r.request_id, None)
                if fut is not None and not fut.done():
                    fut.set_exception(RequestTimeout(
                        f"request {r.request_id} missed its {r.deadline_s}s "
                        f"deadline in queue", request_id=r.request_id,
                        deadline_s=r.deadline_s, elapsed=now - r.arrival_t))
            else:
                live.append(r)
        batch.requests = live

    def _deliver(self, task, batch, t0: float) -> None:
        """Resolve response futures for one executed batch (runs on the
        event loop — run_in_executor futures call back there). The batcher
        reports per-request outcomes: a :class:`SimResponse` resolves its
        future, an :class:`Exception` (typed timeout/quarantine/integrity/
        build failure) fails only that request's future."""
        self._inflight.release()
        now = time.monotonic()
        dt = now - t0
        alpha = 0.2
        self._ewma_req_s = ((1 - alpha) * self._ewma_req_s
                            + alpha * dt / max(len(batch.requests), 1))
        exc = task.exception()
        if exc is not None:
            # infrastructure failure (a bug, not a typed per-request error):
            # fails the whole batch
            self.metrics.inc("batch_errors")
            for r in batch.requests:
                fut = self._futures.pop(r.request_id, None)
                if fut is not None and not fut.done():
                    fut.set_exception(exc)
            return
        for r, resp in task.result():
            fut = self._futures.pop(r.request_id, None)
            if isinstance(resp, Exception):
                self.metrics.inc("request_errors")
                if fut is not None and not fut.done():
                    fut.set_exception(resp)
                continue
            e2e = now - r.arrival_t
            resp.timings["e2e_s"] = e2e
            self.metrics.observe("e2e_s", e2e)
            self.metrics.inc("responses_total")
            if fut is not None and not fut.done():
                fut.set_result(resp)

    # -------------------------------------------------------------- stats
    def stats(self) -> Dict:
        """One JSON snapshot of the whole serving path: stage timers +
        latency percentiles, coalesce factor, queue/tenant state, warm-pool
        counters (with the shm programs scheduled) and solver counters."""
        from ..core import kernelization, staging

        snap = self.metrics.snapshot()
        snap["queue"] = {
            "depth": self.queue.depth,
            "capacity": self.queue.capacity,
            "tenants": self.queue.tenants(),
        }
        snap["warm_pool"] = self.pool.stats()
        snap["solver_calls"] = {
            "ilp": staging.SOLVER_CALLS["ilp"],
            "greedy": staging.SOLVER_CALLS["greedy"],
            "dp": kernelization.SOLVER_CALLS["dp"],
        }
        snap["retry_after_s"] = self.retry_after()
        # profile-guided planning provenance: which cost model this service
        # plans with on its device, tuning outcomes, and the production
        # observation ring
        from ..core.autotune import tuned_outcomes
        from ..sim.profiler import observation_summary, resolve_calibration

        snap["calibration"] = resolve_calibration(device=self.pool.device)[1]
        snap["autotune"] = tuned_outcomes()
        snap["observations"] = observation_summary()
        from ..sim import faults

        plan = faults.active()
        if plan is not None:
            snap["fault_plan"] = plan.stats()
        return snap
