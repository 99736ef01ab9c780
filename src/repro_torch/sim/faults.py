"""Deterministic fault injection + the typed failure taxonomy.

(Copied from ``repro/sim/faults.py`` so this package imports nothing of the
JAX package; only imports differ.)

Atlas-style long-running partitioned simulation has a wide failure surface:
the staging ILP can stall or go infeasible, the DP kernelizer can blow up,
XLA tracing / pallas lowering can fail on a new structure, host<->device
shard streaming can drop a transfer, and a numerically poisoned circuit can
return NaN amplitudes. This module makes every one of those failure modes
*reproducible*:

* a seeded :class:`FaultPlan` holds :class:`FaultSpec` entries keyed by
  **named injection points** (:data:`POINTS`); probes placed at the real
  call sites (``core/staging.py``, ``core/kernelization.py``,
  ``sim/compile.py``, ``sim/engine.py`` incl. the offload backend) fire the
  matching *typed* error — the same error class a real failure raises, so
  the degradation ladder, the serving retry loop and the circuit breaker
  exercise one code path for injected and organic failures alike;
* injection is **off by default and zero-cost when off**: every hot-path
  probe is guarded by a single module-global ``None`` check
  (``faults._ACTIVE is not None``) before any function call happens;
* firing is **deterministic**: a plan with the same seed and the same probe
  sequence fires at the same probes (``rate`` draws come from the plan's
  private ``random.Random``; ``count``/``after`` are plain counters), so a
  chaos test failure reproduces from its seed.

Activation is per-process and thread-visible (the serving worker pool must
see a plan activated from the test thread), via :func:`inject`::

    with faults.inject(FaultPlan(seed=7).add("ilp_timeout")):
        engine_for(...)   # staging ILP raises StagingError -> greedy fallback

Stdlib-only on purpose: ``repro.core`` modules import this without touching
jax/numpy or creating an import cycle (``repro/sim`` is a namespace package).
"""

from __future__ import annotations

import random
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple


# ======================================================================
# Typed error taxonomy
# ======================================================================


class FaultError(Exception):
    """Base of the typed failure taxonomy.

    ``injected`` marks errors raised by the fault-injection subsystem (real
    failures raise the same classes with ``injected=False``); ``retry_after``
    (seconds, optional) is a client backoff hint carried by errors where a
    retry can plausibly succeed."""

    def __init__(self, msg: str = "", *, injected: bool = False,
                 retry_after: Optional[float] = None):
        super().__init__(msg)
        self.injected = injected
        self.retry_after = retry_after


class StagingError(FaultError):
    """ILP staging failed: solver exception, timeout, or no feasible staging.
    The degradation ladder falls back to ``stage_greedy``."""


class KernelizationError(FaultError):
    """DP kernelization failed; the ladder falls back to greedy packing."""


class BackendBuildError(FaultError):
    """Backend construction failed (placement/mesh/device mismatch, trace
    failure). The ladder falls down the backend chain
    (shard_map -> pjit -> dense)."""


class XlaTraceError(BackendBuildError):
    """XLA tracing/compilation failed while building a stage executable."""


class PallasLoweringError(BackendBuildError):
    """Pallas kernel lowering failed; the ladder retries the same backend
    with ``use_pallas=False`` before walking the backend chain."""


class ShardTransferError(FaultError):
    """A host<->device shard transfer failed mid-stream. Transient by
    nature: the serving layer retries with exponential backoff."""


class SpillIOError(ShardTransferError):
    """A disk-tier spill write or reload failed mid-run (tiered shard
    store). Subclasses :class:`ShardTransferError` so the serving retry
    loop treats it as transient; spill writes are atomic (tmp+rename), so
    a failed spill can abort a run but never corrupt an at-rest shard."""


class StorageToleranceError(FaultError):
    """The tiered shard store's accumulated quantization error bound
    exceeded the configured tolerance — the run's result would be less
    accurate than the storage config promises. Not transient: retrying
    the same config re-accumulates the same error; pick a wider tolerance
    or a higher-precision at-rest dtype."""


class IntegrityError(FaultError):
    """The post-run ||psi|| =~ 1 guard failed AND the dense-oracle retry
    also failed — the result is numerically poisoned, not recoverable."""


class RequestTimeout(FaultError):
    """A serving request missed its deadline — rejected before batching,
    before dispatch, or on the worker, whichever notices first. Never raised
    after useful work completed for the request."""

    def __init__(self, msg: str = "", *, request_id: Optional[int] = None,
                 deadline_s: Optional[float] = None,
                 elapsed: Optional[float] = None, **kw):
        super().__init__(msg, **kw)
        self.request_id = request_id
        self.deadline_s = deadline_s
        self.elapsed = elapsed


class CircuitQuarantined(FaultError):
    """The warm pool's per-structure circuit breaker is open: this circuit
    structure failed to build ``failures`` consecutive times and is
    quarantined until the TTL expires (``retry_after`` seconds), protecting
    the service from burning worker time on a poison structure."""

    def __init__(self, msg: str = "", *, digest: str = "", failures: int = 0,
                 **kw):
        super().__init__(msg, **kw)
        self.digest = digest
        self.failures = failures


#: Errors the serving retry loop treats as transient (retry w/ backoff).
TRANSIENT_ERRORS: Tuple[type, ...] = (ShardTransferError,)


# ======================================================================
# Injection points
# ======================================================================

POINTS = (
    "ilp_timeout",           # core/staging.stage_ilp -> StagingError
    "dp_solve_error",        # core/kernelization.kernelize -> KernelizationError
    "xla_trace_error",       # sim/compile.compile_plan + backend setup -> XlaTraceError
    "pallas_lowering_error",  # engine init w/ use_pallas -> PallasLoweringError
    "shard_transfer_error",  # offload shard streaming -> ShardTransferError
    "spill_io_error",        # shard_store disk spill/reload -> SpillIOError
    "nan_amplitudes",        # post-run state corruption (no exception)
    "slow_stage",            # injected latency (no exception)
)

_ERROR_FOR = {
    "ilp_timeout": StagingError,
    "dp_solve_error": KernelizationError,
    "xla_trace_error": XlaTraceError,
    "pallas_lowering_error": PallasLoweringError,
    "shard_transfer_error": ShardTransferError,
    "spill_io_error": SpillIOError,
}


class FaultSpec:
    """One injection rule: fire ``point`` with probability ``rate`` at each
    matching probe, skipping the first ``after`` probes, at most ``count``
    times total (``count=-1``: unlimited). ``site`` (substring match)
    restricts firing to probes whose site label contains it. ``delay_s`` is
    the sleep injected by ``slow_stage``."""

    __slots__ = ("point", "rate", "count", "after", "delay_s", "site",
                 "probed", "fired")

    def __init__(self, point: str, rate: float = 1.0, count: int = -1,
                 after: int = 0, delay_s: float = 0.0, site: str = ""):
        if point not in POINTS:
            raise ValueError(f"unknown injection point {point!r}; "
                             f"pick from {POINTS}")
        self.point = point
        self.rate = float(rate)
        self.count = int(count)
        self.after = int(after)
        self.delay_s = float(delay_s)
        self.site = site
        self.probed = 0  # matching probes seen
        self.fired = 0   # times actually fired

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"FaultSpec({self.point!r}, rate={self.rate}, "
                f"count={self.count}, after={self.after}, "
                f"site={self.site!r}, fired={self.fired}/{self.probed})")


class FaultPlan:
    """A seeded set of :class:`FaultSpec` rules plus firing bookkeeping.

    Thread-safe: probes may come from serving worker threads while the plan
    was built and activated on the main thread."""

    def __init__(self, seed: int = 0, specs: Optional[List[FaultSpec]] = None):
        self.seed = seed
        self.specs: List[FaultSpec] = list(specs or [])
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.fires: Dict[str, int] = {}  # point -> total fires (telemetry)

    def add(self, point: str, *, rate: float = 1.0, count: int = -1,
            after: int = 0, delay_s: float = 0.0, site: str = "") -> "FaultPlan":
        self.specs.append(FaultSpec(point, rate=rate, count=count,
                                    after=after, delay_s=delay_s, site=site))
        return self

    @classmethod
    def from_spec(cls, text: str, seed: int = 0) -> "FaultPlan":
        """Parse ``"point:key=val:key=val;point2:..."`` (e.g. the bench
        ``--chaos`` CLI / env shorthand):
        ``"nan_amplitudes:rate=0.05;slow_stage:rate=0.1:delay_s=0.002"``."""
        plan = cls(seed=seed)
        for chunk in text.split(";"):
            chunk = chunk.strip()
            if not chunk:
                continue
            parts = chunk.split(":")
            kw: Dict[str, object] = {}
            for p in parts[1:]:
                k, _, v = p.partition("=")
                k = k.strip()
                if k == "site":
                    kw[k] = v.strip()
                elif k in ("count", "after"):
                    kw[k] = int(v)
                elif k in ("rate", "delay_s"):
                    kw[k] = float(v)
                else:
                    raise ValueError(f"unknown fault spec key {k!r} in {chunk!r}")
            plan.add(parts[0].strip(), **kw)  # type: ignore[arg-type]
        return plan

    def poll(self, point: str, site: str = "") -> Optional[FaultSpec]:
        """Record one probe at ``(point, site)`` and return the spec that
        fires, or None. Deterministic given the seed + probe sequence."""
        hit = None
        with self._lock:
            for spec in self.specs:
                if spec.point != point:
                    continue
                if spec.site and spec.site not in site:
                    continue
                spec.probed += 1
                if spec.probed <= spec.after:
                    continue
                if 0 <= spec.count <= spec.fired:
                    continue
                if spec.rate < 1.0 and self._rng.random() >= spec.rate:
                    continue
                spec.fired += 1
                self.fires[point] = self.fires.get(point, 0) + 1
                hit = spec
                break
        return hit

    def stats(self) -> Dict:
        with self._lock:
            return {
                "seed": self.seed,
                "fires": dict(self.fires),
                "specs": [
                    {"point": s.point, "rate": s.rate, "count": s.count,
                     "after": s.after, "site": s.site,
                     "probed": s.probed, "fired": s.fired}
                    for s in self.specs
                ],
            }


# ======================================================================
# Process-global activation
# ======================================================================

#: The active plan, or None (the default). Hot-path call sites guard with
#: ``if faults._ACTIVE is not None`` so the disabled cost is one attribute
#: load + identity check — no function call, no allocation.
_ACTIVE: Optional[FaultPlan] = None


def active() -> Optional[FaultPlan]:
    return _ACTIVE


def activate(plan: Optional[FaultPlan]) -> None:
    global _ACTIVE
    _ACTIVE = plan


def deactivate() -> None:
    activate(None)


@contextmanager
def inject(plan: FaultPlan):
    """Activate ``plan`` for the dynamic extent of the block (process-global,
    visible to worker threads). Restores the previous plan on exit."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = plan
    try:
        yield plan
    finally:
        _ACTIVE = prev


def maybe_inject(point: str, site: str = "") -> None:
    """The probe: no-op unless a plan is active and a spec fires.

    Error points raise their typed error (``injected=True``); ``slow_stage``
    sleeps ``delay_s``; ``nan_amplitudes`` is state corruption, not an
    exception — poll it via :func:`should_corrupt` instead."""
    plan = _ACTIVE
    if plan is None:
        return
    spec = plan.poll(point, site)
    if spec is None:
        return
    if point == "slow_stage":
        if spec.delay_s > 0:
            time.sleep(spec.delay_s)
        return
    if point == "nan_amplitudes":
        return  # corruption is applied by the caller via should_corrupt
    raise _ERROR_FOR[point](
        f"injected {point} at {site or '<unsited>'} "
        f"(seed={plan.seed}, fire #{spec.fired})",
        injected=True,
    )


def should_corrupt(site: str = "") -> bool:
    """Poll the ``nan_amplitudes`` point: True when the caller should poison
    its freshly computed state (the post-run integrity guard's test vector)."""
    plan = _ACTIVE
    if plan is None:
        return False
    return plan.poll("nan_amplitudes", site) is not None
