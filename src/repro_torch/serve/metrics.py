"""Lightweight serving metrics: counters, per-stage timers, latency
histograms — one JSON-able snapshot for the whole request path.

(Copied from ``repro/serve/metrics.py`` so this package imports nothing of
the JAX package; only this note and the pointer to the reference's load
harness differ.)

The serving loop is instrumented at every stage boundary (queue-wait,
batch-form, bind/acquire, execute, measure, end-to-end) and the load harness
of the reference (``benchmarks/bench_serve.py``) asserts throughput/tail-latency off the same
snapshot the service itself exposes — there is no second bookkeeping path.

Design constraints:

* **Thread-safe.** Batch execution runs in worker threads while the asyncio
  loop keeps admitting requests; every mutation takes the registry lock (the
  histograms are a few adds — contention is negligible next to an engine
  call).
* **Bounded memory.** Latency distributions are log-bucketed histograms
  (fixed bucket count), not reservoirs: p50/p95/p99 come from bucket
  interpolation with a relative error bounded by the bucket growth factor
  (~8% at the default 96 buckets over 1us..100s), which is plenty to compare
  serving configurations.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, Iterable, Optional


class Histogram:
    """Log-bucketed scalar distribution with percentile estimation.

    Values are clamped into ``[lo, hi]``; bucket edges are geometric so the
    same instance resolves microsecond engine calls and multi-second cold
    compiles. ``percentile`` returns the geometric midpoint of the bucket
    holding the requested rank (exact min/max are tracked separately).
    """

    def __init__(self, lo: float = 1e-6, hi: float = 100.0, n_buckets: int = 96):
        assert hi > lo > 0 and n_buckets >= 2
        self.lo, self.hi, self.n = lo, hi, n_buckets
        self._log_lo = math.log(lo)
        self._scale = n_buckets / (math.log(hi) - self._log_lo)
        self.counts = [0] * n_buckets
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def _bucket(self, v: float) -> int:
        if v <= self.lo:
            return 0
        if v >= self.hi:
            return self.n - 1
        return min(self.n - 1, int((math.log(v) - self._log_lo) * self._scale))

    def _edge(self, i: int) -> float:
        return math.exp(self._log_lo + i / self._scale)

    def observe(self, v: float) -> None:
        self.counts[self._bucket(v)] += 1
        self.count += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def percentile(self, q: float) -> float:
        """q in [0, 1]; 0.0 with no observations."""
        if not self.count:
            return 0.0
        rank = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                return math.sqrt(self._edge(i) * self._edge(i + 1))
        return self.max or 0.0

    def snapshot(self) -> Dict:
        return {
            "count": self.count,
            "sum": self.total,
            "mean": self.total / self.count if self.count else 0.0,
            "min": self.min or 0.0,
            "max": self.max or 0.0,
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
        }


class _Timer:
    """Context manager that records elapsed wall time into a histogram."""

    def __init__(self, metrics: "Metrics", name: str):
        self._metrics = metrics
        self._name = name
        self.elapsed = 0.0

    def __enter__(self) -> "_Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = time.perf_counter() - self._t0
        self._metrics.observe(self._name, self.elapsed)


class Metrics:
    """Named counters + histograms behind one lock, one JSON snapshot.

    Counters are plain floats (``inc``); distributions are
    :class:`Histogram` (``observe``/``timer``). Names are created on first
    touch so call sites stay declaration-free.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._hists: Dict[str, Histogram] = {}
        self._info: Dict[str, object] = {}

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            h.observe(value)

    def timer(self, name: str) -> _Timer:
        return _Timer(self, name)

    def set_info(self, name: str, value) -> None:
        """Attach a structured JSON-able blob (autotune outcomes, calibration
        provenance, ...) surfaced verbatim under ``snapshot()["info"]``."""
        with self._lock:
            self._info[name] = value

    def hist(self, name: str) -> Optional[Histogram]:
        with self._lock:
            return self._hists.get(name)

    def percentile(self, name: str, q: float) -> float:
        with self._lock:
            h = self._hists.get(name)
        return h.percentile(q) if h is not None else 0.0

    def snapshot(self) -> Dict:
        """One JSON-able dict: ``{"counters": {...}, "timers": {name:
        {count,sum,mean,min,max,p50,p95,p99}}}`` plus derived serving ratios
        when their inputs exist (coalesce factor, cache hit rate)."""
        with self._lock:
            out = {
                "counters": dict(self._counters),
                "timers": {k: h.snapshot() for k, h in self._hists.items()},
            }
            if self._info:
                out["info"] = dict(self._info)
        c = out["counters"]
        batches = c.get("batches_total", 0.0)
        coalesced = c.get("requests_executed", 0.0)
        if batches:
            out["coalesce_factor"] = coalesced / batches
        served = c.get("responses_total", 0.0) + c.get("rejects_total", 0.0)
        if served:
            out["reject_rate"] = c.get("rejects_total", 0.0) / served
        return out

    def merge_counters(self, items: Iterable) -> None:
        """Fold an external counter dict (e.g. cache stats) into this
        registry under their own names."""
        for k, v in dict(items).items():
            if isinstance(v, (int, float)):
                with self._lock:
                    self._counters[k] = float(v)
