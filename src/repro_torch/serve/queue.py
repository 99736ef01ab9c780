"""Bounded admission queue with per-tenant weighted fair scheduling.

(Copied from ``repro/serve/queue.py`` so this package imports nothing of
the JAX package; only this note differs.)

The serving loop's contention point: when batch execution falls behind the
arrival rate, requests back up here. Two policies govern the backlog:

* **Backpressure.** Total depth is bounded; :meth:`FairAdmissionQueue.push`
  raises :class:`QueueFull` when at capacity and the caller surfaces a
  reject-with-retry-after to the client instead of letting latency grow
  without bound (the open-loop half of ``bench_serve`` drives the queue past
  capacity on purpose).
* **Weighted fair dequeue (stride scheduling).** Each tenant owns a FIFO
  lane with a virtual *pass*; dequeues pick the non-empty lane with the
  smallest pass and charge it ``1/weight``. A hot tenant that floods the
  queue therefore only ages its own lane — a light tenant's next request
  stays near the global virtual time and is picked almost immediately. Lanes
  (re)activate at the current virtual time so an idle tenant cannot hoard
  credit and later monopolize the scheduler.

The queue itself is synchronous and lock-free by construction: the asyncio
service owns it from the event-loop thread only (worker threads never touch
it). It is deliberately decoupled from asyncio so the unit tests can drive
deadline/fairness interleavings deterministically.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, Hashable, List, Optional, Tuple


class QueueFull(Exception):
    """Admission rejected: the bounded queue is at capacity.

    Carries the observed depth so the service can translate it into a
    client-facing ``retry_after`` hint (depth / drain rate).
    """

    def __init__(self, depth: int, capacity: int):
        super().__init__(f"admission queue full ({depth}/{capacity})")
        self.depth = depth
        self.capacity = capacity


@dataclass
class _Lane:
    weight: float
    vpass: float  # virtual pass: advanced by 1/weight per dequeued item
    items: deque = field(default_factory=deque)  # (key, item) FIFO


class FairAdmissionQueue:
    """Bounded multi-tenant queue: FIFO within a tenant, weighted-fair
    across tenants, with same-key harvesting for the dynamic batcher."""

    def __init__(
        self,
        capacity: int = 256,
        weights: Optional[Dict[str, float]] = None,
        default_weight: float = 1.0,
    ):
        assert capacity >= 1
        self.capacity = capacity
        self.default_weight = default_weight
        self._weights = dict(weights or {})
        self._lanes: Dict[str, _Lane] = {}
        self._depth = 0
        self._vtime = 0.0  # global virtual time = pass of the last dequeue

    # ------------------------------------------------------------- admission
    def __len__(self) -> int:
        return self._depth

    @property
    def depth(self) -> int:
        return self._depth

    def set_weight(self, tenant: str, weight: float) -> None:
        self._weights[tenant] = weight
        lane = self._lanes.get(tenant)
        if lane is not None:
            lane.weight = weight

    def push(self, item, *, tenant: str, key: Hashable) -> None:
        """Admit one request; raises :class:`QueueFull` at capacity."""
        if self._depth >= self.capacity:
            raise QueueFull(self._depth, self.capacity)
        lane = self._lanes.get(tenant)
        if lane is None:
            lane = self._lanes[tenant] = _Lane(
                weight=self._weights.get(tenant, self.default_weight),
                vpass=self._vtime,
            )
        elif not lane.items:
            # lane re-activates at the current virtual time: no credit
            # hoarding across idle periods (min() also forgives a lane that
            # ran far ahead and then went idle)
            lane.vpass = max(lane.vpass, self._vtime)
        lane.items.append((key, item))
        self._depth += 1

    # -------------------------------------------------------------- dequeue
    def _charge(self, lane: _Lane) -> None:
        lane.vpass += 1.0 / max(lane.weight, 1e-9)
        self._vtime = max(self._vtime, min(
            (ln.vpass for ln in self._lanes.values() if ln.items),
            default=lane.vpass,
        ))

    def pop_fair(self) -> Optional[Tuple[Hashable, object]]:
        """Dequeue the head of the lowest-pass non-empty lane (the batch
        *leader*); returns ``(key, item)`` or None when empty."""
        best = None
        for lane in self._lanes.values():
            if lane.items and (best is None or lane.vpass < best.vpass):
                best = lane
        if best is None:
            return None
        key, item = best.items.popleft()
        self._depth -= 1
        self._charge(best)
        return key, item

    def take_matching(self, key: Hashable, k: int) -> List[object]:
        """Harvest up to ``k`` queued requests with the same group key, in
        fair-lane order (lowest pass first, FIFO within a lane). Each taken
        request charges its own tenant's stride — riding along in a batch is
        still consumption. This is the coalescing grab: structure-compatible
        requests from ANY tenant share the leader's engine call."""
        out: List[object] = []
        if k <= 0:
            return out
        lanes = sorted(
            (ln for ln in self._lanes.values() if ln.items),
            key=lambda ln: ln.vpass,
        )
        for lane in lanes:
            if len(out) >= k:
                break
            kept = deque()
            while lane.items and len(out) < k:
                item_key, item = lane.items.popleft()
                if item_key == key:
                    out.append(item)
                    self._depth -= 1
                    self._charge(lane)
                else:
                    kept.append((item_key, item))
            kept.extend(lane.items)
            lane.items = kept
        return out

    def drain(self) -> List[Tuple[Hashable, object]]:
        """Remove and return everything (service shutdown)."""
        out = []
        while True:
            nxt = self.pop_fair()
            if nxt is None:
                return out
            out.append(nxt)

    def tenants(self) -> Dict[str, int]:
        return {t: len(ln.items) for t, ln in self._lanes.items() if ln.items}
