"""Admission control for the concurrent RSP query service.

The shared :class:`~repro_torch.rsp.engine.BlockExecutor` has a bounded worker
pool and a finite block cache: past a point, admitting one more progressive
query does not add throughput, it just queues fetches inside the engine and
inflates every tenant's latency.  The admission controller keeps that
pressure *outside* the engine, where it can be measured and refused:

* Every progressive query carries a **cost** in fetch slots -- the number of
  block fetches it keeps in flight while streaming (``prefetch + 1`` under
  the engine's pipelined ``map_blocks``).
* ``capacity`` bounds the total cost of *admitted* (running) queries.
  Submissions beyond capacity are **queued** FIFO, up to ``max_queue``;
  beyond that they are **rejected** immediately (the caller sees
  :class:`AdmissionRejected` rather than an unbounded queue).
* Sketch-only queries never reach admission: their cost is zero block
  fetches, so the service short-circuits them before this layer.

``release`` returns the queued entries that fit into the freed capacity so
the service can hand them to the scheduler; all state transitions are under
one lock and safe for concurrent submitters.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Any, Callable


class AdmissionRejected(RuntimeError):
    """Raised (or recorded on the ticket) when the service is saturated:
    in-flight demand is at capacity and the wait queue is full."""


@dataclasses.dataclass(frozen=True)
class AdmissionSnapshot:
    """Point-in-time admission state: admitted cost vs capacity, queue
    depth, and the running reject counter."""

    capacity: int
    in_flight: int
    queued: int
    admitted_total: int
    rejected_total: int


class AdmissionController:
    """Capacity-bounded admit/queue/reject gate over opaque work items.

    ``try_admit(item, cost)`` returns ``"admit"`` (capacity reserved),
    ``"queue"`` (held FIFO until released capacity fits it), or ``"reject"``.
    ``release(cost)`` frees capacity and returns the newly admitted queued
    items, in order.  ``drop(item)`` removes a queued item (cancellation)
    without charging capacity.
    """

    def __init__(self, capacity: int, *, max_queue: int | None = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1 fetch slot")
        if max_queue is not None and max_queue < 0:
            raise ValueError("max_queue must be >= 0 (None = unbounded)")
        self.capacity = int(capacity)
        self.max_queue = max_queue
        self._lock = threading.Lock()
        self._in_flight = 0
        self._queue: collections.deque[tuple[Any, int]] = collections.deque()
        self._admitted_total = 0
        self._rejected_total = 0

    def try_admit(self, item: Any, cost: int) -> str:
        """Admit, queue, or reject ``item`` needing ``cost`` fetch slots.

        A cost above ``capacity`` is clamped to it (a single over-wide query
        must still be runnable on an idle service, at full capacity).
        """
        cost = min(max(1, int(cost)), self.capacity)
        with self._lock:
            if self._in_flight + cost <= self.capacity and not self._queue:
                self._in_flight += cost
                self._admitted_total += 1
                return "admit"
            if self.max_queue is None or len(self._queue) < self.max_queue:
                self._queue.append((item, cost))
                return "queue"
            self._rejected_total += 1
            return "reject"

    def release(self, cost: int) -> list[Any]:
        """Free ``cost`` slots; admit and return queued items that now fit
        (FIFO -- a wide queued query at the head blocks narrower ones behind
        it, preserving submission fairness)."""
        cost = min(max(1, int(cost)), self.capacity)
        admitted: list[Any] = []
        with self._lock:
            self._in_flight -= cost
            if self._in_flight < 0:  # defensive: double release is a bug
                self._in_flight = 0
            while self._queue:
                item, c = self._queue[0]
                if self._in_flight + c > self.capacity:
                    break
                self._queue.popleft()
                self._in_flight += c
                self._admitted_total += 1
                admitted.append(item)
        return admitted

    def drop(self, item: Any) -> bool:
        """Remove a still-queued item (cancellation before admission)."""
        with self._lock:
            for entry in self._queue:
                if entry[0] is item:
                    self._queue.remove(entry)
                    return True
        return False

    def drain(self, predicate: Callable[[Any], bool] | None = None) -> list[Any]:
        """Remove and return queued items (optionally only those matching
        ``predicate``); used at service shutdown."""
        with self._lock:
            if predicate is None:
                items = [item for item, _ in self._queue]
                self._queue.clear()
                return items
            keep: collections.deque[tuple[Any, int]] = collections.deque()
            out = []
            for item, c in self._queue:
                (out.append(item) if predicate(item) else keep.append((item, c)))
            self._queue = keep
            return out

    def snapshot(self) -> AdmissionSnapshot:
        with self._lock:
            return AdmissionSnapshot(
                capacity=self.capacity,
                in_flight=self._in_flight,
                queued=len(self._queue),
                admitted_total=self._admitted_total,
                rejected_total=self._rejected_total,
            )
