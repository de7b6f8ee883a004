"""Deadline-aware round-robin step scheduler for progressive queries.

A progressive query is a sequence of cheap one-block steps (fetch one block
through the shared engine, fold it, re-emit the anytime estimate).  Running
each query to completion on its own thread would let one heavy tenant (large
``max_blocks``, tight ``target_rel_err``) monopolize the engine while light
queries wait whole-query times.  Instead the scheduler owns a small worker
pool and interleaves *steps*:

* Runnable tasks sit in one heap ordered by ``(deadline, enqueue seq)`` --
  earliest deadline first, FIFO among equal (and among deadline-less)
  deadlines.  After each step a task re-enqueues at the *tail* of its
  deadline class, so equal-urgency tenants round-robin one block at a time
  and a heavy query cannot starve the others.
* The step callback returns ``True`` to re-enqueue (more blocks wanted) or
  ``False`` when the task is finished (converged, exhausted, cancelled,
  deadline fired); the scheduler never inspects task internals beyond the
  optional ``deadline`` attribute (a ``time.monotonic`` instant).
* A task is owned by at most one worker at a time: it is either in the heap
  or being stepped, never both, so step callbacks need no internal locking
  against themselves.

The scheduler is generic over the task object; ``repro_torch.serve.query_service``
plugs in query runs.  ``close()`` stops the workers, then calls the step
function's ``on_drop`` hook for every task still in the heap so owners can
finalize (cancel) them.
"""

from __future__ import annotations

import heapq
import itertools
import math
import threading
from typing import Any, Callable


class StepScheduler:
    """Interleaves one-step work items across a bounded worker pool.

    ``step``: callable ``(task) -> bool`` -- run one step, return whether
    the task wants more.  ``on_drop``: called for tasks discarded at
    ``close()`` without a final step.
    """

    def __init__(
        self,
        step: Callable[[Any], bool],
        *,
        workers: int = 4,
        on_drop: Callable[[Any], None] | None = None,
        name: str = "rsp-serve",
    ):
        if workers < 1:
            raise ValueError("workers must be >= 1")
        self._step = step
        self._on_drop = on_drop
        self._cv = threading.Condition()
        self._heap: list[tuple[float, int, Any]] = []
        self._seq = itertools.count()
        self._closed = False
        self._idle_workers = 0
        self._threads = [
            threading.Thread(target=self._loop, name=f"{name}-{i}", daemon=True)
            for i in range(workers)
        ]
        for t in self._threads:
            t.start()

    # -- submission --------------------------------------------------------
    def submit(self, task: Any) -> None:
        """Enqueue ``task`` for its next step.  Priority: its ``deadline``
        attribute (monotonic seconds; ``None`` sorts last), then FIFO."""
        if not self._push(task):
            raise RuntimeError("scheduler is closed")

    def _push(self, task: Any) -> bool:
        deadline = getattr(task, "deadline", None)
        key = math.inf if deadline is None else float(deadline)
        with self._cv:
            if self._closed:
                return False
            heapq.heappush(self._heap, (key, next(self._seq), task))
            self._cv.notify()
            return True

    @property
    def pending(self) -> int:
        with self._cv:
            return len(self._heap)

    def idle(self) -> bool:
        """True when no task is queued or being stepped (used by tests)."""
        with self._cv:
            return not self._heap and self._idle_workers == len(self._threads)

    # -- worker loop -------------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._cv:
                self._idle_workers += 1
                while not self._heap and not self._closed:
                    self._cv.wait()
                self._idle_workers -= 1
                if self._closed:
                    return
                _, _, task = heapq.heappop(self._heap)
            try:
                again = self._step(task)
            except Exception:  # noqa: BLE001 -- a step must never kill a worker
                again = False
            if again and not self._push(task):
                # closed mid-step: hand the task to the drop hook instead
                if self._on_drop is not None:
                    self._on_drop(task)

    # -- lifecycle ---------------------------------------------------------
    def close(self, *, timeout: float = 5.0) -> None:
        """Stop the workers (finishing their current step), then drop every
        still-queued task through ``on_drop``."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=timeout)
        with self._cv:
            dropped = [task for _, _, task in self._heap]
            self._heap.clear()
        if self._on_drop is not None:
            for task in dropped:
                self._on_drop(task)

    def __enter__(self) -> "StepScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
