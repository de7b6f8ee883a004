"""``repro_torch.obs.trace`` -- span-based tracing with explicit context propagation.

The serving stack hops threads constantly: a query is submitted on a
caller thread, stepped on scheduler workers, fetched on executor pool
threads, and force-answered by the deadline sweeper.  ``contextvars``
do not follow those hops (pool threads are created once and reused), so
context propagation here is *explicit*: a :class:`SpanContext` is passed
as a plain parameter (``trace=...``) and used as the parent of spans
opened on other threads.

Usage::

    tracer = obs.get_tracer()
    root = tracer.start_span("query", attrs={"qid": 7})
    ...
    with tracer.span("engine.fetch", parent=root.ctx, attrs={"block": 3}):
        ...         # runs on a worker thread; still parents under `root`
    root.end()
    tracer.export_chrome("trace.json")

Sampling is decided once per *root* span (``sample_rate`` on the
tracer); children inherit the decision through their parent's context,
so a trace is always either fully recorded or fully dropped -- no
orphan children.  The event buffer is bounded; overflow increments a
drop counter rather than growing without bound.

Export is Chrome trace-event JSON (``"X"`` complete events with
``ts``/``dur`` in microseconds plus ``"M"`` thread-name metadata),
loadable directly in Perfetto (https://ui.perfetto.dev) or
``chrome://tracing``.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from collections import deque
from dataclasses import dataclass

_ids = threading.local()


def _new_id() -> int:
    # Per-thread RNG: no lock contention, seeded off urandom once per thread.
    rng = getattr(_ids, "rng", None)
    if rng is None:
        rng = _ids.rng = random.Random(int.from_bytes(os.urandom(8), "big"))
    return rng.getrandbits(63) | 1


@dataclass(frozen=True)
class SpanContext:
    """Immutable handle to a span, safe to pass across threads."""

    trace_id: int
    span_id: int
    sampled: bool = True


#: Context of an unsampled root; children of it are suppressed too.
DROPPED = SpanContext(trace_id=0, span_id=0, sampled=False)


class Span:
    """A timed operation.  ``end()`` is idempotent; usable as a context
    manager.  Unsampled spans are inert (still carry a ctx so children
    know to drop themselves)."""

    __slots__ = ("name", "ctx", "parent_id", "attrs", "_tracer", "_t0", "_tid", "_done")

    def __init__(self, name: str, ctx: SpanContext, parent_id: int,
                 attrs: dict | None, tracer: "Tracer | None"):
        self.name = name
        self.ctx = ctx
        self.parent_id = parent_id
        self.attrs = attrs
        self._tracer = tracer
        self._t0 = time.perf_counter() if tracer is not None else 0.0
        self._tid = threading.get_ident()
        self._done = False

    def set_attr(self, key: str, value) -> None:
        if self._tracer is None:
            return
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value

    def end(self) -> None:
        if self._done or self._tracer is None:
            return
        self._done = True
        self._tracer._finish(self, time.perf_counter())

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.end()


_NOOP = Span("", DROPPED, 0, None, None)


class Tracer:
    """Collects finished spans in a bounded buffer; exports Chrome JSON."""

    def __init__(self, *, sample_rate: float = 1.0, max_events: int = 200_000):
        if not 0.0 <= sample_rate <= 1.0:
            raise ValueError("sample_rate must be in [0, 1]")
        self.sample_rate = sample_rate
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=max_events)
        self._dropped = 0
        self._thread_names: dict[int, str] = {}
        self._epoch = time.perf_counter()

    # -- span lifecycle -----------------------------------------------------
    def start_span(self, name: str, *, parent: SpanContext | None = None,
                   attrs: dict | None = None) -> Span:
        """Open a span.  ``parent=None`` starts a new trace (root), which is
        where the sampling decision is made; passing a parent inherits both
        the trace id and the decision."""
        if parent is not None:
            if not parent.sampled:
                return _NOOP
            ctx = SpanContext(parent.trace_id, _new_id(), True)
            return Span(name, ctx, parent.span_id, attrs, self)
        if self.sample_rate < 1.0:
            rng = getattr(_ids, "rng", None)
            if rng is None:
                _new_id()  # seeds the per-thread rng
                rng = _ids.rng
            if rng.random() >= self.sample_rate:
                return _NOOP
        tid = _new_id()
        ctx = SpanContext(tid, _new_id(), True)
        return Span(name, ctx, 0, attrs, self)

    def span(self, name: str, *, parent: SpanContext | None = None,
             attrs: dict | None = None) -> Span:
        """Alias of :meth:`start_span`, reads better in ``with`` statements."""
        return self.start_span(name, parent=parent, attrs=attrs)

    def _finish(self, span: Span, t1: float) -> None:
        ev = (span.name, span._tid, span._t0, t1,
              span.ctx.trace_id, span.ctx.span_id, span.parent_id, span.attrs)
        with self._lock:
            if span._tid not in self._thread_names:
                # spans start and end on one thread; label it for the export
                self._thread_names[span._tid] = threading.current_thread().name
            if len(self._events) == self._events.maxlen:
                self._dropped += 1
            self._events.append(ev)

    def set_thread_name(self, name: str, tid: int | None = None) -> None:
        tid = threading.get_ident() if tid is None else tid
        with self._lock:
            self._thread_names[tid] = name

    # -- introspection / export --------------------------------------------
    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0

    def chrome_events(self) -> list[dict]:
        """Trace-event list: ``M`` thread-name metadata + ``X`` complete
        events, ts/dur in integer microseconds relative to tracer start."""
        with self._lock:
            events = list(self._events)
            names = dict(self._thread_names)
        pid = os.getpid()
        out: list[dict] = [
            {"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
             "args": {"name": label}}
            for tid, label in sorted(names.items())
        ]
        for name, tid, t0, t1, trace_id, span_id, parent_id, attrs in events:
            args = {"trace_id": f"{trace_id:x}", "span_id": f"{span_id:x}"}
            if parent_id:
                args["parent_id"] = f"{parent_id:x}"
            if attrs:
                args.update(attrs)
            out.append({
                "ph": "X",
                "name": name,
                "pid": pid,
                "tid": tid,
                "ts": round((t0 - self._epoch) * 1e6),
                "dur": max(1, round((t1 - t0) * 1e6)),
                "args": args,
            })
        return out

    def export_chrome(self, path: str | os.PathLike) -> int:
        """Write ``{"traceEvents": [...]}`` JSON; returns the event count."""
        events = self.chrome_events()
        payload = {"traceEvents": events, "displayTimeUnit": "ms"}
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, default=repr)
        os.replace(tmp, path)
        return len(events)


__all__ = ["SpanContext", "Span", "Tracer", "DROPPED"]
