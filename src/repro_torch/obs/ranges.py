"""``repro_torch.obs.ranges`` -- named ranges inside the program's hot paths.

``with obs.range("train.forward"):`` marks a stretch of host code for
whichever recorder is on:

* a torch profiler that is recording: a ``record_function`` range, so the
  device work launched inside it is attributed to it on the profiler's
  timeline;
* process telemetry (:func:`repro_torch.obs.enabled`): a span of the
  process tracer, the child of the range open around it on the same
  thread.  Opened first and closed last, the span encloses the profiler's
  range, and both are stamped on one clock (``obs.trace``).

With neither on, :func:`repro_torch.obs.range` returns the shared
:data:`NO_RANGE` after two flag reads: it opens nothing and allocates
nothing.  torch is never imported here: the profiler's flag is read from
``torch.autograd.profiler`` once the program has loaded it.
"""

from __future__ import annotations

import sys
import threading

_open = threading.local()      # .stack: the contexts of this thread's open spans
_profiler = None               # torch.autograd.profiler, once loaded


class _NoRange:
    """The range of a process with no recorder on: does nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


NO_RANGE = _NoRange()


def profiling() -> bool:
    """Whether a torch profiler is recording (False before torch loads)."""
    global _profiler
    mod = _profiler
    if mod is None:
        mod = sys.modules.get("torch.autograd.profiler")
        if mod is None:
            return False
        _profiler = mod
    return mod._is_profiler_enabled


class Range:
    """A range with at least one recorder on: a ``record_function`` when
    ``record``, a span of ``tracer`` when given."""

    __slots__ = ("name", "record", "tracer", "_fn", "_span")

    def __init__(self, name: str, record: bool, tracer):
        self.name, self.record, self.tracer = name, record, tracer
        self._fn = self._span = None

    def __enter__(self) -> "Range":
        if self.tracer is not None:
            stack = getattr(_open, "stack", None)
            if stack is None:
                stack = _open.stack = []
            self._span = self.tracer.start_span(self.name, parent=stack[-1] if stack else None)
            stack.append(self._span.ctx)
        if self.record:
            self._fn = _profiler.record_function(self.name)
            self._fn.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._fn is not None:
            self._fn.__exit__(*exc)
        if self._span is not None:
            _open.stack.pop()
            self._span.end()


__all__ = ["NO_RANGE", "Range", "profiling"]
