"""``repro_torch.obs`` -- in-process telemetry for the RSP stack.

Three pillars, all zero-dependency and thread-safe, and the ranges that
mark the program's hot paths for them and for the torch profiler:

* **metrics** (:mod:`repro_torch.obs.metrics`) -- counters / gauges /
  exponential-bucket histograms in a label-set registry, exportable as
  JSON and Prometheus text format.
* **tracing** (:mod:`repro_torch.obs.trace`) -- spans with *explicit* context
  propagation across executor / scheduler / sweeper threads, exported
  as Chrome trace-event JSON (open in Perfetto).
* **convergence** (:mod:`repro_torch.obs.convergence`) -- per-query
  error-vs-blocks trajectories surfaced on ``QueryResult.trace``.
* **ranges** (:mod:`repro_torch.obs.ranges`) -- ``with obs.range(name):``
  around a stretch of the training step or the models: a
  ``record_function`` range while a torch profiler records, a tracer span
  while telemetry is on, and a shared no-op after two flag reads when
  neither is.

Telemetry is **off by default**: the hot paths check :func:`enabled`
(a plain bool read) and skip all metric/span work when off.  Turn it on
per process::

    from repro_torch import obs
    obs.enable(sample_rate=0.1)        # sample 10% of query traces
    ...
    print(obs.get_registry().to_prometheus())
    obs.get_tracer().export_chrome("trace.json")

or via the environment: ``REPRO_OBS=1`` (optionally
``REPRO_OBS_SAMPLE=0.1``) enables it at import time.

Component-owned registries (e.g. ``QueryService.registry``) are always
live regardless of :func:`enabled` -- they back public accounting APIs
(``QueryService.metrics()``), not optional telemetry.
"""

from __future__ import annotations

import os
import threading

from .convergence import ConvergenceStep, ConvergenceTrace
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .ranges import NO_RANGE, Range, profiling
from .trace import DROPPED, Span, SpanContext, Tracer

_lock = threading.Lock()
_enabled = False
_registry = MetricsRegistry()
_tracer = Tracer()


def enabled() -> bool:
    """Cheap hot-path check: is process-global telemetry on?"""
    return _enabled


def enable(*, sample_rate: float = 1.0) -> None:
    """Turn on global telemetry; ``sample_rate`` applies to new root spans."""
    global _enabled
    with _lock:
        _tracer.sample_rate = float(sample_rate)
        _enabled = True


def disable() -> None:
    global _enabled
    with _lock:
        _enabled = False


def range(name: str):
    """A context manager marking ``name`` for the recorders that are on: a
    ``record_function`` range while a torch profiler records, a span of
    the process tracer (the child of the thread's enclosing range) while
    telemetry is on, and :data:`NO_RANGE` when neither is."""
    record = profiling()
    if not (record or _enabled):
        return NO_RANGE
    return Range(name, record, _tracer if _enabled else None)


def get_registry() -> MetricsRegistry:
    """The process-global metrics registry (hot-path instrumentation)."""
    return _registry


def get_tracer() -> Tracer:
    """The process-global tracer."""
    return _tracer


def reset() -> None:
    """Drop all recorded telemetry and disable.  Intended for tests and
    benchmark phase boundaries; instrument handles cached by components
    become stale, so components re-resolve them lazily."""
    global _enabled, _registry, _tracer
    with _lock:
        _enabled = False
        _registry = MetricsRegistry()
        _tracer = Tracer()


def _init_from_env() -> None:
    raw = os.environ.get("REPRO_OBS", "").strip().lower()
    if raw in ("1", "true", "on", "yes"):
        rate = float(os.environ.get("REPRO_OBS_SAMPLE", "1.0"))
        enable(sample_rate=rate)


_init_from_env()

__all__ = [
    "ConvergenceStep",
    "ConvergenceTrace",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Span",
    "SpanContext",
    "Tracer",
    "DROPPED",
    "NO_RANGE",
    "enabled",
    "enable",
    "range",
    "disable",
    "get_registry",
    "get_tracer",
    "reset",
]
