"""``repro_torch.obs.metrics`` -- a zero-dependency in-process metrics registry.

Three instrument kinds, all thread-safe and allocation-light on the hot
path:

* :class:`Counter` -- monotonically increasing total (``inc``).
* :class:`Gauge` -- last-written value (``set`` / ``add``).
* :class:`Histogram` -- exponential-bucket latency/size distribution
  (``observe``); buckets are ``start * factor**i`` upper bounds plus one
  overflow bucket, with running ``sum`` / ``count`` so means and
  bucket-interpolated quantiles come for free.

A :class:`MetricsRegistry` groups instruments into *families* keyed by
metric name; each family holds one child per label set, so
``registry.counter("rsp_engine_fetch_total", outcome="hit")`` and
``...(outcome="miss")`` are two children of one family.  Handles are
get-or-create and stable -- resolve them once at init and call ``inc`` /
``observe`` in the hot path (a single lock + add).

Snapshots export two ways:

* :meth:`MetricsRegistry.to_json` -- nested dict/JSON for artifacts and
  tests.
* :meth:`MetricsRegistry.to_prometheus` -- Prometheus text exposition
  format (``# TYPE`` headers, ``_bucket{le=...}`` cumulative histogram
  series), ready for a scrape endpoint or textfile collector.

The registry never touches the filesystem or network and has no
dependencies; it is safe to instantiate per component (``QueryService``
owns one) as well as use the process-global one from ``repro_torch.obs``.
"""

from __future__ import annotations

import bisect
import json
import math
import threading
from typing import Iterator

_KINDS = ("counter", "gauge", "histogram")


def _label_key(labels: dict[str, str]) -> tuple[tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _render_labels(key: tuple[tuple[str, str], ...]) -> str:
    if not key:
        return ""
    body = ",".join(f'{k}="{_escape(v)}"' for k, v in key)
    return "{" + body + "}"


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class Counter:
    """Monotonic total.  ``inc`` is the only mutator."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-written value (plus ``add`` for up/down adjustments)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def add(self, amount: float) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Exponential-bucket histogram.

    Bucket ``i`` counts observations ``<= start * factor**i``; one overflow
    bucket catches the rest.  The defaults (1 us .. ~67 s at factor 2)
    cover every latency in the repo; pass ``start``/``factor``/``buckets``
    for other domains (e.g. row counts).
    """

    __slots__ = ("_lock", "bounds", "counts", "_sum", "_count")

    def __init__(self, *, start: float = 1e-6, factor: float = 2.0, buckets: int = 26):
        if start <= 0 or factor <= 1.0 or buckets < 1:
            raise ValueError("need start > 0, factor > 1, buckets >= 1")
        self._lock = threading.Lock()
        self.bounds = [start * factor**i for i in range(buckets)]
        self.counts = [0] * (buckets + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self.counts[i] += 1
            self._sum += value
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else math.nan

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile estimate (upper bound of the bucket
        holding the ``q``-th observation; NaN when empty)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("q must be in [0, 1]")
        with self._lock:
            total = self._count
            counts = list(self.counts)
        if total == 0:
            return math.nan
        rank = q * total
        seen = 0
        for i, c in enumerate(counts):
            seen += c
            if seen >= rank and c > 0:
                return self.bounds[i] if i < len(self.bounds) else math.inf
        return math.inf

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "count": self._count,
                "sum": self._sum,
                "buckets": dict(zip([*self.bounds, math.inf], self.counts)),
            }


class _Family:
    """One metric name: kind + help text + one child per label set."""

    __slots__ = ("name", "kind", "help", "children", "_hist_kwargs")

    def __init__(self, name: str, kind: str, help: str, hist_kwargs: dict):
        self.name = name
        self.kind = kind
        self.help = help
        self.children: dict[tuple[tuple[str, str], ...], Counter | Gauge | Histogram] = {}
        self._hist_kwargs = hist_kwargs

    def child(self, key: tuple[tuple[str, str], ...]):
        c = self.children.get(key)
        if c is None:
            if self.kind == "counter":
                c = Counter()
            elif self.kind == "gauge":
                c = Gauge()
            else:
                c = Histogram(**self._hist_kwargs)
            self.children[key] = c
        return c


class MetricsRegistry:
    """Thread-safe family registry; see module docstring."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    # -- instrument handles -------------------------------------------------
    def _get(self, name: str, kind: str, help: str, labels: dict, hist_kwargs: dict):
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, kind, help, hist_kwargs)
                self._families[name] = fam
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}, not {kind}"
                )
            return fam.child(key)

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(name, "counter", help, labels, {})

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(name, "gauge", help, labels, {})

    def histogram(
        self,
        name: str,
        help: str = "",
        *,
        start: float = 1e-6,
        factor: float = 2.0,
        buckets: int = 26,
        **labels,
    ) -> Histogram:
        return self._get(
            name, "histogram", help, labels,
            {"start": start, "factor": factor, "buckets": buckets},
        )

    # -- introspection / export --------------------------------------------
    def _iter(self) -> Iterator[tuple[_Family, tuple, Counter | Gauge | Histogram]]:
        with self._lock:
            fams = [
                (f, list(f.children.items()))
                for f in self._families.values()
            ]
        for fam, children in fams:
            for key, child in children:
                yield fam, key, child

    def snapshot(self) -> dict:
        """Nested plain-python snapshot: ``{name: {kind, help, series:
        [{labels, value|hist}]}}``."""
        out: dict = {}
        for fam, key, child in self._iter():
            entry = out.setdefault(
                fam.name, {"kind": fam.kind, "help": fam.help, "series": []}
            )
            rec: dict = {"labels": dict(key)}
            if fam.kind == "histogram":
                rec.update(child.snapshot())
            else:
                rec["value"] = child.value
            entry["series"].append(rec)
        return out

    def to_json(self, indent: int | None = None) -> str:
        def _default(o):
            return repr(o)

        snap = self.snapshot()
        # histogram bucket keys are floats (inf included); stringify for JSON
        for fam in snap.values():
            if fam["kind"] != "histogram":
                continue
            for s in fam["series"]:
                s["buckets"] = {
                    ("+Inf" if math.isinf(le) else repr(le)): c
                    for le, c in s["buckets"].items()
                }
        return json.dumps(snap, indent=indent, sort_keys=True, default=_default)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (one scrape payload)."""
        lines: list[str] = []
        by_fam: dict[str, list[tuple[tuple, Counter | Gauge | Histogram]]] = {}
        kinds: dict[str, _Family] = {}
        for fam, key, child in self._iter():
            by_fam.setdefault(fam.name, []).append((key, child))
            kinds[fam.name] = fam
        for name in sorted(by_fam):
            fam = kinds[name]
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for key, child in by_fam[name]:
                if fam.kind == "histogram":
                    snap = child.snapshot()
                    cum = 0
                    for le, c in snap["buckets"].items():
                        cum += c
                        le_s = "+Inf" if math.isinf(le) else repr(le)
                        k = _render_labels(key + (("le", le_s),))
                        lines.append(f"{name}_bucket{k} {cum}")
                    k = _render_labels(key)
                    lines.append(f"{name}_sum{k} {snap['sum']}")
                    lines.append(f"{name}_count{k} {snap['count']}")
                else:
                    lines.append(f"{name}{_render_labels(key)} {child.value}")
        return "\n".join(lines) + "\n"

    def clear(self) -> None:
        with self._lock:
            self._families.clear()


__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]
