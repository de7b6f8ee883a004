"""The traced window: ``torch.profiler`` over the card, and the reduction
of its raw events to what the per-layer readers read.

The profiler misses the device events of a session's first moments (on the
H100 from a few to all of 64 small fills), so 64 fills of a scratch tensor
and a 50 ms pause go first, outside the window.  The window is the
benchmark's own ``portbench.window`` span; device events are kept when they
start inside it.

A device event is attributed to the host span that launched it: its
``linked_correlation_id`` names the host operation that was open at the
launch, and that operation's start and thread place it inside the spans
of that thread.  Entries into the program (``portbench.entry.*`` spans
that the benchmark opens around the calls of the models into the kernels,
and the autograd engine's ``evaluate_function: <Function>Backward`` spans)
are read that way, so the device time of an entry counts whatever the
entry runs, under any kernel name.
"""

from __future__ import annotations

import bisect
import dataclasses
import time

WARMUP_FILLS = 64
WINDOW = "portbench.window"
ENTRY = "portbench.entry."
SPANS = ("portbench.loader", "portbench.step", "portbench.sync")


@dataclasses.dataclass
class HostOp:
    name: str
    start: int          # ns
    end: int
    tid: int


@dataclasses.dataclass
class DeviceEvent:
    name: str
    start: int          # ns
    dur: int
    host: HostOp | None  # the host operation open at its launch


@dataclasses.dataclass
class Trace:
    window: tuple[int, int]             # ns, the window's span on the host clock
    device: list[DeviceEvent]           # inside the window
    host: list[HostOp]                  # every host operation seen

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of the device events' intervals, clipped to the window."""
        lo, hi = self.window
        out: list[tuple[int, int]] = []
        for s, e in sorted((max(ev.start, lo), min(ev.start + ev.dur, hi)) for ev in self.device):
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def idle_gaps(self) -> list[tuple[int, int]]:
        """The device's idle stretches inside the window."""
        gaps, t = [], self.window[0]
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.window[1] > t:
            gaps.append((t, self.window[1]))
        return gaps

    def open_span(self, t: int, names=SPANS) -> str:
        """The innermost of ``names`` open on the host at ``t``, or "other"."""
        best = None
        for op in self.host:
            if op.name in names and op.start <= t < op.end and (best is None
                                                                 or op.start > best.start):
                best = op
        return best.name.split(".", 1)[1] if best is not None else "other"

    def entries(self, names: tuple[str, ...]) -> list[HostOp]:
        """Host spans named exactly one of ``names`` inside the window, one
        a call: a span inside another of them on its thread (the autograd
        engine's range of a node and the node's own) is the same call."""
        lo, hi = self.window
        spans = sorted((op for op in self.host if op.name in names and lo <= op.start < hi),
                       key=lambda op: (op.tid, op.start, -op.end))
        out: list[HostOp] = []
        for op in spans:
            if out and out[-1].tid == op.tid and op.end <= out[-1].end:
                continue
            out.append(op)
        return out

    def device_in(self, spans: list[HostOp]) -> list[DeviceEvent]:
        """Device events launched inside one of ``spans`` (same thread)."""
        by_tid: dict[int, list[tuple[int, int]]] = {}
        for op in spans:
            by_tid.setdefault(op.tid, []).append((op.start, op.end))
        for v in by_tid.values():
            v.sort()
        out = []
        for ev in self.device:
            h = ev.host
            if h is None or h.tid not in by_tid:
                continue
            v = by_tid[h.tid]
            i = bisect.bisect_right(v, (h.start, float("inf"))) - 1
            # spans of one thread nest or follow one another: look back
            # through those that start before the launch
            while i >= 0:
                s, e = v[i]
                if s <= h.start and h.end <= e:
                    out.append(ev)
                    break
                i -= 1
        return out


def profile(run_window) -> Trace:
    """``run_window()`` under the profiler, after the warm-up fills; it
    must end in a ``torch.cuda.synchronize()``."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    scratch = torch.empty(1, dtype=torch.int16, device="cuda")
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(WARMUP_FILLS):
            scratch.fill_(0)
        torch.cuda.synchronize()
        time.sleep(0.05)
        with record_function(WINDOW):
            run_window()
    return parse(prof.profiler.kineto_results.events())


def parse(events) -> Trace:
    """A :class:`Trace` from raw Kineto events."""
    from torch.autograd import DeviceType

    host, by_corr, runtime, device_raw = [], {}, {}, []
    window = None
    for evt in events:
        if evt.device_type() == DeviceType.CUDA:
            device_raw.append(evt)
            continue
        op = HostOp(evt.name(), evt.start_ns(), evt.end_ns(), evt.start_thread_id())
        host.append(op)
        if op.name.startswith("cu"):       # runtime calls (cudaLaunchKernel, ...): CUPTI's ids
            runtime[evt.correlation_id()] = op
        else:                              # operations: the ids kernels link to
            by_corr.setdefault(evt.correlation_id(), op)
        if op.name == WINDOW:
            window = (op.start, op.end)
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    device = []
    for evt in device_raw:
        start = evt.start_ns()
        if not window[0] <= start < window[1]:
            continue
        if evt.is_user_annotation() or evt.name().startswith("portbench."):
            continue                       # the host ranges' shadows on the device timeline
        linked = evt.linked_correlation_id()
        h = by_corr.get(linked) if linked > 0 else None
        if h is None:
            h = runtime.get(evt.correlation_id())
        device.append(DeviceEvent(evt.name(), start, evt.duration_ns(), h))
    device.sort(key=lambda ev: ev.start)
    _place_unlinked(device)
    return Trace(window, device, host)


def _place_unlinked(device: list[DeviceEvent]) -> None:
    """A device event the profiler linked to no host operation was launched,
    in stream order, between its linked neighbours: it gets a host span from
    the previous one's start to the next one's end, when both are on one
    thread, so that it counts inside an entry only when both do."""
    linked = [i for i, ev in enumerate(device) if ev.host is not None]
    for i, ev in enumerate(device):
        if ev.host is not None:
            continue
        k = bisect.bisect_left(linked, i)
        if 0 < k < len(linked):
            a, b = device[linked[k - 1]].host, device[linked[k]].host
            if a.tid == b.tid:
                ev.host = HostOp("unlinked", a.start, b.end, a.tid)


def top_device_ops(trace: Trace, n: int = 10) -> list[list]:
    """The device operations that took most time in the window, by name."""
    by_name: dict[str, float] = {}
    for ev in trace.device:
        by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.dur / 1e9
    return [[name[:200], sec] for name, sec in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]


def longest_gaps(trace: Trace, n: int = 10) -> list[list]:
    """The longest idle gaps, each named by the benchmark's span open on the
    host at its middle."""
    gaps = sorted(trace.idle_gaps(), key=lambda g: g[0] - g[1])[:n]
    return [[trace.open_span((s + e) // 2), (e - s) / 1e9] for s, e in gaps]


def summary(trace: Trace) -> dict:
    """What the trace holds, for the run's standard error: device events,
    those linked to no host operation, and each entry's calls and device
    milliseconds with its three longest kernels."""
    names = sorted({op.name for op in trace.host
                    if op.name.startswith(ENTRY) or op.name.endswith("Backward")
                    and "evaluate_function" in op.name})
    out = {"device_events": len(trace.device),
           "unlinked": sum(ev.host is None for ev in trace.device),
           "placed": sum(ev.host is not None and ev.host.name == "unlinked"
                         for ev in trace.device)}
    for name in names:
        spans = trace.entries((name,))
        events = trace.device_in(spans)
        by_kernel: dict[str, float] = {}
        for ev in events:
            by_kernel[ev.name[:60]] = by_kernel.get(ev.name[:60], 0.0) + ev.dur / 1e6
        out[name] = {"calls": len(spans), "device_ms": sum(by_kernel.values()),
                     "kernels": sorted(by_kernel.items(), key=lambda kv: -kv[1])[:3]}
    return out
