"""What the readers of the program's own ranges share: the device
milliseconds a step (or a scoring call) launched inside the ranges the
program opens under the profiler (``repro_torch.obs.range``).

A device event counts for a range when the host operation that launched
it lies inside one of the range's spans on the same thread
(``Trace.device_in``).  The backward is the exception: the autograd engine
runs it on threads of its own on the card, so ``train.backward`` also
counts the launches made during its interval on the engine's threads
(those that carry ``autograd::engine::evaluate_function:`` operations),
and none of the loader's or any other thread's.  What runs inside
``models.remat`` (a layer's forward recomputed in the backward) is
``remat_ms``'s and is left out of ``backward_ms``.  Every reader gives
None when the trace holds none of its ranges, never 0."""

from __future__ import annotations

import bisect

FORWARD = "train.forward"
BACKWARD = "train.backward"
OPTIMIZER = "train.optimizer"
REMAT = "models.remat"
WEIGHT_CAST = "models.weight_cast"
DDLERP = "rwkv6.ddlerp"
ENGINE = "autograd::engine::evaluate_function:"


def _per_step(ctx, events) -> float:
    return sum(ev.dur for ev in events) / 1e6 / ctx.steps


def range_ms(ctx, name: str):
    """Device ms a step launched inside ``name`` on the range's thread."""
    trace = ctx.trace
    if trace is None or not ctx.steps:
        return None
    spans = trace.entries((name,))
    if not spans:
        return None
    return _per_step(ctx, trace.device_in(spans))


def backward_events(trace, spans) -> list:
    """Device events launched inside ``spans`` on their own thread, or
    during one of them on a thread of the autograd engine."""
    engine = {op.tid for op in trace.host if op.name.startswith(ENGINE)}
    intervals = sorted((op.start, op.end) for op in spans)
    starts = [s for s, _ in intervals]
    own = {id(ev) for ev in trace.device_in(spans)}
    out = []
    for ev in trace.device:
        h = ev.host
        if id(ev) in own:
            out.append(ev)
        elif h is not None and h.tid in engine:
            i = bisect.bisect_right(starts, h.start) - 1
            if i >= 0 and h.start < intervals[i][1]:
                out.append(ev)
    return out


def backward_ms(ctx):
    """Device ms a step of the backward, the recomputed forwards left out."""
    trace = ctx.trace
    if trace is None or not ctx.steps:
        return None
    spans = trace.entries((BACKWARD,))
    if not spans:
        return None
    remat = {id(ev) for ev in trace.device_in(trace.entries((REMAT,)))}
    return _per_step(ctx, [ev for ev in backward_events(trace, spans) if id(ev) not in remat])
