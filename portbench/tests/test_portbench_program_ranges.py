"""The readers of the program's own ranges (``metrics/program_ranges.py``)
on traces built by hand: what each range counts on its own thread, the
backward's launches on the autograd engine's threads (and none of the
loader's), the recomputed forwards taken out of the backward, and None
when a trace holds none of a reader's ranges."""

from __future__ import annotations

import importlib

import pytest

from portbench.run import Readings
from portbench.trace import DeviceEvent, HostOp, Trace

MAIN, ENGINE, LOADER = 1, 2, 3
MS = 1_000_000          # ns


def _launch(name, at, dur_ms, tid, host_name="aten::mul"):
    """A device event of ``dur_ms`` launched by a host op at ``at`` ns."""
    return DeviceEvent(name, at + 10, int(dur_ms * MS), HostOp(host_name, at, at + 5, tid))


def _trace(steps=1, ranges=True):
    """``steps`` steps of a training step's shape: on the main thread the
    forward (4 ms) and the optimizer (2 ms) with a backward range around
    the engine's work; on the engine thread the backward (6 ms) and a
    recomputed layer (3 ms); on the loader thread a gather (5 ms) while
    the backward runs; and a launch between ranges (1 ms)."""
    host, device = [], []
    t = 0
    for _ in range(steps):
        fwd, bwd, opt = (t, t + 100), (t + 100, t + 400), (t + 400, t + 500)
        if ranges:
            host += [HostOp("train.forward", *fwd, MAIN), HostOp("train.backward", *bwd, MAIN),
                     HostOp("models.remat", t + 150, t + 200, ENGINE),
                     HostOp("train.optimizer", *opt, MAIN)]
        host += [HostOp("autograd::engine::evaluate_function: MulBackward0", t + 110, t + 140,
                        ENGINE)]
        device += [_launch("fwd", t + 10, 4, MAIN),
                   _launch("bwd_own", t + 105, 0.5, MAIN),           # on the backward's thread
                   _launch("bwd", t + 120, 6, ENGINE),
                   _launch("remat", t + 160, 3, ENGINE),
                   _launch("gather", t + 250, 5, LOADER),
                   _launch("opt", t + 410, 2, MAIN),
                   _launch("between", t + 600, 1, MAIN)]
        t += 1000
    host.append(HostOp("portbench.window", 0, t, MAIN))
    return Trace((0, t), sorted(device, key=lambda ev: ev.start), host)


def _read(metric, trace, steps=1):
    ctx = Readings(trace=trace, steps=steps, metric=metric)
    return importlib.import_module(f"portbench.metrics.{metric.split('.')[0]}").read(ctx)


EXPECTED = {"forward_ms.train": 4.0, "optimizer_ms.train": 2.0, "remat_ms.train": 3.0,
            "backward_ms.train": 6.5}


@pytest.mark.parametrize("metric", sorted(EXPECTED))
@pytest.mark.parametrize("steps", [1, 3])
def test_each_training_range_counts_its_own_launches(metric, steps):
    assert _read(metric, _trace(steps), steps) == pytest.approx(EXPECTED[metric])


def test_the_backward_counts_the_engine_thread_but_not_the_loaders():
    trace = _trace()
    # the loader's gather launches inside the backward's interval, on a thread
    # that carries no autograd operation
    assert any(ev.name == "gather" for ev in trace.device)
    assert _read("backward_ms.train", trace) == pytest.approx(6.5)
    # put on the engine's thread, it would count
    for ev in trace.device:
        if ev.name == "gather":
            ev.host = HostOp("aten::index", ev.host.start, ev.host.end, ENGINE)
    assert _read("backward_ms.train", trace) == pytest.approx(11.5)


def test_the_recomputed_forward_is_taken_out_of_the_backward():
    trace = _trace()
    trace.host = [op for op in trace.host if op.name != "models.remat"]
    assert _read("remat_ms.train", trace) is None
    assert _read("backward_ms.train", trace) == pytest.approx(9.5)


def test_the_four_training_ranges_partition_what_they_enclose():
    trace = _trace(2)
    parts = sum(_read(m, trace, 2) for m in EXPECTED)
    # every launch but the loader's and the one between ranges
    total = sum(ev.dur for ev in trace.device if ev.name not in ("gather", "between")) / MS / 2
    assert parts == pytest.approx(total)


@pytest.mark.parametrize("metric", sorted(EXPECTED) + ["weight_cast_ms.score",
                                                        "ddlerp_ms.score"])
def test_a_trace_without_the_ranges_reads_none(metric):
    assert _read(metric, _trace(ranges=False)) is None
    assert _read(metric, None) is None


def test_the_scoring_ranges_count_by_thread():
    host = [HostOp("portbench.window", 0, 1000, MAIN),
            HostOp("rwkv6.ddlerp", 100, 200, MAIN),
            HostOp("models.weight_cast", 300, 320, MAIN),
            HostOp("models.weight_cast", 400, 420, MAIN)]
    device = [_launch("shift", 110, 2, MAIN), _launch("lora", 150, 3, MAIN),
              _launch("cast", 305, 0.25, MAIN), _launch("cast", 405, 0.25, MAIN),
              _launch("gemm", 500, 4, MAIN), _launch("gather", 120, 5, LOADER)]
    trace = Trace((0, 1000), device, host)
    assert _read("ddlerp_ms.score", trace, 2) == pytest.approx(2.5)
    assert _read("weight_cast_ms.score", trace, 2) == pytest.approx(0.25)
