"""Run one cell of the benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Everything is found by name: the cell in
``BENCHMARK.json``'s ``workloads``, its traffic, driver, optimizer and
limits in ``portbench/workloads/<cell>.json``, its configuration in the
file ``BENCHMARK.json`` names, the driver in ``portbench/drivers/<driver>.py``
and each metric's reader in ``portbench/metrics/<name>.py`` (a name's part
after the first dot is left out: ``step_mfu.train`` is read by
``step_mfu.py``).

The run: set-up (importing torch, the card, the program's kernels from
their build cache inside the checkout, the weights and corpus from the
seed, and the driver's warm-up at the cell's own shapes) is ``setup_s``,
counted from the start of this process.  Then the window: the driver's
``step()`` back to back for ``--seconds``, closed by a synchronize.  With
``--trace 1`` the window runs under the profiler (``portbench/trace.py``)
and the cell's per-layer metrics are reported instead of its end-to-end
ones.  After the window the program's state is freed, the plain reference
checks what the window produced, and the last line of standard output is
the result.  A run with no card, or with too few, fails before any work;
so does one that finds JAX or the JAX package loaded once the window has
closed.

``--control fp8`` also computes, beside the program's numbers, those of
the reference put in the program's place in the lower precision (the
control), ``--fault`` breaks the timed path underneath, and
``--readings 1`` prints the numbers without judging them against the
cell's limits: they serve to set the limits and are not part of a
benchmark run.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")     # top-level module names, compared whole
TRACE_SECONDS = 10.0                               # the longest traced window


def load_cell(name: str, root: Path = ROOT) -> tuple[dict, dict, dict, dict]:
    """(BENCHMARK.json, its entry of the cell, the cell's workload file,
    its configuration file)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    workload = json.loads((root / "portbench" / "workloads" / f"{name}.json").read_text())
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    return bench, entry, workload, config


def cell_metrics(bench: dict, name: str, trace: bool) -> list[dict]:
    """The metrics a cell reports: its end-to-end ones, or with ``trace``
    its per-layer ones (a metric without ``workloads`` in every cell that
    reports the end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in moved else [])]


def reader(metric: str):
    """The reader module of a metric."""
    return importlib.import_module(f"portbench.metrics.{metric.split('.', 1)[0]}")


class Run:
    """What a driver sees of the run: the cell's files, the seed, the
    device, the benchmark's host spans, and the fault or control asked for
    (tests and limit setting only)."""

    def __init__(self, config: dict, workload: dict, seed: int, device, *, fault=None,
                 control=None):
        self.config, self.workload, self.seed, self.device = config, workload, seed, device
        self.fault, self.control = fault, control
        self.control_numbers: dict | None = None
        self.readings = False
        self.detail: dict | None = None
        self.tracing = False
        self.span_s: dict[str, float] = {}
        self.span_n: dict[str, int] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        """A host span of the benchmark's own around a call into a layer:
        its seconds summed by name, and under the profiler a
        ``portbench.<name>`` range."""
        t = time.perf_counter()
        if self.tracing:
            from torch.profiler import record_function

            with record_function(f"portbench.{name}"):
                yield
        else:
            yield
        self.span_s[name] = self.span_s.get(name, 0.0) + time.perf_counter() - t
        self.span_n[name] = self.span_n.get(name, 0) + 1

    def reset_spans(self) -> None:
        self.span_s, self.span_n = {}, {}


class Readings:
    """What a metric's reader reads: the window's counts and clocks, and
    with a trace the parsed profiler events."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


@contextlib.contextmanager
def entry_spans(modules: list):
    """Each entry the readers name (``ENTRIES``: span name -> "module:attr")
    wrapped in a ``portbench.entry.<name>`` range while tracing; the
    program's attributes are put back afterwards."""
    from torch.profiler import record_function

    saved = []
    for mod in modules:
        for span, where in getattr(mod, "ENTRIES", {}).items():
            module_name, attr = where.split(":")
            try:
                target = importlib.import_module(module_name)
                fn = getattr(target, attr)
            except (ImportError, AttributeError):
                continue            # the entry moved: its reader finds nothing

            def wrapped(*a, _fn=fn, _span=span, **kw):
                with record_function(f"portbench.entry.{_span}"):
                    return _fn(*a, **kw)

            saved.append((target, attr, fn))
            setattr(target, attr, wrapped)
    try:
        yield
    finally:
        for target, attr, fn in reversed(saved):
            setattr(target, attr, fn)


def window(cell, run: Run, seconds: float) -> tuple[int, int, float]:
    """The driver's steps back to back for ``seconds``, closed by a
    synchronize: (steps, units of work, seconds)."""
    import torch

    t0 = time.perf_counter()
    steps = work = 0
    while time.perf_counter() - t0 < seconds:
        work += cell.step()
        steps += 1
    with run.span("sync"):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    return steps, work, time.perf_counter() - t0


def power_limit() -> float | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,"
                              "nounits", "-i", "0"], capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def forbidden_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, root: Path = ROOT,
             device=None, config: dict | None = None, workload: dict | None = None,
             fault: str | None = None, control: str | None = None, judge: bool = True,
             t0: float = T0) -> dict:
    """One run of a cell: the result line's object.  ``device``, ``config``
    and ``workload`` override the cell's (tests at a small size on the
    host); ``fault`` breaks the timed path; ``control`` adds the control's
    numbers; ``judge=False`` leaves ``correct`` undecided."""
    import torch

    bench, entry, wl, cfg = load_cell(name, root)
    config, workload = config or cfg, workload or wl
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
            raise SystemExit(f"{name} needs {entry['chips']} CUDA card(s); this machine has "
                             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
    on_card = device.type == "cuda"
    metrics = cell_metrics(bench, name, trace)
    readers = {m["name"]: reader(m["name"]) for m in metrics}
    run = Run(config, workload, seed, device, fault=fault, control=control)
    run.readings = not judge
    driver = importlib.import_module(f"portbench.drivers.{workload['driver']}")

    with contextlib.ExitStack() as stack:
        if trace:
            stack.enter_context(entry_spans(list(readers.values())))
        cell = driver.Cell(run)
        if on_card:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        run.reset_spans()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        traced = None
        if trace and on_card:
            from portbench import trace as tracing

            run.tracing = True
            box = {}
            traced = tracing.profile(lambda: box.update(
                zip(("steps", "work", "elapsed"), window(cell, run, min(seconds, TRACE_SECONDS)))))
            run.tracing = False
            steps, work, elapsed = box["steps"], box["work"], box["elapsed"]
        else:
            steps, work, elapsed = window(cell, run, seconds)
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the window ran with {', '.join(found)} loaded")
    cell.close()
    t_check = time.perf_counter()
    numbers = cell.check()
    print(f"times setup_s {setup_s:.3f} window_s {elapsed:.3f} check_s "
          f"{time.perf_counter() - t_check:.3f}", file=sys.stderr)

    ctx = Readings(name=name, config=config["run"], workload=workload, setup_s=setup_s,
                   steps=steps, work=work, elapsed=elapsed, peak_bytes=peak,
                   spans=dict(run.span_s), span_counts=dict(run.span_n), trace=traced)
    values = {}
    for m in metrics:
        ctx.metric = m["name"]
        v = readers[m["name"]].read(ctx)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}

    # the numbers compared are those the cell gives a limit; the others are
    # readings for setting limits, printed with --readings 1
    limits = workload.get("limits", {})
    checks = {k: {"value": numbers.get(k, float("nan")), "limit": v} for k, v in limits.items()}
    if not judge:
        checks.update({k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()})
    correct = None
    if judge:
        correct = bool(checks) and all(not math.isnan(c["value"]) and c["value"] <= c["limit"]
                                       for c in checks.values())
    result = {"correct": correct, "attempted": steps, "failed": 0, "metrics": values}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu (host)",
           "count": entry["chips"] if on_card else 0, "memory_peak_bytes": peak}
    if on_card:
        dev["power_limit_w"] = power_limit()
    result["device"] = dev
    if traced is not None:
        from portbench.trace import longest_gaps, summary, top_device_ops

        print("trace " + json.dumps(summary(traced)), file=sys.stderr)
        dev["busy_s"] = traced.busy_s()
        dev["window_s"] = traced.window_s
        result["breakdown"] = {"device_ops": top_device_ops(traced),
                               "idle_gaps": longest_gaps(traced)}
    if run.control_numbers is not None:
        result["control"] = run.control_numbers
    if run.detail is not None:
        print("detail " + json.dumps(run.detail), file=sys.stderr)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("fp8",), default=None)
    ap.add_argument("--readings", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", choices=("stale_state", "half_batch", "token", "answer"),
                    default=None, help="with --readings 1: break the timed path so")
    args = ap.parse_args(argv)
    if args.fault and not args.readings:
        ap.error("--fault goes with --readings 1")

    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    # build caches at fixed paths inside the checkout (the program's own
    # kernels build under build/repro_torch_kernels/ by themselves)
    os.environ["USE_FLAX"] = "0"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")

    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      control=args.control, fault=args.fault, judge=not args.readings)
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    if not args.readings:
        result.pop("control", None)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
