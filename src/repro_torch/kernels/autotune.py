"""``repro_torch.kernels.autotune`` -- the measured configuration search of
the RSP kernels on the card.

The three RSP kernels (``rsp_shuffle``, ``block_sketch``, ``plan_sketch``)
launch with configurations that change their speed but not their meaning:
the threads a CTA, the read path, the staged tile, whether the histogram
lives in shared memory, the rows a CTA.  Their ``impl="auto"`` paths ask
this module which configuration to launch:

* On the first call for a ``(kernel, key, device)`` -- the key buckets the
  rows to the next power of two (:func:`shape_key`) and adds what else
  decides the launch -- every candidate is timed on the actual workload:
  :func:`cuda_seconds` puts CUDA events around a run of back-to-back calls
  that rotate over copies of the input (:class:`Rotation`), so that no
  call finds its block in L2.  Candidates are timed in turns, ``repeats``
  rounds, and each keeps its best run.  The fastest wins, except that the
  default configuration stays unless the fastest beats it by more than the
  spread of their runs: a win within the noise would change the launch
  (and a sketch's fold order) for nothing.  A candidate that fails to
  launch is dropped from the measurement and recorded as ``excluded``; it
  is never replaced by another path.
* The winner persists to ``results/bench/autotune_torch.json`` (or
  ``$REPRO_AUTOTUNE_CACHE``) by an atomic rename, so a later process --
  a mesh's children, a served wave -- reads it and measures nothing.  Once
  made, a key's choice is fixed: runs that must agree bit for bit (served
  against solo answers, mesh against single host) launch the same
  configuration.
* The device key is the card's name plus the kernels' source hash
  (``_cuda.source_hash()``), so a winner measured on an older build of a
  kernel never decides for a newer one.  On a CPU tensor only the plain
  versions run, so ``choose`` returns the default without measuring (the
  counterpart of the reference's ``interpreted`` flag).
* Candidates on a CUDA tensor are kernel configurations only, never a
  plain version: choosing one would hide the kernel.
* ``REPRO_AUTOTUNE=off`` (or ``0`` / ``false`` / ``no``) disables
  measurement everywhere: ``choose`` returns the default at once and
  touches no file.  The tests run in this mode.

The port of ``src/repro/kernels/autotune.py``; its cache file is its own
and it never writes the reference's ``results/bench/autotune.json``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import threading
import time
from pathlib import Path
from typing import Callable, Sequence

import torch

_ENV = "REPRO_AUTOTUNE"
_ENV_CACHE = "REPRO_AUTOTUNE_CACHE"
_OFF = ("off", "0", "false", "no")
CACHE_NAME = "autotune_torch.json"
CALLS = 20                  # back-to-back calls a timed run
L2_BYTES_H100 = 50 << 20    # the L2 assumed where the device does not say
MAX_COPIES = 16             # copies a Rotation makes at most


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One configuration: an implementation name, an optional tile, and the
    kernel's other launch parameters as sorted ``(name, value)`` pairs."""

    impl: str
    tile_rows: int | None = None
    params: tuple = ()

    @classmethod
    def of(cls, impl: str, tile_rows: int | None = None, **params) -> "Candidate":
        return cls(impl, tile_rows, tuple(sorted(params.items())))

    def get(self, name: str, default=None):
        return dict(self.params).get(name, default)

    @property
    def label(self) -> str:
        parts = [self.impl] if self.tile_rows is None else [f"{self.impl}:{self.tile_rows}"]
        parts += [f"{k}={v}" for k, v in self.params]
        return ",".join(parts)


def enabled() -> bool:
    """Whether measurement is allowed (``REPRO_AUTOTUNE`` not off)."""
    return os.environ.get(_ENV, "on").strip().lower() not in _OFF


def cache_path() -> str:
    """Where winners persist: ``$REPRO_AUTOTUNE_CACHE`` or the repository's
    ``results/bench/autotune_torch.json``."""
    env = os.environ.get(_ENV_CACHE)
    if env:
        return env
    return str(Path(__file__).resolve().parents[3] / "results" / "bench" / CACHE_NAME)


def shape_key(rows: int, features: int, dtype: str = "float32") -> str:
    """Bucket ``rows`` to the next power of two so one measurement covers
    nearby shapes; features and dtype are exact."""
    b = 1 << max(0, int(rows) - 1).bit_length()
    return f"r{b}xf{int(features)}:{dtype}"


def device_key(device: torch.device) -> str | None:
    """``"<card name>|<kernel source hash>"`` for a CUDA device; None for
    any other device, where nothing is measured."""
    device = torch.device(device)
    return None if device.type != "cuda" else _cuda_key(device)


@functools.lru_cache(maxsize=16)
def _cuda_key(device: torch.device) -> str:
    # once a device a process: every launch of a tuned path looks it up
    from repro_torch.kernels import _cuda

    return f"{torch.cuda.get_device_name(device)}|{_cuda.source_hash()}"


class Rotation:
    """``x`` and copies of it, made at the first call, enough that one
    pass over them reads twice the card's L2 (at most :data:`MAX_COPIES`):
    ``rotation(i)`` for successive i finds no copy in L2, as a query's call
    meets a block it has not read yet."""

    def __init__(self, x: torch.Tensor):
        self._x = x
        self._copies: list[torch.Tensor] | None = None

    def __call__(self, i: int) -> torch.Tensor:
        if self._copies is None:
            n = -(-2 * _l2_bytes(self._x.device) // max(1, self._x.nbytes))
            self._copies = [self._x] + [self._x.clone() for _ in range(min(n, MAX_COPIES) - 1)]
        return self._copies[i % len(self._copies)]


def _l2_bytes(device: torch.device) -> int:
    if device.type != "cuda":
        return L2_BYTES_H100
    props = torch.cuda.get_device_properties(device)
    return int(getattr(props, "L2_cache_size", L2_BYTES_H100))


def cuda_seconds(fn: Callable[[int], object], device: torch.device) -> float:
    """Seconds a call of ``fn(i)`` on ``device``'s current stream: two CUDA
    events around :data:`CALLS` back-to-back calls (i = 0 .. CALLS - 1),
    divided by :data:`CALLS`, after one warm call ``fn(0)``.  One call of a
    few tens of microseconds, timed alone, measures the events and the
    launch as much as the kernel."""
    fn(0)
    with torch.cuda.device(device):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(CALLS):
            fn(i)
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / 1e3 / CALLS


class Autotuner:
    """In-memory and on-disk cache of measured winners (see module docs).
    ``device_key`` maps a device to its cache name, or to None where
    nothing may be measured (the default: :func:`device_key`)."""

    def __init__(self, path: str | None = None,
                 device_key: Callable[[torch.device], str | None] = device_key):
        self._path = path
        self._device_key = device_key
        self._lock = threading.RLock()
        self._mem: dict[str, dict] = {}
        self._loaded = False
        self.measurements = 0  # tuning runs this process (test and smoke hook)

    def _file(self) -> str:
        return self._path or cache_path()

    def _load(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        try:
            with open(self._file()) as f:
                disk = json.load(f)
            if isinstance(disk, dict):
                for k, v in disk.items():
                    self._mem.setdefault(k, v)
        except (OSError, ValueError):
            pass

    def _persist(self) -> None:
        path = self._file()
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            disk: dict = {}
            try:
                with open(path) as f:
                    old = json.load(f)
                if isinstance(old, dict):
                    disk.update(old)
            except (OSError, ValueError):
                pass
            disk.update(self._mem)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(disk, f, indent=2, sort_keys=True)
                f.write("\n")
            os.replace(tmp, path)
        except OSError:
            pass  # tuning still works in this process; it just won't persist

    def clear(self) -> None:
        """Forget every winner (memory and disk)."""
        with self._lock:
            self._mem.clear()
            self._loaded = False
            try:
                os.remove(self._file())
            except OSError:
                pass

    def records(self) -> dict[str, dict]:
        """Every winner's record, by ``"kernel|key|device"``."""
        with self._lock:
            self._load()
            return {k: dict(v) for k, v in self._mem.items()}

    def lookup(self, kernel: str, key: str, device) -> Candidate | None:
        """The cached winner for ``(kernel, key, device)``, or None."""
        dev = self._device_key(device)
        if dev is None:
            return None
        with self._lock:
            self._load()
            rec = self._mem.get(f"{kernel}|{key}|{dev}")
        if not rec:
            return None
        return Candidate(rec["impl"], rec.get("tile_rows"),
                         tuple((k, v) for k, v in rec.get("params", [])))

    def choose(
        self,
        kernel: str,
        key: str,
        candidates: Sequence[Candidate],
        measure: Callable[[Candidate], float],
        *,
        default: Candidate,
        device,
        repeats: int = 3,
    ) -> Candidate:
        """The winning :class:`Candidate` for ``(kernel, key, device)``.

        With tuning disabled, or on a device that :func:`device_key` does
        not name (the CPU), returns ``default`` untouched.  Otherwise the
        cached winner is returned if present; else the candidates are timed
        in turns, ``repeats`` rounds, via ``measure`` (seconds of one run;
        an exception excludes the candidate), and the one with the fastest
        best run wins -- unless ``default`` is a candidate and beats it, or
        trails it by no more than the larger spread (slowest minus fastest
        run) of the two: then ``default`` stays.  The winner persists to
        :func:`cache_path`.  If no candidate could be measured, ``default``
        wins and the record notes the fallback."""
        if not enabled() or self._device_key(device) is None:
            return default
        cached = self.lookup(kernel, key, device)
        if cached is not None:
            return cached
        with self._lock:
            cached = self.lookup(kernel, key, device)
            if cached is not None:
                return cached
            t_tune = time.perf_counter()
            runs: dict[Candidate, list[float]] = {c: [] for c in candidates}
            excluded: list[str] = []
            # in turns, so that a drift of the card's clock falls on all alike
            for _ in range(max(1, repeats)):
                for c in list(runs):
                    try:
                        runs[c].append(measure(c))
                    except Exception as e:  # noqa: BLE001 -- a refused launch
                        excluded.append(f"{c.label} (error: {type(e).__name__})")
                        del runs[c]
            best_of = {c: min(ts) for c, ts in runs.items()}
            best = min(best_of, key=best_of.get) if best_of else None
            if best is not None and best != default and default in best_of:
                noise = max(max(runs[c]) - min(runs[c]) for c in (best, default))
                if best_of[default] - best_of[best] <= noise:
                    best = default
            self.measurements += 1
            winner = best if best is not None else default
            from repro_torch import obs  # deferred: keep this module import-light

            if obs.enabled():
                reg = obs.get_registry()
                reg.counter(
                    "rsp_autotune_runs_total", "tuning measurement runs", kernel=kernel,
                ).inc()
                reg.histogram(
                    "rsp_autotune_measure_seconds",
                    "wall time spent timing candidates for one tuning run",
                    kernel=kernel,
                ).observe(time.perf_counter() - t_tune)
            rec = {
                "impl": winner.impl,
                "tile_rows": winner.tile_rows,
                "params": [list(p) for p in winner.params],
                "us": None if best is None else best_of[best] * 1e6,
                "measured_us": {c.label: t * 1e6 for c, t in best_of.items()},
                "spread_us": {c.label: (max(ts) - min(ts)) * 1e6 for c, ts in runs.items()},
                "excluded": excluded,
                "fallback": best is None,
            }
            self._mem[f"{kernel}|{key}|{self._device_key(device)}"] = rec
            self._persist()
            return winner


_TUNER = Autotuner()


def get_tuner() -> Autotuner:
    return _TUNER


def choose(*args, **kwargs) -> Candidate:
    """:meth:`Autotuner.choose` on the shared process-wide tuner."""
    return _TUNER.choose(*args, **kwargs)


def clear() -> None:
    _TUNER.clear()
