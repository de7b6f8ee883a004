"""``repro_torch.rsp.engine`` -- the streaming block-execution engine.

Every block-consuming operation reduces to the same shape of work: *move a
sequence of RSP blocks from a source to a consumer as fast as the storage
allows*.  This module owns that movement.  Blocks are tensors on the
dataset's device:

``BlockFetcher``
    The pluggable source protocol -- ``num_blocks`` plus ``fetch(block_id)``.
    :class:`MemoryFetcher` holds the stacked ``[K, n, ...]`` tensor (on the
    card after a ``cuda`` partition; fetch is a view), :class:`StoreFetcher`
    and :class:`MmapFetcher` read an ``RSPStore`` with ``np.load`` (fully or
    memory-mapped) and move the block to the device on the worker thread.
    :func:`as_fetcher` adapts tensors, arrays, stores and loader-like
    objects.

``BlockExecutor``
    Wraps a fetcher with a bounded thread-pool prefetch pipeline and a small
    LRU block cache (of device tensors: 8 blocks by default), with
    single-flight fetches.  Worker exceptions propagate to the consumer at
    the point of consumption.  ``map_blocks(fn, ids)`` yields ``fn(block)``
    for each id *in order* while the next ``prefetch`` blocks load;
    ``fn=None`` yields the raw blocks, so per-block compute runs on the
    caller's thread.

With ``prefetch=0`` the executor is a plain synchronous loop.
``executor.stats()`` exposes hit/miss/eviction counters and the
blocks-fetched count, so a query can report how many blocks it touched.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Iterable, Iterator, Protocol, Sequence, runtime_checkable

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.registry import RSPStore
from repro_torch.device import DEFAULT_DEVICE, as_tensor, resolve_device
from repro_torch.obs.trace import SpanContext


@dataclasses.dataclass(frozen=True)
class ExecutorStats:
    """Counters for one :class:`BlockExecutor`'s block movement.

    ``hits`` / ``misses`` are LRU-cache outcomes (with the cache disabled
    every access is a miss); ``evictions`` counts LRU drops;
    ``blocks_fetched`` is the total number of blocks pulled from the
    underlying fetcher -- the honest I/O count behind a query's "answered
    from N of K blocks" claim.  Snapshots subtract, so a consumer can report
    only its own window: ``after - before``.
    """

    hits: int = 0
    misses: int = 0
    evictions: int = 0
    rows_fetched: int = 0  # rows pulled from the fetcher (misses only)

    @property
    def blocks_fetched(self) -> int:
        return self.misses

    @property
    def accesses(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.accesses if self.accesses else 0.0

    def __sub__(self, other: "ExecutorStats") -> "ExecutorStats":
        return ExecutorStats(
            hits=self.hits - other.hits,
            misses=self.misses - other.misses,
            evictions=self.evictions - other.evictions,
            rows_fetched=self.rows_fetched - other.rows_fetched,
        )

    def __add__(self, other: "ExecutorStats") -> "ExecutorStats":
        return ExecutorStats(
            hits=self.hits + other.hits,
            misses=self.misses + other.misses,
            evictions=self.evictions + other.evictions,
            rows_fetched=self.rows_fetched + other.rows_fetched,
        )


class CallerStats:
    """A per-caller block-access counter.

    Snapshot deltas of the executor-wide :meth:`BlockExecutor.stats` are racy
    the moment two consumers interleave on one executor: each would claim the
    other's I/O.  Instead a caller passes its own ``CallerStats`` into
    ``fetch`` / ``fetch_async`` / ``map_blocks`` and every access is counted
    on *both* the executor's global counters and the caller's -- so per-caller
    counts always sum to the executor total, no matter how requests
    interleave.  Thread-safe; ``stats()`` returns an immutable snapshot.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0
        self._rows = 0
        self._fetch_s = 0.0

    def _hit(self) -> None:
        with self._lock:
            self._hits += 1

    def _miss(self, rows: int = 0, seconds: float = 0.0) -> None:
        with self._lock:
            self._misses += 1
            self._rows += rows
            self._fetch_s += seconds

    def stats(self) -> ExecutorStats:
        with self._lock:
            return ExecutorStats(
                hits=self._hits, misses=self._misses, rows_fetched=self._rows
            )

    def fetch_seconds(self) -> float:
        """Cumulative wall-clock seconds this caller's misses spent inside
        ``fetcher.fetch`` -- the I/O cost behind the counts in :meth:`stats`
        (kept off :class:`ExecutorStats` so its integer conservation
        arithmetic stays exact)."""
        with self._lock:
            return self._fetch_s


# ---------------------------------------------------------------------------
# Fetchers
# ---------------------------------------------------------------------------

@runtime_checkable
class BlockFetcher(Protocol):
    """Anything that can serve RSP blocks by id."""

    @property
    def num_blocks(self) -> int: ...

    def fetch(self, block_id: int) -> torch.Tensor: ...


class MemoryFetcher:
    """Blocks already stacked in memory -- ``fetch`` returns a view.  A
    tensor stays where it lies unless ``device`` is given; a numpy stack is
    moved to ``device``, the card unless asked for the CPU."""

    def __init__(self, blocks, device: torch.device | str | None = None):
        if isinstance(blocks, torch.Tensor):
            self._blocks = blocks if device is None else blocks.to(resolve_device(device))
        else:
            self._blocks = as_tensor(blocks, resolve_device(device))

    @property
    def num_blocks(self) -> int:
        return self._blocks.shape[0]

    def fetch(self, block_id: int) -> torch.Tensor:
        return self._blocks[block_id]


class StoreFetcher:
    """Materializing ``RSPStore`` reads: each fetch loads the block with
    ``np.load`` and moves it to ``device`` (on the worker thread), the card
    unless asked for the CPU."""

    def __init__(self, store: RSPStore, *, device: torch.device | str = DEFAULT_DEVICE,
                 verify: bool = False):
        self.store = store
        self.device = resolve_device(device)
        self.verify = verify

    @property
    def num_blocks(self) -> int:
        return self.store.num_blocks()

    def fetch(self, block_id: int) -> torch.Tensor:
        arr = self.store.load_block(block_id, mmap=False, verify=self.verify)
        return torch.from_numpy(arr).to(self.device)


class MmapFetcher:
    """Memory-mapped ``RSPStore`` reads for corpora larger than RAM: pages
    stream from disk while the block is copied to ``device``, the card
    unless asked for the CPU."""

    def __init__(self, store: RSPStore, *, device: torch.device | str = DEFAULT_DEVICE):
        self.store = store
        self.device = resolve_device(device)

    @property
    def num_blocks(self) -> int:
        return self.store.num_blocks()

    def fetch(self, block_id: int) -> torch.Tensor:
        return as_tensor(self.store.load_block(block_id, mmap=True), self.device)


class _AdapterFetcher:
    """Wraps any object exposing ``num_blocks`` and a block-loading method."""

    def __init__(self, obj: Any, load: Callable[[int], torch.Tensor]):
        self._obj = obj
        self._load = load

    @property
    def num_blocks(self) -> int:
        n = self._obj.num_blocks
        return n() if callable(n) else n

    def fetch(self, block_id: int) -> torch.Tensor:
        return self._load(block_id)


def as_fetcher(
    source: Any, *, mode: str = "auto", device: torch.device | str | None = None
) -> BlockFetcher:
    """Adapt ``source`` into a :class:`BlockFetcher`.

    Accepts an existing fetcher, a stacked tensor (kept where it lies) or
    ``np.ndarray``, an ``RSPStore`` (``mode="store"`` materializes,
    ``"mmap"`` memory-maps, ``"auto"`` == ``"store"``), or any object with
    ``num_blocks`` and ``block``/``load``.  Arrays and store blocks land on
    ``device``, the card unless asked for the CPU.
    """
    if isinstance(source, (MemoryFetcher, StoreFetcher, MmapFetcher, _AdapterFetcher)):
        return source
    if isinstance(source, (np.ndarray, torch.Tensor)):
        return MemoryFetcher(source, device)
    if isinstance(source, RSPStore):
        if mode == "mmap":
            return MmapFetcher(source, device=device)
        if mode in ("auto", "store"):
            return StoreFetcher(source, device=device)
        raise ValueError(f"unknown fetcher mode {mode!r} for a store (auto | store | mmap)")
    for name in ("block", "load", "fetch"):
        load = getattr(source, name, None)
        if callable(load) and hasattr(source, "num_blocks"):
            return _AdapterFetcher(source, load)
    raise TypeError(f"cannot build a BlockFetcher from {type(source).__name__}")


_NULL_CM = contextlib.nullcontext()  # stateless; safe to share


def _fetcher_kind(fetcher: Any) -> str:
    """Telemetry label for the fetch path: memory | store | mmap | other."""
    if isinstance(fetcher, MemoryFetcher):
        return "memory"
    if isinstance(fetcher, StoreFetcher):
        return "store"
    if isinstance(fetcher, MmapFetcher):
        return "mmap"
    return "other"


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------

class BlockExecutor:
    """Prefetching block pipeline over a :class:`BlockFetcher`.

    ``prefetch`` blocks are kept in flight on a bounded thread pool while the
    consumer works; ``cache_blocks`` most-recently-used blocks are retained so
    repeated probes (similarity references, overlapping samples) skip the
    fetch entirely.  ``prefetch=0`` disables threading: every primitive then
    runs as a plain synchronous loop with identical results.

    Exceptions raised by the fetcher (or by a mapped ``fn``) inside a worker
    thread are re-raised in the consumer when the failing block's result is
    consumed.
    """

    def __init__(
        self,
        fetcher: BlockFetcher | Any,
        *,
        prefetch: int = 4,
        cache_blocks: int = 8,
        workers: int | None = None,
    ):
        self.fetcher = as_fetcher(fetcher)
        self.prefetch = max(0, int(prefetch))
        self._kind = _fetcher_kind(self.fetcher)
        self._obs: tuple[Any, dict] | None = None  # (registry, handles) cache
        self._cache: collections.OrderedDict[int, torch.Tensor] = collections.OrderedDict()
        self._cache_cap = max(0, int(cache_blocks))
        self._cache_lock = threading.Lock()
        self._inflight: dict[int, threading.Event] = {}
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._rows_fetched = 0
        if self.prefetch > 0:
            n = workers if workers is not None else min(self.prefetch, 8)
            self._pool: ThreadPoolExecutor | None = ThreadPoolExecutor(
                max_workers=max(1, n), thread_name_prefix="rsp-engine"
            )
        else:
            self._pool = None

    def _m(self) -> dict:
        """Lazy per-executor metric handles against the *current* global
        registry (``obs.reset()`` swaps the registry, so re-resolve when the
        identity changes).  Call only under ``obs.enabled()``."""
        reg = obs.get_registry()
        cached = self._obs
        if cached is None or cached[0] is not reg:
            k = self._kind
            handles = {
                "hit": reg.counter(
                    "rsp_engine_fetch_total", "block accesses", kind=k, outcome="hit"),
                "miss": reg.counter(
                    "rsp_engine_fetch_total", "block accesses", kind=k, outcome="miss"),
                "fetch_s": reg.histogram(
                    "rsp_engine_fetch_seconds", "fetcher.fetch latency", kind=k),
                "flight_s": reg.histogram(
                    "rsp_engine_singleflight_wait_seconds",
                    "time followers wait on the single-flight leader", kind=k),
                "queue_s": reg.histogram(
                    "rsp_engine_queue_wait_seconds",
                    "submit-to-start wait on the prefetch pool", kind=k),
                "rows": reg.counter(
                    "rsp_engine_rows_fetched_total", "rows pulled from the fetcher", kind=k),
            }
            self._obs = cached = (reg, handles)
        return cached[1]

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def __enter__(self) -> "BlockExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- single-block access ----------------------------------------------
    @property
    def num_blocks(self) -> int:
        return self.fetcher.num_blocks

    def fetch(self, block_id: int, *, counter: CallerStats | None = None) -> torch.Tensor:
        """Cache-aware synchronous fetch of one block.  Blocks are shared
        (between the cache and every consumer), so an in-place write would
        corrupt later reads -- clone first to mutate (numpy blocks are marked
        read-only; tensors have no such flag).

        Concurrent callers asking for the same uncached block are
        single-flighted: one fetches, the rest wait and take the cache hit,
        so contention never multiplies the I/O (cache-disabled executors skip
        this -- there is nowhere to share the result from).  ``counter``
        attributes the access to one caller (see :class:`CallerStats`).
        """
        telemetry = obs.enabled()
        while True:
            with self._cache_lock:
                if block_id in self._cache:
                    self._cache.move_to_end(block_id)
                    self._hits += 1
                    if counter is not None:
                        counter._hit()
                    block = self._cache[block_id]
                    if telemetry:
                        self._m()["hit"].inc()
                    return block
                event = self._inflight.get(block_id) if self._cache_cap > 0 else None
                if event is None:
                    if self._cache_cap > 0:
                        self._inflight[block_id] = event = threading.Event()
                    break  # this caller leads the fetch
            # another caller is already fetching this block -- wait, then
            # re-check the cache (a failed or instantly-evicted leader makes
            # this caller lead the retry)
            if telemetry:
                t0 = time.perf_counter()
                event.wait()
                self._m()["flight_s"].observe(time.perf_counter() - t0)
            else:
                event.wait()
        try:
            t0 = time.perf_counter()
            block = self.fetcher.fetch(block_id)
            fetch_s = time.perf_counter() - t0
            if isinstance(block, np.ndarray):
                block.setflags(write=False)
            rows = int(block.shape[0]) if len(block.shape) else 0
            with self._cache_lock:
                self._misses += 1
                self._rows_fetched += rows
                if counter is not None:
                    counter._miss(rows, fetch_s)
                if self._cache_cap > 0:
                    self._cache[block_id] = block
                    self._cache.move_to_end(block_id)
                    while len(self._cache) > self._cache_cap:
                        self._cache.popitem(last=False)
                        self._evictions += 1
            if telemetry:
                m = self._m()
                m["miss"].inc()
                m["fetch_s"].observe(fetch_s)
                m["rows"].inc(rows)
            return block
        finally:
            if event is not None:
                with self._cache_lock:
                    self._inflight.pop(block_id, None)
                event.set()

    def stats(self) -> ExecutorStats:
        """Snapshot of the hit/miss/eviction counters (see
        :class:`ExecutorStats`); subtract two snapshots to meter one
        consumer's window."""
        with self._cache_lock:
            return ExecutorStats(
                hits=self._hits,
                misses=self._misses,
                evictions=self._evictions,
                rows_fetched=self._rows_fetched,
            )

    def reset_stats(self) -> None:
        with self._cache_lock:
            self._hits = self._misses = self._evictions = self._rows_fetched = 0

    def fetch_async(
        self,
        block_id: int,
        fn: Callable[[torch.Tensor], Any] | None = None,
        *,
        counter: CallerStats | None = None,
        trace: SpanContext | None = None,
    ) -> Future:
        """Start fetching ``block_id`` (and applying ``fn``) on a worker.

        Returns a future; without a pool (``prefetch=0``) the work runs
        immediately on the caller's thread and the future is already done.
        Either way, errors surface on ``.result()``.  ``trace`` parents the
        worker-side span under the submitting caller's span (explicitly --
        context vars do not follow pool threads).
        """
        submitted = time.perf_counter() if obs.enabled() else 0.0
        if self._pool is None:
            fut: Future = Future()
            try:
                fut.set_result(self._task(block_id, fn, counter, trace, submitted))
            except BaseException as e:  # noqa: BLE001 -- mirror executor semantics
                fut.set_exception(e)
            return fut
        return self._pool.submit(self._task, block_id, fn, counter, trace, submitted)

    def _task(
        self,
        block_id: int,
        fn: Callable[[torch.Tensor], Any] | None,
        counter: CallerStats | None = None,
        trace: SpanContext | None = None,
        submitted: float = 0.0,
    ) -> Any:
        if not obs.enabled():
            block = self.fetch(block_id, counter=counter)
            return fn(block) if fn is not None else block
        if submitted:
            self._m()["queue_s"].observe(time.perf_counter() - submitted)
        with obs.get_tracer().span(
            "engine.fetch", parent=trace, attrs={"block": block_id, "kind": self._kind}
        ) if trace is not None else _NULL_CM:
            block = self.fetch(block_id, counter=counter)
            return fn(block) if fn is not None else block

    # -- primitive 1: ordered map with prefetch ----------------------------
    def map_blocks(
        self,
        fn: Callable[[torch.Tensor], Any] | None,
        ids: Iterable[int],
        *,
        with_ids: bool = False,
        counter: CallerStats | None = None,
        trace: SpanContext | None = None,
    ) -> Iterator[Any]:
        """Yield ``fn(block)`` for every id *in order*, prefetching ahead.

        ``fn`` runs on the worker threads (overlapping fetch and transform);
        ``fn=None`` yields the raw blocks.  ``with_ids=True`` yields
        ``(block_id, result)`` pairs instead.  ``counter`` attributes every
        access of this stream to one caller (see :class:`CallerStats`);
        ``trace`` parents worker-side spans under the caller's span.
        """
        it = iter(ids)
        window: collections.deque[tuple[int, Future]] = collections.deque()

        def submit_one() -> None:
            for b in it:
                window.append((b, self.fetch_async(b, fn, counter=counter, trace=trace)))
                return

        try:
            for _ in range(self.prefetch + 1):
                submit_one()
            while window:
                bid, fut = window.popleft()
                result = fut.result()
                submit_one()
                yield (bid, result) if with_ids else result
        finally:
            for _, fut in window:
                fut.cancel()

    def run(self, fn: Callable[[torch.Tensor], Any] | None, ids: Sequence[int]) -> list:
        """Materialized :meth:`map_blocks`."""
        return list(self.map_blocks(fn, ids))

    def take(self, ids: Sequence[int]) -> torch.Tensor:
        """Stack the given blocks -> [g, n, ...] (prefetched)."""
        return torch.stack(list(self.map_blocks(None, ids)))
