"""``repro_torch.rsp.ingest`` -- the out-of-core streaming partitioner.

The paper's premise is that RSP blocks are *generated in advance* from a big
distributed data set precisely because the whole set cannot be loaded and
scanned.  The in-memory backends behind ``rsp.partition`` all take the full
corpus as one array; this module closes the gap with a single-pass scatter
form of Algorithm 1 whose peak memory is O(chunk + write buffers), never
O(N).  It is host numpy by nature, as the reference package's is: the
scatter is row movement between files, and its per-block sketches are
folded in float64 with the numpy oracle (``kernels/block_sketch/ref.py``)
and the host sketches (``rsp/sketch.py``), so a store ingested by either
package opens in the other with the same blocks and ``sketches.json``:

``ChunkSource``
    The pluggable input protocol -- corpus dimensions plus a ``chunks()``
    iterator of record batches in storage order.  Four adapters ship:
    :class:`ArrayChunkSource` (in-RAM or memmapped array),
    :class:`NpyChunkSource` (``np.load(mmap_mode="r")`` -- pages stream from
    disk), :class:`DirectoryChunkSource` (a directory of ``.npy`` chunk
    files), and :class:`IterChunkSource` (a plain record-batch iterator).
    :func:`as_chunk_source` adapts arrays, paths, directories, and batch
    sequences.

``stream_partition``
    Algorithm 1 as a scatter pass.  The key identity: the two-stage
    construction ``out[:, i*delta:(i+1)*delta] = original[i][perm].reshape(
    K, delta, ...)[assign]`` fixes every record's destination *before any
    data is seen* -- row ``r`` of original block ``i`` lands in RSP block
    ``inv_assign[inv_perm[r] // delta]`` at offset ``i*delta + inv_perm[r]
    % delta``.  So each incoming chunk is split at original-block
    boundaries and each segment's rows are written directly into their
    destination offsets of a preallocated per-block ``.npy`` (via
    ``RSPStore.create_writer`` / ``np.lib.format.open_memmap``), with the
    per-block ``block_sketch`` state folded incrementally (Chan combine)
    during the write -- the finished store has exact partition-time
    summaries with zero extra corpus scans.  The output is bit-identical
    to ``two_stage_partition_np`` for the same spec and seed, for any
    chunking of the input: both draw the ``_np_rng(seed, 0, i)`` and
    ``_np_rng(seed, 1, i)`` permutation streams.

Scatter writes run on a bounded thread pool (the engine's prefetch-window
pattern): ``workers`` threads keep at most ``max_inflight`` chunk segments
in flight, results are reaped in submission order so sketch folding is
deterministic, and worker exceptions abort the ingest (temps removed, no
manifest published).

``chip_smoke.py`` ingests the HIGGS-sized corpus from a ``.npy`` file on
disk through this path and reports its seconds and peak memory growth.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Iterable, Iterator, Protocol, Sequence, runtime_checkable

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.partition import _np_rng
from repro_torch.core.registry import RSPStore
from repro_torch.core.types import RSPSpec
from repro_torch.device import as_numpy
from repro_torch.kernels.block_sketch.ref import BlockSketch, block_sketch_ref, merge_sketches
from repro_torch.rsp.sketch import (
    LabelsSketch,
    MomentsSketch,
    SketchSuite,
    sketch_schema_descriptor,
)

_DEFAULT_CHUNK_BYTES = 8 << 20  # ~8 MiB of records per auto-sized chunk


# ---------------------------------------------------------------------------
# ChunkSource protocol + adapters
# ---------------------------------------------------------------------------

@runtime_checkable
class ChunkSource(Protocol):
    """Anything that can stream a corpus as record batches in storage order.

    A source may additionally declare ``owns_chunks = True`` to promise that
    every yielded batch is a freshly allocated array nobody mutates
    afterwards; the parallel scatter then skips its defensive per-chunk
    detach copy.  Absent (the default), batches are assumed to alias a
    producer-owned buffer and are copied before asynchronous use.
    """

    @property
    def num_records(self) -> int: ...

    @property
    def record_shape(self) -> tuple[int, ...]: ...

    @property
    def dtype(self) -> np.dtype: ...

    def chunks(self) -> Iterator[np.ndarray]: ...


def _auto_chunk_records(record_shape: tuple[int, ...], dtype: np.dtype) -> int:
    row_bytes = int(np.dtype(dtype).itemsize * max(1, int(np.prod(record_shape, dtype=np.int64))))
    return max(1, _DEFAULT_CHUNK_BYTES // row_bytes)


class ArrayChunkSource:
    """Chunked view of an array already in RAM (or an ``np.memmap``), or of
    a tensor on any device: chunks are materialized host copies, so
    downstream holds no reference to the mmap, and a tensor on the card
    crosses to the host a chunk at a time."""

    owns_chunks = True  # chunks() yields fresh copies

    def __init__(self, array, *, chunk_records: int | None = None):
        self._array = array
        if isinstance(array, torch.Tensor):
            self._dtype = torch.empty((), dtype=array.dtype).numpy().dtype
        else:
            self._dtype = np.dtype(array.dtype)
        self._chunk = int(chunk_records) if chunk_records else _auto_chunk_records(
            self.record_shape, self._dtype
        )

    @property
    def num_records(self) -> int:
        return int(self._array.shape[0])

    @property
    def record_shape(self) -> tuple[int, ...]:
        return tuple(int(d) for d in self._array.shape[1:])

    @property
    def dtype(self) -> np.dtype:
        return self._dtype

    def chunks(self) -> Iterator[np.ndarray]:
        for a in range(0, self.num_records, self._chunk):
            yield np.array(as_numpy(self._array[a : a + self._chunk]))


class NpyChunkSource:
    """One ``.npy`` corpus file streamed via ``np.load(mmap_mode="r")`` --
    pages come off disk chunk by chunk, the file is never loaded whole."""

    owns_chunks = True  # chunks() yields fresh copies

    def __init__(self, path: str, *, chunk_records: int | None = None):
        self.path = os.fspath(path)
        mm = np.load(self.path, mmap_mode="r", allow_pickle=False)
        self._shape = tuple(mm.shape)
        self._dtype = np.dtype(mm.dtype)
        del mm
        self._chunk = int(chunk_records) if chunk_records else _auto_chunk_records(
            self._shape[1:], self._dtype
        )

    @property
    def num_records(self) -> int:
        return int(self._shape[0])

    @property
    def record_shape(self) -> tuple[int, ...]:
        return tuple(self._shape[1:])

    @property
    def dtype(self) -> np.dtype:
        return self._dtype

    def chunks(self) -> Iterator[np.ndarray]:
        mm = np.load(self.path, mmap_mode="r", allow_pickle=False)
        for a in range(0, self.num_records, self._chunk):
            yield np.array(mm[a : a + self._chunk])


class DirectoryChunkSource:
    """A directory of ``.npy`` chunk files, concatenated in sorted filename
    order (the 'distributed data set already on the cluster' layout)."""

    owns_chunks = True  # chunks() yields fresh copies

    def __init__(self, root: str, *, chunk_records: int | None = None):
        self.root = os.fspath(root)
        names = sorted(n for n in os.listdir(self.root) if n.endswith(".npy"))
        if not names:
            raise ValueError(f"no .npy chunk files in {self.root!r}")
        self._files = [NpyChunkSource(os.path.join(self.root, n), chunk_records=chunk_records)
                       for n in names]
        head = self._files[0]
        for f in self._files[1:]:
            if f.record_shape != head.record_shape or f.dtype != head.dtype:
                raise ValueError(
                    f"chunk file {f.path!r} has records {f.record_shape}/{f.dtype},"
                    f" expected {head.record_shape}/{head.dtype}"
                )

    @property
    def num_records(self) -> int:
        return sum(f.num_records for f in self._files)

    @property
    def record_shape(self) -> tuple[int, ...]:
        return self._files[0].record_shape

    @property
    def dtype(self) -> np.dtype:
        return self._files[0].dtype

    def chunks(self) -> Iterator[np.ndarray]:
        for f in self._files:
            yield from f.chunks()


class IterChunkSource:
    """A plain record-batch iterable.  Sequences of arrays are introspected
    for dimensions; true one-shot iterators must declare ``num_records``,
    ``record_shape``, and ``dtype`` up front (the spec and the preallocated
    store need them before the first batch arrives) and can stream only once.
    """

    def __init__(
        self,
        batches: Iterable[np.ndarray],
        *,
        num_records: int | None = None,
        record_shape: tuple[int, ...] | None = None,
        dtype: Any = None,
    ):
        if isinstance(batches, (list, tuple)):
            arrs = [np.asarray(b) for b in batches]
            if not arrs:
                raise ValueError("need at least one batch")
            num_records = sum(int(a.shape[0]) for a in arrs)
            record_shape = tuple(arrs[0].shape[1:])
            dtype = arrs[0].dtype
            batches = arrs
            self._reiterable = True
        else:
            if num_records is None or record_shape is None or dtype is None:
                raise ValueError(
                    "IterChunkSource over a one-shot iterator needs num_records,"
                    " record_shape, and dtype declared up front"
                )
            self._reiterable = False
        self._batches = batches
        self._consumed = False
        self._num_records = int(num_records)
        self._record_shape = tuple(record_shape)
        self._dtype = np.dtype(dtype)

    @property
    def num_records(self) -> int:
        return self._num_records

    @property
    def record_shape(self) -> tuple[int, ...]:
        return self._record_shape

    @property
    def dtype(self) -> np.dtype:
        return self._dtype

    def chunks(self) -> Iterator[np.ndarray]:
        if self._consumed and not self._reiterable:
            raise RuntimeError(
                "this IterChunkSource wraps a one-shot iterator that was already"
                " consumed; rebuild the source to stream again"
            )
        self._consumed = True
        for b in self._batches:
            yield np.asarray(b)


def as_chunk_source(obj: Any, *, chunk_records: int | None = None) -> ChunkSource:
    """Adapt ``obj`` into a :class:`ChunkSource`.

    Accepts an existing source, an array (in-RAM or ``np.memmap``) or a
    tensor, a path to a ``.npy`` file or to a directory of ``.npy`` chunk
    files, or a list/tuple of record batches.
    """
    if (
        hasattr(obj, "chunks")
        and callable(obj.chunks)
        and hasattr(obj, "num_records")
        and not isinstance(obj, np.ndarray)
    ):
        return obj
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return ArrayChunkSource(obj, chunk_records=chunk_records)
    if isinstance(obj, (str, os.PathLike)):
        path = os.fspath(obj)
        if os.path.isdir(path):
            return DirectoryChunkSource(path, chunk_records=chunk_records)
        if os.path.isfile(path) and path.endswith(".npy"):
            return NpyChunkSource(path, chunk_records=chunk_records)
        raise TypeError(f"path {path!r} is neither a .npy file nor a chunk directory")
    if isinstance(obj, (list, tuple)):
        return IterChunkSource(obj)
    raise TypeError(f"cannot build a ChunkSource from {type(obj).__name__}")


def maybe_chunk_source(obj: Any, *, chunk_records: int | None = None) -> ChunkSource | None:
    """:func:`as_chunk_source`, returning None instead of raising -- both for
    unadaptable types and for adapter construction failures (empty chunk
    directory, mismatched shard shapes), so capability predicates built on
    this keep their reason-or-None contract."""
    try:
        return as_chunk_source(obj, chunk_records=chunk_records)
    except (TypeError, ValueError):
        return None


def is_stream_source(obj: Any) -> bool:
    """True for inputs that must stream: everything :func:`as_chunk_source`
    adapts *except* plain in-RAM arrays and tensors (the in-memory backends
    serve those) and bare lists/tuples, which are ambiguous -- the streaming
    layer reads them as record *batches* while array construction reads
    them as records.  Wrap a batch list in :class:`IterChunkSource` to
    stream it explicitly."""
    if _in_memory(obj):
        return False
    return maybe_chunk_source(obj) is not None


def _in_memory(obj: Any) -> bool:
    """Plain in-RAM arrays, tensors and record lists: never streamed unless
    a caller asks for it."""
    if isinstance(obj, np.ndarray) and not isinstance(obj, np.memmap):
        return True
    return isinstance(obj, (torch.Tensor, list, tuple))


def resolve_stream_source(
    obj: Any, *, chunk_records: int | None = None
) -> ChunkSource | None:
    """The facade's one-shot detection: the :class:`ChunkSource` for inputs
    that must stream, or None for array-like inputs (same classification as
    :func:`is_stream_source`, but the adapter is built exactly once and
    returned).  Path-like inputs that *should* adapt but cannot raise with
    the adapter's detailed reason instead of degrading to array handling."""
    if _in_memory(obj):
        return None
    if isinstance(obj, (str, os.PathLike)):
        return as_chunk_source(obj, chunk_records=chunk_records)
    return maybe_chunk_source(obj, chunk_records=chunk_records)


# ---------------------------------------------------------------------------
# Streaming scatter pass (Algorithm 1, out of core)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _SketchAcc:
    """Per-RSP-block fold state, merged in deterministic segment order.

    ``sketch`` folds the kernel-grade moment sketch; ``suite`` carries the
    richer mergeable members (KLL quantiles, KMV distinct counts) that are
    updated with the same rows on the fold thread, in the same deterministic
    submission order."""

    sketch: BlockSketch | None = None
    label_hist: np.ndarray | None = None
    suite: SketchSuite | None = None


def _destinations(i: int, pos: np.ndarray, inv_assign: np.ndarray, delta: int):
    """RSP-block ids and in-block row offsets for original-block ``i`` rows
    whose randomized positions are ``pos`` (the inverse-permutation image)."""
    k = inv_assign[pos // delta]
    dest = i * delta + pos % delta
    return k, dest


def _scatter_segment(
    write_rows,
    rows: np.ndarray,
    i: int,
    pos: np.ndarray,
    inv_assign: np.ndarray,
    delta: int,
    block_size: int,
    *,
    with_summaries: bool,
    num_classes: int | None,
    label_column: int,
) -> list[tuple[int, BlockSketch | None, np.ndarray | None, np.ndarray | None]]:
    """Write one chunk segment (rows of original block ``i``) to its
    destination offsets; returns per-RSP-block mini-sketches (and the flat
    float64 rows, for the richer suite members) for folding."""
    k, dest = _destinations(i, pos, inv_assign, delta)
    order = np.argsort(k.astype(np.int64) * block_size + dest)
    ks = k[order]
    cuts = np.flatnonzero(np.diff(ks)) + 1
    results: list[tuple[int, BlockSketch | None, np.ndarray | None, np.ndarray | None]] = []
    for group in np.split(order, cuts):
        kk = int(k[group[0]])
        vals = rows[group]
        write_rows(kk, dest[group], vals)
        sketch = hist = flat = None
        if with_summaries:
            f64 = np.asarray(vals, dtype=np.float64).reshape(vals.shape[0], -1)
            sketch = block_sketch_ref(f64)
            # retain the source-dtype rows (not the f64 copy) for the
            # KLL/KMV fold on the main thread: the in-flight window holds
            # several of these, and the ingest memory cap is real
            flat = vals.reshape(vals.shape[0], -1)
            if num_classes is not None:
                labels = f64[:, label_column]
                ilabels = labels.astype(np.int64)
                if (
                    np.any(ilabels != labels)
                    or ilabels.min(initial=0) < 0
                    or ilabels.max(initial=0) >= num_classes
                ):
                    raise ValueError(
                        f"block {kk}: label column {label_column} has values outside"
                        f" 0..{num_classes - 1} (wrong label_column or num_classes?)"
                    )
                hist = np.bincount(ilabels, minlength=num_classes)
        results.append((kk, sketch, hist, flat))
    return results


def stream_partition(
    source: Any,
    spec: RSPSpec,
    *,
    out: str | None = None,
    permute_assignment: bool = True,
    with_summaries: bool = True,
    num_classes: int | None = None,
    label_column: int = -1,
    chunk_records: int | None = None,
    workers: int = 4,
    max_inflight: int | None = None,
) -> tuple[np.ndarray | RSPStore, list[SketchSuite] | None]:
    """Single-pass Algorithm 1 over a :class:`ChunkSource` with bounded memory.

    With ``out`` set, blocks are written into preallocated per-block ``.npy``
    temps under ``out`` and published atomically (checksums from the finished
    files, manifest last); the return value is the finished
    :class:`RSPStore`.  With ``out=None`` the scatter targets one in-RAM
    ``[K, n, ...]`` array (the small-corpus / testing path).  Either way the
    result is bit-identical to ``two_stage_partition_np(full_array, spec)``
    and the returned summaries are the sketches folded during the write.

    ``workers=0`` runs the scatter synchronously on the caller's thread (the
    reference behavior, like the engine's ``prefetch=0``).
    """
    src = as_chunk_source(source, chunk_records=chunk_records)
    if src.num_records != spec.num_records:
        raise ValueError(
            f"source has {src.num_records} records, spec says {spec.num_records}"
        )
    if tuple(src.record_shape) != tuple(spec.record_shape):
        raise ValueError(
            f"source records have shape {tuple(src.record_shape)},"
            f" spec says {tuple(spec.record_shape)}"
        )
    P, K = spec.num_original_blocks, spec.num_blocks
    if spec.num_records % (P * K) != 0:
        raise ValueError(
            f"spec unsatisfiable: N={spec.num_records} must be divisible by"
            f" P*K={P * K} so sub-blocks have uniform size delta"
        )
    delta, R, n = spec.slice_size, spec.original_block_size, spec.block_size
    tail = tuple(spec.record_shape)
    dtype = np.dtype(spec.dtype)

    writer = dest = None
    if out is not None:
        writer = RSPStore(out).create_writer(spec)
        write_rows = writer.write_rows
    else:
        dest = np.empty((K, n, *tail), dtype=dtype)

        def write_rows(block_id: int, offsets: np.ndarray, values: np.ndarray) -> None:
            dest[block_id][offsets] = values

    acc = [_SketchAcc() for _ in range(K)]

    def fold(results) -> None:
        if not with_summaries:
            return
        for kk, sketch, hist, flat in results:
            a = acc[kk]
            a.sketch = sketch if a.sketch is None else merge_sketches(a.sketch, sketch)
            if hist is not None:
                a.label_hist = hist if a.label_hist is None else a.label_hist + hist
            if flat is not None:
                if a.suite is None:
                    # KLL/KMV members; moments/labels attach at the end from
                    # the kernel-grade folds above
                    a.suite = SketchSuite.create(kk, kinds=("moments", "kll", "distinct"))
                a.suite.sketches["kll"].update(flat)
                a.suite.sketches["distinct"].update(flat)

    pool = ThreadPoolExecutor(max_workers=max(1, workers), thread_name_prefix="rsp-ingest") \
        if workers > 0 else None
    window: collections.deque[Future] = collections.deque()
    cap = max_inflight if max_inflight is not None else 2 * max(1, workers)

    def submit(i: int, a: int, rows: np.ndarray, inv_perm: np.ndarray,
               inv_assign: np.ndarray) -> None:
        args = (write_rows, rows, i, inv_perm[a : a + rows.shape[0]], inv_assign,
                delta, n)
        kw = dict(with_summaries=with_summaries, num_classes=num_classes,
                  label_column=label_column)
        if pool is None:
            fold(_scatter_segment(*args, **kw))
            return
        while len(window) >= cap:
            fold(window.popleft().result())
        window.append(pool.submit(_scatter_segment, *args, **kw))

    metrics = None
    if obs.enabled():
        reg = obs.get_registry()
        sink = "store" if out is not None else "memory"
        metrics = {
            "chunks": reg.counter(
                "rsp_ingest_chunks_total", "chunks scattered", sink=sink),
            "rows": reg.counter(
                "rsp_ingest_rows_scattered_total", "records scattered", sink=sink),
            "chunk_s": reg.histogram(
                "rsp_ingest_chunk_seconds",
                "split + submit + backpressure time per chunk", sink=sink),
            "rate": reg.gauge(
                "rsp_ingest_rows_per_second", "overall scatter throughput", sink=sink),
        }
        t_ingest = time.perf_counter()

    cursor = 0
    cached_i = -1
    inv_perm = inv_assign = None
    try:
        for chunk in src.chunks():
            t_chunk = time.perf_counter() if metrics is not None else 0.0
            chunk = np.asarray(chunk)
            if chunk.shape[0] == 0:
                continue
            if tuple(chunk.shape[1:]) != tail:
                raise ValueError(
                    f"chunk records have shape {tuple(chunk.shape[1:])}, spec says {tail}"
                )
            if chunk.dtype != dtype:
                chunk = chunk.astype(dtype)
            elif pool is not None and not getattr(src, "owns_chunks", False):
                # detach from any producer-owned buffer: segments are views
                # into the chunk that workers read *after* the producer has
                # moved on, so a source that reuses its batch buffer would
                # otherwise silently corrupt the partition.  Sources that
                # promise fresh per-chunk allocations (owns_chunks) skip the
                # copy -- it would double the hot path's memcpy for nothing.
                chunk = np.array(chunk)
            c0 = 0
            while c0 < chunk.shape[0]:
                i = cursor // R
                if i >= P:
                    raise ValueError(
                        f"source produced more than the {spec.num_records} records"
                        " the spec describes"
                    )
                a = cursor - i * R
                take = min(chunk.shape[0] - c0, R - a)
                if i != cached_i:
                    perm = _np_rng(spec.seed, 0, i).permutation(R)
                    inv_perm = np.argsort(perm)
                    if permute_assignment:
                        assign = _np_rng(spec.seed, 1, i).permutation(K)
                        inv_assign = np.argsort(assign)
                    else:
                        inv_assign = np.arange(K)
                    cached_i = i
                submit(i, a, chunk[c0 : c0 + take], inv_perm, inv_assign)
                cursor += take
                c0 += take
            if metrics is not None:
                metrics["chunks"].inc()
                metrics["rows"].inc(chunk.shape[0])
                metrics["chunk_s"].observe(time.perf_counter() - t_chunk)
        if cursor != spec.num_records:
            raise ValueError(
                f"source produced {cursor} records, spec says {spec.num_records}"
            )
        while window:
            fold(window.popleft().result())
        if metrics is not None:
            elapsed = max(time.perf_counter() - t_ingest, 1e-9)
            metrics["rate"].set(cursor / elapsed)
    except BaseException:
        for fut in window:
            fut.cancel()
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)
            pool = None
        if writer is not None:
            writer.abort()
        raise
    finally:
        if pool is not None:
            pool.shutdown(wait=True)

    summaries = None
    if with_summaries:
        summaries = []
        for k, a in enumerate(acc):
            suite = a.suite if a.suite is not None else SketchSuite.create(
                k, kinds=("moments", "kll", "distinct")
            )
            suite.sketches["moments"] = MomentsSketch.from_block_sketch(a.sketch)
            if a.label_hist is not None:
                suite.sketches["labels"] = LabelsSketch(
                    num_classes, label_column, hist=a.label_hist
                )
            summaries.append(suite)

    if writer is not None:
        store = writer.finalize(
            summaries=summaries,
            meta={
                "backend": "np_stream",
                "num_classes": num_classes,
                "label_column": label_column,
            },
            sketch_schema=None if summaries is None else sketch_schema_descriptor(summaries),
        )
        store.last_ingest_summaries = summaries
        return store, summaries
    return dest, summaries


__all__ = [
    "ArrayChunkSource",
    "ChunkSource",
    "DirectoryChunkSource",
    "IterChunkSource",
    "NpyChunkSource",
    "as_chunk_source",
    "is_stream_source",
    "maybe_chunk_source",
    "resolve_stream_source",
    "stream_partition",
]
