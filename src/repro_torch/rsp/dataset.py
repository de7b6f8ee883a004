"""``RSPDataset`` -- the one-object facade over the RSP pipeline, on a device.

The paper's workflow is one pipeline: partition into RSP blocks
(Algorithm 1), store, block-sample (Definition 4), then estimate (Sec. 8)
with progressive queries, many analysts at once, or ensemble-learn
(Sec. 9, Algorithm 2) and feed a training loop::

    ds = rsp.partition(data, blocks=100, seed=1, num_classes=2)   # on the card
    ds.save("/data/corpus.rsp")
    ds = rsp.from_source("/data/corpus.npy", blocks=100, out="/data/c.rsp")
    ds = rsp.open("/data/corpus.rsp")
    res = ds.query(["mean", "p95"], target_rel_err=0.01, use_sketches=False)
    est = ds.estimator(g=20)                       # block-level moments
    with ds.serve(capacity=64, workers=8) as svc:  # concurrent tenants
        res = svc.result(svc.submit("p95", deadline_ms=500))
    ens, hist = ds.ensemble(make_logreg(28, 2), eval_x=xe, eval_y=ye, g=5)
    mmd = ds.similarity(3, metric="mmd")           # Sec. 7 diagnostics
    loader = ds.loader(8192, seed=0)               # training batches

Every entry point takes ``device=`` and defaults to ``"cuda"``; with no card
present it raises, and only an explicit ``device="cpu"`` runs on the host.
Blocks are tensors on the dataset's device: ``partition`` leaves the stacked
``[K, n, ...]`` result there, and a reopened store moves each block there on
the engine's worker threads.  Partition-time sketches are computed on the
host in numpy float64, as in the reference package, and stores are
byte-compatible with it.  A corpus on disk streams into a store through
the host scatter of ``rsp/ingest.py`` (the ``np_stream`` backend).
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.core.ensemble import (
    BaseLearner,
    Ensemble,
    EnsembleHistory,
    asymptotic_ensemble_learn,
)
from repro_torch.core.registry import RSPStore
from repro_torch.core.sampler import (
    BlockSampler,
    HostAssignment,
    SamplingPolicy,
    deal_blocks,
    make_policy,
)
from repro_torch.core.estimators import BlockLevelEstimator, MomentStats, streaming_estimate
from repro_torch.core.similarity import ks_statistic, max_label_divergence, mmd_block_vs_data
from repro_torch.core.types import RSPSpec
from repro_torch.device import DEFAULT_DEVICE, as_numpy, as_tensor, resolve_device
from repro_torch.rsp.backends import AUTO, PartitionRequest, run_partition
from repro_torch.rsp.ingest import resolve_stream_source
from repro_torch.rsp.engine import (
    BlockExecutor,
    BlockFetcher,
    MemoryFetcher,
    MmapFetcher,
    StoreFetcher,
    as_fetcher,
)
from repro_torch.rsp.sketch import SketchSuite, load_summaries, sketch_schema_descriptor
from repro_torch.rsp.summaries import (
    BlockSummary,
    combine_summaries,
    max_divergence_from_summaries,
    summarize_blocks,
)


def _dtype_name(data) -> str:
    if isinstance(data, torch.Tensor):
        return str(torch.empty((), dtype=data.dtype).numpy().dtype)
    return str(np.dtype(getattr(data, "dtype", np.float32)))


class RSPDataset:
    """A materialized Random Sample Partition with chainable analysis ops."""

    def __init__(
        self,
        spec: RSPSpec,
        *,
        blocks: torch.Tensor | np.ndarray | None = None,
        store: RSPStore | None = None,
        backend: str = "np",
        summaries: list[SketchSuite] | list[BlockSummary] | None = None,
        num_classes: int | None = None,
        label_column: int = -1,
        fetcher: str | BlockFetcher = "auto",
        prefetch: int = 4,
        cache_blocks: int = 8,
        device: str | torch.device = DEFAULT_DEVICE,
    ):
        if blocks is None and store is None:
            raise ValueError("provide in-memory blocks and/or a store")
        self.device = resolve_device(device)
        self.spec = spec
        self.backend = backend
        self.num_classes = num_classes
        self.label_column = label_column
        self._blocks = None if blocks is None else as_tensor(blocks, self.device)
        self._store = store
        self._summaries = summaries
        self._fetcher_mode = fetcher
        self._prefetch = prefetch
        self._cache_blocks = cache_blocks
        self._executor: BlockExecutor | None = None

    # ------------------------------------------------------------------
    # Construction: Algorithm 1 through the backend registry
    # ------------------------------------------------------------------
    @classmethod
    def partition(
        cls,
        data: Any,
        blocks: int,
        *,
        original_blocks: int | None = None,
        seed: int = 0,
        backend: str = AUTO,
        permute_assignment: bool = True,
        num_classes: int | None = None,
        label_column: int = -1,
        summaries: bool = True,
        out: str | None = None,
        chunk_records: int | None = None,
        mesh: Any = None,
        mesh_axis: str = "data",
        device: str | torch.device = DEFAULT_DEVICE,
    ) -> "RSPDataset":
        """Partition ``data`` [N, ...] into an RSP of ``blocks`` blocks on
        ``device``.

        ``data`` may be a numpy array or tensor, or any streaming source
        ``rsp.ingest.as_chunk_source`` adapts (a ``.npy`` path read via
        mmap, a directory of chunk files, a record-batch ``ChunkSource``, a
        memmap) -- streaming sources never load the corpus whole.
        ``backend="auto"`` picks the out-of-core ``np_stream`` scatter for
        streaming sources and whenever ``out=`` is given, the ``cuda``
        backend (the ``rsp_shuffle`` kernel) for 2-D float data on a CUDA
        device, and the bit-exact numpy path otherwise; pass a name to
        force one.

        ``out`` writes the partition into a store at that path: the
        streaming backend scatters chunk slices straight to their
        block-file offsets (the corpus never materializes) and the returned
        dataset is store-backed, its blocks loading onto ``device``;
        in-memory backends save their result there.  ``num_classes`` marks
        column ``label_column`` as a class label, so label histograms join
        the per-block sketches.

        ``mesh`` (a ``torch.distributed`` ``DeviceMesh``, whose dimension
        ``mesh_axis`` names the group, or a ``ProcessGroup`` of D gloo
        ranks) makes ``auto`` pick the ``collective`` backend: every rank
        calls ``partition`` with the whole corpus and ``blocks =
        original_blocks = D``, randomizes its own original block, and
        receives its RSP block through one ``all_to_all``; every rank's
        dataset then holds all D blocks.
        """
        dev = resolve_device(device)
        # memmaps are arrays: when an in-memory backend is forced they stay
        # raw (it serves them fine); under auto/np_stream they stream
        src = None
        if not isinstance(data, (np.ndarray, torch.Tensor)) or backend in (AUTO, "np_stream"):
            src = resolve_stream_source(data, chunk_records=chunk_records)
        if src is not None:
            data = src
            n, record_shape = src.num_records, tuple(src.record_shape)
            dtype = str(np.dtype(src.dtype))
        else:
            n, record_shape = int(data.shape[0]), tuple(int(d) for d in data.shape[1:])
            dtype = _dtype_name(data)
        spec = RSPSpec(
            num_records=n,
            num_blocks=blocks,
            num_original_blocks=blocks if original_blocks is None else original_blocks,
            record_shape=record_shape,
            dtype=dtype,
            seed=seed,
        )
        request = PartitionRequest(
            data=data,
            spec=spec,
            device=dev,
            permute_assignment=permute_assignment,
            out=out,
            with_summaries=summaries,
            num_classes=num_classes,
            label_column=label_column,
            chunk_records=chunk_records,
            mesh=mesh,
            mesh_axis=mesh_axis,
        )
        result, chosen = run_partition(request, backend=backend)
        if isinstance(result, RSPStore):
            # the streaming backend wrote the store; its sketches are the
            # suites folded during the write (no re-parse of the sidecar)
            return cls(
                spec,
                store=result,
                backend=chosen,
                summaries=result.last_ingest_summaries,
                num_classes=num_classes,
                label_column=label_column,
                device=dev,
            )
        ds = cls(
            spec,
            blocks=result,
            backend=chosen,
            num_classes=num_classes,
            label_column=label_column,
            device=dev,
        )
        if summaries:
            ds._summaries = ds._compute_summaries()
        if out is not None:
            ds.save(out)
        return ds

    @classmethod
    def from_source(
        cls,
        source: Any,
        blocks: int,
        *,
        out: str | None = None,
        original_blocks: int | None = None,
        seed: int = 0,
        permute_assignment: bool = True,
        num_classes: int | None = None,
        label_column: int = -1,
        summaries: bool = True,
        chunk_records: int | None = None,
        device: str | torch.device = DEFAULT_DEVICE,
    ) -> "RSPDataset":
        """Build an RSP from a chunked source with bounded memory (the
        out-of-core ingest path, forced).  ``source`` is anything
        ``as_chunk_source`` adapts; with ``out`` set the corpus streams
        straight into a stored RSP whose manifest carries the
        partition-time sketches -- peak memory stays O(chunk + write
        buffers) no matter how large the corpus is.  The dataset's blocks
        live on ``device``."""
        return cls.partition(
            source,
            blocks,
            original_blocks=original_blocks,
            seed=seed,
            backend="np_stream",
            permute_assignment=permute_assignment,
            num_classes=num_classes,
            label_column=label_column,
            summaries=summaries,
            out=out,
            chunk_records=chunk_records,
            device=device,
        )

    @classmethod
    def from_arrays(
        cls,
        spec: dict,
        blocks: np.ndarray,
        summaries: list[dict] | None = None,
        *,
        num_classes: int | None = None,
        label_column: int = -1,
        backend: str = "np",
        device: str | torch.device = DEFAULT_DEVICE,
    ) -> "RSPDataset":
        """A dataset from plain state: the spec as a dict (``RSPSpec``'s
        JSON fields), the stacked blocks ``[K, n, ...]`` as a numpy array and
        the per-block sketch dicts (``SketchSuite.to_dict()`` or v1 summary
        dicts).  This is how another implementation's partition -- for
        example the reference package's -- is carried across."""
        raw = dict(spec)
        raw["record_shape"] = tuple(raw.get("record_shape", ()))
        return cls(
            RSPSpec(**raw),
            blocks=np.asarray(blocks),
            backend=backend,
            summaries=None if summaries is None else load_summaries(summaries),
            num_classes=num_classes,
            label_column=label_column,
            device=device,
        )

    # ------------------------------------------------------------------
    # Block access: one executor owns all block movement
    # ------------------------------------------------------------------
    @property
    def num_blocks(self) -> int:
        return self.spec.num_blocks

    @property
    def block_size(self) -> int:
        return self.spec.block_size

    def __len__(self) -> int:
        return self.num_blocks

    @property
    def executor(self) -> BlockExecutor:
        """The dataset's :class:`BlockExecutor` (built lazily): prefetch
        pipeline + LRU cache over the configured fetcher."""
        if self._executor is None:
            self._executor = BlockExecutor(
                self._make_fetcher(),
                prefetch=self._prefetch,
                cache_blocks=self._cache_blocks,
            )
        return self._executor

    def _make_fetcher(self) -> BlockFetcher:
        mode = self._fetcher_mode
        if not isinstance(mode, str):
            return as_fetcher(mode, device=self.device)
        if mode == "auto":
            if self._blocks is not None:
                return MemoryFetcher(self._blocks)
            return StoreFetcher(self._store, device=self.device)
        if mode == "memory":
            if self._blocks is None:
                with BlockExecutor(
                    StoreFetcher(self._store, device=self.device),
                    prefetch=self._prefetch,
                    cache_blocks=0,
                ) as loadall:
                    self._blocks = loadall.take(range(self.num_blocks))
            return MemoryFetcher(self._blocks)
        if mode in ("store", "mmap"):
            if self._store is None:
                raise ValueError(f"fetcher={mode!r} needs a store-backed dataset")
            if mode == "store":
                return StoreFetcher(self._store, device=self.device)
            return MmapFetcher(self._store, device=self.device)
        raise ValueError(
            f"unknown fetcher {mode!r} (auto | memory | store | mmap | BlockFetcher)"
        )

    def close(self) -> None:
        """Release the executor's worker threads (optional; idle otherwise)."""
        if self._executor is not None:
            self._executor.close()
            self._executor = None

    def block(self, block_id: int) -> torch.Tensor:
        if not 0 <= block_id < self.num_blocks:
            raise IndexError(f"block {block_id} out of range [0, {self.num_blocks})")
        return self.executor.fetch(block_id)

    def __getitem__(self, block_id: int) -> torch.Tensor:
        return self.block(block_id)

    def take(self, block_ids: Sequence[int]) -> torch.Tensor:
        """Stack the given blocks -> [g, n, ...] (prefetched)."""
        return self.executor.take(block_ids)

    def stacked(self) -> torch.Tensor:
        """All blocks as one [K, n, ...] tensor on the device (loads all)."""
        if self._blocks is None:
            self._blocks = self.executor.take(range(self.num_blocks))
        return self._blocks

    # ------------------------------------------------------------------
    # Per-block summary statistics (partition-time sketches)
    # ------------------------------------------------------------------
    @property
    def summaries(self) -> list[SketchSuite]:
        if self._summaries is None:
            self._summaries = self._compute_summaries()
        return self._summaries

    @property
    def has_summaries(self) -> bool:
        """Whether partition-time sketches are already materialized (without
        triggering the full-corpus pass that computes them)."""
        return self._summaries is not None

    def _compute_summaries(self, counter=None) -> list[SketchSuite]:
        label_column = self.label_column if self.num_classes is not None else None
        return summarize_blocks(
            self.executor.map_blocks(None, range(self.num_blocks), counter=counter),
            label_column=label_column,
            num_classes=self.num_classes,
        )

    # ------------------------------------------------------------------
    # Storage
    # ------------------------------------------------------------------
    def save(self, path: str) -> "RSPDataset":
        """Materialize to ``path`` (blocks + manifest with sketches); the
        bytes are those the reference package writes for the same blocks."""
        store = RSPStore(path)
        summaries = self.summaries
        schema = (
            sketch_schema_descriptor(summaries)
            if summaries and isinstance(summaries[0], SketchSuite)
            else None
        )
        store.write_partition(
            self.stacked(),
            self.spec,
            summaries=summaries,
            meta={
                "backend": self.backend,
                "num_classes": self.num_classes,
                "label_column": self.label_column,
            },
            sketch_schema=schema,
        )
        self._store = store
        return self

    @classmethod
    def open(
        cls,
        path: str,
        *,
        fetcher: str | BlockFetcher = "auto",
        prefetch: int = 4,
        cache_blocks: int = 8,
        device: str | torch.device = DEFAULT_DEVICE,
    ) -> "RSPDataset":
        """Open a stored RSP (written by either package); blocks load lazily
        onto ``device``, sketches come from the manifest."""
        store = RSPStore(path)
        meta = store.meta()
        raw = store.summaries()
        return cls(
            store.spec(),
            store=store,
            backend=str(meta.get("backend", "np")),
            summaries=None if raw is None else load_summaries(raw),
            num_classes=meta.get("num_classes"),
            label_column=int(meta.get("label_column", -1)),
            fetcher=fetcher,
            prefetch=prefetch,
            cache_blocks=cache_blocks,
            device=device,
        )

    @property
    def store(self) -> RSPStore | None:
        return self._store

    # ------------------------------------------------------------------
    # Block-level sampling (Definition 4 + sketch-guided policies)
    # ------------------------------------------------------------------
    def sampler(self, seed: int = 0) -> BlockSampler:
        return BlockSampler(self.num_blocks, seed=seed)

    def policy(
        self, policy: str | SamplingPolicy = "uniform", *, seed: int = 0, **kwargs
    ) -> SamplingPolicy:
        """Resolve a block-selection policy over this dataset.  ``weighted``,
        ``stratified`` and ``query_aware`` read the partition-time sketches."""
        needs_sketches = isinstance(policy, str) and policy != "uniform"
        return make_policy(
            policy,
            self.num_blocks,
            seed=seed,
            summaries=self.summaries if needs_sketches else None,
            **kwargs,
        )

    def sample(
        self, g: int, *, seed: int = 0, policy: str | SamplingPolicy = "uniform"
    ) -> list[int]:
        """One block-level sample of g block ids under ``policy``."""
        return self.policy(policy, seed=seed).sample(g)

    def deal(self, num_hosts: int, *, seed: int = 0, epoch: int = 0) -> HostAssignment:
        """Deal block ids across hosts for one epoch (multi-host training)."""
        return deal_blocks(self.num_blocks, num_hosts, seed=seed, epoch=epoch)

    # ------------------------------------------------------------------
    # Estimation (Sec. 8)
    # ------------------------------------------------------------------
    def moments(
        self,
        g: int | None = None,
        *,
        seed: int = 0,
        ids: Sequence[int] | None = None,
        policy: str | SamplingPolicy = "uniform",
    ) -> MomentStats:
        """Corpus moments estimated from a block-level sample of ``g`` blocks
        (``ids`` if given, all blocks when both are None), combined from the
        partition-time sketches -- no block data is read.  A non-uniform
        ``policy`` Horvitz-Thompson reweights the combine."""
        summaries = self.summaries
        non_uniform = isinstance(policy, SamplingPolicy) or policy != "uniform"
        if ids is not None and non_uniform:
            raise ValueError(
                "pass either ids or a non-uniform policy, not both: explicit ids"
                " have no selection probabilities to HT-reweight by"
            )
        if non_uniform:
            if g is None:
                raise ValueError("non-uniform policies need g")
            pol = self.policy(policy, seed=seed)
            ids = pol.sample(g)
            return combine_summaries(
                [summaries[k] for k in ids],
                weights=pol.weights(ids),
                total_count=self.spec.num_records,
            )
        if ids is None:
            ids = range(self.num_blocks) if g is None else self.sample(g, seed=seed)
        return combine_summaries([summaries[k] for k in ids])

    def estimator(
        self,
        g: int | None = None,
        *,
        seed: int = 0,
        ids: Sequence[int] | None = None,
        rel_tol: float | None = None,
        impl: str = "auto",
    ) -> BlockLevelEstimator:
        """A ``BlockLevelEstimator`` fed through the executor's prefetched
        block stream -- use when the convergence history / plateau detector
        is wanted.  ``rel_tol`` stops the scan at the plateau.  Each block's
        moments come from the ``block_sketch`` kernel on the card
        (``impl="auto"``; ``"torch"`` runs its plain version)."""
        if ids is None:
            ids = range(self.num_blocks) if g is None else self.sample(g, seed=seed)
        return streaming_estimate(self.executor, ids, rel_tol=rel_tol, impl=impl)

    def estimate(
        self,
        fn: Callable[[torch.Tensor], Any],
        g: int | None = None,
        *,
        seed: int = 0,
        policy: str | SamplingPolicy = "uniform",
    ) -> Any:
        """Block-level estimate of an arbitrary statistic: mean of ``fn(block)``
        over a block-level sample (each block is a random sample, so the
        average is an unbiased estimate of the corpus statistic).  ``fn``
        takes a block tensor on the dataset's device and runs on the
        executor's workers, overlapping with the fetch of later blocks; its
        values are averaged on the host in float64.  Non-uniform policies
        contribute self-normalized HT weights."""
        pol = None
        if isinstance(policy, SamplingPolicy) or policy != "uniform":
            if g is None:
                raise ValueError("non-uniform policies need g")
            pol = self.policy(policy, seed=seed)
            ids = pol.sample(g)
        else:
            ids = list(range(self.num_blocks)) if g is None else self.sample(g, seed=seed)
        values = [as_numpy(v) for v in self.executor.map_blocks(fn, ids)]
        weights = pol.weights(ids) if pol is not None else None
        return np.average(values, axis=0, weights=weights)

    # ------------------------------------------------------------------
    # Declarative queries (progressive, anytime CIs)
    # ------------------------------------------------------------------
    def query(self, aggregates="mean", **kwargs):
        """Answer a declarative aggregate query with anytime confidence
        intervals, reading as few blocks as the stopping rule allows (see
        :class:`repro_torch.rsp.query.Query` for the keywords).  Blocks are
        sketched on the dataset's device: ``sketch_impl="auto"`` runs the
        CUDA kernels on the card."""
        from repro_torch.rsp.query import QueryExecutor, as_query

        return QueryExecutor(self, as_query(aggregates, **kwargs)).run()

    def query_stream(self, aggregates="mean", **kwargs):
        """Progressive variant of :meth:`query`: one anytime ``QueryResult``
        per block read."""
        from repro_torch.rsp.query import QueryExecutor, as_query

        return QueryExecutor(self, as_query(aggregates, **kwargs)).stream()

    def distribute(self, transport, *, ownership=None, **kwargs):
        """This dataset as one host of a mesh: a
        :class:`~repro_torch.distributed.DistributedDataset` whose queries
        fan block work out over ``transport`` (a
        :class:`~repro_torch.distributed.mesh.Transport`), with this host
        reading only its owned blocks, onto this dataset's device.
        ``ownership`` defaults to the deterministic deal of ``num_blocks``
        over ``transport.num_hosts`` seeded by the partition seed;
        ``straggler_grace=`` / ``poll_interval=`` forward to
        ``DistributedDataset``.  Requires materialized partition-time
        sketches (open a store that carries them, or partition with
        ``summaries=True``)."""
        from repro_torch.distributed.rsp import DistributedDataset

        return DistributedDataset(self, transport, ownership=ownership, **kwargs)

    def serve(self, **kwargs):
        """A concurrent multi-tenant :class:`~repro_torch.serve.QueryService`
        over this dataset: many simultaneous queries share this dataset's
        ``BlockExecutor`` block cache, an admission controller bounds
        in-flight block-I/O demand, a deadline-aware scheduler interleaves
        one-block progressive steps across tenants (each step's sketch runs
        on the dataset's device), and every query can return an anytime
        result when its deadline fires.  Keyword arguments (``capacity=``,
        ``max_queue=``, ``workers=``, ``seed=``, ``default_deadline_ms=``)
        forward to ``QueryService``.  Use as a context manager or call
        ``close()`` to release the worker threads."""
        from repro_torch.serve.query_service import QueryService

        return QueryService(self, **kwargs)

    # ------------------------------------------------------------------
    # Ensemble learning (Sec. 9, Algorithm 2)
    # ------------------------------------------------------------------
    def ensemble(
        self,
        learner: BaseLearner,
        *,
        eval_x: Any,
        eval_y: Any,
        g: int = 5,
        batches: int | None = None,
        seed: int = 0,
        improvement_tol: float = 1e-3,
        patience: int = 2,
    ) -> tuple[Ensemble, EnsembleHistory]:
        """Asymptotic ensemble learning over block-level samples.  Records
        are split into features/label via ``label_column`` (set
        ``num_classes`` at partition time).  Blocks stream through the
        executor per batch, so a store-backed dataset only reads the sampled
        blocks; the base models train on the dataset's device, and the
        evaluation set is moved there."""
        if self.num_classes is None:
            raise ValueError("ensemble needs num_classes (set it at partition time)")

        def fetch(ids):
            return self._split_xy(self.executor.take(ids))

        return asymptotic_ensemble_learn(
            learner=learner,
            eval_x=as_tensor(eval_x, self.device),
            eval_y=as_tensor(eval_y, self.device),
            g=g,
            seed=seed,
            improvement_tol=improvement_tol,
            patience=patience,
            max_batches=batches,
            num_blocks=self.num_blocks,
            fetch_blocks=fetch,
        )

    def _split_xy(self, stacked: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Stacked records -> (features without the label column, int64 labels)."""
        col = self.label_column % stacked.shape[-1]
        ys = stacked[..., col].to(torch.int64)
        keep = [c for c in range(stacked.shape[-1]) if c != col]
        xs = stacked[..., torch.as_tensor(keep, device=stacked.device)]
        return xs, ys

    # ------------------------------------------------------------------
    # Similarity / diagnostics (Sec. 7)
    # ------------------------------------------------------------------
    def similarity(
        self,
        block_id: int,
        *,
        metric: str = "mmd",
        feature: int = 0,
        max_points: int = 1024,
        seed: int = 0,
    ) -> float:
        """How close block ``block_id`` is to the full corpus, computed on
        the dataset's device.

        ``metric="mmd"``: unbiased MMD^2 (RBF, median-heuristic bandwidth);
        ``metric="ks"``: two-sample KS statistic on one feature column;
        ``metric="labels"``: L-inf label-distribution distance (needs
        ``num_classes``).

        The corpus reference is the full in-memory partition when available
        (the probed block is legitimately a 1/K fraction of it); for
        store-backed datasets it is a bounded block-level sample (valid by
        Lemma 1 -- each block is a random sample) that *excludes* the probed
        block, since a small reference that contained the probe would
        overweight it far beyond its 1/K corpus share and shrink every
        distance.
        """
        block = self.block(block_id)
        corpus = self._corpus_reference(
            max(max_points, 4096), seed=seed, exclude=block_id
        )
        if metric == "mmd":
            return mmd_block_vs_data(block, corpus, max_points=max_points, seed=seed)
        if metric == "ks":
            return ks_statistic(block[:, feature], corpus[:, feature])
        if metric == "labels":
            if self.num_classes is None:
                raise ValueError("metric='labels' needs num_classes")
            col = self.label_column
            return max_label_divergence(block[:, col], corpus[:, col], self.num_classes)
        raise ValueError(f"unknown metric {metric!r} (mmd | ks | labels)")

    def _corpus_reference(
        self, max_records: int, *, seed: int = 0, exclude: int | None = None
    ) -> torch.Tensor:
        """Flat [M, ...] corpus sample for similarity comparisons: the whole
        partition when in memory, else >= ``max_records`` records from a
        block-level sample (no full-corpus load).  ``exclude`` keeps a probed
        block out of its own reference set (self-inclusion shrinks any
        block-vs-corpus distance)."""
        if self._blocks is not None:
            return self._blocks.reshape(-1, *self.spec.record_shape)
        g = min(self.num_blocks, max(1, -(-max_records // self.block_size)))
        request = min(self.num_blocks, g + (1 if exclude is not None else 0))
        ids = self.sample(request, seed=seed)
        if exclude is not None:
            ids = [i for i in ids if i != exclude][:g]
            if not ids:
                # single-block store: the probe IS the corpus (degenerate)
                ids = [exclude]
        return self.executor.take(ids).reshape(-1, *self.spec.record_shape)

    def label_divergence(self) -> float:
        """Worst block-vs-corpus label L-inf distance, from the sketches alone."""
        return max_divergence_from_summaries(self.summaries)

    # ------------------------------------------------------------------
    # Training pipeline
    # ------------------------------------------------------------------
    def loader(
        self,
        batch_size: int,
        *,
        seed: int = 0,
        policy: str | SamplingPolicy = "uniform",
        prefetch: int = 2,
        **kwargs,
    ):
        """An ``RSPLoader`` over this dataset: block-level sampled batches,
        prefetched through the engine, as tensors on the dataset's device
        (``policy`` selects blocks)."""
        from repro_torch.data.loader import BlockSource, RSPLoader

        # the loader gets the dataset's configured fetcher (memory / store /
        # mmap / custom) but its own cache-free executor: blocks stream in
        # one hop, not through this dataset's executor and LRU cache (which
        # would retain single-use training blocks)
        return RSPLoader(
            BlockSource(dataset=self),
            batch_size=batch_size,
            seed=seed,
            policy=policy,
            prefetch=prefetch,
            fetcher=self._make_fetcher(),
            **kwargs,
        )

    def __repr__(self) -> str:
        src = "memory" if self._blocks is not None else f"store:{self._store.root}"
        return (
            f"RSPDataset(K={self.num_blocks}, n={self.block_size}, "
            f"record_shape={self.spec.record_shape}, backend={self.backend!r}, "
            f"device={str(self.device)!r}, source={src})"
        )
