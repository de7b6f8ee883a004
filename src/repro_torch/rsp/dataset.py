"""``RSPDataset`` -- the one-object facade over the RSP pipeline, on a device.

The paper's workflow is one pipeline: partition into RSP blocks
(Algorithm 1), store, block-sample (Definition 4), then estimate (Sec. 8)
with progressive queries::

    ds = rsp.partition(data, blocks=100, seed=1, num_classes=2)   # on the card
    ds.save("/data/corpus.rsp")
    ds = rsp.open("/data/corpus.rsp")
    res = ds.query(["mean", "p95"], target_rel_err=0.01, use_sketches=False)

Every entry point takes ``device=`` and defaults to ``"cuda"``; with no card
present it raises, and only an explicit ``device="cpu"`` runs on the host.
Blocks are tensors on the dataset's device: ``partition`` leaves the stacked
``[K, n, ...]`` result there, and a reopened store moves each block there on
the engine's worker threads.  Partition-time sketches are computed on the
host in numpy float64, as in the reference package, and stores are
byte-compatible with it.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core.registry import RSPStore
from repro_torch.core.sampler import BlockSampler, SamplingPolicy, make_policy
from repro_torch.core.estimators import MomentStats
from repro_torch.core.types import RSPSpec
from repro_torch.device import DEFAULT_DEVICE, as_tensor, resolve_device
from repro_torch.rsp.backends import AUTO, PartitionRequest, run_partition
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
        device: str | torch.device = DEFAULT_DEVICE,
    ) -> "RSPDataset":
        """Partition ``data`` [N, ...] (numpy array or tensor) into an RSP of
        ``blocks`` blocks on ``device``.

        ``backend="auto"`` picks the ``cuda`` backend (the ``rsp_shuffle``
        kernel) for 2-D float data on a CUDA device and the bit-exact numpy
        path otherwise; pass a name to force one.  ``num_classes`` marks
        column ``label_column`` as a class label, so label histograms join
        the per-block sketches.  ``out`` saves the partition there.
        """
        dev = resolve_device(device)
        spec = RSPSpec(
            num_records=int(data.shape[0]),
            num_blocks=blocks,
            num_original_blocks=blocks if original_blocks is None else original_blocks,
            record_shape=tuple(int(d) for d in data.shape[1:]),
            dtype=_dtype_name(data),
            seed=seed,
        )
        request = PartitionRequest(
            data=data, spec=spec, device=dev, permute_assignment=permute_assignment
        )
        result, chosen = run_partition(request, backend=backend)
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

    # ------------------------------------------------------------------
    # Diagnostics (Sec. 7)
    # ------------------------------------------------------------------
    def label_divergence(self) -> float:
        """Worst block-vs-corpus label L-inf distance, from the sketches alone."""
        return max_divergence_from_summaries(self.summaries)

    def __repr__(self) -> str:
        src = "memory" if self._blocks is not None else f"store:{self._store.root}"
        return (
            f"RSPDataset(K={self.num_blocks}, n={self.block_size}, "
            f"record_shape={self.spec.record_shape}, backend={self.backend!r}, "
            f"device={str(self.device)!r}, source={src})"
        )
