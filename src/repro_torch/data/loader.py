"""RSP-backed training data loader, on a device.

The loader realizes the paper's pipeline for model training: the corpus is an
RSP (materialized via ``core.registry.RSPStore`` or held in memory), each host
consumes a block-level sample stream (Definition 4, or a sketch-guided
``SamplingPolicy``), and global batches are assembled from the records of the
currently open blocks.  By Lemma 1 every global batch is a random sample of
the corpus -- with no run-time global shuffle, and with O(1)-sized resumable
state.

Batches are tensors on the source's device (the card unless asked for the
CPU).  Block movement is delegated to ``repro_torch.rsp.engine.BlockExecutor``:
the loader keeps ``open_blocks + prefetch`` blocks in flight, each fetched
onto the device and permuted there on the executor's worker threads, and
worker exceptions propagate to ``next_batch()`` instead of hanging the
consumer.  The in-block permutation is the reference package's numpy
``SeedSequence([seed, 0xD47A, tag, block_id])`` permutation, drawn on the
host and applied with one gather on the device, so the batches are the
reference's bit for bit, and ``state_dict`` uses its schema: a state saved
by either package resumes in the other.
"""

from __future__ import annotations

import collections
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch.core.registry import RSPStore
from repro_torch.core.sampler import SamplingPolicy, make_policy
from repro_torch.device import DEFAULT_DEVICE, as_tensor, resolve_device


class BlockSource:
    """Uniform interface over in-memory stacked blocks, an RSPStore, or a
    ``repro_torch.rsp.RSPDataset`` (anything with ``num_blocks`` /
    ``block(k)``).  Loaded blocks are tensors on ``device`` (the card unless
    asked for the CPU; a dataset's blocks stay on the dataset's device)."""

    def __init__(
        self,
        blocks=None,
        store: RSPStore | None = None,
        dataset=None,
        *,
        device: str | torch.device = DEFAULT_DEVICE,
    ):
        if sum(x is not None for x in (blocks, store, dataset)) != 1:
            raise ValueError("provide exactly one of blocks / store / dataset")
        self.device = dataset.device if dataset is not None else resolve_device(device)
        self._blocks = None if blocks is None else as_tensor(blocks, self.device)
        self._store = store
        self._dataset = dataset
        self._summaries = None

    @property
    def num_blocks(self) -> int:
        if self._blocks is not None:
            return self._blocks.shape[0]
        if self._dataset is not None:
            return self._dataset.num_blocks
        return self._store.num_blocks()

    def load(self, block_id: int) -> torch.Tensor:
        if self._blocks is not None:
            return self._blocks[block_id]
        if self._dataset is not None:
            return self._dataset.block(block_id)
        return as_tensor(self._store.load_block(block_id), self.device)

    def summaries(self):
        """Per-block sketches for sketch-guided sampling policies: from the
        dataset / store manifest when present, else computed once from the
        blocks (one full scan, cached)."""
        if self._dataset is not None:
            return self._dataset.summaries
        from repro_torch.rsp.sketch import load_summaries
        from repro_torch.rsp.summaries import summarize_blocks

        if self._summaries is None:
            raw = self._store.summaries() if self._store is not None else None
            if raw is not None:
                self._summaries = load_summaries(raw)
            else:
                self._summaries = summarize_blocks(
                    self.load(k) for k in range(self.num_blocks)
                )
        return self._summaries


class _OpenBlock:
    """One sampled block in the loader's pool: id, permutation tag, the
    (possibly still in-flight) permuted records, and the read cursor."""

    __slots__ = ("block_id", "tag", "cursor", "_future", "_records")

    def __init__(self, block_id: int, tag: int, future: Future, cursor: int = 0):
        self.block_id = block_id
        self.tag = tag
        self.cursor = cursor
        self._future = future
        self._records: torch.Tensor | None = None

    def records(self) -> torch.Tensor:
        """The permuted block; blocks until the fetch lands and re-raises any
        worker exception here."""
        if self._records is None:
            self._records = self._future.result()
        return self._records

    def cancel(self) -> None:
        self._future.cancel()


class RSPLoader:
    """Per-host batch iterator over an RSP corpus.

    Batches of ``batch_size`` records are drawn from a rolling pool of
    sampled blocks; when a block is exhausted the policy provides the next
    one.  Records inside a block are consumed in a per-visit permuted order
    (cheap: block fits in memory by construction).  The engine keeps
    ``open_blocks + prefetch`` blocks in flight on worker threads
    (``prefetch=0`` falls back to synchronous loads).

    ``state_dict``/``load_state_dict`` capture (policy state, open-pool
    block ids + cursors) for exact O(open-pool) restart -- resuming reloads
    only the blocks that were open, never the consumed history.
    """

    def __init__(
        self,
        source: BlockSource,
        *,
        batch_size: int,
        seed: int = 0,
        open_blocks: int = 2,
        drop_last: bool = True,
        transform: Callable[[torch.Tensor], torch.Tensor] | None = None,
        policy: str | SamplingPolicy = "uniform",
        prefetch: int = 2,
        fetcher=None,
        executor=None,
    ):
        from repro_torch.rsp.engine import BlockExecutor, as_fetcher

        self.source = source
        self.batch_size = batch_size
        self.open_blocks = open_blocks
        self.drop_last = drop_last
        self.transform = transform
        self._seed = seed
        needs_sketches = isinstance(policy, str) and policy != "uniform"
        self.policy = make_policy(
            policy,
            source.num_blocks,
            seed=seed,
            summaries=source.summaries() if needs_sketches else None,
        )
        self._owns_executor = executor is None
        # blocks are consumed once per epoch: no LRU benefit, so cache off.
        # ``fetcher`` overrides where blocks come from (e.g. the dataset's
        # configured mmap/custom fetcher) while ``source`` still provides
        # num_blocks and sketches.
        self._executor = executor if executor is not None else BlockExecutor(
            as_fetcher(source if fetcher is None else fetcher),
            prefetch=prefetch,
            cache_blocks=0,
        )
        self._pool: collections.deque[_OpenBlock] = collections.deque()
        self._consumed_batches = 0

    @property
    def sampler(self):
        """The underlying ``BlockSampler`` (uniform policy only; else None)."""
        return getattr(self.policy, "sampler", None)

    # -- iteration -----------------------------------------------------------
    def _permute(self, block_id: int, tag: int, block: torch.Tensor) -> torch.Tensor:
        # the reference's numpy draw on the host, one gather on the device
        rng = np.random.default_rng(
            np.random.SeedSequence([self._seed, 0xD47A, tag, block_id])
        )
        perm = torch.from_numpy(rng.permutation(block.shape[0]))
        return block[perm.to(block.device)]

    def _request(self, block_id: int, tag: int, cursor: int = 0) -> None:
        """Start fetching + permuting one block on the engine's workers."""
        fut = self._executor.fetch_async(
            block_id, lambda b, _id=block_id, _t=tag: self._permute(_id, _t, b)
        )
        self._pool.append(_OpenBlock(block_id, tag, fut, cursor))

    def _refill(self) -> None:
        target = self.open_blocks + self._executor.prefetch
        while len(self._pool) < target:
            (bid,) = self.policy.sample(1)
            self._request(bid, self.policy.epoch)

    def next_batch(self) -> torch.Tensor:
        out: list[torch.Tensor] = []
        need = self.batch_size
        while need > 0:
            self._refill()
            entry = self._pool[0]
            records = entry.records()  # propagates worker exceptions
            take = min(need, records.shape[0] - entry.cursor)
            out.append(records[entry.cursor : entry.cursor + take])
            entry.cursor += take
            need -= take
            if entry.cursor >= records.shape[0]:
                self._pool.popleft()
        batch = torch.cat(out)
        self._consumed_batches += 1
        return self.transform(batch) if self.transform else batch

    def __iter__(self) -> Iterator[torch.Tensor]:
        while True:
            yield self.next_batch()

    def close(self) -> None:
        """Terminal: cancels in-flight fetches and releases worker threads.
        The open-pool position is discarded -- ``state_dict()`` first if the
        stream should be resumable."""
        for entry in self._pool:
            entry.cancel()
        self._pool.clear()
        if self._owns_executor:
            self._executor.close()

    def __enter__(self) -> "RSPLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- checkpointing ---------------------------------------------------------
    def state_dict(self) -> dict:
        """Block-granular state: policy position + the open pool's
        (block id, permutation tag, cursor) triples.  In-flight prefetched
        blocks are pool entries with cursor 0, so nothing is lost."""
        return {
            "version": 2,
            "seed": self._seed,  # permutation seed: resume is self-contained
            "policy": self.policy.state_dict(),
            "consumed_batches": self._consumed_batches,
            "pool": [
                {"block_id": e.block_id, "tag": e.tag, "cursor": e.cursor}
                for e in self._pool
            ],
        }

    def load_state_dict(self, state: dict) -> None:
        """Exact resume in O(open-pool): restore the policy position and
        reload only the blocks that were open (same ids, same permutation
        tags, same cursors).  Legacy v1 states (no pool) fall back to
        replaying the consumed batches."""
        if "pool" not in state:
            self._load_legacy(state)
            return
        kind = state["policy"].get("kind")
        if kind != self.policy.name:
            raise ValueError(
                f"checkpoint policy {kind!r} != loader policy {self.policy.name!r}"
            )
        self._seed = int(state.get("seed", self._seed))
        self.policy.load_state_dict(state["policy"])
        for entry in self._pool:
            entry.cancel()
        self._pool.clear()
        for e in state["pool"]:
            self._request(int(e["block_id"]), int(e["tag"]), int(e["cursor"]))
        self._consumed_batches = int(state["consumed_batches"])

    def _load_legacy(self, state: dict) -> None:
        # v1 checkpoints carried only (sampler seed, consumed batch count);
        # the stream is deterministic, so replay reproduces it exactly --
        # at O(consumed batches) cost.  New checkpoints never take this path.
        if self.policy.name != "uniform":
            raise ValueError(
                "legacy (v1) checkpoints are uniform-only; cannot resume a"
                f" {self.policy.name!r}-policy loader from one"
            )
        self._seed = int(state["sampler"]["seed"])  # permutations keyed off it
        self.policy = make_policy("uniform", self.source.num_blocks, seed=self._seed)
        for entry in self._pool:
            entry.cancel()
        self._pool.clear()
        self._consumed_batches = 0
        for _ in range(int(state["consumed_batches"])):
            self.next_batch()


class PrefetchLoader:
    """Background *batch* prefetch (double buffering) on one worker thread.

    ``RSPLoader`` already prefetches blocks; this wrapper additionally
    overlaps batch assembly + transform with the consumer's compute.  Worker
    exceptions propagate out of ``next_batch()`` at the point the failing
    batch would have been delivered -- never swallowed, never a silent hang.
    """

    def __init__(self, loader: RSPLoader, depth: int = 2):
        self.loader = loader
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="rsp-batch"
        )
        self._futures: collections.deque[Future] = collections.deque()
        for _ in range(max(1, depth)):
            self._futures.append(self._executor.submit(loader.next_batch))

    def next_batch(self) -> torch.Tensor:
        fut = self._futures.popleft()
        self._futures.append(self._executor.submit(self.loader.next_batch))
        return fut.result()

    def close(self) -> None:
        """Terminal: stops the batch thread and closes the wrapped loader
        (its executor threads and in-flight fetches included)."""
        for fut in self._futures:
            fut.cancel()
        self._futures.clear()
        self._executor.shutdown(wait=True, cancel_futures=True)
        self.loader.close()

    def __enter__(self) -> "PrefetchLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
