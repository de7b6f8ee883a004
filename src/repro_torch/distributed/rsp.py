"""``repro_torch.distributed.rsp`` -- mesh-distributed RSP datasets and queries.

The paper's setting is a cluster: RSP blocks live across nodes, and block
sampling "can be refined to select blocks depending on the availability of
nodes" (Sec. 7).  This module makes that concrete:

:class:`DistributedDataset`
    Wraps one host's view of a shared RSP store: a
    :class:`~repro_torch.distributed.ownership.BlockOwnership` deal says which
    blocks this host owns, a :class:`~repro_torch.rsp.engine.ScopedFetcher`
    makes touching anything else a hard error, and a
    :class:`~repro_torch.distributed.mesh.Transport` is the byte plane to
    the peers.  ``note_departed`` / ``rebalance`` apply Theorem-1-valid
    re-deals on host churn.

:class:`DistributedQueryExecutor`
    A :class:`~repro_torch.rsp.query.QueryExecutor` whose ``_payload_source``
    gathers *peer-computed block payloads* instead of streaming local
    blocks.  Everything else -- selection, Chan merging, HT weighting, CIs,
    the stopping rule -- is byte-for-byte the single-host code path, which
    is what makes the distributed answer **bit-identical** to the
    single-host answer with the same seed:

    * every host derives the identical block-id sequence (policies are
      deterministic functions of ``(seed, draw counter)`` and the shared
      manifest sketches -- inclusion probabilities are computed once from
      the manifest, so HT/Hajek estimates stay exactly unbiased no matter
      which host processes which block);
    * each position's payload is a pure function of the block bytes and
      the query shape, computed by the position's *owner* (on its device:
      the sketch kernels on the card, whose fold order is fixed) and
      published on the transport (JSON float round-trips are exact, dtypes
      preserved);
    * every host folds the gathered payloads in canonical position order
      through the same ``_stream_impl`` fold.

    Straggler tolerance rides :class:`~repro_torch.distributed.straggler.
    LeaseScheduler`: when an owner misses its grace window, its unstarted
    positions are re-dealt deterministically to the survivors (statistically
    free by block exchangeability), duplicate publishes are idempotent
    (identical bytes), and a host whose consumer stops early publishes a
    ``fin`` marker so peers steal its remainder without waiting out the
    grace.  The grace counts from the holder's last sign of life: each host
    runs a :class:`~repro_torch.distributed.mesh.Heartbeat` for as long as
    it works on the query, and a waiter restarts the grace whenever the
    holder's counter moves, so a live but late host is never presumed dead.
    The heartbeat shows only that the host lives, not that it gets on: a
    holder alive but stuck (a hung fetch, a ``compute`` that never returns)
    beats on.  So a waiter gives a beating holder at most
    :data:`LIVE_GRACES` graces for one position, then computes the position
    itself and takes the holder's later positions without waiting.  The
    holder is not presumed dead and keeps its blocks: it is only stalled.
"""

from __future__ import annotations

import hashlib
import heapq
import json
import threading
import time
from typing import Iterator

import numpy as np

from repro_torch import obs
from repro_torch.distributed.mesh import Heartbeat, HostKilledError, Transport
from repro_torch.distributed.ownership import BlockOwnership
from repro_torch.distributed.straggler import LeaseScheduler
from repro_torch.kernels.block_sketch import BlockSketch
from repro_torch.rsp.engine import BlockExecutor, ScopedFetcher
from repro_torch.rsp.query import QueryExecutor, as_query


# ---------------------------------------------------------------------------
# Payload codec: exact JSON round-trip of the per-block fold state
# ---------------------------------------------------------------------------

def encode_payload(payload: dict) -> bytes:
    """Serialize one block's fold payload to canonical bytes.

    Exact to the bit: Python's shortest-repr float encoding round-trips
    every float64 (inf/nan included), array dtypes travel alongside the
    data, and key order is canonical -- so any two hosts encoding the same
    payload produce identical bytes (idempotent duplicate publishes).

    The payload's sketches are already host numpy: every sketch impl
    brings a block's outputs off the card in one copy of the packed buffer
    (``kernels/_sketch.py``), so encoding copies nothing off the device."""
    d = {
        "whole": None if payload["whole"] is None else _sketch_dict(payload["whole"]),
        "per_class": (
            None
            if payload["per_class"] is None
            else [_sketch_dict(s) for s in payload["per_class"]]
        ),
        "rows_total": payload["rows_total"],
        "rows_selected": payload["rows_selected"],
        "distinct": (
            None if payload.get("distinct") is None else payload["distinct"].to_dict()
        ),
    }
    return json.dumps(d, sort_keys=True).encode()


def _sketch_dict(sk) -> dict:
    """Every sketch impl returns a host :class:`BlockSketch` whose moments
    are float64 and whose histogram is int64 (``kernels/block_sketch/
    ops.py``), the fields a decoded payload carries too, so the fold sees
    the same values from a local and a decoded payload."""
    if not isinstance(sk, BlockSketch):
        raise TypeError(f"a payload holds BlockSketch objects, got {type(sk).__name__}")
    return sk.to_dict()


def decode_payload(data: bytes) -> dict:
    from repro_torch.rsp.sketch import DistinctSketch

    d = json.loads(data.decode())
    return {
        "whole": None if d["whole"] is None else BlockSketch.from_dict(d["whole"]),
        "per_class": (
            None
            if d["per_class"] is None
            else [BlockSketch.from_dict(s) for s in d["per_class"]]
        ),
        "rows_total": d["rows_total"],
        "rows_selected": d["rows_selected"],
        "distinct": (
            None if d["distinct"] is None else DistinctSketch.from_dict(d["distinct"])
        ),
    }


# ---------------------------------------------------------------------------
# The distributed query executor
# ---------------------------------------------------------------------------

#: beats a grace: a live host's counter moves this many times a grace, so
#: a beat delayed by a busy interpreter lock still lands within it
BEATS_PER_GRACE = 8
#: graces a waiter gives a beating holder for one position before it
#: computes the position itself (the holder lives but may be stuck)
LIVE_GRACES = 4

class DistributedQueryExecutor(QueryExecutor):
    """Fans one query's block work out over the mesh (see module docstring).

    Overrides only ``_payload_source``; the fold and all statistics are the
    inherited single-host code."""

    def __init__(self, dds: "DistributedDataset", query):
        super().__init__(dds, query)
        self._dds = dds
        #: hosts this query declared dead (grace expired with no payload);
        #: DistributedDataset re-deals their blocks after the query
        self.presumed_dead: set[int] = set()
        #: holders that beat on but kept a position past LIVE_GRACES graces;
        #: this host computed their positions after that, and they stay owners
        self.stalled: set[int] = set()

    # -- the one overridden seam -------------------------------------------
    def _payload_source(
        self, ids, lo, hi, *, needs_hist, needs_rows, grouped, need_whole
    ) -> Iterator[tuple[int, dict]]:
        dds = self._dds
        transport: Transport = dds.transport
        me = transport.host_id
        # materialize the full deterministic selection sequence up front --
        # every host derives the same list, so "position" is a global name
        ids = [int(i) for i in ids]
        n = len(ids)

        ns, base, fp = self._namespace(ids, lo, hi)
        transport.put(f"{base}/fp/{me}", fp.encode())
        heartbeat = dds._start_heartbeat(f"{ns}/hb/{me}")

        ownership = dds.ownership
        assign: dict[int, list[int]] = {h: [] for h in ownership.hosts()}
        for p, bid in enumerate(ids):
            assign.setdefault(ownership.owner_of(bid), []).append(p)
        sched = LeaseScheduler.from_assignment(assign)
        assignee = {p: h for h, ps in assign.items() for p in ps}
        failed: set[int] = set()
        my_heap = list(assign.get(me, []))
        heapq.heapify(my_heap)
        computed: dict[int, bytes] = {}

        def compute(p: int) -> bytes:
            block = dds.executor.fetch(ids[p], counter=self.counter)
            data = encode_payload(
                self._make_payload(
                    block, lo, hi, needs_hist, needs_rows, grouped, need_whole
                )
            )
            transport.put(f"{ns}/p/{p}", data)
            computed[p] = data
            sched.complete(me, p)
            return data

        def take(p: int) -> bytes:
            """Compute a stalled holder's position here; its ownership
            stays as it is."""
            dds.allow_blocks([ids[p]])
            return compute(p)

        def work_ahead() -> bool:
            """Compute one pending owned/stolen position while waiting."""
            while my_heap:
                p = heapq.heappop(my_heap)
                if p not in computed:
                    compute(p)
                    return True
            return False

        def reassign(p: int, since: float) -> None:
            """Declare ``p``'s assignee gone; re-deal its unfinished
            positions deterministically onto the survivors.  ``since`` is
            when this host began waiting for ``p``: under telemetry the wait
            up to the re-deal is this host's steal time."""
            if obs.enabled():
                obs.get_registry().histogram(
                    "rsp_mesh_steal_seconds",
                    "wait for a position's payload up to its re-deal", host=str(me),
                ).observe(time.monotonic() - since)
            dead = assignee[p]
            failed.add(dead)
            self.presumed_dead.add(dead)
            sched.fail_host(dead)
            survivors = sorted(
                set(h for h in ownership.hosts() if h not in failed) | {me}
            )
            grants = sched.redeal(survivors)
            for h, ps in grants.items():
                for gp in ps:
                    assignee[gp] = h
            mine = grants.get(me, [])
            if mine:
                dds.allow_blocks(ids[gp] for gp in mine)
                for gp in mine:
                    heapq.heappush(my_heap, gp)

        poll = dds.poll_interval
        grace = dds.straggler_grace
        try:
            for p in range(n):
                data = computed.get(p)
                if data is None and assignee[p] == me:
                    data = compute(p)
                waiting = time.monotonic()
                deadline = waiting + grace
                stall_at = waiting + LIVE_GRACES * grace   # the most a beating holder gets
                seen = None  # (holder, its counter) at this wait's last look
                while data is None:
                    data = transport.get(f"{ns}/p/{p}", poll)
                    if data is not None:
                        break
                    work_ahead()
                    holder = assignee[p]
                    if holder == me:
                        data = compute(p)
                        break
                    if transport.get(f"{ns}/fin/{holder}", 0.0) is not None:
                        # holder ceased computing for this query; one last
                        # look (it may have published p just before), then
                        # steal without waiting out the grace
                        data = transport.get(f"{ns}/p/{p}", poll)
                        if data is not None:
                            break
                        reassign(p, waiting)
                        deadline = time.monotonic() + grace
                        stall_at = time.monotonic() + LIVE_GRACES * grace
                        continue
                    self._check_fingerprints(transport, base, fp)
                    if holder in self.stalled or time.monotonic() > stall_at:
                        # alive but no payload in LIVE_GRACES graces: stuck
                        self.stalled.add(holder)
                        data = take(p)
                        break
                    beat = transport.get(f"{ns}/hb/{holder}", 0.0)
                    if seen is not None and seen != (holder, beat):
                        # the holder is alive: its grace starts again
                        deadline = time.monotonic() + grace
                    seen = (holder, beat)
                    if time.monotonic() > deadline:
                        reassign(p, waiting)
                        deadline = time.monotonic() + grace
                        stall_at = time.monotonic() + LIVE_GRACES * grace
                yield ids[p], decode_payload(data)
        finally:
            dds._stop_heartbeat(heartbeat)
            # reached on convergence, close(), and exhaustion alike: tell
            # the peers this host computes nothing further for this query
            try:
                transport.put(f"{ns}/fin/{me}", b"1")
            except HostKilledError:
                pass  # dying hosts cannot say goodbye

    # -- naming and divergence detection -----------------------------------
    def _namespace(self, ids, lo, hi) -> tuple[str, str, str]:
        """``(ns, base, fp)`` for this query's keys.

        ``base`` digests the query *shape* (seed, aggregates, predicates,
        stopping rule); ``fp`` digests the *derived state* (policy
        distribution, materialized id sequence, histogram grid).  The
        working namespace is ``base/fp``, so hosts whose manifests diverge
        can never consume each other's payloads -- divergence degrades to
        isolated (still correct) execution, and ``_check_fingerprints``
        turns it into a loud error."""
        q = self.q
        sig = {
            "seed": self.seed,
            "aggs": [(a.kind, a.q, a.feature, a.by_label, a.name) for a in q.aggregates],
            "policy": getattr(self._pol, "name", str(q.policy)),
            "n": len(ids),
            "where": repr(q.where),
            "columns": q.columns,
            "bins": q.bins,
            "bootstrap": q.bootstrap,
            "confidence": q.confidence,
            "target_rel_err": q.target_rel_err,
            "min_blocks": q.min_blocks,
        }
        base = "rspq/" + hashlib.sha1(
            json.dumps(sig, sort_keys=True, default=str).encode()
        ).hexdigest()[:16]
        h = hashlib.sha1()
        try:
            h.update(self._pol.fingerprint().encode())
        except NotImplementedError:  # custom policy: fall back to its name
            h.update(getattr(self._pol, "name", "custom").encode())
        h.update(np.asarray(ids, dtype=np.int64).tobytes())
        if lo is not None:
            h.update(np.ascontiguousarray(np.asarray(lo, np.float64)).tobytes())
            h.update(np.ascontiguousarray(np.asarray(hi, np.float64)).tobytes())
        fp = h.hexdigest()[:16]
        return f"{base}/{fp}", base, fp

    def _check_fingerprints(self, transport: Transport, base: str, fp: str) -> None:
        for key, value in transport.poll(f"{base}/fp/").items():
            if value.decode() != fp:
                raise RuntimeError(
                    f"distributed query fingerprint mismatch ({key} published"
                    f" {value.decode()!r}, this host derived {fp!r}): hosts"
                    " disagree on the manifest sketches / policy distribution"
                    " -- refusing to merge (HT weights would silently skew)"
                )


# ---------------------------------------------------------------------------
# The distributed dataset facade
# ---------------------------------------------------------------------------

class DistributedDataset:
    """One host's view of an RSP shared across a mesh.

    ``dataset`` is this host's (complete) view of the stored partition --
    each host opens the same store, or shares the in-memory blocks
    read-only under :class:`~repro_torch.distributed.mesh.LocalTransport`.
    The ownership deal decides which of those blocks this host may actually
    *read*: block movement goes through a
    :class:`~repro_torch.rsp.engine.ScopedFetcher`, so any fetch outside the
    owned/stolen scope raises -- before the block is read or copied to the
    device -- instead of silently breaking the "each host streams only its
    local blocks" contract.  Blocks land on the dataset's device, and each
    payload is sketched there.

    Requires materialized partition-time sketches: the selection policies'
    inclusion probabilities must come from the *shared* manifest (computing
    them locally would both scan un-owned blocks and risk diverging HT
    weights across hosts).
    """

    def __init__(
        self,
        dataset,
        transport: Transport,
        *,
        ownership: BlockOwnership | None = None,
        straggler_grace: float = 10.0,
        poll_interval: float = 0.05,
    ):
        if not dataset.has_summaries:
            raise ValueError(
                "DistributedDataset needs materialized partition-time"
                " sketches (dataset.has_summaries): inclusion probabilities"
                " must come from the shared manifest so HT weights agree"
                " across hosts"
            )
        if ownership is None:
            ownership = BlockOwnership.deal(
                dataset.num_blocks, transport.num_hosts, seed=dataset.spec.seed
            )
        if ownership.num_blocks != dataset.num_blocks:
            raise ValueError(
                f"ownership covers {ownership.num_blocks} blocks,"
                f" dataset has {dataset.num_blocks}"
            )
        self.dataset = dataset
        self.transport = transport
        self.ownership = ownership
        self.straggler_grace = float(straggler_grace)
        self.poll_interval = float(poll_interval)
        self._scoped = ScopedFetcher(
            dataset._make_fetcher(), ownership.blocks_of(transport.host_id)
        )
        self._executor = BlockExecutor(
            self._scoped,
            prefetch=dataset._prefetch,
            cache_blocks=dataset._cache_blocks,
        )
        self._heartbeats: set[Heartbeat] = set()
        self._heartbeats_lock = threading.Lock()

    # -- RSPDataset protocol surface (QueryExecutor + QueryService) --------
    @property
    def spec(self):
        return self.dataset.spec

    @property
    def num_blocks(self) -> int:
        return self.dataset.num_blocks

    @property
    def num_classes(self):
        return self.dataset.num_classes

    @property
    def label_column(self):
        return self.dataset.label_column

    @property
    def summaries(self):
        return self.dataset.summaries

    @property
    def has_summaries(self) -> bool:
        return self.dataset.has_summaries

    @property
    def executor(self) -> BlockExecutor:
        return self._executor

    def policy(self, policy="uniform", *, seed: int = 0, **kwargs):
        return self.dataset.policy(policy, seed=seed, **kwargs)

    def _compute_summaries(self, counter=None):
        return self.dataset._compute_summaries(counter=counter)

    # -- identity ----------------------------------------------------------
    @property
    def host_id(self) -> int:
        return self.transport.host_id

    @property
    def owned_blocks(self) -> list[int]:
        return self.ownership.blocks_of(self.host_id)

    def allow_blocks(self, block_ids) -> None:
        """Widen this host's read scope (stolen straggler leases)."""
        self._scoped.allow(block_ids)

    # -- queries -----------------------------------------------------------
    def query_executor(self, query) -> DistributedQueryExecutor:
        """Factory consumed by :class:`~repro_torch.serve.QueryService` (and
        the query methods below) so served queries fan out over the mesh
        too."""
        return DistributedQueryExecutor(self, as_query(query))

    def query(self, aggregates="mean", **kwargs):
        """Distributed :meth:`repro_torch.rsp.dataset.RSPDataset.query`: same
        declarative surface, bit-identical answer, block work fanned out
        over the mesh."""
        qe = self.query_executor(as_query(aggregates, **kwargs))
        try:
            return qe.run()
        finally:
            self._after_query(qe)

    def query_stream(self, aggregates="mean", **kwargs):
        """Progressive variant: one anytime result per folded block."""
        qe = self.query_executor(as_query(aggregates, **kwargs))

        def gen():
            try:
                yield from qe.stream()
            finally:
                self._after_query(qe)

        return gen()

    def serve(self, **kwargs):
        """A :class:`~repro_torch.serve.QueryService` whose queries execute
        distributed (via the ``query_executor`` factory hook)."""
        from repro_torch.serve.query_service import QueryService

        return QueryService(self, **kwargs)

    # -- elastic membership (Theorem-1-valid re-deals) ---------------------
    def _after_query(self, qe: DistributedQueryExecutor) -> None:
        gone = {h for h in qe.presumed_dead if h != self.host_id}
        if gone:
            self.note_departed(gone)

    def note_departed(self, hosts) -> BlockOwnership:
        """Re-deal departed hosts' blocks to the survivors for subsequent
        queries.  Statistically free (Theorem 1): re-assignment moves where
        blocks are *computed*, never which blocks exist."""
        current = set(self.ownership.hosts())
        hosts = [h for h in hosts if h in current and h != self.host_id]
        if hosts:
            self.ownership = self.ownership.redeal(hosts)
            self._scoped.replace(self.ownership.blocks_of(self.host_id))
        return self.ownership

    def rebalance(self, num_hosts: int | None = None) -> BlockOwnership:
        """Fresh balanced deal (a joined host gets its share)."""
        self.ownership = self.ownership.rebalance(
            self.transport.num_hosts if num_hosts is None else int(num_hosts)
        )
        self._scoped.replace(self.ownership.blocks_of(self.host_id))
        return self.ownership

    # -- liveness ----------------------------------------------------------
    def _start_heartbeat(self, key: str) -> Heartbeat:
        """Beat ``key`` while this host works on one query (see
        :class:`~repro_torch.distributed.mesh.Heartbeat`)."""
        hb = Heartbeat(self.transport, key, self.straggler_grace / BEATS_PER_GRACE)
        with self._heartbeats_lock:
            self._heartbeats.add(hb)
        return hb.start()

    def _stop_heartbeat(self, hb: Heartbeat) -> None:
        hb.stop()
        with self._heartbeats_lock:
            self._heartbeats.discard(hb)

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        with self._heartbeats_lock:
            beating = list(self._heartbeats)
        for hb in beating:
            self._stop_heartbeat(hb)
        self._executor.close()

    def __enter__(self) -> "DistributedDataset":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
