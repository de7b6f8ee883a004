"""``QueryService`` -- concurrent multi-tenant approximate-query serving.

The paper's payoff is that analysis of a big data set becomes analysis of a
few pre-generated RSP blocks; at scale that only matters if many analysts
can ask at once.  This service multiplexes concurrent
:class:`~repro_torch.rsp.query.Query` submissions over ONE opened
:class:`~repro_torch.rsp.dataset.RSPDataset` and its shared
:class:`~repro_torch.rsp.engine.BlockExecutor` block cache:

* **Budgets.**  Every query carries ``target_rel_err`` / ``max_blocks``
  (how much accuracy to buy) and a ``deadline_ms`` (how long the tenant
  will wait).  A query that converges early returns early; one that hits
  its deadline returns its current **anytime** estimate -- point value,
  confidence interval, and blocks consumed -- instead of failing.
* **Admission control.**  Progressive queries cost fetch slots
  (``prefetch + 1`` in-flight block fetches each); the
  :class:`~repro_torch.serve.admission.AdmissionController` admits up to
  ``capacity`` slots, queues the next ``max_queue`` submissions FIFO, and
  rejects beyond that -- saturation is visible, not a latency cliff.
* **Fair scheduling.**  The :class:`~repro_torch.serve.scheduler.StepScheduler`
  interleaves *one-block* progressive steps across admitted queries
  (earliest deadline first, round-robin within a deadline class), so a
  heavy query cannot starve light ones.
* **Sketch fast path.**  Moment/label-count-only queries are answered
  synchronously at ``submit`` from the partition-time sketches -- zero
  block I/O, never queued, never rejected.
* **Honest metering.**  Each query carries its own
  :class:`~repro_torch.rsp.engine.CallerStats`, so per-query I/O sums exactly to
  the executor total no matter how tenants interleave; ``metrics()``
  reports QPS, latency percentiles, shared-cache hit rate, admission
  rejects, and blocks fetched per query.

Usage::

    with ds.serve(capacity=64, workers=8) as svc:
        tickets = [svc.submit("median", target_rel_err=0.02,
                              deadline_ms=500) for _ in tenants]
        results = [svc.result(t) for t in tickets]

Reproducibility: a submitted query with no pinned seed gets
``derive_seed(service seed, query id)``, so every tenant's bootstrap and
block-selection streams are independent AND identical across runs
regardless of scheduling order.

On the card, each step sketches its block with the ``block_sketch`` or
``plan_sketch`` kernel on the scheduler's worker thread, which first makes
the dataset's device its current one.  Every worker launches on that
device's current stream, and the kernels fold in a fixed order, so a served
answer equals the same seeded query run alone, bit for bit.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
import contextlib
import threading
import time
from typing import Any, Iterator

import torch

from repro_torch import obs
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.rsp.engine import ExecutorStats
from repro_torch.rsp.query import (
    AggregateResult,
    Query,
    QueryExecutor,
    QueryResult,
    as_query,
    derive_seed,
)
from repro_torch.serve.admission import AdmissionController, AdmissionRejected, AdmissionSnapshot
from repro_torch.serve.scheduler import StepScheduler

# terminal outcomes a ticket can report
OUTCOMES = (
    "sketch",       # answered from partition-time sketches at submit (0 I/O)
    "converged",    # every CI met target_rel_err before the deadline
    "exhausted",    # read max_blocks without converging (answer still valid)
    "deadline",     # deadline fired -> anytime result returned
    "cancelled",    # cancel() or service shutdown
    "rejected",     # admission queue full
    "failed",       # the query raised; see ticket.error
)


class QueryTicket:
    """Handle for one submitted query.

    ``status`` is ``"pending"`` until terminal (``"done"`` / ``"rejected"``);
    ``outcome`` (one of :data:`OUTCOMES`) says *how* it finished.  ``result``
    is the final or anytime :class:`~repro_torch.rsp.query.QueryResult` (``None``
    for rejected queries and queries cancelled before their first block).
    Thread-safe; finalization is idempotent -- the first of worker /
    deadline-waiter / cancel wins and the rest are no-ops.
    """

    def __init__(self, qid: int, query: Query, deadline: float | None):
        self.id = qid
        self.query = query
        self.deadline = deadline          # time.monotonic() instant, or None
        self.submitted_at = time.monotonic()
        self.finished_at: float | None = None
        self.outcome: str | None = None
        self.result: QueryResult | None = None
        self.error: BaseException | None = None
        self._event = threading.Event()
        self._lock = threading.Lock()

    @property
    def done(self) -> bool:
        return self._event.is_set()

    @property
    def status(self) -> str:
        if not self.done:
            return "pending"
        return "rejected" if self.outcome == "rejected" else "done"

    @property
    def latency_ms(self) -> float | None:
        if self.finished_at is None:
            return None
        return (self.finished_at - self.submitted_at) * 1e3

    def wait(self, timeout: float | None = None) -> bool:
        return self._event.wait(timeout)

    def _finalize(
        self,
        *,
        outcome: str,
        result: QueryResult | None,
        error: BaseException | None = None,
        record=None,
    ) -> bool:
        """Set the outcome once; ``record(ticket)`` (the service's metrics)
        runs before waiters wake, so no ``result()`` returns ahead of the
        counters a ``metrics()`` snapshot reads."""
        with self._lock:
            if self._event.is_set():
                return False
            self.outcome = outcome
            self.result = result
            self.error = error
            self.finished_at = time.monotonic()
            if record is not None:
                record(self)
            self._event.set()
            return True

    def __repr__(self) -> str:
        return f"QueryTicket(id={self.id}, status={self.status!r}, outcome={self.outcome!r})"


class _Run:
    """Scheduler-side state of one admitted/queued progressive query."""

    __slots__ = (
        "ticket", "qe", "gen", "cost", "last", "admitted", "released", "enqueued_at",
    )

    def __init__(self, ticket: QueryTicket, qe: QueryExecutor, cost: int):
        self.ticket = ticket
        self.qe = qe
        self.gen: Iterator[QueryResult] = qe.stream()
        self.cost = cost
        self.last: QueryResult | None = None
        self.admitted = False
        self.released = False
        self.enqueued_at = time.monotonic()  # admission-wait metering

    @property
    def deadline(self) -> float | None:  # StepScheduler priority key
        return self.ticket.deadline

    def close_gen(self) -> None:
        """Close the progressive stream; its ``finally`` cancels the query's
        queued prefetch futures inside the shared executor."""
        try:
            self.gen.close()
        except Exception:  # noqa: BLE001 -- closing a dead stream is best-effort
            pass


@dataclasses.dataclass(frozen=True)
class ServiceMetrics:
    """One consistent snapshot of the service counters.

    Latency percentiles are over completed queries (sketch answers
    included); ``qps`` is completions over the first-submit -> last-finish
    window; ``cache_hit_rate`` / ``executor`` meter the shared executor
    since the service opened; ``blocks_per_query`` averages each query's
    own honest ``CallerStats`` fetch count.
    """

    submitted: int
    completed: int
    rejected: int
    cancelled: int
    deadline_hits: int
    sketch_answers: int
    failed: int
    qps: float
    latency_p50_ms: float
    latency_p99_ms: float
    cache_hit_rate: float
    blocks_fetched: int
    blocks_per_query: float
    admission: AdmissionSnapshot
    executor: ExecutorStats


def _percentile(sorted_ms: list[float], q: float) -> float:
    if not sorted_ms:
        return math.nan
    idx = min(len(sorted_ms) - 1, max(0, math.ceil(q * len(sorted_ms)) - 1))
    return sorted_ms[idx]


class QueryService:
    """Concurrent approximate-query serving over one ``RSPDataset``.

    ``capacity`` bounds in-flight block-I/O demand in fetch slots (each
    progressive query holds ``min(prefetch + 1, max_blocks)`` slots while
    admitted); ``max_queue`` bounds the admission wait queue (``None`` =
    unbounded, ``0`` = reject at capacity); ``workers`` are the stepping
    threads that interleave progressive queries; ``seed`` is the service's
    RNG root for :func:`~repro_torch.rsp.query.derive_seed`;
    ``default_deadline_ms`` applies to submissions that don't set one.

    Opening the service materializes the dataset's partition-time sketches
    once (a no-op for stored datasets with a manifest), so the sketch fast
    path and sketch-guided policies never race to compute them later.
    """

    def __init__(
        self,
        dataset,
        *,
        capacity: int = 64,
        max_queue: int | None = None,
        workers: int = 4,
        seed: int = 0,
        default_deadline_ms: float | None = None,
    ):
        self.ds = dataset
        self.seed = seed
        self.default_deadline_ms = default_deadline_ms
        _ = dataset.summaries  # materialize once, before any concurrency
        self._admission = AdmissionController(capacity, max_queue=max_queue)
        self._scheduler = StepScheduler(
            self._step, workers=workers, on_drop=self._drop
        )
        self._ids = itertools.count()
        self._lock = threading.Lock()
        self._runs: dict[int, _Run] = {}
        self._stats0 = dataset.executor.stats()
        self._closed = False
        # deadline sweeper: finalizes tickets AT their deadline instant, so
        # latency honours the budget even when every worker is busy stepping
        # other queries and no result() waiter is parked on the ticket
        self._sweep_cv = threading.Condition()
        self._sweep_heap: list[tuple[float, int, QueryTicket]] = []
        self._sweeper = threading.Thread(
            target=self._sweep, name="rsp-serve-deadline", daemon=True
        )
        self._sweeper.start()
        # metrics: one registry per service is the single book of record --
        # ``metrics()`` is a view over these counters (no parallel private
        # tallies), and ``registry.to_prometheus()`` is scrape-ready.  The
        # registry is always live (it backs the public accounting API), only
        # spans/global-registry hot-path telemetry are gated by repro_torch.obs.
        self.registry = MetricsRegistry()
        self._m_submitted = self.registry.counter(
            "rsp_serve_submitted_total", "queries submitted")
        self._m_outcomes = {
            o: self.registry.counter(
                "rsp_serve_queries_total", "finished queries by outcome", outcome=o)
            for o in OUTCOMES
        }
        self._m_blocks = self.registry.counter(
            "rsp_serve_blocks_fetched_total", "block fetches by finished queries")
        self._m_admission_wait = self.registry.histogram(
            "rsp_serve_admission_wait_seconds",
            "submit-to-admission wait of queued queries")
        self._m_step = self.registry.histogram(
            "rsp_serve_step_seconds", "one-block progressive step latency")
        self._m_slack = self.registry.histogram(
            "rsp_serve_deadline_slack_seconds",
            "remaining budget at answer time (deadline queries, clamped at 0)")
        self._m_overrun = self.registry.counter(
            "rsp_serve_deadline_overrun_total",
            "answers delivered past their deadline")
        # exact latency samples for percentiles (bucketed histograms would
        # round p99 up to a bucket edge and trip latency gates); under _lock
        self._latencies_ms: list[float] = []
        self._first_submit: float | None = None
        self._last_finish: float | None = None

    # ------------------------------------------------------------------
    # Submission
    # ------------------------------------------------------------------
    def submit(
        self,
        aggregates: Any = "mean",
        *,
        deadline_ms: float | None = None,
        on_reject: str = "raise",
        **query_kwargs,
    ) -> QueryTicket:
        """Submit one query; returns immediately with a :class:`QueryTicket`.

        ``aggregates`` / ``query_kwargs`` are anything
        ``RSPDataset.query`` accepts (``target_rel_err=``, ``max_blocks=``,
        ``policy=``, ...).  ``deadline_ms`` is this query's latency budget,
        measured from submission (queue time included): when it fires the
        ticket completes with the current anytime estimate.  Sketch-only
        queries are answered inline before admission (queries with
        ``where=`` predicates never take that path -- partition-time
        sketches are unfiltered -- and stream filtered block passes through
        the plan-compiled kernels instead).  ``on_reject="raise"``
        raises :class:`AdmissionRejected` when the service is saturated;
        ``"ticket"`` returns a rejected ticket instead.
        """
        if on_reject not in ("raise", "ticket"):
            raise ValueError("on_reject must be 'raise' or 'ticket'")
        if self._closed:
            raise RuntimeError("service is closed")
        q = as_query(aggregates, **query_kwargs)
        qid = next(self._ids)
        if q.seed is None:
            q = dataclasses.replace(q, seed=derive_seed(self.seed, qid))
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        deadline = None if deadline_ms is None else time.monotonic() + deadline_ms / 1e3
        ticket = QueryTicket(qid, q, deadline)
        self._m_submitted.inc()
        with self._lock:
            if self._first_submit is None:
                self._first_submit = ticket.submitted_at
        # datasets that provide their own executor factory (a
        # DistributedDataset fanning block work over a mesh) plug in here;
        # plain RSPDatasets get the stock executor.  Validates the query.
        make_qe = getattr(self.ds, "query_executor", None)
        qe = make_qe(q) if callable(make_qe) else QueryExecutor(self.ds, q)

        # zero-I/O fast path: answer sketch-eligible queries (moments,
        # label counts, and -- with v2 suites -- ungrouped unfiltered
        # quantile/distinct) synchronously from the sketches -- no
        # admission, no scheduling, no fetches.  In auto mode a
        # bound-limited sketch answer that misses the query's
        # target_rel_err is NOT final: the query falls through to the
        # scheduled progressive path instead of silently under-delivering.
        sketch_forced = q.use_sketches is True
        sketch_auto = (
            q.use_sketches == "auto" and qe._sketch_eligible() and self.ds.has_summaries
        )
        if sketch_forced or sketch_auto:
            try:
                # run() validates forced queries (raises if block data is
                # needed); the direct call skips the progressive fallback
                # that must stay behind admission control
                result = qe.run() if sketch_forced else qe._answer_from_sketches()
            except Exception as e:  # noqa: BLE001 -- surface via the ticket
                ticket._finalize(outcome="failed", result=None, error=e,
                                 record=lambda t: self._record(t, blocks=0))
                return ticket
            if sketch_forced or result.converged:
                qe.end_span()
                ticket._finalize(outcome="sketch", result=result, record=lambda t: self._record(
                    t, blocks=result.executor_stats.blocks_fetched))
                return ticket

        cost = self.ds.executor.prefetch + 1
        if q.max_blocks is not None:
            cost = min(cost, max(1, q.max_blocks))
        run = _Run(ticket, qe, cost)
        with self._lock:
            self._runs[qid] = run
        decision = self._admission.try_admit(run, cost)
        if decision == "reject":
            ticket._finalize(outcome="rejected", result=None,
                             record=lambda t: self._record(t, blocks=0))
            with self._lock:
                self._runs.pop(qid, None)
            if on_reject == "raise":
                raise AdmissionRejected(
                    f"query {qid}: service saturated "
                    f"({self._admission.snapshot().in_flight} slots in flight)"
                )
            return ticket
        if decision == "admit":
            run.admitted = True
            self._scheduler.submit(run)
        if deadline is not None:
            with self._sweep_cv:
                heapq.heappush(self._sweep_heap, (deadline, qid, ticket))
                self._sweep_cv.notify()
        return ticket

    # ------------------------------------------------------------------
    # Results / cancellation
    # ------------------------------------------------------------------
    def result(self, ticket: QueryTicket, timeout: float | None = None) -> QueryResult:
        """Block until ``ticket`` finishes and return its (final or anytime)
        result.  Enforces the ticket's deadline even if no worker has touched
        the query yet (e.g. it is still queued for admission): at the
        deadline the ticket completes with whatever has been computed.
        ``timeout`` (seconds) bounds this call independently of the query's
        own deadline; on expiry ``TimeoutError`` is raised and the query
        keeps running.
        """
        wait_end = None if timeout is None else time.monotonic() + timeout
        while not ticket.done:
            now = time.monotonic()
            bounds = [b for b in (ticket.deadline, wait_end) if b is not None]
            if not bounds:
                ticket.wait()
                continue
            until = min(bounds)
            if until > now:
                ticket.wait(until - now)
            if ticket.done:
                break
            now = time.monotonic()
            if ticket.deadline is not None and now >= ticket.deadline:
                self._force_deadline(ticket)
                break
            if wait_end is not None and now >= wait_end:
                raise TimeoutError(f"query {ticket.id} still pending after {timeout}s")
        return self._unwrap(ticket)

    def _unwrap(self, ticket: QueryTicket) -> QueryResult:
        if ticket.outcome == "failed":
            raise ticket.error
        if ticket.outcome == "rejected":
            raise AdmissionRejected(f"query {ticket.id} was rejected at admission")
        assert ticket.result is not None
        return ticket.result

    def cancel(self, ticket: QueryTicket) -> bool:
        """Cancel a pending query.  Returns True if this call finalized it
        (with its current anytime estimate, if any); False if it already
        finished.  A cancelled query's queued block fetches are released --
        dropped from the admission queue before admission, or unwound by the
        next worker touch (closing its prefetch window) after."""
        with self._lock:
            run = self._runs.get(ticket.id)
        if run is None:
            return False
        res = run.last if run.last is not None else self._anytime_empty(run)
        if not ticket._finalize(outcome="cancelled", result=res, record=lambda t: self._record(
                t, blocks=run.qe.counter.stats().blocks_fetched)):
            return False
        if self._admission.drop(run):
            # never admitted: nothing holds capacity; tidy up directly
            self._retire(run)
        # admitted runs are retired by the worker/scheduler that next owns
        # them (they observe ticket.done) -- never close a generator that a
        # worker may be executing
        return True

    # ------------------------------------------------------------------
    # Stepping (scheduler callback)
    # ------------------------------------------------------------------
    def _step(self, run: _Run) -> bool:
        """Advance one progressive query by one block.  Returns True to
        re-enqueue (more blocks wanted)."""
        ticket = run.ticket
        if ticket.done:
            self._retire(run)
            return False
        if ticket.deadline is not None and time.monotonic() >= ticket.deadline:
            self._finalize(run, outcome="deadline")
            return False
        span = None
        if obs.enabled() and run.qe.ctx is not None:
            span = obs.get_tracer().start_span(
                "serve.step", parent=run.qe.ctx, attrs={"qid": ticket.id}
            )
        t0 = time.perf_counter()
        try:
            with self._on_device():
                res = next(run.gen)
        except StopIteration:
            self._finalize(run, outcome="exhausted")
            return False
        except Exception as e:  # noqa: BLE001 -- surface via the ticket
            self._finalize(run, outcome="failed", error=e)
            return False
        finally:
            self._m_step.observe(time.perf_counter() - t0)
            if span is not None:
                span.end()
        run.last = res
        if res.converged or res.from_sketches:
            self._finalize(run, outcome="converged")
            return False
        return True

    def _on_device(self):
        """The dataset's CUDA device as the worker's current device (a
        kernel launches on the current device), or nothing on the CPU."""
        dev = getattr(self.ds, "device", None)
        if dev is not None and dev.type == "cuda":
            return torch.cuda.device(dev)
        return contextlib.nullcontext()

    def _finalize(
        self, run: _Run, *, outcome: str, error: BaseException | None = None
    ) -> None:
        res = run.last
        if res is None and error is None:
            res = self._anytime_empty(run)
        run.ticket._finalize(outcome=outcome, result=res, error=error, record=lambda t: self._record(
            t, blocks=run.qe.counter.stats().blocks_fetched))
        self._retire(run)

    def _drop(self, run: _Run) -> None:
        """Scheduler drop hook: the service is closing; finalize as
        cancelled (anytime result preserved)."""
        run.ticket._finalize(
            outcome="cancelled",
            result=run.last if run.last is not None else self._anytime_empty(run),
            record=lambda t: self._record(t, blocks=run.qe.counter.stats().blocks_fetched),
        )
        self._retire(run)

    def _retire(self, run: _Run) -> None:
        """Tear down a finished run: close its stream (cancelling queued
        prefetches) and release its admission slots, promoting queued runs."""
        run.close_gen()
        run.qe.end_span()  # closing a never-started gen skips its finally
        with self._lock:
            self._runs.pop(run.ticket.id, None)
        stack = [run]
        while stack:
            r = stack.pop()
            with self._lock:
                if not r.admitted or r.released:
                    continue
                r.released = True
            for nxt in self._admission.release(r.cost):
                nxt.admitted = True
                self._m_admission_wait.observe(time.monotonic() - nxt.enqueued_at)
                if nxt.ticket.done:
                    nxt.close_gen()
                    nxt.qe.end_span()
                    with self._lock:
                        self._runs.pop(nxt.ticket.id, None)
                    stack.append(nxt)
                    continue
                try:
                    self._scheduler.submit(nxt)
                except RuntimeError:  # closed while promoting
                    self._drop(nxt)

    def _sweep(self) -> None:
        """Deadline sweeper thread: sleep until the earliest registered
        deadline, then finalize every expired ticket with its anytime
        estimate.  Workers' pre-step checks and ``result()`` waiters enforce
        deadlines too; the sweeper guarantees it happens *on time* for
        tickets nobody is touching (queued for admission, or admitted but
        starved of worker attention)."""
        while True:
            with self._sweep_cv:
                while not self._closed:
                    if not self._sweep_heap:
                        self._sweep_cv.wait()
                        continue
                    delay = self._sweep_heap[0][0] - time.monotonic()
                    if delay > 0:
                        self._sweep_cv.wait(delay)
                        continue
                    break
                if self._closed:
                    return
                _, _, ticket = heapq.heappop(self._sweep_heap)
            # finalize outside the cv: _force_deadline takes service locks
            if not ticket.done:
                self._force_deadline(ticket)

    def _force_deadline(self, ticket: QueryTicket) -> None:
        """Deadline enforcement from a ``result()`` waiter: finalize with the
        latest anytime estimate even if the run is mid-step or still queued."""
        with self._lock:
            run = self._runs.get(ticket.id)
        if run is None:
            return
        span = None
        if obs.enabled() and run.qe.ctx is not None:
            # runs on the sweeper thread (or a result() waiter); parenting
            # under the query's root span is explicit, not thread-inherited
            span = obs.get_tracer().start_span(
                "serve.deadline", parent=run.qe.ctx, attrs={"qid": ticket.id}
            )
        res = run.last if run.last is not None else self._anytime_empty(run)
        ticket._finalize(outcome="deadline", result=res, record=lambda t: self._record(
            t, blocks=run.qe.counter.stats().blocks_fetched))
        if self._admission.drop(run):
            self._retire(run)  # was still queued: safe to tear down here
        if span is not None:
            span.end()

    def _anytime_empty(self, run: _Run) -> QueryResult:
        """The anytime answer before any block has been folded: NaN point
        estimates with infinite intervals (which trivially cover), zero
        blocks read."""
        q = run.ticket.query
        aggs = tuple(
            AggregateResult(
                name=a.label,
                kind=a.kind,
                estimate=math.nan,
                ci_lo=-math.inf if a.kind != "histogram" else None,
                ci_hi=math.inf if a.kind != "histogram" else None,
                rel_err=None if a.kind == "histogram" else math.inf,
            )
            for a in q.aggregates
        )
        return QueryResult(
            aggregates=aggs,
            blocks_read=0,
            total_blocks=self.ds.num_blocks,
            confidence=q.confidence,
            target_rel_err=q.target_rel_err,
            converged=False,
            from_sketches=False,
            executor_stats=run.qe.counter.stats(),
        )

    # ------------------------------------------------------------------
    # Metrics
    # ------------------------------------------------------------------
    def _record(self, ticket: QueryTicket, *, blocks: int) -> None:
        self._m_outcomes[ticket.outcome].inc()
        if ticket.outcome == "rejected":
            return
        self._m_blocks.inc(blocks)
        if ticket.deadline is not None:
            slack = ticket.deadline - ticket.finished_at
            self._m_slack.observe(max(slack, 0.0))
            if slack < 0:
                self._m_overrun.inc()
        with self._lock:
            self._latencies_ms.append(ticket.latency_ms)
            self._last_finish = ticket.finished_at

    def metrics(self) -> ServiceMetrics:
        """One consistent snapshot, read straight off :attr:`registry` (the
        counters) and the exact latency samples -- there is no second set of
        books to drift from the scrape endpoint."""
        executor_delta = self.ds.executor.stats() - self._stats0
        outcomes = {o: int(c.value) for o, c in self._m_outcomes.items()}
        blocks_fetched = int(self._m_blocks.value)
        with self._lock:
            lat = sorted(self._latencies_ms)
            completed = len(lat)
            window = None
            if self._first_submit is not None and self._last_finish is not None:
                window = max(self._last_finish - self._first_submit, 1e-9)
        return ServiceMetrics(
            submitted=int(self._m_submitted.value),
            completed=completed,
            rejected=outcomes["rejected"],
            cancelled=outcomes["cancelled"],
            deadline_hits=outcomes["deadline"],
            sketch_answers=outcomes["sketch"],
            failed=outcomes["failed"],
            qps=0.0 if window is None else completed / window,
            latency_p50_ms=_percentile(lat, 0.50),
            latency_p99_ms=_percentile(lat, 0.99),
            cache_hit_rate=executor_delta.hit_rate,
            blocks_fetched=blocks_fetched,
            blocks_per_query=blocks_fetched / completed if completed else 0.0,
            admission=self._admission.snapshot(),
            executor=executor_delta,
        )

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------
    def close(self) -> None:
        """Stop the workers; outstanding queries finalize as ``cancelled``
        with their current anytime estimates."""
        if self._closed:
            return
        self._closed = True
        with self._sweep_cv:
            self._sweep_cv.notify_all()
        self._sweeper.join(timeout=5.0)
        self._scheduler.close()
        for run in self._admission.drain():
            self._drop(run)
        with self._lock:
            leftovers = list(self._runs.values())
        for run in leftovers:
            self._drop(run)

    def __enter__(self) -> "QueryService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        snap = self._admission.snapshot()
        return (
            f"QueryService(K={self.ds.num_blocks}, capacity={snap.capacity},"
            f" in_flight={snap.in_flight}, queued={snap.queued},"
            f" submitted={int(self._m_submitted.value)})"
        )


# re-export for `from repro_torch.serve.query_service import AdmissionRejected`
__all__ = [
    "OUTCOMES",
    "AdmissionRejected",
    "QueryService",
    "QueryTicket",
    "ServiceMetrics",
]
