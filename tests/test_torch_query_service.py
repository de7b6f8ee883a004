"""The port's concurrent query serving (``repro_torch.serve``: admission,
the step scheduler, ``QueryService``) against its solo runs and the
reference package's.

The service's contract under contention, as ``tests/test_serve.py`` holds
the reference to it: no deadlock; every served answer equals the same
seeded query run alone -- here bit for bit, ``blocks_read``, ``converged``,
estimates and CIs -- because each query's seed is ``derive_seed(service
seed, query id)``; per-query ``CallerStats`` sum to the shared executor's
window; cancellation and close release their work; deadlines give anytime
results.  Served answers also agree with the reference's solo runs of the
same derived seed within 1e-5, with equal ``blocks_read`` (the port's
sketches run the kernels' plain versions here, the reference its float32
jit paths).  No assertion depends on the order in which threads run: the
solo runs are keyed by the ticket's id, never by completion order.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import time

import numpy as np
import pytest

from repro import rsp as ref_rsp
from repro.rsp.query import Aggregate as RefAggregate
from repro.rsp.query import QueryExecutor as RefQueryExecutor
from repro.rsp.query import as_query as ref_as_query
from repro.rsp.query import derive_seed as ref_derive_seed
from repro_torch import rsp
from repro_torch.rsp import query as query_mod
from repro_torch.rsp.engine import ExecutorStats
from repro_torch.rsp.query import Aggregate, QueryExecutor, as_query, derive_seed
from repro_torch.serve import (
    OUTCOMES,
    AdmissionController,
    AdmissionRejected,
    QueryService,
    StepScheduler,
)

K, BLOCK, F = 24, 384, 4   # three features and a 0/1 label in the last column
TIMEOUT = 60


@pytest.fixture(scope="module")
def stored(tmp_path_factory):
    rng = np.random.default_rng(0)
    data = rng.normal(5, 1, size=(K * BLOCK, F)).astype(np.float32)
    data[:, -1] = rng.integers(0, 2, size=K * BLOCK)
    path = str(tmp_path_factory.mktemp("serve") / "corpus.rsp")
    ref_rsp.partition(data, blocks=K, seed=1, num_classes=2).save(path)
    return path, data


def _open(path, **kw):
    kw.setdefault("cache_blocks", K)
    return rsp.open(path, device="cpu", **kw)


def _hog(svc, **kw):
    """A progressive query that can neither converge nor exhaust while a
    test runs: PPS-with-replacement selection (no epoch bound) chasing an
    unreachable target.  It holds its admission slots until cancelled."""
    return svc.submit("mean", use_sketches=False, target_rel_err=1e-12,
                      policy="weighted", max_blocks=10**7, **kw)


def _specs(aggregate):
    """Mixed tenants: sketch answers, progressive quantiles and means, a
    filtered projection (the plan path) and a per-class mean."""
    return [
        (["mean", "var", "count"], {}),
        ("median", dict(max_blocks=6, use_sketches=False)),
        ("mean", dict(target_rel_err=0.01, use_sketches=False)),
        ("p90", dict(target_rel_err=0.05, use_sketches=False)),
        ("mean", dict(where="c0 > 5.0", columns=(0, 2), target_rel_err=0.01,
                      use_sketches=False)),
        (aggregate("mean", by_label=True), dict(max_blocks=8, use_sketches=False)),
    ]


def _equal(served, solo):
    assert served.blocks_read == solo.blocks_read
    assert served.converged == solo.converged
    for a, b in zip(served.aggregates, solo.aggregates):
        for f in ("estimate", "ci_lo", "ci_hi"):
            np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)))


def _close(served, ref):
    assert served.blocks_read == ref.blocks_read
    assert served.converged == ref.converged
    for a, b in zip(served.aggregates, ref.aggregates):
        for f in ("estimate", "ci_lo", "ci_hi"):
            got, want = getattr(a, f), getattr(b, f)
            if want is None:
                assert got is None
                continue
            np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                                       rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Admission controller
# ---------------------------------------------------------------------------

def test_admission_admit_queue_reject_and_promotion():
    ac = AdmissionController(4, max_queue=1)
    assert ac.try_admit("a", 3) == "admit"
    assert ac.try_admit("b", 3) == "queue"       # 3 + 3 > 4
    assert ac.try_admit("c", 1) == "reject"      # queue full
    snap = ac.snapshot()
    assert (snap.in_flight, snap.queued, snap.rejected_total) == (3, 1, 1)
    assert ac.release(3) == ["b"]
    assert ac.snapshot().in_flight == 3 and ac.snapshot().admitted_total == 2
    assert ac.release(3) == []


def test_admission_oversized_cost_clamps_to_capacity():
    ac = AdmissionController(4)
    assert ac.try_admit("wide", 100) == "admit"
    assert ac.try_admit("next", 1) == "queue"
    assert ac.release(100) == ["next"]


def test_admission_drop_and_drain_remove_queued_items():
    ac = AdmissionController(1, max_queue=5)
    ac.try_admit("a", 1)
    for item in ("b", "c", "d"):
        assert ac.try_admit(item, 1) == "queue"
    assert ac.drop("b") is True and ac.drop("b") is False
    assert ac.drain(lambda item: item == "d") == ["d"]
    assert ac.drain() == ["c"]
    assert ac.release(1) == []
    with pytest.raises(ValueError):
        AdmissionController(0)


# ---------------------------------------------------------------------------
# Scheduler
# ---------------------------------------------------------------------------

class _Stall:
    """Pins the single worker until released, so later submissions pile up
    in the heap and their pop order is fixed."""

    deadline = -1.0   # sorts before every real task

    def __init__(self):
        self.gate = threading.Event()


def _wait_idle(sched, timeout=10.0):
    end = time.monotonic() + timeout
    while not sched.idle() and time.monotonic() < end:
        time.sleep(0.01)
    assert sched.idle()


def test_scheduler_round_robin_interleaves_tenants():
    trace = []

    class Task:
        deadline = None

        def __init__(self, name, steps):
            self.name, self.left = name, steps

    def step(t):
        if isinstance(t, _Stall):
            t.gate.wait(5)
            return False
        trace.append(t.name)
        t.left -= 1
        return t.left > 0

    sched = StepScheduler(step, workers=1)
    stall = _Stall()
    sched.submit(stall)
    sched.submit(Task("heavy", 6))
    sched.submit(Task("light", 2))
    stall.gate.set()
    _wait_idle(sched)
    sched.close()
    assert trace[:4] == ["heavy", "light", "heavy", "light"]
    assert trace.count("light") == 2 and trace.count("heavy") == 6


def test_scheduler_prefers_the_earliest_deadline():
    trace = []

    class Task:
        def __init__(self, name, deadline):
            self.name, self.deadline = name, deadline

    def step(t):
        if isinstance(t, _Stall):
            t.gate.wait(5)
            return False
        trace.append(t.name)
        return False

    sched = StepScheduler(step, workers=1)
    stall = _Stall()
    sched.submit(stall)
    now = time.monotonic()
    sched.submit(Task("late", now + 60))
    sched.submit(Task("none", None))
    sched.submit(Task("soon", now + 1))
    stall.gate.set()
    _wait_idle(sched)
    sched.close()
    assert trace == ["soon", "late", "none"]


def test_scheduler_close_drops_queued_tasks_through_the_hook():
    dropped, stepped = [], []
    stall = _Stall()

    def step(t):
        if t is stall:
            t.gate.wait(TIMEOUT)
            return True   # wants more, but the scheduler is closed by then
        stepped.append(t)
        return False

    sched = StepScheduler(step, workers=1, on_drop=dropped.append)
    sched.submit(stall)
    left = object()
    sched.submit(left)
    while sched.pending != 1:   # the worker holds the stall, the heap the other
        time.sleep(0.001)
    closer = threading.Thread(target=sched.close)
    closer.start()
    while not sched._closed:
        time.sleep(0.001)
    stall.gate.set()
    closer.join(TIMEOUT)
    assert not closer.is_alive()
    assert stepped == [] and dropped == [stall, left]
    with pytest.raises(RuntimeError, match="closed"):
        sched.submit(object())


# ---------------------------------------------------------------------------
# QueryService: concurrent serving, served == solo
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workers", [3, 16])
def test_concurrent_tenants_equal_their_solo_runs(stored, workers):
    """4 submitter threads, mixed tenants; every served answer equals the
    port's solo run of its derived seed bit for bit and the reference's
    within 1e-5, and per-query counters sum to the executor's window.  At
    16 workers (more than the cores) the interpreter switches threads every
    microsecond, so a lost update in the service's shared state would show."""
    path, _ = stored
    ds = _open(path)
    specs = [s for _ in range(4) for s in _specs(Aggregate)]
    service_seed = 11
    before = ds.executor.stats()
    tickets: list = [None] * len(specs)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6 if workers > 3 else interval)
    try:
        with QueryService(ds, capacity=8, workers=workers, seed=service_seed) as svc:

            def submitter(lo, hi):
                for i in range(lo, hi):
                    agg, kw = specs[i]
                    tickets[i] = svc.submit(agg, **kw)

            step = len(specs) // 4
            threads = [threading.Thread(target=submitter, args=(j * step, (j + 1) * step))
                       for j in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=TIMEOUT)
            assert not any(t.is_alive() for t in threads)
            served = [svc.result(t, timeout=TIMEOUT) for t in tickets]
            m = svc.metrics()
    finally:
        sys.setswitchinterval(interval)
    window = ds.executor.stats() - before
    total = sum((t.result.executor_stats for t in tickets), ExecutorStats())
    assert (total.hits, total.misses) == (window.hits, window.misses)
    assert sorted(t.id for t in tickets) == list(range(len(specs)))
    assert m.submitted == m.completed == len(specs) and m.failed == 0
    assert {t.outcome for t in tickets} <= {"sketch", "converged", "exhausted"}

    solo_ds = _open(path)
    ref_ds = ref_rsp.open(path, cache_blocks=K)
    ref_specs = [s for _ in range(4) for s in _specs(RefAggregate)]
    for i, t in enumerate(tickets):
        seed = derive_seed(service_seed, t.id)
        assert seed == ref_derive_seed(service_seed, t.id)
        agg, kw = specs[i]
        solo = QueryExecutor(solo_ds, dataclasses.replace(as_query(agg, **kw), seed=seed)).run()
        _equal(served[i], solo)
        ref_agg, ref_kw = ref_specs[i]
        ref = RefQueryExecutor(
            ref_ds, dataclasses.replace(ref_as_query(ref_agg, **ref_kw), seed=seed)).run()
        _close(served[i], ref)
    solo_ds.close()
    ref_ds.close()
    ds.close()


def test_derived_seeds_are_schedule_invariant(stored):
    """The same queries submitted in two orders give the same bits: seeds
    come from stable ids, never from the scheduling order."""
    path, _ = stored

    def run(order):
        ds = _open(path)
        with QueryService(ds, capacity=4, workers=3, seed=42) as svc:
            tickets = {i: svc.submit("p75", max_blocks=5, use_sketches=False,
                                     seed=derive_seed(42, i)) for i in order}
            out = {i: svc.result(t, timeout=TIMEOUT) for i, t in tickets.items()}
        ds.close()
        return out

    a = run(list(range(8)))
    b = run(list(reversed(range(8))))
    for i in range(8):
        _equal(a[i], b[i])


def test_sketch_only_queries_bypass_admission_with_zero_io(stored):
    path, data = stored
    ds = _open(path)
    with QueryService(ds, capacity=1, workers=1, seed=3) as svc:
        slow = _hog(svc)
        fast = [svc.submit(["mean", "count"]) for _ in range(10)]
        for t in fast:
            assert t.done and t.outcome == "sketch" and t.result.from_sketches
            assert t.result.executor_stats.blocks_fetched == 0
        np.testing.assert_allclose(np.asarray(fast[0].result["mean"].estimate),
                                   data.astype(np.float64).mean(0), rtol=1e-5, atol=1e-5)
        assert svc.cancel(slow)
    ds.close()


# ---------------------------------------------------------------------------
# Deadlines, saturation, cancel, close, metrics
# ---------------------------------------------------------------------------

def test_deadline_returns_an_anytime_result_not_a_failure(stored):
    path, data = stored
    ds = _open(path)
    truth = data.astype(np.float64).mean(0)
    with QueryService(ds, capacity=8, workers=2, seed=5) as svc:
        t = _hog(svc, deadline_ms=300, confidence=0.999)
        res = svc.result(t, timeout=TIMEOUT)
        assert t.outcome == "deadline" and not res.converged and res.blocks_read >= 1
        assert t.finished_at >= t.deadline
        a = res["mean"]
        assert np.all(np.asarray(a.ci_lo) <= truth) and np.all(truth <= np.asarray(a.ci_hi))
        assert svc.metrics().deadline_hits == 1
    ds.close()


def test_deadline_fires_while_queued_for_admission(stored):
    path, _ = stored
    ds = _open(path)
    with QueryService(ds, capacity=1, workers=1, seed=5) as svc:
        hog = _hog(svc)
        queued = svc.submit("median", use_sketches=False, deadline_ms=200, target_rel_err=0.01)
        res = svc.result(queued, timeout=TIMEOUT)
        assert queued.outcome == "deadline"
        assert res.blocks_read == 0   # never admitted: the empty anytime answer
        assert np.isnan(np.asarray(res["p50"].estimate)).all()
        assert res["p50"].ci_hi == np.inf
        svc.cancel(hog)
    ds.close()


def test_the_sweeper_finishes_a_ticket_whose_step_is_blocked(stored, monkeypatch):
    """A step that blocks inside its block's sketch (on the card: the
    packed copy back) cannot hold its ticket past the deadline: the sweeper
    finishes it with the last anytime result while the worker still waits,
    with no ``result()`` caller parked on it."""
    path, _ = stored
    gate, entered = threading.Event(), threading.Event()
    calls = []
    sketch = query_mod.block_sketch

    def stalling(block, **kw):
        calls.append(1)
        if len(calls) == 3:
            entered.set()
            gate.wait(TIMEOUT)
        return sketch(block, **kw)

    monkeypatch.setattr(query_mod, "block_sketch", stalling)
    ds = _open(path)
    try:
        with QueryService(ds, capacity=8, workers=1, seed=7) as svc:
            t = svc.submit("mean", use_sketches=False, target_rel_err=1e-12, deadline_ms=300)
            assert entered.wait(TIMEOUT)
            assert t.wait(TIMEOUT)
            assert not gate.is_set()   # the worker is still inside the sketch
            assert t.outcome == "deadline" and t.result.blocks_read == 2
            assert np.isfinite(np.asarray(t.result["mean"].estimate)).all()
            gate.set()
    finally:
        gate.set()
        ds.close()


def test_admission_rejects_when_saturated_and_the_queue_is_full(stored):
    path, _ = stored
    ds = _open(path)
    with QueryService(ds, capacity=1, max_queue=1, workers=1, seed=2) as svc:
        a, b = _hog(svc), _hog(svc)
        with pytest.raises(AdmissionRejected):
            svc.submit("median", use_sketches=False)
        rejected = svc.submit("median", use_sketches=False, on_reject="ticket")
        assert rejected.outcome == "rejected" and rejected.status == "rejected"
        with pytest.raises(AdmissionRejected):
            svc.result(rejected)
        m = svc.metrics()
        assert m.rejected == 2 and m.admission.rejected_total == 2
        assert m.admission.queued == 1
        svc.cancel(a)
        svc.cancel(b)
    ds.close()


def test_cancel_releases_admission_and_unblocks_queued_queries(stored):
    path, _ = stored
    ds = _open(path)
    with QueryService(ds, capacity=1, workers=1, seed=9) as svc:
        hog = _hog(svc)
        queued = svc.submit("mean", use_sketches=False, target_rel_err=0.02)
        assert svc.cancel(hog) is True
        assert svc.cancel(hog) is False
        assert hog.outcome == "cancelled" and hog.result is not None
        res = svc.result(queued, timeout=TIMEOUT)
        assert queued.outcome in ("converged", "exhausted") and res.blocks_read >= 2
    ds.close()


def test_close_cancels_outstanding_queries(stored):
    path, _ = stored
    ds = _open(path)
    svc = QueryService(ds, capacity=2, workers=1, seed=4)
    tickets = [_hog(svc) for _ in range(6)]
    svc.close()
    for t in tickets:
        assert t.done and t.outcome == "cancelled"
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit("mean", use_sketches=False)
    svc.close()   # idempotent
    ds.close()


def test_service_metrics_account_for_every_submission(stored):
    path, _ = stored
    ds = _open(path)
    with QueryService(ds, capacity=8, workers=2, seed=6) as svc:
        tickets = [svc.submit(["mean", "count"]) for _ in range(5)]
        tickets += [svc.submit("median", max_blocks=4, use_sketches=False) for _ in range(5)]
        for t in tickets:
            svc.result(t, timeout=TIMEOUT)
        m = svc.metrics()
        text = svc.registry.to_prometheus()
    assert m.submitted == m.completed == 10 and m.sketch_answers == 5
    assert m.qps > 0 and m.latency_p50_ms <= m.latency_p99_ms
    assert 4 <= m.blocks_fetched <= 20
    assert m.blocks_per_query == pytest.approx(m.blocks_fetched / 10)
    assert "rsp_serve_queries_total" in text and set(OUTCOMES) >= {"sketch", "exhausted"}
    ds.close()


def test_failed_query_surfaces_on_its_ticket(stored):
    path, _ = stored
    ds = _open(path)
    with QueryService(ds, workers=1) as svc:
        t = svc.submit("mean", use_sketches=True, where="c0 > 1")
        assert t.outcome == "failed"
        with pytest.raises(ValueError, match="needs block data"):
            svc.result(t)
    ds.close()


def test_dataset_serve_opens_a_service_over_its_blocks(stored):
    path, _ = stored
    ds = _open(path)
    with ds.serve(capacity=4, workers=2, seed=1) as svc:
        assert isinstance(svc, QueryService) and svc.ds is ds
        res = svc.result(svc.submit(Aggregate("count", by_label=True)), timeout=TIMEOUT)
    assert res.from_sketches
    assert float(np.sum(res.aggregates[0].estimate)) == K * BLOCK
    ds.close()


class _FactoryDataset:
    """A dataset that brings its own executor factory (as a
    ``DistributedDataset`` does) and records every query it was asked for."""

    def __init__(self, ds):
        self._ds = ds
        self.made = []

    def __getattr__(self, name):
        return getattr(self._ds, name)

    def query_executor(self, q):
        self.made.append(q)
        return QueryExecutor(self._ds, q)


def test_service_builds_executors_through_the_dataset_factory(stored):
    path, _ = stored
    ds = _open(path)
    stub = _FactoryDataset(ds)
    with QueryService(stub, capacity=8, workers=2, seed=3) as svc:
        tickets = [svc.submit("mean", use_sketches=False, max_blocks=4),
                   svc.submit(["mean", "count"])]
        results = [svc.result(t, timeout=TIMEOUT) for t in tickets]
    assert [q.seed for q in stub.made] == [t.query.seed for t in tickets]
    assert results[0].blocks_read == 4 and results[1].from_sketches
    solo = QueryExecutor(ds, stub.made[0]).run()
    _equal(results[0], solo)
    ds.close()
