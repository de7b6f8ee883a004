"""The port's distributed RSP queries over the in-process ``LocalTransport``
mesh, against its own single-host answers and the reference package's
distributed answers.

The contract, as ``tests/test_distributed_query.py`` holds the reference
to it: a distributed progressive query is *bit-identical* to the
single-host answer with the same seed -- estimates, CI ends,
``blocks_read``, ``converged`` -- however many hosts run it and whether or
not one dies mid-query.  Against the reference's distributed answer on one
shared store (the port sketches with the kernels' plain versions here, the
reference with its float32 jit paths) estimates and CI ends agree within
1e-5 and ``blocks_read`` / ``converged`` are equal.  Payloads of the
numpy oracles (``sketch_impl="ref"``) encode to the same bytes in both
packages.
"""

import json
import types

import numpy as np
import pytest

from repro import rsp as ref_rsp
from repro.distributed import LocalTransport as RefLocalTransport
from repro.distributed import load_ownership as ref_load_ownership
from repro.distributed import run_local_hosts as ref_run_local_hosts
from repro.distributed import save_ownership as ref_save_ownership
from repro.distributed.ownership import BlockOwnership as RefBlockOwnership
from repro.distributed.rsp import decode_payload as ref_decode_payload
from repro.distributed.rsp import encode_payload as ref_encode_payload
from repro.rsp.query import QueryExecutor as RefQueryExecutor
from repro.rsp.query import as_query as ref_as_query
from repro_torch import rsp
from repro_torch.distributed import (
    BlockOwnership,
    DistributedDataset,
    DistributedQueryExecutor,
    LocalTransport,
    load_ownership,
    run_local_hosts,
    save_ownership,
)
from repro_torch.distributed.elastic import open_or_deal, rebalance_join, redeal_departed
from repro_torch.distributed.rsp import decode_payload, encode_payload
from repro_torch.rsp.engine import ScopedFetcher, as_fetcher
from repro_torch.rsp.query import QueryExecutor, as_query

TOL = 1e-5
# The straggler grace is a wall-clock heuristic: under load a live host can
# run late.  Where no host dies, a late host must never be stolen from, so
# the grace is longer than any test; where one dies, the survivors wait
# KILL_GRACE, and a test that asserts the survivors' re-deal gives them
# SURVIVOR_GRACE, so that one survivor running late is not taken for dead.
NO_DEATH_GRACE = 60.0
KILL_GRACE = 2.0
SURVIVOR_GRACE = 5.0


def _corpus(n=4096, data_seed=7):
    rng = np.random.default_rng(data_seed)
    data = rng.normal(size=(n, 4)).astype(np.float32)
    data[:, 2] = rng.gamma(2.0, 1.0, size=n).astype(np.float32)
    return data


def _make_ds(n=4096, blocks=16, seed=3, data_seed=7):
    return rsp.partition(_corpus(n, data_seed), blocks, seed=seed, device="cpu")


def _sig(r):
    """Canonical bit-exact signature of a QueryResult."""
    return json.dumps(
        {
            "est": {a.name: np.asarray(a.estimate).ravel().tolist() for a in r.aggregates},
            "lo": {
                a.name: None if a.ci_lo is None else np.asarray(a.ci_lo).ravel().tolist()
                for a in r.aggregates
            },
            "hi": {
                a.name: None if a.ci_hi is None else np.asarray(a.ci_hi).ravel().tolist()
                for a in r.aggregates
            },
            "blocks_read": r.blocks_read,
            "converged": r.converged,
            "selectivity": r.selectivity,
        },
        sort_keys=True,
    )


QUERY = dict(
    aggregates=["mean", "p95"],
    target_rel_err=0.04,
    seed=11,
    policy="weighted",
    where="c2 > 0.5",
    max_blocks=16,
)


def _as(as_query_fn, kw):
    kw = dict(kw)
    return as_query_fn(kw.pop("aggregates"), **kw)


def _distributed(ds, transports, query_kwargs, run_hosts=run_local_hosts,
                 grace=NO_DEATH_GRACE):
    """Every host's ``(result, ownership after the query)``; None for a
    host that died by injection."""
    def run(t):
        dds = ds.distribute(t, straggler_grace=grace, poll_interval=0.01)
        return dds.query(**query_kwargs), dds.ownership

    return run_hosts(transports, run)


def _distributed_sigs(ds, transports, query_kwargs, **kwargs):
    return [None if r is None else (_sig(r[0]), r[1])
            for r in _distributed(ds, transports, query_kwargs, **kwargs)]


# ---------------------------------------------------------------------------
# bit-identity with the port's single-host answer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_hosts", [1, 2, 3, 4])
def test_distributed_matches_single_host_bitwise(num_hosts):
    ds = _make_ds()
    ref = _sig(ds.query(**QUERY))
    results = _distributed_sigs(ds, LocalTransport.group(num_hosts), QUERY)
    assert len(results) == num_hosts
    for sig, own in results:
        assert sig == ref
        assert sorted(own.hosts()) == list(range(num_hosts))


def test_early_convergence_stops_at_same_block_everywhere():
    ds = _make_ds(n=8192, blocks=32)
    q = dict(QUERY, aggregates=["mean"], target_rel_err=0.2, max_blocks=32, columns=[2])
    ref = ds.query(**q)
    assert ref.converged and ref.blocks_read < 32  # must actually stop early
    for sig, _own in _distributed_sigs(ds, LocalTransport.group(4), q):
        assert sig == _sig(ref)


def test_uniform_policy_and_grouped_quantiles_match():
    ds = _make_ds()
    q = dict(aggregates=["mean", "p50"], policy="uniform", seed=5, max_blocks=16,
             target_rel_err=0.01, where="c0 > 0.0")
    ref = _sig(ds.query(**q))
    for sig, _own in _distributed_sigs(ds, LocalTransport.group(2), q):
        assert sig == ref


def test_per_class_means_match():
    data = _corpus()
    data[:, 3] = (data[:, 0] > 0).astype(np.float32)
    ds = rsp.partition(data, 16, seed=3, num_classes=2, device="cpu")
    q = dict(aggregates=rsp.Aggregate("mean", by_label=True), seed=2, max_blocks=10,
             use_sketches=False)
    ref = _sig(ds.query(**q))
    for sig, _own in _distributed_sigs(ds, LocalTransport.group(3), q):
        assert sig == ref


def test_each_host_reads_only_its_own_positions():
    ds = _make_ds()
    q = dict(aggregates=["p95"], seed=4, max_blocks=12, use_sketches=False)
    ids = ds.policy("uniform", seed=4).sample(12)

    def run(t):
        dds = ds.distribute(t, straggler_grace=NO_DEATH_GRACE, poll_interval=0.01)
        res = dds.query(**q)
        return res, dds.executor.stats().accesses, set(dds.owned_blocks)

    out = run_local_hosts(LocalTransport.group(4), run)
    # no host died: every position was read once, by its owner
    assert sum(o[1] for o in out) == out[0][0].blocks_read == 12
    assert [o[1] for o in out] == [len(set(ids) & o[2]) for o in out]


# ---------------------------------------------------------------------------
# straggler death mid-query
# ---------------------------------------------------------------------------

def test_killed_host_changes_no_estimate():
    ds = _make_ds(n=8192, blocks=32)
    q = dict(QUERY, max_blocks=32)
    ref = _sig(ds.query(**q))
    transports = LocalTransport.group(4)
    transports[3].kill_after_puts(2)  # dies after publishing 2 payloads
    results = _distributed_sigs(ds, transports, q, grace=SURVIVOR_GRACE)
    survivors = [r for r in results if r is not None]
    assert len(survivors) == 3 and results[3] is None
    for sig, own in survivors:
        assert sig == ref  # estimates, CIs, stopping point: all unchanged
        assert sorted(own.hosts()) == [0, 1, 2]  # dead host re-dealt away
        assert own.epoch == 1


def test_killed_host_blocks_are_redealt_to_survivors():
    ds = _make_ds()
    transports = LocalTransport.group(2)
    transports[1].kill_after_puts(0)  # dies before publishing anything
    ref = _sig(ds.query(**QUERY))
    results = _distributed_sigs(ds, transports, QUERY, grace=KILL_GRACE)
    assert results[1] is None
    sig, own = results[0]
    assert sig == ref
    assert sorted(own.blocks_of(0)) == list(range(ds.num_blocks))


def test_steal_wait_is_recorded_under_telemetry():
    """Under telemetry a survivor records its wait for a dead host's payload
    up to the re-deal: one steal, at least the grace."""
    from repro_torch import obs

    ds = _make_ds()
    ref = _sig(ds.query(**QUERY))
    transports = LocalTransport.group(2)
    transports[1].kill_after_puts(0)
    obs.reset()
    obs.enable()
    try:
        results = _distributed_sigs(ds, transports, QUERY, grace=KILL_GRACE)
        series = obs.get_registry().snapshot()["rsp_mesh_steal_seconds"]["series"]
    finally:
        obs.reset()
    assert results[1] is None and results[0][0] == ref
    assert [r["labels"] for r in series] == [{"host": "0"}]
    assert series[0]["count"] == 1 and series[0]["sum"] >= KILL_GRACE


def test_a_failing_host_surfaces_its_error():
    ds = _make_ds()

    def run(t):
        dds = ds.distribute(t, straggler_grace=KILL_GRACE, poll_interval=0.01)
        if t.host_id == 1:
            raise RuntimeError("host 1 broke")
        return dds.query(**QUERY)

    with pytest.raises(RuntimeError, match="host 1 broke"):
        run_local_hosts(LocalTransport.group(2), run)


# ---------------------------------------------------------------------------
# serve: QueryService over a DistributedDataset
# ---------------------------------------------------------------------------

def test_query_service_over_distributed_mesh():
    ds = _make_ds()
    ref = _sig(ds.query(**QUERY))

    def run(t):
        dds = ds.distribute(t, straggler_grace=NO_DEATH_GRACE, poll_interval=0.01)
        with dds.serve(workers=1) as svc:
            # explicit seed: every host's service derives the same namespace
            ticket = svc.submit(**QUERY)
            result = svc.result(ticket, timeout=60.0)
            return _sig(result), ticket

    for sig, ticket in run_local_hosts(LocalTransport.group(2), run):
        assert sig == ref
        assert ticket.outcome in ("converged", "exhausted")


def test_served_queries_run_through_the_distributed_executor():
    ds = _make_ds()
    made = []

    class Recording(DistributedDataset):
        def query_executor(self, query):
            qe = super().query_executor(query)
            made.append(qe)
            return qe

    def run(t):
        dds = Recording(ds, t, straggler_grace=NO_DEATH_GRACE, poll_interval=0.01)
        with dds.serve(workers=1) as svc:
            res = svc.result(svc.submit(**QUERY), timeout=60.0)
        return _sig(res), dds.executor.stats().accesses

    ref = ds.query(**QUERY)
    out = run_local_hosts(LocalTransport.group(2), run)
    assert [sig for sig, _ in out] == [_sig(ref)] * 2
    assert len(made) == 2 and all(isinstance(qe, DistributedQueryExecutor) for qe in made)
    # the blocks were read by the mesh's scoped executors, not the dataset's
    assert sum(n for _, n in out) >= ref.blocks_read


# ---------------------------------------------------------------------------
# scope enforcement
# ---------------------------------------------------------------------------

class _CountingFetcher:
    def __init__(self, inner):
        self.inner = inner
        self.reads = []

    @property
    def num_blocks(self):
        return self.inner.num_blocks

    def fetch(self, block_id):
        self.reads.append(block_id)
        return self.inner.fetch(block_id)


def test_scoped_fetcher_denies_unowned_blocks():
    ds = _make_ds()
    inner = _CountingFetcher(as_fetcher(ds._make_fetcher()))
    scoped = ScopedFetcher(inner, [0, 1, 2])
    assert as_fetcher(scoped) is scoped
    assert scoped.fetch(1) is not None
    with pytest.raises(PermissionError):
        scoped.fetch(3)
    assert inner.reads == [1]  # refused before the inner fetcher read anything
    scoped.allow([3])  # a stolen lease widens the scope
    assert scoped.fetch(3) is not None
    scoped.replace([5])  # a re-deal resets it
    with pytest.raises(PermissionError):
        scoped.fetch(0)
    assert scoped.fetch(5) is not None
    assert scoped.allowed == frozenset({5}) and inner.reads == [1, 3, 5]


def test_a_host_never_reads_a_block_it_does_not_own():
    ds = _make_ds()
    t = LocalTransport.group(2)[0]
    dds = ds.distribute(t)
    foreign = next(b for b in range(ds.num_blocks) if b not in dds.owned_blocks)
    with pytest.raises(PermissionError):
        dds.executor.fetch(foreign)


def test_distributed_dataset_requires_summaries():
    rng = np.random.default_rng(0)
    data = rng.normal(size=(1024, 2)).astype(np.float32)
    ds = rsp.partition(data, 4, summaries=False, device="cpu")
    with pytest.raises(ValueError, match="summaries"):
        ds.distribute(LocalTransport.group(1)[0])


# ---------------------------------------------------------------------------
# elastic churn: leave, join, persisted deals
# ---------------------------------------------------------------------------

def test_redeal_departed_covers_all_blocks():
    own = BlockOwnership.deal(32, 4, seed=1)
    new = redeal_departed(own, [2])
    assert sorted(new.hosts()) == [0, 1, 3]
    covered = sorted(b for h in new.hosts() for b in new.blocks_of(h))
    assert covered == list(range(32))
    assert new.epoch == own.epoch + 1
    assert new.to_dict() == RefBlockOwnership.deal(32, 4, seed=1).redeal([2]).to_dict()


def test_join_rebalance_roundtrips_through_store(tmp_path):
    store = types.SimpleNamespace(root=str(tmp_path))
    own = open_or_deal(store, 32, 2, seed=5)
    assert load_ownership(store) == own
    grown = rebalance_join(own, 3, store=store)
    assert grown.num_hosts == 3
    assert load_ownership(store) == grown
    # matching reopen returns the persisted deal, mismatch deals fresh
    assert open_or_deal(store, 32, 3) == grown
    fresh = open_or_deal(store, 32, 4)
    assert fresh.num_hosts == 4 and load_ownership(store) == fresh


def test_ownership_save_load_roundtrip(tmp_path):
    store = types.SimpleNamespace(root=str(tmp_path))
    own = BlockOwnership.deal(16, 3, seed=9).redeal([1])
    save_ownership(store, own)
    assert load_ownership(store) == own


def test_ownership_rejects_invalid_deals():
    from repro_torch.core.sampler import HostAssignment

    with pytest.raises(ValueError, match="owned by hosts"):
        BlockOwnership(HostAssignment({0: [0, 1], 1: [1, 2]}), num_blocks=3)
    with pytest.raises(ValueError, match="no owner"):
        BlockOwnership(HostAssignment({0: [0], 1: [2]}), num_blocks=3)
    with pytest.raises(ValueError, match="outside"):
        BlockOwnership(HostAssignment({0: [0, 1, 7]}), num_blocks=3)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_ownership_json_opens_in_the_other_package(tmp_path, writer):
    store = types.SimpleNamespace(root=str(tmp_path))
    port = BlockOwnership.deal(40, 3, seed=4).redeal([2]).rebalance(5).redeal([0])
    ref = RefBlockOwnership.deal(40, 3, seed=4).redeal([2]).rebalance(5).redeal([0])
    assert port.to_dict() == ref.to_dict()
    if writer == "reference":
        ref_save_ownership(store, ref)
        got = load_ownership(store)
        assert got == port
    else:
        save_ownership(store, port)
        got = ref_load_ownership(store)
        assert got.to_dict() == port.to_dict()
    assert all(got.blocks_of(h) == port.blocks_of(h) for h in port.hosts())


def test_elastic_join_after_query(tmp_path):
    ds = _make_ds()
    t = LocalTransport.group(1)[0]
    dds = ds.distribute(t)
    dds.query(**QUERY)
    assert sorted(dds.owned_blocks) == list(range(16))
    own = dds.rebalance(3)  # two hosts joined
    assert own.num_hosts == 3
    assert sorted(dds.owned_blocks) == sorted(own.blocks_of(0))
    store = types.SimpleNamespace(root=str(tmp_path))
    save_ownership(store, own)
    assert load_ownership(store) == own


def test_note_departed_narrows_the_scope():
    ds = _make_ds()
    dds = ds.distribute(LocalTransport.group(4)[1])
    mine = set(dds.owned_blocks)
    own = dds.note_departed([3, 1])  # a host never re-deals itself away
    assert own.hosts() == [0, 1, 2] and set(dds.owned_blocks) > mine
    foreign = next(b for b in range(ds.num_blocks) if b not in dds.owned_blocks)
    with pytest.raises(PermissionError):
        dds.executor.fetch(foreign)


# ---------------------------------------------------------------------------
# against the reference's distributed answer on one shared store
# ---------------------------------------------------------------------------

CROSS_QUERIES = {
    "weighted_where_p95": QUERY,
    "uniform_columns": dict(aggregates=["mean", "var"], policy="uniform", seed=5,
                            columns=(0, 2), max_blocks=16, target_rel_err=0.05,
                            use_sketches=False),
    "quantile_histogram": dict(aggregates=["p50", "histogram"], seed=8, max_blocks=6,
                               use_sketches=False),
}


@pytest.fixture(scope="module")
def shared_store(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mesh") / "corpus.rsp")
    ref_rsp.partition(_corpus(8192), blocks=32, seed=3, backend="np").save(path)
    return path


@pytest.mark.parametrize("name", sorted(CROSS_QUERIES))
def test_port_distributed_agrees_with_reference_distributed(shared_store, name):
    q = CROSS_QUERIES[name]
    ref_ds = ref_rsp.open(shared_store)
    port_ds = rsp.open(shared_store, device="cpu")
    transports = RefLocalTransport.group(3)
    transports[2].kill_after_puts(1)
    want = [r for r in _distributed(ref_ds, transports, q, run_hosts=ref_run_local_hosts,
                                    grace=KILL_GRACE) if r is not None]
    transports = LocalTransport.group(3)
    transports[2].kill_after_puts(1)
    got = [r for r in _distributed(port_ds, transports, q, grace=KILL_GRACE) if r is not None]
    assert len(got) == len(want) == 2
    # the re-deal depends on which host ran late (a wall-clock grace); the
    # answers do not
    for (g, g_own), (w, w_own) in zip(got, want):
        assert 2 not in g_own.hosts() and 2 not in w_own.hosts()
        assert (g.blocks_read, g.converged) == (w.blocks_read, w.converged)
        for a, b in zip(g.aggregates, w.aggregates):
            assert a.name == b.name
            for f in ("estimate", "ci_lo", "ci_hi"):
                x, y = getattr(a, f), getattr(b, f)
                if y is None:
                    assert x is None
                    continue
                np.testing.assert_allclose(np.asarray(x, np.float64), np.asarray(y, np.float64),
                                           rtol=TOL, atol=TOL, err_msg=f"{a.name}.{f}")


# ---------------------------------------------------------------------------
# the payload codec
# ---------------------------------------------------------------------------

PAYLOAD_QUERIES = {
    "p95_where": dict(aggregates=["mean", "p95"], where="c2 > 0.5"),
    "columns_histogram": dict(aggregates=["histogram", "var"], columns=(0, 3), bins=16),
    "distinct": dict(aggregates=["distinct", "mean"], where="c0 < 0.0"),
}


def _payload(executor_cls, ds, q, block):
    qe = executor_cls(ds, q)
    needs_hist = any(a.kind in ("quantile", "histogram") for a in q.aggregates)
    needs_rows = any(a.kind == "distinct" for a in q.aggregates)
    lo, hi = qe._grid() if needs_hist else (None, None)
    return qe._make_payload(block, lo, hi, needs_hist, needs_rows, False, True)


@pytest.mark.parametrize("name", sorted(PAYLOAD_QUERIES))
def test_ref_impl_payloads_encode_to_the_same_bytes_in_both_packages(shared_store, name):
    kw = dict(PAYLOAD_QUERIES[name], use_sketches=False, sketch_impl="ref")
    ref_ds = ref_rsp.open(shared_store)
    port_ds = rsp.open(shared_store, device="cpu")
    for b in (0, 17):
        want = ref_encode_payload(_payload(RefQueryExecutor, ref_ds, _as(ref_as_query, kw),
                                           ref_ds.block(b)))
        p = _payload(QueryExecutor, port_ds, _as(as_query, kw), port_ds.block(b))
        got = encode_payload(p)
        assert got == want
        back = decode_payload(got)
        assert encode_payload(back) == got
        assert ref_decode_payload(got).keys() == back.keys()
        for field in ("whole",):
            for attr in ("count", "mean", "m2", "min", "max", "hist", "lo", "hi"):
                x, y = getattr(back[field], attr), getattr(p[field], attr)
                if y is None:
                    assert x is None
                else:
                    assert np.asarray(x).dtype == np.asarray(y).dtype
                    np.testing.assert_array_equal(x, y)


def test_torch_impl_payload_roundtrips_exactly():
    ds = _make_ds()
    q = as_query(["mean", "p95"], where="c2 > 0.5", use_sketches=False)
    p = _payload(QueryExecutor, ds, q, ds.block(3))
    back = decode_payload(encode_payload(p))
    assert (back["rows_total"], back["rows_selected"]) == (p["rows_total"], p["rows_selected"])
    for attr in ("mean", "m2", "min", "max", "hist", "lo", "hi"):
        x, y = getattr(back["whole"], attr), getattr(p["whole"], attr)
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(x, y)
    with pytest.raises(TypeError, match="BlockSketch"):
        encode_payload(dict(p, whole=types.SimpleNamespace(count=1.0)))


# ---------------------------------------------------------------------------
# property: any host count, any kill schedule (tests/test_distributed_props.py)
# ---------------------------------------------------------------------------

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

_DS_CACHE: dict = {}


def _cached_ds(data_seed):
    if data_seed not in _DS_CACHE:
        _DS_CACHE[data_seed] = _make_ds(n=2048, blocks=8, seed=3, data_seed=data_seed)
    return _DS_CACHE[data_seed]


@settings(max_examples=8, deadline=None, suppress_health_check=list(HealthCheck))
@given(
    data_seed=st.integers(0, 3),
    query_seed=st.integers(0, 1000),
    num_hosts=st.integers(1, 4),
    policy=st.sampled_from(["uniform", "weighted"]),
    kill=st.one_of(st.none(), st.tuples(st.integers(0, 3), st.integers(0, 3))),
)
def test_property_distributed_equals_single_host(
    data_seed, query_seed, num_hosts, policy, kill
):
    ds = _cached_ds(data_seed)
    q = dict(aggregates=["mean"], target_rel_err=0.05, seed=query_seed,
             policy=policy, where="c2 > 0.5", max_blocks=8)
    ref = _sig(ds.query(**q))
    transports = LocalTransport.group(num_hosts)
    killed = None
    if kill is not None and num_hosts > 1:
        killed = kill[0] % num_hosts
        transports[killed].kill_after_puts(kill[1])
    results = _distributed_sigs(ds, transports, q, grace=KILL_GRACE)
    for h, r in enumerate(results):
        if h == killed:
            continue  # may be None (died) -- only survivors have a contract
        assert r is not None and r[0] == ref
