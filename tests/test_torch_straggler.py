"""The port's lease scheduler and straggler simulation against the
reference package's, on the same inputs.

``repro_torch.distributed.straggler`` is pure Python, so every result must
equal the reference's exactly: ``simulate``'s makespan, per-host blocks,
steals, completions and dead hosts, and ``LeaseScheduler``'s grants after
``from_assignment`` / ``fail_host`` / ``redeal``.  The invariants of
``tests/test_distributed.py`` and ``tests/test_distributed_props.py`` hold
too: no block is ever dropped or processed twice while one host survives.
"""

import pytest

from repro.distributed.straggler import LeaseScheduler as RefLeaseScheduler
from repro.distributed.straggler import simulate as ref_simulate
from repro_torch.distributed import LeaseScheduler, simulate


def _same(got, want):
    assert got == want
    return got


def test_straggler_work_stealing_beats_static():
    speeds = [1.0, 1.0, 1.0, 0.1]  # one 10x straggler
    static = _same(simulate(64, speeds, steal=False), ref_simulate(64, speeds, steal=False))
    dynamic = _same(simulate(64, speeds, steal=True), ref_simulate(64, speeds, steal=True))
    assert dynamic["makespan"] < static["makespan"] * 0.5
    done = sorted(b for bs in dynamic["per_host_blocks"].values() for b in bs)
    assert done == list(range(64))  # every block exactly once


def test_straggler_balanced_hosts_no_pathology():
    speeds = [1.0] * 4
    dyn = _same(simulate(32, speeds, steal=True), ref_simulate(32, speeds, steal=True))
    static = _same(simulate(32, speeds, steal=False), ref_simulate(32, speeds, steal=False))
    assert dyn["makespan"] <= static["makespan"] * 1.26


def test_straggler_host_failure_completes_every_block_once():
    out = _same(simulate(40, [4.0, 1.0, 1.0], fail_at={0: 2.0}),
                ref_simulate(40, [4.0, 1.0, 1.0], fail_at={0: 2.0}))
    assert out["dead_hosts"] == [0]
    assert out["completed"] == 40
    done = [b for bs in out["per_host_blocks"].values() for b in bs]
    assert sorted(done) == list(range(40))
    healthy = simulate(40, [4.0, 1.0, 1.0])
    assert out["makespan"] >= healthy["makespan"]  # losing a host has a cost


def test_straggler_all_hosts_dead_reports_shortfall():
    out = _same(simulate(40, [1.0, 1.0], fail_at={0: 0.5, 1: 0.5}),
                ref_simulate(40, [1.0, 1.0], fail_at={0: 0.5, 1: 0.5}))
    assert out["dead_hosts"] == [0, 1]
    assert out["completed"] < 40  # honest: blocks were lost, not hidden


def test_lease_scheduler_request_complete_steal():
    for cls in (LeaseScheduler, RefLeaseScheduler):
        s = cls(list(range(7)), lease_window=3)
        assert s.request(0) == [0, 1, 2] and s.request(1) == [3, 4, 5]
        s.complete(0, 0)
        s.complete(1, 2)  # a steal race: completion by a non-leaseholder
        assert s.steal_from(0) == [1]
        assert s.request(2) == [1, 6]
        for b in (1, 3, 4, 5, 6):
            s.complete(2, b)
        assert s.all_done and s.done_blocks == set(range(7))


def test_redeal_needs_a_survivor():
    s = LeaseScheduler.from_assignment({0: [0, 1]})
    s.fail_host(0)
    with pytest.raises(ValueError, match="survivor"):
        s.redeal([])


hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402


@settings(max_examples=50, deadline=None)
@given(
    num_blocks=st.integers(1, 48),
    speeds=st.lists(st.floats(0.05, 8.0), min_size=1, max_size=6),
    lease_window=st.integers(1, 4),
    fails=st.dictionaries(st.integers(0, 5), st.floats(0.0, 20.0), max_size=5),
    steal=st.booleans(),
)
def test_property_simulate_equals_reference_and_never_drops_or_duplicates(
    num_blocks, speeds, lease_window, fails, steal
):
    fails = {h: t for h, t in fails.items() if h < len(speeds)}
    if len(fails) == len(speeds):
        fails.popitem()  # keep one survivor
    kw = dict(lease_window=lease_window, fail_at=fails, steal=steal)
    out = _same(simulate(num_blocks, speeds, **kw), ref_simulate(num_blocks, speeds, **kw))
    done = [b for bs in out["per_host_blocks"].values() for b in bs]
    assert len(done) == len(set(done)), "a block was processed twice"
    assert sorted(done) == list(range(num_blocks)), "a block was dropped"
    assert out["completed"] == num_blocks
    for h in out["dead_hosts"]:
        assert h in fails


@settings(max_examples=50, deadline=None)
@given(
    num_hosts=st.integers(1, 6),
    positions=st.integers(0, 40),
    failures=st.lists(st.integers(0, 5), max_size=6),
    lease_window=st.integers(1, 4),
    data=st.data(),
)
def test_property_lease_redeal_equals_reference(num_hosts, positions, failures, lease_window,
                                                data):
    owner = data.draw(st.lists(st.integers(0, num_hosts - 1), min_size=positions,
                               max_size=positions))
    assign = {h: [p for p, o in enumerate(owner) if o == h] for h in range(num_hosts)}
    done = data.draw(st.sets(st.integers(0, max(positions - 1, 0)), max_size=positions))
    port = LeaseScheduler.from_assignment(assign, lease_window=lease_window)
    ref = RefLeaseScheduler.from_assignment(assign, lease_window=lease_window)
    for p in sorted(done):
        if p < positions:
            port.complete(owner[p], p)
            ref.complete(owner[p], p)
    failed = set()
    for h in failures:
        if h >= num_hosts:
            continue
        failed.add(h)
        assert port.fail_host(h) == ref.fail_host(h)
        survivors = [s for s in range(num_hosts) if s not in failed] or [h]
        grants = _same(port.redeal(survivors), ref.redeal(survivors))
        # re-granted positions are exactly the dead host's unfinished ones,
        # each to one survivor
        granted = [p for ps in grants.values() for p in ps]
        assert len(granted) == len(set(granted))
        assert not set(granted) & port.done_blocks
    assert port._leases == ref._leases and port.done_blocks == ref.done_blocks
    # every unfinished position is leased to exactly one live host
    leased = [p for h, ps in port._leases.items() for p in ps if p not in port.done_blocks]
    assert sorted(leased) == sorted(set(range(positions)) - port.done_blocks)
