"""Liveness of the port's mesh hosts: the heartbeat that a host runs while
it works on a query, and the waiter's grace that restarts whenever the
holder's counter moves.

* Beats are not publishes: ``LocalTransport.kill_after_puts`` counts puts
  only, so a test's kill point stays where it was.
* A killed host's beat raises, so its heartbeat -- and its counter --
  stop, and its peers steal from it after one grace.
* A holder that beats on but is stuck (its fetch never returns) is waited
  for at most ``LIVE_GRACES`` graces: then its peer computes the holder's
  positions itself, and the holder, alive, stays an owner.
* The killed-host query of ``test_torch_distributed_query.py`` runs beside
  a thread that burns the interpreter lock.  A wall-clock grace then takes
  a live but late survivor for dead (its re-deal drops it from the
  owners); with the heartbeat, every survivor stays an owner and every
  answer equals the single host's.
"""

import sys
import threading
import time

import numpy as np
import pytest

from repro_torch import rsp
from repro_torch.distributed import (
    Heartbeat,
    HostKilledError,
    LocalTransport,
    TCPStoreTransport,
    TransportError,
    run_local_hosts,
    serve_store,
)
from repro_torch.distributed.rsp import BEATS_PER_GRACE, LIVE_GRACES

# the values of tests/test_torch_distributed_query.py
SURVIVOR_GRACE = 5.0
QUERY = dict(aggregates=["mean", "p95"], target_rel_err=0.04, seed=11, policy="weighted",
             where="c2 > 0.5", max_blocks=32)


def _make_ds(n=8192, blocks=32, seed=3, data_seed=7):
    rng = np.random.default_rng(data_seed)
    data = rng.normal(size=(n, 4)).astype(np.float32)
    data[:, 2] = rng.gamma(2.0, 1.0, size=n).astype(np.float32)
    return rsp.partition(data, blocks, seed=seed, device="cpu")


def _sig(r):
    """Estimates, CI ends, blocks read and convergence, as exact lists."""
    return (
        [np.asarray(a.estimate).ravel().tolist() for a in r.aggregates],
        [None if a.ci_lo is None else np.asarray(a.ci_lo).ravel().tolist() for a in r.aggregates],
        [None if a.ci_hi is None else np.asarray(a.ci_hi).ravel().tolist() for a in r.aggregates],
        r.blocks_read, r.converged,
    )


def _count(t, key):
    v = t.get(key, 0.0)
    return 0 if v is None else int(v)


def test_beats_do_not_count_toward_kill_after_puts():
    a, b = LocalTransport.group(2)
    a.kill_after_puts(2)
    for _ in range(50):
        a.beat("q/hb/0")
    a.put("q/p/0", b"x")
    a.put("q/p/1", b"y")
    assert _count(b, "q/hb/0") == 50
    with pytest.raises(HostKilledError):
        a.put("q/p/2", b"z")     # the third publish, as without beats
    with pytest.raises(HostKilledError):
        a.beat("q/hb/0")         # a killed host beats no more
    assert _count(b, "q/hb/0") == 50
    assert b.poll("q/p/") == {"q/p/0": b"x", "q/p/1": b"y"}   # beats are not published keys


def test_a_killed_hosts_heartbeat_stops():
    a, b = LocalTransport.group(2)
    a.kill_after_puts(0)
    hb = Heartbeat(a, "q/hb/0", 0.01).start()
    try:
        deadline = time.monotonic() + 10.0
        while _count(b, "q/hb/0") < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert _count(b, "q/hb/0") >= 3   # alive: the counter moves
        with pytest.raises(HostKilledError):
            a.put("q/p/0", b"x")          # dies here
        time.sleep(0.05)                  # at most one beat was in flight
        stopped = _count(b, "q/hb/0")
        time.sleep(0.2)
        assert _count(b, "q/hb/0") == stopped
        hb._thread.join(timeout=10.0)
        assert not hb._thread.is_alive()  # a refused beat ends the thread
    finally:
        hb.stop()


def test_heartbeat_stop_joins_its_thread():
    (t,) = LocalTransport.group(1)
    hb = Heartbeat(t, "hb", 0.01).start()
    time.sleep(0.05)
    hb.stop()
    assert not hb._thread.is_alive()
    n = _count(t, "hb")
    time.sleep(0.05)
    assert _count(t, "hb") == n and n >= 1
    hb.stop()   # idempotent
    with pytest.raises(ValueError):
        Heartbeat(t, "hb", 0.0)


def test_tcpstore_beat_is_an_atomic_add():
    store = serve_store()
    a = TCPStoreTransport.connect(f"127.0.0.1:{store.port}", 0, 2)
    b = TCPStoreTransport.connect(f"127.0.0.1:{store.port}", 1, 2)
    threads = [threading.Thread(target=lambda t=t: [t.beat("q/hb/0") for _ in range(25)])
               for t in (a, b)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30.0)
    assert _count(b, "q/hb/0") == 50
    a.put("q/p/0", b"x")                  # a put still publishes once
    assert b.poll("q/p/") == {"q/p/0": b"x"}
    assert b.poll("q/hb/") == {}          # beat keys are not indexed
    assert isinstance(HostKilledError("x"), TransportError)


def test_query_runs_and_joins_one_heartbeat_a_host():
    ds = _make_ds(n=4096, blocks=16)
    before = {t.name for t in threading.enumerate()}

    def run(t):
        dds = ds.distribute(t, straggler_grace=60.0, poll_interval=0.01)
        res = dds.query(**dict(QUERY, max_blocks=16))
        ns = next(iter(t.poll("rspq/")), None)
        dds.close()
        return res, ns

    out = run_local_hosts(LocalTransport.group(3), run)
    assert all(r is not None for r in out)
    leftover = {t.name for t in threading.enumerate()} - before
    assert not any(n.startswith("rsp-heartbeat") for n in leftover)


def test_distributed_dataset_close_stops_a_running_heartbeat():
    ds = _make_ds(n=4096, blocks=16)
    (t,) = LocalTransport.group(1)
    dds = ds.distribute(t, straggler_grace=60.0, poll_interval=0.01)
    stream = dds.query_stream(**dict(QUERY, max_blocks=16))
    next(stream)                          # the query is under way: one heartbeat
    assert len(dds._heartbeats) == 1
    (hb,) = dds._heartbeats
    assert hb._thread.is_alive()
    assert BEATS_PER_GRACE * hb._period == pytest.approx(60.0)
    dds.close()
    assert not hb._thread.is_alive() and not dds._heartbeats
    stream.close()


def test_a_stuck_but_beating_holder_is_taken_from_and_stays_an_owner():
    """Host 1's fetch blocks until the test lets go, while its heartbeat
    beats on.  Host 0 waits at most ``LIVE_GRACES`` graces for host 1's
    first position, then computes host 1's positions itself: its answer is
    the single host's, it ends while host 1 is still stuck, and host 1 is
    neither presumed dead nor dealt away."""
    ds = _make_ds(n=4096, blocks=16)
    q = dict(QUERY, max_blocks=16)
    ref = ds.query(**q)
    grace = 1.0
    release = threading.Event()
    safety = threading.Timer(120.0, release.set)   # an unbounded wait ends here, and fails
    t0, t1 = LocalTransport.group(2)
    out: dict = {}

    def host0():
        dds = ds.distribute(t0, straggler_grace=grace, poll_interval=0.01)
        made = []
        make = dds.query_executor
        dds.query_executor = lambda query: made.append(make(query)) or made[-1]
        start = time.monotonic()
        out["res0"] = dds.query(**q)
        out["seconds"] = time.monotonic() - start
        out["ended_while_stuck"] = not release.is_set()
        out["qe"], out["own"] = made[0], dds.ownership
        dds.close()

    def host1():
        dds = ds.distribute(t1, straggler_grace=grace, poll_interval=0.01)
        fetch = dds.executor.fetch

        def stuck(*args, **kwargs):
            release.wait()
            return fetch(*args, **kwargs)

        dds.executor.fetch = stuck
        try:
            out["res1"] = dds.query(**q)
        finally:
            dds.close()

    threads = [threading.Thread(target=f, daemon=True) for f in (host0, host1)]
    safety.start()
    try:
        for th in threads:
            th.start()
        threads[0].join(timeout=180.0)
        release.set()
        threads[1].join(timeout=180.0)
    finally:
        safety.cancel()
    assert not any(th.is_alive() for th in threads)
    assert out["ended_while_stuck"]
    assert out["seconds"] >= LIVE_GRACES * grace           # it waited the bound out first
    assert _sig(out["res0"]) == _sig(ref) == _sig(out["res1"])
    assert out["qe"].stalled == {1} and out["qe"].presumed_dead == set()
    assert sorted(out["own"].hosts()) == [0, 1] and out["own"].epoch == 0


def _burn(stop: threading.Event) -> None:
    """Execute bytecode without a pause: every other thread gets the
    interpreter lock only when this one is made to hand it over."""
    x = 0
    while not stop.is_set():
        for _ in range(10_000):
            x += 1


# One burner under a 20 ms switch interval: each hand-over of the lock to
# a host thread waits for the burner's turn.  Measured on an 8-core host,
# the killed-host query below took 160-220 s beside one to four burners;
# without the heartbeat it presumed a live survivor dead in each of four
# such runs.
BURNERS = 1
SWITCH_INTERVAL = 0.02


def test_killed_host_changes_no_estimate_beside_a_lock_burner():
    """``test_killed_host_changes_no_estimate`` beside a thread that burns
    the interpreter lock: a survivor whose payload is late only because its
    thread waits for the lock stays an owner."""
    ds = _make_ds()
    ref = ds.query(**QUERY)
    transports = LocalTransport.group(4)
    transports[3].kill_after_puts(2)   # dies after publishing 2 payloads
    stop = threading.Event()
    burners = [threading.Thread(target=_burn, args=(stop,), name=f"lock-burner-{i}",
                                daemon=True) for i in range(BURNERS)]
    old = sys.getswitchinterval()

    def run(t):
        dds = ds.distribute(t, straggler_grace=SURVIVOR_GRACE, poll_interval=0.01)
        return dds.query(**QUERY), dds.ownership

    sys.setswitchinterval(SWITCH_INTERVAL)
    try:
        for th in burners:
            th.start()
        results = run_local_hosts(transports, run)
    finally:
        stop.set()
        sys.setswitchinterval(old)
        for th in burners:
            th.join(timeout=30.0)
    assert not any(th.is_alive() for th in burners)
    survivors = [r for r in results if r is not None]
    assert len(survivors) == 3 and results[3] is None
    for res, own in survivors:
        assert _sig(res) == _sig(ref)
        assert sorted(own.hosts()) == [0, 1, 2]   # only the dead host re-dealt away
        assert own.epoch == 1
