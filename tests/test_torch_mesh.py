"""The port's multi-process mesh: ``TCPStoreTransport`` over a
``torch.distributed.TCPStore`` hosted by the launcher, and the distributed
query run by real OS processes (``tests/test_distributed_rsp.py``'s mesh
cases, on the CPU).

The launcher below hosts the store in the test process (so a killed worker
cannot take it down), binds a free port, exports an explicit
``PYTHONPATH`` and the ``RSP_COORDINATOR`` / ``RSP_NUM_PROCESSES`` /
``RSP_PROCESS_ID`` variables ``init_from_env`` reads, gives every child its
own timeout and reads back every child's streams whatever happens.  Each
child partitions the same seed-deterministic corpus, so each checks its mesh
answer bit for bit against the single-host answer it computes itself.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time

import pytest

from repro_torch.distributed import TCPStoreTransport, TransportError, init_from_env, serve_store

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
CHILD_TIMEOUT = 60.0


@dataclasses.dataclass
class Child:
    rank: int
    returncode: int | None
    stdout: str
    stderr: str
    timed_out: bool = False
    killed: bool = False

    def describe(self) -> str:
        status = ("timed out" if self.timed_out else "killed (injected)" if self.killed
                  else f"exit {self.returncode}")
        return (f"--- process {self.rank}: {status} ---\nstdout:\n{self.stdout[-2000:]}\n"
                f"stderr:\n{self.stderr[-4000:]}\n")


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def gloo_init() -> str:
    """A child's lines that join the gloo group of ``RSP_NUM_PROCESSES``
    ranks on the ``TCPStore`` the launcher hosts at ``RSP_STORE``: the
    launcher keeps the store bound, so no other process can take its port
    before the ranks meet."""
    return ('host, port = os.environ["RSP_STORE"].rsplit(":", 1)\n'
            'dist.init_process_group("gloo", store=dist.TCPStore(host, int(port),'
            ' is_master=False), rank=int(os.environ["RSP_PROCESS_ID"]),'
            ' world_size=int(os.environ["RSP_NUM_PROCESSES"]))')


def run_children(source: str, n: int, *, env: dict | None = None, timeout: float = CHILD_TIMEOUT,
                 kill_when=None) -> list[Child]:
    """Run ``source`` as ``n`` processes (``RSP_PROCESS_ID`` 0..n-1 and
    ``RSP_NUM_PROCESSES`` set, with ``env`` on top), each killed past
    ``timeout`` seconds.  ``kill_when(rank) -> bool`` is polled while the
    children run: a child for which it turns true is SIGKILLed."""
    with tempfile.TemporaryDirectory(prefix="rsp-torch-mesh-") as tmp:
        script = os.path.join(tmp, "child.py")
        with open(script, "w") as f:
            f.write(source)
        procs, files = [], []
        for rank in range(n):
            penv = dict(os.environ)
            penv.update(env or {})
            penv["PYTHONPATH"] = SRC + os.pathsep + penv.get("PYTHONPATH", "")
            penv["RSP_NUM_PROCESSES"] = str(n)
            penv["RSP_PROCESS_ID"] = str(rank)
            penv["OMP_NUM_THREADS"] = "1"
            out = open(os.path.join(tmp, f"out.{rank}"), "w+")
            err = open(os.path.join(tmp, f"err.{rank}"), "w+")
            files.append((out, err))
            procs.append(subprocess.Popen([sys.executable, script], env=penv, stdout=out,
                                          stderr=err, cwd=tmp))
        start = time.monotonic()
        killed, timed_out = set(), set()
        try:
            while any(p.poll() is None for p in procs):
                for rank, p in enumerate(procs):
                    if p.poll() is not None:
                        continue
                    if kill_when is not None and rank not in killed and kill_when(rank):
                        p.send_signal(signal.SIGKILL)
                        killed.add(rank)
                    elif time.monotonic() - start > timeout:
                        p.send_signal(signal.SIGKILL)
                        timed_out.add(rank)
                time.sleep(0.02)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.send_signal(signal.SIGKILL)
                p.wait()
        children = []
        for rank, (p, (out, err)) in enumerate(zip(procs, files)):
            out.seek(0)
            err.seek(0)
            children.append(Child(rank, p.returncode, out.read(), err.read(),
                                  rank in timed_out, rank in killed))
            out.close()
            err.close()
        return children


def assert_ok(children: list[Child], marker: str) -> None:
    report = "\n".join(c.describe() for c in children)
    for c in children:
        if c.killed:
            continue
        assert c.returncode == 0 and not c.timed_out, f"process {c.rank} failed\n{report}"
        assert marker in c.stdout, f"process {c.rank} missing {marker!r}\n{report}"


def marked(child: Child, marker: str):
    line = next(ln for ln in child.stdout.splitlines() if ln.startswith(marker))
    return json.loads(line[len(marker):])


# ---------------------------------------------------------------------------
# the transport in one process
# ---------------------------------------------------------------------------

@pytest.fixture
def store():
    server = serve_store()
    yield server


def test_put_get_and_idempotent_duplicate_publish(store):
    a = TCPStoreTransport.connect(f"127.0.0.1:{store.port}", 0, 2)
    b = TCPStoreTransport.connect(f"127.0.0.1:{store.port}", 1, 2)
    assert (a.host_id, a.num_hosts, b.host_id) == (0, 2, 1)
    assert b.get("q/p/0") is None
    a.put("q/p/0", b"payload")
    assert b.get("q/p/0", timeout=1.0) == b"payload"
    b.put("q/p/0", b"payload")          # a stolen position published twice
    b.put("q/p/0", b"other bytes")      # the first publish stays
    assert a.get("q/p/0") == b"payload"
    with pytest.raises(ValueError, match="reserved"):
        a.put("q/p/_keys", b"x")


def test_get_times_out_with_none(store):
    t = TCPStoreTransport.connect(f"127.0.0.1:{store.port}", 0, 1)
    t0 = time.monotonic()
    assert t.get("never", timeout=0.2) is None
    assert 0.2 <= time.monotonic() - t0 < 2.0


def test_poll_lists_a_directory_by_prefix(store):
    a = TCPStoreTransport.connect(f"127.0.0.1:{store.port}", 0, 2)
    b = TCPStoreTransport.connect(f"127.0.0.1:{store.port}", 1, 2)
    assert a.poll("rspq/x/fp/") == {}
    a.put("rspq/x/fp/0", b"f0")
    b.put("rspq/x/fp/1", b"f1")
    b.put("rspq/x/fp/1", b"f1")
    b.put("rspq/x/fpz", b"no")
    a.put("rspq/y/fp/0", b"elsewhere")
    assert b.poll("rspq/x/fp/") == {"rspq/x/fp/0": b"f0", "rspq/x/fp/1": b"f1"}
    assert a.poll("rspq/x/fp/1") == {"rspq/x/fp/1": b"f1"}


def test_a_lost_store_is_a_transport_error():
    server = serve_store()
    t = TCPStoreTransport.connect(f"127.0.0.1:{server.port}", 0, 1)
    t.put("k", b"v")
    del server
    with pytest.raises(TransportError):
        for _ in range(50):
            t.put("k2", b"v")
            time.sleep(0.01)
    with pytest.raises(TransportError, match="cannot reach"):
        TCPStoreTransport.connect(f"127.0.0.1:{free_port()}", 0, 1, timeout=0.5)


def test_init_from_env_reads_the_launcher_variables(store):
    assert init_from_env({}) is None
    t = init_from_env({"RSP_COORDINATOR": f"127.0.0.1:{store.port}",
                       "RSP_NUM_PROCESSES": "3", "RSP_PROCESS_ID": "2"})
    assert isinstance(t, TCPStoreTransport) and (t.host_id, t.num_hosts) == (2, 3)
    with pytest.raises(ValueError, match="host:port"):
        TCPStoreTransport.connect("nowhere", 0, 1)


# ---------------------------------------------------------------------------
# the distributed query across processes
# ---------------------------------------------------------------------------

CORPUS = r"""
import json, os, signal, sys
import numpy as np
from repro_torch import rsp
from repro_torch.distributed import init_from_env

def corpus():
    rng = np.random.default_rng(7)
    data = rng.normal(size=(32768, 4)).astype(np.float32)
    data[:, 2] = rng.gamma(2.0, 1.0, size=32768).astype(np.float32)
    return rsp.partition(data, 32, seed=3, device="cpu")

KWARGS = dict(aggregates=["mean", "p95"], target_rel_err=0.04, seed=11, policy="weighted",
              where="c2 > 0.5", max_blocks=32)

def sig(r):
    return json.dumps({
        "est": {a.name: np.asarray(a.estimate).ravel().tolist() for a in r.aggregates},
        "lo": {a.name: None if a.ci_lo is None else np.asarray(a.ci_lo).ravel().tolist()
               for a in r.aggregates},
        "hi": {a.name: None if a.ci_hi is None else np.asarray(a.ci_hi).ravel().tolist()
               for a in r.aggregates},
        "blocks_read": r.blocks_read, "converged": r.converged}, sort_keys=True)
"""

MESH_QUERY = CORPUS + r"""
t = init_from_env()
ds = corpus()
ref = ds.query(**KWARGS)
# start together: a peer still starting up must not look like a straggler
victim = os.environ.get("RSP_VICTIM")
t.put("start/%d" % t.host_id, b"1")
for h in range(t.num_hosts):
    if str(h) != victim:
        assert t.get("start/%d" % h, timeout=50.0) is not None, "host %d never started" % h
dds = ds.distribute(t, straggler_grace=float(os.environ["RSP_GRACE"]), poll_interval=0.02)
res = dds.query(**KWARGS)
assert sig(ref) == sig(res), "distributed != single-host:\n%s\n%s" % (sig(ref), sig(res))
assert len(dds.owned_blocks) > 0
print("SIG " + json.dumps({"single": sig(ref), "mesh": sig(res),
                           "hosts": dds.ownership.hosts()}), flush=True)
print("MESH_QUERY_OK", flush=True)
"""

# The last process connects, announces it, and then never computes a
# payload: the launcher SIGKILLs it.  Survivors start together, wait out the
# straggler grace, steal its positions through the deterministic re-deal,
# and still give the single-host answer.
DEAD_HOST = CORPUS + r"""
t = init_from_env()
if str(t.host_id) == os.environ["RSP_VICTIM"]:
    t.put("ready/%d" % t.host_id, b"1")
    signal.pause()
""" + MESH_QUERY.partition("t = init_from_env()\n")[2]


def _mesh(source: str, n: int, *, grace: float, kill_last: bool = False):
    server = serve_store()
    env = {"RSP_COORDINATOR": f"127.0.0.1:{server.port}", "RSP_GRACE": str(grace)}
    kill_when = None
    if kill_last:
        env["RSP_VICTIM"] = str(n - 1)

        def kill_when(rank):
            return rank == n - 1 and server.check([f"ready/{rank}"])
    children = run_children(source, n, env=env, kill_when=kill_when)
    del server
    return children


@pytest.mark.parametrize("num_processes", [2, 4])
def test_mesh_query_bit_identical(num_processes):
    children = _mesh(MESH_QUERY, num_processes, grace=30.0)
    assert_ok(children, "MESH_QUERY_OK")
    sigs = [marked(c, "SIG ") for c in children]
    assert len({s["single"] for s in sigs}) == 1
    assert all(s["mesh"] == s["single"] for s in sigs)
    assert all(s["hosts"] == list(range(num_processes)) for s in sigs)


def test_mesh_query_survives_killed_host():
    # a longer grace than the smoke's 2 s: under a loaded test run the
    # survivor running late must not be taken for dead as well
    children = _mesh(DEAD_HOST, 3, grace=5.0, kill_last=True)
    assert children[2].killed, children[2].describe()
    assert_ok(children, "MESH_QUERY_OK")
    sigs = [marked(c, "SIG ") for c in children[:2]]
    assert sigs[0] == sigs[1]
    assert all(s["mesh"] == s["single"] and s["hosts"] == [0, 1] for s in sigs)
