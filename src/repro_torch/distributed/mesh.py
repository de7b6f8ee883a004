"""``repro_torch.distributed.mesh`` -- the byte-level coordination plane for
multi-host RSP.

Distributed queries need exactly one communication primitive: *publish a
small byte payload under a key, and let every host poll for keys it is
waiting on*.  This module puts that behind a tiny :class:`Transport`
protocol, so the query layer never touches the store underneath, and
provides two implementations:

* :class:`TCPStoreTransport` -- a client of a ``torch.distributed.TCPStore``
  key-value server.  Real multi-process meshes; see :func:`init_from_env`
  for the ``RSP_COORDINATOR`` bootstrap.  The *launcher* hosts the server
  (:func:`serve_store`) and every worker connects to it as a client, so no
  worker's death takes the store down with it: a survivor of a killed host
  keeps reading and publishing.  (A mesh whose store lives in one of its
  workers loses every peer's coordination when that worker goes.)
* :class:`LocalTransport` -- ``LocalTransport.group(n)`` returns n transports
  over one shared in-memory store.  ``kill_after_puts(k)`` arms deterministic
  fault injection: the k-th subsequent publish raises
  :class:`HostKilledError`, emulating a host dying mid-query.

Liveness does not rest on the wall clock alone: a host that works on a
query runs a :class:`Heartbeat`, a thread that advances a counter of its
own (``Transport.beat``) every ``period`` seconds.  A peer waiting for that
host's payload restarts its grace whenever the counter moves, so a host
that is alive but late (a slow payload, a busy interpreter lock) is never
taken for dead, while a dead host's counter stops and it is stolen from
after one grace.
"""

from __future__ import annotations

import datetime
import os
import threading
import time
from typing import Callable, Protocol, runtime_checkable


class TransportError(RuntimeError):
    """A transport operation failed (connection lost, duplicate key, ...)."""


class HostKilledError(TransportError):
    """Raised by a :class:`LocalTransport` whose host was fault-injected dead."""


@runtime_checkable
class Transport(Protocol):
    """Minimal mesh coordination surface: identity + a shared KV store."""

    @property
    def host_id(self) -> int: ...

    @property
    def num_hosts(self) -> int: ...

    def put(self, key: str, value: bytes) -> None: ...

    def get(self, key: str, timeout: float = 0.0) -> bytes | None: ...

    def poll(self, prefix: str) -> dict[str, bytes]: ...

    def beat(self, key: str) -> None:
        """Advance the counter at ``key`` by one.  ``get(key)`` reads it as
        the decimal count; beats are not publishes (a counter is re-written,
        a published key is not)."""
        ...


class Heartbeat:
    """A thread that calls ``transport.beat(key)`` at once and then every
    ``period`` seconds until :meth:`stop`.

    A transport error ends the beating: a killed host
    (:class:`HostKilledError`) or a lost store makes the counter stop,
    which is what its peers read as death."""

    def __init__(self, transport: "Transport", key: str, period: float):
        if period <= 0:
            raise ValueError("period must be > 0")
        self._transport = transport
        self._key = key
        self._period = float(period)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"rsp-heartbeat-{key}", daemon=True
        )

    def start(self) -> "Heartbeat":
        self._thread.start()
        return self

    def _run(self) -> None:
        while True:
            try:
                self._transport.beat(self._key)
            except TransportError:
                return
            if self._stop.wait(self._period):
                return

    def stop(self) -> None:
        """Stop beating and join the thread (idempotent)."""
        self._stop.set()
        self._thread.join()


# ---------------------------------------------------------------------------
# In-process emulation
# ---------------------------------------------------------------------------

class _LocalStore:
    """Shared dict + condition variable behind a LocalTransport group."""

    def __init__(self):
        self._kv: dict[str, bytes] = {}
        self._cond = threading.Condition()

    def put(self, key: str, value: bytes) -> None:
        with self._cond:
            self._kv[key] = bytes(value)
            self._cond.notify_all()

    def get(self, key: str, timeout: float) -> bytes | None:
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                v = self._kv.get(key)
                if v is not None:
                    return v
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._cond.wait(remaining)

    def poll(self, prefix: str) -> dict[str, bytes]:
        with self._cond:
            return {k: v for k, v in self._kv.items() if k.startswith(prefix)}

    def add(self, key: str, amount: int) -> None:
        with self._cond:
            self._kv[key] = str(int(self._kv.get(key, b"0")) + amount).encode()
            self._cond.notify_all()


class LocalTransport:
    """One emulated host of an in-process mesh (see ``group``).

    All hosts share one :class:`_LocalStore`; each host runs on its own
    thread (``run_local_hosts``).  Fault injection: ``kill_after_puts(k)``
    makes the k-th subsequent ``put`` (and every transport call after it)
    raise :class:`HostKilledError` -- from the peers' point of view the host
    simply stops publishing, exactly like a crashed process.  Beats do not
    count as publishes, and a killed host's ``beat`` raises too, so its
    heartbeat stops with it.
    """

    def __init__(self, store: _LocalStore, host_id: int, num_hosts: int):
        self._store = store
        self._host_id = int(host_id)
        self._num_hosts = int(num_hosts)
        self._kill_after: int | None = None
        self._puts = 0
        self._dead = False

    @classmethod
    def group(cls, num_hosts: int) -> list["LocalTransport"]:
        """``num_hosts`` transports over one shared in-memory store."""
        if num_hosts < 1:
            raise ValueError("num_hosts must be >= 1")
        store = _LocalStore()
        return [cls(store, h, num_hosts) for h in range(num_hosts)]

    @property
    def host_id(self) -> int:
        return self._host_id

    @property
    def num_hosts(self) -> int:
        return self._num_hosts

    def kill_after_puts(self, k: int) -> None:
        """Arm fault injection: die on the k-th subsequent publish."""
        self._kill_after = int(k)

    def _check_alive(self) -> None:
        if self._dead:
            raise HostKilledError(f"host {self._host_id} was killed")

    def put(self, key: str, value: bytes) -> None:
        self._check_alive()
        if self._kill_after is not None and self._puts >= self._kill_after:
            self._dead = True
            raise HostKilledError(
                f"host {self._host_id} killed after {self._puts} publishes"
            )
        self._puts += 1
        self._store.put(key, value)

    def get(self, key: str, timeout: float = 0.0) -> bytes | None:
        self._check_alive()
        return self._store.get(key, timeout)

    def poll(self, prefix: str) -> dict[str, bytes]:
        self._check_alive()
        return self._store.poll(prefix)

    def beat(self, key: str) -> None:
        self._check_alive()
        self._store.add(key, 1)


def run_local_hosts(
    transports: list[LocalTransport], fn: Callable[[LocalTransport], object]
) -> list[object]:
    """Run ``fn(transport)`` for every host on its own thread.

    Returns one result per host, ``None`` for hosts that died via fault
    injection (:class:`HostKilledError`).  Any *other* exception from a host
    is re-raised in the caller after all threads join -- a broken host must
    fail the caller, not vanish into a thread.
    """
    results: list[object] = [None] * len(transports)
    errors: list[BaseException] = []

    def run(i: int, t: LocalTransport) -> None:
        try:
            results[i] = fn(t)
        except HostKilledError:
            pass  # injected death: the host's silence is the point
        except BaseException as e:  # noqa: BLE001 -- surface to the caller
            errors.append(e)

    threads = [
        threading.Thread(target=run, args=(i, t), name=f"rsp-host-{i}")
        for i, t in enumerate(transports)
    ]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    return results


# ---------------------------------------------------------------------------
# Real multi-process meshes (torch.distributed.TCPStore)
# ---------------------------------------------------------------------------

INDEX = "_keys"          # per-directory key index (TCPStore cannot list a prefix)
CHECK_INTERVAL = 0.002   # seconds between key checks while a get waits


def _directory(key: str) -> str:
    """The directory part of ``key`` (``"a/b/c"`` -> ``"a/b"``; ``""`` for a
    key without a slash)."""
    return key.rpartition("/")[0]


def _index_key(directory: str) -> str:
    return f"{directory}/{INDEX}" if directory else INDEX


def serve_store(host: str = "127.0.0.1", port: int = 0):
    """Host a ``TCPStore`` server for a mesh and return it (``.port`` is the
    bound port; ``port=0`` binds a free one).  The launcher keeps the
    returned object alive for as long as its workers run: the server lives
    in the launcher's process, so a worker that dies leaves it serving."""
    from torch.distributed import TCPStore

    return TCPStore(host, port, None, True, wait_for_workers=False,
                    timeout=datetime.timedelta(seconds=60))


class TCPStoreTransport:
    """KV transport over a ``torch.distributed.TCPStore`` client.

    The three store operations the query protocol needs map as follows:

    * ``put`` is ``compare_set(key, "", value)``: the first publish wins and
      a duplicate publish (two hosts stealing the same straggler position
      compute identical bytes) changes nothing.  Every put also appends the
      key to its directory's index (``"<dir>/_keys"``), since a
      ``TCPStore`` cannot list keys by prefix.
    * ``get(key, timeout)`` checks for the key until it exists or
      ``timeout`` seconds pass, and returns ``None`` on timeout (a store
      ``wait`` would raise and log instead).
    * ``poll(prefix)`` reads the index of the prefix's directory and returns
      the published keys under ``prefix`` in that directory (keys in deeper
      directories are not listed).
    * ``beat(key)`` is the store's atomic ``add(key, 1)``: a counter cannot
      be a compare-set key, whose first value would stay.  Beat keys are
      not indexed.

    Errors of the store itself (a lost connection) propagate as
    :class:`TransportError`.
    """

    def __init__(self, store, host_id: int, num_hosts: int):
        self._store = store
        self._host_id = int(host_id)
        self._num_hosts = int(num_hosts)

    @classmethod
    def connect(cls, address: str, host_id: int, num_hosts: int, *,
                timeout: float = 60.0) -> "TCPStoreTransport":
        """A client of the store server at ``address`` (``host:port``)."""
        from torch.distributed import TCPStore

        host, _, port = address.rpartition(":")
        if not host or not port:
            raise ValueError(f"store address must be host:port, got {address!r}")
        try:
            store = TCPStore(host, int(port), None, False,
                             timeout=datetime.timedelta(seconds=timeout))
        except RuntimeError as e:
            raise TransportError(f"cannot reach the store at {address}: {e}") from e
        return cls(store, host_id, num_hosts)

    @property
    def host_id(self) -> int:
        return self._host_id

    @property
    def num_hosts(self) -> int:
        return self._num_hosts

    def put(self, key: str, value: bytes) -> None:
        if key.rpartition("/")[2] == INDEX:
            raise ValueError(f"{INDEX!r} is reserved for the key index")
        try:
            self._store.compare_set(key, b"", bytes(value))
            self._store.append(_index_key(_directory(key)), (key + "\n").encode())
        except RuntimeError as e:
            raise TransportError(f"put({key!r}) failed: {e}") from e

    def get(self, key: str, timeout: float = 0.0) -> bytes | None:
        deadline = time.monotonic() + max(0.0, timeout)
        try:
            while not self._store.check([key]):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                time.sleep(min(CHECK_INTERVAL, remaining))
            return bytes(self._store.get(key))
        except RuntimeError as e:
            raise TransportError(f"get({key!r}) failed: {e}") from e

    def poll(self, prefix: str) -> dict[str, bytes]:
        index = _index_key(_directory(prefix))
        try:
            if not self._store.check([index]):
                return {}
            keys = sorted({k for k in self._store.get(index).decode().split("\n")
                           if k.startswith(prefix)})
            return {k: bytes(self._store.get(k)) for k in keys}
        except RuntimeError as e:
            raise TransportError(f"poll({prefix!r}) failed: {e}") from e

    def beat(self, key: str) -> None:
        try:
            self._store.add(key, 1)
        except RuntimeError as e:
            raise TransportError(f"beat({key!r}) failed: {e}") from e


def init_from_env(env=None) -> TCPStoreTransport | None:
    """Join a real multi-process mesh from the launcher's variables.

    Reads ``RSP_COORDINATOR`` (``host:port`` of the store server the
    launcher hosts with :func:`serve_store`), ``RSP_NUM_PROCESSES`` and
    ``RSP_PROCESS_ID``.  Returns ``None`` when ``RSP_COORDINATOR`` is unset
    (a single-host run), else the connected :class:`TCPStoreTransport`."""
    env = os.environ if env is None else env
    addr = env.get("RSP_COORDINATOR")
    if not addr:
        return None
    return TCPStoreTransport.connect(
        addr, int(env["RSP_PROCESS_ID"]), int(env["RSP_NUM_PROCESSES"])
    )
