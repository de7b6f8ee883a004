"""Straggler-aware RSP block scheduling (lease-based work stealing).

Because every RSP block is statistically exchangeable with every other
(Definition 3), the scheduler may re-assign blocks freely: a straggling host
loses its unstarted leases to faster hosts with zero statistical penalty --
the final set of processed blocks is still a uniform block-level sample.
The paper (Sec. 7) anticipates exactly this: "this sampling process can be
refined to select blocks depending on the availability of nodes".

``simulate`` is a deterministic event simulation of the schedule;
``LeaseScheduler`` is the runtime object the distributed query drives.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Sequence


@dataclasses.dataclass
class LeaseScheduler:
    """Blocks are leased in small windows; hosts request more when done."""

    block_ids: list[int]
    lease_window: int = 2

    def __post_init__(self):
        self._queue = list(self.block_ids)[::-1]  # pop from end
        self._leases: dict[int, list[int]] = {}
        self._done: set[int] = set()

    @classmethod
    def from_assignment(
        cls, assignment: dict[int, list[int]], *, lease_window: int = 2
    ) -> "LeaseScheduler":
        """Seed the ledger from a block-ownership deal: every block starts
        leased to its owner and the queue starts empty.  This is the shape a
        distributed query uses -- blocks flow back into the queue only when
        ``fail_host`` declares an owner dead, and ``redeal`` re-grants them
        deterministically to the survivors."""
        sched = cls(
            [b for h in sorted(assignment) for b in assignment[h]],
            lease_window=lease_window,
        )
        sched._queue = []
        sched._leases = {int(h): list(blocks) for h, blocks in assignment.items()}
        return sched

    def request(self, host: int) -> list[int]:
        grant = []
        while self._queue and len(grant) < self.lease_window:
            grant.append(self._queue.pop())
        self._leases.setdefault(host, []).extend(grant)
        return grant

    def complete(self, host: int, block_id: int) -> None:
        """Mark a block done.  Tolerant of completion by a non-leaseholder
        (a steal race produced a duplicate, identical result): the block is
        recorded done either way and removed from wherever it is leased."""
        leases = self._leases.setdefault(host, [])
        if block_id in leases:
            leases.remove(block_id)
        self._done.add(block_id)

    def steal_from(self, slow_host: int) -> list[int]:
        """Return a slow host's *unstarted* leases to the queue."""
        stolen = [b for b in self._leases.get(slow_host, []) if b not in self._done]
        self._leases[slow_host] = []
        self._queue.extend(stolen[::-1])
        return stolen

    def fail_host(self, host: int) -> list[int]:
        """Declare a host dead: all its unfinished leases go back to the
        queue (identical mechanics to stealing -- a dead host is just a
        straggler that never recovers)."""
        return self.steal_from(host)

    def redeal(self, survivors: Sequence[int]) -> dict[int, list[int]]:
        """Drain the queue round-robin onto the sorted survivors.

        Deterministic: any host computing this from the same failure set
        derives the identical grant map, so distributed peers never need to
        negotiate who takes which orphaned block (and duplicate grants from
        skewed failure *timing* are harmless -- payloads are deterministic).
        """
        survivors = sorted(set(int(h) for h in survivors))
        if not survivors:
            raise ValueError("redeal needs at least one survivor")
        queued = self._queue[::-1]  # FIFO view
        self._queue = []
        grants: dict[int, list[int]] = {h: [] for h in survivors}
        for i, b in enumerate(queued):
            h = survivors[i % len(survivors)]
            grants[h].append(b)
            self._leases.setdefault(h, []).append(b)
        return grants

    @property
    def all_done(self) -> bool:
        return len(self._done) == len(self.block_ids) and not self._queue

    @property
    def done_blocks(self) -> set[int]:
        return set(self._done)


def simulate(
    num_blocks: int,
    host_speeds: Sequence[float],
    *,
    lease_window: int = 2,
    steal: bool = True,
    steal_threshold: float = 2.0,
    fail_at: dict[int, float] | None = None,
) -> dict:
    """Event simulation: returns {makespan, per_host_blocks, stolen,
    completed, dead_hosts}.

    ``host_speeds[h]`` = blocks/time-unit.  With ``steal=False`` this is the
    static round-robin deal (the paper's naive batch assignment).
    ``fail_at[h] = t`` kills host h at time t: its in-flight block never
    finishes, its unfinished leases flow back to the queue, and idle
    survivors wake to drain them -- as long as one host survives, every
    block still completes exactly once.
    """
    H = len(host_speeds)
    fail_at = {int(h): float(t) for h, t in (fail_at or {}).items()}
    sched = LeaseScheduler(list(range(num_blocks)), lease_window=lease_window)
    per_host: dict[int, list[int]] = {h: [] for h in range(H)}
    stolen_total = 0

    if not steal and not fail_at:
        # static deal: host h gets blocks h, h+H, ... processes sequentially
        makespan = 0.0
        for h in range(H):
            mine = list(range(h, num_blocks, H))
            per_host[h] = mine
            makespan = max(makespan, len(mine) / host_speeds[h])
        return {
            "makespan": makespan,
            "per_host_blocks": per_host,
            "stolen": 0,
            "completed": num_blocks,
            "dead_hosts": [],
        }

    # dynamic leases: (time, kind, host, block) with kind 0=fail, 1=finish
    now = 0.0
    events: list[tuple[float, int, int, int]] = []
    active: dict[int, int] = {}
    dead: set[int] = set()

    def start_next(h: int, t: float) -> None:
        if h in dead:
            return
        mine = sched._leases.get(h, [])
        running = active.get(h)
        for b in mine:
            if b != running and b not in sched._done:
                active[h] = b
                heapq.heappush(events, (t + 1.0 / host_speeds[h], 1, h, b))
                return
        grant = sched.request(h)
        if grant:
            active[h] = grant[0]
            heapq.heappush(events, (t + 1.0 / host_speeds[h], 1, h, grant[0]))
        else:
            active.pop(h, None)

    for h, t_fail in fail_at.items():
        heapq.heappush(events, (t_fail, 0, h, -1))
    for h in range(H):
        sched.request(h)
        start_next(h, 0.0)

    mean_speed = sum(host_speeds) / H
    while events:
        now, kind, h, b = heapq.heappop(events)
        if h in dead:
            continue
        if kind == 0:
            dead.add(h)
            active.pop(h, None)
            sched.fail_host(h)  # unfinished leases (incl. in-flight) requeue
            for s in range(H):
                if s not in dead and s not in active:
                    start_next(s, now)
            continue
        if b in sched._done:
            continue
        sched.complete(h, b)
        per_host[h].append(b)
        # steal unstarted leases from live hosts much slower than the mean
        if sched._queue == [] and steal:
            for s in range(H):
                if s != h and s not in dead and host_speeds[s] < mean_speed / steal_threshold:
                    pending = [x for x in sched._leases.get(s, []) if x != active.get(s)]
                    for blk in pending:
                        sched._leases[s].remove(blk)
                        sched._queue.append(blk)
                        stolen_total += 1
        start_next(h, now)

    return {
        "makespan": now,
        "per_host_blocks": per_host,
        "stolen": stolen_total,
        "completed": len(sched._done),
        "dead_hosts": sorted(dead),
    }
