"""Recovery planning for a replica that dies mid-flight.

A copy of ``plan_recovery`` and ``RecoveryReport`` from the JAX package's
``runtime/ft.py`` (its training supervisor and heartbeat belong to the
training slice, ROADMAP Queue 1 item 13).  When a replica dies without a
drain its device state (page pools, allocator refcounts) is presumed lost,
but every request's prompt and emitted tokens live on the host in its
``Request``.  ``plan_recovery`` orders the dead replica's orphans
deterministically: active slots by admission sequence, then the queue in
queue order, so ``ServingEngine.kill_replica`` re-admits them elsewhere as
re-prefills and recovery replays exactly under a fixed fault schedule.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class RecoveryReport:
    """What ``plan_recovery`` decided for one dead replica: which requests
    were orphaned in flight and which were still queued, in re-admission
    order."""
    replica: int
    active_rids: List[int] = field(default_factory=list)
    queued_rids: List[int] = field(default_factory=list)

    @property
    def n_orphans(self) -> int:
        return len(self.active_rids) + len(self.queued_rids)


def plan_recovery(replica: int, active_admissions, queued_requests):
    """-> (requests, RecoveryReport) for a replica that died mid-flight.

    ``active_admissions`` are the replica's in-flight admissions (objects
    with ``.seq`` and ``.req``); ``queued_requests`` its not yet admitted
    requests.  Active requests come first, oldest admission first (they
    have emitted the most tokens and re-prefill the most state), then the
    queue in its own order.  The order is a function of the dead replica's
    state alone, never of dict or set iteration."""
    active = sorted(active_admissions, key=lambda adm: adm.seq)
    requests = [adm.req for adm in active] + list(queued_requests)
    report = RecoveryReport(
        replica=replica,
        active_rids=[adm.req.rid for adm in active],
        queued_rids=[req.rid for req in queued_requests])
    return requests, report
