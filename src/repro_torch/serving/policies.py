"""Non-FCFS scheduling policies: priority with aging (optionally
preemptive) and deficit-round-robin fairness across client ids.

A copy of the JAX package's ``serving/policies.py``.  Both subclass
``FCFSScheduler`` purely for its paged planning machinery (page budgeting,
prefix lookup, COW, eviction, rollback) and override only the
queue-discipline hooks, so every allocator and prefix-cache invariant the
base keeps carries over unchanged.  ``PriorityScheduler`` (with
``preemption=True``) bounds high-priority TTFT by evicting low-priority
slots; its aging term bounds low-priority starvation.  ``FairScheduler``
divides service evenly across clients whoever floods the queue.

Invariants the policies keep (as in the JAX package):

- resource conservation: every admission's pages and slab are released
  through exactly one of ``on_finish`` / ``on_preempt``; a victim chosen by
  ``plan_preemptions`` is always an active admission, so no release can
  fire twice;
- output invariance: policies reorder work, never change it: greedy
  outputs are token-identical across policies and preemption points;
- no ping-pong: preemption is gated on base (not aged) priority, or on a
  ``preempt_after``-quantum deficit gap, and a victim's aging credit resets
  on requeue, so a victim cannot at once re-evict its evictor;
- free slots first: ``_admissible_without_eviction`` (pages, slabs and the
  evictable cache included) suppresses preemption whenever a free slot
  could serve the starved request.
"""
from __future__ import annotations

import collections
from typing import List

from repro_torch.serving.scheduler import Admission, FCFSScheduler


class PriorityScheduler(FCFSScheduler):
    """Highest-effective-priority admission with aging and preemption.

    Each request carries an integer ``priority`` (higher = more urgent;
    absent = 0).  Admission picks the pending request with the largest
    *effective* priority ``priority + aging_rate * rounds_waited`` (ties:
    submission order), so any positive ``aging_rate`` guarantees a
    low-priority request eventually outranks a continuous high-priority
    stream — no starvation.

    With ``preemption=True`` the scheduler also evicts running slots: when
    a pending request's *base* priority strictly exceeds a running
    request's base priority and no free slot (with enough free/evictable
    pages — a free slot whose pool is exhausted doesn't count) would serve
    it, the lowest-priority (most recently admitted) victim is preempted.
    Base priorities — not aged ones — gate preemption, so an aged
    low-priority request can win a *free* slot but never steal a busy one;
    and a preempted victim's aging credit resets, so it re-queues *below*
    the urgent request that displaced it instead of out-ranking it at the
    next admission and ping-ponging the slot every tick.
    """

    def __init__(self, *, aging_rate: float = 0.125, preemption: bool = False,
                 **kw):
        super().__init__(**kw)
        assert aging_rate >= 0, aging_rate
        self.aging_rate = aging_rate
        self.preemption = preemption
        self._seq = 0

    @staticmethod
    def _base(req) -> int:
        return getattr(req, "priority", 0)

    def _eff(self, req) -> float:
        return self._base(req) + \
            self.aging_rate * (self._round - req._sched_round)

    def _enqueue(self, req) -> None:
        req._sched_seq = self._seq
        self._seq += 1
        if not hasattr(req, "_sched_round"):
            req._sched_round = self._round
        self.queue.append(req)

    def _select_next(self):
        if not self.queue:
            return None
        # single linear pass (deque index access would make this O(n^2))
        best, _ = max(enumerate(self.queue),
                      key=lambda t: (self._eff(t[1]), -t[1]._sched_seq))
        req = self.queue[best]
        del self.queue[best]
        return req

    def _put_back(self, req) -> None:
        # selection re-sorts every round, so position is irrelevant; the
        # blocked request keeps outranking the queue until it fits
        self.queue.append(req)

    def _requeue_preempted(self, req) -> None:
        # the victim's aging credit resets: an aged-up victim must not
        # immediately out-rank the urgent request that displaced it (that
        # would ping-pong the slot every tick and starve both)
        req._sched_round = self._round
        self.queue.append(req)

    def plan_preemptions(self, active: List[Admission],
                         n_free: int) -> List[Admission]:
        if not self.preemption or not self.queue:
            return []
        pend = sorted(self.queue,
                      key=lambda r: (-self._eff(r), r._sched_seq))
        # victim order: lowest base priority first; among equals the most
        # recently admitted (least sunk prefill/decode work)
        pool = sorted(active, key=lambda a: (self._base(a.req), -a.seq))
        victims, spare = [], n_free
        for req in pend:
            if not pool and spare <= 0:
                break           # nothing left to grant, stop scanning
            if spare > 0 and self._admissible_without_eviction(req):
                spare -= 1      # a free slot serves it without eviction
            elif pool and self._base(pool[0].req) < self._base(req):
                victims.append(pool.pop(0))
            # else: this request can't preempt anyone, but one further down
            # the effective-priority order (e.g. fresh-high behind aged-low)
            # still might — keep scanning
        return victims


class FairScheduler(FCFSScheduler):
    """Deficit round-robin across client ids.

    Each request carries a ``client_id`` (absent = 0); requests queue FIFO
    per client.  Clients are visited round-robin; a visit tops the client's
    deficit counter up by ``quantum`` tokens, and the head request is
    admitted once the deficit covers its cost (prompt + max_new_tokens
    tokens — its whole KV footprint).  Service therefore converges to an
    equal token share per client: a client flooding the queue only
    lengthens its own backlog, and a client with large requests is charged
    proportionally more rounds per admission.

    With ``preemption=True`` DRR also preempts: plain DRR only rotates at
    admission time, so once a client's long-running requests occupy every
    slot, a newly arrived client waits out their full decode — unbounded
    starvation.  A backlogged client with no running slot (and no free
    slot that could serve it) instead accrues ``quantum`` deficit per tick,
    and once its deficit exceeds a running client's by
    ``preempt_after * quantum`` it evicts that client's most recently
    admitted slot (least sunk work; preempted KV is donated to the prefix
    cache, so nothing is recomputed on resume).  Admission then charges
    the starved client's cost as usual, dropping it back below the
    threshold — slots time-slice between contending clients at
    ``preempt_after``-quantum granularity instead of ping-ponging."""

    def __init__(self, *, quantum: int = 64, preemption: bool = False,
                 preempt_after: int = 4, **kw):
        super().__init__(**kw)
        assert quantum > 0, quantum
        assert preempt_after > 0, preempt_after
        self.quantum = quantum
        self.preemption = preemption
        self.preempt_after = preempt_after
        self._queues: dict = {}                       # client -> FIFO
        self._deficit: dict = {}
        self._rr: collections.deque = collections.deque()  # visit order

    @staticmethod
    def _client(req):
        return getattr(req, "client_id", 0)

    @staticmethod
    def _cost(req) -> int:
        return len(req.prompt) + req.max_new_tokens

    def _ensure(self, c) -> None:
        if c not in self._queues:
            self._queues[c] = collections.deque()
            self._deficit[c] = 0
            self._rr.append(c)

    def _enqueue(self, req) -> None:
        c = self._client(req)
        self._ensure(c)
        self._queues[c].append(req)

    def has_pending(self) -> bool:
        return any(self._queues.values())

    def pending_requests(self) -> List:
        return [r for q in self._queues.values() for r in q]

    def plan_preemptions(self, active: List[Admission],
                         n_free: int) -> List[Admission]:
        """Preemptive DRR (see class docstring): starved clients accrue
        deficit per tick and evict a running client once the gap exceeds
        ``preempt_after * quantum``."""
        if not self.preemption or not self.has_pending():
            return []
        running: dict = {}                 # client -> its active admissions
        for a in active:
            running.setdefault(self._client(a.req), []).append(a)
        victims, spare = [], n_free
        for c in sorted((c for c, q in self._queues.items()
                         if q and c not in running),
                        key=lambda c: -self._deficit.get(c, 0)):
            if spare > 0 and self._admissible_without_eviction(
                    self._queues[c][0]):
                spare -= 1                 # a free slot serves it; no ev.
                continue
            # starvation clock: only waiting clients that nothing (free
            # slot or running share) currently serves accrue credit
            self._deficit[c] += self.quantum
            # victim client: the most-served (lowest-deficit) running
            # client; within it, the most recent admission (least sunk
            # prefill/decode work, mirroring the priority policy)
            pool = sorted(
                ((self._deficit.get(rc, 0), rc) for rc, adms in
                 running.items() if adms),
                key=lambda t: t[0])
            if not pool:
                break
            vdef, vc = pool[0]
            if self._deficit[c] - vdef <= self.preempt_after * self.quantum:
                continue
            victim = max(running[vc], key=lambda a: a.seq)
            running[vc].remove(victim)
            victims.append(victim)
        return victims

    def _select_next(self):
        if not self.has_pending():
            return None
        # DRR: rotate through clients topping up deficits; terminates
        # because every full rotation credits each backlogged client
        while True:
            c = self._rr[0]
            q = self._queues[c]
            if not q:
                self._deficit[c] = 0    # classic DRR: idle clients reset
                self._rr.rotate(-1)
                continue
            if self._deficit[c] < self._cost(q[0]):
                self._deficit[c] += self.quantum
                self._rr.rotate(-1)
                continue
            req = q.popleft()
            self._deficit[c] -= self._cost(req)
            return req

    def _put_back(self, req) -> None:
        c = self._client(req)
        self._ensure(c)
        self._queues[c].appendleft(req)
        self._deficit[c] += self._cost(req)   # blocked, not served: refund

    def _requeue_preempted(self, req) -> None:
        # resumes at its client's head; the service it consumed stays spent
        c = self._client(req)
        self._ensure(c)
        self._queues[c].appendleft(req)

    def _clear_queue(self) -> None:
        # drain-time takeover: clients keep their deficit/rotation state
        # (an idle client's deficit resets at the next _select_next visit)
        for q in self._queues.values():
            q.clear()
