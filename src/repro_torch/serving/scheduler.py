"""Scheduling policy for the serving engine (policy/mechanism split).

A copy of the JAX package's ``serving/scheduler.py``: the ``Scheduler``
interface, ``Admission`` records and
``FCFSScheduler``, the stock policy and the machinery base: page and slab
budgeting, radix prefix lookup, copy-on-write planning, cache eviction,
rollback and page release.  Subclasses override only the queue-discipline
hooks (``_enqueue`` / ``_select_next`` / ``_put_back`` /
``_requeue_preempted`` / ``_clear_queue``) plus, for preemptive policies,
``plan_preemptions`` (``serving.policies``).  Without a page allocator
(``allocator=None``, the contiguous engine) it only orders the queue.  The
engine executes admissions (COW page copies, chunked prefill from the first
uncached token) and reports lifecycle events back (``on_cow_done``,
``on_prefill_complete``, ``on_cross_written``, ``on_finish``,
``on_preempt``, ``on_spec_trim``).  A replicated engine builds one
scheduler per replica, each over its replica's allocator and caches, and
hands it that replica's ``ReplicaStats`` (``replica_stats``): the
per-replica counters move at the same sites as the global ones.  Elastic
membership adds the drain-time hooks: ``plan_migration`` (the
destination's admission for a migrating slot), ``on_migrated`` (the
source hands the resident references over and drops the rest) and
``take_queued`` (the queue leaves for re-placement on the survivors).

Disaggregated serving (``disagg=(P, D)``) gives each replica's scheduler
a **role**: a ``prefill`` replica budgets only the resident-prompt page
run (the slot leaves at its first token, so no decode pages are
reserved) and never reserves draft headroom; a ``decode`` replica plans
like ``mixed`` and is fed by ``plan_handoff``, the destination half of a
page handoff, which allocates a fresh run for resident + remaining-decode
tokens.  ``on_handoff_sent`` then moves the ownership at once
(``kvcache.handoff_refs``).  A decode replica's own queue fills only with
preempted requests, re-admitted over the pages their preemption donated.

Beyond attention-only archs, admission is a JOINT all-or-nothing budget:

- **SSM/hybrid**: one recurrent-state slab per request
  (``slab_allocator``); a request is admitted only if pages AND a slab are
  both available, and every rollback returns both.
- **enc-dec**: ``cross_pages_per_req`` pages of encoder cross-KV from the
  same allocator.  A frames-digest hit on the ``CrossKVCache`` shares the
  resident pages (refcount only); a second request with the same frames
  in the same tick shares the pages planned for the first
  (``_pending_cross``: one encode); a miss allocates fresh pages and marks
  the admission ``needs_encode``, so the engine runs the cross-KV write
  step once before the slot's first prefill chunk; ``on_cross_written``
  then publishes the pages for later identical-frame requests.  A miss
  that cannot get its cross pages rolls the whole admission back.

Preemption contract: the engine calls ``plan_preemptions`` each tick and
evicts the returned victims; ``on_preempt`` donates the victim's resident
full pages to the radix prefix cache (so resume re-admits as a prefix hit
and the KV is never recomputed), releases the slot's page refs and slab,
and re-queues the request.  A resumed request's admission plans over its
*effective prompt* (original prompt plus the tokens it already generated).
An SSM arch carries no prefix cache: the engine stashes its slab on the
host instead.

Invariant: leak freedom — every page is free, radix-cached or
    cross-cached, and every slab is free, after ``run()``/``drain()``
    retire all admissions.

Invariant: role budgeting conserves the pool — a prefill-role admission
    holds exactly the resident-prompt page run, and a handoff moves those
    references to freshly allocated destination pages exactly once, so
    per-replica leak freedom survives any interleaving of handoffs and
    preemptions.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.kvcache import handoff_refs, pages_needed


def effective_prompt(req) -> np.ndarray:
    """Tokens a (re-)admission must make resident: the original prompt plus
    everything the request already generated.  For a fresh request this is
    just the prompt; a preempted request re-prefills its own output, which
    the prefix cache turns into a hit on the pages donated at preemption
    (``on_preempt``): reuse, not recompute."""
    out = getattr(req, "out_tokens", None)
    if not out:
        return np.asarray(req.prompt, np.int32)
    return np.concatenate([np.asarray(req.prompt, np.int32),
                           np.asarray(out, np.int32)])


def remaining_new_tokens(req) -> int:
    """Decode budget still owed to ``req`` (shrinks across preemptions, so
    effective_prompt + remaining is the constant submit-time budget)."""
    out = getattr(req, "out_tokens", None)
    return req.max_new_tokens - (len(out) if out else 0)


@dataclass
class Admission:
    """One scheduler decision: place ``req`` into engine slot ``slot``.

    pages: the slot's full block-table page run (None for the contiguous
    engine).  cached_len: prompt tokens already resident through prefix
    sharing; chunked prefill starts at this offset.  cow: the (src, dst)
    page pair the engine must copy before the slot's first write
    (divergence out of a shared partial page).  seq: global admission
    order stamp (preemptive policies pick the victim with the least sunk
    work by it).  slab: the slot's recurrent-state slab id (SSM archs).
    cross_pages: the slot's read-only cross-KV page run (enc-dec archs);
    needs_encode marks a frames-digest miss: the engine must run the
    cross-KV write step before this slot's first prefill chunk.  spec: the run includes draft headroom (+spec_tokens of coverage), so
    the engine may run the verify step on the slot; False means
    speculation was denied at admission (pool pressure) and the slot
    decodes one token per tick."""
    slot: int
    req: object
    pages: Optional[List[int]] = None
    cached_len: int = 0
    cow: Optional[Tuple[int, int]] = None
    seq: int = 0
    slab: Optional[int] = None
    cross_pages: Optional[List[int]] = None
    needs_encode: bool = False
    spec: bool = False


class Scheduler:
    """Policy interface the engine drives.  Implementations own the wait
    queue and (for the paged engine) all allocator and prefix-cache
    traffic."""

    def submit(self, req) -> None:
        raise NotImplementedError

    def has_pending(self) -> bool:
        raise NotImplementedError

    def pending_requests(self) -> List:
        """Queued (not yet admitted) requests, in no particular order."""
        raise NotImplementedError

    def plan(self, free_slots: List[int]) -> List[Admission]:
        """Admissions for this tick; at most one per free slot."""
        raise NotImplementedError

    def plan_preemptions(self, active: List[Admission],
                         n_free: int) -> List[Admission]:
        """Victims to evict this tick (before admission planning).  The
        engine preempts each returned admission's slot; default: none."""
        return []

    def on_cow_done(self, adm: Admission) -> None:
        """The engine copied adm.cow: release the pin on the source."""

    def on_prefill_complete(self, adm: Admission) -> None:
        """adm's prompt is fully resident (cache-insertion hook)."""

    def on_cross_written(self, adm: Admission) -> None:
        """The engine ran adm's cross-KV write: publish the pages."""

    def on_finish(self, adm: Admission) -> None:
        """adm's request retired: release its resources."""

    def on_preempt(self, adm: Admission, resident_tokens) -> None:
        """adm was evicted mid-flight with ``resident_tokens`` computed:
        salvage its pages and re-queue the request."""
        raise NotImplementedError

    def on_spec_trim(self, adm: Admission, keep: int) -> None:
        """The engine stopped speculating on adm's slot: return the draft
        headroom pages past block-table index ``keep``."""

    def plan_handoff(self, slot: int, req,
                     resident_len: int) -> Optional[Admission]:
        """Destination-side admission for an incoming page handoff
        (disaggregated serving); default: refuse, the handoff stays queued
        at the source replica."""
        return None

    def on_handoff_sent(self, adm: Admission, dst_allocator,
                        dst_pages) -> None:
        """adm's resident pages were transferred to another replica: move
        the references and retire the source slot."""
        raise NotImplementedError


class FCFSScheduler(Scheduler):
    """First-come-first-served admission.

    Paged mode adds all-or-nothing budgeting: the head request either gets
    its full page budget (prompt + max_new_tokens) and, for SSM archs, a
    state slab, or the whole queue waits (no mid-flight OOM, no starvation
    by overtaking).  A pure-SSM arch has no KV pool (``kv_pages=False``):
    its page demand is zero and its state lives in the slab.  With a
    ``prefix_cache`` admission maps the longest cached prefix into the
    block table, duplicating a partially shared page copy-on-write, and
    evicts LRU cache runs when the pool cannot cover the remainder.  With
    ``spec_tokens`` > 0 an admission also tries for +spec_tokens of page
    coverage, all or nothing, never evicting; a request denied it
    (``stats.spec_denied``) is still admitted, with ``spec=False``.
    ``role`` is the replica's under disaggregation ("prefill", "decode"),
    else "mixed"."""

    def __init__(self, *, seq_budget: int, allocator=None, page_size: int = 0,
                 prefix_cache=None, stats=None, slab_allocator=None,
                 cross_cache=None, cross_pages_per_req: int = 0,
                 kv_pages: bool = True, spec_tokens: int = 0,
                 role: str = "mixed"):
        if role not in ("mixed", "prefill", "decode"):
            raise ValueError(f"role must be mixed, prefill or decode, got "
                             f"{role!r}")
        self.queue: collections.deque = collections.deque()
        self.seq_budget = seq_budget
        # "prefill" budgets only the resident-prompt page run (the slot
        # hands off at its first token) and reserves no draft headroom;
        # "decode" plans like "mixed" (the router reads the marker)
        self.role = role
        self.allocator = allocator
        self.psz = page_size
        self.prefix_cache = prefix_cache
        self.kv_pages = kv_pages
        self.slab_allocator = slab_allocator      # SSM archs
        self.cross_cache = cross_cache            # enc-dec archs
        self.cross_pages_per_req = cross_pages_per_req
        self.spec_tokens = spec_tokens
        # cross pages planned this tick but not yet written: a second
        # same-frame admission in the same plan() round shares them
        # instead of running a second encode
        self._pending_cross: dict = {}
        self.stats = stats
        self._round = 0      # logical clock: one tick per plan() call
        self._adm_seq = 0    # admission order stamp
        # page demand of the queued backlog, kept at every enqueue and
        # dequeue (submit / admission / put-back / requeue), so the router's
        # load probe is O(1)
        self.backlog_pages = 0
        # the replica's counters (a replicated engine sets them), moved at
        # the same sites as the global stats so the two cannot drift
        self.replica_stats = None

    @property
    def paged(self) -> bool:
        return self.allocator is not None

    # ------------------------------------------------- queue discipline hooks
    def _enqueue(self, req) -> None:
        self.queue.append(req)

    def _select_next(self):
        """Next request to try admitting, or None."""
        return self.queue.popleft() if self.queue else None

    def _put_back(self, req) -> None:
        """The selected request could not be admitted (page pressure): it
        stays head-of-line so nothing overtakes it."""
        self.queue.appendleft(req)

    def _requeue_preempted(self, req) -> None:
        """A preempted request returns to the queue; FCFS resumes it
        first."""
        self.queue.appendleft(req)

    def _clear_queue(self) -> None:
        self.queue.clear()

    # ------------------------------------------------------------- intake
    def submit(self, req) -> None:
        if len(req.prompt) == 0:
            raise RuntimeError(f"request {req.rid} has an empty prompt")
        if self.paged:
            if len(req.prompt) + req.max_new_tokens > self.seq_budget:
                raise RuntimeError(
                    f"request {req.rid} needs {len(req.prompt)} prompt + "
                    f"{req.max_new_tokens} new tokens; the sequence budget "
                    f"is {self.seq_budget}")
            need = self._req_pages(req)
            usable = self.allocator.n_pages - self.allocator.n_reserved
            if need > usable:       # reject now, not mid-run at admission
                raise RuntimeError(
                    f"request {req.rid} needs {need} pages"
                    + (f" (incl. {self.cross_pages_per_req} cross-KV)"
                       if self.cross_pages_per_req else "")
                    + f"; the pool only has {usable} usable")
        elif len(req.prompt) >= self.seq_budget:
            # the contiguous lane needs room past the prompt for decode
            raise RuntimeError(
                f"request {req.rid} prompt ({len(req.prompt)} tokens) "
                f"exceeds the sequence budget {self.seq_budget}")
        self._enqueue(req)
        self.backlog_pages += self._req_pages(req)

    def has_pending(self) -> bool:
        return bool(self.queue)

    def pending_requests(self) -> List:
        return list(self.queue)

    def _req_pages(self, req) -> int:
        """Page demand of one queued request (cross-KV included).  Constant
        while it waits (out_tokens only grow while admitted), so the
        backlog counter's add and subtract stay symmetric across put-backs
        and requeues."""
        if not self.paged:
            return 0
        n = len(effective_prompt(req))
        if self.role != "prefill":      # prefill slots leave at first token
            n += remaining_new_tokens(req)
        return (pages_needed(n, self.psz) if self.kv_pages else 0) \
            + self.cross_pages_per_req

    def _evictable_pages(self) -> int:
        """Pages eviction could eventually reclaim across both caches."""
        n = 0
        if self.prefix_cache is not None:
            n += self.prefix_cache.n_evictable_pages
        if self.cross_cache is not None:
            n += self.cross_cache.n_evictable_pages
        return n

    def _reclaim(self, shortfall: int) -> None:
        """Evict cached runs until ``shortfall`` pages are freed (radix
        prefix leaves first, LRU first: they are rebuildable per request;
        then whole cross-KV entries)."""
        if self.prefix_cache is not None:
            shortfall -= self.prefix_cache.evict(shortfall)
        if shortfall > 0 and self.cross_cache is not None:
            self.cross_cache.evict(shortfall)

    def _admissible_without_eviction(self, req) -> bool:
        """True if a free slot could serve ``req`` right now, pool pages and
        state slabs included.  A free slot whose pool is exhausted must not
        suppress preemption: evicting a victim is what frees the pages (and
        its slab)."""
        if not self.paged:
            return True
        if self.slab_allocator is not None and \
                self.slab_allocator.n_free == 0:
            return False
        return self.allocator.n_free + self._evictable_pages() \
            >= self._req_pages(req)

    # ---------------------------------------------------------- admission
    def plan(self, free_slots: List[int]) -> List[Admission]:
        self._round += 1
        out = []
        for slot in free_slots:
            req = self._select_next()
            if req is None:
                break
            self.backlog_pages -= self._req_pages(req)
            if self.paged:
                adm = self._plan_paged(slot, req)
                if adm is None:     # blocked: wait for reclamation
                    self._put_back(req)
                    self.backlog_pages += self._req_pages(req)
                    break
            else:
                adm = Admission(slot=slot, req=req)
            adm.seq = self._adm_seq
            self._adm_seq += 1
            out.append(adm)
        return out

    def _can_reclaim(self, need: int) -> bool:
        """True if evicting cache runs can cover a ``need``-page
        allocation (free pages + eventually-evictable cached pages)."""
        ev = self._evictable_pages()
        return ev > 0 and self.allocator.n_free + ev >= need

    def _plan_paged(self, slot: int, req) -> Optional[Admission]:
        prompt = effective_prompt(req)
        L = len(prompt)
        horizon = L if self.role == "prefill" \
            else L + remaining_new_tokens(req)
        total = pages_needed(horizon, self.psz) if self.kv_pages else 0
        alloc = self.allocator
        # ---- recurrent-state slab (SSM): all-or-nothing with pages
        slab = None
        if self.slab_allocator is not None:
            slab = self.slab_allocator.alloc()
            if slab is None:        # every slab busy: wait
                return None
        cached_len, run = 0, []
        if self.prefix_cache is not None:
            matched, run = self.prefix_cache.lookup(prompt)
            # always prefill >= 1 token: the final prompt position's logits
            # seed the first decode
            cached_len = min(matched, max(L - 1, 0))
        n_full = cached_len // self.psz
        shared = run[:n_full]
        cow_src = run[n_full] if cached_len % self.psz else None
        # pin the reused pages before eviction (below) can touch them
        alloc.incref(shared)
        if cow_src is not None:
            alloc.incref([cow_src])
        need = total - n_full
        fresh = alloc.alloc(need)
        if fresh is None and self._can_reclaim(need):
            # evict only when it covers the shortfall: a futile eviction
            # would wipe hot prefixes and still leave us blocked
            self._reclaim(need - alloc.n_free)
            fresh = alloc.alloc(need)
        if fresh is None and (shared or cow_src is not None):
            # prefix reuse itself can block admission: the pins make the
            # matched run unevictable, and the leftover need may exceed
            # what eviction can reclaim, forever if no other slot is in
            # flight.  Degrade to a cold prefill: drop the pins (the run
            # becomes evictable), reclaim, take the budget fresh.
            alloc.decref(shared)
            if cow_src is not None:
                alloc.decref([cow_src])
            shared, cow_src, cached_len, n_full = [], None, 0, 0
            need = total
            if alloc.n_free < need and self._can_reclaim(need):
                self._reclaim(need - alloc.n_free)
            fresh = alloc.alloc(need)
        if fresh is None:           # roll the pins back; the head blocks
            alloc.decref(shared)
            if cow_src is not None:
                alloc.decref([cow_src])
            if slab is not None:
                self.slab_allocator.free(slab)
            return None
        # ---- encoder cross-KV (enc-dec): a digest hit shares, a miss
        # encodes
        cross_pages, needs_encode = None, False
        if self.cross_cache is not None:
            key = self.cross_cache.digest(req.frames)
            cross_pages = self.cross_cache.acquire(key)
            if cross_pages is None and key in self._pending_cross:
                # the same frames admitted earlier this tick: its write
                # step runs before any read, so sharing is already safe
                cross_pages = list(self._pending_cross[key])
                alloc.incref(cross_pages)
            if cross_pages is None:
                needs_encode = True
                ncross = self.cross_pages_per_req
                cross_pages = alloc.alloc(ncross)
                if cross_pages is None and self._can_reclaim(ncross):
                    self._reclaim(ncross - alloc.n_free)
                    cross_pages = alloc.alloc(ncross)
                if cross_pages is None:   # joint rollback; the head blocks
                    alloc.decref(shared + fresh)
                    if cow_src is not None:
                        alloc.decref([cow_src])
                    if slab is not None:
                        self.slab_allocator.free(slab)
                    return None
                self._pending_cross[key] = list(cross_pages)
        spec = self._draft_headroom(req, L, total, fresh)
        # count on admission only: a blocked head-of-line request is
        # re-planned every tick and must not inflate the hit rates
        for st in self._counters():
            if self.prefix_cache is not None:
                st.prefix_lookups += 1
                st.prefix_hits += cached_len > 0
            if self.cross_cache is not None:
                st.cross_lookups += 1
                st.cross_hits += not needs_encode
        # fresh[0] sits at block-table index n_full: exactly where the COW
        # copy of the partial page belongs
        cow = (cow_src, fresh[0]) if cow_src is not None else None
        return Admission(slot=slot, req=req, pages=shared + fresh,
                         cached_len=cached_len, cow=cow, slab=slab,
                         cross_pages=cross_pages, needs_encode=needs_encode,
                         spec=spec)

    def _counters(self):
        """The stats blocks a counting site moves: the global and, in a
        replicated engine, the replica's."""
        return [st for st in (self.stats, self.replica_stats)
                if st is not None]

    def _draft_headroom(self, req, L: int, total: int,
                        pages: List[int]) -> bool:
        """Append the speculative headroom (+spec_tokens of coverage past
        ``L`` + the remaining new tokens) to ``pages`` if the pool covers
        it; never evicts (hot resident prefixes outrank draft room), never
        for a prefill-role replica (its slots do not decode).  -> whether
        it was granted."""
        if self.spec_tokens <= 0 or not self.kv_pages or \
                self.role == "prefill":
            return False
        n_max = self.seq_budget // self.psz
        extra = min(pages_needed(L + remaining_new_tokens(req) +
                                 self.spec_tokens, self.psz), n_max) - total
        more = self.allocator.alloc(extra)
        if more is None:
            for st in self._counters():
                st.spec_denied += 1
            return False
        pages.extend(more)
        return True

    # ------------------------------------------------------------- events
    def on_cow_done(self, adm: Admission) -> None:
        self.allocator.decref([adm.cow[0]])

    def on_prefill_complete(self, adm: Admission) -> None:
        if self.prefix_cache is None:
            return
        prompt = effective_prompt(adm.req)
        n_full = len(prompt) // self.psz    # the partial tail stays private
        if n_full:
            self.prefix_cache.insert(prompt[:n_full * self.psz],
                                     adm.pages[:n_full])

    def on_cross_written(self, adm: Admission) -> None:
        """The engine encoded adm's frames and wrote its cross pages:
        publish them for later identical-frame requests (the cache takes
        its own refs) and retire the same-tick pending entry."""
        key = self.cross_cache.digest(adm.req.frames)
        self._pending_cross.pop(key, None)
        self.cross_cache.insert(key, adm.cross_pages)

    def _release(self, adm: Admission) -> None:
        """Drop every resource an admission holds (pages, slab, cross
        pages)."""
        self.allocator.decref(adm.pages)
        if adm.slab is not None:
            self.slab_allocator.free(adm.slab)
        if adm.cross_pages is not None:
            self.allocator.decref(adm.cross_pages)

    def on_finish(self, adm: Admission) -> None:
        if self.paged:
            self._release(adm)

    def on_spec_trim(self, adm: Admission, keep: int) -> None:
        """Return the headroom pages past block-table index ``keep``.  A
        tail page may be shared with the prefix cache by the time the trim
        runs (a preemption donated it, or an identical prompt was
        inserted), so this drops the slot's reference per page
        (``allocator.trim``), never assumes it was the only one."""
        self.allocator.trim(adm.pages[keep:])
        del adm.pages[keep:]
        adm.spec = False

    def on_preempt(self, adm: Admission, resident_tokens) -> None:
        """Salvage an evicted slot: donate its resident *full* pages to the
        prefix cache (resume finds them as a prefix hit: the victim's KV is
        reused, never recomputed), drop the slot's page refs, slab and
        cross-KV refs (SSM state travels through the engine's host stash
        instead; cross pages usually stay resident in the cross-KV cache),
        and re-queue the request.  The partial tail page is slot-private KV and
        is freed; resume re-prefills those few tokens."""
        if self.paged:
            if self.prefix_cache is not None:
                n_full = len(resident_tokens) // self.psz
                if n_full:
                    self.prefix_cache.insert(
                        resident_tokens[:n_full * self.psz],
                        adm.pages[:n_full])
            self._release(adm)
        self._requeue_preempted(adm.req)
        self.backlog_pages += self._req_pages(adm.req)

    # ------------------------------------------------------ disaggregation
    def plan_handoff(self, slot: int, req,
                     resident_len: int) -> Optional[Admission]:
        """Destination-side admission for an incoming page handoff: the
        request arrives with ``resident_len`` tokens of KV computed on the
        source replica, so this allocates a fresh run for resident +
        remaining-decode tokens (the transfer step fills the resident
        prefix; ``on_handoff_sent`` moves the references).  All or nothing
        like ``_plan_paged``: None leaves the handoff queued at the source.
        Draft headroom is budgeted as at a cold admission."""
        total = pages_needed(resident_len + remaining_new_tokens(req),
                             self.psz)
        alloc = self.allocator
        fresh = alloc.alloc(total)
        if fresh is None and self._can_reclaim(total):
            self._reclaim(total - alloc.n_free)
            fresh = alloc.alloc(total)
        if fresh is None:
            return None
        spec = self._draft_headroom(req, resident_len, total, fresh)
        adm = Admission(slot=slot, req=req, pages=fresh,
                        cached_len=resident_len, spec=spec)
        adm.seq = self._adm_seq
        self._adm_seq += 1
        return adm

    def on_handoff_sent(self, adm: Admission, dst_allocator,
                        dst_pages) -> None:
        """The engine transferred adm's resident pages to another replica:
        move the references at once (the source refs drop exactly once;
        pages the radix cache shares stay resident here).  A prefill
        admission holds no slab and no cross pages (disaggregation serves
        attention-only archs), so its pages are its whole estate."""
        handoff_refs(self.allocator, adm.pages, dst_allocator, dst_pages)

    # ------------------------------------------------- elastic membership
    def plan_migration(self, slot: int, req,
                       resident_len: int) -> Optional[Admission]:
        """Destination-side admission for a drain-time slot migration.
        Unlike ``plan_handoff`` (whose source is a finished prefill), a
        migrating slot may still be mid-prefill, so this budgets the full
        cold-admission horizon, ``len(effective_prompt) +
        remaining_new_tokens`` (the constant submit-time budget), which
        always covers the resident pages.  All or nothing: None makes the
        engine fall back to preempt-and-requeue."""
        L = len(effective_prompt(req))
        total = pages_needed(L + remaining_new_tokens(req), self.psz)
        alloc = self.allocator
        fresh = alloc.alloc(total)
        if fresh is None and self._can_reclaim(total):
            self._reclaim(total - alloc.n_free)
            fresh = alloc.alloc(total)
        if fresh is None:
            return None
        spec = self._draft_headroom(req, L, total, fresh)
        adm = Admission(slot=slot, req=req, pages=fresh,
                        cached_len=resident_len, spec=spec)
        adm.seq = self._adm_seq
        self._adm_seq += 1
        return adm

    def on_migrated(self, adm: Admission, k: int, dst_allocator,
                    dst_pages) -> None:
        """The engine transferred adm's first ``k`` (resident) pages to
        another replica: hand exactly those references over at once, then
        drop the unfilled horizon tail.  The tail goes through ``decref``,
        not ``free``: a preemption elsewhere may have donated overlapping
        pages to the radix cache by now."""
        if k:
            handoff_refs(self.allocator, adm.pages[:k], dst_allocator,
                         dst_pages)
        self.allocator.decref(adm.pages[k:])
        if adm.cross_pages is not None:
            self.allocator.decref(adm.cross_pages)

    def take_queued(self) -> List:
        """Drain-time queue takeover: every queued (not yet admitted)
        request leaves this scheduler for re-placement elsewhere; the
        backlog counter returns to zero with them."""
        out = self.pending_requests()
        for req in out:
            self.backlog_pages -= self._req_pages(req)
        self._clear_queue()
        return out
