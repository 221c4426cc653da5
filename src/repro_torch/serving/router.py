"""Request router for dp>1 serving: pick a replica for every request.

A copy of the JAX package's ``serving/router.py``.

With the page pool sharded over the data axes, each replica serves out of
its own allocator / radix prefix cache / scheduler — state never crosses a
replica boundary.  That makes placement a real decision: a request whose
prefix is resident on replica 1 costs a full re-prefill anywhere else.
The router resolves it with the classic two-level rule:

1. **Prefix affinity** — route to the replica whose radix cache holds the
   longest prefix of the request's effective prompt (so shared system
   prompts, agent scaffolds, and preempted-and-resumed requests land where
   their KV already lives).  Because routing happens at submit, a burst of
   same-prefix requests would otherwise scatter before the first prefill
   ever populates a cache — so affinity also scores against the prompts
   *recently routed* to each replica (their KV is resident or about to
   be).  A match shorter than one page is noise (no page is reusable) and
   falls through.  Ties fall through to rule 2 among the tied replicas.
2. **Least loaded** — otherwise, route to the replica with the lowest page
   load: pages pinned by live slots (minus what eviction could reclaim)
   plus the page demand of its queued backlog.  Ties break on the lowest
   replica index (deterministic routing).

Routing happens once, at submit, and is sticky: preemption donates pages
to the *owning* replica's prefix cache (or stashes SSM state / releases
cross refs) and re-queues on the same replica's scheduler, so resume is
a local hit.  Affinity lookups take no page refs
(``RadixPrefixCache.lookup`` is read-only apart from its LRU clock), so
routing can never pin or leak pages.

Invariant: replica locality — the router is the ONLY component that
    sees all replicas at once.  Everything it routes to — allocator,
    slab allocator, prefix/cross caches, scheduler queues, preemption
    donations — is replica-local, and no page/slab id ever crosses a
    replica boundary; the dp tests assert per-replica leak-freedom
    independently.
Enforced-by: tests/test_torch_replicas.py::test_dp2_matches_jax_and_dp1

Invariant: routing pins nothing — affinity lookups take no page refs
    (``RadixPrefixCache.lookup`` is read-only apart from its LRU clock),
    so routing can never pin or leak pages.
Enforced-by: tests/test_torch_replicas.py::test_router_matches_jax

Invariant: role-aware placement — under disaggregation (``roles`` set)
    fresh requests are admitted only on prefill-role replicas, and
    ``decode_placement`` hands finished page runs only to decode-role
    replicas; neither set is ever empty and a request crosses the
    boundary exactly once, via the page-transfer handoff.
Enforced-by: tests/test_torch_disagg.py::test_disagg_matches_jax_and_dp1

Invariant: no placement onto a draining replica — once
    ``mark_draining`` names a replica, ``route`` and ``decode_placement``
    exclude it even when it momentarily reports the least page load (a
    drain empties it), so admissions racing an active ``scale_to`` land
    on survivors and are never migrated twice.
Enforced-by: tests/test_torch_replicas.py::test_router_matches_jax
"""
from __future__ import annotations

import collections
from typing import List, Optional

from repro_torch.serving.prefix_cache import CrossKVCache, _common_len
from repro_torch.serving.scheduler import effective_prompt


class Router:
    """Replica selector over parallel (scheduler, allocator, prefix-cache)
    triples; ``route`` returns a replica index."""

    def __init__(self, scheds: List, allocators: List,
                 prefix_caches: List[Optional[object]], page_size: int,
                 recent_window: int = 32, cross_caches=None,
                 roles: Optional[List[str]] = None):
        assert len(scheds) == len(allocators) == len(prefix_caches)
        self.scheds = scheds
        self.allocators = allocators
        self.prefix_caches = prefix_caches
        self.cross_caches = cross_caches or [None] * len(scheds)
        self.psz = page_size
        self.n_replicas = len(scheds)
        # disaggregation: per-replica roles ("prefill" / "decode"); None
        # means every replica serves both phases (the interleaved engine)
        self.roles = roles
        if roles is not None:
            assert len(roles) == len(scheds)
            self._admit_set = [r for r, ro in enumerate(roles)
                               if ro == "prefill"]
            assert self._admit_set and len(self._admit_set) < len(scheds)
        else:
            self._admit_set = list(range(self.n_replicas))
        self.affinity_routed = 0       # requests placed by prefix affinity
        self._draining: set = set()    # replicas mid-drain: never place here
        # prompts recently routed per replica: speculative affinity for
        # bursts whose shared prefix hasn't finished prefilling anywhere yet
        self._recent = [collections.deque(maxlen=recent_window)
                        for _ in range(self.n_replicas)]
        # frames digests recently routed per replica (enc-dec): same
        # speculative window for encodes that haven't landed yet
        self._recent_frames = [collections.deque(maxlen=recent_window)
                               for _ in range(self.n_replicas)]

    def page_load(self, r: int) -> int:
        """Replica r's page pressure: pages held that eviction cannot
        reclaim, plus the page demand of its queued backlog.  The backlog
        term is a running counter on the scheduler (O(1), so load doesn't
        rescan a growing queue per submit); the evictable-pages term walks
        the replica's radix tree, bounded by its cached-page count."""
        alloc = self.allocators[r]
        held = alloc.n_pages - alloc.n_reserved - alloc.n_free
        cache = self.prefix_caches[r]
        if cache is not None:
            held -= cache.n_evictable_pages
        return held + self.scheds[r].backlog_pages

    def affinity(self, req) -> List[int]:
        """Per-replica affinity score: the longest cached prefix of the
        request's effective prompt, or the longest common prefix with a
        recently routed prompt (resident-or-soon KV), whichever is
        longer.  Enc-dec requests additionally score a frames-digest hit
        on the replica's cross-KV cache (or its recently routed digests)
        as one full page — landing where the encode already ran turns a
        duplicate encode into a refcount share."""
        prompt = effective_prompt(req)
        toks = [int(t) for t in prompt]
        digest = None
        if getattr(req, "frames", None) is not None and \
                any(c is not None for c in self.cross_caches):
            digest = CrossKVCache.digest(req.frames)
        out = []
        for r, (c, recent) in enumerate(zip(self.prefix_caches,
                                            self._recent, strict=True)):
            s = c.lookup(prompt)[0] if c is not None else 0
            for q in recent:
                if s >= len(toks):
                    break
                s = max(s, _common_len(q, toks))
            if digest is not None:
                xc = self.cross_caches[r]
                if (xc is not None and xc.has(digest)) or \
                        digest in self._recent_frames[r]:
                    s = max(s, self.psz)
            out.append(s)
        return out

    def mark_draining(self, r: int) -> None:
        """Exclude replica r from all future placement (an active
        ``scale_to`` is migrating its state away).  Rebuilding the router
        after the membership change clears the mark by construction."""
        self._draining.add(r)

    def route(self, req) -> int:
        """Pick a replica for ``req`` (no state change beyond LRU clocks);
        call ``commit`` once the replica's scheduler accepted it."""
        admit = [r for r in self._admit_set if r not in self._draining] \
            or self._admit_set
        if len(admit) == 1:
            return admit[0]
        hits = self.affinity(req)
        best = max(hits[r] for r in admit)
        if best >= self.psz:           # at least one full page reusable
            cand = [r for r in admit if hits[r] == best]
            self.affinity_routed += 1
        else:
            cand = list(admit)
        return min(cand, key=lambda rr: (self.page_load(rr), rr))

    def decode_placement(self, candidates: List[int]) -> int:
        """Pick the decode replica to receive a finished page run: least
        page load, index tiebreak (the same deterministic rule as cold
        routing).  ``candidates`` is the engine's per-tick set of
        decode-role replicas that still have a free slot."""
        cand = [r for r in candidates if r not in self._draining] \
            or list(candidates)
        return min(cand, key=lambda rr: (self.page_load(rr), rr))

    def commit(self, req, r: int) -> None:
        """Record a successful placement: ``req``'s prompt (and frames
        digest, for enc-dec) joins replica r's recent-routing window
        (rejected requests must not skew affinity, so this is separate
        from ``route``)."""
        self._recent[r].append([int(t) for t in effective_prompt(req)])
        if getattr(req, "frames", None) is not None:
            self._recent_frames[r].append(CrossKVCache.digest(req.frames))
