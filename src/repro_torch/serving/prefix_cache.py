"""The radix prefix cache, the speculative draft source, the enc-dec
cross-KV cache and the host spill store: a copy of the JAX package's
``serving/prefix_cache.py``.

Radix prefix cache: token-id sequences -> refcounted page runs in the
engine's ``PageAllocator`` id space.  KV already resident in the page pool
is never recomputed or re-stored: completed prefills insert their prompt's
full pages into a radix tree; admission looks up the longest cached prefix
and maps those pages straight into the new slot's block table, so chunked
prefill starts at the first uncached token.  The cache deals only in page
ids, so int8 pools need nothing extra here: a page's payload and its scale
rows share the id, and the engine's page-copy step copies both.

Invariants (as in the JAX package, held against it by
``tests/test_torch_prefix_cache.py``):

- page alignment: every node key length is a positive multiple of
  ``page_size`` and ``node.pages`` holds ``len(key) / page_size`` ids;
  children are keyed by their first page of tokens, so sequences that
  diverge mid-page live in sibling nodes;
- cache refs: the tree holds one allocator ref per page it references;
  pages are released only by eviction;
- immutability: inserted pages hold KV of fully prefilled positions only
  and are never written again (the engine inserts only a prompt's full
  pages; the partial tail stays slot-private);
- copy-on-write: a lookup matching into the middle of a page maps the
  matched full pages and returns the partial page as the source of a
  private copy (``core.steps.make_page_copy_step``) made before the slot
  writes;
- LRU eviction: leaf runs go oldest first, and only when no live slot
  shares their pages (refcount 1), so each eviction frees exactly
  ``len(node.pages)`` pages;
- spill restore is byte-identical: page payloads spilled to the
  ``HostSpillStore`` (int8 payloads and their per-(page, row) scale rows
  included) restore bit for bit into fresh pages of any replica, so a hit
  after a membership change or a restart reads exactly the bytes the
  original prefill or encode wrote.
"""
from __future__ import annotations

import hashlib
from typing import List, Optional, Tuple

import numpy as np

MAX_NGRAM = 3    # longest trailing n-gram matched, as in the JAX package


def _common_len(a, b) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


class RadixNode:
    __slots__ = ("key", "pages", "children", "parent", "last_access")

    def __init__(self, key: tuple, pages: List[int],
                 parent: Optional["RadixNode"]):
        self.key = key
        self.pages = pages
        self.children: dict = {}
        self.parent = parent
        self.last_access = 0


class RadixPrefixCache:
    """Radix tree over token ids; holds allocator refs on cached pages."""

    def __init__(self, allocator, page_size: int):
        self.allocator = allocator
        self.psz = page_size
        self.root = RadixNode((), [], None)
        self._clock = 0          # logical LRU clock (deterministic)
        self.evictions = 0

    # ------------------------------------------------------------- queries
    @property
    def n_cached_pages(self) -> int:
        return sum(len(n.pages) for n in self._nodes())

    @property
    def n_nodes(self) -> int:
        return sum(1 for _ in self._nodes())

    @property
    def n_evictable_pages(self) -> int:
        """Pages eviction could eventually free: nodes whose whole subtree
        is unshared (refcount 1 everywhere).  A pinned descendant keeps its
        ancestors resident because only leaves are ever evicted."""
        total = 0

        def clean(node):
            nonlocal total
            ok = all(self.allocator.refcount(p) == 1 for p in node.pages)
            for ch in node.children.values():
                ok &= clean(ch)           # no short-circuit: count siblings
            if ok and node is not self.root:
                total += len(node.pages)
            return ok

        clean(self.root)
        return total

    def _nodes(self):
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            yield n

    def entries(self):
        """Yield (token_path, pages) per *leaf*, root-to-leaf accumulated:
        leaves subsume every interior node's prefix, so they are the whole
        resident corpus (the speculative drafts search their paths)."""
        stack = [((), [], self.root)]
        while stack:
            prefix, ppages, node = stack.pop()
            path = prefix + node.key
            pages = ppages + node.pages
            if not node.children and node is not self.root:
                yield path, pages
            stack.extend((path, pages, ch) for ch in node.children.values())

    # -------------------------------------------------------------- lookup
    def lookup(self, tokens) -> Tuple[int, List[int]]:
        """Longest cached prefix of ``tokens`` -> (match_len, pages).

        ``pages`` covers ``ceil(match_len / page_size)`` pages along the
        matched path; when ``match_len`` is not page-aligned the last entry
        is the partially matched page (copy-on-write source).  Takes no
        refs: the caller pins what it keeps before any eviction can run."""
        toks = [int(t) for t in tokens]
        self._clock += 1
        node, pages, matched = self.root, [], 0
        while matched < len(toks):
            rem = toks[matched:]
            child = node.children.get(tuple(rem[:self.psz]))
            if child is None:
                # no full-page match: scan for a mid-page partial match
                best, best_c = None, 0
                for ch in node.children.values():
                    c = _common_len(ch.key, rem)
                    if c > best_c:
                        best, best_c = ch, c
                if best is not None:
                    best.last_access = self._clock
                    pages.append(best.pages[0])
                    matched += best_c
                break
            c = _common_len(child.key, rem)
            child.last_access = self._clock
            n_full = c // self.psz
            pages.extend(child.pages[:n_full])
            if c % self.psz:
                pages.append(child.pages[n_full])
            matched += c
            if c < len(child.key):
                break
            node = child
        return matched, pages

    # -------------------------------------------------------------- insert
    def insert(self, tokens, pages: List[int]) -> int:
        """Cache ``pages`` (full pages of a prefilled prompt) under
        ``tokens``; len(tokens) must equal len(pages) * page_size.

        Prefix parts already cached keep their existing pages (the caller's
        duplicates stay slot-owned and die with the slot); only the new
        suffix takes cache refs.  -> number of newly referenced pages."""
        toks = [int(t) for t in tokens]
        assert len(toks) == len(pages) * self.psz, (len(toks), len(pages))
        self._clock += 1
        node, i = self.root, 0
        while i < len(toks):
            rem = toks[i:]
            child = node.children.get(tuple(rem[:self.psz]))
            if child is None:
                leaf = RadixNode(tuple(rem), list(pages[i // self.psz:]),
                                 node)
                leaf.last_access = self._clock
                self.allocator.incref(leaf.pages)
                node.children[tuple(rem[:self.psz])] = leaf
                return len(leaf.pages)
            c = _common_len(child.key, rem)
            cp = (c // self.psz) * self.psz   # split at a page boundary
            child.last_access = self._clock
            if cp < len(child.key):
                self._split(child, cp)
            i += cp
            node = child
        return 0

    def _split(self, node: RadixNode, cp: int):
        """Split ``node`` so its key ends at page-aligned offset ``cp``."""
        tail = RadixNode(node.key[cp:], node.pages[cp // self.psz:], node)
        tail.children = node.children
        tail.last_access = node.last_access
        for gc in tail.children.values():
            gc.parent = tail
        node.key = node.key[:cp]
        node.pages = node.pages[:cp // self.psz]
        node.children = {tail.key[:self.psz]: tail}

    # ------------------------------------------------------------ eviction
    def evict(self, n_pages: int) -> int:
        """Evict LRU leaf runs until >= ``n_pages`` pages return to the
        pool (or nothing evictable remains).  -> pages actually freed."""
        freed = 0
        while freed < n_pages:
            victim = None
            for n in self._nodes():
                if n.children:
                    continue                  # leaves only: children first
                if any(self.allocator.refcount(p) > 1 for p in n.pages):
                    continue                  # shared with a live slot
                if victim is None or n.last_access < victim.last_access:
                    victim = n
            if victim is None:
                break
            self.allocator.decref(victim.pages)
            freed += len(victim.pages)
            del victim.parent.children[victim.key[:self.psz]]
            self.evictions += 1
        return freed


class PromptLookupDraft:
    """Self-drafting source for speculative decoding — no second model.

    Prompt-lookup (n-gram) drafting: the longest trailing n-gram of the
    slot's context (prompt + emitted tokens) is matched against its most
    recent earlier occurrence, first within the context itself, then along
    the radix prefix cache's stored token paths (other requests' prompts,
    when the engine runs one); the k tokens that followed that occurrence
    become the draft.  Drafts are proposals only — the verify step scores
    them against the real model and rejection keeps outputs token-identical
    — so a bad draft costs pages, never accuracy.  An empty return means
    "no guess": the engine falls back to the one-token decode path for that
    slot this tick."""

    def __init__(self, prefix_cache: Optional[RadixPrefixCache] = None):
        self.prefix_cache = prefix_cache

    def draft(self, context, k: int) -> List[int]:
        """Propose up to ``k`` continuation tokens for ``context``."""
        if k <= 0 or len(context) < 2:
            return []
        toks = [int(t) for t in context]
        for n in range(min(MAX_NGRAM, len(toks) - 1), 0, -1):
            gram = toks[-n:]
            # most recent earlier occurrence within the context itself
            for i in range(len(toks) - n - 1, -1, -1):
                if toks[i:i + n] == gram:
                    out = toks[i + n:i + n + k]
                    if out:
                        return out
            # then along cached token paths (other requests' prompts)
            best: List[int] = []
            for path in self._cache_paths():
                for i in range(len(path) - n, -1, -1):
                    if list(path[i:i + n]) == gram:
                        out = [int(t) for t in path[i + n:i + n + k]]
                        if len(out) > len(best):
                            best = out
                        break
            if best:
                return best
        return []

    def _cache_paths(self):
        """Root-to-leaf token sequences of the radix cache (leaves subsume
        every interior path, so they are the whole searchable corpus)."""
        if self.prefix_cache is None:
            return
        for path, _ in self.prefix_cache.entries():
            yield path


class CrossKVCache:
    """Encoder cross-KV sharing: frames digest -> refcounted page run.

    The cache holds ONE allocator ref per page of every entry; a serving
    slot that hits takes an extra ref (``acquire``) and drops it at finish
    or preemption, so an entry's pages return to the pool only when the
    entry is evicted AND no slot still reads them.  Entries whose pages
    are unshared (refcount 1: cache-only) are LRU-evictable under pool
    pressure.  No copy-on-write: cross pages are written once at
    admission (``core.steps.make_cross_kv_write_step``) and read-only
    after."""

    def __init__(self, allocator):
        self.allocator = allocator
        self._entries: dict = {}    # digest -> [pages, last_access]
        self._clock = 0
        self.evictions = 0

    @staticmethod
    def digest(frames) -> str:
        """Identity of an encoder input: the sha1 of its bytes and shape."""
        a = np.ascontiguousarray(np.asarray(frames))
        return hashlib.sha1(a.tobytes() + str(a.shape).encode()).hexdigest()

    @property
    def n_cached_pages(self) -> int:
        return sum(len(e[0]) for e in self._entries.values())

    @property
    def n_entries(self) -> int:
        return len(self._entries)

    @property
    def n_evictable_pages(self) -> int:
        return sum(len(e[0]) for e in self._entries.values()
                   if all(self.allocator.refcount(p) == 1 for p in e[0]))

    def has(self, key: str) -> bool:
        """Read-only residency probe (no refs, no LRU touch)."""
        return key in self._entries

    def acquire(self, key: str) -> Optional[List[int]]:
        """Pages for ``key`` with one extra (slot) ref taken, or None."""
        self._clock += 1
        e = self._entries.get(key)
        if e is None:
            return None
        e[1] = self._clock
        self.allocator.incref(e[0])
        return list(e[0])

    def insert(self, key: str, pages: List[int]) -> bool:
        """Adopt ``pages`` (freshly written cross-KV) under ``key``; takes
        one cache ref per page.  -> False (no refs taken) when the key is
        already cached: the caller's pages then stay slot-private and die
        with the slot."""
        self._clock += 1
        if key in self._entries:
            return False
        self.allocator.incref(pages)
        self._entries[key] = [list(pages), self._clock]
        return True

    def entries(self):
        """Yield (digest, pages) for every cached encode."""
        for key, (pages, _) in self._entries.items():
            yield key, list(pages)

    def evict(self, n_pages: int) -> int:
        """Evict LRU unshared entries until >= n_pages are freed (or nothing
        evictable remains).  -> pages freed."""
        freed = 0
        while freed < n_pages:
            victim = None
            for k, (pages, last) in self._entries.items():
                if any(self.allocator.refcount(p) > 1 for p in pages):
                    continue            # a live slot still reads them
                if victim is None or last < self._entries[victim][1]:
                    victim = k
            if victim is None:
                break
            pages, _ = self._entries.pop(victim)
            self.allocator.decref(pages)
            freed += len(pages)
            self.evictions += 1
        return freed


class HostSpillStore:
    """Host-side persistence for cached entries across membership changes
    and engine restarts.

    Device page pools die with their replica rows (a drain shrinks the
    pool; a crash loses the rows outright), but the payload bytes of radix
    prefix and cross-KV entries are pure functions of tokens and frames, so
    the engine gathers them to the host before a reconfiguration
    (``ServingEngine.spill_state``) and writes them into the survivors'
    pools after it (``_restore_from_spill``).  Keys are the caches' own
    identities: the leaf token path for radix entries, the frames digest
    for cross entries.  A payload list holds one host tensor per pool of
    the kind, in the engine's pool order, each the entry's pages of every
    layer (``pool[:, pages]``): int8 payloads and their scale rows are
    separate pools and ride along byte for byte.  Payloads stay torch
    tensors in the pools' own dtypes (numpy has no bfloat16) and are never
    cast.

    A plain dict with overwrite semantics: spilling a key again replaces
    the entry (the latest bytes win), and the store outlives the engine,
    so a fresh engine can warm-start from it (``build_paged(spill=)``)."""

    def __init__(self):
        self.radix: dict = {}        # token path tuple -> (n_pages, payloads)
        self.cross: dict = {}        # frames digest    -> (n_pages, payloads)
        self.pages_saved = 0
        self.pages_restored = 0

    def put_prefix(self, tokens: tuple, n_pages: int, payloads):
        self.radix[tuple(int(t) for t in tokens)] = (n_pages, payloads)
        self.pages_saved += n_pages

    def put_cross(self, key: str, n_pages: int, payloads):
        self.cross[key] = (n_pages, payloads)
        self.pages_saved += n_pages

    @property
    def n_entries(self) -> int:
        return len(self.radix) + len(self.cross)
