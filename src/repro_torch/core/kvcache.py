"""The decode caches: the contiguous per-slot lanes, the page pools and SSM
state slabs, and the host-side page and slab allocators.

Port of the JAX package's ``core/kvcache.py`` for attention-only, SSM,
hybrid and encoder-decoder models on one device, with ``n_replicas``
data-parallel replicas folded into every pool (below).

**Contiguous lanes** (``cache_template``/``zero_cache``): per layer group
and pattern entry, stacked under the group's reps axis,

    {"kv": {"k"/"v": (reps, B, G, W, D) in plan.kv_cache_dtype,
            "pos": (reps, B, W) int32, -1 = empty}}
    {"ssm": {"state": (reps, B, H, P, N) float32,
             "conv_x": (reps, B, K-1, H*P), "conv_B"/"conv_C": (reps, B,
             K-1, N) in cfg.dtype}}

    {"cross": {"k"/"v": (reps, B, G, S_enc, D) in plan.kv_cache_dtype}}

with W = ``kv_window`` (the sequence budget, or a sliding window shorter
than it); int8 lanes hold the fixed-scale ``blocks.KVQ`` payload, an
enc-dec decoder's cross lanes (the encoder memory's K/V, written at
prefill) JAX's bare int8 cast (``blocks.cross_lane_cast``).

**Paged pools** (``paged_cache_template``/``zero_paged_cache``): per layer
group and pattern entry, for an attention layer,

    {"kv": {"kp": (reps, n_pages, n_kv_loc, page_size, D),
            "vp": (reps, n_pages, n_kv_loc, page_size, D)}}

and, for int8 pools, ``"ksp"``/``"vsp"`` float32 scales of shape (reps,
n_pages, page_size): one scale per (page, token row), written with the
row's payload, so every row is quantized on its own.  A zero scale
dequantizes to exact zeros.  For an SSM layer it holds

    {"ssm": {"statep": (reps, n_slabs, H, P, N) float32 or int8,
             "conv_xp": (reps, n_slabs, K-1, H*P),
             "conv_Bp"/"conv_Cp": (reps, n_slabs, K-1, N)}}

with conv tails in ``cfg.dtype`` and, for int8 slabs, ``"sscalep"``
(reps, n_slabs, H) float32: one scale per (slab, head), rewritten with the
whole state on every scatter.  A pure-SSM model has no KV pools at all.
An enc-dec decoder layer also holds

    {"cross": {"ckp"/"cvp": the shape of "kp"}}

(with ``"cksp"``/``"cvsp"`` for int8 pools): the encoder memory's K/V,
written once per encode and read-only after.  Cross pages share the
self-KV page-id space (one allocator covers both), so a request's cross
block table and its self block table index the same ``n_pages``.

**Replicas** (``n_replicas`` = R): JAX gives every pool a replica axis,
(reps, R, n_pages, ...), and each step folds it into one larger pool,
(reps, R * n_pages, ...), so attention never sees it.  Here the pools are
stored folded: the same bytes in the same order, and at R = 1 exactly the
one-replica layout.  Replica r's page p is folded page ``r * n_pages + p``
(its slab s folded slab ``r * n_slabs + s``: ``fold_ids``, the one place
that computes it).  The engine folds every id on the host as it stages a
step's inputs, scratch page 0 and slab 0 included (an idle row of replica
r reads replica r's scratch page), so the steps index the folded pools
and know nothing of replicas.
``unfold_replica_pools`` is a view of that (reps, R, n_pages, ...) and
``fold_replica_pools`` its inverse view: neither copies, because every
step writes its pools in place and a write into a copy would be lost.

Token t of a slot lives at page block_table[t // page_size], offset
t % page_size; a request's recurrent state lives in its one slab.  The
pools are one static allocation, updated in place; request lengths appear
only as data (block tables, positions), never as shapes.

Invariants: page 0 and slab 0 are scratch — idle decode lanes point their
    block tables and slab ids at them so the decode step always runs
    full-batch; their contents are garbage by convention and never read
    back by a live slot.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ATTN_WINDOW
from repro_torch.core.device import resolve_device
from repro_torch.core.model import check_supported, tree_map
from repro_torch.core.partition import (kv_pool_is_quantized,
                                        ssm_pool_is_quantized, torch_dtype)

SCRATCH_PAGE = 0
SCRATCH_SLAB = 0


def cache_profile(cfg) -> set:
    """Union of decode-cache kinds across the decoder stack: a subset of
    {"kv", "ssm", "cross_kv"}."""
    kinds = set()
    for spec in cfg.layer_specs():
        kinds.update(spec.cache_kinds())
    return kinds


def kv_window(cfg, spec, budget: int) -> int:
    """Ring length of a layer's contiguous KV lane: the budget, or the
    sliding window where the layer has one and it is shorter."""
    if spec.attn == ATTN_WINDOW and cfg.sliding_window:
        return min(budget, cfg.sliding_window)
    return budget


def layer_cache_template(cfg, plan, lay, spec, batch: int, budget: int):
    """-> {kind: {name: (shape, dtype)}} for ONE layer (no reps axis)."""
    out = {}
    if "kv" in spec.cache_kinds():
        W = kv_window(cfg, spec, budget)
        kv_shape = (batch, lay.attn.n_kv_loc, W, cfg.head_dim_)
        kvd = torch_dtype(plan.kv_cache_dtype)
        out["kv"] = {"k": (kv_shape, kvd), "v": (kv_shape, kvd),
                     "pos": ((batch, W), torch.int32)}
    if "ssm" in spec.cache_kinds():
        H, Pd, N = lay.ssm.hq_loc, cfg.ssm_head_dim, cfg.ssm_state
        K, conv_dt = cfg.ssm_conv, torch_dtype(cfg.dtype)
        out["ssm"] = {"state": ((batch, H, Pd, N), torch.float32),
                      "conv_x": ((batch, K - 1, H * Pd), conv_dt),
                      "conv_B": ((batch, K - 1, N), conv_dt),
                      "conv_C": ((batch, K - 1, N), conv_dt)}
    if "cross_kv" in spec.cache_kinds():
        shape = (batch, lay.attn.n_kv_loc, cfg.enc_seq_len, cfg.head_dim_)
        kvd = torch_dtype(plan.kv_cache_dtype)
        out["cross"] = {"k": (shape, kvd), "v": (shape, kvd)}
    return out


def cache_template(cfg, plan, lay, batch: int, budget: int):
    """The contiguous cache: list (per layer group) of lists (per pattern
    entry) of layer templates stacked under the group's reps axis."""
    check_supported(cfg)
    return [[{kind: {name: ((g.n_reps,) + shape, dtype)
                     for name, (shape, dtype) in leaves.items()}
              for kind, leaves in layer_cache_template(
                  cfg, plan, lay, spec, batch, budget).items()}
             for spec in g.pattern] for g in cfg.layer_groups()]


def zero_cache(tmpl, device="cuda"):
    """Materialize a contiguous cache template: zeros, and -1 in the int32
    ``pos`` leaves (every slot starts empty)."""
    dev = resolve_device(device)
    return [[{kind: {name: (torch.full(shape, -1, dtype=dtype, device=dev)
                            if dtype == torch.int32 else
                            torch.zeros(shape, dtype=dtype, device=dev))
                     for name, (shape, dtype) in leaves.items()}
              for kind, leaves in entry.items()}
             for entry in group] for group in tmpl]


def paged_cache_template(cfg, plan, lay, n_pages: int, page_size: int,
                         n_slabs: int = 0, n_replicas: int = 1):
    """-> list (per layer group) of lists (per pattern entry) of
    ``{"kv": {"kp": (shape, dtype), "vp": (shape, dtype)}}`` (plus
    ``"ksp"``/``"vsp"`` scale pools when the pool is int8) for attention
    layers, ``{"ssm": {"statep", "conv_xp", "conv_Bp", "conv_Cp"}}``
    (plus ``"sscalep"`` for int8 slabs) for SSM layers, with ``n_slabs``
    slabs including the scratch slab, and ``{"cross": {"ckp", "cvp"}}``
    (plus ``"cksp"``/``"cvsp"``) for an enc-dec decoder's layers.
    ``n_pages`` and ``n_slabs`` are per replica: every pool holds
    ``n_replicas`` of them, folded (the module's docstring)."""
    check_supported(cfg)
    if n_replicas < 1:
        raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
    kv_shape = (n_replicas * n_pages, lay.attn.n_kv_loc, page_size,
                cfg.head_dim_)
    kv_dtype = torch_dtype(plan.kv_cache_dtype)
    slab = None
    if "ssm" in cache_profile(cfg):
        if n_slabs < 2:
            raise ValueError(f"SSM layers need n_slabs > 1 (scratch + one "
                             f"per slot), got {n_slabs}")
        H, Pd, N = lay.ssm.hq_loc, cfg.ssm_head_dim, cfg.ssm_state
        K, conv_dt = cfg.ssm_conv, torch_dtype(cfg.dtype)
        quant = ssm_pool_is_quantized(plan)
        n_slabs *= n_replicas
        slab = {"statep": ((n_slabs, H, Pd, N),
                           torch.int8 if quant else torch.float32),
                "conv_xp": ((n_slabs, K - 1, H * Pd), conv_dt),
                "conv_Bp": ((n_slabs, K - 1, N), conv_dt),
                "conv_Cp": ((n_slabs, K - 1, N), conv_dt)}
        if quant:
            slab["sscalep"] = ((n_slabs, H), torch.float32)
    out = []
    for g in cfg.layer_groups():
        per_pattern = []
        for spec in g.pattern:
            entry = {}
            if "kv" in spec.cache_kinds():
                kv = {"kp": (kv_shape, kv_dtype), "vp": (kv_shape, kv_dtype)}
                if kv_pool_is_quantized(plan):
                    scale = ((kv_shape[0], page_size), torch.float32)
                    kv.update(ksp=scale, vsp=scale)
                entry["kv"] = kv
            if "ssm" in spec.cache_kinds():
                entry["ssm"] = slab
            if "cross_kv" in spec.cache_kinds():
                cross = {"ckp": (kv_shape, kv_dtype),
                         "cvp": (kv_shape, kv_dtype)}
                if kv_pool_is_quantized(plan):
                    scale = ((kv_shape[0], page_size), torch.float32)
                    cross.update(cksp=scale, cvsp=scale)
                entry["cross"] = cross
            per_pattern.append(
                {kind: {name: ((g.n_reps,) + shape, dtype)
                        for name, (shape, dtype) in pools.items()}
                 for kind, pools in entry.items()})
        out.append(per_pattern)
    return out


def fold_ids(ids, replica: int, n_per: int):
    """Replica ``replica``'s page (or slab) ids as ids of the folded
    pools, ``n_per`` the pages (slabs) of one replica: id p is folded id
    ``replica * n_per + p``.  Takes an int, a sequence or a numpy array;
    -> an int or an int32 array."""
    if isinstance(ids, (int, np.integer)):
        return replica * n_per + int(ids)
    return np.asarray(ids, np.int32) + np.int32(replica * n_per)


def unfold_replica_pools(cache, n_replicas: int):
    """Folded pools (reps, R * n, ...) as views (reps, R, n, ...): replica r's
    page (or slab) p at [:, r, p].  Views, never copies."""
    return tree_map(lambda pool: pool.view(
        (pool.shape[0], n_replicas, pool.shape[1] // n_replicas)
        + tuple(pool.shape[2:])), cache)


def fold_replica_pools(cache):
    """Inverse of ``unfold_replica_pools``: (reps, R, n, ...) ->
    (reps, R * n, ...), views."""
    return tree_map(lambda pool: pool.view(
        (pool.shape[0], pool.shape[1] * pool.shape[2])
        + tuple(pool.shape[3:])), cache)


def zero_paged_cache(tmpl, device="cuda"):
    dev = resolve_device(device)
    return [[{kind: {name: torch.zeros(shape, dtype=dtype, device=dev)
                     for name, (shape, dtype) in pools.items()}
              for kind, pools in entry.items()}
             for entry in group] for group in tmpl]


class PageAllocator:
    """Host-side refcounted block-pool allocator (page 0 reserved as scratch).

    All-or-nothing allocation: a request either gets every page it needs up
    front (prompt + max_new_tokens worth, plus draft headroom when
    speculating) or stays queued — admission control instead of mid-flight
    OOM.  Freed pages return to the pool LIFO, so a steady-state request mix
    reuses a small working set.

    Pages carry a reference count so they can be shared: a freshly allocated
    page has one owner; the radix prefix cache and further serving slots
    take extra refs (``incref``).  A page returns to the free list only when
    its last ref drops (``decref``).  Shared pages are immutable by
    convention: a slot that must append into one first takes a private copy
    (copy-on-write; ``serving.prefix_cache``).

    Every page whose last reference drops (``decref``, and the speculative
    ``trim`` through it) is marked **scale-dirty**, so an engine with int8
    pools can zero its scale rows before the page is reused
    (``take_scale_dirty``): a recycled page never pairs a fresh payload with
    a previous occupant's scales."""

    def __init__(self, n_pages: int, n_reserved: int = 1):
        assert n_pages > n_reserved, (n_pages, n_reserved)
        self.n_pages = n_pages
        self.n_reserved = n_reserved
        self._free = list(range(n_pages - 1, n_reserved - 1, -1))
        self._free_set = set(self._free)     # O(1) double-free detection
        self._rc = [0] * n_pages
        self._scale_dirty: set = set()       # freed pages w/ stale scale rows
        self.total_allocated = 0             # pages ever handed out (stats)
        self.pages_transferred_out = 0       # handed to another replica
        self.pages_transferred_in = 0        # received from another replica

    @property
    def n_free(self) -> int:
        return len(self._free)

    def refcount(self, page: int) -> int:
        return self._rc[page]

    def alloc(self, n: int):
        """-> list of n page ids (each refcount 1), or None if the pool
        can't cover n."""
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(out)
        for p in out:
            self._rc[p] = 1
        self.total_allocated += n
        return out

    def incref(self, pages):
        """Add one ref per page (sharing an already-live page)."""
        for p in pages:
            assert self._rc[p] > 0, f"incref of unallocated page {p}"
            self._rc[p] += 1

    def decref(self, pages):
        """Drop one ref per page; pages whose last ref drops are freed and
        marked scale-dirty."""
        for p in pages:
            assert p >= self.n_reserved, f"freeing reserved page {p}"
            assert p not in self._free_set, f"double free of page {p}"
            self._rc[p] -= 1
            if self._rc[p] == 0:
                self._free.append(p)
                self._free_set.add(p)
                self._scale_dirty.add(p)

    def trim(self, pages):
        """Release a live slot's tail pages (the draft headroom a slot gives
        back when it stops speculating).  Drops exactly the slot's own
        reference per page, so a page still shared elsewhere stays live."""
        self.decref(pages)

    def take_scale_dirty(self) -> list:
        """Drain the pages needing a scale reset before reuse: every page
        freed since the previous drain that is still on the free list.  A
        dirty page meanwhile re-allocated stays marked: resetting it now
        would corrupt its new occupant, and its stale rows sit past that
        occupant's length until it is freed again."""
        out = sorted(self._scale_dirty & self._free_set)
        self._scale_dirty.difference_update(out)
        return out


class SlabAllocator:
    """Host-side free-list allocator for SSM state slabs (slab 0 scratch).

    A slab holds one request's recurrent state (SSD state plus conv tails)
    across every SSM layer.  Slabs are never shared — recurrent state has
    exactly one owner — so there are no refcounts: ``alloc`` hands out one
    slab id (or None when exhausted, for all-or-nothing admission) and
    ``free`` returns it.  The engine zeroes a slab at admission."""

    def __init__(self, n_slabs: int, n_reserved: int = 1):
        assert n_slabs > n_reserved, (n_slabs, n_reserved)
        self.n_slabs = n_slabs
        self.n_reserved = n_reserved
        self._free = list(range(n_slabs - 1, n_reserved - 1, -1))
        self.total_allocated = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self):
        """-> one slab id, or None when the pool is exhausted."""
        if not self._free:
            return None
        self.total_allocated += 1
        return self._free.pop()

    def free(self, slab: int):
        assert slab >= self.n_reserved, f"freeing reserved slab {slab}"
        assert slab not in self._free, f"double free of slab {slab}"
        self._free.append(slab)


def pages_needed(n_tokens: int, page_size: int) -> int:
    return -(-n_tokens // page_size)


def handoff_refs(src_alloc: PageAllocator, src_pages,
                 dst_alloc: PageAllocator, dst_pages):
    """Move ownership of a page run between replica allocators, at once.

    The destination allocated fresh pages up front (``dst_pages``, each
    refcount 1: the transfer step copies the payload into them); this
    drops the source slot's reference to each source page exactly once.
    Source pages the radix prefix cache (or another slot) still shares just
    lose one ref and stay resident on the source replica: a handoff never
    frees a shared page from under its sharers."""
    assert src_alloc is not dst_alloc, "handoff within one replica"
    assert len(src_pages) == len(dst_pages), (src_pages, dst_pages)
    for p in dst_pages:
        assert dst_alloc.refcount(p) == 1, \
            f"handoff into shared destination page {p} " \
            f"(refcount {dst_alloc.refcount(p)}); destination pages must " \
            f"be freshly allocated"
    src_alloc.decref(src_pages)
    src_alloc.pages_transferred_out += len(src_pages)
    dst_alloc.pages_transferred_in += len(dst_pages)
