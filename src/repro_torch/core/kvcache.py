"""The decode caches: the contiguous per-slot lanes, the page pools and SSM
state slabs, and the host-side page and slab allocators.

Port of the JAX package's ``core/kvcache.py`` for attention-only and
pure-SSM decoders on one device (dp=1, so nothing carries a replica axis).

**Contiguous lanes** (``cache_template``/``zero_cache``): per layer group
and pattern entry, stacked under the group's reps axis,

    {"kv": {"k"/"v": (reps, B, G, W, D) in plan.kv_cache_dtype,
            "pos": (reps, B, W) int32, -1 = empty}}
    {"ssm": {"state": (reps, B, H, P, N) float32,
             "conv_x": (reps, B, K-1, H*P), "conv_B"/"conv_C": (reps, B,
             K-1, N) in cfg.dtype}}

with W = ``kv_window`` (the sequence budget, or a sliding window shorter
than it); int8 lanes hold the fixed-scale ``blocks.KVQ`` payload.

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

import torch

from repro_torch.configs.base import ATTN_WINDOW
from repro_torch.core.device import resolve_device
from repro_torch.core.model import check_supported
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
                         n_slabs: int = 0):
    """-> list (per layer group) of lists (per pattern entry) of
    ``{"kv": {"kp": (shape, dtype), "vp": (shape, dtype)}}`` (plus
    ``"ksp"``/``"vsp"`` scale pools when the pool is int8) for attention
    layers and ``{"ssm": {"statep", "conv_xp", "conv_Bp", "conv_Cp"}}``
    (plus ``"sscalep"`` for int8 slabs) for SSM layers, with ``n_slabs``
    slabs including the scratch slab."""
    check_supported(cfg)
    kv_shape = (n_pages, lay.attn.n_kv_loc, page_size, cfg.head_dim_)
    kv_dtype = torch_dtype(plan.kv_cache_dtype)
    slab = None
    if "ssm" in cache_profile(cfg):
        if n_slabs < 2:
            raise ValueError(f"SSM layers need n_slabs > 1 (scratch + one "
                             f"per slot), got {n_slabs}")
        H, Pd, N = lay.ssm.hq_loc, cfg.ssm_head_dim, cfg.ssm_state
        K, conv_dt = cfg.ssm_conv, torch_dtype(cfg.dtype)
        quant = ssm_pool_is_quantized(plan)
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
                    scale = ((n_pages, page_size), torch.float32)
                    kv.update(ksp=scale, vsp=scale)
                entry["kv"] = kv
            if "ssm" in spec.cache_kinds():
                entry["ssm"] = slab
            per_pattern.append(
                {kind: {name: ((g.n_reps,) + shape, dtype)
                        for name, (shape, dtype) in pools.items()}
                 for kind, pools in entry.items()})
        out.append(per_pattern)
    return out


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
    reuses a small working set.  A page returns to the free list when its
    last reference drops.

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

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int):
        """-> list of n page ids (each refcount 1), or None if the pool
        can't cover n."""
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(out)
        for p in out:
            self._rc[p] = 1
        return out

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
