"""Paged KV cache: the page pools and the host-side page allocator.

Port of the JAX package's ``core/kvcache.py`` for attention-only decoders
on one device (dp=1, so the pools carry no replica axis).  Per layer group
and pattern entry the cache holds

    {"kv": {"kp": (reps, n_pages, n_kv_loc, page_size, D),
            "vp": (reps, n_pages, n_kv_loc, page_size, D)}}

and, for int8 pools, ``"ksp"``/``"vsp"`` float32 scales of shape (reps,
n_pages, page_size): one scale per (page, token row), written with the
row's payload, so every row is quantized on its own.  A zero scale
dequantizes to exact zeros.

Token t of a slot lives at page block_table[t // page_size], offset
t % page_size.  The pools are one static allocation, updated in place;
request lengths appear only as data (block tables, positions), never as
shapes.

Invariant: page 0 is scratch — idle decode lanes point their block tables
    at it so the decode step always runs full-batch; its contents are
    garbage by convention and never read back by a live slot.
"""
from __future__ import annotations

import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.model import check_supported
from repro_torch.core.partition import kv_pool_is_quantized, torch_dtype

SCRATCH_PAGE = 0


def paged_cache_template(cfg, plan, lay, n_pages: int, page_size: int):
    """-> list (per layer group) of lists (per pattern entry) of
    ``{"kv": {"kp": (shape, dtype), "vp": (shape, dtype)}}``, plus
    ``"ksp"``/``"vsp"`` scale pools when the pool is int8."""
    check_supported(cfg)
    shape = (n_pages, lay.attn.n_kv_loc, page_size, cfg.head_dim_)
    dtype = torch_dtype(plan.kv_cache_dtype)
    quant = kv_pool_is_quantized(plan)
    out = []
    for g in cfg.layer_groups():
        kv = {"kp": ((g.n_reps,) + shape, dtype),
              "vp": ((g.n_reps,) + shape, dtype)}
        if quant:
            scale = ((g.n_reps, n_pages, page_size), torch.float32)
            kv.update(ksp=scale, vsp=scale)
        out.append([{"kv": dict(kv)} for _ in g.pattern])
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


def pages_needed(n_tokens: int, page_size: int) -> int:
    return -(-n_tokens // page_size)
