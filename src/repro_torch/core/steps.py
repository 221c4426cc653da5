"""The serving steps: contiguous decode and whole-prompt prefill, and the
paged decode, speculative verify, prefill chunk and page copy.

Port of the JAX package's ``make_decode_step``, ``make_prefill_step``,
``make_paged_decode_step``, ``make_verify_step``,
``make_prefill_chunk_step`` and ``make_page_copy_step`` at dp=1.  Each is
a plain callable that runs eagerly; the engine captures every fixed-shape
one in a CUDA graph on the card (``core.graphs``), where JAX jits it.  The
contiguous steps take the per-slot lanes of ``kvcache.cache_template``; the
prefill step takes one prompt at its own length.  Each paged step's shapes
are fixed when it is made — (batch, n_max_pages) for decode, (batch, q_len,
n_max_pages) for verify, (chunk, n_max_pages) for a prefill chunk — and
every request length reaches them only as data (block tables, positions,
live-column counts), never as a shape, as in the JAX engine.  Paged models
with SSM layers take one more input, ``slab_ids``: each row's state slab
(scratch slab 0 for idle lanes).
"""
from __future__ import annotations

import torch

from repro_torch.core import model
from repro_torch.core.kvcache import (cache_profile, cache_template,
                                      paged_cache_template, zero_cache,
                                      zero_paged_cache)
from repro_torch.core.partition import model_layout
from repro_torch.kernels import decode_attention as k_dec


def _expect(name, t, shape):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != step shape "
                         f"{tuple(shape)}")


def _pages(cfg, block_table, slab_ids, rows):
    """The step's paging inputs; ``slab_ids`` exactly when the model has
    SSM layers."""
    pages = {"block_table": block_table}
    if "ssm" in cache_profile(cfg):
        if slab_ids is None:
            raise ValueError(f"arch '{cfg.name}' has SSM layers: the step "
                             f"needs slab_ids")
        _expect("slab_ids", slab_ids, (rows,))
        pages["slab_ids"] = slab_ids
    elif slab_ids is not None:
        raise ValueError(f"arch '{cfg.name}' has no SSM layers: no slab_ids")
    return pages


def make_decode_step(cfg, plan, batch: int, budget: int):
    """-> decode_fn(params, cache, tokens (B, 1), pos (B,)) -> (logits (B,
    V), cache updated in place), over the contiguous lanes of
    ``zero_cache_for(cfg, plan, batch, budget)``.  ``pos`` is the inclusive
    position of each row's token; idle rows run with token 0 and pos 0.
    On the card the decode kernel reads each lane's first ``min(pos + 1,
    W)`` slots of its ring of W (the budget, or a sliding window shorter
    than it: ``core.attention``)."""
    lay = model_layout(cfg, plan)

    def decode_fn(params, cache, tokens, pos):
        _expect("tokens", tokens, (batch, 1))
        _expect("pos", pos, (batch,))
        return model.forward_decode(params, cache, tokens, pos, cfg, plan,
                                    lay)

    return decode_fn


def make_prefill_step(cfg, plan, budget: int):
    """-> prefill_fn(params, prompt (1, S), cache) -> (logits (1, V), cache
    filled in place), for a batch-1 lane of ``zero_cache_for(cfg, plan, 1,
    budget)`` and 1 <= S < budget."""
    lay = model_layout(cfg, plan)

    def prefill_fn(params, prompt, cache):
        if prompt.dim() != 2 or prompt.shape[0] != 1 or \
                not 1 <= prompt.shape[1] < budget:
            raise ValueError(f"prompt: shape {tuple(prompt.shape)} is not "
                             f"(1, S) with 1 <= S < {budget}")
        return model.forward_prefill(params, prompt, cache, cfg, plan, lay)

    return prefill_fn


def zero_cache_for(cfg, plan, batch: int, budget: int, device="cuda"):
    """Empty contiguous lanes for ``batch`` slots of ``budget`` tokens."""
    lay = model_layout(cfg, plan)
    return zero_cache(cache_template(cfg, plan, lay, batch, budget), device)


def make_paged_decode_step(cfg, plan, batch: int, n_max_pages: int):
    """-> decode_fn(params, cache, tokens (B, 1), pos (B,), block_table
    (B, n_max)[, slab_ids (B,)]) -> (logits (B, V), cache updated in
    place).  ``pos`` is the inclusive position of each row's token; idle
    rows point their block table at the scratch page with pos 0, and their
    slab id at the scratch slab."""
    lay = model_layout(cfg, plan)

    def decode_fn(params, cache, tokens, pos, block_table, slab_ids=None):
        _expect("tokens", tokens, (batch, 1))
        _expect("pos", pos, (batch,))
        _expect("block_table", block_table, (batch, n_max_pages))
        pages = _pages(cfg, block_table, slab_ids, batch)
        return model.forward_decode(params, cache, tokens, pos, cfg, plan,
                                    lay, pages)

    return decode_fn


def make_verify_step(cfg, plan, batch: int, q_len: int, n_max_pages: int):
    """-> verify_fn(params, cache, tokens (B, Q), pos (B,), qlen (B,),
    block_table (B, n_max)) -> (logits (B, Q, V), cache updated in place).

    The speculative companion of the decode step: one call scores Q = k+1
    positions per slot (the last accepted token plus k drafts), writing
    all Q tokens' KV through the block table and reading the cache once.
    ``qlen`` marks each row's live columns; idle rows point their block
    table at the scratch page with pos 0 and qlen 1.  Attention-only
    models only: an SSM recurrence advances one token per step."""
    if "ssm" in cache_profile(cfg):
        raise ValueError(f"verify step requires an attention-only arch, got "
                         f"'{cfg.name}': SSM recurrences advance one token "
                         f"per step")
    lay = model_layout(cfg, plan)

    def verify_fn(params, cache, tokens, pos, qlen, block_table):
        _expect("tokens", tokens, (batch, q_len))
        _expect("pos", pos, (batch,))
        _expect("qlen", qlen, (batch,))
        _expect("block_table", block_table, (batch, n_max_pages))
        pages = {"block_table": block_table}
        return model.forward_verify(params, cache, tokens, pos, qlen, cfg,
                                    plan, lay, pages)

    return verify_fn


def check_verify_on_card(cfg, plan, q_len: int):
    """Refuse a verify step of ``q_len`` = k + 1 queries a row that the
    card's verify kernel cannot take at this arch's head layout: the
    kernel holds a kv slot's R x Q query rows (R q heads a slot, Q queries
    each) in one m16 tile, so R x Q <= 16, and Q <= 8
    (``kernels.decode_attention.plan``).  mistral-large-123b's R = 12
    takes Q = 1 only: no speculation.  Raised where an engine is built on
    the card, before anything is allocated; the CPU path (plain versions)
    takes any k, as the Pallas kernel does.  Raises ValueError."""
    r = model_layout(cfg, plan).attn.r
    if r * q_len > k_dec.MAX_ROWS or q_len > k_dec.MAX_NQ:
        raise ValueError(
            f"speculative={q_len - 1} is unsupported on the card for arch "
            f"'{cfg.name}': the verify kernel takes R x Q <= "
            f"{k_dec.MAX_ROWS} query rows of a kv slot and Q <= "
            f"{k_dec.MAX_NQ}, and R {r} q heads a slot x Q {q_len} queries "
            f"= {r * q_len} (ROADMAP Queue 2 item 1: R x Q > 16; the CPU "
            f"path takes any k)")


def _index(name, x, device):
    """A step's per-tick scalar as the (1,) int32 device tensor the model
    takes; a host int (a direct caller's) is copied there."""
    if isinstance(x, torch.Tensor):
        _expect(name, x, (1,))
        return x
    return torch.tensor([x], dtype=torch.int32, device=device)


def make_prefill_chunk_step(cfg, plan, chunk: int, n_max_pages: int):
    """-> chunk_fn(params, cache, tokens (1, C), chunk_start, last_idx,
    block_table (1, n_max)[, slab_ids (1,)]) -> (logits (1, V), cache
    updated in place).  ``chunk_start`` is the chunk's first absolute
    position and ``last_idx`` the in-chunk index of the prompt's last token
    (SSM layers leave their state untouched past it), each a (1,) int32
    tensor on the device, as JAX takes them traced (the engine's case: the
    step reads neither on the host, so one CUDA graph serves every chunk),
    or a host int, range-checked here.  The engine checks its own
    ``last_idx`` while it is still a host int."""
    lay = model_layout(cfg, plan)

    def chunk_fn(params, cache, tokens, chunk_start, last_idx, block_table,
                 slab_ids=None):
        _expect("tokens", tokens, (1, chunk))
        _expect("block_table", block_table, (1, n_max_pages))
        if not isinstance(last_idx, torch.Tensor) and \
                not 0 <= last_idx < chunk:
            raise ValueError(f"last_idx {last_idx} outside the chunk {chunk}")
        chunk_start = _index("chunk_start", chunk_start, tokens.device)
        last_idx = _index("last_idx", last_idx, tokens.device)
        pages = _pages(cfg, block_table, slab_ids, 1)
        return model.forward_prefill_chunk(params, cache, tokens, chunk_start,
                                           last_idx, cfg, plan, lay, pages)

    return chunk_fn


def make_page_copy_step(n_pages: int):
    """-> copy_fn(cache, src (1,), dst (1,)) -> cache, with page ``src``
    copied onto page ``dst`` in every layer's self-KV pool, in place.

    The mechanism behind copy-on-write: a slot that must append into a
    page the radix prefix cache shares first duplicates it into a private
    page (``serving.prefix_cache``), then writes only the copy.  int8 pools
    copy the payload and its scale rows together (``ksp``/``vsp`` share the
    page id).  SSM slabs (another id space) are left alone.  ``src`` and
    ``dst`` are (1,) int32 tensors on the pools' device, read there and
    never on the host, so one CUDA graph serves every pair; src == dst is
    the identity.  Plain indexed copies: the JAX package has no kernel for
    this step either (``make_page_copy_step`` there, one pair per
    replica); the pools carry their own shapes."""

    def copy_fn(cache, src, dst):
        _expect("src", src, (1,))
        _expect("dst", dst, (1,))
        dst = dst.long()           # index_copy_ takes int64 ids only
        for group in cache:
            for entry in group:
                for pool in entry.get("kv", {}).values():
                    if pool.shape[1] != n_pages:
                        raise ValueError(f"pool of {pool.shape[1]} pages, "
                                         f"step made for {n_pages}")
                    pool.index_copy_(1, dst, pool.index_select(1, src))
        return cache

    return copy_fn


def zero_paged_cache_for(cfg, plan, n_pages, page_size, device="cuda",
                         n_slabs: int = 0):
    lay = model_layout(cfg, plan)
    return zero_paged_cache(
        paged_cache_template(cfg, plan, lay, n_pages, page_size, n_slabs),
        device)
