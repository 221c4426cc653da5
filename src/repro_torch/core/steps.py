"""The serving steps: contiguous decode and whole-prompt prefill, and the
paged decode, speculative verify, prefill chunk, page copy, page transfer
and an enc-dec arch's cross-KV write.

Port of the JAX package's ``make_decode_step``, ``make_prefill_step``,
``make_paged_decode_step``, ``make_verify_step``,
``make_prefill_chunk_step``, ``make_page_copy_step``,
``make_page_transfer_step`` and ``make_cross_kv_write_step`` on one
device.  Each is
a plain callable that runs eagerly; the engine captures every fixed-shape
one in a CUDA graph on the card (``core.graphs``), where JAX jits it.  The
contiguous steps take the per-slot lanes of ``kvcache.cache_template``; the
prefill step takes one prompt at its own length.  Each paged step's shapes
are fixed when it is made — (batch, n_max_pages) for decode, (batch, q_len,
n_max_pages) for verify, (chunk, n_max_pages) for a prefill chunk — and
every request length reaches them only as data (block tables, positions,
live-column counts), never as a shape, as in the JAX engine.  Paged models
with SSM layers take one more input, ``slab_ids``: each row's state slab
(scratch slab 0 for idle lanes); enc-dec models take their read-only
``cross_block_table`` after it (all scratch page 0 for idle lanes), and
their contiguous prefill takes the request's frames before its prompt.

**Replicas**: the pools of R data-parallel replicas are one folded pool
(``core.kvcache``), and every id a paged step takes (block tables, slab
ids, cross block tables, copy and transfer pages) is already folded, by
the engine on the host (``kvcache.fold_ids``), so the steps know nothing
of replicas.  The decode and verify steps run R x Bp rows, row b replica
b // Bp's; the chunk, copy and cross-KV write steps run one unit of one
replica a replay, at the same shapes as with one replica; the transfer
step moves a page run between two replicas' pages.  JAX's steps take the
ids replica-relative and offset them inside the step instead; the bytes
written are the same.
"""
from __future__ import annotations

import torch

from repro_torch.core import model
from repro_torch.core.kvcache import (cache_profile, cache_template,
                                      pages_needed, paged_cache_template,
                                      zero_cache, zero_paged_cache)
from repro_torch.core.blocks import _row_quant
from repro_torch.core.partition import model_layout
from repro_torch.kernels import decode_attention as k_dec


def _expect(name, t, shape):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != step shape "
                         f"{tuple(shape)}")


def n_cross_pages(cfg, page_size: int) -> int:
    """Pages of one encoder memory's cross-KV (0 without cross-attention)."""
    if "cross_kv" not in cache_profile(cfg):
        return 0
    return pages_needed(cfg.enc_seq_len, page_size)


def _pages(cfg, block_table, slab_ids, cross_bt, rows, n_cross=0):
    """The step's paging inputs; ``slab_ids`` exactly when the model has
    SSM layers, ``cross_block_table`` (rows, n_cross) exactly when it has
    cross-attention."""
    pages = {"block_table": block_table}
    prof = cache_profile(cfg)
    if "ssm" in prof:
        if slab_ids is None:
            raise ValueError(f"arch '{cfg.name}' has SSM layers: the step "
                             f"needs slab_ids")
        _expect("slab_ids", slab_ids, (rows,))
        pages["slab_ids"] = slab_ids
    elif slab_ids is not None:
        raise ValueError(f"arch '{cfg.name}' has no SSM layers: no slab_ids")
    if "cross_kv" in prof:
        if not n_cross:
            raise ValueError(f"arch '{cfg.name}' has cross-attention: make "
                             f"the step with its page_size")
        if cross_bt is None:
            raise ValueError(f"arch '{cfg.name}' has cross-attention: the "
                             f"step needs cross_block_table")
        _expect("cross_block_table", cross_bt, (rows, n_cross))
        pages["cross_block_table"] = cross_bt
    elif cross_bt is not None:
        raise ValueError(f"arch '{cfg.name}' has no cross-attention: no "
                         f"cross_block_table")
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
    budget)`` and 1 <= S < budget.  An enc-dec arch's takes ``(params,
    frames (1, S_enc, E), prompt, cache)``, as JAX's takes ``(frames,
    dec_tokens, cache)``: the frames in any float dtype, cast to the
    weights' dtype, encoded, and every cross lane filled."""
    lay = model_layout(cfg, plan)

    def check(prompt):
        if prompt.dim() != 2 or prompt.shape[0] != 1 or \
                not 1 <= prompt.shape[1] < budget:
            raise ValueError(f"prompt: shape {tuple(prompt.shape)} is not "
                             f"(1, S) with 1 <= S < {budget}")

    if cfg.is_encdec:
        def prefill_fn(params, frames, prompt, cache):
            check(prompt)
            _expect("frames", frames, (1, cfg.enc_seq_len, cfg.d_model))
            return model.forward_prefill(params, prompt, cache, cfg, plan,
                                         lay, frames)
    else:
        def prefill_fn(params, prompt, cache):
            check(prompt)
            return model.forward_prefill(params, prompt, cache, cfg, plan,
                                         lay)

    return prefill_fn


def zero_cache_for(cfg, plan, batch: int, budget: int, device="cuda"):
    """Empty contiguous lanes for ``batch`` slots of ``budget`` tokens."""
    lay = model_layout(cfg, plan)
    return zero_cache(cache_template(cfg, plan, lay, batch, budget), device)


def make_paged_decode_step(cfg, plan, batch: int, n_max_pages: int,
                           page_size: int = 0):
    """-> decode_fn(params, cache, tokens (B, 1), pos (B,), block_table
    (B, n_max)[, slab_ids (B,)][, cross_block_table (B, n_cross)]) ->
    (logits (B, V), cache updated in place).  ``pos`` is the inclusive
    position of each row's token; idle rows point their block table at the
    scratch page with pos 0, their slab id at the scratch slab and their
    cross block table at the scratch page.  ``page_size`` sizes the cross
    block table (enc-dec archs)."""
    lay = model_layout(cfg, plan)
    n_cross = n_cross_pages(cfg, page_size) if page_size else 0

    def decode_fn(params, cache, tokens, pos, block_table, *extra):
        _expect("tokens", tokens, (batch, 1))
        _expect("pos", pos, (batch,))
        _expect("block_table", block_table, (batch, n_max_pages))
        pages = _pages(cfg, block_table, *_extra(cfg, extra), batch,
                       n_cross=n_cross)
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


def _extra(cfg, extra):
    """A paged step's trailing inputs as (slab_ids, cross_block_table):
    ``slab_ids`` first when the model has SSM layers, then the cross block
    table when it has cross-attention (JAX's order)."""
    extra = list(extra)
    prof = cache_profile(cfg)
    slab_ids = extra.pop(0) if "ssm" in prof and extra else None
    cross_bt = extra.pop(0) if "cross_kv" in prof and extra else None
    if extra:
        raise ValueError(f"arch '{cfg.name}': {len(extra)} unexpected step "
                         f"inputs")
    return slab_ids, cross_bt


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


def make_prefill_chunk_step(cfg, plan, chunk: int, n_max_pages: int,
                            page_size: int = 0):
    """-> chunk_fn(params, cache, tokens (1, C), chunk_start, last_idx,
    block_table (1, n_max)[, slab_ids (1,)][, cross_block_table (1,
    n_cross)]) -> (logits (1, V), cache updated in place).  ``chunk_start`` is the chunk's first absolute
    position and ``last_idx`` the in-chunk index of the prompt's last token
    (SSM layers leave their state untouched past it), each a (1,) int32
    tensor on the device, as JAX takes them traced (the engine's case: the
    step reads neither on the host, so one CUDA graph serves every chunk),
    or a host int, range-checked here.  The engine checks its own
    ``last_idx`` while it is still a host int."""
    lay = model_layout(cfg, plan)
    n_cross = n_cross_pages(cfg, page_size) if page_size else 0

    def chunk_fn(params, cache, tokens, chunk_start, last_idx, block_table,
                 *extra):
        _expect("tokens", tokens, (1, chunk))
        _expect("block_table", block_table, (1, n_max_pages))
        if not isinstance(last_idx, torch.Tensor) and \
                not 0 <= last_idx < chunk:
            raise ValueError(f"last_idx {last_idx} outside the chunk {chunk}")
        chunk_start = _index("chunk_start", chunk_start, tokens.device)
        last_idx = _index("last_idx", last_idx, tokens.device)
        pages = _pages(cfg, block_table, *_extra(cfg, extra), 1,
                       n_cross=n_cross)
        return model.forward_prefill_chunk(params, cache, tokens, chunk_start,
                                           last_idx, cfg, plan, lay, pages)

    return chunk_fn


def _kv_pools(cache, n_pages):
    """Every layer's self-KV pools (payloads and int8 scale rows), each
    checked to hold ``n_pages`` pages."""
    for group in cache:
        for entry in group:
            for pool in entry.get("kv", {}).values():
                if pool.shape[1] != n_pages:
                    raise ValueError(f"pool of {pool.shape[1]} pages, step "
                                     f"made for {n_pages}")
                yield pool


def make_page_copy_step(n_pages: int, n_pairs: int = 1):
    """-> copy_fn(cache, src (n,), dst (n,)) -> cache, with page ``src[i]``
    copied onto page ``dst[i]`` in every layer's self-KV pool, in place
    (n = ``n_pairs``; ``n_pages`` the pools' pages, every replica's).

    The mechanism behind copy-on-write: a slot that must append into a
    page the radix prefix cache shares first duplicates it into a private
    page (``serving.prefix_cache``), then writes only the copy.  int8 pools
    copy the payload and its scale rows together (``ksp``/``vsp`` share the
    page id).  SSM slabs (another id space) are left alone.  ``src`` and
    ``dst`` are int32 tensors on the pools' device, read there and never
    on the host, so one CUDA graph serves every pair; src == dst is the
    identity.  Plain indexed copies: the JAX package has no kernel for
    this step either (``make_page_copy_step`` there, one pair per
    replica)."""

    def copy_fn(cache, src, dst):
        _expect("src", src, (n_pairs,))
        _expect("dst", dst, (n_pairs,))
        dst = dst.long()           # index_copy_ takes int64 ids only
        for pool in _kv_pools(cache, n_pages):
            pool.index_copy_(1, dst, pool.index_select(1, src))
        return cache

    return copy_fn


def make_page_transfer_step(n_pages: int, n_lanes: int):
    """-> transfer_fn(cache, src_pages (n_lanes,), dst_pages (n_lanes,)) ->
    cache, with folded page ``src_pages[i]`` copied onto folded page
    ``dst_pages[i]`` in every layer's self-KV pool (the int8 pools' scale
    rows too, byte for byte), in place; ``n_pages`` the pools' pages,
    every replica's.

    The disaggregated engine's handoff (JAX's ``make_page_transfer_step``):
    a prefill replica's finished page run moves to freshly allocated pages
    of a decode replica, without re-running prefill.  Unused lanes go from
    the source replica's scratch page to the destination's, so several
    lanes may write the destination's scratch page: which one lands is
    undefined, and scratch bytes are never read back.  Both inputs are
    int32 tensors on the pools' device, never read on the host, so one
    CUDA graph serves every handoff.  On one device JAX's cross-shard sum
    is the identity: this is the page copy over ``n_lanes`` pairs, a
    gather and a scatter on the folded pool.  SSM slabs and cross-KV pools
    do not transfer (the engine refuses disaggregation for those archs);
    the ownership of the pages moves on the host
    (``kvcache.handoff_refs``)."""
    return make_page_copy_step(n_pages, n_lanes)


def make_cross_kv_write_step(cfg, plan, page_size: int):
    """-> write_fn(params, cache, frames (1, S_enc, E), cross_block_table
    (1, n_cross)) -> cache, its cross pools written in place.

    The enc-dec admission step (JAX's ``make_cross_kv_write_step`` at
    dp=1): run the encoder over one request's frames (any float dtype,
    cast to the weights' dtype, as JAX casts them to ``cfg.dtype``),
    project every cross-attention layer's K/V of the memory
    (``model.forward_cross_kv``) and scatter them into the ``ckp``/``cvp``
    pools: position s to page ``cross_block_table[s // page_size]``,
    offset ``s % page_size``.  int8 pools quantize each token row over its
    (heads, head_dim) values with its own scale, amax / 127, rounded half
    to even and clipped at 127 (``blocks._row_quant``, JAX's
    ``scatter_q``), payload and scale written together.  Runs once per
    encode (never on a frames-digest hit); the pages are read-only after.
    Fixed shapes: the engine captures it in a CUDA graph over static
    frames and table buffers, whose warm-up writes go to scratch page 0.
    With replicas the table's ids are folded (one encode of one replica a
    call; JAX's step encodes a row per replica, the idle ones into scratch
    pages)."""
    if "cross_kv" not in cache_profile(cfg):
        raise ValueError(f"arch '{cfg.name}' has no cross-attention layers")
    lay = model_layout(cfg, plan)
    S_enc = cfg.enc_seq_len
    n_cross = n_cross_pages(cfg, page_size)

    def write_fn(params, cache, frames, cross_bt):
        _expect("frames", frames, (1, S_enc, cfg.d_model))
        _expect("cross_block_table", cross_bt, (1, n_cross))
        enc = model.encode(params, frames.to(model.frames_dtype(params)),
                           cfg, plan, lay)
        kvs = model.forward_cross_kv(params, enc, cfg, plan, lay)
        s = torch.arange(S_enc, device=frames.device)
        pid = cross_bt[0].long().index_select(0, s // page_size)
        off = s % page_size
        for gkv, gcache in zip(kvs, cache, strict=True):
            for kv, entry in zip(gkv, gcache, strict=True):
                if kv is None:
                    continue
                cr = entry["cross"]
                for name in ("k", "v"):
                    # (reps, 1, G, S_enc, D) -> one row per position:
                    # (S_enc, reps, G, D), the order pool[:, pid, :, off]
                    # takes
                    rows = kv[name][:, 0].permute(2, 0, 1, 3)
                    pool = cr[f"c{name}p"]
                    if f"c{name}sp" in cr:
                        rows, scale = _row_quant(rows)       # (S_enc, reps)
                        cr[f"c{name}sp"][:, pid, off] = scale.t()
                    pool[:, pid, :, off] = rows.to(pool.dtype)
        return cache

    return write_fn


def zero_paged_cache_for(cfg, plan, n_pages, page_size, device="cuda",
                         n_slabs: int = 0, n_replicas: int = 1):
    """Zeroed pools of ``n_replicas`` replicas of ``n_pages`` pages (and
    ``n_slabs`` slabs), folded (``core.kvcache``)."""
    lay = model_layout(cfg, plan)
    return zero_paged_cache(
        paged_cache_template(cfg, plan, lay, n_pages, page_size, n_slabs,
                             n_replicas),
        device)
