"""Attention: flash attention (a whole prompt or a prefill chunk),
single-token decode over a contiguous cache or through a block table, and
paged speculative verify (Q queries per slot), over float or int8 pools.

Port of the JAX package's ``core/attention.py``, same grouped-GQA layout:

    q: (B, G, R, Sq, D)  — G kv slots, R q heads per slot
    k/v: (B, G, Skv, D)

On CPU tensors these are plain PyTorch (the oracle the tests hold against
JAX).  On CUDA tensors every function here launches a Hopper kernel
through ``kernels.ops``, q's (G, R) heads flattened to G R heads, so q head
g R + r reads kv head g, as the grouping here does.  Flash, paged decode
and verify take the sliding window as the plain versions do; verify takes
at most 16 query rows (R x Q) per kv head, which the kernel's plan
enforces; anything else raises.

Convention: these functions take the INCLUSIVE position ``cur_pos`` of the
current token (query i of verify sits at ``cur_pos + i`` and sees
``kv_pos <= cur_pos + i``); the decode kernels take the count of valid
tokens ``length = cur_pos + 1``.  The conversion happens here and nowhere
else.

The contiguous decode kernel masks by a prefix length, not by the lane's
``slot_pos``; the two agree for a ring of W slots (the budget, or a
sliding window shorter than it) with length ``min(cur_pos + 1, W)``:
before the ring wraps, slots [0, cur_pos] hold positions 0..cur_pos of
this request; after it, the W slots hold exactly (cur_pos - W, cur_pos],
all inside a window of W; and a ring of the budget never wraps, the
engine retiring a slot before its position reaches it (so a window longer
than the ring never bites).  Only the order of the softmax sum differs
from JAX's.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

NEG = -1e30


def _masked_exp(s, valid):
    """JAX's ``_online_chunk`` for one chunk: unnormalized weights
    ``exp(s - max)`` over the valid entries (0 elsewhere) and their sum.
    Callers cast the weights to v's dtype before the float32 weighted sum,
    as JAX does."""
    s = torch.where(valid, s, torch.full_like(s, NEG))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * valid
    den = p.sum(dim=-1)
    return p, den


def flash_attention(q, k, v, *, causal=True, window=0, scale=None,
                    q_offset=0, kv_offset=0):
    """Returns (B, G, R, Sq, D) in q.dtype.  Query i sits at position
    ``q_offset + i``, key j at ``kv_offset + j``; ``q_offset`` is an int or
    a one-element int32 tensor on q's device (read there by the kernel)."""
    B, G, R, Sq, D = q.shape
    Skv = k.shape[2]
    if q.is_cuda:
        if B != 1 or kv_offset != 0:
            raise NotImplementedError(
                f"the flash-attention kernel takes one sequence and "
                f"kv_offset 0 (got B={B}, kv_offset={kv_offset})")
        out = ops.flash_attention(q[0].reshape(G * R, Sq, D).contiguous(),
                                  k[0].contiguous(), v[0].contiguous(),
                                  causal=causal, window=window, scale=scale,
                                  q_offset=q_offset)
        return out.reshape(1, G, R, Sq, D)
    scale = scale if scale is not None else D ** -0.5
    s = torch.einsum("bgrsd,bgcd->bgrsc", q.float(), k.float()) * scale
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    kv_pos = kv_offset + torch.arange(Skv, device=q.device)
    valid = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        valid &= kv_pos[None, :] <= q_pos[:, None]
    if window > 0:
        valid &= kv_pos[None, :] > q_pos[:, None] - window
    p, den = _masked_exp(s, valid)
    acc = torch.einsum("bgrsc,bgcd->bgrsd", p.to(v.dtype).float(), v.float())
    return (acc / den.clamp_min(1e-20)[..., None]).to(q.dtype)


def decode_attention(q, k_cache, v_cache, slot_pos, cur_pos, *, window=0,
                     scale=None, kv_scale=None):
    """q: (B, G, R, D); caches: (B, G, S_slots, D); slot_pos: (B, S_slots)
    absolute position held by each slot (-1 = empty); cur_pos: (B,).  On the
    card the kernel reads slots [0, min(cur_pos + 1, S_slots)) (module
    docstring: a window's ring needs no more), and takes int8 caches as
    they are stored, with their fixed dequantization scale ``kv_scale``;
    the plain path takes caches in q's dtype."""
    B, G, R, D = q.shape
    if q.is_cuda:
        length = torch.clamp(cur_pos + 1, max=k_cache.shape[2])
        out = ops.decode_attention(q.reshape(B, G * R, D).contiguous(),
                                   k_cache, v_cache, length.to(torch.int32),
                                   scale=scale, kv_scale=kv_scale)
        return out.reshape(B, G, R, D)
    if kv_scale is not None:
        raise ValueError("decode_attention: the plain path takes caches "
                         "dequantized to q's dtype, not kv_scale")
    scale = scale if scale is not None else D ** -0.5
    s = torch.einsum("bgrd,bgsd->bgrs", q.float(), k_cache.float()) * scale
    valid = (slot_pos >= 0) & (slot_pos <= cur_pos[:, None])
    if window > 0:
        valid &= slot_pos > (cur_pos[:, None] - window)
    p, den = _masked_exp(s, valid[:, None, None, :])
    acc = torch.einsum("bgrs,bgsd->bgrd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return (acc / den.clamp_min(1e-20)[..., None]).to(q.dtype)


def gather_pages(pool, block_table):
    """Each slot's logical KV stream from the page pool.
    pool: (n_pages, G, psz, D); block_table: (B, n_max) -> (B, G, n_max*psz, D)."""
    n_pages, G, psz, D = pool.shape
    B, n_max = block_table.shape
    g = pool[block_table.reshape(-1).long()].reshape(B, n_max, G, psz, D)
    return g.permute(0, 2, 1, 3, 4).reshape(B, G, n_max * psz, D)


def gather_pages_dequant(pool, scales, block_table, dtype):
    """``gather_pages`` for an int8 pool with per-(page, row) scales.
    pool: (n_pages, G, psz, D) int8; scales: (n_pages, psz) float32
    -> (B, G, n_max * psz, D) in ``dtype``."""
    B, n_max = block_table.shape
    psz = pool.shape[2]
    g = gather_pages(pool, block_table).float()
    s = scales[block_table.reshape(-1).long()].reshape(B, 1, n_max * psz, 1)
    return (g * s).to(dtype)


def gather_kv(k_pool, v_pool, block_table, dtype, k_scale=None, v_scale=None):
    """Both pools' logical streams, (B, G, n_max * psz, D) each: int8 pools
    (``k_scale`` given) are dequantized to ``dtype``, float pools are
    gathered as stored."""
    if k_scale is not None:
        return (gather_pages_dequant(k_pool, k_scale, block_table, dtype),
                gather_pages_dequant(v_pool, v_scale, block_table, dtype))
    return gather_pages(k_pool, block_table), gather_pages(v_pool, block_table)


def paged_decode_attention(q, k_pool, v_pool, block_table, cur_pos, *,
                           window=0, scale=None, k_scale=None, v_scale=None):
    """Decode attention through a block table.  q: (B, G, R, D); pools:
    (n_pages, G, psz, D); block_table: (B, n_max); cur_pos: (B,) the
    INCLUSIVE position of the current token, seeing ``kv_pos <= cur_pos``
    (and ``> cur_pos - window`` with a window).  ``k_scale``/``v_scale``
    ((n_pages, psz) float32): int8 pools, dequantized on read."""
    B, G, R, D = q.shape
    if q.is_cuda:
        out = ops.paged_decode_attention(
            q.reshape(B, G * R, D).contiguous(), k_pool, v_pool, block_table,
            (cur_pos + 1).to(torch.int32), scale=scale, k_scale=k_scale,
            v_scale=v_scale, window=window)
        return out.reshape(B, G, R, D)
    L = block_table.shape[1] * k_pool.shape[2]
    kv_pos = torch.arange(L, dtype=torch.int32, device=q.device).expand(B, L)
    kf, vf = gather_kv(k_pool, v_pool, block_table, q.dtype, k_scale, v_scale)
    return decode_attention(q, kf, vf, kv_pos, cur_pos, window=window,
                            scale=scale)


def paged_verify_attention(q, k_pool, v_pool, block_table, cur_pos, *,
                           window=0, scale=None, k_scale=None, v_scale=None):
    """Q-query decode attention for speculative verify.  q: (B, G, R, Q, D)
    — query i of a slot sits at ``cur_pos + i`` (query 0 is the last
    accepted token, the rest are drafts whose KV is already written) and
    sees ``kv_pos <= cur_pos + i``.  Pools, block_table and scales as in
    ``paged_decode_attention``; cur_pos: (B,) -> (B, G, R, Q, D)."""
    B, G, R, Q, D = q.shape
    if q.is_cuda:
        out = ops.paged_verify_attention(
            q.reshape(B, G * R, Q, D).contiguous(), k_pool, v_pool, block_table,
            (cur_pos + 1).to(torch.int32), scale=scale, k_scale=k_scale,
            v_scale=v_scale, window=window)
        return out.reshape(B, G, R, Q, D)
    scale = scale if scale is not None else D ** -0.5
    L = block_table.shape[1] * k_pool.shape[2]
    kf, vf = gather_kv(k_pool, v_pool, block_table, q.dtype, k_scale, v_scale)
    s = torch.einsum("bgrqd,bgsd->bgrqs", q.float(), kf.float()) * scale
    kv_pos = torch.arange(L, device=q.device)[None, None, :]            # (1,1,L)
    q_pos = cur_pos.long()[:, None, None] + \
        torch.arange(Q, device=q.device)[None, :, None]                  # (B,Q,1)
    valid = kv_pos <= q_pos                                             # (B,Q,L)
    if window > 0:
        valid &= kv_pos > q_pos - window
    p, den = _masked_exp(s, valid[:, None, None])
    acc = torch.einsum("bgrqs,bgsd->bgrqd", p.to(vf.dtype).float(), vf.float())
    return (acc / den.clamp_min(1e-20)[..., None]).to(q.dtype)
