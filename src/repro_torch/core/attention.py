"""Attention: prefill-chunk flash attention and paged single-token decode.

Port of the JAX package's ``core/attention.py``, same grouped-GQA layout:

    q: (B, G, R, Sq, D)  — G kv slots, R q heads per slot
    k/v: (B, G, Skv, D)

On CPU tensors these are plain PyTorch (the oracle the tests hold against
JAX).  On CUDA tensors ``flash_attention`` and ``paged_decode_attention``
launch the Hopper kernels through ``kernels.ops``; the kernels take one kv
head per q head (R == 1) and no sliding window in decode, and anything
else raises until the slice that ports GQA and windows.
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
    ``q_offset + i``, key j at ``kv_offset + j``."""
    B, G, R, Sq, D = q.shape
    Skv = k.shape[2]
    if q.is_cuda:
        if B != 1 or R != 1 or kv_offset != 0:
            raise NotImplementedError(
                f"the flash-attention kernel takes one sequence with one kv "
                f"head per q head and kv_offset 0 (got B={B}, R={R}, "
                f"kv_offset={kv_offset}); GQA comes with a later slice")
        out = ops.flash_attention(q[0, :, 0].contiguous(), k[0].contiguous(),
                                  v[0].contiguous(), causal=causal,
                                  window=window, scale=scale,
                                  q_offset=int(q_offset))
        return out[None, :, None]
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
                     scale=None):
    """q: (B, G, R, D); caches: (B, G, S_slots, D); slot_pos: (B, S_slots)
    absolute position held by each slot (-1 = empty); cur_pos: (B,)."""
    B, G, R, D = q.shape
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


def paged_decode_attention(q, k_pool, v_pool, block_table, cur_pos, *,
                           window=0, scale=None):
    """Decode attention through a block table.  q: (B, G, R, D); pools:
    (n_pages, G, psz, D); block_table: (B, n_max); cur_pos: (B,) the
    INCLUSIVE position of the current token (the kernel takes the count
    ``cur_pos + 1``)."""
    B, G, R, D = q.shape
    if q.is_cuda:
        if R != 1 or window > 0:
            raise NotImplementedError(
                f"the paged-decode kernel takes one kv head per q head and "
                f"no window (got R={R}, window={window}); GQA and windows "
                f"come with a later slice")
        length = (cur_pos + 1).to(torch.int32)
        out = ops.paged_decode_attention(q[:, :, 0].contiguous(), k_pool,
                                         v_pool, block_table, length,
                                         scale=scale)
        return out[:, :, None]
    L = block_table.shape[1] * k_pool.shape[2]
    kv_pos = torch.arange(L, dtype=torch.int32, device=q.device).expand(B, L)
    return decode_attention(q, gather_pages(k_pool, block_table),
                            gather_pages(v_pool, block_table), kv_pos,
                            cur_pos, window=window, scale=scale)
