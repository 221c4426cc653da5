"""Plain PyTorch versions of the kernels on the paged-serving paths.

Each ``ref_*`` is the function its Hopper kernel computes, with the Pallas
kernel's contract and shapes, and no tiling.  ``kernels.ops`` runs these on
CPU tensors; ``chip_smoke.py`` holds every kernel against them on the card.
All arithmetic is float32, cast back to the input dtype at the end.  A row
with no valid key (fully masked) yields zeros, as the kernels do.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG = -1e30


def ref_matmul(a, b, trans_b: bool = False):
    """a: (M, K) @ b: (K, N), or b: (N, K) when ``trans_b`` -> (M, N) in
    a.dtype, with a float32 accumulator."""
    bf = b.float().t() if trans_b else b.float()
    return torch.matmul(a.float(), bf).to(a.dtype)


def ref_rmsnorm(x, scale, eps: float = 1e-6):
    """x: (T, E); scale: (E,) -> x * rsqrt(mean(x^2) + eps) * (1 + scale)."""
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * (1.0 + scale.float())).to(x.dtype)


def ref_rmsnorm_residual(x, r, scale, eps: float = 1e-6):
    """x, r: (T, E); scale: (E,) -> (s = x + r, ref_rmsnorm(s)): the
    residual add before a norm, s in PyTorch's own rounding."""
    s = x + r
    return s, ref_rmsnorm(s, scale, eps)


def ref_rmsnorm_gated(y, z, scale, eps: float = 1e-6, out_dtype=None):
    """y, z: (T, E); scale: (E,) -> ref_rmsnorm(y * silu(float(z))) in
    float32, cast to ``out_dtype`` (default float32): mamba2's gated norm."""
    g = y * F.silu(z.float())
    return ref_rmsnorm(g, scale, eps).to(out_dtype or torch.float32)


def _masked_softmax_av(s, mask, v):
    """softmax over the last axis restricted to ``mask``, times v; rows with
    no valid entry give zeros."""
    s = torch.where(mask, s, torch.full_like(s, NEG))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * mask
    den = p.sum(dim=-1, keepdim=True)
    return torch.matmul(p, v.float()) / den.clamp_min(1e-20)


def ref_flash_attention(q, k, v, causal: bool = True, window: int = 0,
                        scale=None, q_offset=None):
    """q: (H, Sq, D), k/v: (H, Skv, D) -> (H, Sq, D).

    Query row i sits at position ``q_offset + i`` and key j at position j.
    ``q_offset`` (an int or a one-element tensor) defaults to ``Skv - Sq``:
    the Pallas contract, where the queries are the suffix of the key
    stream."""
    H, Sq, D = q.shape
    Skv = k.shape[1]
    scale = scale if scale is not None else D ** -0.5
    q_offset = Skv - Sq if q_offset is None else q_offset
    s = torch.einsum("hqd,hkd->hqk", q.float(), k.float()) * scale
    qp = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kp = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window > 0:
        mask &= kp > qp - window
    return _masked_softmax_av(s, mask[None], v).to(q.dtype)


def ref_dequant_pool(pool, scales):
    """An int8 page pool through its per-(page, row) scales, in float32.
    pool: (n_pages, H, psz, D) int8; scales: (n_pages, psz) float32."""
    return pool.float() * scales[:, None, :, None]


def ref_paged_verify_attention(q, k_pages, v_pages, block_table, length,
                               scale=None, k_scale=None, v_scale=None):
    """Q queries per (slot, head) over the slot's block-table pages.

    q: (B, H, Q, D); k_pages/v_pages: (n_pages, H, psz, D), float or int8
    with ``k_scale``/``v_scale`` (n_pages, psz) float32 (dequantised in
    float32, as the Pallas i8 kernels do); block_table: (B, n_max) int32
    page ids; length: (B,) int32 count of valid tokens ahead of query 0.
    Query i sees positions < length + i -> (B, H, Q, D) in q's dtype."""
    B, H, Q, D = q.shape
    psz = k_pages.shape[2]
    n_max = block_table.shape[1]
    scale = scale if scale is not None else D ** -0.5
    ids = block_table.reshape(-1).long()
    if k_scale is not None:
        k_pages = ref_dequant_pool(k_pages, k_scale)
        v_pages = ref_dequant_pool(v_pages, v_scale)

    def gather(pool):                                 # -> (B, H, n_max*psz, D)
        g = pool[ids].reshape(B, n_max, H, psz, D)
        return g.permute(0, 2, 1, 3, 4).reshape(B, H, n_max * psz, D)

    k, v = gather(k_pages), gather(v_pages)
    s = torch.einsum("bhqd,bhsd->bhqs", q.float(), k.float()) * scale
    kpos = torch.arange(n_max * psz, device=q.device)
    see = length.to(q.device).long()[:, None] + \
        torch.arange(Q, device=q.device)[None, :]               # (B, Q)
    mask = (kpos[None, None, :] < see[:, :, None])[:, None]     # (B, 1, Q, L)
    return _masked_softmax_av(s, mask, v).to(q.dtype)


def ref_paged_decode_attention(q, k_pages, v_pages, block_table, length,
                               scale=None, k_scale=None, v_scale=None):
    """One query per (slot, head): ``ref_paged_verify_attention`` with
    Q = 1.  q: (B, H, D) -> (B, H, D); positions < length attend."""
    return ref_paged_verify_attention(q[:, :, None], k_pages, v_pages,
                                      block_table, length, scale, k_scale,
                                      v_scale)[:, :, 0]


def ref_decode_attention(q, k, v, length, scale=None):
    """One query per (row, head) over a contiguous cache, keys at positions
    < length.  q: (B, H, D); k/v: (B, H, S, D); length: (B,) int32 valid-key
    counts -> (B, H, D) in q's dtype.  A row with length 0 gives zeros, as
    the Pallas kernel does (JAX's ``ref_decode_attention`` returns the mean
    of V there: its softmax runs over all-masked scores)."""
    B, H, D = q.shape
    S = k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    s = torch.einsum("bhd,bhsd->bhs", q.float(), k.float())[:, :, None] * scale
    mask = torch.arange(S, device=q.device)[None, :] < \
        length.to(q.device).long()[:, None]                      # (B, S)
    return _masked_softmax_av(s, mask[:, None, None], v)[:, :, 0].to(q.dtype)


def ref_decode_attention_i8(q, k, v, length, kv_scale, scale=None):
    """``ref_decode_attention`` over int8 lanes k/v (B, H, S, D) at one
    fixed dequantization scale ``kv_scale`` (a float), dequantized in
    float32."""
    return ref_decode_attention(q, k.float() * kv_scale, v.float() * kv_scale,
                                length, scale)


def ref_dequant_state(state, scales):
    """An int8 SSD state slab through its per-head scales, in float32.
    state: (..., H, P, N) int8; scales: (..., H) float32."""
    return state.float() * scales[..., None, None]


def ref_ssd_scan(x, dt, B, C, A, state0=None):
    """The SSD recurrence one token at a time (JAX ``ref_ssd_scan`` with a
    leading batch axis): h_t = exp(dt_t A) h_{t-1} + dt_t x_t (x) B_t and
    y_t = C_t . h_t.

    x: (Bt, S, H, P); dt: (Bt, S, H) float32; B/C: (Bt, S, N); A: (H,)
    negative; state0: (Bt, H, P, N) float32 or None (zeros).  No ``D``
    skip term.  -> (y (Bt, S, H, P) in x's dtype, final state (Bt, H, P, N)
    float32)."""
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    Af = A.float()
    h = torch.zeros((Bt, H, P, N), dtype=torch.float32, device=x.device) \
        if state0 is None else state0.float()
    ys = []
    for t in range(S):
        dec = torch.exp(dtf[:, t] * Af)                          # (Bt, H)
        u = dtf[:, t, :, None] * xf[:, t]                        # (Bt, H, P)
        h = h * dec[:, :, None, None] + u[..., None] * Bf[:, t, None, None, :]
        ys.append(torch.einsum("bn,bhpn->bhp", Cf[:, t], h))
    return torch.stack(ys, dim=1).to(x.dtype), h
