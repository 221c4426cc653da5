"""Dispatch over the kernels of the serving paths: rmsnorm (alone, with
the residual add before it, or as mamba2's gated norm), matmul, flash
attention, paged decode and verify attention over float or int8 pools,
the SSD scan from a float or an int8 state, and decode attention over a
contiguous cache of float or fixed-scale int8 lanes (thirteen kernel
variants in all).

On a CPU tensor each wrapper runs its kernel's plain PyTorch version
(``kernels.ref``); on a CUDA tensor it launches the Hopper kernel or
raises.  Nothing falls back: a kernel that does not build or launch is an
error, never a silent detour through the plain version.

Each kernel variant has its own wrapper with a plain integer ``launches``,
raised by one exactly where it launches its kernel (an empty output
launches none), so a run can show that it went through every kernel
(``launch_counts`` / ``reset_launch_counts``).  A CUDA graph of a step
(``core.graphs``) launches again, at every replay, each kernel its capture
recorded: the capture counts nothing and each replay adds the captured
call's counts (``add_launches``), so the counts stay the kernels that ran.
``paged_decode_attention`` and ``paged_verify_attention`` hand int8 pools
(``k_scale``/``v_scale`` given) to their ``_i8`` twins, and
``decode_attention`` int8 lanes (``kv_scale`` given) to
``decode_attention_i8``; ``ssd_scan_i8`` takes the int8 state slab and its
per-head scales.
"""
from __future__ import annotations

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import matmul as _matmul
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rmsnorm
from repro_torch.kernels import ssd_scan as _ssd


def rmsnorm(x, scale, eps: float = 1e-6):
    """x: (T, E); scale: (E,) -> x * rsqrt(mean(x^2) + eps) * (1 + scale)."""
    if x.device.type == "cpu":
        return ref.ref_rmsnorm(x, scale, eps)
    out = _rmsnorm.rmsnorm(x, scale, eps)
    if out.numel():
        rmsnorm.launches += 1
    return out


def rmsnorm_residual(x, r, scale, eps: float = 1e-6):
    """x, r: (T, E); scale: (E,) -> (s = x + r, rmsnorm(s)), both in
    x.dtype: the residual add fused into the norm after it."""
    if x.device.type == "cpu":
        return ref.ref_rmsnorm_residual(x, r, scale, eps)
    s, y = _rmsnorm.rmsnorm_residual(x, r, scale, eps)
    if y.numel():
        rmsnorm_residual.launches += 1
    return s, y


def rmsnorm_gated(y, z, scale, eps: float = 1e-6, out_dtype=None):
    """y, z: (T, E); scale: (E,) -> rmsnorm(y * silu(float(z))) in
    float32, cast to ``out_dtype`` (default float32): mamba2's gated
    norm."""
    if y.device.type == "cpu":
        return ref.ref_rmsnorm_gated(y, z, scale, eps, out_dtype)
    out = _rmsnorm.rmsnorm_gated(y, z, scale, eps, out_dtype)
    if out.numel():
        rmsnorm_gated.launches += 1
    return out


def matmul(a, b, *, trans_b: bool = False):
    """a: (M, K) @ b: (K, N), or b: (N, K) when ``trans_b`` -> (M, N) in
    a.dtype with a float32 accumulator."""
    if a.device.type == "cpu":
        return ref.ref_matmul(a, b, trans_b)
    out = _matmul.matmul(a, b, trans_b=trans_b)
    if out.numel():
        matmul.launches += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale=None, q_offset=None):
    """q: (H, Sq, D); k/v: (H, Skv, D) -> (H, Sq, D); query i at position
    ``q_offset + i`` (default ``Skv - Sq``: queries are the kv suffix).
    ``q_offset``: an int, or a one-element int32 tensor on q's device (the
    prefill chunk's per-tick offset, which the kernel reads there)."""
    if q.device.type == "cpu":
        return ref.ref_flash_attention(q, k, v, causal=causal, window=window,
                                       scale=scale, q_offset=q_offset)
    out = _flash.flash_attention(q, k, v, causal=causal, window=window,
                                 scale=scale, q_offset=q_offset)
    if out.numel():
        flash_attention.launches += 1
    return out


def paged_decode_attention(q, k_pages, v_pages, block_table, length, *,
                           scale=None, k_scale=None, v_scale=None):
    """q: (B, H, D) over pools (n_pages, H, psz, D) through block_table
    (B, n_max); ``length`` (B,) counts valid tokens -> (B, H, D).  Pools
    in q's dtype, or int8 with ``k_scale``/``v_scale`` (n_pages, psz)."""
    if k_scale is not None:
        return paged_decode_attention_i8(q, k_pages, v_pages, block_table,
                                         length, k_scale, v_scale,
                                         scale=scale)
    if q.device.type == "cpu":
        return ref.ref_paged_decode_attention(q, k_pages, v_pages,
                                              block_table, length, scale)
    out = _decode.paged_decode_attention(q, k_pages, v_pages, block_table,
                                         length, scale=scale)
    if out.numel():
        paged_decode_attention.launches += 1
    return out


def paged_decode_attention_i8(q, k_pages, v_pages, block_table, length,
                              k_scale, v_scale, *, scale=None):
    """``paged_decode_attention`` over int8 pools, dequantised on read."""
    if q.device.type == "cpu":
        return ref.ref_paged_decode_attention(q, k_pages, v_pages,
                                              block_table, length, scale,
                                              k_scale, v_scale)
    out = _decode.paged_decode_attention(q, k_pages, v_pages, block_table,
                                         length, scale=scale,
                                         k_scale=k_scale, v_scale=v_scale)
    if out.numel():
        paged_decode_attention_i8.launches += 1
    return out


def paged_verify_attention(q, k_pages, v_pages, block_table, length, *,
                           scale=None, k_scale=None, v_scale=None):
    """q: (B, H, Q, D), query i at ``length - 1 + i`` seeing positions
    ``< length + i``; pools, scales, block_table and length as in
    ``paged_decode_attention`` -> (B, H, Q, D)."""
    if k_scale is not None:
        return paged_verify_attention_i8(q, k_pages, v_pages, block_table,
                                         length, k_scale, v_scale,
                                         scale=scale)
    if q.device.type == "cpu":
        return ref.ref_paged_verify_attention(q, k_pages, v_pages,
                                              block_table, length, scale)
    out = _decode.paged_verify_attention(q, k_pages, v_pages, block_table,
                                         length, scale=scale)
    if out.numel():
        paged_verify_attention.launches += 1
    return out


def paged_verify_attention_i8(q, k_pages, v_pages, block_table, length,
                              k_scale, v_scale, *, scale=None):
    """``paged_verify_attention`` over int8 pools, dequantised on read."""
    if q.device.type == "cpu":
        return ref.ref_paged_verify_attention(q, k_pages, v_pages,
                                              block_table, length, scale,
                                              k_scale, v_scale)
    out = _decode.paged_verify_attention(q, k_pages, v_pages, block_table,
                                         length, scale=scale,
                                         k_scale=k_scale, v_scale=v_scale)
    if out.numel():
        paged_verify_attention_i8.launches += 1
    return out


def ssd_scan(x, dt, B, C, A, state0=None):
    """x: (Bt, S, H, P); dt: (Bt, S, H) float32; B/C: (Bt, S, N); A: (H,);
    state0: (Bt, H, P, N) float32 or None (zeros) -> (y (Bt, S, H, P) in
    x's dtype without the D term, final state (Bt, H, P, N) float32)."""
    if x.device.type == "cpu":
        return ref.ref_ssd_scan(x, dt, B, C, A, state0)
    out = _ssd.ssd_scan(x, dt, B, C, A, state0=state0)
    ssd_scan.launches += 1
    return out


def ssd_scan_i8(x, dt, B, C, A, state0, state0_scale):
    """``ssd_scan`` seeded from an int8 state slab (Bt, H, P, N) and its
    (Bt, H) float32 scales, dequantized in float32."""
    if x.device.type == "cpu":
        return ref.ref_ssd_scan(x, dt, B, C, A,
                                ref.ref_dequant_state(state0, state0_scale))
    out = _ssd.ssd_scan(x, dt, B, C, A, state0=state0,
                        state0_scale=state0_scale)
    ssd_scan_i8.launches += 1
    return out


def decode_attention(q, k, v, length, *, scale=None, kv_scale=None):
    """q: (B, H, D) over a contiguous cache k/v (B, H, S, D) in q's dtype,
    or int8 lanes read at the fixed dequantization scale ``kv_scale``;
    ``length`` (B,) int32 counts valid keys (``pos + 1``) -> (B, H, D)."""
    if kv_scale is not None:
        return decode_attention_i8(q, k, v, length, kv_scale, scale=scale)
    if q.device.type == "cpu":
        return ref.ref_decode_attention(q, k, v, length, scale)
    out = _decode.decode_attention(q, k, v, length, scale=scale)
    if out.numel():
        decode_attention.launches += 1
    return out


def decode_attention_i8(q, k, v, length, kv_scale, *, scale=None):
    """``decode_attention`` over int8 lanes k/v (B, H, S, D) whose values
    times ``kv_scale`` (a float) are the keys and values."""
    if q.device.type == "cpu":
        return ref.ref_decode_attention_i8(q, k, v, length, kv_scale, scale)
    out = _decode.decode_attention(q, k, v, length, scale=scale,
                                   kv_scale=kv_scale)
    if out.numel():
        decode_attention_i8.launches += 1
    return out


WRAPPERS = (rmsnorm, rmsnorm_residual, rmsnorm_gated, matmul,
            flash_attention, paged_decode_attention,
            paged_decode_attention_i8, paged_verify_attention,
            paged_verify_attention_i8, ssd_scan, ssd_scan_i8,
            decode_attention, decode_attention_i8)
for _w in WRAPPERS:
    _w.launches = 0


def launch_counts() -> dict:
    return {w.__name__: w.launches for w in WRAPPERS}


def reset_launch_counts():
    for w in WRAPPERS:
        w.launches = 0


def set_launch_counts(counts: dict):
    for w in WRAPPERS:
        w.launches = counts[w.__name__]


def add_launches(counts: dict):
    """One replay of a captured call that launched ``counts`` kernels."""
    for w in WRAPPERS:
        w.launches += counts.get(w.__name__, 0)
