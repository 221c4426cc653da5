"""Launchers of the Hopper decode-attention kernels: the paged ones
(``csrc/paged_decode.cu``) and the contiguous one
(``csrc/decode_attention.cu``).

Replace ``src/repro/kernels/decode_attention.py::paged_decode_attention``
(float and int8 pools), ``::paged_verify_attention`` (float and int8
pools) and ``::decode_attention`` (a contiguous cache).  See the sources
for what bounds them and how they are built; ``kernels.ops`` is the entry
point.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (32, 64, 128)
MAX_NQ = 8           # verify queries per slot the kernel holds in registers
_P, _I = ctypes.c_void_p, ctypes.c_int
_TAIL = [ctypes.c_float, _I, _P]                     # scale, dtype, stream
_ARGTYPES = {
    "repro_paged_decode": [_P] * 6 + [_I] * 5 + _TAIL,
    "repro_paged_decode_i8": [_P] * 8 + [_I] * 5 + _TAIL,
    "repro_paged_verify": [_P] * 6 + [_I] * 6 + _TAIL,
    "repro_paged_verify_i8": [_P] * 8 + [_I] * 6 + _TAIL,
    "repro_decode_attention": [_P] * 5 + [_I] * 4 + _TAIL,
}


def _check(name, q, k_pages, v_pages, block_table, length, k_scale, v_scale):
    """The checks every variant makes (q's rank is the caller's);
    -> (B, H, D, psz, n_max)."""
    quant = k_scale is not None or v_scale is not None
    build.check_cuda_tensor(q, f"{name} q", q.dim(), _DTYPES)
    pool_dt = (torch.int8,) if quant else (q.dtype,)
    build.check_cuda_tensor(k_pages, f"{name} k_pages", 4, pool_dt)
    build.check_cuda_tensor(v_pages, f"{name} v_pages", 4, pool_dt)
    build.check_cuda_tensor(block_table, f"{name} block_table", 2,
                            (torch.int32,))
    build.check_cuda_tensor(length, f"{name} length", 1, (torch.int32,))
    B, H, D = q.shape[0], q.shape[1], q.shape[-1]
    n_pages, Hk, psz, Dk = k_pages.shape
    if (Hk, Dk) != (H, D) or v_pages.shape != k_pages.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)} pools "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}: "
                         f"pool heads must equal q heads (GQA comes later)")
    if block_table.shape[0] != B or length.shape[0] != B:
        raise ValueError(f"{name}: block_table {tuple(block_table.shape)} / "
                         f"length {tuple(length.shape)} do not cover B={B}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {D} not in {HEAD_DIMS}")
    tensors = [q, k_pages, v_pages, block_table, length]
    if quant:
        for s, sname in ((k_scale, "k_scale"), (v_scale, "v_scale")):
            build.check_cuda_tensor(s, f"{name} {sname}", 2, (torch.float32,))
            if tuple(s.shape) != (n_pages, psz):
                raise ValueError(f"{name}: {sname} {tuple(s.shape)} != "
                                 f"(n_pages, psz) = {(n_pages, psz)}")
        tensors += [k_scale, v_scale]
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices {devs}")
    return B, H, D, psz, block_table.shape[1]


def _launch(symbol, q, k_pages, v_pages, block_table, length, k_scale,
            v_scale, scale, nq=None):
    B, H, D, psz, n_max = _check(symbol, q, k_pages, v_pages, block_table,
                                 length, k_scale, v_scale)
    scale = float(scale if scale is not None else D ** -0.5)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = build.kernel_function("paged_decode", symbol, _ARGTYPES[symbol])
    scales = [] if k_scale is None else [k_scale.data_ptr(),
                                         v_scale.data_ptr()]
    dims = [B, H] + ([] if nq is None else [nq]) + [D, psz, n_max]
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), *scales,
                block_table.data_ptr(), length.data_ptr(), out.data_ptr(),
                *dims, scale, build.dtype_code(q.dtype), build.stream_of(q))
    build.check_launch(rc, symbol)
    return out


def paged_decode_attention(q, k_pages, v_pages, block_table, length, *,
                           scale=None, k_scale=None, v_scale=None):
    """q: (B, H, D); k_pages/v_pages: (n_pages, H, psz, D) in q's dtype, or
    int8 with ``k_scale``/``v_scale`` (n_pages, psz) float32; block_table:
    (B, n_max) int32; length: (B,) int32 valid-token counts (``pos + 1``,
    not the inclusive position) -> (B, H, D) in q's dtype."""
    if q.dim() != 3:
        raise ValueError(f"paged_decode: q {tuple(q.shape)} is not (B, H, D)")
    symbol = "repro_paged_decode" if k_scale is None else \
        "repro_paged_decode_i8"
    return _launch(symbol, q, k_pages, v_pages, block_table, length,
                   k_scale, v_scale, scale)


def paged_verify_attention(q, k_pages, v_pages, block_table, length, *,
                           scale=None, k_scale=None, v_scale=None):
    """q: (B, H, Q, D) with Q <= 8, query i of slot b at position
    ``length[b] - 1 + i`` seeing keys ``kpos < length[b] + i``; pools,
    scales, block_table and length as in ``paged_decode_attention``
    -> (B, H, Q, D) in q's dtype."""
    if q.dim() != 4 or not 1 <= q.shape[2] <= MAX_NQ:
        raise ValueError(f"paged_verify: q {tuple(q.shape)} is not (B, H, Q, "
                         f"D) with 1 <= Q <= {MAX_NQ}")
    symbol = "repro_paged_verify" if k_scale is None else \
        "repro_paged_verify_i8"
    return _launch(symbol, q, k_pages, v_pages, block_table, length,
                   k_scale, v_scale, scale, nq=q.shape[2])


def decode_attention(q, k, v, length, *, scale=None):
    """q: (B, H, D); k/v: (B, H, S, D) in q's dtype; length: (B,) int32
    valid-key counts (``pos + 1``; keys at or past it are never read)
    -> (B, H, D) in q's dtype."""
    name = "decode_attention"
    build.check_cuda_tensor(q, f"{name} q", 3, _DTYPES)
    build.check_cuda_tensor(k, f"{name} k", 4, (q.dtype,))
    build.check_cuda_tensor(v, f"{name} v", 4, (q.dtype,))
    build.check_cuda_tensor(length, f"{name} length", 1, (torch.int32,))
    B, H, D = q.shape
    S = k.shape[2]
    if tuple(k.shape) != (B, H, S, D) or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)}: k/v must be (B, H, S, D) with "
                         f"q's B, H and D (GQA comes later)")
    if length.shape[0] != B:
        raise ValueError(f"{name}: length {tuple(length.shape)} does not "
                         f"cover B={B}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {D} not in {HEAD_DIMS}")
    if len({t.device for t in (q, k, v, length)}) != 1:
        raise ValueError(f"{name}: tensors on several devices")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"{name}: k and v must be 16-byte aligned (the "
                         f"kernel reads key rows with 16-byte loads)")
    scale = float(scale if scale is not None else D ** -0.5)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = build.kernel_function(name, "repro_decode_attention",
                               _ARGTYPES["repro_decode_attention"])
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
                out.data_ptr(), B, H, S, D, scale, build.dtype_code(q.dtype),
                build.stream_of(q))
    build.check_launch(rc, name)
    return out
