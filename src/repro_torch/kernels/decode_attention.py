"""Launcher of the Hopper paged-decode kernel (``csrc/paged_decode.cu``).

Replaces ``src/repro/kernels/decode_attention.py::paged_decode_attention``
for float pools.  See the source for what bounds it and how it is built;
``kernels.ops`` is the entry point.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (32, 64, 128)
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float]
             + [ctypes.c_int, ctypes.c_void_p])


def paged_decode_attention(q, k_pages, v_pages, block_table, length, *,
                           scale=None):
    """q: (B, H, D); k_pages/v_pages: (n_pages, H, psz, D) in q's dtype;
    block_table: (B, n_max) int32; length: (B,) int32 valid-token counts
    (``pos + 1``, not the inclusive position) -> (B, H, D)."""
    build.check_cuda_tensor(q, "paged_decode q", 3, _DTYPES)
    build.check_cuda_tensor(k_pages, "paged_decode k_pages", 4, (q.dtype,))
    build.check_cuda_tensor(v_pages, "paged_decode v_pages", 4, (q.dtype,))
    build.check_cuda_tensor(block_table, "paged_decode block_table", 2,
                            (torch.int32,))
    build.check_cuda_tensor(length, "paged_decode length", 1, (torch.int32,))
    B, H, D = q.shape
    n_pages, Hk, psz, Dk = k_pages.shape
    if (Hk, Dk) != (H, D) or v_pages.shape != k_pages.shape:
        raise ValueError(f"paged_decode: q {tuple(q.shape)} pools "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}: "
                         f"pool heads must equal q heads (GQA comes later)")
    if block_table.shape[0] != B or length.shape[0] != B:
        raise ValueError(f"paged_decode: block_table {tuple(block_table.shape)}"
                         f" / length {tuple(length.shape)} do not cover B={B}")
    if D not in HEAD_DIMS:
        raise ValueError(f"paged_decode: head_dim {D} not in {HEAD_DIMS}")
    devs = {t.device for t in (q, k_pages, v_pages, block_table, length)}
    if len(devs) != 1:
        raise ValueError(f"paged_decode: tensors on several devices {devs}")
    scale = float(scale if scale is not None else D ** -0.5)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = build.kernel_function("paged_decode", "repro_paged_decode",
                               _ARGTYPES)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                block_table.data_ptr(), length.data_ptr(), out.data_ptr(),
                B, H, D, psz, block_table.shape[1], scale,
                build.dtype_code(q.dtype), build.stream_of(q))
    build.check_launch(rc, "paged_decode_attention")
    return out
