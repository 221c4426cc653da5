"""Launcher of the Hopper flash-attention kernel
(``csrc/flash_attention.cu``).

Replaces ``src/repro/kernels/flash_attention.py::flash_attention``.  See the
source for what bounds it and how it is built; ``kernels.ops`` is the
entry point.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (32, 64, 128)
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float]
             + [ctypes.c_int, ctypes.c_void_p])


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale=None, q_offset=None):
    """q: (H, Sq, D); k/v: (H, Skv, D), one kv head per q head -> (H, Sq, D).
    Query row i sits at position ``q_offset + i`` (default ``Skv - Sq``)."""
    build.check_cuda_tensor(q, "flash_attention q", 3, _DTYPES)
    build.check_cuda_tensor(k, "flash_attention k", 3, (q.dtype,))
    build.check_cuda_tensor(v, "flash_attention v", 3, (q.dtype,))
    H, Sq, D = q.shape
    Skv = k.shape[1]
    if k.shape != (H, Skv, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}: k/v must be "
                         f"(H, Skv, D) with H == q heads (GQA comes later)")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} not in {HEAD_DIMS}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    scale = float(scale if scale is not None else D ** -0.5)
    q_offset = Skv - Sq if q_offset is None else int(q_offset)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = build.kernel_function("flash_attention", "repro_flash_attention",
                               _ARGTYPES)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                H, Sq, Skv, D, q_offset, int(causal), int(window), scale,
                build.dtype_code(q.dtype), build.stream_of(q))
    build.check_launch(rc, "flash_attention")
    return out
