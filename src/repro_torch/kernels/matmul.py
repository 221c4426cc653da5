"""Launcher of the Hopper matmul kernel (``csrc/matmul.cu``).

Replaces ``src/repro/kernels/matmul.py::matmul``.  See the source for what
bounds it and how it is built; ``kernels.ops.matmul`` is the entry point.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def matmul(a, b, *, trans_b: bool = False):
    """a: (M, K) @ b: (K, N), or b: (N, K) when ``trans_b`` -> (M, N) in
    a.dtype, on the card."""
    build.check_cuda_tensor(a, "matmul a", 2, _DTYPES)
    build.check_cuda_tensor(b, "matmul b", 2, (a.dtype,))
    if b.device != a.device:
        raise ValueError(f"matmul: a on {a.device}, b on {b.device}")
    M, K = a.shape
    N, Kb = (b.shape[0], b.shape[1]) if trans_b else (b.shape[1], b.shape[0])
    if Kb != K:
        raise ValueError(f"matmul: inner dims differ, a {tuple(a.shape)} b "
                         f"{tuple(b.shape)} trans_b={trans_b}")
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    fn = build.kernel_function("matmul", "repro_matmul", _ARGTYPES)
    with torch.cuda.device(a.device):
        rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
                int(trans_b), build.dtype_code(a.dtype), build.stream_of(a))
    build.check_launch(rc, "matmul")
    return out
