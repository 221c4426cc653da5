"""Launcher of the Hopper SSD-scan kernel (``csrc/ssd_scan.cu``).

Replaces ``src/repro/kernels/ssd_scan.py::ssd_scan`` (``_ssd_kernel`` and
``_ssd_kernel_i8``).  See the source for what bounds it and how it is built;
``kernels.ops.ssd_scan`` / ``ops.ssd_scan_i8`` are the entry points.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 9 + [_I] * 7 + [_P]

Q_CHUNK = 64         # rows per chunk (csrc/ssd_scan.cu Q)
P_TILE = 16          # head_dim must be a multiple (a warp's or block's rows)
MAX_STATE = 256      # float32 kernel: state size N its shared memory takes
MMA_MAX_N = 128      # bfloat16 kernel: state size one warp's registers hold
MMA_MAX_P = 128      # bfloat16 kernel: head_dim, P / 16 warps a block


def check_shape(S: int, P: int, N: int, dtype: torch.dtype) -> None:
    """Raises ValueError for shapes no kernel takes: float32 on CUDA cores
    (P a multiple of 16, N up to 256), bfloat16 on tensor cores (P and N
    multiples of 16 up to 128); the C entry refuses the same."""
    if min(S, P, N) <= 0 or P % P_TILE:
        raise ValueError(f"ssd_scan: head_dim {P} must be a multiple of "
                         f"{P_TILE}; S {S}, N {N} > 0")
    if dtype == torch.float32:
        if N > MAX_STATE:
            raise ValueError(f"ssd_scan: float32 state {N} > {MAX_STATE}")
        return
    if dtype != torch.bfloat16:
        raise ValueError(f"ssd_scan: dtype {dtype} has no kernel")
    if N % 16 or N > MMA_MAX_N or P > MMA_MAX_P:
        raise ValueError(f"ssd_scan: the bfloat16 kernel takes a state size "
                         f"N that is a multiple of 16 up to {MMA_MAX_N} and "
                         f"head_dim up to {MMA_MAX_P}, got N {N}, P {P}")


def ssd_scan(x, dt, B, C, A, *, state0=None, state0_scale=None):
    """x: (Bt, S, H, P) float32/bfloat16; dt: (Bt, S, H) float32; B/C:
    (Bt, S, N) in x's dtype; A: (H,) float32; state0: None, (Bt, H, P, N)
    float32, or int8 with ``state0_scale`` (Bt, H) float32 -> (y (Bt, S,
    H, P) in x's dtype, final state (Bt, H, P, N) float32), on the card."""
    build.check_cuda_tensor(x, "ssd_scan x", 4, _DTYPES)
    Bt, S, H, P = x.shape
    build.check_cuda_tensor(dt, "ssd_scan dt", 3, (torch.float32,))
    build.check_cuda_tensor(B, "ssd_scan B", 3, (x.dtype,))
    build.check_cuda_tensor(C, "ssd_scan C", 3, (x.dtype,))
    build.check_cuda_tensor(A, "ssd_scan A", 1, (torch.float32,))
    N = B.shape[-1]
    if tuple(dt.shape) != (Bt, S, H) or tuple(B.shape) != (Bt, S, N) or \
            C.shape != B.shape or tuple(A.shape) != (H,):
        raise ValueError(f"ssd_scan: x {tuple(x.shape)} dt {tuple(dt.shape)} "
                         f"B {tuple(B.shape)} C {tuple(C.shape)} A "
                         f"{tuple(A.shape)} do not fit (Bt, S, H, P)")
    check_shape(S, P, N, x.dtype)
    if x.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (x, B, C)):
        raise ValueError("ssd_scan: the tensor-core kernel needs 16-byte "
                         "aligned x, B and C")
    tensors = [x, dt, B, C, A]
    s0_kind, s0_ptr, scale_ptr = 0, None, None
    if state0 is not None:
        quant = state0_scale is not None
        build.check_cuda_tensor(state0, "ssd_scan state0", 4,
                                (torch.int8,) if quant else (torch.float32,))
        if tuple(state0.shape) != (Bt, H, P, N):
            raise ValueError(f"ssd_scan: state0 {tuple(state0.shape)} != "
                             f"{(Bt, H, P, N)}")
        tensors.append(state0)
        s0_kind, s0_ptr = (2 if quant else 1), state0.data_ptr()
        if quant:
            build.check_cuda_tensor(state0_scale, "ssd_scan state0_scale", 2,
                                    (torch.float32,))
            if tuple(state0_scale.shape) != (Bt, H):
                raise ValueError(f"ssd_scan: state0_scale "
                                 f"{tuple(state0_scale.shape)} != {(Bt, H)}")
            tensors.append(state0_scale)
            scale_ptr = state0_scale.data_ptr()
    elif state0_scale is not None:
        raise ValueError("ssd_scan: state0_scale given without state0")
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"ssd_scan: tensors on several devices {devs}")
    y = torch.empty_like(x)
    final = torch.empty((Bt, H, P, N), dtype=torch.float32, device=x.device)
    fn = build.kernel_function("ssd_scan", "repro_ssd_scan", _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(),
                A.data_ptr(), s0_ptr, scale_ptr, y.data_ptr(), final.data_ptr(),
                Bt, S, H, P, N, s0_kind, build.dtype_code(x.dtype),
                build.stream_of(x))
    build.check_launch(rc, "ssd_scan")
    return y, final
