"""Hopper RMSNorm kernel in Triton.

Replaces ``src/repro/kernels/rmsnorm.py::rmsnorm`` (``_rmsnorm_kernel``):
``y = x * rsqrt(mean(x^2) + eps) * (1 + scale)`` per row, in float32, cast
back to x's dtype.
Bound on this card: a few operations per element against one read and one
write of the row, so bytes bound it.
Design: one program per row with ``BLOCK = next_pow2(E)``, so the row is
read once into registers, reduced, scaled and written once; the scale
vector is read once per row and stays in L2.  ``triton`` is imported on the
first launch, never at module import (the CPU tests import this module).
"""
from __future__ import annotations

import os

import torch

from repro_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)
tl = None          # triton.language, bound on the first launch
_JIT: dict = {}    # the compiled kernel and triton's helpers, once per process


def _rmsnorm_kernel(x_ptr, s_ptr, o_ptr, E, eps, BLOCK: tl.constexpr):
    row = tl.program_id(0)
    cols = tl.arange(0, BLOCK)
    mask = cols < E
    x = tl.load(x_ptr + row * E + cols, mask=mask, other=0.0).to(tl.float32)
    ms = tl.sum(x * x, axis=0) / E
    s = tl.load(s_ptr + cols, mask=mask, other=0.0).to(tl.float32)
    y = x * (1.0 / tl.sqrt(ms + eps)) * (1.0 + s)
    tl.store(o_ptr + row * E + cols, y.to(o_ptr.dtype.element_ty), mask=mask)


def _compiled():
    global tl
    if not _JIT:
        # keep triton's cache inside the checkout, beside the CUDA builds
        os.environ.setdefault("TRITON_CACHE_DIR",
                              str(build.BUILD_DIR / "triton"))
        import triton
        import triton.language as tl  # noqa: F811  (binds the module name)
        _JIT["kernel"] = triton.jit(_rmsnorm_kernel)
        _JIT["next_pow2"] = triton.next_power_of_2
    return _JIT["kernel"], _JIT["next_pow2"]


def rmsnorm(x, scale, eps: float = 1e-6):
    """x: (T, E); scale: (E,) -> (T, E) in x.dtype, on the card."""
    build.check_cuda_tensor(x, "rmsnorm x", 2, _DTYPES)
    build.check_cuda_tensor(scale, "rmsnorm scale", 1, _DTYPES)
    T, E = x.shape
    if scale.shape[0] != E or scale.device != x.device:
        raise ValueError(f"rmsnorm: scale {tuple(scale.shape)} on "
                         f"{scale.device} does not match x {tuple(x.shape)} "
                         f"on {x.device}")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    kernel, next_pow2 = _compiled()
    with torch.cuda.device(x.device):
        kernel[(T,)](x, scale, out, E, float(eps), BLOCK=next_pow2(E),
                     num_warps=4)
    return out
