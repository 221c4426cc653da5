"""Hopper RMSNorm kernel in Triton, in three variants of one kernel.

Replaces ``src/repro/kernels/rmsnorm.py::rmsnorm`` (``_rmsnorm_kernel``):
``y = x * rsqrt(mean(x^2) + eps) * (1 + scale)`` per row, in float32, cast
back to x's dtype.  The variants, chosen by ``tl.constexpr`` flags, absorb
the elementwise ops the model runs around a norm:

- ``rmsnorm``: the norm alone.
- ``rmsnorm_residual``: the residual add before a norm, ``s = x + r`` (the
  sum formed in float32 and rounded once to x's dtype, as PyTorch's add
  rounds it) and ``y = rmsnorm(s)`` of the rounded ``s``; both written.
  So ``s`` is bitwise ``x + r`` and ``y`` bitwise ``rmsnorm(x + r)``.
- ``rmsnorm_gated``: mamba2's gated norm, ``rmsnorm(y * silu(float(z)))``
  in float32, written in the caller's dtype (JAX's gated norm at tp = 1,
  ``src/repro/core/blocks.py`` ``ssm_mixer`` through
  ``layers.rmsnorm_from_sumsq``).

Bound on this card: a few operations per element against one read of
each input row and one write of each output row, so bytes bound them; at
the serving shapes a row is a few KB and a call is its launch and one
round trip to memory, which is why the neighbours' ops are fused in here
rather than the kernel made faster alone.
Design: one program per row with ``BLOCK = next_pow2(E)``, so each row is
read once into registers, reduced, scaled and written once; the scale
vector is read once per row and stays in L2.  The three variants share
the reduction and the scaling lines, so the residual variant's ``y`` is
the plain variant's result on ``s``.  ``triton`` is imported on the first
launch, never at module import (the CPU tests import this module).
"""
from __future__ import annotations

import os

import torch

from repro_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)
tl = None          # triton.language, bound on the first launch
_JIT: dict = {}    # the compiled kernel and triton's helpers, once per process


def _rmsnorm_kernel(x_ptr, r_ptr, s_ptr, o_ptr, sum_ptr, E, eps,
                    BLOCK: tl.constexpr, RESIDUAL: tl.constexpr,
                    GATED: tl.constexpr):
    row = tl.program_id(0)
    cols = tl.arange(0, BLOCK)
    mask = cols < E
    x = tl.load(x_ptr + row * E + cols, mask=mask, other=0.0)
    if RESIDUAL:
        r = tl.load(r_ptr + row * E + cols, mask=mask, other=0.0)
        xs = (x.to(tl.float32) + r.to(tl.float32)).to(x.dtype)
        tl.store(sum_ptr + row * E + cols, xs, mask=mask)
        x = xs.to(tl.float32)
    elif GATED:
        z = tl.load(r_ptr + row * E + cols, mask=mask, other=0.0).to(tl.float32)
        x = x.to(tl.float32) * (z / (1.0 + tl.exp(-z)))
    else:
        x = x.to(tl.float32)
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


def _check(name, x, scale, other=None, other_dtypes=_DTYPES):
    build.check_cuda_tensor(x, f"{name} x", 2, _DTYPES)
    build.check_cuda_tensor(scale, f"{name} scale", 1, _DTYPES)
    T, E = x.shape
    if scale.shape[0] != E or scale.device != x.device:
        raise ValueError(f"{name}: scale {tuple(scale.shape)} on "
                         f"{scale.device} does not match x {tuple(x.shape)} "
                         f"on {x.device}")
    if other is not None:
        build.check_cuda_tensor(other, f"{name} second input", 2,
                                other_dtypes)
        if other.shape != x.shape or other.device != x.device:
            raise ValueError(f"{name}: second input {tuple(other.shape)} on "
                             f"{other.device} does not match x "
                             f"{tuple(x.shape)} on {x.device}")


def _launch(x, r, scale, out, xsum, eps, residual=False, gated=False):
    T, E = x.shape
    kernel, next_pow2 = _compiled()
    with torch.cuda.device(x.device):
        kernel[(T,)](x, r, scale, out, xsum, E, float(eps),
                     BLOCK=next_pow2(E), RESIDUAL=residual, GATED=gated,
                     num_warps=4)


def rmsnorm(x, scale, eps: float = 1e-6):
    """x: (T, E); scale: (E,) -> (T, E) in x.dtype, on the card."""
    _check("rmsnorm", x, scale)
    out = torch.empty_like(x)
    if out.numel():
        _launch(x, x, scale, out, out, eps)
    return out


def rmsnorm_residual(x, r, scale, eps: float = 1e-6):
    """x, r: (T, E) in one dtype; scale: (E,) -> (s = x + r, rmsnorm(s)),
    both (T, E) in x.dtype, on the card."""
    _check("rmsnorm_residual", x, scale, r, (x.dtype,))
    xsum, out = torch.empty_like(x), torch.empty_like(x)
    if out.numel():
        _launch(x, r, scale, out, xsum, eps, residual=True)
    return xsum, out


def rmsnorm_gated(y, z, scale, eps: float = 1e-6, out_dtype=None):
    """y, z: (T, E) float32 or bfloat16; scale: (E,) -> rmsnorm(y *
    silu(float(z))) computed in float32, (T, E) in ``out_dtype`` (default
    float32), on the card."""
    _check("rmsnorm_gated", y, scale, z)
    out_dtype = out_dtype or torch.float32
    if out_dtype not in _DTYPES:
        raise ValueError(f"rmsnorm_gated: out_dtype {out_dtype} not in "
                         f"{_DTYPES}")
    out = torch.empty(y.shape, dtype=out_dtype, device=y.device)
    if out.numel():
        _launch(y, z, scale, out, out, eps, gated=True)
    return out
