"""Normalization, rotary embeddings, activations, embedding and LM head.

Port of the JAX package's ``core/layers.py`` at tp=1 (every ``psum`` there
is the identity on one device).  ``rmsnorm``, ``add_rmsnorm`` (the
residual add fused into the norm after it), ``gated_rmsnorm`` (mamba2's
gated norm, ``rmsnorm_from_sumsq`` at tp=1) and the LM head go through
``kernels.ops``, so on the card they run the Hopper kernels.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


def rmsnorm(x, scale, eps: float = 1e-6):
    """RMSNorm over the last axis, ``(1 + scale)`` convention, computed in
    float32 and cast back."""
    E = x.shape[-1]
    y = ops.rmsnorm(x.reshape(-1, E).contiguous(), scale, eps)
    return y.reshape(x.shape)


def add_rmsnorm(x, delta, scale, eps: float = 1e-6):
    """``s = x + delta`` and ``rmsnorm(s)`` in one pass -> (s, norm), both
    bitwise what the add and ``rmsnorm`` give one after the other."""
    E = x.shape[-1]
    s, y = ops.rmsnorm_residual(x.reshape(-1, E).contiguous(),
                                delta.reshape(-1, E).contiguous(), scale, eps)
    return s.reshape(x.shape), y.reshape(x.shape)


def gated_rmsnorm(y, z, scale, eps: float = 1e-6, out_dtype=None):
    """RMSNorm of ``y * silu(float(z))`` over the last axis, in float32,
    cast to ``out_dtype`` (default float32)."""
    E = y.shape[-1]
    out = ops.rmsnorm_gated(y.reshape(-1, E).contiguous(),
                            z.reshape(-1, E).contiguous(), scale, eps,
                            out_dtype)
    return out.reshape(y.shape)


def apply_norm(x, p, cfg, delta=None):
    """The residual stream with its pending ``delta`` added, and its norm
    -> (x + delta, rmsnorm(x + delta)); with no delta (x, rmsnorm(x))."""
    if delta is not None:
        return add_rmsnorm(x, delta, p["scale"], cfg.norm_eps)
    return x, rmsnorm(x, p["scale"], cfg.norm_eps)


def activation(x, kind: str):
    if kind != "silu":
        raise NotImplementedError(f"activation '{kind}' is not ported yet")
    return F.silu(x)


def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


_FREQS: dict = {}        # (head_dim, theta, device) -> rope frequencies


def _rope_freqs_on(d: int, theta: float, device):
    """The frequencies on ``device``, copied there once: a step must not
    copy from the host (that would sync, and break a CUDA graph capture)."""
    key = (d, float(theta), device)
    f = _FREQS.get(key)
    if f is None:
        f = _FREQS[key] = torch.from_numpy(rope_freqs(d, theta)).to(device)
    return f


def apply_rope(x, positions, theta: float):
    """Split-half rotary embedding in float32.  x: (..., S, D) with
    positions (..., S) or (S,)."""
    if theta <= 0:
        return x
    d = x.shape[-1]
    freqs = _rope_freqs_on(d, theta, x.device)
    ang = positions[..., None].to(torch.float32) * freqs          # (..., S, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def embed(tokens, table):
    """tokens: (B, S) int; table: (V, E) -> (B, S, E)."""
    return F.embedding(tokens, table)


def logits(x, head):
    """x: (B, S, E); head: (V, E), read as stored -> (B, S, V)."""
    B, S, E = x.shape
    out = ops.matmul(x.reshape(B * S, E).contiguous(), head, trans_b=True)
    return out.reshape(B, S, head.shape[0])
