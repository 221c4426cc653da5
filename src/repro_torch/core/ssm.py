"""Mamba-2 SSD (state-space duality) blocks: the depthwise causal conv, the
chunked scan and the one-token decode step.

Port of the JAX package's ``core/ssm.py`` at tp=1 (all heads on one
device), without ``return_extras`` (context parallelism):

    x  : (B, S, H, P)   heads H, head dim P
    dt : (B, S, H)      softplus-activated step sizes, float32
    Bm, Cm : (B, S, N)  state projections (one group, shared by the heads)
    A  : (H,)           negative per-head decay
    state : (B, H, P, N) float32

``ssd_chunked`` runs the scan through ``kernels.ops`` (the Hopper SSD
kernel on the card) and adds the ``D`` skip term, which the kernel
contract leaves to the caller.  ``causal_conv`` and ``ssd_decode_step`` are
plain PyTorch, as they are plain JAX in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


def causal_conv(x, w, state=None, tail_idx=None):
    """Depthwise causal conv.  x: (B, S, C); w: (C, K); state: (B, K-1, C)
    the previous inputs, or None (zeros).  ``tail_idx``: in-chunk index of
    the last valid input row (an int or a one-element integer tensor, read
    on the device); the returned state is the K-1 inputs ending there
    (inclusive), so a chunk whose tail is padding still hands the next step
    the true history.  None = S - 1.  -> (y, new_state)."""
    B, S, C = x.shape
    K = w.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    w = w.to(x.dtype)
    y = sum(xp[:, i:i + S, :] * w[:, i] for i in range(K))
    if K == 1:
        return y, x.new_zeros((B, 0, C))
    if tail_idx is None:
        return y, xp[:, -(K - 1):, :]
    # input row s sits at xp index K-1+s; the K-1 rows ending at tail_idx
    # inclusive are xp[tail_idx+1 : tail_idx+K], gathered at a device index
    if not isinstance(tail_idx, torch.Tensor):
        tail_idx = torch.tensor(tail_idx, device=x.device)
    rows = tail_idx.reshape(1).long() + torch.arange(1, K, device=x.device)
    return y, xp.index_select(1, rows)


def ssd_chunked(x, dt, Bm, Cm, A, D, state0=None, state0_scale=None):
    """The exact SSD scan of a sequence (or a prefill chunk carried on from
    ``state0``), plus the ``D * x`` skip term.  ``state0``: (B, H, P, N)
    float32, or int8 with ``state0_scale`` (B, H) float32 (dequantized in
    float32 inside the scan).  JAX's ``chunk`` argument has no counterpart:
    the kernel fixes its own chunk length, and the result does not depend
    on it.  -> (y (B, S, H, P) in x's dtype, final state (B, H, P, N)
    float32)."""
    args = [t.contiguous() for t in (x, dt, Bm, Cm, A)]
    if state0_scale is not None:
        y, state = ops.ssd_scan_i8(*args, state0.contiguous(),
                                   state0_scale.contiguous())
    else:
        y, state = ops.ssd_scan(*args, None if state0 is None
                                else state0.float().contiguous())
    y = y.float() + x.float() * D.float()[None, None, :, None]
    return y.to(x.dtype), state


def ssd_decode_step(x, dt, Bm, Cm, A, D, state):
    """One token.  x: (B, H, P); dt: (B, H); Bm/Cm: (B, N); state: (B, H,
    P, N) float32 -> (y (B, H, P) in x's dtype, new state)."""
    xf = x.float()
    dtf = dt.float()
    dec = torch.exp(dtf * A.float())                               # (B, H)
    contrib = torch.einsum("bh,bn,bhp->bhpn", dtf, Bm.float(), xf)
    state = state * dec[..., None, None] + contrib
    y = torch.einsum("bn,bhpn->bhp", Cm.float(), state)
    y = y + xf * D.float()[None, :, None]
    return y.to(x.dtype), state
