"""Load the JAX package's parameters into the port.

``params_from_jax`` takes the output of the JAX package's
``core.model.init_params`` converted leaf by leaf to numpy (the caller does
that; this module imports neither jax nor the JAX package) and returns the
port's parameter tree: same paths, the stacked ``reps`` axis kept, and the
tp-local axis of size 1 stripped as the JAX package's ``blocks._lo`` does.
For tinyllama-42m, JAX's ``wq`` (8, 1, 512, 8, 64) becomes (8, 512, 8, 64)
and ``embed.table`` (1, 32000, 512) becomes (32000, 512).  Norm scales are
replicated in JAX and carry no tp axis.  The SSM leaves cross the same way:
``in_z``/``in_x``/``in_dt``/``conv_x``/``A_log``/``D``/``dt_bias``/``out``
lose their tp axis, ``norm_scale`` arrives flat, (reps, 1, H*P) ->
(reps, H*P), and the replicated ``in_B``/``in_C``/``conv_B``/``conv_C``
carry none; ``A_log`` and ``dt_bias`` stay float32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.model import map_template
from repro_torch.core.partition import model_layout


def _to_torch(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":       # ml_dtypes' numpy bfloat16
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def params_from_jax(cfg, plan, np_tree, device="cuda"):
    """JAX ``init_params`` output as numpy -> the port's parameter tree on
    ``device``.  Raises when a leaf's shape is not the JAX layout of the
    port's template (tp=1)."""
    dev = resolve_device(device)
    n_kv_loc = model_layout(cfg, plan).attn.n_kv_loc

    def leaf(spec, reps, arr):
        full = list(spec.full)
        if spec.kv_heads:                      # JAX stores the kv_map gather
            full[1] = n_kv_loc
        want = ((reps,) if reps else ()) + tuple(full)
        t = _to_torch(arr)
        if tuple(t.shape) != want:             # strip the tp axis of size 1
            ax = 1 if reps else 0
            if t.dim() != len(want) + 1 or t.shape[ax] != 1:
                raise ValueError(f"JAX leaf of shape {tuple(t.shape)} does not "
                                 f"match the port's {want} (tp=1 expected)")
            t = t.squeeze(ax)
            if tuple(t.shape) != want:
                raise ValueError(f"JAX leaf {tuple(t.shape)} != port {want}")
        return t.to(dev)

    specs = map_template(cfg, lambda spec, reps: (spec, reps))

    def walk(s, a):
        if isinstance(s, tuple):
            return leaf(s[0], s[1], a)
        if isinstance(s, dict):
            if set(s) != set(a):
                raise ValueError(f"tree keys differ: port {sorted(s)} vs "
                                 f"JAX {sorted(a)}")
            return {k: walk(s[k], a[k]) for k in s}
        if len(s) != len(a):
            raise ValueError(f"list lengths differ: {len(s)} vs {len(a)}")
        return [walk(x, y) for x, y in zip(s, a, strict=True)]

    return walk(specs, np_tree)
