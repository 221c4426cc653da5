"""Elastic replicas: re-scatter the paged serving pools onto a new
replica count.

The port's ``reshard_replica_pools``, from the JAX package's
``runtime/elastic.py`` (its ``choose_layout`` and ``rebuild`` pick a
device mesh for training and wait for ROADMAP Queue 1 items 12 and 13).
The port stores every replica's pages folded into one pool, (reps, R *
n, ...) (``core.kvcache``), so the replica axis is reached through
``kvcache.unfold_replica_pools``, a view: each surviving replica's rows
are copied to their new position in a fresh pool, and replicas that join
start zeroed.  ``ServingEngine.scale_to`` and ``kill_replica`` drive it.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.kvcache import fold_replica_pools, unfold_replica_pools
from repro_torch.core.model import tree_map


def reshard_replica_pools(cache, keep: Sequence[int], new_n_replicas: int,
                          n_replicas: int):
    """-> a new folded cache of ``new_n_replicas`` replicas from ``cache``,
    a folded cache of ``n_replicas``.

    ``keep`` lists the surviving old replica indices in their new order:
    survivor ``keep[j]`` becomes replica ``j``.  Replicas ``len(keep)`` ..
    ``new_n_replicas - 1`` join and start zeroed (their allocators hand out
    pages into untouched rows, so zeroing is hygiene: it matches
    ``zero_paged_cache_for``'s starting state).  Every leaf moves the same
    way: page pools, int8 scale rows, SSM slabs and slab scales, cross
    pools.  Each survivor's rows are one slice copy on the pools' device,
    nothing read on the host; the old cache is left as it was."""
    keep = list(keep)
    if not 0 < len(keep) <= new_n_replicas:
        raise ValueError(f"keep={keep!r} incompatible with "
                         f"new_n_replicas={new_n_replicas}")
    if any(not 0 <= r < n_replicas for r in keep):
        raise ValueError(f"keep={keep!r} names a replica outside the "
                         f"cache's {n_replicas}")

    def _leaf(v):                 # (reps, R, n, ...)
        out = torch.zeros((v.shape[0], new_n_replicas) + tuple(v.shape[2:]),
                          dtype=v.dtype, device=v.device)
        for j, r in enumerate(keep):
            out[:, j].copy_(v[:, r])
        return out

    return fold_replica_pools(tree_map(_leaf,
                                       unfold_replica_pools(cache, n_replicas)))
