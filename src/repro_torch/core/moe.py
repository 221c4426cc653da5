"""Mixture-of-experts FFN at tp=1.

Port of the JAX package's ``core/moe.py``: ``_capacity``, ``router_topk``,
``_bucket_by_expert``, ``_combine``, ``_expert_ffn``, ``moe_ffn_tp`` and
``moe_ffn_ep`` (at tp=1, where it holds every expert and computes the same
function).  What decides token identity with JAX is kept:

- the capacity of every expert's bucket is a function of the call's row
  count T, padding rows and idle lanes included (they route too);
- top-k takes the lowest expert index first among equal probabilities, as
  ``jax.lax.top_k`` does (a stable descending sort: ``torch.topk`` promises
  no order for ties);
- a pair's bucket row is its place among the pairs routed to the same
  expert in flat order (token, then rank), as JAX's stable sort by expert
  gives it, so the same pairs are dropped past the capacity;
- router logits and softmax in float32, the gates renormalised, then cast
  to the activation dtype before the multiply.

Nothing here waits on the card: the places and the per-expert fill
counts come from a cumulative sum over the pairs' one-hot columns, a
fixed (n, T k) tensor (no ``bincount``, ``nonzero`` or ``.item()``), every
shape is fixed by T and the config, so a step holding an MoE layer is
one CUDA graph.  The experts' products run on
``kernels.ops.expert_matmul``, which reads only each bucket's filled
rows (an empty expert's weights are never read).  The combine gathers
each token's k expert outputs and sums them in the order JAX's
scatter-add applies them (ascending expert), so it repeats bit for bit
where an atomic ``index_add_`` would not.

Pairs dropped by capacity are counted on the device
(``dropped_pairs``/``reset_dropped_pairs``); a CUDA graph's warm-up calls
are taken out again (``core.graphs``), its replays count.
"""
from __future__ import annotations

import torch

from repro_torch.core.layers import activation
from repro_torch.kernels import ops

_DROPPED: dict = {}     # device -> (1,) int64: pairs dropped by capacity


def _capacity(T: int, k: int, n_experts: int, factor: float) -> int:
    """Expert capacity with a decode-safe floor: tiny token counts (decode
    steps) get capacity >= min(T, 16) so adversarial routing cannot drop
    tokens; the statistical capacity bound governs large T (prefill)."""
    return max(int(factor * T * k / n_experts), min(T, 16), 1)


def router_topk(x, w_router, top_k: int, n_experts: int):
    """x: (T, E) -> (gates (T, k) float32 renormalised, idx (T, k) int64):
    the k most probable experts of each row, highest first, the lowest
    index first among equal probabilities."""
    logits = ops.matmul(x.float().contiguous(), w_router.float())
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[:, :top_k], idx[:, :top_k]
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return gates, idx


def _bucket_by_expert(x, idx, gates, n_experts: int, capacity: int):
    """Scatter tokens into per-expert buckets (pairs over capacity are
    dropped).  -> (buckets (n, capacity, E), info), ``info`` per (token,
    rank) pair in flat order t * k + j: ``slot`` (its bucket row, or
    ``n * capacity`` when dropped), ``keep``, ``gate``; and ``fill`` (n,)
    int32, the rows each bucket holds.

    A pair's place in its bucket is the number of earlier pairs (in flat
    order) routed to the same expert: the cumulative sum of the pairs'
    one-hot columns, read at the pair's expert.  That is JAX's stable sort by
    expert (``repro.core.moe._bucket_by_expert``), pair for pair, without
    the sort; the per-expert counts are the sum's last column."""
    T, k = idx.shape
    E = x.shape[-1]
    flat_e = idx.reshape(1, -1)                        # (1, T*k)
    onehot = torch.arange(n_experts, device=x.device)[:, None] == flat_e
    # (n, T*k): each expert's pairs so far, a scan along each row (the
    # inner dim: the card scans rows in parallel)
    seen = torch.cumsum(onehot, dim=1, dtype=torch.int32)
    pos_in_bucket = seen.gather(0, flat_e)[0] - 1
    keep = pos_in_bucket < capacity
    slot = torch.where(keep, flat_e[0] * capacity + pos_in_bucket,
                       n_experts * capacity)
    buckets = torch.zeros(n_experts * capacity + 1, E, dtype=x.dtype,
                          device=x.device)
    buckets.index_copy_(0, slot, x[:, None, :].expand(T, k, E).reshape(-1, E))
    fill = seen[:, -1].clamp(max=capacity)
    return (buckets[:-1].reshape(n_experts, capacity, E),
            dict(slot=slot, keep=keep, gate=gates.reshape(-1), fill=fill))


def _combine(buckets_out, info, E, idx):
    """Expert outputs back to their tokens, weighted by the gates (cast to
    the outputs' dtype; a dropped pair weighs 0): each token's k outputs
    gathered by slot and added one by one in that dtype, in ascending
    expert order, the order in which JAX's scatter-add applies a token's
    pairs (sorted by expert); a fixed order, so the sum repeats bit for
    bit.  ``idx`` (T, k): the routed experts."""
    T, k = idx.shape
    flat = buckets_out.reshape(-1, E)
    picked = flat[info["slot"].clamp(max=flat.shape[0] - 1)]
    w = info["gate"].to(picked.dtype)
    contrib = torch.where(info["keep"][:, None], picked * w[:, None],
                          0.0).view(T, k, E)               # dropped: 0
    by_expert = torch.sort(idx, dim=1).indices         # ascending expert
    parts = contrib.gather(1, by_expert[:, :, None].expand(T, k, E))
    out = parts[:, 0]
    for j in range(1, k):
        out = out + parts[:, j]
    return out


def _expert_ffn(buckets, w_gate, w_up, w_down, act, gated, fill):
    """buckets: (n, cap, E); weights: (n, E, F), (n, F, E); ``fill`` (n,)
    int32: the rows of each bucket the expert products read (the rest come
    out zero, as JAX's products of the zero rows do)."""
    if gated:
        h = activation(ops.expert_matmul(buckets, w_gate, fill), act) * \
            ops.expert_matmul(buckets, w_up, fill)
    else:
        h = activation(ops.expert_matmul(buckets, w_up, fill), act)
    return ops.expert_matmul(h, w_down, fill)


def _count_drops(info, n_pairs):
    dev = info["fill"].device
    if dev not in _DROPPED:
        _DROPPED[dev] = torch.zeros(1, dtype=torch.int64, device=dev)
    _DROPPED[dev].add_(n_pairs - info["fill"].sum())


def dropped_pairs() -> int:
    """(token, expert) pairs dropped by capacity since the last reset, over
    every device (reads the counters: the host waits for the card)."""
    return int(sum(int(t.item()) for t in _DROPPED.values()))


def reset_dropped_pairs():
    for t in _DROPPED.values():
        t.zero_()


def drop_counters():
    """A copy of the drop counters, for ``restore_drop_counters``."""
    return {dev: t.clone() for dev, t in _DROPPED.items()}


def restore_drop_counters(saved):
    """Put the counters back as ``drop_counters`` saw them (a counter made
    since then back to 0): what a graph's warm-up calls routed is not
    counted."""
    for dev, t in _DROPPED.items():
        if dev in saved:
            t.copy_(saved[dev])
        else:
            t.zero_()


def moe_ffn_tp(x, p, cfg, capacity_factor=1.25):
    """JAX's paper-faithful TP MoE at tp=1 (every expert whole).  x: (B, S,
    E); p: {"router": {"w": (E, n)}, "experts": {"w_gate"/"w_up": (n, E, F),
    "w_down": (n, F, E)}} -> (B, S, E)."""
    B, S, E = x.shape
    T = B * S
    xt = x.reshape(T, E)
    gates, idx = router_topk(xt, p["router"]["w"], cfg.top_k, cfg.n_experts)
    capacity = _capacity(T, cfg.top_k, cfg.n_experts, capacity_factor)
    buckets, info = _bucket_by_expert(xt, idx, gates, cfg.n_experts, capacity)
    _count_drops(info, T * cfg.top_k)
    ex = p["experts"]
    out = _expert_ffn(buckets, ex.get("w_gate"), ex["w_up"], ex["w_down"],
                      cfg.act, cfg.gated_ffn, info["fill"])
    return _combine(out, info, E, idx).reshape(B, S, E)


def moe_ffn_ep(x, p, cfg, shard_idx=0, tp=1, capacity_factor=1.25):
    """JAX's expert-parallel MoE at tp=1: the one shard holds all n experts
    (n_loc = n), runs every bucket and its partial combine is the whole
    one, so it is ``moe_ffn_tp``.  tp > 1 waits for tensor parallelism
    (ROADMAP Queue 1 item 12)."""
    if tp != 1 or shard_idx != 0:
        raise NotImplementedError(
            f"moe_ffn_ep over tp={tp} (shard {shard_idx}) is not ported: the "
            f"port runs at tp=1 (ROADMAP Queue 1 item 12)")
    return moe_ffn_tp(x, p, cfg, capacity_factor)
