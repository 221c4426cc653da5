"""Token samplers over (possibly vocab-padded) logits: copies of the JAX
package's ``serving/sampler.py::sample_from_logits`` and
``speculative_sample`` (host-side numpy), kept for sampled decoding; and
the greedy path the serving engine runs: ``greedy_ids`` on the device,
inside the compiled steps, and ``greedy_accept``, the verify emission over
those ids."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class SamplerConfig:
    temperature: float = 0.0      # 0 => greedy
    top_k: int = 0
    top_p: float = 0.0


def sample_from_logits(logits: np.ndarray, cfg: SamplerConfig,
                       vocab_size: int, rng: np.random.RandomState):
    """logits: (B, V_pad) float32 -> (B,) int32."""
    lg = logits[:, :vocab_size].astype(np.float64)
    if cfg.temperature <= 0:
        return lg.argmax(axis=-1).astype(np.int32)
    lg = lg / cfg.temperature
    if cfg.top_k:
        kth = np.partition(lg, -cfg.top_k, axis=-1)[:, -cfg.top_k][:, None]
        lg = np.where(lg < kth, -np.inf, lg)
    p = np.exp(lg - lg.max(axis=-1, keepdims=True))
    p /= p.sum(axis=-1, keepdims=True)
    if cfg.top_p:
        srt = np.argsort(-p, axis=-1)
        out = np.zeros(lg.shape[0], np.int32)
        for b in range(lg.shape[0]):
            ps = p[b, srt[b]]
            keep = np.cumsum(ps) - ps < cfg.top_p
            keep[0] = True
            sel = srt[b, keep]
            pp = p[b, sel] / p[b, sel].sum()
            out[b] = rng.choice(sel, p=pp)
        return out
    return np.array([rng.choice(lg.shape[1], p=p[b])
                     for b in range(lg.shape[0])], np.int32)


def speculative_sample(logits: np.ndarray, draft, cfg: SamplerConfig,
                       vocab_size: int, rng: np.random.RandomState):
    """Accept/emit loop over verify-step logits: the deterministic-draft
    case of rejection sampling, token-identical to the one-token path.

    ``logits``: (Q, V_pad), row i the next-token distribution after the
    last accepted token plus draft[:i]; ``draft``: the kd <= Q-1 proposed
    tokens.  Row i is sampled exactly as ``sample_from_logits`` would on the
    one-token path, the sample is emitted, and drafting continues past row
    i only while the sample agrees with draft[i] (the draft is a point
    mass, so that agreement IS the rejection test, and the first
    disagreeing row already holds the corrected sample).  -> emitted
    tokens (1 <= len <= len(draft) + 1)."""
    out = []
    for i in range(len(draft) + 1):
        tok = int(sample_from_logits(logits[i:i + 1], cfg, vocab_size,
                                     rng)[0])
        out.append(tok)
        if i < len(draft) and tok != int(draft[i]):
            break
    return out


def greedy_ids(logits, vocab_size: int):
    """``sample_from_logits``'s greedy branch on the device: the argmax of
    each row's first ``vocab_size`` logits, compared in float32 as JAX
    compares them; ``torch.argmax`` returns the first maximal index, as
    ``np.argmax`` does.  logits (..., V_pad) -> (...) int32."""
    return logits[..., :vocab_size].float().argmax(-1).to(torch.int32)


def greedy_accept(ids, draft):
    """``speculative_sample``'s greedy branch over the verify step's greedy
    ids (taken on the card): ``ids`` (Q,) holds row i's argmax; row i is
    emitted, and drafting continues past it only while it equals
    draft[i].  -> emitted tokens (1 <= len <= len(draft) + 1), the tokens
    ``speculative_sample`` gives on the rows' logits."""
    out = []
    for i in range(len(draft) + 1):
        tok = int(ids[i])
        out.append(tok)
        if i < len(draft) and tok != int(draft[i]):
            break
    return out
