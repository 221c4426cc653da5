"""Token samplers over (possibly vocab-padded) logits: copies of the JAX
package's ``serving/sampler.py::sample_from_logits`` and
``speculative_sample`` (host-side numpy)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


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
