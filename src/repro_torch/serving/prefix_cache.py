"""Draft source for speculative decoding: the JAX package's
``serving/prefix_cache.py::PromptLookupDraft`` without its radix corpus.

The port has no radix prefix cache yet (ROADMAP Queue 1 item 9), so the
draft corpus is the request's own context, as in the JAX package when it
runs without a prefix cache.  The search along cached token paths comes
back with the prefix cache.
"""
from __future__ import annotations

from typing import List

MAX_NGRAM = 3    # longest trailing n-gram matched, as in the JAX package


class PromptLookupDraft:
    """Self-drafting source for speculative decoding — no second model.

    Prompt-lookup (n-gram) drafting: the longest trailing n-gram of the
    slot's context (prompt + emitted tokens) is matched against its most
    recent earlier occurrence in that context; the k tokens that followed
    that occurrence become the draft.  Drafts are proposals only — the
    verify step scores them against the real model and rejection keeps
    outputs token-identical — so a bad draft costs pages, never accuracy.
    An empty return means "no guess": the engine falls back to the
    one-token decode path for that slot this tick."""

    def draft(self, context, k: int) -> List[int]:
        """Propose up to ``k`` continuation tokens for ``context``."""
        if k <= 0 or len(context) < 2:
            return []
        toks = [int(t) for t in context]
        for n in range(min(MAX_NGRAM, len(toks) - 1), 0, -1):
            gram = toks[-n:]
            for i in range(len(toks) - n - 1, -1, -1):
                if toks[i:i + n] == gram:
                    out = toks[i + n:i + n + k]
                    if out:
                        return out
        return []
