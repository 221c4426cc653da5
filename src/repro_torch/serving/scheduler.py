"""Scheduling policy for the serving engine (policy/mechanism split).

A copy of the part of the JAX package's ``serving/scheduler.py`` that FCFS
serving without a prefix cache needs: the ``Scheduler`` interface,
``Admission`` records, ``FCFSScheduler``'s all-or-nothing budgeting of
pages and state slabs and its speculative draft headroom.  Without a page
allocator (``allocator=None``, the contiguous engine) it only orders the
queue: every slot owns a whole lane, so a free slot admits the head.  The
engine executes admissions and reports lifecycle events back
(``on_prefill_complete``, ``on_finish``, ``on_spec_trim``).

Invariant: leak freedom — every page and every slab is free after
    ``run()``/``drain()`` retire all admissions.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from repro_torch.core.kvcache import pages_needed


def effective_prompt(req) -> np.ndarray:
    """Tokens an admission must make resident: the original prompt plus
    everything the request already generated (non-empty only for a request
    that re-enters after preemption, which a later slice ports)."""
    out = getattr(req, "out_tokens", None)
    if not out:
        return np.asarray(req.prompt, np.int32)
    return np.concatenate([np.asarray(req.prompt, np.int32),
                           np.asarray(out, np.int32)])


def remaining_new_tokens(req) -> int:
    """Decode budget still owed to ``req``."""
    out = getattr(req, "out_tokens", None)
    return req.max_new_tokens - (len(out) if out else 0)


@dataclass
class Admission:
    """One scheduler decision: place ``req`` into engine slot ``slot`` with
    the block-table page run ``pages`` (prompt + max_new_tokens worth).
    spec: the run includes draft headroom (+spec_tokens of coverage), so the
    engine may run the verify step on the slot; False means speculation was
    denied at admission (pool pressure) and the slot decodes one token per
    tick.  slab: the slot's recurrent-state slab id (SSM archs)."""
    slot: int
    req: object
    pages: Optional[List[int]] = None
    spec: bool = False
    slab: Optional[int] = None


class Scheduler:
    """Policy interface the engine drives.  Implementations own the wait
    queue and all allocator traffic."""

    def submit(self, req) -> None:
        raise NotImplementedError

    def has_pending(self) -> bool:
        raise NotImplementedError

    def plan(self, free_slots: List[int]) -> List[Admission]:
        """Admissions for this tick; at most one per free slot."""
        raise NotImplementedError

    def on_prefill_complete(self, adm: Admission) -> None:
        """adm's prompt is fully resident."""

    def on_finish(self, adm: Admission) -> None:
        """adm's request retired — release its resources."""

    def on_spec_trim(self, adm: Admission, keep: int) -> None:
        """The engine stopped speculating on adm's slot — return the draft
        headroom pages past block-table index ``keep``."""


class FCFSScheduler(Scheduler):
    """First-come-first-served admission with all-or-nothing budgeting: the
    head request either gets its full page budget (prompt +
    max_new_tokens) and, for SSM archs, a state slab, or the whole queue
    waits (no mid-flight OOM, no starvation by overtaking).  A pure-SSM
    arch has no KV pool (``kv_pages=False``): its page demand is zero and
    its state lives entirely in the slab.  With no ``allocator`` (the
    contiguous engine) nothing is budgeted.  With ``spec_tokens`` > 0 an
    admission also tries for +spec_tokens of page coverage, so the verify
    step can write drafted positions past prompt + max_new_tokens: all or
    nothing, and a request denied it (``stats.spec_denied``) is still
    admitted, with ``spec=False``."""

    def __init__(self, *, seq_budget: int, allocator=None, page_size: int = 0,
                 spec_tokens: int = 0, stats=None, slab_allocator=None,
                 kv_pages: bool = True):
        self.queue: collections.deque = collections.deque()
        self.seq_budget = seq_budget
        self.allocator = allocator
        self.psz = page_size
        self.spec_tokens = spec_tokens
        self.stats = stats
        self.slab_allocator = slab_allocator      # SSM archs
        self.kv_pages = kv_pages

    @property
    def paged(self) -> bool:
        return self.allocator is not None

    def submit(self, req) -> None:
        if len(req.prompt) == 0:
            raise RuntimeError(f"request {req.rid} has an empty prompt")
        if not self.paged:
            if len(req.prompt) >= self.seq_budget:
                # the contiguous lane needs room past the prompt for decode
                raise RuntimeError(
                    f"request {req.rid} prompt ({len(req.prompt)} tokens) "
                    f"exceeds the sequence budget {self.seq_budget}")
            self.queue.append(req)
            return
        if len(req.prompt) + req.max_new_tokens > self.seq_budget:
            raise RuntimeError(
                f"request {req.rid} needs {len(req.prompt)} prompt + "
                f"{req.max_new_tokens} new tokens; the sequence budget "
                f"is {self.seq_budget}")
        need = self._req_pages(req)
        usable = self.allocator.n_pages - self.allocator.n_reserved
        if need > usable:       # reject now, not mid-run at admission
            raise RuntimeError(f"request {req.rid} needs {need} pages; the "
                               f"pool only has {usable} usable")
        self.queue.append(req)

    def has_pending(self) -> bool:
        return bool(self.queue)

    def _req_pages(self, req) -> int:
        if not self.paged or not self.kv_pages:
            return 0
        return pages_needed(len(effective_prompt(req)) +
                            remaining_new_tokens(req), self.psz)

    def plan(self, free_slots: List[int]) -> List[Admission]:
        out = []
        for slot in free_slots:
            if not self.queue:
                break
            if not self.paged:
                out.append(Admission(slot=slot, req=self.queue.popleft()))
                continue
            req = self.queue[0]
            slab = None
            if self.slab_allocator is not None:
                slab = self.slab_allocator.alloc()
                if slab is None:        # every slab busy: the head waits
                    break
            total = self._req_pages(req)
            pages = self.allocator.alloc(total)
            if pages is None:           # blocked: the head waits for pages
                if slab is not None:
                    self.slab_allocator.free(slab)
                break
            self.queue.popleft()
            out.append(Admission(slot=slot, req=req, pages=pages,
                                 spec=self._draft_headroom(req, total, pages),
                                 slab=slab))
        return out

    def _draft_headroom(self, req, total: int, pages: List[int]) -> bool:
        """Append the speculative headroom to ``pages`` if the pool covers
        it; never evicts.  -> whether it was granted."""
        if self.spec_tokens <= 0:
            return False
        n_max = self.seq_budget // self.psz
        extra = min(pages_needed(len(effective_prompt(req)) +
                                 remaining_new_tokens(req) + self.spec_tokens,
                                 self.psz), n_max) - total
        more = self.allocator.alloc(extra)
        if more is None:
            if self.stats is not None:
                self.stats.spec_denied += 1
            return False
        pages.extend(more)
        return True

    def on_finish(self, adm: Admission) -> None:
        if not self.paged:
            return
        self.allocator.decref(adm.pages)
        if adm.slab is not None:
            self.slab_allocator.free(adm.slab)

    def on_spec_trim(self, adm: Admission, keep: int) -> None:
        """Return the headroom pages past block-table index ``keep``: drop
        the slot's reference to each (``allocator.trim``), never assume it
        was the only one."""
        self.allocator.trim(adm.pages[keep:])
        del adm.pages[keep:]
        adm.spec = False
