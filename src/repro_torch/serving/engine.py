"""Serving engine: continuous batching over contiguous lanes, or over the
prefill-chunk and decode steps of the paged cache.

Port of the JAX package's ``serving/engine.py`` for one replica (dp=1),
FCFS admission, greedy sampling and the serial loop (the JAX engine's
``overlap=False``).  The engine is mechanism: it owns the cache, block
tables and positions and runs the steps; admission and page budgeting
live in ``serving.scheduler``.

**Contiguous engine** (``ServingEngine(...)``, ``paged=False``, the JAX
launcher's default): every slot owns a lane of ``seq_budget`` tokens.
Each tick admits the queue's head into every free slot and prefills its
exact prompt (``steps.make_prefill_step``: flash attention over the
whole prompt, or the SSD scan from a zero state) straight into the
slot's lane, emptied in place first (zeros, ``pos = -1``), which leaves
the lane as JAX's copy of a fresh batch-1 lane does; the slot's first
token is emitted at prefill completion.  Then ONE decode step runs over all slots (``steps.make_decode_step``, the
decode-attention kernel over the lanes); idle lanes run with token 0 and
pos 0 and their logits are ignored.  A slot retires at its token budget,
at EOS, or when its position reaches ``seq_budget - 1``, so a lane's ring
never wraps.  int8 lanes (``plan.kv_cache_dtype == "int8"``) store K/V at
the fixed scale ``blocks.KVQ``; an SSM arch's lane holds its float32
state and conv tails.  Speculation needs the paged engine.  A tick with
no slot in flight after admission is not counted, as in JAX.

**Paged engine** (``build_paged``): a fixed decode batch of ``batch_slots``
slots: every tick admits what the pool can hold (each admission gets its
whole page run up front — prompt + max_new_tokens — or waits), advances
every prefilling slot by one chunk, runs ONE decode step over all slots
(idle and prefilling lanes point at the scratch page with pos 0), then
collects: prefill completions first (their first token is sampled from the
chunk's logits), then decode emissions. Finished slots return their pages
and are refilled from the queue.

**Speculative decoding** (``speculative=k``): each tick a self-drafting
source (``serving.prefix_cache.PromptLookupDraft``: n-gram lookup over the
slot's own context, no second model) proposes up to k tokens per slot, and
ONE verify step (``core.steps.make_verify_step``) scores all k+1 positions,
writing their KV through the block table.  ``speculative_sample`` emits
1..k+1 tokens per slot, token-identical to the one-token path.  Rejected
drafts need no device rollback: ``pos`` advances only past emitted tokens
and validity masks the rest until it is overwritten.  Admission budgets +k
tokens of page headroom all or nothing (``Admission.spec``); a slot whose
drafts miss ``SPEC_DISABLE_AFTER`` times in a row stops drafting and
returns the headroom (``Scheduler.on_spec_trim``).  A tick where no slot
drafts runs the plain decode step.

**int8 page pools** (paged, ``plan.kv_cache_dtype == "int8"``): every token
row is quantized with its own scale as it is written; after each tick's
admissions the engine zeroes, in place, the scale rows of the pages freed
since the last tick (``PageAllocator.take_scale_dirty``), so a recycled
page never pairs a fresh payload with a stale scale.

**SSM archs** (mamba2), paged: each admission also gets one recurrent-state
**slab** (``SlabAllocator``; ``batch_slots + 1`` slabs, slab 0 scratch),
zeroed at admission so the previous owner's state cannot leak into the new
request; prefill chunks and decode steps read and write it by slab id, and
idle lanes point at the scratch slab.  A pure-SSM arch has no KV pool and
budgets no pages.  ``plan.ssm_cache_dtype == "int8"`` stores the slabs as
int8 with per-(slab, head) scales.  Speculation is refused: an SSM
recurrence advances one token per step.  The FCFS engine never preempts, so
the JAX engine's host stash of a preempted slab has no counterpart yet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.kvcache import (SCRATCH_PAGE, SCRATCH_SLAB,
                                      PageAllocator, SlabAllocator,
                                      cache_profile, pages_needed)
from repro_torch.core.model import Decoder, check_supported, tree_map
from repro_torch.core.partition import kv_pool_is_quantized
from repro_torch.core.steps import (make_decode_step, make_paged_decode_step,
                                    make_prefill_chunk_step, make_prefill_step,
                                    make_verify_step, zero_cache_for,
                                    zero_paged_cache_for)
from repro_torch.serving.prefix_cache import PromptLookupDraft
from repro_torch.serving.sampler import (SamplerConfig, sample_from_logits,
                                         speculative_sample)
from repro_torch.serving.scheduler import (Admission, FCFSScheduler,
                                           effective_prompt)

# consecutive zero-accept verify steps after which a slot stops drafting
# and returns its draft-headroom pages (the speculation is clearly not
# paying for its pages and compute on this request)
SPEC_DISABLE_AFTER = 4


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (S,) int32
    max_new_tokens: int = 32
    seed: Optional[int] = None         # sampling stream seed (default: rid)
    rng: Optional[np.random.RandomState] = None   # set at submit
    out_tokens: list = field(default_factory=list)
    done: bool = False
    t_submit: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0


@dataclass
class EngineStats:
    ticks: int = 0
    prefills: int = 0
    decoded_tokens: int = 0
    tick_wall_s: float = 0.0           # total wall time inside tick()
    tpot_s: list = field(default_factory=list)
    request_ttft: dict = field(default_factory=dict)   # rid -> seconds
    spec_steps: int = 0                # verify slot-steps with a draft
    spec_drafted: int = 0              # draft tokens proposed to the verifier
    spec_accepted: int = 0             # draft tokens accepted
    spec_emitted: int = 0              # tokens emitted by drafted slot-steps
    spec_draft_lookups: int = 0        # draft-source queries
    spec_draft_hits: int = 0           # ... that produced a usable draft
    spec_denied: int = 0               # admissions denied draft headroom

    @property
    def ttft_s(self) -> list:
        """TTFT samples in first-token order."""
        return list(self.request_ttft.values())

    @property
    def accepted_tokens_per_tick(self) -> float:
        """Tokens emitted per drafted verify slot-step (> 1.0 means the
        speculation beats the one-token path)."""
        return self.spec_emitted / self.spec_steps if self.spec_steps \
            else 0.0

    @property
    def draft_hit_rate(self) -> float:
        return self.spec_draft_hits / self.spec_draft_lookups \
            if self.spec_draft_lookups else 0.0


class ServingEngine:
    def __init__(self, cfg, plan, batch_slots: int, seq_budget: int, params,
                 *, paged: bool = False, page_size: int = 16,
                 n_pages: int = 0, prefill_chunk: int = 16,
                 eos_id: int = 1, rng_seed: int = 0, speculative: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        check_supported(cfg)
        if speculative < 0:
            raise ValueError(f"speculative must be >= 0, got {speculative}")
        prof = cache_profile(cfg)
        if speculative > 0 and not paged:
            raise ValueError("speculative decoding requires the paged engine")
        if speculative > 0 and prof != {"kv"}:
            raise ValueError(
                f"speculative decoding is unsupported for arch "
                f"'{cfg.name}': the k-token verify step covers "
                f"attention-only decoders (cache kinds {sorted(prof)}) "
                f"— SSM recurrences advance one token per step and "
                f"enc-dec verify is not implemented")
        if paged and (seq_budget % page_size or seq_budget % prefill_chunk):
            raise ValueError(f"seq_budget {seq_budget} must be a multiple of "
                             f"page_size {page_size} and prefill_chunk "
                             f"{prefill_chunk}")
        self.cfg, self.plan = cfg, plan
        self.paged = bool(paged)
        self.has_slabs = self.paged and "ssm" in prof
        self.n_slabs = batch_slots + 1 if self.has_slabs else 0
        self.B = batch_slots
        self.S = seq_budget
        self.eos = eos_id
        self.sampler = SamplerConfig()          # greedy
        self.rng_seed = rng_seed
        self.model = Decoder(tree_map(lambda t: t.to(self.device), params))
        self.params = self.model.tree()
        self.stats = EngineStats()
        self.speculative = int(speculative)
        self.quant_pools = self.paged and kv_pool_is_quantized(plan) and \
            "kv" in prof
        self.allocator = self.slab_allocator = None
        self.verify_fn = self.draft_source = None
        if self.paged:
            n_pages = n_pages or batch_slots * (seq_budget // page_size) + 1
            self.page_size = page_size
            self.chunk = prefill_chunk
            self.n_max_pages = seq_budget // page_size
            self.allocator = PageAllocator(n_pages)
            if self.has_slabs:
                self.slab_allocator = SlabAllocator(self.n_slabs)
            self.sched = FCFSScheduler(seq_budget=seq_budget,
                                       allocator=self.allocator,
                                       page_size=page_size,
                                       spec_tokens=self.speculative,
                                       stats=self.stats,
                                       slab_allocator=self.slab_allocator,
                                       kv_pages="kv" in prof)
            self.cache = zero_paged_cache_for(cfg, plan, n_pages, page_size,
                                              self.device, self.n_slabs)
            self.prefill_fn = make_prefill_chunk_step(cfg, plan,
                                                      prefill_chunk,
                                                      self.n_max_pages)
            self.decode_fn = make_paged_decode_step(cfg, plan, batch_slots,
                                                    self.n_max_pages)
            if self.speculative:
                self.verify_fn = make_verify_step(cfg, plan, batch_slots,
                                                  self.speculative + 1,
                                                  self.n_max_pages)
                self.draft_source = PromptLookupDraft()
        else:
            self.sched = FCFSScheduler(seq_budget=seq_budget,
                                       stats=self.stats)
            self.cache = zero_cache_for(cfg, plan, batch_slots, seq_budget,
                                        self.device)
            self.prefill_fn = make_prefill_step(cfg, plan, seq_budget)
            self.decode_fn = make_decode_step(cfg, plan, batch_slots,
                                              seq_budget)
        self.admissions: List[Optional[Admission]] = [None] * self.B
        self.slot_state: List[Optional[str]] = [None] * self.B
        self.pos = np.zeros(self.B, np.int32)
        self.last_token = np.zeros(self.B, np.int32)
        self.prefill_done = np.zeros(self.B, np.int32)
        self.spec_miss = np.zeros(self.B, np.int32)
        self._rids: set = set()

    @classmethod
    def build_paged(cls, cfg, plan, batch_slots: int, seq_budget: int,
                    params, *, page_size: int = 16, n_pages: int = 0,
                    prefill_chunk: int = 16, eos_id: int = 1,
                    rng_seed: int = 0, speculative: int = 0, device="cuda"):
        """A paged engine.  ``n_pages`` defaults to full occupancy (every
        slot at budget) plus the scratch page; pass something smaller to
        exercise admission control under memory pressure.
        ``speculative=k`` > 0 verifies up to k prompt-lookup drafts per slot
        in one step."""
        return cls(cfg, plan, batch_slots, seq_budget, params, paged=True,
                   page_size=page_size, n_pages=n_pages,
                   prefill_chunk=prefill_chunk, eos_id=eos_id,
                   rng_seed=rng_seed, speculative=speculative, device=device)

    # ------------------------------------------------------------------ API
    def has_pending(self) -> bool:
        return self.sched.has_pending()

    def submit(self, req: Request):
        if req.rid in self._rids:     # rids key the per-request stats
            raise RuntimeError(f"duplicate request id {req.rid}")
        self.sched.submit(req)        # raises on infeasible requests
        self._rids.add(req.rid)
        if req.rng is None:
            seed = req.seed if req.seed is not None else req.rid
            req.rng = np.random.RandomState([self.rng_seed, seed])
        req.t_submit = time.monotonic()

    def run(self, max_ticks: int = 10_000):
        while (self.has_pending() or
               any(a is not None for a in self.admissions)) and \
                self.stats.ticks < max_ticks:
            self.tick()
        return self.stats

    def drain(self) -> int:
        """Abort every in-flight admission, returning its pages and slab
        (paged engine).  Aborted requests keep ``done=False``; queued requests stay
        queued.  -> number of slots drained."""
        n = 0
        for b in range(self.B):
            if self.admissions[b] is not None:
                self.sched.on_finish(self.admissions[b])
                self._clear_slot(b)
                n += 1
        return n

    # ----------------------------------------------------------------- tick
    def tick(self):
        t0 = time.monotonic()
        if self.paged:
            self._tick_paged()
        elif not self._tick_contiguous():
            return                 # nothing in flight: not a counted tick
        self.stats.ticks += 1
        self.stats.tick_wall_s += time.monotonic() - t0

    def _tick_contiguous(self) -> bool:
        """Admit into free slots (each prefilled at admission), then one
        decode step over every lane.  -> False when no slot is in flight
        after admission (no decode step ran)."""
        free = [b for b in range(self.B) if self.admissions[b] is None]
        for adm in self.sched.plan(free):
            self.admissions[adm.slot] = adm
            self._prefill_into(adm.slot, adm.req)
        live = list(self.admissions)
        if all(a is None for a in live):
            return False
        logits, self.cache = self.decode_fn(
            self.params, self.cache,
            self._to_device(self.last_token[:, None], torch.int64),
            self._to_device(self.pos))
        logits = logits.float().cpu().numpy()
        now = time.monotonic()
        for b, adm in enumerate(live):
            if adm is None:
                continue
            self.pos[b] += 1        # the decode step wrote last_token's KV
            self._emit(b, adm.req, self._sample(logits, b, adm.req), now)
        return True

    def _prefill_into(self, b: int, req: Request):
        """Empty slot b's lanes in place (zeros; pos -1 marks every ring
        slot empty, as in a fresh lane), prefill ``req``'s exact prompt
        straight into them, and emit the token sampled from the prompt's
        last logits: the first generated token."""
        lane = [[{kind: {name: t[:, b:b + 1] for name, t in leaves.items()}
                  for kind, leaves in entry.items()} for entry in group]
                for group in self.cache]
        for group in lane:
            for entry in group:
                for leaves in entry.values():
                    for t in leaves.values():        # (reps, 1, ...) views
                        t.fill_(-1 if t.dtype == torch.int32 else 0)
        prompt = np.asarray(req.prompt, np.int64)[None]
        logits, _ = self.prefill_fn(self.params,
                                    self._to_device(prompt, torch.int64), lane)
        self.stats.prefills += 1
        self.pos[b] = len(req.prompt)
        self._emit(b, req, self._sample(logits.float().cpu().numpy(), 0, req),
                   time.monotonic())

    def _tick_paged(self):
        for adm in self.sched.plan([b for b in range(self.B)
                                    if self.admissions[b] is None]):
            b = adm.slot
            self.admissions[b] = adm
            self.slot_state[b] = "prefill"
            self.prefill_done[b] = 0
            self.pos[b] = 0
            self.last_token[b] = 0
            if self.has_slabs:
                self._zero_slab(adm.slab)
        if self.quant_pools:
            dirty = self.allocator.take_scale_dirty()
            if dirty:
                self._reset_scale_rows(dirty)
        rounds = [self._prefill_chunk(b) for b in range(self.B)
                  if self.slot_state[b] == "prefill"]
        step = self._decode_step()
        self._collect(rounds, step)

    def _reset_scale_rows(self, pids):
        """Zero, in place, the scale rows of recycled pages: scale 0
        dequantizes to exact zeros, so rows past a new occupant's length
        can never pair its payload with the previous owner's scales."""
        idx = torch.tensor(pids, dtype=torch.long, device=self.device)
        for group in self.cache:
            for entry in group:
                entry["kv"]["ksp"][:, idx] = 0.0
                entry["kv"]["vsp"][:, idx] = 0.0

    def _zero_slab(self, slab: int):
        """Zero, in place, slab ``slab`` of every SSM layer (state, conv
        tails and, for int8 slabs, scales): the previous owner's state
        must not leak into the new request."""
        for group in self.cache:
            for entry in group:
                for pool in entry.get("ssm", {}).values():
                    pool[:, slab] = 0

    def _slab_id(self, b: int, active: bool = True) -> int:
        adm = self.admissions[b]
        return adm.slab if (active and adm is not None
                            and adm.slab is not None) else SCRATCH_SLAB

    def _slab_ids(self, ids):
        """The steps' ``slab_ids`` input, for SSM archs only."""
        return (self._to_device(np.asarray(ids, np.int32)),) \
            if self.has_slabs else ()

    def _to_device(self, x: np.ndarray, dtype=torch.int32):
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device,
                                                            dtype)

    def _bt_row(self, b: int) -> np.ndarray:
        row = np.full(self.n_max_pages, SCRATCH_PAGE, np.int32)
        adm = self.admissions[b]
        if adm is not None:
            row[:len(adm.pages)] = adm.pages
        return row

    def _prefill_chunk(self, b: int):
        """Advance slot b by one chunk.  -> (b, logits (1, V) on the
        device, the prompt length if this chunk completes the prompt else
        None)."""
        C = self.chunk
        prompt = effective_prompt(self.admissions[b].req)
        L, c0 = len(prompt), int(self.prefill_done[b])
        n = min(C, L - c0)
        toks = np.zeros((1, C), np.int64)
        toks[0, :n] = prompt[c0:c0 + n]
        logits, self.cache = self.prefill_fn(
            self.params, self.cache, self._to_device(toks, torch.int64), c0,
            min(L - 1 - c0, C - 1), self._to_device(self._bt_row(b)[None]),
            *self._slab_ids([self._slab_id(b)]))
        self.prefill_done[b] = c0 + C
        return b, logits, (L if c0 + C >= L else None)

    def _decode_step(self):
        """One decode-or-verify step over every decode-state slot; idle and
        prefilling lanes ride along on the scratch page with pos 0.
        -> ("decode", logits (B, V) on the device, active slots), ("verify",
        logits (B, Q, V), active slots, drafts) or None."""
        active = [b for b in range(self.B) if self.slot_state[b] == "decode"]
        if not active:
            return None
        if self.speculative:
            drafts = self._plan_drafts(active)
            if drafts is not None:
                return self._dispatch_verify(active, drafts)
            # no slot drafted: the plain one-token step, as with speculation
            # off
        bt = np.stack([self._bt_row(b) if b in active else
                       np.full(self.n_max_pages, SCRATCH_PAGE, np.int32)
                       for b in range(self.B)])
        pos = np.where(np.isin(np.arange(self.B), active), self.pos, 0)
        logits, self.cache = self.decode_fn(
            self.params, self.cache,
            self._to_device(self.last_token[:, None], torch.int64),
            self._to_device(pos), self._to_device(bt),
            *self._slab_ids([self._slab_id(b, b in active)
                             for b in range(self.B)]))
        return "decode", logits, active

    def _plan_drafts(self, active: List[int]):
        """Draft up to k tokens per speculation-capable active slot.
        -> {slot: draft tokens} holding only non-empty drafts, or None when
        nothing drafted.  A slot whose drafts missed ``SPEC_DISABLE_AFTER``
        times in a row stops drafting and returns its headroom pages."""
        k = self.speculative
        drafts = {}
        for b in active:
            adm = self.admissions[b]
            if not adm.spec:
                continue
            req = adm.req
            if self.spec_miss[b] >= SPEC_DISABLE_AFTER:
                keep = pages_needed(len(req.prompt) + req.max_new_tokens,
                                    self.page_size)
                self.sched.on_spec_trim(adm, keep)
                continue
            self.stats.spec_draft_lookups += 1
            draft = self.draft_source.draft(effective_prompt(req), k)
            # verify writes KV at pos..pos+kd, which must stay inside the
            # slot's pages and the sequence budget
            cov = len(adm.pages) * self.page_size
            kd = min(len(draft), cov - 1 - int(self.pos[b]),
                     self.S - 1 - int(self.pos[b]))
            if kd <= 0:
                self.spec_miss[b] += 1
                continue
            self.stats.spec_draft_hits += 1
            drafts[b] = [int(t) for t in draft[:kd]]
        return drafts or None

    def _dispatch_verify(self, active: List[int], drafts: dict):
        """One verify step scores k+1 positions for every active slot
        (draftless slots ride along as qlen=1 rows, idle lanes on the
        scratch page with pos 0 and qlen 1)."""
        Q = self.speculative + 1
        toks = np.zeros((self.B, Q), np.int64)
        qlen = np.ones(self.B, np.int32)
        pos = np.zeros(self.B, np.int32)
        bt = np.full((self.B, self.n_max_pages), SCRATCH_PAGE, np.int32)
        for b in active:
            d = drafts.get(b, [])
            toks[b, 0] = self.last_token[b]
            toks[b, 1:1 + len(d)] = d
            qlen[b] = len(d) + 1
            pos[b] = self.pos[b]
            bt[b] = self._bt_row(b)
        logits, self.cache = self.verify_fn(
            self.params, self.cache, self._to_device(toks, torch.int64),
            self._to_device(pos), self._to_device(qlen), self._to_device(bt))
        return "verify", logits, active, drafts

    def _collect(self, rounds, step):
        """The tick's barrier: logits come to the host, prefill
        completions emit their first token (and flip to decode), then the
        decode step's slots emit theirs."""
        for b, logits, L in rounds:
            if L is None:
                continue
            adm = self.admissions[b]
            self.stats.prefills += 1
            self.sched.on_prefill_complete(adm)
            self.pos[b] = L
            self._emit(b, adm.req,
                       self._sample(logits.float().cpu().numpy(), 0, adm.req),
                       time.monotonic())
            if self.admissions[b] is not None:
                self.slot_state[b] = "decode"
        if step is None:
            return
        kind, logits, active = step[:3]
        logits = logits.float().cpu().numpy()
        now = time.monotonic()
        if kind == "decode":
            for b in active:
                self.pos[b] += 1    # the decode step wrote last_token's KV
                self._emit(b, self.admissions[b].req,
                           self._sample(logits, b, self.admissions[b].req),
                           now)
            return
        drafts = step[3]
        for b in active:
            req = self.admissions[b].req
            d = drafts.get(b, [])
            out = speculative_sample(logits[b, :len(d) + 1], d, self.sampler,
                                     self.cfg.vocab_size, req.rng)
            emitted = 0
            for tok in out:
                self.pos[b] += 1    # verify wrote this position's KV
                self._emit(b, req, tok, now)
                emitted += 1
                if self.admissions[b] is None:
                    break           # retired mid-accept: drop the tail
            if d:
                self.stats.spec_steps += 1
                self.stats.spec_drafted += len(d)
                self.stats.spec_accepted += emitted - 1
                self.stats.spec_emitted += emitted
                if self.admissions[b] is not None:   # retired slots reset
                    self.spec_miss[b] = 0 if emitted > 1 \
                        else self.spec_miss[b] + 1

    def _sample(self, logits: np.ndarray, row: int, req: Request) -> int:
        return int(sample_from_logits(logits[row:row + 1], self.sampler,
                                      self.cfg.vocab_size, req.rng)[0])

    def _emit(self, b: int, req: Request, tok: int, now: float):
        """Record one generated token for slot b; retire the slot when done.
        Decode ticks advance ``pos`` past the KV they wrote before emitting;
        prefill completion leaves it at the prompt length."""
        if not req.out_tokens:
            req.t_first_token = now
            self.stats.request_ttft[req.rid] = now - req.t_submit
        req.out_tokens.append(tok)
        self.last_token[b] = tok
        self.stats.decoded_tokens += 1
        if tok == self.eos or len(req.out_tokens) >= req.max_new_tokens \
                or self.pos[b] >= self.S - 1:
            req.done = True
            req.t_done = now
            self.stats.tpot_s.append(
                (now - req.t_first_token) / max(len(req.out_tokens) - 1, 1))
            self.sched.on_finish(self.admissions[b])
            self._clear_slot(b)

    def _clear_slot(self, b: int):
        self.admissions[b] = None
        self.slot_state[b] = None
        self.pos[b] = 0
        self.last_token[b] = 0
        self.prefill_done[b] = 0
        self.spec_miss[b] = 0
