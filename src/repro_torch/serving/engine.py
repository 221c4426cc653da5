"""Serving engine: continuous batching over contiguous lanes, or over the
prefill-chunk and decode steps of the paged cache.

Port of the JAX package's ``serving/engine.py`` for one replica (dp=1),
FCFS admission and greedy sampling.  The engine is mechanism: it owns the
cache, block tables and positions and runs the steps; admission and page
budgeting live in ``serving.scheduler``.

**Compiled steps and their traffic.**  Every fixed-shape step (the paged
decode, verify and prefill chunk, the contiguous decode) is captured once
into a CUDA graph at construction (``core.graphs.compile_step``: the
counterpart of the JAX steps' ``jax.jit``) and replayed; the step ends with
the greedy argmax on the card (``logits[..., :vocab].float().argmax(-1)``,
the first maximal index as ``np.argmax`` takes it), so token ids, not
logits, come back.  Each step kind's inputs are packed into one integer
buffer with two pinned host halves, used in turn, each guarded by an event
so a copy still in flight is never overwritten: a dispatch fills a half and
sends it in ONE non-blocking copy.  The ids of every step of a tick land in
one device buffer, which comes back in ONE non-blocking copy to pinned
memory behind an event.  ``graphs=False`` runs the same steps eagerly (the
counterpart of ``jax.disable_jit``), so the card can hold the two against
each other.  On the CPU the steps run eagerly: the caller asked for it.

**Contiguous engine** (``ServingEngine(...)``, ``paged=False``, the JAX
launcher's default): every slot owns a lane of ``seq_budget`` tokens.
Each tick admits the queue's head into every free slot and prefills its
exact prompt (``steps.make_prefill_step``, eager: one shape per prompt
length, as JAX retraces it per length; flash attention over the whole
prompt, or the SSD scan from a zero state) straight into the slot's lane,
emptied in place first (zeros, ``pos = -1``), which leaves the lane as
JAX's copy of a fresh batch-1 lane does; the slot's first token is emitted
at prefill completion.  Then ONE decode step runs over all slots
(``steps.make_decode_step``, the decode-attention kernel over the lanes)
and is collected in the same tick; idle lanes run with token 0 and pos 0
and their ids are ignored.  A slot retires at its token budget, at EOS, or
when its position reaches ``seq_budget - 1``, so a lane's ring never
wraps.  int8 lanes (``plan.kv_cache_dtype == "int8"``) store K/V at the
fixed scale ``blocks.KVQ``; an SSM arch's lane holds its float32 state and
conv tails.  Speculation needs the paged engine, and ``overlap`` is
ignored, as in JAX.  A tick with no slot in flight after admission is not
counted, as in JAX.

**Paged engine** (``build_paged``): a fixed decode batch of ``batch_slots``
slots.  Each tick is the JAX engine's pipelined plan -> collect ->
dispatch (``overlap=True``, the default):

- **plan** (host, while the previous tick's steps run on the card): admit
  what the pool can hold (each admission gets its whole page run up front
  -- prompt + max_new_tokens -- or waits); zero the new slots' state slabs
  and the scale rows of pages freed since the last plan, in place, their
  ids through the same staging.  That device work is enqueued behind the
  in-flight steps on the one stream, so it needs no fence.
- **collect** (the tick's only barrier): wait for the previous dispatch's
  ids copy, then emit in dispatch order: prefill completions first (their
  first token), then decode or verify emissions; a slot retired or
  re-admitted since dispatch is skipped by its (slot, rid) guard.
- **dispatch** (returns without blocking): advance every prefilling slot
  by one chunk (one replay each), then run ONE decode (or verify) step
  over all slots (idle and prefilling lanes point at the scratch page with
  pos 0), and send the ids home.

``overlap=False`` collects in the same tick: the serial loop, token-
identical (greedy outputs do not depend on when a slot is admitted).
``run()`` and ``drain()`` collect in-flight work first.  Finished slots
return their pages at collect, before the next dispatch, so the host only
ever plans pages and slabs that no in-flight step references.

**Speculative decoding** (``speculative=k``): in dispatch a self-drafting
source (``serving.prefix_cache.PromptLookupDraft``: n-gram lookup over the
slot's own context, no second model) proposes up to k tokens per slot, and
ONE verify step (``core.steps.make_verify_step``) scores all k+1
positions, writing their KV through the block table.  Collect emits 1..k+1
tokens per slot by greedy acceptance over the verify step's ids
(``sampler.greedy_accept``, ``speculative_sample``'s greedy branch),
token-identical to the one-token path.  Rejected drafts need no device
rollback: ``pos`` advances only past emitted tokens and validity masks the
rest until it is overwritten.  Admission budgets +k tokens of page headroom
all or nothing (``Admission.spec``); a slot whose drafts miss
``SPEC_DISABLE_AFTER`` times in a row stops drafting and returns the
headroom (``Scheduler.on_spec_trim``).  A tick where no slot drafts runs
the plain decode step.

**int8 page pools** (paged, ``plan.kv_cache_dtype == "int8"``): every token
row is quantized with its own scale as it is written; the plan zeroes, in
place, the scale rows of the pages freed since the last plan
(``PageAllocator.take_scale_dirty``), so a recycled page never pairs a
fresh payload with a stale scale.

**SSM archs** (mamba2), paged: each admission also gets one recurrent-state
**slab** (``SlabAllocator``; ``batch_slots + 1`` slabs, slab 0 scratch),
zeroed at admission so the previous owner's state cannot leak into the new
request; prefill chunks and decode steps read and write it by slab id, and
idle lanes point at the scratch slab.  A pure-SSM arch has no KV pool and
budgets no pages.  ``plan.ssm_cache_dtype == "int8"`` stores the slabs as
int8 with per-(slab, head) scales.  Speculation is refused: an SSM
recurrence advances one token per step.  The FCFS engine never preempts, so
the JAX engine's host stash of a preempted slab, its deferred preemptions
and its copy-on-write and handoff rounds have no counterpart yet.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.graphs import EagerStep, compile_step
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
from repro_torch.serving.sampler import greedy_accept, greedy_ids
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
    """Counters of a run.  The pipeline's, as in JAX: ``plan_ahead_ticks``
    (plan phases run with a dispatch still in flight), ``collect_wait_s``
    (host time blocked waiting for ids), ``device_busy_s`` (dispatch to
    collect intervals) and ``plan_invalidations``, which stays 0: the
    FCFS engine never preempts, so no plan is ever rolled back."""
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
    plan_ahead_ticks: int = 0          # plan phases run with work in flight
    plan_invalidations: int = 0        # planned entries rolled back (none)
    collect_wait_s: float = 0.0        # host time blocked at collect points
    device_busy_s: float = 0.0         # dispatch->collect device intervals

    @property
    def device_busy_fraction(self) -> float:
        """Fraction of tick wall time with dispatched work in flight, an
        overlap health proxy (dispatch-to-collect intervals over total tick
        time; approximate, since the device may finish before collect)."""
        return min(self.device_busy_s / self.tick_wall_s, 1.0) \
            if self.tick_wall_s else 0.0

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


class Staging:
    """A step kind's inputs packed into one integer buffer of ``rows`` rows:
    two host halves (pinned on the card), filled and sent in turn, and the
    device buffer they are copied to.  A half is reused only after the
    event recorded behind its last copy (one tick back at least, and long
    past by then: a collect has waited for a later event since)."""

    def __init__(self, fields, device, rows: int = 1, dtype=torch.int32):
        self.slots, o = {}, 0
        for name, shape in fields:
            n = math.prod(shape)
            self.slots[name] = (o, n, tuple(shape))
            o += n
        self.cuda = device.type == "cuda"
        self.halves = [torch.zeros((rows, o), dtype=dtype,
                                   pin_memory=self.cuda) for _ in range(2)]
        self.events = [torch.cuda.Event() if self.cuda else None
                       for _ in range(2)]
        self.dev = torch.zeros((rows, o), dtype=dtype, device=device)
        self.turn = 0

    def split(self, flat) -> dict:
        """A flat row (tensor or array) as its fields, views in order."""
        return {name: flat[o:o + n].reshape(shape)
                for name, (o, n, shape) in self.slots.items()}

    def host(self) -> np.ndarray:
        """The next half to fill, (rows, width)."""
        ev = self.events[self.turn]
        if ev is not None and not ev.query():
            ev.synchronize()          # never hit in a tick (see the class)
        return self.halves[self.turn].numpy()

    def send(self, count: Optional[int] = None):
        """Copy the filled half's first ``count`` elements (all by default)
        to the device without blocking; the half is in flight until its
        event."""
        src, dst = self.halves[self.turn].view(-1), self.dev.view(-1)
        n = src.numel() if count is None else count
        dst[:n].copy_(src[:n], non_blocking=True)
        if self.cuda:
            self.events[self.turn].record()
        self.turn ^= 1


class ServingEngine:
    def __init__(self, cfg, plan, batch_slots: int, seq_budget: int, params,
                 *, paged: bool = False, page_size: int = 16,
                 n_pages: int = 0, prefill_chunk: int = 16,
                 eos_id: int = 1, rng_seed: int = 0, speculative: int = 0,
                 overlap: bool = True, graphs: bool = True, device="cuda"):
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
        self.overlap = bool(overlap) and self.paged
        self.graphs = bool(graphs)
        self.has_slabs = self.paged and "ssm" in prof
        self.n_slabs = batch_slots + 1 if self.has_slabs else 0
        self.B = batch_slots
        self.S = seq_budget
        self.eos = eos_id
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
        self._inflight: Optional[dict] = None
        self._build_io()
        self.steps = self._build_steps()

    @classmethod
    def build_paged(cls, cfg, plan, batch_slots: int, seq_budget: int,
                    params, *, page_size: int = 16, n_pages: int = 0,
                    prefill_chunk: int = 16, eos_id: int = 1,
                    rng_seed: int = 0, speculative: int = 0,
                    overlap: bool = True, graphs: bool = True,
                    device="cuda"):
        """A paged engine.  ``n_pages`` defaults to full occupancy (every
        slot at budget) plus the scratch page; pass something smaller to
        exercise admission control under memory pressure.
        ``speculative=k`` > 0 verifies up to k prompt-lookup drafts per slot
        in one step.  ``overlap=False`` is the serial loop; ``graphs=False``
        runs the steps eagerly."""
        return cls(cfg, plan, batch_slots, seq_budget, params, paged=True,
                   page_size=page_size, n_pages=n_pages,
                   prefill_chunk=prefill_chunk, eos_id=eos_id,
                   rng_seed=rng_seed, speculative=speculative,
                   overlap=overlap, graphs=graphs, device=device)

    # -------------------------------------------------------- steps and io
    def _build_io(self):
        """Staging for every step kind's inputs, and the ids buffer: one
        row of ids per prefill round of a tick (at most one a slot), then
        the decode step's B ids or the verify step's B x Q."""
        dev, B = self.device, self.B
        io = {"decode": [("tokens", (B, 1)), ("pos", (B,))]}
        if self.paged:
            slab = [("slab_ids", (B,))] if self.has_slabs else []
            nm = self.n_max_pages
            io["decode"] += [("block_table", (B, nm))] + slab
            io["chunk"] = ([("tokens", (1, self.chunk)), ("chunk_start", (1,)),
                            ("last_idx", (1,)), ("block_table", (1, nm))]
                           + ([("slab_ids", (1,))] if self.has_slabs else []))
            if self.speculative:
                io["verify"] = [("tokens", (B, self.speculative + 1)),
                                ("pos", (B,)), ("qlen", (B,)),
                                ("block_table", (B, nm))]
        else:
            io["prompt"] = [("tokens", (1, self.S))]
        self.io = {kind: Staging(fields, dev, rows=B if kind == "chunk" else 1)
                   for kind, fields in io.items()}
        if self.paged:
            # the chunk graph's static inputs: each round's row is copied
            # here on the card before its replay
            self._chunk_in = torch.zeros(self.io["chunk"].dev.shape[1],
                                         dtype=torch.int32, device=dev)
            # ids of slabs to zero and pages whose scale rows to reset
            self.io["plan"] = Staging(
                [("ids", (self.allocator.n_pages + self.n_slabs,))], dev,
                dtype=torch.int64)
        n_out = B + B * (self.speculative + 1)
        self._out = torch.zeros(n_out, dtype=torch.int32, device=dev)
        cuda = dev.type == "cuda"
        self._out_host = torch.zeros(n_out, dtype=torch.int32,
                                     pin_memory=cuda)
        self._out_np = self._out_host.numpy()
        self._out_event = torch.cuda.Event() if cuda else None

    def _build_steps(self) -> dict:
        """Each fixed-shape step over its static inputs, ending in the
        greedy ids: captured in a CUDA graph on the card (``graphs``),
        else eager.  The contiguous whole-prompt prefill stays eager (one
        shape per prompt length)."""
        make = compile_step if self.graphs else EagerStep
        V = self.cfg.vocab_size

        def run(name):
            # the step function is looked up at every call, so an eager
            # step runs whatever is installed on the engine
            def step(*ins):
                logits = getattr(self, name)(self.params, self.cache, *ins)[0]
                return logits, greedy_ids(logits, V)
            return step

        def inputs(kind, flat=None):
            io = self.io[kind]
            return tuple(io.split(io.dev[0] if flat is None else flat).values())

        steps = {"decode": make(run("decode_fn"), inputs("decode"))}
        if self.paged:
            steps["chunk"] = make(run("prefill_fn"),
                                  inputs("chunk", self._chunk_in))
            if self.speculative:
                steps["verify"] = make(run("verify_fn"), inputs("verify"))
        return steps

    def _send_out(self, inflight: dict):
        """Send the tick's ids home in one copy behind an event; collect
        waits for it."""
        self._out_host.copy_(self._out, non_blocking=True)
        if self._out_event is not None:
            self._out_event.record()
        self._inflight = dict(inflight, t_dispatch=time.monotonic())

    def _wait_out(self):
        t0 = time.monotonic()
        if self._out_event is not None:
            self._out_event.synchronize()
        t1 = time.monotonic()
        self.stats.collect_wait_s += t1 - t0
        return t1

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
        # collect what is still in flight (after max_ticks), so emitted
        # tokens and retirements land before the caller looks or drains
        self._barrier()
        return self.stats

    def _barrier(self):
        """Collect any in-flight dispatch; the engine is then idle."""
        if self._inflight is not None:
            self._collect_phase()

    def drain(self) -> int:
        """Abort every in-flight admission, returning its pages and slab
        (paged engine), after collecting in-flight work.  Aborted requests
        keep ``done=False``; queued requests stay queued.  -> number of
        slots drained."""
        self._barrier()
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
        decode step over every lane, collected at once.  -> False when no
        slot is in flight after admission (no decode step ran)."""
        free = [b for b in range(self.B) if self.admissions[b] is None]
        for adm in self.sched.plan(free):
            self.admissions[adm.slot] = adm
            self._prefill_into(adm.slot, adm.req)
        live = [b for b in range(self.B) if self.admissions[b] is not None]
        if not live:
            return False
        self._send_out({"pf": [], "step": self._dispatch_decode(live)})
        self._collect_phase()
        return True

    def _prefill_into(self, b: int, req: Request):
        """Empty slot b's lanes in place (zeros; pos -1 marks every ring
        slot empty, as in a fresh lane), prefill ``req``'s exact prompt
        straight into them, and emit the greedy token of the prompt's last
        logits: the first generated token."""
        lane = [[{kind: {name: t[:, b:b + 1] for name, t in leaves.items()}
                  for kind, leaves in entry.items()} for entry in group]
                for group in self.cache]
        for group in lane:
            for entry in group:
                for leaves in entry.values():
                    for t in leaves.values():        # (reps, 1, ...) views
                        t.fill_(-1 if t.dtype == torch.int32 else 0)
        L = len(req.prompt)
        io = self.io["prompt"]
        io.host()[0, :L] = req.prompt
        io.send(L)
        logits, _ = self.prefill_fn(self.params, io.dev[:, :L], lane)
        self._out[:1].copy_(greedy_ids(logits, self.cfg.vocab_size))
        self._out_host[:1].copy_(self._out[:1], non_blocking=True)
        if self._out_event is not None:
            self._out_event.record()
        now = self._wait_out()
        self.stats.prefills += 1
        self.pos[b] = L
        self._emit(b, req, int(self._out_np[0]), now)

    def _tick_paged(self):
        """One pipelined tick: plan (host; overlaps the previous dispatch
        on the card), collect (the tick's one barrier: the previous
        dispatch's ids), dispatch this tick's steps.  ``overlap=False``
        collects the fresh dispatch at once: the serial loop."""
        self._plan_phase()
        self._collect_phase()
        self._dispatch_phase()
        if not self.overlap:
            self._collect_phase()

    # ------------------------------------------------------------ plan phase
    def _plan_phase(self):
        """Admissions, and in-place zeroing of the new slots' slabs and of
        the scale rows of pages freed since the last plan.  Freed pages and
        slabs were released at a collect, so no in-flight step reads them;
        the zeroing rides the stream behind the in-flight steps."""
        if self._inflight is not None:
            self.stats.plan_ahead_ticks += 1
        slabs = []
        for adm in self.sched.plan([b for b in range(self.B)
                                    if self.admissions[b] is None]):
            b = adm.slot
            self.admissions[b] = adm
            self.slot_state[b] = "prefill"
            self.prefill_done[b] = 0
            self.pos[b] = 0
            self.last_token[b] = 0
            if self.has_slabs:
                slabs.append(adm.slab)
        pids = self.allocator.take_scale_dirty() if self.quant_pools else []
        if slabs or pids:
            self._zero_rows(slabs, pids)

    def _zero_rows(self, slabs, pids):
        """Zero, in place, slabs ``slabs`` of every SSM layer (state, conv
        tails and, for int8 slabs, scales: the previous owner's state must
        not leak into the new request) and the scale rows of recycled pages
        ``pids`` (scale 0 dequantizes to exact zeros, so rows past a new
        occupant's length can never pair its payload with the previous
        owner's scales).  The ids go through the plan staging."""
        io = self.io["plan"]
        ids = io.host()[0]
        ids[:len(slabs)] = slabs
        ids[len(slabs):len(slabs) + len(pids)] = pids
        io.send(len(slabs) + len(pids))
        dev = io.dev[0]
        sid, pid = dev[:len(slabs)], dev[len(slabs):len(slabs) + len(pids)]
        for group in self.cache:
            for entry in group:
                if slabs:
                    for pool in entry.get("ssm", {}).values():
                        pool.index_fill_(1, sid, 0)
                if pids and "kv" in entry:
                    entry["kv"]["ksp"].index_fill_(1, pid, 0.0)
                    entry["kv"]["vsp"].index_fill_(1, pid, 0.0)

    # --------------------------------------------------------- collect phase
    def _collect_phase(self):
        """Wait for the in-flight dispatch's ids, then emit in dispatch
        order: prefill completions (first token, flip to decode), then the
        decode or verify step's tokens.  A slot retired since dispatch is
        skipped by its (slot, rid) guard."""
        inf = self._inflight
        if inf is None:
            return
        self._inflight = None
        t1 = self._wait_out()
        self.stats.device_busy_s += t1 - inf["t_dispatch"]
        ids = self._out_np
        for i, (b, rid, L) in enumerate(inf["pf"]):
            adm = self.admissions[b]
            if L is None or adm is None or adm.req.rid != rid:
                continue
            self.stats.prefills += 1
            self.sched.on_prefill_complete(adm)
            self.pos[b] = L
            self._emit(b, adm.req, int(ids[i]), time.monotonic())
            if self.admissions[b] is not None:
                self.slot_state[b] = "decode"
        step = inf["step"]
        if step is None:
            return
        now = time.monotonic()
        out = ids[self.B:]
        if step[0] == "decode":
            for b, rid in step[1]:
                adm = self.admissions[b]
                if adm is None or adm.req.rid != rid:
                    continue
                self.pos[b] += 1    # the decode step wrote last_token's KV
                self._emit(b, adm.req, int(out[b]), now)
            return
        Q, drafts = self.speculative + 1, step[2]
        for b, rid in step[1]:
            adm = self.admissions[b]
            if adm is None or adm.req.rid != rid:
                continue
            req = adm.req
            d = drafts.get(b, [])
            emitted = 0
            for tok in greedy_accept(out[b * Q:b * Q + len(d) + 1], d):
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

    # -------------------------------------------------------- dispatch phase
    def _dispatch_phase(self):
        """Enqueue this tick's steps and return without blocking: a chunk
        round per prefilling slot, then the decode-or-verify step, then the
        ids' copy home."""
        pf = self._dispatch_prefill()
        step = self._dispatch_step()
        if pf or step is not None:
            self._send_out({"pf": pf, "step": step})

    def _slab_id(self, b: int, active: bool = True) -> int:
        adm = self.admissions[b]
        return adm.slab if (active and adm is not None
                            and adm.slab is not None) else SCRATCH_SLAB

    def _bt_row(self, b: int) -> np.ndarray:
        row = np.full(self.n_max_pages, SCRATCH_PAGE, np.int32)
        adm = self.admissions[b]
        if adm is not None:
            row[:len(adm.pages)] = adm.pages
        return row

    def _dispatch_prefill(self) -> list:
        """Advance every prefilling slot by one chunk: all rounds' inputs in
        one copy, then one replay per round.  -> [(slot, rid, prompt
        length if this chunk completes the prompt else None)], round i's
        id at ids row i."""
        rows = [b for b in range(self.B) if self.admissions[b] is not None
                and self.slot_state[b] == "prefill"]
        if not rows:
            return []
        C, io = self.chunk, self.io["chunk"]
        host, pf = io.host(), []
        for i, b in enumerate(rows):
            req = self.admissions[b].req
            prompt = effective_prompt(req)
            L, c0 = len(prompt), int(self.prefill_done[b])
            last = min(L - 1 - c0, C - 1)
            if not 0 <= last < C:
                raise ValueError(f"slot {b}: last_idx {last} outside the "
                                 f"chunk {C}")
            f = io.split(host[i])
            n = min(C, L - c0)
            f["tokens"][0, :n] = prompt[c0:c0 + n]
            f["tokens"][0, n:] = 0
            f["chunk_start"][0], f["last_idx"][0] = c0, last
            f["block_table"][0] = self._bt_row(b)
            if self.has_slabs:
                f["slab_ids"][0] = self._slab_id(b)
            self.prefill_done[b] = c0 + C
            pf.append((b, req.rid, L if c0 + C >= L else None))
        io.send(len(rows) * io.dev.shape[1])
        for i, entry in enumerate(pf):
            self._prefill_round(i, entry)
        return pf

    def _prefill_round(self, i: int, entry):
        """Replay the chunk step on round i's inputs; its id goes to ids
        row i before the next round's replay overwrites the step's own."""
        self._chunk_in.copy_(self.io["chunk"].dev[i])
        _, ids = self.steps["chunk"]()
        self._out[i:i + 1].copy_(ids)

    def _dispatch_step(self):
        """The decode-or-verify step over every decode-state slot.
        -> ("decode", [(slot, rid)]), ("verify", [(slot, rid)], drafts) or
        None."""
        active = [b for b in range(self.B) if self.slot_state[b] == "decode"]
        if not active:
            return None
        if self.speculative:
            drafts = self._plan_drafts(active)
            if drafts is not None:
                return self._dispatch_verify(active, drafts)
            # no slot drafted: the plain one-token step, as with speculation
            # off
        return self._dispatch_decode(active)

    def _dispatch_decode(self, active: List[int]):
        """One decode step over every slot; the paged engine's idle and
        prefilling lanes ride along on the scratch page (and slab) with pos
        0, the contiguous engine's idle lanes with token 0 and pos 0."""
        io = self.io["decode"]
        f = io.split(io.host()[0])
        f["tokens"][:, 0] = self.last_token
        act = np.isin(np.arange(self.B), active)
        f["pos"][:] = np.where(act, self.pos, 0)
        if self.paged:
            for b in range(self.B):
                f["block_table"][b] = self._bt_row(b) if act[b] \
                    else SCRATCH_PAGE
                if self.has_slabs:
                    f["slab_ids"][b] = self._slab_id(b, bool(act[b]))
        io.send()
        _, ids = self.steps["decode"]()
        self._out[self.B:2 * self.B].copy_(ids)
        return "decode", [(b, self.admissions[b].req.rid) for b in active]

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
        io = self.io["verify"]
        f = io.split(io.host()[0])
        f["tokens"][:] = 0
        f["qlen"][:] = 1
        f["pos"][:] = 0
        f["block_table"][:] = SCRATCH_PAGE
        for b in active:
            d = drafts.get(b, [])
            f["tokens"][b, 0] = self.last_token[b]
            f["tokens"][b, 1:1 + len(d)] = d
            f["qlen"][b] = len(d) + 1
            f["pos"][b] = self.pos[b]
            f["block_table"][b] = self._bt_row(b)
        io.send()
        _, ids = self.steps["verify"]()
        self._out[self.B:].copy_(ids.reshape(-1))
        return ("verify", [(b, self.admissions[b].req.rid) for b in active],
                drafts)

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
