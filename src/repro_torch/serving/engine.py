"""Serving engine: continuous batching over contiguous lanes, or over the
prefill-chunk and decode steps of the paged cache.

Port of the JAX package's ``serving/engine.py`` on one device, greedy or
sampled, with ``dp`` data-parallel replicas and disaggregated
prefill/decode.  The engine is mechanism: it owns the cache, block tables
and positions and runs the steps; admission order, page budgeting, prefix
reuse, eviction and preemption victims live in ``serving.scheduler`` and
``serving.policies`` (``scheduler=``: FCFS by default, or a
``PriorityScheduler``/``FairScheduler`` instance or factory).

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

**Sampled decoding** (``sampler=SamplerConfig(temperature > 0, top_k,
top_p)``): every request draws from its own stream,
``RandomState([rng_seed, seed or rid])`` made at submit, exactly one draw
per emitted row, in emission order (``serving.sampler``, the JAX package's
numpy sampler), so sampled outputs do not depend on admission order,
batch composition, preemption points or speculation, as in JAX.  A
sampled engine brings the rows it draws from to the host: each step's
logits rows (a completing chunk's last row, the decode step's B rows, the
verify step's B x Q) are copied on the card, in the logits' dtype, into
one device buffer beside the ids, before the next replay overwrites the
step's output, and come home in ONE non-blocking copy to pinned memory
behind the ids' event; collect widens them to float32 (exact from bf16)
and draws.  One host buffer suffices: collect reads it before the next
dispatch enqueues a copy into it.  Rows whose slot retired or was
preempted since dispatch are skipped by the (slot, rid) guard, so their
streams do not advance.  A greedy engine (``temperature == 0``, the
default) copies no logits: its ids come home alone.

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

- **plan** (host, while the previous tick's steps run on the card): the
  policy's preemption verdicts (applied at once when nothing is in flight,
  else deferred past collect), then admit what the pool can hold (each
  admission gets its whole page run up front -- prompt + max_new_tokens --
  or waits); zero the new slots' state slabs (or restore a preempted
  request's stash) and the scale rows of pages freed since the last plan,
  in place, their ids through the same staging.  That device work is
  enqueued behind the in-flight steps on the one stream, so it needs no
  fence.
- **collect** (the tick's only barrier): wait for the previous dispatch's
  ids copy, then emit in dispatch order: prefill completions first (their
  first token), then decode or verify emissions; a slot retired or
  re-admitted since dispatch is skipped by its (slot, rid) guard.  Then
  the deferred preemptions: a victim retired at collect is skipped and
  counted in ``plan_invalidations``.
- **dispatch** (returns without blocking): the copy-on-write page copies
  planned this tick (one replay of the copy step each), then advance every
  prefilling slot by one chunk (one replay each), then run ONE decode (or
  verify) step over all slots (idle and prefilling lanes point at the
  scratch page with pos 0), and send the ids home.

``overlap=False`` collects in the same tick: the serial loop, token-
identical (greedy outputs, and sampled ones drawn from per-request
streams, do not depend on when a slot is admitted).
``run()``, ``drain()`` and ``preempt()`` collect in-flight work first.
Finished slots return their pages at collect, before the next dispatch, so
the host only ever plans pages and slabs that no in-flight step
references.

**Prefix cache** (``prefix_cache=True``, attention-only archs): a radix
tree maps cached prompt prefixes to refcounted page runs
(``serving.prefix_cache.RadixPrefixCache``).  Admission maps the longest
cached prefix into the block table and prefill starts at the first
uncached token (``Admission.cached_len``, ``stats.prefill_tokens_skipped``);
a prefix that ends mid-page gets a private copy of that page before the
slot's first write (``core.steps.make_page_copy_step``, captured like the
other steps, ``stats.cow_copies``).  A completed prefill inserts its
prompt's full pages; LRU leaves are evicted under pool pressure.

**Preemption** (``preempt(b)``, or a policy's ``plan_preemptions``): the
victim's resident full pages are donated to the prefix cache and the
request re-queues over its effective prompt (prompt + emitted tokens), so
resume is a prefix hit: its KV is reused, not recomputed.

**Speculative decoding** (``speculative=k``): in dispatch a self-drafting
source (``serving.prefix_cache.PromptLookupDraft``: n-gram lookup over the
slot's own context, no second model) proposes up to k tokens per slot, and
ONE verify step (``core.steps.make_verify_step``) scores all k+1
positions, writing their KV through the block table.  Collect emits 1..k+1
tokens per slot by greedy acceptance over the verify step's ids
(``sampler.greedy_accept``, ``speculative_sample``'s greedy branch) or,
sampled, by ``speculative_sample`` over its logits rows (one draw per
emitted row), token-identical to the one-token path.  Rejected drafts
need no device rollback: ``pos`` advances only past emitted tokens and
validity masks the rest until it is overwritten.  Admission budgets +k
tokens of page headroom all or nothing (``Admission.spec``); a slot whose
drafts miss ``SPEC_DISABLE_AFTER`` times in a row stops drafting and
returns the headroom (``Scheduler.on_spec_trim``).  A tick where no slot drafts runs
the plain decode step.

**int8 page pools** (paged, ``plan.kv_cache_dtype == "int8"``): every token
row is quantized with its own scale as it is written; the plan zeroes, in
place, the scale rows of the pages freed since the last plan
(``PageAllocator.take_scale_dirty``), so a recycled page never pairs a
fresh payload with a stale scale.

**SSM archs** (mamba2, and the hybrid hymba), paged: each admission also
gets one recurrent-state **slab** (``SlabAllocator``; ``batch_slots + 1``
slabs, slab 0 scratch), zeroed at admission so the previous owner's state
cannot leak into the new request; prefill chunks and decode steps read and
write it by slab id, and idle lanes point at the scratch slab.  A pure-SSM
arch has no KV pool and budgets no pages; a hybrid is admitted with its
page run and its slab together, all or nothing, and frees both together.
``plan.ssm_cache_dtype == "int8"`` stores the slabs as
int8 with per-(slab, head) scales.  Speculation is refused: an SSM
recurrence advances one token per step.  The prefix cache is refused: an SSM
layer's state for a shared prefix is not addressable by pages.  A preempted
slot's slab (state, conv tails and, for int8 slabs, scales: 48 MiB for a
float32 mamba2-370m request, 6.25 MiB for hymba-1.5b) and, for a hybrid,
the payloads (and int8 scale rows) of the KV pages covering its resident
tokens are copied to pinned host memory after the barrier
(``_stash_slot``) and written into the re-admission's new slab and pages
before its first chunk (``_restore_slot``, ``stats.slab_restores``);
prefill resumes at the stashed position.

**Encoder-decoders** (seamless): a request carries its encoder input,
``Request.frames`` (enc_seq_len, d_model) frame embeddings (the audio
stub), checked at submit with JAX's messages.  The contiguous engine
encodes at every admission: the whole-prompt prefill step takes the
frames, runs the encoder and fills the slot's cross lanes, which every
decode step reads.  The paged engine pages the encoder memory's K/V into
cross pools that share the self-KV page-id space (``build_paged`` sizes
the pool for every slot's self and cross pages by default): each
admission also gets ``n_cross_pages`` read-only pages, shared by frames
digest (``serving.prefix_cache.CrossKVCache``: a later request with equal
frames takes the resident pages; a second one in the same tick shares the
pages of the first's pending encode).  A miss runs the cross-KV write step
(``core.steps.make_cross_kv_write_step``, captured like the other steps:
the encoder, every layer's cross K/V, the scatter) once, dispatched before
the tick's copy-on-write copies and prefill chunks, so no chunk reads
cross pages before they are written; the chunk and decode steps read them
through each row's cross block table (idle rows: the scratch page).
``stats`` counts ``cross_lookups``, ``cross_hits`` and ``cross_encodes``.
As in JAX, the prefix cache is refused (the self-KV depends on the frames
through cross-attention) and so is speculation.

**Replicas** (``dp`` = R > 1, paged engine only, as in JAX): R replicas of
``batch_slots`` slots each (``Bp``; global slot b = r * Bp + local, ``B``
= R * Bp), each with its own allocator, prefix cache, slab allocator,
cross-KV cache, scheduler (built by the ``scheduler`` factory, never a
shared instance) and draft source, so refcounts, prefix pins, eviction
and preemption donations never cross a replica.  The pools hold every
replica's pages folded into one (``core.kvcache``: replica r's page p is
page r * n_pages + p, the JAX layout's bytes), and every id the engine
stages for a step is folded on the host (``kvcache.fold_ids``; an idle
row of replica r reads replica r's scratch page and slab), so one step
set drives them all and no step knows of replicas: the decode and verify
steps run all B rows; the chunk, copy-on-write and cross-KV write steps
run one unit of one replica a replay, as with one replica (chunks in
JAX's round order: the first prefilling slot of each replica, then the
second, ...), so a replica with nothing to prefill costs nothing.  The
router
(``serving.router``) places every request at submit: prefix affinity over
the radix caches and the prompts routed recently, frames affinity, then
the least page load with backlog; resumes after preemption stay on their
replica.  ``stats.replicas[r]`` counts per replica.  The dp = 1
accessors (``sched``, ``allocator``, ``prefix_cache``, ``slab_allocator``,
``cross_cache``) refuse R > 1.  Sampled outputs stay schedule-invariant:
each request draws from its own stream, whatever its replica.

**Disaggregated prefill/decode** (``disagg=(P, D)``, P + D = dp,
attention-only archs): replicas 0 .. P-1 prefill and P .. dp-1 decode.
The router admits fresh requests on prefill replicas only; their slots
budget the prompt's pages alone, chunk-prefill, emit the first token at
collect and queue for handoff.  Each plan matches the queue's head (FIFO)
to the least-loaded decode replica with a free slot (``Router.
decode_placement``), whose scheduler allocates the run for resident +
remaining tokens (``plan_handoff``); the slot is claimed at plan, and
the dispatch phase moves the pages first, before this tick's steps, with
the page-transfer step (``core.steps.make_page_transfer_step``: every
self-KV pool, int8 scale rows too, from one replica's pages to the
other's, its inputs device data from a staging buffer, so one CUDA graph
serves every handoff), then moves the references (``on_handoff_sent`` ->
``kvcache.handoff_refs``) and clears the source slot.  A source evicted
in between rolls the claim back (``plan_invalidations``).  Decode
replicas run decode (or verify) steps only; ``stats.handoffs``,
``pages_transferred`` and the replicas' ``handoffs_out/_in``,
``pages_transferred_out/_in`` count them.

**Elastic replicas** (paged, a scheduler factory, no disaggregation, as in
JAX): ``scale_to(dp_new)`` and ``kill_replica(r)`` change the replica set
live, from a ``membership_hook`` fired at the top of every paged tick
(fault injection, the launcher's ``--scale-events``) or between ticks.
Both collect in-flight work first.  A scale-down drains the leaving
replicas: each active slot migrates to a survivor with a free slot (the
destination admission budgets the full horizon, ``plan_migration``; the
resident pages go through the page-transfer step, int8 scale rows too;
the references hand over, ``on_migrated``), or is preempted and requeued
where that cannot apply (slabs, cross-KV pages, no free slot, pool
pressure, a transfer that raised: the claim rolls back); then the queues
move to the survivors (``take_queued``, ``_place``).  A kill drops the
replica's state whole and re-admits its requests on the survivors as
re-prefills over prompt + emitted tokens (``runtime.ft.plan_recovery``:
active by admission order, then the queue).  Then ``_rebuild``: the step
graphs are dropped (they hold the old pools' addresses), the pools
re-scatter to the new R (``runtime.elastic.reshard_replica_pools``),
survivor ``keep[j]`` becomes replica j with its allocator, caches,
scheduler and counters (replica-local ids, folded anew at staging),
joined replicas start empty, the slot arrays, requests' replicas and the
router are rebuilt, and the step set is made and captured again at the
new R.  ``stats`` counts ``scale_events``, ``crashes``, ``migrations``,
``migrated_pages`` and ``readmitted``.

**Host spill** (``spill=HostSpillStore()``, as in JAX): cached radix and
cross-KV entries are pure functions of their tokens or frames, so their
page payloads (int8 scale rows too) are copied to host tensors keyed by
token path or frames digest (``spill_state``): at a drain, for the leaving
replicas, before the rebuild drops their rows.  After every ``scale_to``,
and when an engine is built with a store (a warm start), each entry not
resident on any replica is written into fresh pages of the least
page-loaded replica, in place, and inserted into its cache
(``_restore_from_spill``).  A kill spills nothing: a crash loses the rows.
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
                                      cache_profile, fold_ids, pages_needed)
from repro_torch.core.model import Decoder, check_supported, tree_map
from repro_torch.core.partition import kv_pool_is_quantized
from repro_torch.core.steps import (check_verify_on_card, make_decode_step,
                                    make_cross_kv_write_step,
                                    make_page_copy_step,
                                    make_page_transfer_step,
                                    make_paged_decode_step,
                                    make_prefill_chunk_step, make_prefill_step,
                                    make_verify_step, n_cross_pages,
                                    zero_cache_for, zero_paged_cache_for)
from repro_torch.runtime.elastic import reshard_replica_pools
from repro_torch.runtime.ft import RecoveryReport, plan_recovery
from repro_torch.serving.prefix_cache import (CrossKVCache, HostSpillStore,
                                              PromptLookupDraft,
                                              RadixPrefixCache)
from repro_torch.serving.router import Router
from repro_torch.serving.sampler import (SamplerConfig, greedy_accept,
                                         greedy_ids, sample_from_logits,
                                         speculative_sample)
from repro_torch.serving.scheduler import (Admission, FCFSScheduler,
                                           Scheduler, effective_prompt)

# consecutive zero-accept verify steps after which a slot stops drafting
# and returns its draft-headroom pages (the speculation is clearly not
# paying for its pages and compute on this request)
SPEC_DISABLE_AFTER = 4


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (S,) int32
    frames: Optional[np.ndarray] = None  # (enc_seq_len, d_model): enc-dec
    max_new_tokens: int = 32
    priority: int = 0                  # higher = more urgent (policies.py)
    client_id: int = 0                 # fairness accounting key (policies.py)
    seed: Optional[int] = None         # sampling stream seed (default: rid)
    rng: Optional[np.random.RandomState] = None   # set at submit
    replica: int = -1                  # routed replica (set at submit)
    out_tokens: list = field(default_factory=list)
    done: bool = False
    t_submit: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0


@dataclass
class ReplicaStats:
    """Per-replica counters (``EngineStats.replicas[r]``)."""
    role: str = "mixed"                # "prefill"/"decode" under disagg
    routed: int = 0                    # requests the router placed here
    prefills: int = 0
    decoded_tokens: int = 0
    preemptions: int = 0
    prefix_lookups: int = 0
    prefix_hits: int = 0
    cross_lookups: int = 0             # enc-dec frames-digest lookups
    cross_hits: int = 0
    spec_denied: int = 0               # admissions denied draft headroom
    handoffs_out: int = 0              # finished page runs sent (prefill)
    handoffs_in: int = 0               # ... received (decode)
    pages_transferred_out: int = 0
    pages_transferred_in: int = 0

    @property
    def prefix_hit_rate(self) -> float:
        return self.prefix_hits / self.prefix_lookups \
            if self.prefix_lookups else 0.0


@dataclass
class EngineStats:
    """Counters of a run.  The pipeline's, as in JAX: ``plan_ahead_ticks``
    (plan phases run with a dispatch still in flight), ``collect_wait_s``
    (host time blocked waiting for ids), ``device_busy_s`` (dispatch to
    collect intervals) and ``plan_invalidations`` (preemption verdicts
    deferred past collect whose victim retired there, so they were rolled
    back).  ``handoffs`` and ``pages_transferred`` count a disaggregated
    engine's page-run transfers (and, in ``pages_transferred``, an elastic
    drain's migrations); ``scale_events``, ``crashes``, ``migrations``,
    ``migrated_pages`` and ``readmitted`` count membership changes;
    ``replicas`` holds one ``ReplicaStats`` a replica."""
    ticks: int = 0
    prefills: int = 0
    decoded_tokens: int = 0
    prefill_tokens_skipped: int = 0    # prompt tokens served from the cache
    cow_copies: int = 0
    preemptions: int = 0
    prefix_lookups: int = 0
    prefix_hits: int = 0
    cross_lookups: int = 0             # enc-dec frames-digest lookups
    cross_hits: int = 0                # ... served from a shared encode
    cross_encodes: int = 0             # cross-KV write steps run
    slab_restores: int = 0             # preempted SSM state reloads
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
    plan_invalidations: int = 0        # deferred preemptions rolled back
    collect_wait_s: float = 0.0        # host time blocked at collect points
    device_busy_s: float = 0.0         # dispatch->collect device intervals
    handoffs: int = 0                  # prefill->decode page-run transfers
    pages_transferred: int = 0         # pages moved across replicas
    scale_events: int = 0              # scale_to membership changes applied
    crashes: int = 0                   # kill_replica recoveries
    migrations: int = 0                # in-flight slots moved off a drain
    migrated_pages: int = 0            # pages those migrations carried
    readmitted: int = 0                # requests re-placed by drain/recovery
    replicas: List[ReplicaStats] = field(default_factory=list)

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

    @property
    def prefix_hit_rate(self) -> float:
        return self.prefix_hits / self.prefix_lookups \
            if self.prefix_lookups else 0.0

    @property
    def cross_hit_rate(self) -> float:
        return self.cross_hits / self.cross_lookups \
            if self.cross_lookups else 0.0


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
                 eos_id: int = 1, sampler: Optional[SamplerConfig] = None,
                 rng_seed: int = 0, speculative: int = 0,
                 prefix_cache: bool = False, scheduler=None,
                 overlap: bool = True, graphs: bool = True, dp: int = 1,
                 disagg=None, spill=None, device="cuda"):
        self.device = resolve_device(device)
        check_supported(cfg)
        if speculative < 0:
            raise ValueError(f"speculative must be >= 0, got {speculative}")
        prof = cache_profile(cfg)
        if dp < 1:
            raise ValueError(f"dp must be >= 1, got {dp}")
        if dp > 1 and not paged:
            raise ValueError("dp>1 serving requires the paged engine")
        self.disagg = self.roles = None
        if disagg is not None:
            p_reps, d_reps = int(disagg[0]), int(disagg[1])
            if not paged:
                raise ValueError(
                    "disaggregated serving requires the paged engine")
            if p_reps < 1 or d_reps < 1 or p_reps + d_reps != dp:
                raise ValueError(
                    f"disagg {p_reps}:{d_reps} must cover every replica "
                    f"with at least one of each role: need P >= 1, D >= 1 "
                    f"and P + D == dp ({dp})")
            if prof != {"kv"}:
                raise ValueError(
                    f"disaggregated serving is unsupported for arch "
                    f"'{cfg.name}': the page-transfer step moves self-KV "
                    f"page runs between replica pools (cache kinds "
                    f"{sorted(prof)}) — SSM slabs and cross-KV pages do "
                    f"not hand off")
            self.disagg = (p_reps, d_reps)
            self.roles = ["prefill"] * p_reps + ["decode"] * d_reps
        if isinstance(scheduler, Scheduler) and dp > 1:
            raise ValueError("dp>1 needs a scheduler factory, not an instance")
        if isinstance(scheduler, Scheduler) and self.disagg is not None:
            raise ValueError(
                "disaggregation needs a scheduler factory, not an instance")
        if prefix_cache and not paged:
            raise ValueError("the prefix cache requires the paged engine")
        if prefix_cache and "ssm" in prof:
            raise ValueError(
                f"prefix_cache=True is unsupported for arch "
                f"'{cfg.name}': its SSM layers hold recurrent state "
                f"that a token-id prefix cannot address (cache kinds "
                f"{sorted(prof)}); run it paged without the prefix "
                f"cache")
        if prefix_cache and "cross_kv" in prof:
            raise ValueError(
                f"prefix_cache=True is unsupported for arch "
                f"'{cfg.name}': decoder self-KV depends on the "
                f"request's encoder frames through cross-attention, "
                f"so equal token prefixes do not imply equal KV; "
                f"cross-KV sharing is keyed by frames digest instead "
                f"(automatic)")
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
        if speculative > 0 and self.device.type == "cuda":
            check_verify_on_card(cfg, plan, speculative + 1)
        self.cfg, self.plan = cfg, plan
        self.paged = bool(paged)
        self.overlap = bool(overlap) and self.paged
        self.graphs = bool(graphs)
        self.has_slabs = self.paged and "ssm" in prof
        self.n_slabs = batch_slots + 1 if self.has_slabs else 0
        self.has_cross = self.paged and "cross_kv" in prof
        self.n_cross_pages = n_cross_pages(cfg, page_size) \
            if self.has_cross else 0
        self.R = dp                    # data-parallel replicas
        self.Bp = batch_slots          # slots a replica
        self.B = dp * batch_slots      # global slots (the decode batch)
        self.S = seq_budget
        self.eos = eos_id
        self.sampler = sampler or SamplerConfig()
        self.sampled = self.sampler.temperature > 0
        self.rng_seed = rng_seed
        self.model = Decoder(tree_map(lambda t: t.to(self.device), params))
        self.params = self.model.tree()
        self.stats = EngineStats(replicas=[ReplicaStats()
                                           for _ in range(dp)])
        self.speculative = int(speculative)
        self.quant_pools = self.paged and kv_pool_is_quantized(plan) and \
            ("kv" in prof or "cross_kv" in prof)
        # one of each a replica (paged); the contiguous engine has none
        self.allocators: List[PageAllocator] = []
        self.prefix_caches: List[Optional[RadixPrefixCache]] = []
        self.slab_allocators: List[SlabAllocator] = []
        self.cross_caches: List[CrossKVCache] = []
        self.draft_sources: List[PromptLookupDraft] = []
        self.router: Optional[Router] = None
        self.verify_fn = self.transfer_fn = None
        self._prefix_cache_enabled = bool(prefix_cache)
        self._stash: dict = {}         # rid -> preempted SSM checkpoint
        self._pending_handoffs: List[int] = []   # prefilled, awaiting a home
        if self.paged:
            n_pages = n_pages or batch_slots * (
                seq_budget // page_size + self.n_cross_pages) + 1
            self.page_size = page_size
            self.chunk = prefill_chunk
            self.n_max_pages = seq_budget // page_size
            self.n_pool_pages = n_pages      # a replica's pool
            self.allocators = [PageAllocator(n_pages) for _ in range(dp)]
            self.prefix_caches = [
                RadixPrefixCache(a, page_size) if prefix_cache else None
                for a in self.allocators]
            if self.has_slabs:
                self.slab_allocators = [SlabAllocator(self.n_slabs)
                                        for _ in range(dp)]
            if self.has_cross:
                self.cross_caches = [CrossKVCache(a)
                                     for a in self.allocators]
            if self.has_cross:
                self.cross_write_fn = make_cross_kv_write_step(cfg, plan,
                                                               page_size)
            self.cache = zero_paged_cache_for(cfg, plan, n_pages, page_size,
                                              self.device, self.n_slabs, dp)
            self.prefill_fn = make_prefill_chunk_step(
                cfg, plan, prefill_chunk, self.n_max_pages, page_size)
            self._make_step_fns()
            if self.speculative:
                self.draft_sources = [PromptLookupDraft(c)
                                      for c in self.prefix_caches]
        else:
            self.cache = zero_cache_for(cfg, plan, batch_slots, seq_budget,
                                        self.device)
            self.prefill_fn = make_prefill_step(cfg, plan, seq_budget)
            self.decode_fn = make_decode_step(cfg, plan, batch_slots,
                                              seq_budget)
        # ``scheduler`` is a ready instance (one replica) or a factory (a
        # Scheduler subclass or a functools.partial of one) that receives
        # the engine-owned allocator, caches and stats: one a replica, so
        # every policy's queues, deficits and clocks are the replica's own
        sched = scheduler or FCFSScheduler
        if isinstance(sched, Scheduler):
            self.scheds = [sched]
        else:
            self.scheds = [self._sched_for(sched, r) for r in range(dp)]
        for r, sc in enumerate(self.scheds):
            # per-replica counters move at the scheduler's counting sites,
            # beside the global ones
            if getattr(sc, "replica_stats", None) is None:
                sc.replica_stats = self.stats.replicas[r]
        if self.roles is not None:
            for r, role in enumerate(self.roles):
                self.stats.replicas[r].role = role
        if self.paged:
            self.router = Router(self.scheds, self.allocators,
                                 self.prefix_caches, page_size,
                                 cross_caches=self.cross_caches or None,
                                 roles=self.roles)
        self.admissions: List[Optional[Admission]] = [None] * self.B
        self.slot_state: List[Optional[str]] = [None] * self.B
        self.pos = np.zeros(self.B, np.int32)
        self.last_token = np.zeros(self.B, np.int32)
        self.prefill_done = np.zeros(self.B, np.int32)
        self.spec_miss = np.zeros(self.B, np.int32)
        self._rids: set = set()
        self._inflight: Optional[dict] = None
        # elastic membership: joined replicas build their schedulers from
        # the factory; a hook installed here fires at the top of every
        # paged tick, before planning (fault injection, ops triggers)
        self._sched_factory = None if isinstance(sched, Scheduler) else sched
        self.membership_hook = None
        self._build_io()
        self.steps = self._build_steps()
        # a host spill store warm-starts the caches now and is written at
        # every drain and read after every membership change
        self.spill = spill
        if self.paged and spill is not None:
            self._restore_from_spill(spill)

    @classmethod
    def build_paged(cls, cfg, plan, batch_slots: int, seq_budget: int,
                    params, *, page_size: int = 16, n_pages: int = 0,
                    prefill_chunk: int = 16, eos_id: int = 1,
                    sampler: Optional[SamplerConfig] = None,
                    rng_seed: int = 0, speculative: int = 0,
                    prefix_cache: bool = False, scheduler=None,
                    overlap: bool = True, graphs: bool = True, dp: int = 1,
                    disagg=None, spill=None, device="cuda"):
        """A paged engine.  ``n_pages`` (a replica's pool) defaults to full
        occupancy (every slot at budget, plus every slot's cross-KV pages
        for enc-dec archs) plus the scratch page; pass something smaller
        to exercise admission control under memory pressure.
        ``speculative=k`` > 0 verifies up to k prompt-lookup drafts per slot
        in one step; ``prefix_cache=True`` shares cached prompt prefixes
        (radix tree, copy-on-write pages); ``scheduler`` is the policy
        (FCFS by default); ``sampler`` with a temperature > 0 samples each
        request from its own stream seeded by (``rng_seed``, its seed or
        rid).  ``dp`` replicas each get ``batch_slots`` slots and their own
        pool; ``disagg=(P, D)`` splits them into prefill and decode roles.
        ``overlap=False`` is the serial loop; ``graphs=False`` runs the
        steps eagerly.  ``spill`` (a ``HostSpillStore``) warm-starts the
        prefix and cross caches from a previous engine's spilled pages;
        the engine keeps it, spills leaving replicas into it at a drain and
        restores from it after every ``scale_to``."""
        return cls(cfg, plan, batch_slots, seq_budget, params, paged=True,
                   page_size=page_size, n_pages=n_pages,
                   prefill_chunk=prefill_chunk, eos_id=eos_id,
                   sampler=sampler, rng_seed=rng_seed, speculative=speculative,
                   prefix_cache=prefix_cache, scheduler=scheduler,
                   overlap=overlap, graphs=graphs, dp=dp, disagg=disagg,
                   spill=spill, device=device)

    # ------------------------------------------------ one-replica accessors
    def _one(self, what, items):
        if self.R != 1:
            raise AssertionError(f"dp>1: use engine.{what}s[r]")
        return items[0] if items else None

    @property
    def sched(self):
        """The single scheduler (dp = 1)."""
        if self.R != 1:
            raise AssertionError("dp>1: use engine.scheds[r] / has_pending()")
        return self.scheds[0]

    @property
    def allocator(self) -> Optional[PageAllocator]:
        """The single page allocator (dp = 1; None when contiguous)."""
        return self._one("allocator", self.allocators)

    @property
    def prefix_cache(self) -> Optional[RadixPrefixCache]:
        """The radix prefix cache (dp = 1; None without one)."""
        return self._one("prefix_cache", self.prefix_caches)

    @property
    def slab_allocator(self) -> Optional[SlabAllocator]:
        """The single slab allocator (dp = 1; None without slabs)."""
        return self._one("slab_allocator", self.slab_allocators)

    @property
    def cross_cache(self) -> Optional[CrossKVCache]:
        """The single cross-KV cache (dp = 1; None without cross pages)."""
        return self._one("cross_cache", self.cross_caches)

    def _rep(self, b: int) -> int:
        """Replica owning global slot ``b``."""
        return b // self.Bp

    def _gslot(self, r: int, local: int) -> int:
        """Replica-local slot -> global slot."""
        return r * self.Bp + local

    def _rep_slots(self, r: int):
        return range(r * self.Bp, (r + 1) * self.Bp)

    # -------------------------------------------------------- steps and io
    def _sched_for(self, factory, r: int):
        """Replica ``r``'s scheduler from ``factory``, over the replica's
        allocator and caches, with the engine's stats (and the replica's
        role under disaggregation)."""
        paged = self.paged
        return factory(
            seq_budget=self.S,
            allocator=self.allocators[r] if paged else None,
            page_size=self.page_size if paged else 0,
            prefix_cache=self.prefix_caches[r] if paged else None,
            stats=self.stats,
            slab_allocator=(self.slab_allocators[r] if self.has_slabs
                            else None),
            cross_cache=self.cross_caches[r] if self.has_cross else None,
            cross_pages_per_req=self.n_cross_pages,
            kv_pages=not paged or "kv" in cache_profile(self.cfg),
            spec_tokens=self.speculative,
            **({"role": self.roles[r]} if self.roles else {}))

    def _make_step_fns(self):
        """The paged step functions whose shapes follow the replica count
        R: decode and verify over B = R x Bp rows, the copy-on-write copy
        and the page transfer over the folded pools' R x n_pages pages.
        The steps index the folded pools of every replica: the engine
        folds each id as it stages it (``kvcache.fold_ids``).  The transfer
        exists at every R > 1 for attention-only archs, as in JAX (a
        disaggregated engine's handoffs, an elastic drain's migrations).
        Made at construction and again after every membership change."""
        nm, n_folded = self.n_max_pages, self.R * self.n_pool_pages
        if self._prefix_cache_enabled:
            self.copy_fn = make_page_copy_step(n_folded)          # COW
        self.transfer_fn = None
        if self.R > 1 and not self.has_slabs and not self.has_cross:
            self.transfer_fn = make_page_transfer_step(n_folded, nm)
        self.decode_fn = make_paged_decode_step(self.cfg, self.plan, self.B,
                                                nm, self.page_size)
        if self.speculative:
            self.verify_fn = make_verify_step(self.cfg, self.plan, self.B,
                                              self.speculative + 1, nm)

    def _build_io(self):
        """Staging for every step kind's inputs, and the ids buffer: one
        row per prefill chunk of a tick (at most B), then the decode step's
        B ids or the verify step's B x Q.  A sampled engine also gets a
        logits buffer of as many rows, on the card and pinned on the
        host."""
        dev, B = self.device, self.B
        io = {"decode": [("tokens", (B, 1)), ("pos", (B,))]}
        rows = {}
        if self.paged:
            slab = [("slab_ids", (B,))] if self.has_slabs else []
            nm, nc = self.n_max_pages, self.n_cross_pages
            cross = [("cross_bt", (B, nc))] if self.has_cross else []
            io["decode"] += [("block_table", (B, nm))] + slab + cross
            # a chunk a row, one per prefilling slot at most
            io["chunk"] = ([("tokens", (1, self.chunk)), ("chunk_start", (1,)),
                            ("last_idx", (1,)), ("block_table", (1, nm))]
                           + ([("slab_ids", (1,))] if self.has_slabs else [])
                           + ([("cross_bt", (1, nc))] if self.has_cross
                              else []))
            rows["chunk"] = B
            if self.has_cross:
                # an encode a row, one per admission of the tick at most
                io["cross"] = [("cross_bt", (nc,))]
                rows["cross"] = B
            if self.speculative:
                io["verify"] = [("tokens", (B, self.speculative + 1)),
                                ("pos", (B,)), ("qlen", (B,)),
                                ("block_table", (B, nm))]
            if self.prefix_caches[0] is not None:
                # a copy-on-write (src, dst) pair a row, one per admission
                io["copy"] = [("src", (1,)), ("dst", (1,))]
                rows["copy"] = B
            if self.transfer_fn is not None:
                # a handoff (or a migration) a row, one per slot at most
                io["handoff"] = [("src_pages", (nm,)), ("dst_pages", (nm,))]
                rows["handoff"] = B
        else:
            io["prompt"] = [("tokens", (1, self.S))]
        self.io = {kind: Staging(fields, dev, rows=rows.get(kind, 1))
                   for kind, fields in io.items()}
        if self.cfg.is_encdec:
            # float32 frames as requests carry them (the steps cast them to
            # the weights' dtype): a row per encode, or the contiguous
            # prefill's one
            frames = [("frames", (self.cfg.enc_seq_len, self.cfg.d_model))]
            self.io["frames"] = Staging(frames, dev,
                                        rows=B if self.paged else 1,
                                        dtype=torch.float32)
        if self.paged:
            # the chunk, copy and transfer graphs' static inputs: each
            # replay's row is copied here on the card before it
            self._chunk_in = torch.zeros(self.io["chunk"].dev.shape[1],
                                         dtype=torch.int32, device=dev)
            self._copy_in = torch.zeros(2, dtype=torch.int32, device=dev)
            if self.transfer_fn is not None:
                self._xfer_in = torch.zeros(self.io["handoff"].dev.shape[1],
                                            dtype=torch.int32, device=dev)
            if self.has_cross:
                # the cross-KV write graph's static inputs: the frames and
                # the cross block table
                self._frames_in = torch.zeros(
                    (1, self.cfg.enc_seq_len, self.cfg.d_model),
                    dtype=torch.float32, device=dev)
                self._cross_in = torch.zeros(self.n_cross_pages,
                                             dtype=torch.int32, device=dev)
            # ids of slabs to zero and pages whose scale rows to reset, as
            # folded ids over every replica
            self.io["plan"] = Staging(
                [("ids", (self.R * (self.n_pool_pages + self.n_slabs),))], dev,
                dtype=torch.int64)
        n_out = B + B * (self.speculative + 1)
        self._out = torch.zeros(n_out, dtype=torch.int32, device=dev)
        cuda = dev.type == "cuda"
        self._out_host = torch.zeros(n_out, dtype=torch.int32,
                                     pin_memory=cuda)
        self._out_np = self._out_host.numpy()
        self._out_event = torch.cuda.Event() if cuda else None
        self._lout = self._lout_host = None
        if self.sampled:
            # the logits' dtype: the head's, which is the activations'
            shape = (n_out, self.cfg.vocab_size)
            dt = self.params["embed"]["table"].dtype
            self._lout = torch.zeros(shape, dtype=dt, device=dev)
            self._lout_host = torch.zeros(shape, dtype=dt, pin_memory=cuda)

    def _build_steps(self) -> dict:
        """Each fixed-shape step over its static inputs, at the engine's
        replica count (one step set for its R, JAX's ``paged_step_set``),
        ending in the greedy ids: captured in a CUDA graph on the card
        (``graphs``), else eager.  The contiguous whole-prompt prefill
        stays eager (one shape per prompt length)."""
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

        def copy(src, dst):
            self.copy_fn(self.cache, src, dst)
            return ()

        def transfer(*ins):
            self.transfer_fn(self.cache, *ins)
            return ()

        def cross_write(frames, cross_in):
            self.cross_write_fn(self.params, self.cache, frames,
                                cross_in[None])
            return ()

        steps = {"decode": make(run("decode_fn"), inputs("decode"))}
        if self.paged:
            steps["chunk"] = make(run("prefill_fn"),
                                  inputs("chunk", self._chunk_in))
            if self.speculative:
                steps["verify"] = make(run("verify_fn"), inputs("verify"))
            if "copy" in self.io:
                steps["copy"] = make(copy, inputs("copy", self._copy_in))
            if self.has_cross:
                steps["cross"] = make(cross_write,
                                      (self._frames_in, self._cross_in))
            if self.transfer_fn is not None:
                steps["transfer"] = make(transfer,
                                         inputs("handoff", self._xfer_in))
        return steps

    def _send_out(self, inflight: dict):
        """Send the tick's ids home in one copy behind an event, and a
        sampled engine's logits rows in one more (the prefill chunks' rows,
        then the step's); collect waits for the event."""
        self._out_host.copy_(self._out, non_blocking=True)
        if self.sampled:
            step = inflight["step"]
            n = len(inflight["pf"]) if step is None else self.B + self.B * (
                self.speculative + 1 if step[0] == "verify" else 1)
            self._lout_host[:n].copy_(self._lout[:n], non_blocking=True)
        if self._out_event is not None:
            self._out_event.record()
        self._inflight = dict(inflight, t_dispatch=time.monotonic())

    def _logit_rows(self, row: int, n: int) -> np.ndarray:
        """Rows ``row`` .. ``row + n`` of the logits brought home, widened
        to float32 (exact from bf16), as JAX's host copy gives them to
        its sampler."""
        return self._lout_host[row:row + n].float().numpy()

    def _token(self, row: int, req: Request) -> int:
        """The token of ids row ``row``: its greedy id, or on a sampled
        engine one draw from ``req``'s own stream over the row's logits."""
        if not self.sampled:
            return int(self._out_np[row])
        return int(sample_from_logits(self._logit_rows(row, 1), self.sampler,
                                      self.cfg.vocab_size, req.rng)[0])

    def _wait_out(self):
        t0 = time.monotonic()
        if self._out_event is not None:
            self._out_event.synchronize()
        t1 = time.monotonic()
        self.stats.collect_wait_s += t1 - t0
        return t1

    # ------------------------------------------------------------------ API
    def has_pending(self) -> bool:
        return any(sc.has_pending() for sc in self.scheds)

    def submit(self, req: Request):
        if req.rid in self._rids:     # rids key the per-request stats
            raise RuntimeError(f"duplicate request id {req.rid}")
        if self.cfg.is_encdec:
            want = (self.cfg.enc_seq_len, self.cfg.d_model)
            if req.frames is None:
                raise RuntimeError(
                    f"request {req.rid}: arch '{self.cfg.name}' is "
                    f"encoder-decoder — Request.frames of shape {want} "
                    f"(encoder frame embeddings) is required")
            if tuple(np.shape(req.frames)) != want:
                raise RuntimeError(
                    f"request {req.rid}: frames shape "
                    f"{tuple(np.shape(req.frames))} != {want} expected by "
                    f"arch '{self.cfg.name}' (enc_seq_len, d_model)")
        if self.disagg is not None:
            # a prefill-role admission budgets the prompt only; the request
            # must still fit a decode replica's pool at handoff
            need = pages_needed(len(req.prompt) + req.max_new_tokens,
                                self.page_size)
            usable = max(self.allocators[r].n_pages -
                         self.allocators[r].n_reserved
                         for r in range(self.R)
                         if self.roles[r] == "decode")
            if need > usable:
                raise RuntimeError(
                    f"request {req.rid} needs {need} pages to decode but "
                    f"the largest decode-replica pool has only {usable} "
                    f"usable pages — it could prefill but never hand off")
        r = self.router.route(req) if self.router is not None else 0
        self.scheds[r].submit(req)    # raises on infeasible requests
        if self.router is not None:
            self.router.commit(req, r)
        req.replica = r
        self.stats.replicas[r].routed += 1
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
        """Abort every in-flight admission, returning its pages and slab to
        its replica (paged engine), after collecting in-flight work.
        Aborted requests keep ``done=False``; queued requests stay queued.
        Host stashes of preempted SSM slots are dropped too: a still-queued
        preempted request that resumes after a drain re-prefills from
        scratch (exact: admission zeroes its slab), so stash memory cannot
        outlive the work it checkpoints.  -> number of slots drained."""
        self._barrier()
        n = 0
        for b in range(self.B):
            if self.admissions[b] is not None:
                self.scheds[self._rep(b)].on_finish(self.admissions[b])
                self._clear_slot(b)
                n += 1
        self._stash.clear()
        return n

    def preempt(self, b: int):
        """Evict global slot ``b`` mid-flight, after collecting in-flight
        work.  Emitted tokens already live on ``req.out_tokens`` and resume
        re-admits over the effective prompt (prompt + emitted tokens), so
        the resident full pages, donated to the owning replica's prefix
        cache by its ``sched.on_preempt``, come back as a prefix hit there
        (routing is sticky): the KV is reused, not recomputed (only the
        partial tail page is re-prefilled).  An SSM slot's slab is stashed
        on the host instead.  A slot queued for handoff leaves the queue."""
        if not self.paged:
            raise ValueError("preemption requires the paged engine")
        if self.admissions[b] is None:
            raise ValueError(f"slot {b} is idle")
        self._barrier()               # external preempt: settle first
        if self.admissions[b] is None:
            return                    # the slot retired at that collect
        self._preempt_now(b)

    def _preempt_now(self, b: int):
        """Immediate eviction: no in-flight step references slot ``b``
        (nothing is in flight, or its results were just collected)."""
        adm = self.admissions[b]
        r = self._rep(b)
        n = int(self.prefill_done[b]) if self.slot_state[b] == "prefill" \
            else int(self.pos[b])
        if self.has_slabs:
            # recurrent state cannot be re-derived from donated pages:
            # checkpoint the slab before the scheduler frees it
            self._stash_slot(r, adm, n)
        self.scheds[r].on_preempt(adm, effective_prompt(adm.req)[:n])
        self._clear_slot(b)
        self.stats.preemptions += 1
        self.stats.replicas[r].preemptions += 1

    # --------------------------------------------------- elastic membership
    def scale_to(self, dp_new: int):
        """Live dp reconfiguration: grow or shrink to ``dp_new`` replicas
        without dropping an in-flight request.  Scale-down drains the
        leaving replicas first: each active slot migrates its resident KV
        pages to a survivor through the page-transfer step (int8 scale rows
        ride along; host refcounts hand off at once), or falls back to
        preempt-and-requeue where migration cannot apply (SSM or enc-dec
        state, no free slot, destination pool pressure, a failed
        transfer); then queued requests re-route to survivors.  Both
        directions then rebuild (``_rebuild``): the pools re-scatter to the
        new width, survivors keep their allocator, cache and scheduler
        objects, joined replicas start fresh, and the step set is made and
        captured again at the new R.  With a spill store attached, the
        drain spills the leaving replicas' cached entries before the
        rebuild, and every change ends by restoring what is not resident
        (``_restore_from_spill``)."""
        if not self.paged:
            raise ValueError("elastic membership requires the paged engine")
        if self.disagg is not None:
            raise ValueError(
                "scale_to under disaggregation is unsupported: a disagg "
                "engine's prefill/decode role sets are static")
        if self._sched_factory is None:
            raise ValueError(
                "scale_to needs a scheduler factory, not a pre-built "
                "instance (joined replicas build their own scheduler)")
        dp_new = int(dp_new)
        # JAX's messages at the one device's data extent of 1: every
        # replica count is a whole number of device groups
        if dp_new < 1:
            raise ValueError(
                f"dp_new={dp_new} must be a positive multiple of the "
                f"mesh's data extent (1) so every replica keeps a whole "
                f"device group")
        if dp_new == self.R:
            return
        self._barrier()               # in-flight work settles first
        self.stats.scale_events += 1
        if dp_new > self.R:
            self._rebuild(list(range(self.R)), dp_new)
        else:
            keep = list(range(dp_new))
            self._drain_replicas(list(range(dp_new, self.R)), keep)
            self._rebuild(keep, dp_new)
        if self.spill is not None:
            self._restore_from_spill(self.spill)

    def kill_replica(self, r: int) -> RecoveryReport:
        """A replica FAILURE, with no drain: replica ``r``'s pages,
        allocator and scheduler state are presumed lost.  Recovery
        (``runtime.ft.plan_recovery``) re-admits its orphans on the
        survivors: active slots replay prompt + emitted tokens as a
        re-prefill from the requests on the host (exact continuation: each
        request's stream has advanced one draw per emitted token either
        way), queued requests re-route.  -> the ``RecoveryReport``."""
        if not self.paged:
            raise ValueError("elastic membership requires the paged engine")
        if self.disagg is not None:
            raise ValueError(
                "kill_replica under disaggregation is unsupported: a "
                "disagg engine's prefill/decode role sets are static")
        if self._sched_factory is None:
            raise ValueError(
                "kill_replica needs a scheduler factory, not a pre-built "
                "instance")
        if not 0 <= r < self.R:
            raise ValueError(f"replica {r} out of range (dp={self.R})")
        if self.R < 2:
            raise ValueError(
                f"cannot lose a replica at dp={self.R}: the survivor "
                f"count must stay a positive multiple of the mesh's data "
                f"extent (1)")
        self._barrier()
        self.stats.crashes += 1
        active = [self.admissions[b] for b in self._rep_slots(r)
                  if self.admissions[b] is not None]
        reqs, report = plan_recovery(r, active,
                                     self.scheds[r].pending_requests())
        # the dead replica's pool, allocator and caches are dropped whole:
        # its slots clear without on_finish (no refcounts survive to
        # release into)
        for b in self._rep_slots(r):
            if self.admissions[b] is not None:
                self._clear_slot(b)
        self._rebuild([x for x in range(self.R) if x != r], self.R - 1)
        for req in reqs:
            self._place(req)
        return report

    def _drain_replicas(self, leaving: List[int], keep: List[int]):
        """Empty the leaving replicas: mark them unroutable, migrate (or
        preempt and requeue) every active slot, re-place their queues on
        the survivors, and spill their cached entries to the host if a
        spill store is attached.  Runs with nothing in flight (callers
        collect first)."""
        for r in leaving:
            self.router.mark_draining(r)
        for r in leaving:
            for b in self._rep_slots(r):
                if self.admissions[b] is None:
                    continue
                if not self._migrate_slot(b, keep):
                    # fallback: evict onto the leaving scheduler's queue
                    # (an SSM slot's slab to the host stash); re-placed
                    # below
                    self._preempt_now(b)
        for r in leaving:
            for req in self.scheds[r].take_queued():
                self._place(req)
        if self.spill is not None:
            # before the rebuild drops the leaving replicas' pool rows: the
            # pages that preempted slots donated are spilled too
            self.spill_state(self.spill, replicas=leaving)

    def _migrate_slot(self, b_src: int, keep: List[int]) -> bool:
        """Move global slot ``b_src``'s request to a surviving replica:
        claim a destination admission, copy the resident pages with the
        page-transfer step (scale rows ride along), hand the references
        over, and install the slot's state (position, prefill progress,
        last token) at the destination.  -> False where migration cannot
        apply (state that does not transfer, no free slot, destination
        pool pressure, a transfer that raised): the destination claim, if
        any, is rolled back, the source slot is left as it was, and the
        caller preempts instead."""
        if self.has_slabs or self.has_cross or self.transfer_fn is None:
            return False
        src_r = self._rep(b_src)
        adm = self.admissions[b_src]
        req = adm.req
        in_prefill = self.slot_state[b_src] == "prefill"
        n = int(self.prefill_done[b_src]) if in_prefill \
            else int(self.pos[b_src])
        cand = [r for r in keep
                if any(self.admissions[b] is None
                       for b in self._rep_slots(r))]
        if not cand:
            return False
        dst_r = self.router.decode_placement(cand)
        local = min(b - dst_r * self.Bp for b in self._rep_slots(dst_r)
                    if self.admissions[b] is None)
        dst_adm = self.scheds[dst_r].plan_migration(local, req, n)
        if dst_adm is None:
            return False              # destination pool pressure
        k = pages_needed(n, self.page_size)
        if k:
            try:
                io = self.io["handoff"]
                self._xfer_row(io.split(io.host()[0]), src_r, adm.pages[:k],
                               dst_r, dst_adm.pages[:k])
                io.send(io.dev.shape[1])
                self._xfer_in.copy_(io.dev[0])
                self.steps["transfer"]()
            except Exception:
                # no reference moved yet (they move after the transfer):
                # retiring the destination claim restores the state before
                # the migration exactly, with no orphaned page on either side
                self.scheds[dst_r].on_finish(dst_adm)
                return False
        self.scheds[src_r].on_migrated(adm, k, self.allocators[dst_r],
                                       dst_adm.pages[:k])
        b_dst = self._gslot(dst_r, dst_adm.slot)
        self.admissions[b_dst] = dst_adm
        self.slot_state[b_dst] = "prefill" if in_prefill else "decode"
        self.pos[b_dst] = self.pos[b_src]
        self.prefill_done[b_dst] = self.prefill_done[b_src]
        self.last_token[b_dst] = self.last_token[b_src]
        self.spec_miss[b_dst] = self.spec_miss[b_src]
        self._clear_slot(b_src)
        req.replica = dst_r
        self.router.commit(req, dst_r)
        self.stats.migrations += 1
        self.stats.migrated_pages += k
        self.stats.pages_transferred += k
        self.stats.replicas[src_r].pages_transferred_out += k
        self.stats.replicas[dst_r].pages_transferred_in += k
        self.stats.replicas[dst_r].routed += 1
        return True

    def _place(self, req: Request):
        """Re-place a request already submitted, after a membership change:
        route it (draining and dead replicas excluded), queue it, and keep
        its identity (rid, stream, submit time and emitted tokens persist,
        so the client sees only latency).  It cannot newly fail: every
        replica's pool has the same size, and the effective prompt grows
        exactly as the remaining new tokens shrink."""
        r = self.router.route(req)
        self.scheds[r].submit(req)
        self.router.commit(req, r)
        req.replica = r
        self.stats.replicas[r].routed += 1
        self.stats.readmitted += 1

    def _rebuild(self, keep: List[int], dp_new: int):
        """Re-stamp the engine for ``dp_new`` replicas with survivors
        ``keep`` (old indices, order kept; survivor ``keep[j]`` becomes
        replica j).  Every step graph captured the addresses of the old
        pools and staging buffers, so all of them are dropped first (a
        replay after the pools moved would write freed memory).  Then the
        pools re-scatter (``runtime.elastic.reshard_replica_pools``);
        survivors carry their allocator, prefix cache, slab allocator,
        cross cache, scheduler and ``ReplicaStats`` objects over (their
        page and slab ids are replica-local, so every folded id changes:
        ids are folded only at staging); joined replicas start fresh; the
        slot arrays and each request's replica remap; the router is rebuilt
        (drain marks cleared; its windows of recent prompts and its
        affinity count carried over); the draft sources are made anew; and
        the step functions, staging and graphs are built again at the new
        R."""
        assert self._inflight is None and not self._pending_handoffs
        keep = list(keep)
        n_keep = len(keep)
        self.steps = {}
        self.cache = reshard_replica_pools(self.cache, keep, dp_new, self.R)
        self.allocators = [self.allocators[r] for r in keep] + \
            [PageAllocator(self.n_pool_pages)
             for _ in range(dp_new - n_keep)]
        self.prefix_caches = [self.prefix_caches[r] for r in keep] + \
            [RadixPrefixCache(a, self.page_size)
             if self._prefix_cache_enabled else None
             for a in self.allocators[n_keep:]]
        if self.has_slabs:
            self.slab_allocators = \
                [self.slab_allocators[r] for r in keep] + \
                [SlabAllocator(self.n_slabs) for _ in range(dp_new - n_keep)]
        if self.has_cross:
            self.cross_caches = [self.cross_caches[r] for r in keep] + \
                [CrossKVCache(a) for a in self.allocators[n_keep:]]
        self.scheds = [self.scheds[r] for r in keep] + \
            [self._sched_for(self._sched_factory, j)
             for j in range(n_keep, dp_new)]
        self.stats.replicas = [self.stats.replicas[r] for r in keep] + \
            [ReplicaStats() for _ in range(dp_new - n_keep)]
        for j, sc in enumerate(self.scheds):
            # survivors' ReplicaStats moved with them; only the joined
            # replicas' schedulers need theirs
            if getattr(sc, "replica_stats", None) is None:
                sc.replica_stats = self.stats.replicas[j]
        # slot arrays: old global slot keep[j] * Bp + l -> new j * Bp + l
        old = (self.admissions, self.pos, self.last_token, self.spec_miss,
               self.slot_state, self.prefill_done)
        B_new = self.Bp * dp_new
        self.admissions = [None] * B_new
        self.pos = np.zeros(B_new, np.int32)
        self.last_token = np.zeros(B_new, np.int32)
        self.spec_miss = np.zeros(B_new, np.int32)
        self.slot_state = [None] * B_new
        self.prefill_done = np.zeros(B_new, np.int32)
        for j, r_old in enumerate(keep):
            for loc in range(self.Bp):
                ob, nb = r_old * self.Bp + loc, j * self.Bp + loc
                self.admissions[nb] = old[0][ob]
                self.pos[nb] = old[1][ob]
                self.last_token[nb] = old[2][ob]
                self.spec_miss[nb] = old[3][ob]
                self.slot_state[nb] = old[4][ob]
                self.prefill_done[nb] = old[5][ob]
                if old[0][ob] is not None:
                    old[0][ob].req.replica = j
        for j, sc in enumerate(self.scheds):
            for req in sc.pending_requests():
                req.replica = j
        old_router = self.router
        self.R, self.B = dp_new, B_new
        self.router = Router(self.scheds, self.allocators,
                             self.prefix_caches, self.page_size,
                             cross_caches=self.cross_caches or None)
        for j, r_old in enumerate(keep):
            self.router._recent[j].extend(old_router._recent[r_old])
            self.router._recent_frames[j].extend(
                old_router._recent_frames[r_old])
        self.router.affinity_routed = old_router.affinity_routed
        if self.speculative:
            self.draft_sources = [PromptLookupDraft(c)
                                  for c in self.prefix_caches]
        self._make_step_fns()
        self._build_io()
        self.steps = self._build_steps()

    def _kind_pools(self, kind: str):
        """Every layer's pools of one cache kind ("kv" or "cross" page
        pools, (reps, R * n_pages, ...), or "ssm" slab pools, (reps, R *
        n_slabs, ...)), in cache order."""
        return [pool for group in self.cache for entry in group
                for pool in entry.get(kind, {}).values()]

    @staticmethod
    def _runs(pages):
        """Page ids as runs of consecutive ids: (offset in ``pages``,
        first id, length), so a run is copied as one slice (a view: no
        index tensor, nothing read on the host)."""
        runs = []
        for i, p in enumerate(pages):
            if runs and p == runs[-1][1] + runs[-1][2]:
                runs[-1][2] += 1
            else:
                runs.append([i, p, 1])
        return runs

    def _stash_slot(self, r: int, adm: Admission, n: int):
        """Checkpoint a preempted slot of replica ``r`` to host memory: its
        slab (state after exactly ``n`` tokens, conv tails, int8 scales)
        and, for a hybrid, the payloads of the first ``pages_needed(n,
        page_size)`` pages of every KV pool (int8 pools' scale rows too),
        as JAX's ``_stash_slot``: KV alone could be recomputed, but not
        through hybrid layers without re-advancing the SSM state, so the
        resume point restores both.  Non-blocking copies into pinned
        buffers; the host never reads them: the restore copies them back on
        the same stream, after these copies."""
        pin = self.device.type == "cuda"

        def host(src):
            return torch.empty(src.shape, dtype=src.dtype, pin_memory=pin)

        slab = fold_ids(adm.slab, r, self.n_slabs)
        slabs = []
        for pool in self._kind_pools("ssm"):
            h = host(pool[:, slab])
            h.copy_(pool[:, slab], non_blocking=True)
            slabs.append(h)
        k = pages_needed(n, self.page_size) if adm.pages else 0
        kv = []
        for pool in self._kind_pools("kv") if k else ():
            h = host(pool[:, :k])
            for i, p, m in self._runs(self._folded(r, adm.pages[:k])):
                h[:, i:i + m].copy_(pool[:, p:p + m], non_blocking=True)
            kv.append(h)
        self._stash[adm.req.rid] = {"n": n, "ssm": slabs, "kv": kv,
                                    "n_kv_pages": k}

    def _restore_slot(self, r: int, adm: Admission, stash: dict):
        """Write a stashed checkpoint into the re-admission's fresh slab and
        the first ``stash["n_kv_pages"]`` pages of its new run on replica
        ``r``; prefill then continues at token ``stash["n"]``: nothing
        resident is recomputed."""
        slab = fold_ids(adm.slab, r, self.n_slabs)
        for pool, h in zip(self._kind_pools("ssm"), stash["ssm"],
                           strict=True):
            pool[:, slab].copy_(h, non_blocking=True)
        k = stash["n_kv_pages"]
        if k:
            runs = self._runs(self._folded(r, adm.pages[:k]))
            for pool, h in zip(self._kind_pools("kv"), stash["kv"],
                               strict=True):
                for i, p, m in runs:
                    pool[:, p:p + m].copy_(h[:, i:i + m], non_blocking=True)
        self.stats.slab_restores += 1

    def _folded(self, r: int, pages):
        """Replica ``r``'s page ids as ids of the folded pools."""
        return fold_ids(pages, r, self.n_pool_pages)

    # ---------------------------------------------------------- host spill
    def spill_state(self, store=None, replicas: Optional[List[int]] = None):
        """Spill the radix prefix and cross-KV cache entries of
        ``replicas`` (default: all) to a ``HostSpillStore``: each entry's
        page payloads (int8 payloads and their per-(page, row) scale rows
        included, byte for byte), keyed by token path or frames digest.
        The pools are untouched (spilling takes no refs); a restore
        allocates fresh pages wherever the store is next attached.  The
        copies have landed when this returns.  -> the store."""
        if not self.paged:
            raise AssertionError("spill requires the paged engine")
        store = store if store is not None else HostSpillStore()
        for r in (replicas if replicas is not None else range(self.R)):
            pc = self.prefix_caches[r]
            if pc is not None:
                for toks, pages in pc.entries():
                    store.put_prefix(toks, len(pages),
                                     self._gather_pages(r, "kv", pages))
            if self.has_cross:
                for key, pages in self.cross_caches[r].entries():
                    store.put_cross(key, len(pages),
                                    self._gather_pages(r, "cross", pages))
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return store

    def _restore_from_spill(self, store):
        """Write spilled entries into the least page-loaded replicas, as
        JAX does: allocate fresh pages, write the stored payloads bit for
        bit into the pools in place (the step graphs hold the pools'
        addresses), insert into the replica's cache and drop the
        allocation's refs (the cache holds its own now; pages of a prefix
        the tree already held drop to refcount 0 and recycle).  Restored
        pages stay referenced, so the scale-row reset of recycled pages
        never touches them.  Entries already resident, or not fitting the
        pool now, are skipped: the store is a warm start, not a ledger."""
        if store is None or not self.paged:
            return
        cand = [r for r in range(self.R)
                if self.prefix_caches[r] is not None]
        if cand:
            for toks, (k, payloads) in store.radix.items():
                prompt = list(toks)
                if any(self.prefix_caches[c].lookup(prompt)[0] >= len(toks)
                       for c in cand):
                    continue              # already resident somewhere
                r = min(cand, key=lambda rr: (self.router.page_load(rr), rr))
                pages = self.allocators[r].alloc(k)
                if pages is None:
                    continue              # pool pressure: stays spilled
                self._scatter_pages(r, "kv", pages, payloads)
                self.prefix_caches[r].insert(prompt, pages)
                self.allocators[r].decref(pages)
                store.pages_restored += k
        if self.has_cross:
            for key, (k, payloads) in store.cross.items():
                if any(xc.has(key) for xc in self.cross_caches):
                    continue
                r = min(range(self.R),
                        key=lambda rr: (self.router.page_load(rr), rr))
                pages = self.allocators[r].alloc(k)
                if pages is None:
                    continue
                self._scatter_pages(r, "cross", pages, payloads)
                self.cross_caches[r].insert(key, pages)
                self.allocators[r].decref(pages)
                store.pages_restored += k

    def _page_index(self, r: int, pages) -> torch.Tensor:
        """Replica ``r``'s page ids as an index of the folded pools, on the
        engine's device."""
        return torch.as_tensor(self._folded(r, pages),
                               dtype=torch.long).to(self.device)

    def _gather_pages(self, r: int, kind: str, pages) -> list:
        """Replica ``r``'s ``pages`` of every pool of ``kind``, ``pool[:,
        folded ids]``, as host tensors in the pools' dtypes (pinned on the
        card, the copies non-blocking: ``spill_state`` waits for them).
        An index tensor, unlike the slot stash's run copies: a spill runs
        between ticks, where a copy of the ids may block, and not inside
        plan."""
        idx = self._page_index(r, pages)
        out = []
        for pool in self._kind_pools(kind):
            rows = pool.index_select(1, idx)
            if self.device.type == "cuda":
                host = torch.empty(rows.shape, dtype=rows.dtype,
                                   pin_memory=True)
                host.copy_(rows, non_blocking=True)
                rows = host
            out.append(rows)
        return out

    def _scatter_pages(self, r: int, kind: str, pages, payloads):
        """Write ``payloads`` (``_gather_pages``'s list) into replica
        ``r``'s ``pages`` of every pool of ``kind``, in place."""
        idx = self._page_index(r, pages)
        for pool, rows in zip(self._kind_pools(kind), payloads, strict=True):
            pool.index_copy_(1, idx, rows.to(self.device, non_blocking=True))

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
        for adm in self.scheds[0].plan(free):
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
        straight into them, and emit the token of the prompt's last
        logits (greedy, or drawn from the request's stream): the first
        generated token."""
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
        if self.cfg.is_encdec:
            # the encoder runs at every admission, over the request's
            # frames, and fills the slot's cross lanes
            fio = self.io["frames"]
            fio.host()[0] = np.asarray(req.frames, np.float32).reshape(-1)
            fio.send()
            logits, _ = self.prefill_fn(
                self.params,
                fio.dev.view(1, self.cfg.enc_seq_len, self.cfg.d_model),
                io.dev[:, :L], lane)
        else:
            logits, _ = self.prefill_fn(self.params, io.dev[:, :L], lane)
        self._out[:1].copy_(greedy_ids(logits, self.cfg.vocab_size))
        self._out_host[:1].copy_(self._out[:1], non_blocking=True)
        if self.sampled:
            self._lout_host[:1].copy_(logits, non_blocking=True)
        if self._out_event is not None:
            self._out_event.record()
        now = self._wait_out()
        self.stats.prefills += 1
        self.stats.replicas[0].prefills += 1
        self.pos[b] = L
        self._emit(b, req, self._token(0, req), now)

    def _tick_paged(self):
        """One pipelined tick: plan (host; overlaps the previous dispatch
        on the card), collect (the tick's one barrier: the previous
        dispatch's ids), the preemptions deferred past it, dispatch this
        tick's steps.  ``overlap=False`` collects the fresh dispatch at
        once: the serial loop.  A membership hook (fault injection, ops
        triggers) fires first, before any planning: ``scale_to`` and
        ``kill_replica`` collect in-flight work themselves, so the hook
        sees, and leaves, an engine with nothing in flight."""
        if self.membership_hook is not None:
            self.membership_hook(self)
        tick_plan = self._plan_phase()
        self._collect_phase()
        self._run_deferred_preempts(tick_plan)
        self._dispatch_phase(tick_plan)
        if not self.overlap:
            self._collect_phase()

    # ------------------------------------------------------------ plan phase
    def _plan_phase(self) -> dict:
        """Preemption verdicts (each replica's policy over its own slots),
        the handoffs of a disaggregated engine, admissions and the COW and
        cross-KV work of this tick, and in place: the new slots' slabs
        zeroed (or restored from a preempted request's stash) and the scale
        rows of pages freed since the last plan zeroed (the cross pools'
        too).  Verdicts against slots with work in flight are deferred past
        collect (their emissions may retire the victim first); with nothing
        in flight they apply at once, as in the serial loop.  Freed pages
        and slabs were released at a collect or behind a dispatched step,
        so no later device work reads them before their new owner writes;
        the device work rides the stream behind the in-flight steps.  -> the
        tick's plan: {"preempts": [(slot, rid)], "handoffs": [(source
        slot, source admission, destination replica, destination slot,
        destination admission)], "cow": [(replica, admission)], "cross":
        [admission]} (the admissions with a copy-on-write page, and those
        whose frames must be encoded, in plan order)."""
        tick_plan = {"preempts": [], "handoffs": [], "cow": [], "cross": []}
        if self._inflight is not None:
            self.stats.plan_ahead_ticks += 1
        for r in range(self.R):
            active = [self.admissions[b] for b in self._rep_slots(r)
                      if self.admissions[b] is not None]
            for adm in self.scheds[r].plan_preemptions(
                    active, self.Bp - len(active)):
                b = self._gslot(r, adm.slot)
                if self._inflight is None:
                    self._preempt_now(b)
                else:
                    tick_plan["preempts"].append((b, adm.req.rid))
        if self.disagg is not None:
            self._plan_handoffs(tick_plan)
        slabs, pids = [], []
        for r in range(self.R):
            for adm in self.scheds[r].plan([b - r * self.Bp
                                            for b in self._rep_slots(r)
                                            if self.admissions[b] is None]):
                b = self._gslot(r, adm.slot)
                self.admissions[b] = adm
                self.slot_state[b] = "prefill"
                if adm.cow is not None:
                    tick_plan["cow"].append((r, adm))
                if adm.needs_encode:
                    tick_plan["cross"].append(adm)
                # prefix-cached tokens are resident: prefill resumes at the
                # first uncached position (for a preempted request, its
                # donated progress: reused, not recomputed)
                self.prefill_done[b] = adm.cached_len
                self.stats.prefill_tokens_skipped += adm.cached_len
                self.pos[b] = 0
                self.last_token[b] = 0
                if self.has_slabs:
                    stash = self._stash.pop(adm.req.rid, None)
                    if stash is None:
                        slabs.append(fold_ids(adm.slab, r, self.n_slabs))
                    else:
                        self._restore_slot(r, adm, stash)
                        self.prefill_done[b] = stash["n"]
                        self.stats.prefill_tokens_skipped += stash["n"]
            if self.quant_pools:
                pids.extend(self._folded(
                    r, self.allocators[r].take_scale_dirty()))
        if slabs or pids:
            self._zero_rows(slabs, pids)
        return tick_plan

    def _plan_handoffs(self, tick_plan: dict):
        """Match the slots whose prefill finished (FIFO) to decode replicas
        with a free slot.  The destination slot is claimed now, so this
        tick's admissions see it taken; the transfer (and the source's
        release) happens at dispatch, and a deferred preemption landing on
        the source first rolls the claim back."""
        deferred = {b for b, _ in tick_plan["preempts"]}
        while self._pending_handoffs:
            b_src = self._pending_handoffs[0]
            if b_src in deferred:
                break           # the source is evicted at this collect
            src_adm = self.admissions[b_src]
            cand = [r for r in range(self.R)
                    if self.roles[r] == "decode"
                    and any(self.admissions[b] is None
                            for b in self._rep_slots(r))]
            if not cand:
                break
            dst_r = self.router.decode_placement(cand)
            local = min(b - dst_r * self.Bp for b in self._rep_slots(dst_r)
                        if self.admissions[b] is None)
            resident = int(self.pos[b_src])
            dst_adm = self.scheds[dst_r].plan_handoff(local, src_adm.req,
                                                      resident)
            if dst_adm is None:
                break           # destination pool pressure: the head waits
            b_dst = self._gslot(dst_r, dst_adm.slot)
            self.admissions[b_dst] = dst_adm
            self.slot_state[b_dst] = "decode"
            self.pos[b_dst] = resident
            self.prefill_done[b_dst] = resident
            self.last_token[b_dst] = src_adm.req.out_tokens[-1]
            self.spec_miss[b_dst] = 0
            self._pending_handoffs.pop(0)
            tick_plan["handoffs"].append(
                (b_src, src_adm, dst_r, b_dst, dst_adm))

    def _zero_rows(self, slabs, pids):
        """Zero, in place, slabs ``slabs`` of every SSM layer (state, conv
        tails and, for int8 slabs, scales: the previous owner's state must
        not leak into the new request) and the scale rows of recycled pages
        ``pids`` in the self-KV and cross pools (scale 0 dequantizes to
        exact zeros, so rows past a new occupant's length can never pair
        its payload with the previous owner's scales); both as ids of the
        folded pools, every replica's in one call.  The ids go through the
        plan staging."""
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
                for kind in ("kv", "cross") if pids else ():
                    for name, pool in entry.get(kind, {}).items():
                        if name.endswith("sp"):
                            pool.index_fill_(1, pid, 0.0)

    # --------------------------------------------------------- collect phase
    def _collect_phase(self):
        """Wait for the in-flight dispatch's ids, then emit in dispatch
        order: prefill completions (first token; then decode, or the
        handoff queue on a prefill replica), then the decode or verify
        step's tokens.  A slot retired since dispatch is skipped by its
        (slot, rid) guard."""
        inf = self._inflight
        if inf is None:
            return
        self._inflight = None
        t1 = self._wait_out()
        self.stats.device_busy_s += t1 - inf["t_dispatch"]
        ids = self._out_np
        for row, (b, rid, L) in enumerate(inf["pf"]):
            adm = self.admissions[b]
            if L is None or adm is None or adm.req.rid != rid:
                continue
            r = self._rep(b)
            self.stats.prefills += 1
            self.stats.replicas[r].prefills += 1
            self.scheds[r].on_prefill_complete(adm)
            self.pos[b] = L
            self._emit(b, adm.req, self._token(row, adm.req),
                       time.monotonic())
            if self.admissions[b] is None:
                continue            # retired by that token
            if self.roles is not None and self.roles[r] == "prefill":
                # a prefill replica never decodes: the slot's finished page
                # run waits for a decode replica
                self.slot_state[b] = "handoff"
                self._pending_handoffs.append(b)
            else:
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
                self._emit(b, adm.req, self._token(self.B + b, adm.req), now)
            return
        Q, drafts = self.speculative + 1, step[2]
        for b, rid in step[1]:
            adm = self.admissions[b]
            if adm is None or adm.req.rid != rid:
                continue
            req = adm.req
            d = drafts.get(b, [])
            emitted = 0
            if self.sampled:
                toks = speculative_sample(
                    self._logit_rows(self.B + b * Q, len(d) + 1), d,
                    self.sampler, self.cfg.vocab_size, req.rng)
            else:
                toks = greedy_accept(out[b * Q:b * Q + len(d) + 1], d)
            for tok in toks:
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

    def _run_deferred_preempts(self, tick_plan: dict):
        """Apply the preemption verdicts deferred past collect.  A victim
        that retired at collect is skipped, so no release fires twice
        (``plan_invalidations`` counts it)."""
        for b, rid in tick_plan["preempts"]:
            adm = self.admissions[b]
            if adm is None or adm.req.rid != rid:
                self.stats.plan_invalidations += 1
                continue
            self._preempt_now(b)

    # -------------------------------------------------------- dispatch phase
    def _dispatch_phase(self, tick_plan: dict):
        """Enqueue this tick's steps and return without blocking: the page
        handoffs (their destination slots join this tick's decode step),
        the cross-KV encodes, the COW page copies, a chunk per prefilling
        slot, then the decode-or-verify step, then
        the ids' copy home.  Every encode of the tick runs before any
        chunk, so a slot sharing a pending encode never reads its pages
        unwritten."""
        self._dispatch_handoffs(tick_plan["handoffs"])
        self._dispatch_cross(tick_plan["cross"])
        self._dispatch_cow(tick_plan["cow"])
        pf = self._dispatch_prefill()
        step = self._dispatch_step()
        if pf or step is not None:
            self._send_out({"pf": pf, "step": step})

    def _dispatch_handoffs(self, handoffs: list):
        """Run the planned page-run transfers: every handoff's source and
        destination pages (folded ids) in one copy, then one replay of the
        transfer step each (its inputs
        copied into the step's static buffer on the card first); then the
        references move (``on_handoff_sent``) and the source slot clears.
        A plan whose source was evicted since (a preemption deferred past
        collect) rolls the destination claim back instead."""
        live = []
        for b_src, src_adm, dst_r, b_dst, dst_adm in handoffs:
            if self.admissions[b_src] is not src_adm:
                self.scheds[dst_r].on_finish(dst_adm)
                self._clear_slot(b_dst)
                self.stats.plan_invalidations += 1
                continue
            live.append((b_src, src_adm, dst_r, dst_adm))
        if not live:
            return
        io = self.io["handoff"]
        host = io.host()
        for i, (b_src, src_adm, dst_r, dst_adm) in enumerate(live):
            k = len(src_adm.pages)
            self._xfer_row(io.split(host[i]), self._rep(b_src),
                           src_adm.pages, dst_r, dst_adm.pages[:k])
        io.send(len(live) * io.dev.shape[1])
        for i, (b_src, src_adm, dst_r, dst_adm) in enumerate(live):
            self._xfer_in.copy_(io.dev[i])
            self.steps["transfer"]()
            src_r, k = self._rep(b_src), len(src_adm.pages)
            self.scheds[src_r].on_handoff_sent(
                src_adm, self.allocators[dst_r], dst_adm.pages[:k])
            self._clear_slot(b_src)
            src_adm.req.replica = dst_r
            self.stats.handoffs += 1
            self.stats.pages_transferred += k
            rs, rd = self.stats.replicas[src_r], self.stats.replicas[dst_r]
            rs.handoffs_out += 1
            rd.handoffs_in += 1
            rs.pages_transferred_out += k
            rd.pages_transferred_in += k

    def _xfer_row(self, f: dict, src_r: int, src_pages, dst_r: int,
                  dst_pages):
        """Fill a transfer step's input row ``f``: replica ``src_r``'s
        pages onto replica ``dst_r``'s, as folded ids; unused lanes copy
        the source's scratch page onto the destination's."""
        k = len(src_pages)
        f["src_pages"][:] = self._folded(src_r, [SCRATCH_PAGE])
        f["dst_pages"][:] = self._folded(dst_r, [SCRATCH_PAGE])
        f["src_pages"][:k] = self._folded(src_r, src_pages)
        f["dst_pages"][:k] = self._folded(dst_r, dst_pages)

    def _dispatch_cross(self, adms: List[Admission]):
        """Each admission's encode: every encode's frames and cross block
        table (folded ids) in one copy each, then one replay of the
        cross-KV write step each (its inputs copied into the step's static
        buffers on the card first); the pages are published to the
        replica's cross-KV cache once the write is enqueued (a later read
        is behind it on the stream)."""
        if not adms:
            return
        fio, cio = self.io["frames"], self.io["cross"]
        frames, host = fio.host(), cio.host()
        for i, adm in enumerate(adms):
            frames[i] = np.asarray(adm.req.frames, np.float32).reshape(-1)
            host[i] = self._folded(adm.req.replica, adm.cross_pages)
        fio.send(len(adms) * fio.dev.shape[1])
        cio.send(len(adms) * cio.dev.shape[1])
        for i, adm in enumerate(adms):
            self._frames_in.view(-1).copy_(fio.dev[i])
            self._cross_in.copy_(cio.dev[i])
            self.steps["cross"]()
            self.scheds[adm.req.replica].on_cross_written(adm)
            self.stats.cross_encodes += 1

    def _dispatch_cow(self, cows: list):
        """Each (replica, admission)'s copy-on-write page: every (src, dst)
        pair (folded ids) in one copy, then one replay of the copy step per
        pair, before any chunk writes into the copy; the source's pin is
        released after."""
        if not cows:
            return
        io = self.io["copy"]
        host = io.host()
        for i, (r, adm) in enumerate(cows):
            host[i] = self._folded(r, adm.cow)
        io.send(len(cows) * io.dev.shape[1])
        for i, (r, adm) in enumerate(cows):
            self._copy_in.copy_(io.dev[i])
            self.steps["copy"]()
            self.scheds[r].on_cow_done(adm)
            self.stats.cow_copies += 1

    def _slab_id(self, b: int, active: bool = True) -> int:
        """Slot b's slab, or its replica's scratch slab: a folded id."""
        adm = self.admissions[b]
        slab = adm.slab if (active and adm is not None
                            and adm.slab is not None) else SCRATCH_SLAB
        return fold_ids(slab, self._rep(b), self.n_slabs)

    def _bt_row(self, b: int, active: bool = True) -> np.ndarray:
        """Slot b's block table, its replica's scratch page past its pages
        (every page when not ``active``): folded ids."""
        row = np.full(self.n_max_pages, SCRATCH_PAGE, np.int32)
        adm = self.admissions[b]
        if active and adm is not None:
            row[:len(adm.pages)] = adm.pages
        return self._folded(self._rep(b), row)

    def _cross_row(self, b: int, active: bool = True) -> np.ndarray:
        """Slot b's cross block table: its cross pages, or its replica's
        scratch page for a slot without them: folded ids."""
        row = np.full(self.n_cross_pages, SCRATCH_PAGE, np.int32)
        adm = self.admissions[b]
        if active and adm is not None and adm.cross_pages is not None:
            row[:] = adm.cross_pages
        return self._folded(self._rep(b), row)

    def _dispatch_prefill(self) -> list:
        """Advance every prefilling slot by one chunk, in JAX's round
        order (the first prefilling slot of each replica, then the second,
        ...): all chunks' inputs in one copy, then one replay per chunk.
        -> [(slot, rid, prompt length if this chunk completes the prompt
        else None)], chunk i's id at ids row i."""
        per_rep = [[b for b in self._rep_slots(r)
                    if self.admissions[b] is not None
                    and self.slot_state[b] == "prefill"]
                   for r in range(self.R)]
        rows = [slots[k] for k in range(max(map(len, per_rep)))
                for slots in per_rep if k < len(slots)]
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
            if self.has_cross:
                f["cross_bt"][0] = self._cross_row(b)
            self.prefill_done[b] = c0 + C
            pf.append((b, req.rid, L if c0 + C >= L else None))
        io.send(len(rows) * io.dev.shape[1])
        for i, entry in enumerate(pf):
            self._prefill_round(i, entry)
        return pf

    def _prefill_round(self, i: int, entry):
        """Replay the chunk step on chunk i's inputs; its id (and, on a
        sampled engine, the logits row of a chunk that completes its
        prompt) goes to row i before the next replay overwrites the step's
        own."""
        self._chunk_in.copy_(self.io["chunk"].dev[i])
        logits, ids = self.steps["chunk"]()
        self._out[i:i + 1].copy_(ids)
        if self.sampled and entry[2] is not None:
            self._lout[i].copy_(logits[0])

    def _dispatch_step(self):
        """The decode-or-verify step over every decode-state slot of every
        replica.  -> ("decode", [(slot, rid)]), ("verify", [(slot, rid)],
        drafts) or None."""
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
        prefilling lanes ride along on their replica's scratch page (and
        slab) with pos 0, the contiguous engine's idle lanes with token 0
        and pos 0."""
        io = self.io["decode"]
        f = io.split(io.host()[0])
        f["tokens"][:, 0] = self.last_token
        act = np.isin(np.arange(self.B), active)
        f["pos"][:] = np.where(act, self.pos, 0)
        if self.paged:
            for b in range(self.B):
                f["block_table"][b] = self._bt_row(b, bool(act[b]))
                if self.has_slabs:
                    f["slab_ids"][b] = self._slab_id(b, bool(act[b]))
                if self.has_cross:
                    f["cross_bt"][b] = self._cross_row(b, bool(act[b]))
        io.send()
        logits, ids = self.steps["decode"]()
        self._out[self.B:2 * self.B].copy_(ids)
        if self.sampled:
            self._lout[self.B:2 * self.B].copy_(logits)
        return "decode", [(b, self.admissions[b].req.rid) for b in active]

    def _plan_drafts(self, active: List[int]):
        """Draft up to k tokens per speculation-capable active slot, from
        its replica's draft source.  -> {slot: draft tokens} holding only
        non-empty drafts, or None when nothing drafted.  A slot whose
        drafts missed ``SPEC_DISABLE_AFTER`` times in a row stops drafting
        and returns its headroom pages."""
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
                self.scheds[self._rep(b)].on_spec_trim(adm, keep)
                continue
            self.stats.spec_draft_lookups += 1
            draft = self.draft_sources[self._rep(b)].draft(
                effective_prompt(req), k)
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
        (draftless slots ride along as qlen=1 rows, idle lanes on their
        replica's scratch page with pos 0 and qlen 1)."""
        io = self.io["verify"]
        f = io.split(io.host()[0])
        f["tokens"][:] = 0
        f["qlen"][:] = 1
        f["pos"][:] = 0
        for b in range(self.B):
            f["block_table"][b] = self._bt_row(b, False)
        for b in active:
            d = drafts.get(b, [])
            f["tokens"][b, 0] = self.last_token[b]
            f["tokens"][b, 1:1 + len(d)] = d
            f["qlen"][b] = len(d) + 1
            f["pos"][b] = self.pos[b]
            f["block_table"][b] = self._bt_row(b)
        io.send()
        logits, ids = self.steps["verify"]()
        self._out[self.B:].copy_(ids.reshape(-1))
        if self.sampled:
            self._lout[self.B:].copy_(logits.reshape(-1, logits.shape[-1]))
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
        self.stats.replicas[self._rep(b)].decoded_tokens += 1
        if tok == self.eos or len(req.out_tokens) >= req.max_new_tokens \
                or self.pos[b] >= self.S - 1:
            req.done = True
            req.t_done = now
            self.stats.tpot_s.append(
                (now - req.t_first_token) / max(len(req.out_tokens) - 1, 1))
            self.scheds[self._rep(b)].on_finish(self.admissions[b])
            self._clear_slot(b)

    def _clear_slot(self, b: int):
        self.admissions[b] = None
        self.slot_state[b] = None
        self.pos[b] = 0
        self.last_token[b] = 0
        self.prefill_done[b] = 0
        self.spec_miss[b] = 0
        if b in self._pending_handoffs:
            self._pending_handoffs.remove(b)
