"""Serving launcher of the PyTorch port: batched requests through the
serving engine, on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-42m \\
        --requests 16 --slots 8 --seq-budget 256 --max-new 32 [--paged]

Takes the flags of ``python -m repro.launch.serve`` that the one-replica
path supports, and selects the engine as that launcher does:
the contiguous engine by default, the paged engine with ``--paged`` or
``--speculative K`` (prompt-lookup drafts verified in one step,
attention-only archs).  ``--kv-dtype int8`` stores fixed-scale int8 lanes
(contiguous) or int8 page pools and SSM state slabs (paged).
``--arch tinyllama-42m-64h`` serves the paper's 64-head variant (head_dim
8).  ``--arch seamless-m4t-large-v2`` serves the encoder-decoder: every
request carries one of ``--frame-groups K`` random frame tensors (request
i the (i mod K)-th), encoded at admission (contiguous) or once per
distinct tensor, its cross-KV pages shared by frames digest (``--paged``,
which prints JAX's ``cross_kv:`` line); ``--prefix-cache`` and
``--speculative`` are refused for it, as in JAX.  ``--arch mamba2-370m`` serves the SSM decoder from per-slot state lanes,
or from state slabs with ``--paged``; ``--arch qwen3-0.6b`` a GQA decoder
with qk-norm, ``--arch gemma3-12b`` gemma3 (sliding windows on 5 of
every 6 layers, head_dim 256, sandwich norms, a gelu FFN; 23.5 GB of bf16
weights at full width); ``--arch mistral-large-123b`` a dense decoder of
d_model 12288 with 12 q heads a kv head and an untied LM head (245 GB of
bf16 weights at full depth: on one card, serve it with ``--smoke``, or at
full width and a cut depth from a script, as ``chip_smoke.py`` does;
``--speculative`` is refused on the card, its verify kernel takes R x Q
<= 16); ``--arch hymba-1.5b`` the hybrid (attention and
SSD heads in every layer, windows of 1024 on 29 of 32 layers), from
per-slot KV and state lanes, or with ``--paged`` from KV pages and a
state slab per request (``--kv-dtype int8``: int8 pools and slabs;
``--policy priority --preemption`` stashes both on the host).
``--arch deepseek-moe-16b`` serves the mixture of experts (6 of 64
routed experts and 2 shared ones in every layer but the first: 32.75 GB
of bf16 weights, whole on one card), ``--arch mixtral-8x22b`` 2 of 8
experts with windows of 4096 (282 GB of bf16 at full depth: serve it
with ``--smoke`` on one card); JAX's launcher has no MoE flag, so the
capacity factor is the plan's 1.25 in both.  SSM archs
refuse ``--speculative`` and ``--prefix-cache``, as in JAX, and print
the ``ssm_slabs:`` line when paged.  ``--prefix-cache`` (implies
``--paged``) shares cached prompt prefixes through a radix tree with
copy-on-write pages and prints the ``prefix_cache:`` line;
``--shared-prefix N`` prepends a common N-token prefix to every prompt.
``--policy {fcfs,priority,fair}`` picks the admission policy; ``--policy
priority --preemption`` (or ``fair``) also evicts running slots (paged
engine); ``--high-priority-every N`` makes every Nth request urgent and
splits TTFT by class, ``--clients N`` spreads requests over N client ids.
The paged engine pipelines its tick (plan the next tick while this one
runs on the card) unless ``--no-overlap``, as the JAX launcher does, and
prints the ``pipeline:`` line; the contiguous engine ignores the flag, as
in JAX.  ``--temperature T`` > 0 samples with ``top_k=40``, each request
from its own stream seeded by ``--seed`` and its id, as the JAX launcher
does (0, the default, is greedy).  ``--dp N`` serves N data-parallel
replicas on the one card (selects the paged engine; the router places
each request, and a ``router:`` line and a ``replica[r]:`` line each
report them), ``--disagg P:D`` (with ``--dp P+D``) splits them into
prefill and decode replicas that hand finished page runs over (a
``disagg(...)`` line), with the JAX launcher's checks.
``--scale-events T:N[,T:N...]`` (with ``T:kill:R`` entries) changes the
paged engine's replica count live: at tick T it scales to N replicas
(a drain migrates in-flight pages to the survivors) or kills replica R
(its requests are re-admitted elsewhere), and prints JAX's ``elastic:``
line; it is refused with ``--disagg`` and without the paged engine, with
the JAX launcher's messages.  The port runs tp=1: ``--tp 2`` is refused
with the slice it waits for.
Weights are random, drawn from ``--seed`` on the serving device (a CUDA
generator on the card: full-width draws stay there); prompts are random
token ids.
"""
from __future__ import annotations

import argparse
import functools
import sys
import time

import numpy as np

# flags of the JAX launcher, parsed with its types and defaults: (the
# values the port serves, the later slice of the port that brings the rest)
LATER = {
    "--tp": ((1,), "tensor parallelism (ROADMAP Queue 1 item 12)"),
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="serving on the PyTorch port")
    ap.add_argument("--arch", required=True,
                    help="registered config id (repro_torch.configs)")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family config (CPU-sized)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--seq-budget", type=int, default=256)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kv-dtype", choices=("fp32", "fp16", "int8"),
                    default="fp16",
                    help="KV dtype: fp32, fp16 (bfloat16, as in the JAX "
                         "launcher) or int8 (contiguous lanes at a fixed "
                         "scale; paged pools with per-row scales, and SSM "
                         "state slabs with per-(slab, head) scales)")
    ap.add_argument("--paged", action="store_true",
                    help="the paged engine (page pools, chunked prefill, "
                         "SSM state slabs) instead of the contiguous one")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--n-pages", type=int, default=0,
                    help="page pool size (0 = full occupancy + scratch)")
    ap.add_argument("--speculative", type=int, default=0, metavar="K",
                    help="speculative decoding: prompt-lookup self-drafts "
                         "of up to K tokens verified in one step (outputs "
                         "stay token-identical)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the Hopper kernels) or cpu (plain PyTorch)")
    # the JAX launcher's flags of later slices, with its types and defaults
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--disagg", default=None, metavar="P:D")
    ap.add_argument("--scale-events", default=None, metavar="T:N[,T:N...]")
    ap.add_argument("--overlap", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="plan tick t+1 while tick t's steps run on the card "
                         "(paged engine; --no-overlap is the serial loop, "
                         "token-identical either way)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (top_k 40, as the JAX "
                         "launcher); 0 is greedy")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix prefix sharing with copy-on-write pages "
                         "(implies --paged)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend a common system-prompt prefix of this "
                         "many tokens to every request")
    ap.add_argument("--frame-groups", type=int, default=1, metavar="K",
                    help="enc-dec archs: spread requests over K distinct "
                         "synthetic frame tensors (requests in a group "
                         "share one encode's cross-KV pages)")
    ap.add_argument("--policy", choices=("fcfs", "priority", "fair"),
                    default="fcfs", help="admission policy "
                                         "(serving.policies)")
    ap.add_argument("--preemption", action="store_true",
                    help="evict running slots for urgent or starved "
                         "requests (--policy priority or fair, paged "
                         "engine)")
    ap.add_argument("--high-priority-every", type=int, default=0, metavar="N",
                    help="every Nth request gets priority 10 (0 = uniform "
                         "priority)")
    ap.add_argument("--clients", type=int, default=1,
                    help="spread requests over N client ids (fair policy)")
    args = ap.parse_args(argv)
    for flag, (served, slice_) in LATER.items():
        value = getattr(args, flag[2:].replace("-", "_"))
        if value not in served:
            shown = flag if isinstance(value, bool) else f"{flag} {value}"
            ap.error(f"{shown} is not supported by the PyTorch port yet: it "
                     f"waits for {slice_}")
    if args.speculative < 0:
        ap.error("--speculative must be >= 0")
    if args.dp < 1:
        ap.error("--dp must be >= 1")
    args.disagg_pd = None
    if args.disagg is not None:
        try:
            p, d = (int(x) for x in args.disagg.split(":"))
        except ValueError:
            ap.error("--disagg expects P:D (e.g. --disagg 1:1)")
        if p < 1 or d < 1 or p + d != args.dp:
            ap.error(f"--disagg {args.disagg} needs --dp {p + d} "
                     f"(P + D replicas, both >= 1)")
        args.disagg_pd = (p, d)
    args.scale_events_list = []
    if args.scale_events:
        if not (args.paged or args.prefix_cache or args.dp > 1
                or args.speculative):
            ap.error("--scale-events requires the paged engine (--paged)")
        if args.disagg_pd is not None:
            ap.error("--scale-events cannot combine with --disagg "
                     "(role sets are static)")
        for part in args.scale_events.split(","):
            bits = part.split(":")
            try:
                if len(bits) == 2:
                    args.scale_events_list.append(
                        (int(bits[0]), "scale", int(bits[1])))
                elif len(bits) == 3 and bits[1] == "kill":
                    args.scale_events_list.append(
                        (int(bits[0]), "kill", int(bits[2])))
                else:
                    raise ValueError(part)
            except ValueError:
                ap.error("--scale-events expects comma-separated T:N or "
                         "T:kill:R entries")
        args.scale_events_list.sort()
    from repro_torch.configs import get_config
    from repro_torch.core.kvcache import cache_profile
    try:
        cfg = get_config(args.arch)
    except KeyError as e:
        ap.error(str(e))
    if cfg.is_encoder_only:
        ap.error(f"arch '{args.arch}': encoder-only arch has no decode path "
                 f"to serve")
    if args.speculative and "ssm" in cache_profile(cfg):
        ap.error(f"--speculative is unsupported for arch '{args.arch}': SSM "
                 f"recurrences advance one token per step")
    if args.shared_prefix + args.prompt_len + args.max_new > args.seq_budget:
        ap.error("--shared-prefix + --prompt-len + --max-new must fit "
                 "--seq-budget")
    if args.preemption and args.policy not in ("priority", "fair"):
        ap.error("--preemption requires --policy priority or fair")
    if args.preemption and not (args.paged or args.prefix_cache
                                or args.dp > 1):
        ap.error("--preemption requires the paged engine (--paged)")
    return args


def main(argv=None):
    args = parse_args(argv)
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.core import model
    from repro_torch.core.device import resolve_device
    from repro_torch.core.partition import ShardingPlan
    from repro_torch.serving import (FairScheduler, PriorityScheduler,
                                     Request, SamplerConfig, ServingEngine)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    kvd = {"fp32": "float32", "fp16": "bfloat16", "int8": "int8"}[
        args.kv_dtype]
    plan = ShardingPlan(kv_cache_dtype=kvd,
                        ssm_cache_dtype="int8" if args.kv_dtype == "int8"
                        else "")
    dev = resolve_device(args.device)
    params = model.init_params(cfg, plan,
                               torch.Generator(device=dev).manual_seed(
                                   args.seed),
                               device=dev)
    sampler = SamplerConfig(temperature=args.temperature, top_k=40)
    scheduler = None                 # engine default: FCFS
    if args.policy != "fcfs":
        scheduler = functools.partial(
            PriorityScheduler if args.policy == "priority" else FairScheduler,
            preemption=args.preemption)
    if args.paged or args.prefix_cache or args.speculative or args.dp > 1:
        engine = ServingEngine.build_paged(
            cfg, plan, args.slots, args.seq_budget, params,
            page_size=args.page_size, n_pages=args.n_pages,
            prefill_chunk=args.prefill_chunk, sampler=sampler,
            rng_seed=args.seed,
            speculative=args.speculative, prefix_cache=args.prefix_cache,
            scheduler=scheduler, overlap=args.overlap, dp=args.dp,
            disagg=args.disagg_pd, device=args.device)
        if args.scale_events_list:
            def membership_hook(e, _pending=list(args.scale_events_list)):
                while _pending and e.stats.ticks >= _pending[0][0]:
                    _, kind, val = _pending.pop(0)
                    if kind == "scale":
                        e.scale_to(val)
                    else:
                        e.kill_replica(val)
            engine.membership_hook = membership_hook
    else:
        engine = ServingEngine(cfg, plan, args.slots, args.seq_budget, params,
                               sampler=sampler, rng_seed=args.seed,
                               scheduler=scheduler, device=args.device)
    rng = np.random.RandomState(args.seed)
    shared = rng.randint(2, cfg.vocab_size,
                         args.shared_prefix).astype(np.int32)
    # the JAX launcher's order of draws: the shared prefix, the frame
    # tensors, then each prompt
    frame_groups = [rng.randn(cfg.enc_seq_len, cfg.d_model).astype(np.float32)
                    for _ in range(max(args.frame_groups, 1))] \
        if cfg.is_encdec else []
    reqs = []
    t0 = time.time()
    for rid in range(args.requests):
        prompt = rng.randint(2, cfg.vocab_size,
                             rng.randint(4, args.prompt_len + 1)
                             ).astype(np.int32)
        hi = args.high_priority_every and rid % args.high_priority_every == 0
        req = Request(rid=rid, prompt=np.concatenate([shared, prompt]),
                      max_new_tokens=args.max_new, priority=10 if hi else 0,
                      client_id=rid % max(args.clients, 1),
                      frames=(frame_groups[rid % len(frame_groups)]
                              if frame_groups else None))
        reqs.append(req)
        engine.submit(req)
    stats = engine.run()
    dt = time.time() - t0
    where = (torch.cuda.get_device_name(engine.device)
             if engine.device.type == "cuda" else "cpu")
    decoding = (f"sampled(temperature={args.temperature},top_k=40)"
                if engine.sampled else "greedy")
    print(f"device={where} arch={cfg.name} "
          f"engine={'paged' if engine.paged else 'contiguous'} "
          f"decoding={decoding} requests={args.requests} "
          f"ticks={stats.ticks} prefills={stats.prefills} "
          f"tokens={stats.decoded_tokens} preemptions={stats.preemptions}")
    if stats.ttft_s:
        print(f"throughput={stats.decoded_tokens / dt:.1f} tok/s "
              f"ttft_p50={np.median(stats.ttft_s) * 1e3:.1f}ms "
              f"ttft_p99={np.percentile(stats.ttft_s, 99) * 1e3:.1f}ms "
              f"tpot_p50={np.median(stats.tpot_s) * 1e3:.1f}ms")
    else:
        print("no tokens emitted")
    if args.high_priority_every:
        for label, cls in (("high", 10), ("low", 0)):
            ts = [stats.request_ttft[r.rid] for r in reqs
                  if r.priority == cls and r.rid in stats.request_ttft]
            if ts:
                print(f"ttft[{label}]: p50={np.median(ts) * 1e3:.1f}ms "
                      f"p99={np.percentile(ts, 99) * 1e3:.1f}ms n={len(ts)}")
    caches = [c for c in engine.prefix_caches if c is not None]
    if caches:
        print(f"prefix_cache: hit_rate={stats.prefix_hit_rate:.2f} "
              f"({stats.prefix_hits}/{stats.prefix_lookups} lookups) "
              f"prefill_tokens_skipped={stats.prefill_tokens_skipped} "
              f"cow_copies={stats.cow_copies} "
              f"cached_pages={sum(c.n_cached_pages for c in caches)} "
              f"evictions={sum(c.evictions for c in caches)}")
    if args.speculative:
        print(f"speculative(k={args.speculative}): accepted_tokens_per_tick="
              f"{stats.accepted_tokens_per_tick:.2f} draft_hit_rate="
              f"{stats.draft_hit_rate:.2f} ({stats.spec_draft_hits}/"
              f"{stats.spec_draft_lookups} lookups) accepted="
              f"{stats.spec_accepted}/{stats.spec_drafted} drafted "
              f"spec_denied={stats.spec_denied}")
    if engine.paged:
        print(f"pipeline: overlap={'on' if engine.overlap else 'off'} "
              f"device_busy_fraction={stats.device_busy_fraction:.2f} "
              f"plan_ahead_ticks={stats.plan_ahead_ticks} "
              f"plan_invalidations={stats.plan_invalidations} "
              f"collect_wait={stats.collect_wait_s * 1e3:.1f}ms")
        allocs = engine.allocators
        print(f"pages_free={sum(a.n_free for a in allocs)}/"
              f"{sum(a.n_pages - a.n_reserved for a in allocs)}")
    if engine.cross_caches:
        print(f"cross_kv: hit_rate={stats.cross_hit_rate:.2f} "
              f"({stats.cross_hits}/{stats.cross_lookups} lookups) "
              f"encodes={stats.cross_encodes} cached_entries="
              f"{sum(c.n_entries for c in engine.cross_caches)}")
    if engine.has_slabs:
        slabs = engine.slab_allocators
        print(f"ssm_slabs: slabs={engine.n_slabs - 1} "
              f"allocated={sum(s.total_allocated for s in slabs)} "
              f"free={sum(s.n_free for s in slabs)} "
              f"stash_restores={stats.slab_restores}")
    if args.disagg_pd is not None:
        print(f"disagg(P={args.disagg_pd[0]} D={args.disagg_pd[1]}): "
              f"handoffs={stats.handoffs} "
              f"pages_transferred={stats.pages_transferred}")
    if args.scale_events:
        print(f"elastic: scale_events={stats.scale_events} "
              f"crashes={stats.crashes} migrations={stats.migrations} "
              f"migrated_pages={stats.migrated_pages} "
              f"readmitted={stats.readmitted} dp_final={engine.R}")
    if args.dp > 1:
        print(f"router: affinity_routed={engine.router.affinity_routed}"
              f"/{args.requests}")
        for r, rs in enumerate(stats.replicas):
            alloc = engine.allocators[r]
            handoff = ""
            if args.disagg_pd is not None:
                handoff = (f" role={rs.role} "
                           f"handoffs={rs.handoffs_out}out/"
                           f"{rs.handoffs_in}in "
                           f"pages_transferred={rs.pages_transferred_out}"
                           f"out/{rs.pages_transferred_in}in")
            print(f"replica[{r}]: routed={rs.routed} "
                  f"prefills={rs.prefills} tokens={rs.decoded_tokens} "
                  f"preemptions={rs.preemptions} "
                  f"prefix_hit_rate={rs.prefix_hit_rate:.2f} "
                  f"pages_allocated={alloc.total_allocated} "
                  f"pages_free={alloc.n_free}/"
                  f"{alloc.n_pages - alloc.n_reserved}" + handoff)
    return 0


if __name__ == "__main__":
    sys.exit(main())
