"""Serving launcher of the PyTorch port: batched requests through the
serving engine, on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-42m \\
        --requests 16 --slots 8 --seq-budget 256 --max-new 32 [--paged]

Takes the flags of ``python -m repro.launch.serve`` that the greedy
one-replica path supports, and selects the engine as that launcher does:
the contiguous engine by default, the paged engine with ``--paged`` or
``--speculative K`` (prompt-lookup drafts verified in one step,
attention-only archs).  ``--kv-dtype int8`` stores fixed-scale int8 lanes
(contiguous) or int8 page pools and SSM state slabs (paged).
``--arch mamba2-370m`` serves the SSM decoder from per-slot state lanes,
or from state slabs with ``--paged``.  The paged engine pipelines its tick
(plan the next tick while this one runs on the card) unless
``--no-overlap``, as the JAX launcher does, and prints the ``pipeline:``
line; the contiguous engine ignores the flag, as in JAX.  The port runs
tp=1, dp=1, FCFS and greedy: the JAX launcher's other flags parse with its
defaults, and a value the port cannot serve (``--tp 2``, ``--temperature
0.7``, any ``--prefix-cache``, ...) is refused with the slice it waits
for.  Weights are random, drawn from ``--seed``; prompts are random token
ids.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

# flags of the JAX launcher, parsed with its types and defaults: (the
# values the port serves, the later slice of the port that brings the rest)
LATER = {
    "--tp": ((1,), "tensor parallelism (ROADMAP Queue 1 item 12)"),
    "--dp": ((1,), "data-parallel replicas (ROADMAP Queue 1 item 11)"),
    "--disagg": ((None,), "disaggregated prefill/decode (ROADMAP Queue 1 "
                          "item 11)"),
    "--scale-events": ((None,), "elastic replicas (ROADMAP Queue 1 item 11)"),
    "--temperature": ((0.0,), "sampled decoding (ROADMAP Queue 1 item 6)"),
    "--prefix-cache": ((False,), "the prefix cache (ROADMAP Queue 1 item 4)"),
    "--shared-prefix": ((0,), "the prefix cache (ROADMAP Queue 1 item 4)"),
    "--frame-groups": ((1,), "encoder-decoder serving (ROADMAP Queue 1 "
                             "item 9)"),
    "--policy": (("fcfs",), "priority and fair policies (ROADMAP Queue 1 "
                            "item 4)"),
    "--preemption": ((False,), "preemption (ROADMAP Queue 1 item 4)"),
    "--high-priority-every": ((0,), "priority policies (ROADMAP Queue 1 "
                                    "item 4)"),
    "--clients": ((1,), "the fair policy (ROADMAP Queue 1 item 4)"),
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="greedy serving on the PyTorch port")
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
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--shared-prefix", type=int, default=0)
    ap.add_argument("--frame-groups", type=int, default=1, metavar="K")
    ap.add_argument("--policy", choices=("fcfs", "priority", "fair"),
                    default="fcfs")
    ap.add_argument("--preemption", action="store_true")
    ap.add_argument("--high-priority-every", type=int, default=0, metavar="N")
    ap.add_argument("--clients", type=int, default=1)
    args = ap.parse_args(argv)
    for flag, (served, slice_) in LATER.items():
        value = getattr(args, flag[2:].replace("-", "_"))
        if value not in served:
            shown = flag if isinstance(value, bool) else f"{flag} {value}"
            ap.error(f"{shown} is not supported by the PyTorch port yet: it "
                     f"waits for {slice_}")
    if args.speculative < 0:
        ap.error("--speculative must be >= 0")
    from repro_torch.configs import get_config
    from repro_torch.core.kvcache import cache_profile
    try:
        cfg = get_config(args.arch)
    except KeyError as e:
        ap.error(str(e))
    if args.speculative and "ssm" in cache_profile(cfg):
        ap.error(f"--speculative is unsupported for arch '{args.arch}': SSM "
                 f"recurrences advance one token per step")
    if args.prompt_len + args.max_new > args.seq_budget:
        ap.error("--prompt-len + --max-new must fit --seq-budget")
    return args


def main(argv=None):
    args = parse_args(argv)
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.core import model
    from repro_torch.core.partition import ShardingPlan
    from repro_torch.serving import Request, ServingEngine

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    kvd = {"fp32": "float32", "fp16": "bfloat16", "int8": "int8"}[
        args.kv_dtype]
    plan = ShardingPlan(kv_cache_dtype=kvd,
                        ssm_cache_dtype="int8" if args.kv_dtype == "int8"
                        else "")
    params = model.init_params(cfg, plan,
                               torch.Generator().manual_seed(args.seed),
                               device=args.device)
    if args.paged or args.speculative:
        engine = ServingEngine.build_paged(
            cfg, plan, args.slots, args.seq_budget, params,
            page_size=args.page_size, n_pages=args.n_pages,
            prefill_chunk=args.prefill_chunk, rng_seed=args.seed,
            speculative=args.speculative, overlap=args.overlap,
            device=args.device)
    else:
        engine = ServingEngine(cfg, plan, args.slots, args.seq_budget, params,
                               rng_seed=args.seed, device=args.device)
    rng = np.random.RandomState(args.seed)
    t0 = time.time()
    for rid in range(args.requests):
        prompt = rng.randint(2, cfg.vocab_size,
                             rng.randint(4, args.prompt_len + 1)
                             ).astype(np.int32)
        engine.submit(Request(rid=rid, prompt=prompt,
                              max_new_tokens=args.max_new))
    stats = engine.run()
    dt = time.time() - t0
    where = (torch.cuda.get_device_name(engine.device)
             if engine.device.type == "cuda" else "cpu")
    print(f"device={where} arch={cfg.name} "
          f"engine={'paged' if engine.paged else 'contiguous'} "
          f"requests={args.requests} "
          f"ticks={stats.ticks} prefills={stats.prefills} "
          f"tokens={stats.decoded_tokens}")
    if stats.ttft_s:
        print(f"throughput={stats.decoded_tokens / dt:.1f} tok/s "
              f"ttft_p50={np.median(stats.ttft_s) * 1e3:.1f}ms "
              f"ttft_p99={np.percentile(stats.ttft_s, 99) * 1e3:.1f}ms "
              f"tpot_p50={np.median(stats.tpot_s) * 1e3:.1f}ms")
    else:
        print("no tokens emitted")
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
        print(f"pages_free={engine.allocator.n_free}/"
              f"{engine.allocator.n_pages - engine.allocator.n_reserved}")
    if engine.has_slabs:
        print(f"ssm_slabs: slabs={engine.n_slabs - 1} "
              f"allocated={engine.slab_allocator.total_allocated} "
              f"free={engine.slab_allocator.n_free}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
