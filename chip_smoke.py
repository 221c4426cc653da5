#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card: the quickest proof that
the port still builds, runs its Hopper kernels and serves on the GPU.

    python3 chip_smoke.py

Run from the root of a checkout (it puts ``src/`` on ``sys.path``).  It
imports nothing of JAX and nothing of the JAX package.  Phases, one line
each (and a few detail lines):

1. env      the card (nvidia-smi name and power limit), torch and CUDA
            versions, the time to build every kernel from ``src/``, and
            each kernel instantiation's registers and spills (ptxas).
2. kernels  each of the fourteen kernel variants (rmsnorm alone, with the
            residual add fused in and as mamba2's gated norm, matmul, the
            matmul over an MoE layer's expert axis, flash
            attention, paged decode and paged verify over float and int8
            pools, the SSD scan from a float or an int8 state, decode
            attention over contiguous float or fixed-scale int8 lanes)
            against its plain PyTorch
            version on the card, at the main paths' shapes plus ragged cases
            (for rmsnorm also qwen3's qk-norm rows, E 128 at T 128 and
            512, and its E 1024 at T 8, with random scales; for the norm
            family T in {8, 32, 160}, E 512 and 1024, the
            residual variant's sum bitwise x + r and its norm bitwise
            ops.rmsnorm(x + r), the gated one over n = 2048 with y, z and
            the output each float32 or bf16, one kernel node per call;
            (for matmul every product of the three models at M in {8, 32, 33,
            40, 160}, K or N off a multiple of 8, two bf16 calls bitwise
            equal, one kernel node per call in a CUDA graph, and times per
            shape beside torch.matmul's;
            for paged attention page-crossing lengths, a shuffled block
            table, an idle lane on scratch page 0, verify at Q in {1, 2, 5,
            8}, zero-scale rows, lengths on page edges at head dims 32, 64
            and 128 and pages of 8 and 16, two bf16 calls bitwise equal, one
            kernel node per call, and a CUDA graph of each entry replayed
            after its length changes in place equal to the eager call; for
            flash attention the prefill chunk at q_offset 0, 96 and 224
            with and without windows, and at 37, 213 and 230 (where a chunk
            resumes after a prefix hit; rows past Skv at 230), the offset
            as an int32 on the card (a
            graph replayed after it changed in place equals the eager
            call), the contiguous prefill's square Sq =
            Skv in
            {23, 130, 160}, head dims 32, 64 and 128, and times at four
            shapes beside SDPA's; for the SSD scan the serve chunk, S = 5
            and 33, several chunks with a partial tail, trailing dt = 0
            rows, two batch rows, y and the final state; flash and the SSD
            scan also two bf16 calls bitwise equal and one kernel node per
            call; for the contiguous decode, float and int8 lanes, S 256
            and 1024 with full, ragged, tile-edge and zero lengths, S = 300
            with D 32 and 128 and an idle lane, NaN in every float key and
            value past a row's length, two bf16 calls bitwise equal, one
            kernel node per call and a graph replayed after `length`
            changes equal to the eager call), with the stated tolerance;
            then GQA at qwen3's shapes (16 q over 8 kv heads, D 128; float32
            and bf16): flash over the chunk at q_offset 0, 96, 224 and 230
            (an int32 on the card) and whole prompts of 23 and 160, paged
            decode and verify at Q 5 and 8 (R Q = 16) over float and int8
            pools (B 8, pages of 16, ragged lengths, graphs replayed after
            length changes), the contiguous decode over float and int8
            lanes at S 256 and 1024, and verify refusing R Q = 18 before
            any launch; then sliding windows and head_dim 256 at gemma3's
            shapes (16 q over 8 kv heads): paged decode and verify (Q 5)
            with windows of 64 and 1024 at D 64, 128 and 256 (B 8, pages of
            16, n_max 128, lengths 100-2000), float32 and bf16 over float
            and int8 pools, graphs replayed as lengths cross the window; the
            contiguous decode at D 256 over a 1024-slot ring past its wrap;
            flash at D 256 over a 128-row chunk at q_offset 1400 in 2048 keys
            with and without the window of 1024 and a 512-token prompt;
            rmsnorm at E 3840 and 256; matmul at every gemma3 projection
            and the 262,144-row tied head; then hymba-1.5b's shapes (25 q
            heads over 25 kv slots, group 1, D 64): paged decode with the
            window of 1024 and without over bf16 and int8 pools (B 8, pages
            of 16, n_max 128, lengths 100-2000), the contiguous decode over
            a 1024-slot ring, flash over the 128-row chunk at q_offset 1400
            in 2048 keys, the SSD scan at H 50, P 64, N 16 over 128 rows
            from a zero, float32 and int8 state, the gated norm over 3200
            channels, rmsnorm at E 1600, matmul at every hymba projection
            (in_dt's N 50, in_B/in_C's N 16) and the 32,001-row head; then
            mistral-large-123b's shapes (96 q over 8 kv heads, group 12, D
            128): flash over the chunk (Sq 32 at q_offset 256 in 288 keys,
            and the first chunk), paged decode (B 8, lengths to 256, a
            graph replayed after they change), the norms at E 12288,
            matmul at M 8 and 32 for wq, wk/wv, wo, w_gate/w_up and
            w_down (K and N to 28672) and the untied (32768, 12288) head at
            M 8 and 1; then tinyllama-42m-64h's shapes (64 heads of head_dim
            8, the m16n8k8 instantiations): flash over serve's chunk (Sq 32
            at q_offset 224 in 256 keys), the first chunk and a 160-token
            prompt, paged decode and verify (Q 5 and 8) over float and int8
            pools (B 8, a graph replayed after the lengths change), the
            contiguous decode over float and int8 lanes at S 256; then
            seamless-m4t-large-v2's shapes (16 heads of 64): flash without
            the causal mask over 4096 keys (Sq 32 and 100) and the
            encoder's causal flash over 4096 frames, paged decode through a
            256-page cross block table over float and int8 pools, the
            contiguous decode at S 4096, matmul at M 4096, 32 and 8 for the
            projections and the plain FFN and the tied 256,206-row head;
            then the expert matmul at deepseek-moe-16b's shapes (64
            experts, E 2048 and F 1408 both ways round, capacities 8 and
            16) and mixtral-8x22b's (8 experts, E 6144 and F 16384), with
            a decode tick's routing, empty, partly filled and full
            buckets, NaN in every row past a count (never read: finite
            output, zeros past the counts), float32 and bf16, beside the
            shared experts' products and the routers' float32 products
            (K split over a cluster), the expert cases' bound counting
            the non-empty experts' weights and the library time
            ``torch.bmm`` over every expert;
            median
            times (CUDA graphs of back-to-back calls, CUDA events) of the
            kernel, the plain version and the one PyTorch call that
            computes the same function where there is one (SDPA, with
            enable_gqa=True for GQA, is_causal=True for a whole prompt and
            a mask for the offset chunk, checked against the plain version;
            a yardstick only; the port never calls it).
3. parity   full-width tinyllama-42m in float32, engines on the card
            (kernels; steps in CUDA graphs, the pipelined tick) against
            engines on the CPU (plain versions), and every card engine's
            greedy tokens against the same engine with graphs=False,
            overlap=False (eager steps, the serial loop): the
            one-token engine, the speculative engine (k=4), the int8-pool
            engine and the speculative int8-pool engine each give identical
            greedy tokens and the live logits of every step within
            tolerance, leak-free after drain(); each speculative engine's
            tokens equal its one-token engine's on the card, with drafts
            accepted; the int8 pools' logit drift against float pools is
            printed.  parity-qwen3: full-width, full-depth qwen3-0.6b in
            float32 (GQA, qk-norm with random scales), card against
            CPU: float pools (also
            against the eager-serial engine), int8 pools with
            speculative=4 and the contiguous engine, identical greedy
            tokens and live logits within the tinyllama tolerances.
            parity-gemma3: gemma3-12b with its features and kernel shapes
            (16 q over 8 kv heads x 256, qk-norm, sandwich norms, the scaled
            embedding, gelu, 5 window layers to 1 global) cut to d_model
            1024, d_ff 4096, vocab 32000, 6 layers and a window of 64, in
            float32, card against CPU: float pools, int8 pools with
            speculative=4 and the contiguous engine at budget 256 (rings
            of 64), 80-200 prompt tokens, identical greedy tokens.
            parity-hymba: hymba-1.5b cut to 5 layers (full attention at
            0, 2 and 4) and a window of 64, every width as published
            (d_model 1600, 25/5 heads x 64 stored as 25 kv slots, 50 SSD
            heads of state 16, d_ff 5504, vocab 32001), float32, card
            against CPU: float pools and slabs (logits within 1e-4), int8
            pools and slabs, the contiguous engine at budget 256 (logits
            within 1e-4, tokens equal to the paged engine's), and int8
            pools and slabs with preempt(b) forced (KV pages and the slab
            stashed and restored), identical greedy tokens.
            parity-mistral: mistral-large-123b cut to 3 layers, d_model
            768, 12 q heads over 1 kv head of 64 (its group of 12), d_ff
            2048, its vocab of 32768 and untied head kept, float32: float
            pools (also against the eager-serial engine) and the contiguous
            engine, card against CPU, logits within 1e-4, identical greedy
            tokens; a speculative engine on the card refused at
            construction (R 12 x Q 2 > 16).  parity-sample: tinyllama-42m at
            full width cut to 4 layers, float32, sampled (temperature 0.7,
            top_k 40; temperature 1.0, top_p 0.9): the paged engine with
            speculation k = 3 (also against the one-token engine), under
            priority preemption with preempt(b) forced (also against FCFS),
            and the contiguous engine (also against the paged one), card
            against CPU: identical sampled tokens.  parity-64h:
            tinyllama-42m-64h at full width and depth (64 heads of 8),
            float32, weights x10: the paged engine (also against the
            eager-serial engine) and the contiguous engine (also against the
            paged one), card against CPU, live logits within the tinyllama
            tolerance, identical greedy tokens.  parity-seamless:
            seamless-m4t-large-v2 cut to 3 decoder and 2 encoder layers,
            d_model 512, 8 heads of 64, d_ff 2048, vocab 32000 and 512
            frames, float32, weights x5 (int8 x2) but the layernorms': the
            paged engine over float pools (also against the eager-serial
            engine) and int8 pools (2 encodes, 2 cross hits), the
            contiguous engine over float32 lanes (tokens also equal to the
            paged engine's) and int8 lanes (JAX's bare cast), 4 requests
            over 2 frame tensors, card against CPU, identical greedy
            tokens, live logits within the tinyllama or int8 tolerance.
            parity-deepseek: deepseek-moe-16b cut to 1 dense and 2 MoE
            layers at d_model 256 and experts of 128, its 64 experts,
            top-6, 2 shared experts, 16 heads of 128 and vocab kept,
            float32, weights x10: paged (also eager-serial) and
            contiguous engines, card against CPU, identical greedy
            tokens, live logits within the tinyllama tolerance, the same
            pairs dropped by capacity, and the smallest gap between the
            k-th and (k+1)-th routing probability printed.
            parity-ssm: full-width mamba2-370m in float32, card
            against CPU, from float32 and from int8 state slabs: identical
            greedy tokens (more than one distinct), live logits within
            tolerance, slabs leak-free after drain().  parity-contig: the
            contiguous engine on tinyllama-42m, float32 lanes (tokens also
            equal to the paged engine's on the card) and fixed-scale int8
            lanes; parity-contig-ssm: the contiguous engine on mamba2-370m
            (tokens also equal to the paged engine's on the card).
            parity-prefix: the prefix cache, tinyllama requests behind a
            shared 40-token prefix (mid-page hits: copy-on-write), float
            pools one-token and int8 pools with speculative=4 (drafts also
            along the cache's token paths): card against CPU, cache on
            against off, graphs and overlap on against off, identical
            greedy tokens, COW copies and skipped prefill tokens, leak-free
            after drain() and a full evict.  parity-preempt: tinyllama
            under PriorityScheduler(preemption=True), every 3rd request
            urgent and arriving while others run (pages donated to the
            prefix cache), overlap on and off, tokens identical to FCFS
            without preemption; mamba2-370m from float32 and int8 slabs
            with preempt(b) forced mid-prefill and mid-decode (slabs
            stashed on the host and restored), tokens identical to the
            uninterrupted run.  parity-dp and parity-disagg: tinyllama over
            2 replicas of 2 slots (or 1 prefill and 1 decode replica),
            FCFS with the prefix cache, float x10 and int8 x1.75 pools, 8
            requests behind two 40-token prefixes: card against CPU and
            eager-serial, per-replica counters and handoffs equal.
            parity-elastic: the same model and pools, 10 requests, under
            ``ELASTIC_PARITY_EVENTS`` (2 -> 3 replicas, replica 1 killed,
            -> 1 with a slot's pages migrated, -> 2): identical greedy
            tokens card against CPU and eager-serial, live logits within
            tolerance, the same changes, membership counters, each
            request's replica and the kill's RecoveryReport, leak-free.
            parity-spill: the same model and pools, parity-elastic's 10
            requests at dp 2 with a HostSpillStore attached, then
            scale_to(1): the drain spills replica 1's radix entries and
            the restore writes them into replica 0, pages and scale rows
            torch.equal to the pre-drain pages on the card (again after
            one more tick); a fresh dp-2 engine warm-started from the
            store re-serves the prompts: tokens equal to the cold run's
            and the CPU path's, prefix hits > 0, the store and counters
            equal on the CPU.  And seamless-m4t-large-v2 at full width cut
            to ``SPILL_SM_DEPTH`` (bfloat16 drawn on the card, 4096
            frames): an encode spilled and restored into a fresh engine,
            cross pages torch.equal, the same frames then hit
            (cross_encodes 0) with the cold run's tokens.  Spill and
            restore ms, bytes and GB/s printed.
4. serve    bfloat16 weights, 8 slots, 16 requests, in seventeen phases:
            full-width tinyllama-42m in serve (bfloat16 pools, random
            prompts), serve-spec (k=4, repetitive prompts), serve-int8
            (int8 pools, random prompts) and serve-spec-int8, full-width
            mamba2-370m cut to 12 of its 48 layers (``SERVE_DEPTH``) in
            serve-ssm (float32 state slabs) and serve-ssm-int8 (int8
            slabs), and tinyllama-42m on the
            contiguous engine in serve-contig (bfloat16 lanes) and
            serve-contig-int8 (fixed-scale int8 lanes), and serve-prefix
            (tinyllama, bfloat16 pools, the prefix cache: a shared
            100-token prefix and 16-64 tokens of each request's own;
            tokens identical with the cache off in this call, hit rate,
            skipped prefill tokens, COW copies and the copy graph's nodes
            printed, and its tok/s, busy share and prefill chunks beside
            serve's), and serve-qwen3 (full-width qwen3-0.6b, 28 layers,
            bfloat16 pools, random prompts; no eager-serial run), and
            serve-gemma3 (full-width gemma3-12b at 24 of its 48 layers
            (``SERVE_DEPTH``), weights drawn on the card, bfloat16 pools, a
            2048-token budget,
            chunks of 128, prompts of 512-1536 tokens and the count of
            decode rows whose window is shorter than their prefix), and
            serve-hymba (full-width hymba-1.5b at 16 of its 32 hybrid
            layers (``SERVE_DEPTH``), the same long mix, bfloat16 pools and float32 slabs;
            flash attention and the SSD scan in every layer of every
            chunk, the paged decode kernel in every layer of every decode
            tick), and serve-mistral (full-width mistral-large-123b at 20
            of its 88 layers (``SERVE_DEPTH``: 57.0 GB of bf16 weights),
            drawn on the card, bfloat16 pools, random prompts, flash and
            paged decode at group 12, the untied head; its widths, head
            layout, weight bytes, tok/s, ticks and busy share printed on
            a ``mistral[...]`` line with the card), and serve-sample
            (serve's model and mix, sampled at temperature 0.7, top_k 40:
            served again eager-serial with identical tokens, and its
            tok/s, wall per tick and ticks beside serve's on a
            ``sample[...]`` line), and serve-64h (full-width, full-depth
            tinyllama-42m-64h, serve's mix: 64 heads of head_dim 8 in flash
            and paged decode, beside serve on a ``64h[...]`` line), and
            serve-seamless (full-width, full-depth seamless-m4t-large-v2,
            24 encoder and 24 decoder layers, weights drawn on the card,
            bfloat16 pools and cross pools, serve's mix over 4 frame
            tensors of 4096 frames: 4 encodes, 12 cross hits; flash twice
            per layer in every chunk, paged decode twice per layer in every
            decode tick, the encoder's flash and products in each encode's
            graph, 10L + 1 counted kernels a tick (layernorm is plain
            PyTorch: no norm kernel); a ``seamless[...]`` line with the
            encodes, the hit rate, one encode's time, TTFT and TPOT, the
            busy share, device time and matmul share), and serve-deepseek
            (full-width, full-depth deepseek-moe-16b, 32.75 GB of bf16
            weights drawn on the card, serve's mix: the expert matmul 3
            times per MoE layer in every step, 390 counted kernels a
            step; the pairs dropped by capacity over its chunks and ticks
            printed, and a ``deepseek[...]`` line with the matmul's and
            the expert matmul's shares of device time).  Every
            request
            completes, pools and slabs are leak-free after drain(), and
            each kernel launched in the steps it belongs to (launch counts
            set to 0 just before each phase and read just after; the SSD
            scan once per layer in every prefill chunk, never in a decode
            tick; the
            contiguous decode kernel (its int8 variant in
            serve-contig-int8) once per layer in every contiguous
            decode tick and in no paged phase, flash attention once per
            layer in every whole-prompt prefill, no paged kernel in a
            contiguous phase; the norm family once per norm of the model
            in every step: one plain norm (and qwen3's q and k norms in every
            layer), the rest with the residual add fused in, mamba2's and
            hymba's gated norm in every layer, gemma3's post-sublayer
            norms; 10L + 2 counted kernels per tinyllama decode tick, 12L +
            2 per qwen3 tick, 14L + 2 per gemma3 tick, 8L + 2 per mamba2
            tick, 17L + 2 per hymba tick).
            Launches are counted where a wrapper launches its kernel and at
            every replay of a step's graph (the kernels its capture
            recorded).  Each step graph is read node by node
            (cuGraphGetNodes, kernel names by cuFuncGetName): the port's
            kernels in it equal the step's counted launches, and the rest
            are PyTorch's (the greedy argmax among them); memcpy and memset
            nodes and the graph's memory are printed.  Every paged phase is
            served once more with every plan and dispatch under
            set_sync_debug_mode("error") (collect outside it).  serve,
            serve-ssm and serve-contig are served again with graphs=False,
            overlap=False (identical greedy tokens), and tok/s, wall per
            tick and busy share of the two are printed side by side (ab[]).
            Prints tok/s, TTFT, TPOT, acceptance and launches per step.
            serve-dp and serve-disagg serve 32 requests over 2 replicas of
            8 slots (or 1:1), with a ``dp[...]`` line beside serve; then
            serve-elastic: serve-dp's engine and mix under
            ``SERVE_ELASTIC_EVENTS`` (2 -> 1 -> 2 -> 1 replicas, the last
            by killing replica 0), each change's wall time split into the
            barrier, the drain, the pools' re-scatter and the graphs'
            capture, the decode and chunk graphs' kernel nodes after each
            change equal to serve-dp's (R = 2) or serve's (R = 1), and the
            memory reserved over the cycle grown by no more than one step
            set's graph pools; tok/s beside serve and serve-dp.
5. profile  each serve phase's workload again under torch.profiler:
            device time by kernel, the host-blocking CUDA runtime calls,
            the device's busy share of the phase, and the calls, device
            time per call and share of matmul, the expert matmul, flash
            attention, the SSD
            scan, paged and contiguous decode attention and the norm family
            (never more kernels in the trace than
            launches; the kernel phase checks one kernel per call exactly,
            in CUDA graphs; the kernels of a graph replay are traced one
            by one); for the eager-serial runs of serve, serve-ssm and
            serve-contig too.
6. sim      the port's copy of the paper's analytical multi-MCU model
            (``repro_torch.sim``) in this process, where no JAX is
            imported: one ``sim:`` line with the calibrated model's
            headline metrics (the JAX sim's numbers).
7. offload  host-offload streaming (``repro_torch.runtime.offload``):
            pinned host groups copied on a side CUDA stream into two
            staging buffers, one group ahead of the compute; the toy of
            ``examples/offload_streaming.py`` (8 float32 groups) and one
            mistral-large-123b layer's FFN weights as 4 groups of 2.11 GB of
            bf16 at M 8, each equal to the all-resident run bitwise, CUDA
            events showing every copy overlap the previous group's compute;
            the host-to-device rate measured on the card, compute per
            group, streamed and resident wall and ``required_bandwidth``
            against the link (the paper's §V-C arithmetic).

Then one JSON line with every kernel's numbers, the nvidia-smi line, and
last ``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
before the last line.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (NVIDIA data sheet, dense): the least time the
# card could take is max(bytes / HBM rate, operations / peak rate).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12,   # bf16 tensor, fp32 CUDA-core
            "int8": 1979e12}                         # int8 tensor
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),       # tests/test_kernels.py:16-18
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
PARITY_TOL = dict(rtol=1e-3, atol=1e-3)   # float32 logits after 8 layers, x10 weights
# int8 pools (weights x1.75, |logit| up to about 4): a K/V value on a rounding
# boundary may quantize one step apart on the card and on the CPU.  H100 runs
# read 5.6e-3; atol is about 4x that, well under the 0.07 that int8 pools
# themselves move these logits from float pools
INT8_PARITY_TOL = dict(rtol=1e-3, atol=2e-2)
# the SSD scan (tests/test_kernels.py: chunked and sequential forms sum in
# other orders): float32 1e-3, and bf16 outputs at the bf16 tolerance
SSD_TOL = {"float32": dict(rtol=1e-3, atol=1e-3),
           "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# full-width mamba2-370m in float32, card against CPU, 48 layers, |logit| up
# to about 3.2: the first H100 run read 3.6e-5 from float32 slabs and 1.7e-4
# from int8 slabs (a state value on a rounding boundary may quantize one
# step apart); atol is about 5x each reading (PERF.md)
SSM_PARITY_TOL = dict(rtol=1e-4, atol=2e-4)
SSM_INT8_PARITY_TOL = dict(rtol=1e-4, atol=1e-3)
# contiguous int8 lanes (weights x1.75, |logit| up to about 4) store K/V at
# the fixed scale 16: a value on a rounding boundary of x * 16 may quantize
# one step (1/16) apart on the card and on the CPU.  The first H100 run read
# 3.9e-3; atol is about 5x that
CONTIG_INT8_PARITY_TOL = dict(rtol=1e-3, atol=2e-2)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def bound(nbytes, nops, dtype):
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = nops / PEAK_OPS[dtype_name(dtype)]
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


# --------------------------------------------------------------------- timing
def time_ms(fn, torch, reps=10, iters=20):
    """Median device time of one ``fn()`` call: ``reps`` back-to-back calls
    captured in a CUDA graph (no host launch cost in the number), replayed
    ``iters`` times between CUDA events, five samples."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / (iters * reps))
    return statistics.median(samples)


def time_plain(fn, torch):
    """``time_ms`` with 2 calls a graph and 5 replays a sample: for the plain
    versions at gemma3's and hymba's shapes (up to 5 ms a call), timed
    beside their kernels, not in the way of the run."""
    return time_ms(fn, torch, reps=2, iters=5)


def read_graph(graph, names=False):
    """The nodes of a kept ``torch.cuda.CUDAGraph``, read through libcuda's
    cuGraphGetNodes: (type, kernel name) per node (type 0 a kernel, 1 a
    memcpy, 2 a memset; the name, with ``names``, of a kernel node's
    function through cuGraphKernelNodeGetParams and cuFuncGetName, else
    None): how many kernels a call launches, and which, exactly, where a
    profiler trace may drop records."""
    import ctypes

    class KernelParams(ctypes.Structure):     # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                    ("block", ctypes.c_uint * 3), ("smem", ctypes.c_uint),
                    ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                    ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]

    cu = ctypes.CDLL("libcuda.so.1")
    g, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(g, None, ctypes.byref(n)) == 0,
          "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)) == 0,
          "cuGraphGetNodes failed")
    out = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0,
              "cuGraphNodeGetType failed")
        name = None
        if names and kind.value == 0:
            kp, s = KernelParams(), ctypes.c_char_p()
            check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                                   ctypes.byref(kp)) == 0,
                  "cuGraphKernelNodeGetParams failed")
            rc = (cu.cuFuncGetName(ctypes.byref(s), ctypes.c_void_p(kp.func))
                  if kp.func else
                  cu.cuKernelGetName(ctypes.byref(s), ctypes.c_void_p(kp.kern)))
            check(rc == 0 and s.value, f"no name for a kernel node (CUresult {rc})")
            name = s.value.decode()
        out.append((kind.value, name))
    return out


def graph_nodes(torch, fn):
    """The node types of a CUDA graph captured around one ``fn()`` call
    (``read_graph``)."""
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    return [kind for kind, _ in read_graph(g)]


def compare(name, got, want, dtype, torch, tol=None):
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    err = (got - want).abs()
    tol = tol or TOL[dtype_name(dtype)]
    ok = bool((err <= tol["atol"] + tol["rtol"] * want.abs()).all())
    check(ok, f"{name}: max |kernel - plain| = {err.max().item():.3e} beyond "
              f"rtol={tol['rtol']} atol={tol['atol']}")
    return err.max().item()


# -------------------------------------------------------------------- phases
def phase_env(torch, build):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    build.build_all()
    cuda_s = time.perf_counter() - t0
    from repro_torch.kernels import ops
    x, sc = torch.randn(4, 512, device="cuda"), torch.zeros(512, device="cuda")
    t0 = time.perf_counter()
    ops.rmsnorm(x, sc)                   # compiles the Triton kernel's variants
    ops.rmsnorm_residual(x, x, sc)
    ops.rmsnorm_gated(x, x, sc)
    torch.cuda.synchronize()
    triton_s = time.perf_counter() - t0
    print(f"env: card='{smi_line}' torch={torch.__version__} "
          f"cuda={torch.version.cuda} device={torch.cuda.get_device_name(0)} "
          f"count={torch.cuda.device_count()} build_cuda_s={cuda_s:.1f} "
          f"build_triton_s={triton_s:.1f}")
    for stem, log in sorted(build.BUILD_LOG.items()):
        for name, regs, spills in ptxas_usage(log):
            print(f"  ptxas[{stem}] {name}: {regs} registers, {spills}")
    return smi_line


def ptxas_usage(log):
    """-> (kernel instantiation, registers, spill line) for each function in
    nvcc's ``-Xptxas -v`` output, names demangled by the toolkit's cu++filt
    (template arguments kept, the parameter list dropped)."""
    import re
    from torch.utils.cpp_extension import CUDA_HOME
    found, name, spills = [], None, ""
    for line in log.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for")[-1].strip()
        elif "spill" in line:
            spills = line.strip()
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            found.append([name, int(m.group(1)), spills])
            name = None
    filt = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "cu++filt"
    if found and filt.exists():
        out = subprocess.run([str(filt)], input="\n".join(f[0] for f in found),
                             capture_output=True, text=True, timeout=60)
        for f, line in zip(found, out.stdout.splitlines()):
            line = line.removeprefix("void ").replace("<unnamed>::", "")
            f[0] = line[:line.index(">(") + 1] if ">(" in line else line.split("(")[0]
    return found


# Every matmul of the three models' main paths: (name, K, N, trans_b).
MATMULS = (("tinyllama wq/wk/wv/wo", 512, 512, False),
           ("tinyllama w_gate/w_up", 512, 2048, False),
           ("tinyllama w_down", 2048, 512, False),
           ("tinyllama LM head", 512, 32000, True),
           ("mamba2 in_z/in_x", 1024, 2048, False),
           ("mamba2 in_dt", 1024, 32, False),
           ("mamba2 in_B/in_C", 1024, 128, False),
           ("mamba2 out", 2048, 1024, False),
           ("mamba2 LM head", 1024, 50280, True),
           ("qwen3 wq", 1024, 2048, False),
           ("qwen3 wk/wv", 1024, 1024, False),
           ("qwen3 wo", 2048, 1024, False),
           ("qwen3 w_gate/w_up", 1024, 3072, False),
           ("qwen3 w_down", 3072, 1024, False),
           ("qwen3 LM head", 1024, 151936, True))
MATMULS_RAGGED = (("ragged K", 1004, 520, False), ("ragged K", 1004, 300, True),
                  ("ragged N", 512, 50, False))


def phase_kernels(torch, F):
    from repro_torch.kernels import decode_attention as _dec
    from repro_torch.kernels import flash_attention as _fl
    from repro_torch.kernels import matmul as _mm
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    rows = {}
    worst = {}

    def note(kname, case, err):
        print(f"  {kname} {case}: max_abs_err={err:.3e}")
        worst[kname] = max(worst.get(kname, 0.0), err)

    n_graphs = 0

    def one_kernel(kname, case, call):
        """``call()``, captured in a CUDA graph, is one kernel node and
        nothing else: one launch per call, no second kernel, no memset."""
        nonlocal n_graphs
        kinds = graph_nodes(torch, call)
        check(kinds == [0], f"{kname} {case}: one call is graph nodes {kinds}, "
                            f"not one kernel node")
        n_graphs += 1

    # ---- rmsnorm: T = 8 decode rows / 32 chunk rows at E = 512; qwen3's
    # qk-norm, rows of head_dim 128 (8 slots x 16 heads a decode tick, a
    # 32-token chunk's 512) and its plain first-layer norm at E = 1024; each
    # call one kernel node in a CUDA graph
    for dt in (torch.float32, torch.bfloat16):
        for T, E in ((8, 512), (32, 512), (33, 512), (128, 128), (512, 128),
                     (8, 1024)):
            x, s = randn(T, E, dtype=dt), 0.1 * randn(E, dtype=dt)
            case = f"T={T} E={E} {dtype_name(dt)}"
            note("rmsnorm", case,
                 compare("rmsnorm", ops.rmsnorm(x, s), ref.ref_rmsnorm(x, s),
                         dt, torch))
            one_kernel("rmsnorm", case, lambda: ops.rmsnorm(x, s))

    # ---- rmsnorm_residual: the residual add fused into the norm, at the
    # rows a step hands over (8 decode, 32 chunk, 160 a whole prompt) and
    # both models' widths: the sum bitwise x + r, the norm bitwise
    # ops.rmsnorm(x + r) (so the fused model's logits are the unfused
    # ones), and within tolerance of the plain version
    for dt in (torch.float32, torch.bfloat16):
        for T in (8, 32, 160):
            for E in (512, 1024):
                x, r = randn(T, E, dtype=dt), randn(T, E, dtype=dt)
                s = 0.1 * randn(E, dtype=dt)
                case = f"T={T} E={E} {dtype_name(dt)}"
                xs, y = ops.rmsnorm_residual(x, r, s)
                check(torch.equal(xs, x + r),
                      f"rmsnorm_residual {case}: the sum is not bitwise x + r")
                check(torch.equal(y, ops.rmsnorm(x + r, s)),
                      f"rmsnorm_residual {case}: the norm is not bitwise "
                      f"ops.rmsnorm(x + r)")
                note("rmsnorm_residual", case, compare(
                    "rmsnorm_residual", y, ref.ref_rmsnorm_residual(x, r, s)[1],
                    dt, torch))
                one_kernel("rmsnorm_residual", case,
                           lambda: ops.rmsnorm_residual(x, r, s))

    # ---- rmsnorm_gated: mamba2's gated norm over d_inner = 2048, at 8
    # decode rows and 32 chunk rows, y and z each float32 or bf16, written
    # in float32 or bf16
    for ydt in (torch.float32, torch.bfloat16):
        for zdt in (torch.float32, torch.bfloat16):
            for odt in (torch.float32, torch.bfloat16):
                for T in (8, 32):
                    y, z = randn(T, 2048, dtype=ydt), 2.0 * randn(T, 2048, dtype=zdt)
                    s = 0.1 * randn(2048, dtype=torch.bfloat16)
                    case = (f"T={T} n=2048 y {dtype_name(ydt)} z {dtype_name(zdt)} "
                            f"out {dtype_name(odt)}")
                    got = ops.rmsnorm_gated(y, z, s, out_dtype=odt)
                    check(got.dtype == odt, f"rmsnorm_gated {case}: dtype {got.dtype}")
                    note("rmsnorm_gated", case, compare(
                        "rmsnorm_gated", got,
                        ref.ref_rmsnorm_gated(y, z, s, out_dtype=odt), odt, torch))
                    one_kernel("rmsnorm_gated", case,
                               lambda: ops.rmsnorm_gated(y, z, s, out_dtype=odt))
    print(f"  rmsnorm family: each of {n_graphs} cases is one kernel node in a "
          f"CUDA graph")
    x, s = randn(8, 512, dtype=torch.bfloat16), 0.1 * randn(512, dtype=torch.bfloat16)
    w1 = (1.0 + s.float()).to(torch.bfloat16)
    err = compare("rmsnorm", ops.rmsnorm(x, s), ref.ref_rmsnorm(x, s),
                  torch.bfloat16, torch)
    b_ms, b_by = bound(2 * (x.numel() * 2) + s.numel() * 2, 5 * x.numel(),
                       torch.float32)                # the math is float32
    rows["rmsnorm"] = dict(
        shape="x (8, 512) bf16", max_abs_err=err,
        ms=time_ms(lambda: ops.rmsnorm(x, s), torch),
        plain_ms=time_ms(lambda: ref.ref_rmsnorm(x, s), torch),
        library_ms=(time_ms(lambda: F.rms_norm(x, (512,), w1, 1e-6), torch)
                    if hasattr(F, "rms_norm") else None),
        bound_ms=b_ms, bound_by=b_by)
    # qwen3's shapes: qk-norm rows of head_dim 128 (a decode tick's 8 slots
    # x 16 heads, a 32-token chunk's 512) and its E = 1024 norm
    rows["rmsnorm"]["by_shape"] = [dict(rows["rmsnorm"])]
    for T, E in ((128, 128), (512, 128), (8, 1024)):
        xq = randn(T, E, dtype=torch.bfloat16)
        sq = 0.1 * randn(E, dtype=torch.bfloat16)
        wq = (1.0 + sq.float()).to(torch.bfloat16)
        b_ms, b_by = bound(2 * (xq.numel() * 2) + sq.numel() * 2,
                           5 * xq.numel(), torch.float32)
        r = dict(shape=f"x ({T}, {E}) bf16",
                 max_abs_err=compare("rmsnorm", ops.rmsnorm(xq, sq),
                                     ref.ref_rmsnorm(xq, sq), torch.bfloat16,
                                     torch),
                 ms=time_ms(lambda: ops.rmsnorm(xq, sq), torch),
                 plain_ms=time_ms(lambda: ref.ref_rmsnorm(xq, sq), torch),
                 library_ms=(time_ms(lambda: F.rms_norm(xq, (E,), wq, 1e-6),
                                     torch)
                             if hasattr(F, "rms_norm") else None),
                 bound_ms=b_ms, bound_by=b_by)
        rows["rmsnorm"]["by_shape"].append(r)
        lib = "none" if r["library_ms"] is None else f"{1e3 * r['library_ms']:.2f}"
        print(f"  rmsnorm time {r['shape']}: us={1e3 * r['ms']:.2f} "
              f"bound_us={1e3 * r['bound_ms']:.3f} "
              f"plain_us={1e3 * r['plain_ms']:.2f} library_us={lib}")
    # the fused variants at the serve shapes: the residual norm over
    # tinyllama's (8, 512) bf16 rows (x and r read, s and y written); the
    # gated norm over mamba2's (8, 2048) decode rows in serve's dtypes (y in
    # x's dtype, bf16; z bf16; out bf16).  No single PyTorch call computes
    # either.
    r = randn(8, 512, dtype=torch.bfloat16)
    err = compare("rmsnorm_residual", ops.rmsnorm_residual(x, r, s)[1],
                  ref.ref_rmsnorm_residual(x, r, s)[1], torch.bfloat16, torch)
    b_ms, b_by = bound(4 * x.numel() * 2 + s.numel() * 2, 6 * x.numel(),
                       torch.float32)
    rows["rmsnorm_residual"] = dict(
        shape="x, r (8, 512) bf16", max_abs_err=err,
        ms=time_ms(lambda: ops.rmsnorm_residual(x, r, s), torch),
        plain_ms=time_ms(lambda: ref.ref_rmsnorm_residual(x, r, s), torch),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)
    y, z = randn(8, 2048, dtype=torch.bfloat16), 2.0 * randn(8, 2048, dtype=torch.bfloat16)
    sg = 0.1 * randn(2048, dtype=torch.bfloat16)
    bf = torch.bfloat16
    err = compare("rmsnorm_gated", ops.rmsnorm_gated(y, z, sg, out_dtype=bf),
                  ref.ref_rmsnorm_gated(y, z, sg, out_dtype=bf), bf, torch)
    b_ms, b_by = bound(3 * y.numel() * 2 + sg.numel() * 2, 10 * y.numel(),
                       torch.float32)
    rows["rmsnorm_gated"] = dict(
        shape="y, z (8, 2048) bf16 -> bf16", max_abs_err=err,
        ms=time_ms(lambda: ops.rmsnorm_gated(y, z, sg, out_dtype=bf), torch),
        plain_ms=time_ms(lambda: ref.ref_rmsnorm_gated(y, z, sg, out_dtype=bf),
                         torch),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)

    # ---- matmul: every main-path product of the three models at the rows a step
    # hands over (8 decode, 32 paged chunk, 33 ragged, 40 k=4 verify, 160 a
    # whole prompt), plus K or N off a multiple of 8 (chunks gathered element
    # by element); weights at the models' init scale (0.02), as the main
    # paths feed them.  Every bf16 case runs twice: bitwise-equal outputs.
    # Every case is one kernel node in a CUDA graph (no second reduction
    # kernel, no memset).
    n_graphs = 0
    for dt in (torch.float32, torch.bfloat16):
        for tag, K, N, nt in MATMULS + MATMULS_RAGGED:
            b = (0.02 * randn(N, K) if nt else 0.02 * randn(K, N)).to(dt)
            for M in (8, 32, 33, 40, 160):
                a = randn(M, K, dtype=dt)         # activations ~ N(0, 1)
                got = ops.matmul(a, b, trans_b=nt)
                case = f"{tag} M={M} K={K} N={N}{' NT' if nt else ''} {dtype_name(dt)}"
                note("matmul", case, compare("matmul", got, ref.ref_matmul(a, b, nt),
                                             dt, torch))
                if dt == torch.bfloat16:
                    check(torch.equal(got, ops.matmul(a, b, trans_b=nt)),
                          f"matmul {case}: two calls differ")
                one_kernel("matmul", case, lambda: ops.matmul(a, b, trans_b=nt))
            del b
    print(f"  matmul: each of {n_graphs} cases is one kernel node in a CUDA graph")
    # times (L2-warm: the same weight every call) at M = 8 for every shape,
    # and at 32 and 160 for tinyllama's; the row of the JSON line is
    # tinyllama's LM head at M = 8, as before
    by_shape = []
    for tag, K, N, nt in MATMULS:
        b = (0.02 * (randn(N, K) if nt else randn(K, N))).to(torch.bfloat16)
        for M in ((8, 32, 160) if tag.startswith("tinyllama") else (8,)):
            a = randn(M, K, dtype=torch.bfloat16)
            err = compare("matmul", ops.matmul(a, b, trans_b=nt),
                          ref.ref_matmul(a, b, nt), torch.bfloat16, torch)
            b_ms, b_by = bound((M * K + K * N + M * N) * 2, 2 * M * N * K,
                               torch.bfloat16)
            p = _mm.plan(M, N, K, torch.bfloat16, nt)
            r = dict(shape=f"{tag} a ({M}, {K}) @ {'(%d, %d)^T' % (N, K) if nt else '(%d, %d)' % (K, N)} bf16",
                     M=M, K=K, N=N, trans_b=nt, max_abs_err=err,
                     plan=f"bn={p.bn} split={p.split} kt={p.kt} bm={p.bm} "
                          f"blocks={p.blocks}",
                     ms=time_ms(lambda: ops.matmul(a, b, trans_b=nt), torch),
                     plain_ms=time_ms(lambda: ref.ref_matmul(a, b, nt), torch),
                     library_ms=time_ms(lambda: torch.matmul(a, b.t() if nt else b),
                                        torch),
                     bound_ms=b_ms, bound_by=b_by)
            print(f"  matmul time {r['shape']}: us={1e3 * r['ms']:.2f} "
                  f"bound_us={1e3 * b_ms:.2f} plain_us={1e3 * r['plain_ms']:.2f} "
                  f"torch_matmul_us={1e3 * r['library_ms']:.2f} [{r['plan']}]")
            by_shape.append(r)
        del b
    for r in by_shape:
        if r["M"] == 8 and "LM head" in r["shape"]:
            print(f"  matmul {r['shape']}: kernel / torch.matmul = "
                  f"{r['ms'] / r['library_ms']:.3f}")
    head = next(r for r in by_shape
                if r["shape"].startswith("tinyllama LM head") and r["M"] == 8)
    rows["matmul"] = dict(head, by_shape=by_shape)

    # ---- flash attention: the paged prefill chunk (H 8, Sq 32 over the
    # 256-key gathered stream, D 64) at q_offset 0 (every cluster rank past
    # the causal diagonal has no key), 96, 224 and the Pallas default, with
    # a 64- and a 32-key window at 224 (the latter empties the low ranks);
    # at 37, 213 and 230, no multiple of 16, where a chunk resumes after a
    # prefix hit (at 230 its last 6 rows lie past Skv: the padding such a
    # chunk carries past the sequence budget);
    # the contiguous prefill's square prompts Sq = Skv in {23, 130, 160} (no
    # multiple of the 64-key tile); head dims 32 and 128 at the chunk shape
    # and at Sq = Skv = 130.  Every bf16 case runs twice (bitwise-equal
    # outputs); every case, captured in a CUDA graph, is one kernel node.
    H = 8
    n_graphs = 0

    def flash_case(dt, Sq, Skv, D, q_off, win):
        q, k, v = (randn(H, Sq, D, dtype=dt), randn(H, Skv, D, dtype=dt),
                   randn(H, Skv, D, dtype=dt))

        def call():
            return ops.flash_attention(q, k, v, window=win, q_offset=q_off)

        case = (f"Sq={Sq} Skv={Skv} D={D} q_offset={q_off} window={win} "
                f"{dtype_name(dt)}")
        got = call()
        note("flash_attention", case, compare(
            "flash_attention", got, ref.ref_flash_attention(
                q, k, v, window=win, q_offset=q_off), dt, torch))
        if dt == torch.bfloat16:
            check(torch.equal(got, call()), f"flash_attention {case}: two "
                                            f"calls differ")
        one_kernel("flash_attention", case, call)

    for dt in (torch.float32, torch.bfloat16):
        for q_off, win in ((0, 0), (96, 0), (224, 0), (None, 0), (224, 64),
                           (224, 32), (37, 0), (213, 0), (230, 0)):
            flash_case(dt, 32, 256, 64, q_off, win)
        for S in (23, 130, 160):
            flash_case(dt, S, S, 64, 0, 0)
        for D in (32, 128):
            for q_off, win in ((0, 0), (224, 0), (224, 32)):
                flash_case(dt, 32, 256, D, q_off, win)
            flash_case(dt, 130, 130, D, 0, 0)
    print(f"  flash_attention: each of {n_graphs} cases is one kernel node in "
          f"a CUDA graph")
    # the prefill chunk's offset is device data (one int32 the kernel reads
    # there): a graph of one call, replayed after the offset changed in
    # place, equals the eager call at the new offset, float32 and bf16
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (randn(H, 32, 64, dtype=dt), randn(H, 256, 64, dtype=dt),
                   randn(H, 256, 64, dtype=dt))
        off = torch.tensor([224], dtype=torch.int32, device="cuda")
        one_kernel("flash_attention", f"device q_offset {dtype_name(dt)}",
                   lambda: ops.flash_attention(q, k, v, q_offset=off))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = ops.flash_attention(q, k, v, q_offset=off)
        for new in (0, 96, 224, 37):
            off.fill_(new)
            graph.replay()
            eager = ops.flash_attention(q, k, v, q_offset=new)
            torch.cuda.synchronize()
            check(torch.equal(out, eager), f"flash_attention {dtype_name(dt)}: the "
                  f"graph replayed at q_offset {new} differs from the eager call")
    print("  flash_attention: a CUDA graph replayed after its device q_offset "
          "changed in place equals the eager call (float32 and bf16)")
    # times (bf16, L2-warm) at the chunk shape at q_offset 0, 96 and 224,
    # the whole prompt Sq = Skv = 160, and the prefix-hit offsets 37, 213
    # and 230; the row of the JSON line is the chunk at q_offset 224, as
    # before
    # (the offset as the chunk step hands it over: an int32 on the card)
    D = 64
    flash_rows = []
    for Sq, Skv, q_off in ((32, 256, 0), (32, 256, 96), (32, 256, 224),
                           (160, 160, 0), (32, 256, 37), (32, 256, 213),
                           (32, 256, 230)):
        q, k, v = (randn(H, Sq, D, dtype=torch.bfloat16),
                   randn(H, Skv, D, dtype=torch.bfloat16),
                   randn(H, Skv, D, dtype=torch.bfloat16))
        off = torch.tensor([q_off], dtype=torch.int32, device="cuda")
        err = compare("flash_attention", ops.flash_attention(q, k, v, q_offset=off),
                      ref.ref_flash_attention(q, k, v, q_offset=q_off),
                      torch.bfloat16, torch)
        mask = (torch.arange(Skv, device="cuda")[None, :]
                <= torch.arange(Sq, device="cuda")[:, None] + q_off)
        pairs = int(mask.sum())
        kv_read = int(mask.any(0).sum())        # keys some query attends to
        b_ms, b_by = bound((q.numel() * 2 + 2 * H * kv_read * D) * 2,
                           4 * D * H * pairs, torch.bfloat16)
        p = _fl.plan(H, Sq, Skv, D, torch.bfloat16)
        r = dict(
            shape=f"H={H} Sq={Sq} Skv={Skv} D={D} q_offset={q_off} bf16",
            max_abs_err=err, plan=f"wq={p.wq} split={p.split} blocks="
                                  f"{p.split * H * -(-Sq // (16 * p.wq))}",
            ms=time_ms(lambda: ops.flash_attention(q, k, v, q_offset=off), torch),
            plain_ms=time_ms(lambda: ref.ref_flash_attention(q, k, v,
                                                             q_offset=q_off),
                             torch),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q[None], k[None], v[None], attn_mask=mask[None, None]), torch),
            bound_ms=b_ms, bound_by=b_by)
        print(f"  flash_attention time {r['shape']}: us={1e3 * r['ms']:.2f} "
              f"bound_us={1e3 * b_ms:.2f} plain_us={1e3 * r['plain_ms']:.2f} "
              f"sdpa_us={1e3 * r['library_ms']:.2f} kernel/sdpa="
              f"{r['ms'] / r['library_ms']:.3f} [{r['plan']}]")
        flash_rows.append(r)
    rows["flash_attention"] = dict(flash_rows[2], by_shape=flash_rows)

    # ---- paged decode and verify.  Every case is held against the plain
    # version, runs twice in bf16 (bitwise-equal outputs) and, captured in a
    # CUDA graph, is one kernel node; a graph of each entry replayed after
    # `length` changes in place equals the eager call (the launch reads no
    # length on the host).
    n_graphs = 0

    def paged_check(case, dt, kname, call, plain):
        got = call()
        err = compare(kname, got, plain(), dt, torch)
        note(kname, case, err)
        if dt == torch.bfloat16:
            check(torch.equal(got, call()), f"{kname} {case}: two calls differ")
        one_kernel(kname, case, call)
        return err

    def paged_fns(decode, q_, kp_, vp_, table, len_, sc):
        """(kernel name, kernel call, plain call) of one entry."""
        if decode:
            kname = "paged_decode_attention"
            fn, plain = ops.paged_decode_attention, ref.ref_paged_decode_attention
        else:
            kname = "paged_verify_attention"
            fn, plain = ops.paged_verify_attention, ref.ref_paged_verify_attention
        return (kname + ("_i8" if sc else ""),
                lambda: fn(q_, kp_, vp_, table, len_, **sc),
                lambda: plain(q_, kp_, vp_, table, len_, **sc))

    def replay_check(kname, case, call, len_, new):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = call()
        before, saved = call(), len_.clone()
        len_.copy_(torch.tensor(new, dtype=torch.int32, device="cuda"))
        graph.replay()
        eager = call()
        torch.cuda.synchronize()
        check(torch.equal(out, eager), f"{kname} {case}: the graph replayed at "
                                       f"lengths {new} differs from the eager call")
        check(not torch.equal(out, before), f"{kname} {case}: the replay did not "
                                            f"read the new lengths")
        len_.copy_(saved)

    # 8 slots over a shuffled pool, ragged lengths
    B, psz, n_max = 8, 16, 16
    n_pages = B * n_max + 1
    lengths = [1, 15, 16, 17, 100, 255, 256, 1]      # last slot: idle lane
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(1)) + 1
    bt = perm[:B * n_max].reshape(B, n_max).to(torch.int32)
    bt[-1] = 0                                       # idle lane -> scratch page 0
    bt = bt.cuda()
    length = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    for dt in (torch.float32, torch.bfloat16):
        qd = randn(B, H, D, dtype=dt)
        kp, vp = randn(n_pages, H, psz, D, dtype=dt), randn(n_pages, H, psz, D, dtype=dt)
        paged_check(f"lengths={lengths} {dtype_name(dt)}", dt,
                    *paged_fns(True, qd, kp, vp, bt, length, {}))
    qd = randn(B, H, D, dtype=torch.bfloat16)
    kp = randn(n_pages, H, psz, D, dtype=torch.bfloat16)
    vp = randn(n_pages, H, psz, D, dtype=torch.bfloat16)
    _, call, plain = paged_fns(True, qd, kp, vp, bt, length, {})
    err = compare("paged_decode_attention", call(), plain(), torch.bfloat16, torch)
    toks = sum(lengths)
    b_ms, b_by = bound(2 * qd.numel() * 2 + 2 * H * toks * D * 2
                       + bt.numel() * 4 + B * 4, 4 * D * H * toks, torch.bfloat16)
    rows["paged_decode_attention"] = dict(
        shape=f"B={B} H={H} D={D} psz={psz} n_max={n_max} lengths={lengths} bf16",
        max_abs_err=err, ms=time_ms(call, torch), plain_ms=time_ms(plain, torch),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)

    # ---- int8 pools and speculative verify, the same 8 slots.  Each slot's
    # page run covers what its deepest query sees and the block table holds
    # scratch page 0 past it, as the engine builds it; the last slot is an
    # idle lane (length 1 on the scratch page).
    def block_table(lengths, nq):
        out = bt.clone()
        for b, L in enumerate(lengths):
            out[b, min(-(-(L + nq - 1) // psz), n_max):] = 0
        return out

    def int8_pool(n_pages=n_pages, psz=psz, D=D):
        pool = torch.randint(-127, 128, (n_pages, H, psz, D), generator=gen,
                             device="cuda", dtype=torch.int8)
        scale = 0.05 * torch.rand(n_pages, psz, generator=gen, device="cuda")
        return pool, scale

    def zero_rows(scale, table):         # a recycled page's reset rows
        scale[int(table[4, 0]), scale.shape[1] // 2:] = 0.0   # read by slot 4
        return scale

    bt_dec = block_table(lengths, 1)
    for dt in (torch.float32, torch.bfloat16):
        (kq, ks), (vq, vs) = int8_pool(), int8_pool()
        zero_rows(ks, bt_dec), zero_rows(vs, bt_dec)
        qd = randn(B, H, D, dtype=dt)
        paged_check(f"lengths={lengths} q {dtype_name(dt)}, zero-scale rows", dt,
                    *paged_fns(True, qd, kq, vq, bt_dec, length,
                               dict(k_scale=ks, v_scale=vs)))
    (kq, ks), (vq, vs) = int8_pool(), int8_pool()
    zero_rows(ks, bt_dec), zero_rows(vs, bt_dec)
    qd = randn(B, H, D, dtype=torch.bfloat16)
    _, call, plain = paged_fns(True, qd, kq, vq, bt_dec, length,
                               dict(k_scale=ks, v_scale=vs))
    err = compare("paged_decode_attention_i8", call(), plain(), torch.bfloat16,
                  torch)
    b_ms, b_by = bound(2 * qd.numel() * 2 + 2 * H * toks * D + 2 * toks * 4
                       + bt.numel() * 4 + B * 4, 6 * D * H * toks, torch.int8)
    rows["paged_decode_attention_i8"] = dict(
        shape=f"B={B} H={H} D={D} psz={psz} n_max={n_max} lengths={lengths} "
              f"q bf16, int8 pools",
        max_abs_err=err, ms=time_ms(call, torch), plain_ms=time_ms(plain, torch),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)

    # verify: query i of a slot sees positions < length + i; the longest
    # slot's deepest query passes n_max * psz (the kernel clamps the pages);
    # Q 1 (the verify entry at decode's shape) up to 8 (k = 7)
    v_lengths = [1, 12, 16, 17, 100, 250, 254, 1]
    v_length = torch.tensor(v_lengths, dtype=torch.int32, device="cuda")

    for nq in (1, 2, 5, 8):
        bt_v = block_table(v_lengths, nq)
        for dt in (torch.float32, torch.bfloat16):
            qv = randn(B, H, nq, D, dtype=dt)
            kp_, vp_ = (randn(n_pages, H, psz, D, dtype=dt) for _ in range(2))
            paged_check(f"Q={nq} lengths={v_lengths} {dtype_name(dt)}", dt,
                        *paged_fns(False, qv, kp_, vp_, bt_v, v_length, {}))
            (kq, ks), (vq, vs) = int8_pool(), int8_pool()
            zero_rows(ks, bt_v), zero_rows(vs, bt_v)
            paged_check(f"Q={nq} lengths={v_lengths} q {dtype_name(dt)}, "
                        f"zero-scale rows", dt,
                        *paged_fns(False, qv, kq, vq, bt_v, v_length,
                                   dict(k_scale=ks, v_scale=vs)))

    # page edges at every head dim, pages of 8 and 16: a slot's length, or
    # its deepest query's view (length + nq - 1), ends on a page edge, or
    # runs to or past n_max * psz; decode and verify at Q 1, 2, 5 and 8,
    # float and int8 pools (a full block table, the last slot idle)
    for D_, psz_ in ((32, 8), (32, 16), (64, 8), (128, 8), (128, 16)):
        n_pages_ = B * n_max + 1
        table = (torch.randperm(n_pages_ - 1, generator=torch.Generator()
                                .manual_seed(2)) + 1)[:B * n_max]
        table = table.reshape(B, n_max).to(torch.int32)
        table[-1] = 0
        table = table.cuda()
        for nq in (1, 2, 5, 8):
            edges = [psz_, 2 * psz_, psz_ - nq + 1, 3 * psz_ - nq + 1, 6 * psz_,
                     n_max * psz_ - nq + 1, n_max * psz_, 1]
            len_ = torch.tensor(edges, dtype=torch.int32, device="cuda")
            for dt in (torch.float32, torch.bfloat16):
                q_ = randn(B, H, nq, D_, dtype=dt)
                pools = {False: ((randn(n_pages_, H, psz_, D_, dtype=dt),
                                  randn(n_pages_, H, psz_, D_, dtype=dt)), {})}
                (kq, ks), (vq, vs) = (int8_pool(n_pages_, psz_, D_) for _ in range(2))
                pools[True] = ((kq, vq), dict(k_scale=ks, v_scale=vs))
                for quant, ((kp_, vp_), sc) in pools.items():
                    case = (f"D={D_} psz={psz_} Q={nq} page-edge lengths={edges} "
                            f"q {dtype_name(dt)}{', int8 pools' if quant else ''}")
                    for decode in ((True, False) if nq == 1 else (False,)):
                        q_in = q_[:, :, 0].contiguous() if decode else q_
                        paged_check(case, dt, *paged_fns(decode, q_in, kp_, vp_,
                                                         table, len_, sc))
    print(f"  paged attention: each of {n_graphs} cases is one kernel node in a "
          f"CUDA graph")

    # a captured graph of each entry, replayed after `length` changes in place
    new_lengths = [40, 3, 200, 16, 1, 129, 64, 1]
    for dt in (torch.float32, torch.bfloat16):
        (kq, ks), (vq, vs) = int8_pool(), int8_pool()
        kp_, vp_ = (randn(n_pages, H, psz, D, dtype=dt) for _ in range(2))
        for decode, nq in ((True, 1), (False, 5)):
            q_ = randn(B, H, D, dtype=dt) if decode else randn(B, H, nq, D, dtype=dt)
            for pools, sc in (((kp_, vp_), {}), ((kq, vq), dict(k_scale=ks, v_scale=vs))):
                len_ = torch.tensor(v_lengths, dtype=torch.int32, device="cuda")
                kname, call, _ = paged_fns(decode, q_, *pools, bt, len_, sc)
                replay_check(kname, dtype_name(dt), call, len_, new_lengths)
    print("  paged attention: each entry's CUDA graph, replayed after length "
          "changed in place, equals the eager call (float32 and bf16)")

    nq = 5
    bt_v = block_table(v_lengths, nq)
    n_kv = [min(L + nq - 1, n_max * psz) for L in v_lengths]   # keys read
    pairs = sum(min(L + i, n_max * psz) for L in v_lengths for i in range(nq))
    qv = randn(B, H, nq, D, dtype=torch.bfloat16)
    kp_, vp_ = (randn(n_pages, H, psz, D, dtype=torch.bfloat16)
                for _ in range(2))
    (kq, ks), (vq, vs) = int8_pool(), int8_pool()
    zero_rows(ks, bt_v), zero_rows(vs, bt_v)
    io_bytes = 2 * qv.numel() * 2 + bt.numel() * 4 + B * 4
    for name, pools, sc, elt, ops_dt, extra in (
            ("paged_verify_attention", (kp_, vp_), {}, 2, torch.bfloat16, 0),
            ("paged_verify_attention_i8", (kq, vq),
             dict(k_scale=ks, v_scale=vs), 1, torch.int8, 2 * sum(n_kv) * 4)):
        _, call, plain = paged_fns(False, qv, *pools, bt_v, v_length, sc)
        err = compare(name, call(), plain(), torch.bfloat16, torch)
        b_ms, b_by = bound(io_bytes + 2 * H * sum(n_kv) * D * elt + extra,
                           4 * D * H * pairs + (2 * D * H * sum(n_kv)
                                                if sc else 0), ops_dt)
        rows[name] = dict(
            shape=f"B={B} H={H} Q={nq} D={D} psz={psz} n_max={n_max} "
                  f"lengths={v_lengths} q bf16, "
                  f"{'int8' if sc else 'bf16'} pools",
            max_abs_err=err, ms=time_ms(call, torch),
            plain_ms=time_ms(plain, torch),
            library_ms=None, bound_ms=b_ms, bound_by=b_by)
    for name in ("paged_decode_attention", "paged_decode_attention_i8",
                 "paged_verify_attention", "paged_verify_attention_i8"):
        p = _dec.plan(B, H, 1 if "decode" in name else nq, D, psz, n_max,
                      torch.bfloat16, name.endswith("_i8"))
        rows[name]["plan"] = f"nw={p.nw} split={p.split} blocks={p.split * B * H}"
        print(f"  {name} time {rows[name]['shape']}: "
              f"us={1e3 * rows[name]['ms']:.2f} "
              f"bound_us={1e3 * rows[name]['bound_ms']:.2f} "
              f"plain_us={1e3 * rows[name]['plain_ms']:.2f} [{rows[name]['plan']}]")

    # ---- SSD scan at full width (H 32, P 64, N 128): the serve chunk (Bt 1,
    # S 32), a chunk shorter than one 16-row tile (S 5), one row past a
    # tile (S 33), and three kernel chunks and a partial one (S 200), with
    # and without trailing dt = 0 rows (padding past a prompt), one and two
    # batch rows, from a zero, a float32 and an int8 state (one head's
    # scale 0); y and the final state against the plain version.  Every
    # bf16 case runs twice (bitwise-equal outputs); every case is one
    # kernel node in a CUDA graph
    Hs, Ps, Ns = 32, 64, 128

    def ssd_inputs(Bt, S, dt_, pad=0):
        x = randn(Bt, S, Hs, Ps, dtype=dt_)
        dtv = 0.1 * randn(Bt, S, Hs).abs()
        if pad:
            dtv[:, -pad:] = 0.0
        A = -(randn(Hs).abs() + 0.5)
        return x, dtv, randn(Bt, S, Ns, dtype=dt_), randn(Bt, S, Ns, dtype=dt_), A

    def int8_state(Bt):
        q = torch.randint(-127, 128, (Bt, Hs, Ps, Ns), generator=gen,
                          device="cuda", dtype=torch.int8)
        scale = 0.02 * torch.rand(Bt, Hs, generator=gen, device="cuda")
        scale[0, 1] = 0.0                       # a head reset to zeros
        return q, scale

    def ssd_call(name, inputs, s0):
        if name == "ssd_scan":
            return ops.ssd_scan(*inputs, s0)
        return ops.ssd_scan_i8(*inputs, *s0)

    def ssd_plain(name, inputs, s0):
        if name == "ssd_scan":
            return ref.ref_ssd_scan(*inputs, s0)
        return ref.ref_ssd_scan(*inputs, ref.ref_dequant_state(*s0))

    def ssd_check(name, case, inputs, s0):
        dt_ = inputs[0].dtype
        (y, st), (wy, wst) = ssd_call(name, inputs, s0), ssd_plain(name, inputs, s0)
        err = max(compare(name, y, wy, dt_, torch, SSD_TOL[dtype_name(dt_)]),
                  compare(f"{name} final state", st, wst, torch.float32, torch,
                          SSD_TOL["float32"]))
        note(name, case, err)
        if dt_ == torch.bfloat16:
            y2, st2 = ssd_call(name, inputs, s0)
            check(torch.equal(y, y2) and torch.equal(st, st2),
                  f"{name} {case}: two calls differ")
        one_kernel(name, case, lambda: ssd_call(name, inputs, s0))
        return err

    n_graphs = 0
    for dt_ in (torch.float32, torch.bfloat16):
        for Bt, S, pad in ((1, 32, 0), (1, 32, 9), (1, 5, 0), (1, 5, 2),
                           (1, 33, 0), (2, 200, 0), (2, 200, 17)):
            inputs = ssd_inputs(Bt, S, dt_, pad)
            case = f"Bt={Bt} S={S} trailing dt=0 rows={pad} {dtype_name(dt_)}"
            ssd_check("ssd_scan", case + ", zero state", inputs, None)
            ssd_check("ssd_scan", case + ", float32 state", inputs,
                      randn(Bt, Hs, Ps, Ns))
            ssd_check("ssd_scan_i8", case + ", int8 state", inputs,
                      int8_state(Bt))
    print(f"  ssd_scan: each of {n_graphs} cases is one kernel node in a CUDA "
          f"graph")
    S = 32
    inputs = ssd_inputs(1, S, torch.bfloat16)
    io_bytes = (2 * S * Hs * Ps + 2 * S * Ns) * 2 + S * Hs * 4 + Hs * 4
    state_elems = Hs * Ps * Ns
    for name, s0, s0_bytes in (
            ("ssd_scan", randn(1, Hs, Ps, Ns), 4 * state_elems),
            ("ssd_scan_i8", int8_state(1), state_elems + 4 * Hs)):
        err = ssd_check(name, "serve chunk, timed", inputs, s0)
        # the chunked form's products, all on bf16 tensor cores (S <= one
        # chunk): C h^T and the update (2 + 2 ops per token and state
        # element), and C B^T and W x on and below the diagonal; the final
        # state is written once in float32
        tri = S * (S + 1) // 2
        b_ms, b_by = bound(io_bytes + s0_bytes + 4 * state_elems,
                           4 * S * state_elems + 2 * tri * Hs * (Ns + Ps),
                           torch.bfloat16)
        rows[name] = dict(
            shape=f"Bt=1 S={S} H={Hs} P={Ps} N={Ns} x/B/C bf16, "
                  f"{'int8' if name.endswith('i8') else 'float32'} state0",
            max_abs_err=err,
            ms=time_ms(lambda n=name, st=s0: ssd_call(n, inputs, st), torch),
            plain_ms=time_ms(lambda n=name, st=s0: ssd_plain(n, inputs, st),
                             torch),
            library_ms=None, bound_ms=b_ms, bound_by=b_by)

    # ---- decode attention over contiguous lanes, float (decode_attention)
    # and fixed-scale int8 (decode_attention_i8, dq = 1/16): the serve shape
    # (B 8, H 8, S 256, D 64) and tinyllama's longest lane (S 1024) with
    # full, ragged and 16-key-tile-edge lengths, zero lengths and idle lanes
    # (length 1), and S = 300 (no multiple of a tile) at D 32 and 128.
    # Every float key and value at or past a row's length is NaN in the
    # kernel's input (the plain version gets the clean lanes): a kernel that
    # read one would return NaN (int8 has no NaN; its lanes are whole).
    # Every bf16 case runs twice (bitwise-equal outputs); every case is one
    # kernel node in a CUDA graph; a graph of each variant, replayed after
    # `length` changes in place, equals the eager call.
    DQ = 1.0 / 16.0

    def poisoned(t, length):
        t = t.clone()
        for b, L in enumerate(length.tolist()):
            t[b, :, L:] = float("nan")
        return t

    def contig_inputs(Bc, Hc, S, Dc, dt, quant):
        qc = randn(Bc, Hc, Dc, dtype=dt)
        if quant:
            kc, vc = (torch.randint(-127, 128, (Bc, Hc, S, Dc), generator=gen,
                                    device="cuda", dtype=torch.int8)
                      for _ in range(2))
        else:
            kc, vc = randn(Bc, Hc, S, Dc, dtype=dt), randn(Bc, Hc, S, Dc, dtype=dt)
        return qc, kc, vc

    def contig_fns(qc, kc, vc, lc, quant, kin=None, vin=None):
        """(kernel name, kernel call, plain call); the kernel reads kin/vin
        (default kc/vc)."""
        kin = kc if kin is None else kin
        vin = vc if vin is None else vin
        if quant:
            return ("decode_attention_i8",
                    lambda: ops.decode_attention_i8(qc, kin, vin, lc, DQ),
                    lambda: ref.ref_decode_attention_i8(qc, kc, vc, lc, DQ))
        return ("decode_attention", lambda: ops.decode_attention(qc, kin, vin, lc),
                lambda: ref.ref_decode_attention(qc, kc, vc, lc))

    def contig_check(case, Bc, Hc, S, Dc, lengths, dt, quant):
        qc, kc, vc = contig_inputs(Bc, Hc, S, Dc, dt, quant)
        lc = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        kin, vin = (kc, vc) if quant else (poisoned(kc, lc), poisoned(vc, lc))
        kname, call, plain = contig_fns(qc, kc, vc, lc, quant, kin, vin)
        got = call()
        err = compare(kname, got, plain(), dt, torch)
        case = f"{case} {dtype_name(dt)}{' q, int8 lanes' if quant else ''}"
        note(kname, case, err)
        if dt == torch.bfloat16:
            check(torch.equal(got, call()), f"{kname} {case}: two calls differ")
        one_kernel(kname, case, call)
        return err

    n_graphs = 0
    for dt in (torch.float32, torch.bfloat16):
        for quant in (False, True):
            for S, lens in (
                    (256, [256] * 8),
                    (256, [1, 13, 31, 32, 33, 150, 255, 1]),
                    (256, [16, 32, 48, 64, 128, 240, 0, 1]),
                    (1024, [1024] * 8),
                    (1024, [0, 1, 16, 17, 511, 512, 1000, 1024])):
                contig_check(f"B=8 H=8 S={S} D=64 lengths={lens}", 8, 8, S, 64,
                             lens, dt, quant)
            for Dc in (32, 128):
                contig_check(f"B=6 H=4 S=300 D={Dc} lengths 0,13,150,256,300 + idle",
                             6, 4, 300, Dc, [0, 13, 150, 256, 300, 1], dt, quant)
    print(f"  decode attention: each of {n_graphs} cases is one kernel node in a "
          f"CUDA graph")
    for dt in (torch.float32, torch.bfloat16):
        for quant in (False, True):
            qc, kc, vc = contig_inputs(8, 8, 256, 64, dt, quant)
            len_ = torch.tensor([256, 1, 13, 255, 0, 64, 200, 1], dtype=torch.int32,
                                device="cuda")
            kname, call, _ = contig_fns(qc, kc, vc, len_, quant)
            replay_check(kname, dtype_name(dt), call, len_,
                         [40, 3, 200, 16, 1, 129, 64, 0])
    print("  decode attention: each variant's CUDA graph, replayed after length "
          "changed in place, equals the eager call (float32 and bf16)")

    # times (bf16, L2-warm) at the serve shape and at S 1024, full lengths;
    # the rows of the JSON line are the serve shape's
    Bc, Hc, Dc = 8, 8, 64
    for quant in (False, True):
        by_shape = []
        for S in (256, 1024):
            qc, kc, vc = contig_inputs(Bc, Hc, S, Dc, torch.bfloat16, quant)
            lc = torch.full((Bc,), S, dtype=torch.int32, device="cuda")
            kname, call, plain = contig_fns(qc, kc, vc, lc, quant)
            err = compare(kname, call(), plain(), torch.bfloat16, torch)
            toks = int(lc.sum())
            # bytes: q read and o written, each row's valid keys and values
            # read once (one byte an element in int8)
            elt = 1 if quant else 2
            b_ms, b_by = bound(2 * qc.numel() * 2 + 2 * Hc * toks * Dc * elt + Bc * 4,
                               (6 if quant else 4) * Dc * Hc * toks,
                               torch.int8 if quant else torch.bfloat16)
            kmask = (torch.arange(S, device="cuda")[None, :] < lc[:, None])[:, None, None]
            p = _dec.contiguous_plan(Bc, Hc, S, Dc, torch.bfloat16, quant)
            r = dict(
                shape=f"B={Bc} H={Hc} S={S} D={Dc} lengths all {S} q bf16, "
                      f"{'int8' if quant else 'bf16'} lanes",
                max_abs_err=err, plan=f"nw={p.nw} split={p.split} "
                                      f"blocks={p.split * Bc * Hc}",
                ms=time_ms(call, torch), plain_ms=time_ms(plain, torch),
                library_ms=None if quant else time_ms(
                    lambda: F.scaled_dot_product_attention(
                        qc[:, :, None], kc, vc, attn_mask=kmask), torch),
                bound_ms=b_ms, bound_by=b_by)
            lib = "none" if quant else f"{1e3 * r['library_ms']:.2f}"
            print(f"  {kname} time {r['shape']}: us={1e3 * r['ms']:.2f} "
                  f"bound_us={1e3 * b_ms:.2f} plain_us={1e3 * r['plain_ms']:.2f} "
                  f"sdpa_us={lib} [{r['plan']}]")
            by_shape.append(r)
        rows[kname] = dict(by_shape[0], by_shape=by_shape)

    _gqa_kernels(torch, F, randn, gen, note, one_kernel, replay_check, rows)
    _gemma3_kernels(torch, F, randn, gen, note, one_kernel, replay_check, rows)
    _hymba_kernels(torch, F, randn, gen, note, one_kernel, rows)
    _mistral_kernels(torch, F, randn, gen, note, one_kernel, replay_check, rows)
    _paper64h_kernels(torch, F, randn, gen, note, one_kernel, replay_check, rows)
    _seamless_kernels(torch, F, randn, gen, note, one_kernel, replay_check, rows)
    _moe_kernels(torch, randn, gen, note, one_kernel, rows)

    for name, r in rows.items():
        r["max_abs_err_all_cases"] = max(worst[name], r["max_abs_err"])
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"kernels: {name} [{r['shape']}] ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} library_ms={lib} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"max_abs_err={r['max_abs_err_all_cases']:.3e}")
    return rows


# qwen3-0.6b's attention: 16 q heads over 8 kv heads (R = 2), head_dim 128
GQA_HQ, GQA_HK, GQA_D = 16, 8, 128


def _gqa_kernels(torch, F, randn, gen, note, one_kernel, replay_check, rows):
    """The four attention kernels and both int8 variants at qwen3's GQA
    shapes (R = 2, D 128), float32 and bf16, against their plain versions:
    flash over the prefill chunk (Sq 32 over a 256-key stream, q_offset an
    int32 on the card, at 0, 96, 224 and 230) and whole prompts (Sq = Skv
    23 and 160); paged decode (B 8, pages of 16, ragged lengths, an idle
    lane) and verify at Q 5 and 8 (R Q = 16, the m16 full) over float and
    int8 pools; the contiguous decode over float and int8 lanes at S 256
    and 1024.  Every bf16 case runs twice (bitwise-equal outputs), every
    case is one kernel node in a CUDA graph, a graph of each paged entry
    replayed after `length` changes equals the eager call, and verify
    refuses R Q = 18 before any launch.  Times (bf16, L2-warm) beside the
    bound, the plain version and, where one call computes the same,
    SDPA with enable_gqa=True; appended to each kernel's ``by_shape``."""
    from repro_torch.core import attention as core_attn
    from repro_torch.kernels import decode_attention as _dec
    from repro_torch.kernels import flash_attention as _fl
    from repro_torch.kernels import ops, ref
    Hq, Hk, D = GQA_HQ, GQA_HK, GQA_D
    R = Hq // Hk
    bf = torch.bfloat16
    timed = []

    def add(name, r):
        row = rows[name]
        row.setdefault("by_shape", [{k: v for k, v in row.items()}])
        row["by_shape"].append(r)
        timed.append((name, r))

    def twice(kname, case, dt, call, got):
        if dt == bf:
            check(torch.equal(got, call()), f"{kname} {case}: two calls differ")
        one_kernel(kname, case, call)

    # ---- flash: the chunk at four offsets (230: rows past Skv) and whole
    # prompts, q_offset as the chunk step hands it over (an int32 on the card)
    for dt in (torch.float32, bf):
        for Sq, Skv, q_off in ((32, 256, 0), (32, 256, 96), (32, 256, 224),
                               (32, 256, 230), (23, 23, 0), (160, 160, 0)):
            q, k, v = (randn(Hq, Sq, D, dtype=dt), randn(Hk, Skv, D, dtype=dt),
                       randn(Hk, Skv, D, dtype=dt))
            off = torch.tensor([q_off], dtype=torch.int32, device="cuda")

            def call():
                return ops.flash_attention(q, k, v, q_offset=off)

            case = (f"GQA {Hq}/{Hk} Sq={Sq} Skv={Skv} D={D} q_offset={q_off} "
                    f"{dtype_name(dt)}")
            got = call()
            note("flash_attention", case, compare(
                "flash_attention", got,
                ref.ref_flash_attention(q, k, v, q_offset=q_off), dt, torch))
            twice("flash_attention", case, dt, call, got)
    for Sq, Skv, q_off in ((32, 256, 224), (160, 160, 0)):
        q, k, v = (randn(Hq, Sq, D, dtype=bf), randn(Hk, Skv, D, dtype=bf),
                   randn(Hk, Skv, D, dtype=bf))
        off = torch.tensor([q_off], dtype=torch.int32, device="cuda")
        mask = (torch.arange(Skv, device="cuda")[None, :]
                <= torch.arange(Sq, device="cuda")[:, None] + q_off)
        pairs, kv_read = int(mask.sum()), int(mask.any(0).sum())
        b_ms, b_by = bound((2 * q.numel() + 2 * Hk * kv_read * D) * 2,
                           4 * D * Hq * pairs, bf)
        if q_off == 0 and Sq == Skv:        # a whole prompt: plain causal
            def sdpa():
                return F.scaled_dot_product_attention(
                    q[None], k[None], v[None], is_causal=True, enable_gqa=True)
        else:                               # is_causal cannot say q_offset
            def sdpa():
                return F.scaled_dot_product_attention(
                    q[None], k[None], v[None], attn_mask=mask[None, None],
                    enable_gqa=True)
        compare(f"SDPA yardstick Sq={Sq} q_offset={q_off}", sdpa()[0],
                ref.ref_flash_attention(q, k, v, q_offset=q_off), bf, torch)
        p = _fl.plan(Hq, Sq, Skv, D, bf, 0, R)
        rb = _fl.heads_per_block(R)
        add("flash_attention", dict(
            shape=f"GQA Hq={Hq} Hk={Hk} Sq={Sq} Skv={Skv} D={D} "
                  f"q_offset={q_off} bf16",
            max_abs_err=compare("flash_attention",
                                ops.flash_attention(q, k, v, q_offset=off),
                                ref.ref_flash_attention(q, k, v, q_offset=q_off),
                                bf, torch),
            plan=f"wq={p.wq} split={p.split} blocks="
                 f"{p.split * (Hq // rb) * -(-Sq // (16 * p.wq // rb))}",
            ms=time_ms(lambda: ops.flash_attention(q, k, v, q_offset=off), torch),
            plain_ms=time_ms(lambda: ref.ref_flash_attention(q, k, v,
                                                             q_offset=q_off),
                             torch),
            library_ms=time_ms(sdpa, torch),
            bound_ms=b_ms, bound_by=b_by))

    # ---- paged decode and verify: 8 slots over a shuffled pool of pages of
    # 16, ragged lengths, the last slot an idle lane on scratch page 0
    B, psz, n_max = 8, 16, 16
    n_pages = B * n_max + 1
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(3)) + 1
    bt_full = perm[:B * n_max].reshape(B, n_max).to(torch.int32).cuda()
    bt_full[-1] = 0

    def table(lengths, nq):
        out = bt_full.clone()
        for b, L in enumerate(lengths):
            out[b, min(-(-(L + nq - 1) // psz), n_max):] = 0
        return out

    def pools(dt, quant):
        if not quant:
            return (randn(n_pages, Hk, psz, D, dtype=dt),
                    randn(n_pages, Hk, psz, D, dtype=dt)), {}
        kq, vq = (torch.randint(-127, 128, (n_pages, Hk, psz, D), generator=gen,
                                device="cuda", dtype=torch.int8) for _ in range(2))
        ks, vs = (0.05 * torch.rand(n_pages, psz, generator=gen, device="cuda")
                  for _ in range(2))
        return (kq, vq), dict(k_scale=ks, v_scale=vs)

    lengths = [1, 15, 16, 17, 100, 250, 248, 1]
    length = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    for nq in (1, 5, 8):
        bt = table(lengths, nq)
        for dt in (torch.float32, bf):
            for quant in (False, True):
                (kp, vp), sc = pools(dt, quant)
                q = randn(B, Hq, D, dtype=dt) if nq == 1 else \
                    randn(B, Hq, nq, D, dtype=dt)
                fn, plain = (ops.paged_decode_attention,
                             ref.ref_paged_decode_attention) if nq == 1 else \
                    (ops.paged_verify_attention, ref.ref_paged_verify_attention)
                kname = ("paged_decode_attention" if nq == 1 else
                         "paged_verify_attention") + ("_i8" if quant else "")

                def call():
                    return fn(q, kp, vp, bt, length, **sc)

                case = (f"GQA {Hq}/{Hk} Q={nq} D={D} psz={psz} lengths={lengths} "
                        f"q {dtype_name(dt)}{', int8 pools' if quant else ''}")
                got = call()
                note(kname, case, compare(kname, got,
                                          plain(q, kp, vp, bt, length, **sc),
                                          dt, torch))
                twice(kname, case, dt, call, got)
                if dt == bf and nq in (1, 8):
                    len_ = length.clone()
                    replay_check(kname, f"GQA Q={nq}",
                                 lambda: fn(q, kp, vp, bt_full, len_, **sc), len_,
                                 [40, 3, 200, 16, 1, 129, 64, 1])
                if dt == bf:
                    n_kv = [min(L + nq - 1, n_max * psz) for L in lengths]
                    pairs = sum(min(L + i, n_max * psz) for L in lengths
                                for i in range(nq))
                    elt = 1 if quant else 2
                    io = 2 * q.numel() * 2 + bt.numel() * 4 + B * 4
                    kv = 2 * Hk * sum(n_kv) * D * elt + \
                        (2 * sum(n_kv) * 4 if quant else 0)
                    b_ms, b_by = bound(io + kv, 4 * D * Hq * pairs +
                                       (2 * D * Hq * sum(n_kv) if quant else 0),
                                       torch.int8 if quant else bf)
                    p = _dec.plan(B, Hq, nq, D, psz, n_max, bf, quant, R)
                    add(kname, dict(
                        shape=f"GQA B={B} Hq={Hq} Hk={Hk} Q={nq} D={D} psz={psz} "
                              f"n_max={n_max} lengths={lengths} q bf16, "
                              f"{'int8' if quant else 'bf16'} pools",
                        max_abs_err=compare(kname, call(),
                                            plain(q, kp, vp, bt, length, **sc),
                                            bf, torch),
                        plan=f"nw={p.nw} split={p.split} blocks={p.split * B * Hk}",
                        ms=time_ms(call, torch),
                        plain_ms=time_ms(lambda: plain(q, kp, vp, bt, length,
                                                       **sc), torch),
                        library_ms=None, bound_ms=b_ms, bound_by=b_by))
    # R x Q past the m16 (R 3 x Q 6 = 18 rows; R 2 x Q 9 on the core route)
    # is refused before any launch, naming both
    (kp, vp), _ = pools(bf, False)
    q18 = randn(B, 3 * Hk, 6, D, dtype=bf)
    before = ops.launch_counts()
    for what, fn in (
            ("kernel wrapper", lambda: ops.paged_verify_attention(
                q18, kp, vp, table(lengths, 6), length)),
            ("core route", lambda: core_attn.paged_verify_attention(
                randn(B, Hk, 2, 9, D, dtype=bf), kp, vp, table(lengths, 9),
                length - 1))):
        try:
            fn()
        except ValueError as e:
            check("18" in str(e) and "q heads per kv head" in str(e),
                  f"paged_verify_attention: the R x Q = 18 refusal names "
                  f"neither: {e}")
        else:
            raise SmokeFailure(f"paged_verify_attention ({what}) took R x Q = "
                               f"18 query rows")
    check(ops.launch_counts() == before, "paged_verify_attention: a refused "
                                         "call counted a launch")
    print("  paged_verify_attention: R x Q = 18 refused before any launch "
          "(kernel wrapper and core route)")

    # ---- contiguous decode over float and fixed-scale int8 lanes
    DQ = 1.0 / 16.0
    for S in (256, 1024):
        lens = [S, 1, 13, 31, S - 1, 0, S // 2 + 7, 1]
        lc = torch.tensor(lens, dtype=torch.int32, device="cuda")
        for dt in (torch.float32, bf):
            for quant in (False, True):
                qc = randn(B, Hq, D, dtype=dt)
                if quant:
                    kc, vc = (torch.randint(-127, 128, (B, Hk, S, D), generator=gen,
                                            device="cuda", dtype=torch.int8)
                              for _ in range(2))
                    kname = "decode_attention_i8"
                    call = lambda: ops.decode_attention_i8(qc, kc, vc, lc, DQ)  # noqa: E731
                    plain = lambda: ref.ref_decode_attention_i8(qc, kc, vc, lc, DQ)  # noqa: E731
                else:
                    kc, vc = randn(B, Hk, S, D, dtype=dt), randn(B, Hk, S, D, dtype=dt)
                    kname = "decode_attention"
                    call = lambda: ops.decode_attention(qc, kc, vc, lc)  # noqa: E731
                    plain = lambda: ref.ref_decode_attention(qc, kc, vc, lc)  # noqa: E731
                case = (f"GQA {Hq}/{Hk} B={B} S={S} D={D} lengths={lens} "
                        f"q {dtype_name(dt)}{', int8 lanes' if quant else ''}")
                got = call()
                note(kname, case, compare(kname, got, plain(), dt, torch))
                twice(kname, case, dt, call, got)
        for quant in (False, True):
            qc = randn(B, Hq, D, dtype=bf)
            full = torch.full((B,), S, dtype=torch.int32, device="cuda")
            if quant:
                kc, vc = (torch.randint(-127, 128, (B, Hk, S, D), generator=gen,
                                        device="cuda", dtype=torch.int8)
                          for _ in range(2))
                kname = "decode_attention_i8"
                call = lambda: ops.decode_attention_i8(qc, kc, vc, full, DQ)  # noqa: E731
                plain = lambda: ref.ref_decode_attention_i8(qc, kc, vc, full, DQ)  # noqa: E731
                lib = None
            else:
                kc, vc = randn(B, Hk, S, D, dtype=bf), randn(B, Hk, S, D, dtype=bf)
                kname = "decode_attention"
                call = lambda: ops.decode_attention(qc, kc, vc, full)  # noqa: E731
                plain = lambda: ref.ref_decode_attention(qc, kc, vc, full)  # noqa: E731
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    qc[:, :, None], kc, vc, enable_gqa=True)
            toks = B * S
            elt = 1 if quant else 2
            b_ms, b_by = bound(2 * qc.numel() * 2 + 2 * Hk * toks * D * elt + B * 4,
                               (6 if quant else 4) * D * Hq * toks,
                               torch.int8 if quant else bf)
            p = _dec.contiguous_plan(B, Hq, S, D, bf, quant, R)
            add(kname, dict(
                shape=f"GQA B={B} Hq={Hq} Hk={Hk} S={S} D={D} lengths all {S} "
                      f"q bf16, {'int8' if quant else 'bf16'} lanes",
                max_abs_err=compare(kname, call(), plain(), bf, torch),
                plan=f"nw={p.nw} split={p.split} blocks={p.split * B * Hk}",
                ms=time_ms(call, torch), plain_ms=time_ms(plain, torch),
                library_ms=None if lib is None else time_ms(lib, torch),
                bound_ms=b_ms, bound_by=b_by))
    for name, r in timed:
        lib = "none" if r["library_ms"] is None else f"{1e3 * r['library_ms']:.2f}"
        print(f"  {name} time {r['shape']}: us={1e3 * r['ms']:.2f} "
              f"bound_us={1e3 * r['bound_ms']:.2f} plain_us={1e3 * r['plain_ms']:.2f} "
              f"sdpa_gqa_us={lib} [{r['plan']}]")


# gemma3-12b's attention: 16 q heads over 8 kv heads (R = 2), head_dim 256,
# sliding windows of 1024 keys on 5 of every 6 layers
G3_HQ, G3_HK, G3_D, G3_E, G3_WIN = 16, 8, 256, 3840, 1024
# every matmul of gemma3-12b's main path: (name, K, N, trans_b)
G3_MATMULS = (("gemma3 wq", 3840, 4096, False),
              ("gemma3 wk/wv", 3840, 2048, False),
              ("gemma3 wo", 4096, 3840, False),
              ("gemma3 w_gate/w_up", 3840, 15360, False),
              ("gemma3 w_down", 15360, 3840, False),
              ("gemma3 LM head", 3840, 262144, True))


def _gemma3_kernels(torch, F, randn, gen, note, one_kernel, replay_check, rows):
    """The window and head_dim 256 cases at gemma3-12b's shapes (16 q over
    8 kv heads), against their plain versions: paged decode and verify (Q
    5) with windows of 64 and 1024 at D 64, 128 and 256 (B 8, pages of 16,
    n_max 128, lengths 100-2000, on both sides of each window), float32
    and bf16 q over float and int8 pools, and a graph of each bf16 entry
    at D 256 replayed after the lengths cross the window; the contiguous
    decode at D 256 over float and int8 lanes of a 1024-slot ring past its
    wrap (lengths clamped to the ring); flash at D 256 over a prefill chunk
    of 128 at q_offset 1400 in 2048 gathered keys with the window of 1024,
    without a window (the global layers), and a 512-token prompt with and
    without it; rmsnorm at E 3840 and the qk-norm rows of 256; matmul at
    every gemma3 projection and the 262,144-row tied head.  Every bf16 case
    runs twice (bitwise-equal outputs), every case is one kernel node in a
    CUDA graph.  Times (bf16, L2-warm) beside the bound, the plain version
    and the library call where one computes the same (SDPA with a window
    mask, ``torch.matmul``, ``F.rms_norm``); appended to each kernel's
    ``by_shape``."""
    from repro_torch.kernels import decode_attention as _dec
    from repro_torch.kernels import flash_attention as _fl
    from repro_torch.kernels import matmul as _mm
    from repro_torch.kernels import ops, ref
    Hq, Hk, E = G3_HQ, G3_HK, G3_E
    Rg = Hq // Hk
    bf = torch.bfloat16
    timed = []

    def add(name, r):
        row = rows[name]
        row.setdefault("by_shape", [{k: v for k, v in row.items()}])
        row["by_shape"].append(r)
        timed.append((name, r))

    def twice(kname, case, dt, call, got):
        if dt == bf:
            check(torch.equal(got, call()), f"{kname} {case}: two calls differ")
        one_kernel(kname, case, call)

    # ---- paged decode and verify with windows: 8 slots over a shuffled
    # pool of 1025 pages of 16 (n_max 128, the serve phase's 2048 budget)
    B, psz, n_max = 8, 16, 128
    n_pages = B * n_max + 1
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(4)) + 1
    bt = perm[:B * n_max].reshape(B, n_max).to(torch.int32).cuda()
    lengths = [100, 513, 1023, 1024, 1025, 1500, 1777, 2000]
    length = torch.tensor(lengths, dtype=torch.int32, device="cuda")

    def pools(dt, quant, D):
        if not quant:
            return (randn(n_pages, Hk, psz, D, dtype=dt),
                    randn(n_pages, Hk, psz, D, dtype=dt)), {}
        kq, vq = (torch.randint(-127, 128, (n_pages, Hk, psz, D), generator=gen,
                                device="cuda", dtype=torch.int8) for _ in range(2))
        ks, vs = (0.05 * torch.rand(n_pages, psz, generator=gen, device="cuda")
                  for _ in range(2))
        return (kq, vq), dict(k_scale=ks, v_scale=vs)

    def entry(nq, quant):
        fn, plain = (ops.paged_decode_attention, ref.ref_paged_decode_attention) \
            if nq == 1 else (ops.paged_verify_attention, ref.ref_paged_verify_attention)
        kname = ("paged_decode_attention" if nq == 1 else
                 "paged_verify_attention") + ("_i8" if quant else "")
        return kname, fn, plain

    for D in (64, 128, G3_D):
        for dt in (torch.float32, bf):
            for quant in (False, True):
                (kp, vp), sc = pools(dt, quant, D)
                for win in (64, G3_WIN):
                    for nq in (1, 5):
                        kname, fn, plain = entry(nq, quant)
                        q = randn(B, Hq, D, dtype=dt) if nq == 1 else \
                            randn(B, Hq, nq, D, dtype=dt)

                        def call():
                            return fn(q, kp, vp, bt, length, window=win, **sc)

                        case = (f"gemma3 {Hq}/{Hk} window={win} Q={nq} D={D} "
                                f"n_max={n_max} lengths={lengths} q "
                                f"{dtype_name(dt)}{', int8 pools' if quant else ''}")
                        got = call()
                        note(kname, case, compare(
                            kname, got, plain(q, kp, vp, bt, length, window=win,
                                              **sc), dt, torch))
                        twice(kname, case, dt, call, got)
                        if dt == bf and D == G3_D and win == G3_WIN:
                            len_ = length.clone()
                            replay_check(kname, f"gemma3 window={win} Q={nq}",
                                         lambda: fn(q, kp, vp, bt, len_,
                                                    window=win, **sc), len_,
                                         [40, 1030, 2040, 16, 1, 1200, 64, 900])
                del kp, vp, sc
    print("  paged attention: windows of 64 and 1024 at D 64, 128 and 256 "
          "against the plain versions; graphs replayed across the window")

    # times at gemma3's decode (D 256, window 1024 and the global layers'
    # none) and verify Q 5 (window 1024), bf16 q, bf16 and int8 pools
    D = G3_D
    for quant in (False, True):
        (kp, vp), sc = pools(bf, quant, D)
        for nq, win in ((1, G3_WIN), (1, 0), (5, G3_WIN)):
            kname, fn, plain = entry(nq, quant)
            q = randn(B, Hq, D, dtype=bf) if nq == 1 else randn(B, Hq, nq, D, dtype=bf)
            # keys some query of a slot sees: [max(0, L - win), L + nq - 1)
            kv = [min(L + nq - 1, n_max * psz) - (max(0, L - win) if win else 0)
                  for L in lengths]
            pairs = sum(min(L + i, n_max * psz) - (max(0, L + i - win) if win else 0)
                        for L in lengths for i in range(nq))
            elt = 1 if quant else 2
            io = 2 * q.numel() * 2 + bt.numel() * 4 + B * 4
            b_ms, b_by = bound(io + 2 * Hk * sum(kv) * D * elt +
                               (2 * sum(kv) * 4 if quant else 0),
                               4 * D * Hq * pairs + (2 * D * Hq * sum(kv) if quant else 0),
                               torch.int8 if quant else bf)
            p = _dec.plan(B, Hq, nq, D, psz, n_max, bf, quant, Rg, win)

            def call():
                return fn(q, kp, vp, bt, length, window=win, **sc)

            add(kname, dict(
                shape=f"gemma3 B={B} Hq={Hq} Hk={Hk} Q={nq} D={D} psz={psz} "
                      f"n_max={n_max} window={win} lengths={lengths} q bf16, "
                      f"{'int8' if quant else 'bf16'} pools",
                max_abs_err=compare(kname, call(), plain(q, kp, vp, bt, length,
                                                         window=win, **sc), bf, torch),
                plan=f"nw={p.nw} split={p.split} blocks={p.split * B * Hk}",
                ms=time_ms(call, torch),
                plain_ms=time_plain(lambda: plain(q, kp, vp, bt, length, window=win,
                                               **sc), torch),
                library_ms=None, bound_ms=b_ms, bound_by=b_by))
        del kp, vp, sc

    # ---- contiguous decode at D 256 over a ring of 1024 slots (a window
    # layer's lane): positions past the wrap read min(pos + 1, 1024) slots
    S, DQ = G3_WIN, 1.0 / 16.0
    positions = [1500, 1023, 2000, 300, 1024, 5000, 1100, 0]
    lc = torch.tensor([min(p + 1, S) for p in positions], dtype=torch.int32,
                      device="cuda")

    def contig(dt, quant):
        qc = randn(B, Hq, D, dtype=dt)
        if quant:
            kc, vc = (torch.randint(-127, 128, (B, Hk, S, D), generator=gen,
                                    device="cuda", dtype=torch.int8) for _ in range(2))
            return ("decode_attention_i8", qc, kc, vc,
                    lambda len_: ops.decode_attention_i8(qc, kc, vc, len_, DQ),
                    lambda len_: ref.ref_decode_attention_i8(qc, kc, vc, len_, DQ))
        kc, vc = randn(B, Hk, S, D, dtype=dt), randn(B, Hk, S, D, dtype=dt)
        return ("decode_attention", qc, kc, vc,
                lambda len_: ops.decode_attention(qc, kc, vc, len_),
                lambda len_: ref.ref_decode_attention(qc, kc, vc, len_))

    for dt in (torch.float32, bf):
        for quant in (False, True):
            kname, qc, kc, vc, call, plain = contig(dt, quant)
            case = (f"gemma3 ring S={S} D={D} positions={positions} q "
                    f"{dtype_name(dt)}{', int8 lanes' if quant else ''}")
            got = call(lc)
            note(kname, case, compare(kname, got, plain(lc), dt, torch))
            twice(kname, case, dt, lambda: call(lc), got)
    full = torch.full((B,), S, dtype=torch.int32, device="cuda")
    for quant in (False, True):
        kname, qc, kc, vc, call, plain = contig(bf, quant)
        elt = 1 if quant else 2
        b_ms, b_by = bound(2 * qc.numel() * 2 + 2 * Hk * B * S * D * elt + B * 4,
                           (6 if quant else 4) * D * Hq * B * S,
                           torch.int8 if quant else bf)
        p = _dec.contiguous_plan(B, Hq, S, D, bf, quant, Rg)
        add(kname, dict(
            shape=f"gemma3 ring B={B} Hq={Hq} Hk={Hk} S={S} D={D} lengths all "
                  f"{S} q bf16, {'int8' if quant else 'bf16'} lanes",
            max_abs_err=compare(kname, call(full), plain(full), bf, torch),
            plan=f"nw={p.nw} split={p.split} blocks={p.split * B * Hk}",
            ms=time_ms(lambda: call(full), torch),
            plain_ms=time_plain(lambda: plain(full), torch),
            library_ms=None if quant else time_ms(
                lambda: F.scaled_dot_product_attention(
                    qc[:, :, None], kc, vc, enable_gqa=True), torch),
            bound_ms=b_ms, bound_by=b_by))
        del kc, vc

    # ---- flash at D 256: the serve phase's prefill chunk (Sq 128 at
    # q_offset 1400 over the 2048-key gathered stream) with the window and
    # without (a global layer), and a 512-token prompt with and without
    # it; q_offset as the chunk step hands it over (an int32 on the card)
    for dt in (torch.float32, bf):
        for Sq, Skv, q_off, win in ((128, 2048, 1400, G3_WIN), (128, 2048, 1400, 0),
                                    (512, 512, 0, G3_WIN), (512, 512, 0, 0),
                                    (128, 2048, 0, G3_WIN)):
            q, k, v = (randn(Hq, Sq, D, dtype=dt), randn(Hk, Skv, D, dtype=dt),
                       randn(Hk, Skv, D, dtype=dt))
            off = torch.tensor([q_off], dtype=torch.int32, device="cuda")

            def call():
                return ops.flash_attention(q, k, v, window=win, q_offset=off)

            case = (f"gemma3 {Hq}/{Hk} Sq={Sq} Skv={Skv} D={D} q_offset={q_off} "
                    f"window={win} {dtype_name(dt)}")
            got = call()
            note("flash_attention", case, compare(
                "flash_attention", got, ref.ref_flash_attention(
                    q, k, v, window=win, q_offset=q_off), dt, torch))
            twice("flash_attention", case, dt, call, got)
    for Sq, Skv, q_off, win in ((128, 2048, 1400, G3_WIN), (128, 2048, 1400, 0),
                                (512, 512, 0, G3_WIN), (512, 512, 0, 0)):
        q, k, v = (randn(Hq, Sq, D, dtype=bf), randn(Hk, Skv, D, dtype=bf),
                   randn(Hk, Skv, D, dtype=bf))
        off = torch.tensor([q_off], dtype=torch.int32, device="cuda")
        qpos = torch.arange(Sq, device="cuda")[:, None] + q_off
        kpos = torch.arange(Skv, device="cuda")[None, :]
        mask = kpos <= qpos
        if win:
            mask &= kpos > qpos - win
        pairs, kv_read = int(mask.sum()), int(mask.any(0).sum())
        b_ms, b_by = bound((2 * q.numel() + 2 * Hk * kv_read * D) * 2,
                           4 * D * Hq * pairs, bf)
        if q_off == 0 and Sq == Skv and not win:
            def sdpa():
                return F.scaled_dot_product_attention(
                    q[None], k[None], v[None], is_causal=True, enable_gqa=True)
        else:
            def sdpa():
                return F.scaled_dot_product_attention(
                    q[None], k[None], v[None], attn_mask=mask[None, None],
                    enable_gqa=True)
        compare(f"SDPA yardstick Sq={Sq} q_offset={q_off} window={win}", sdpa()[0],
                ref.ref_flash_attention(q, k, v, window=win, q_offset=q_off), bf,
                torch)
        p = _fl.plan(Hq, Sq, Skv, D, bf, win, Rg)
        rb = _fl.heads_per_block(Rg)
        add("flash_attention", dict(
            shape=f"gemma3 Hq={Hq} Hk={Hk} Sq={Sq} Skv={Skv} D={D} "
                  f"q_offset={q_off} window={win} bf16",
            max_abs_err=compare("flash_attention",
                                ops.flash_attention(q, k, v, window=win, q_offset=off),
                                ref.ref_flash_attention(q, k, v, window=win,
                                                        q_offset=q_off), bf, torch),
            plan=f"wq={p.wq} split={p.split} blocks="
                 f"{p.split * (Hq // rb) * -(-Sq // (16 * p.wq // rb))}",
            ms=time_ms(lambda: ops.flash_attention(q, k, v, window=win,
                                                   q_offset=off), torch),
            plain_ms=time_plain(lambda: ref.ref_flash_attention(
                q, k, v, window=win, q_offset=q_off), torch),
            library_ms=time_ms(sdpa, torch), bound_ms=b_ms, bound_by=b_by))

    # ---- rmsnorm: a decode tick's and a chunk's rows at E 3840 (ln1/ln2,
    # post_ln1/post_ln2, the final norm) and the qk-norm rows of 256 (8
    # slots x 16 heads a tick, a 128-token chunk's 2048), random scales
    for dt in (torch.float32, bf):
        for T, En in ((8, E), (128, E), (128, G3_D), (2048, G3_D)):
            x, s = randn(T, En, dtype=dt), 0.1 * randn(En, dtype=dt)
            case = f"gemma3 T={T} E={En} {dtype_name(dt)}"
            got = ops.rmsnorm(x, s)
            note("rmsnorm", case, compare("rmsnorm", got, ref.ref_rmsnorm(x, s),
                                          dt, torch))
            twice("rmsnorm", case, dt, lambda: ops.rmsnorm(x, s), got)
            if dt == bf:
                r = randn(T, En, dtype=dt)
                xs, y = ops.rmsnorm_residual(x, r, s)
                check(torch.equal(xs, x + r) and torch.equal(y, ops.rmsnorm(x + r, s)),
                      f"rmsnorm_residual {case}: not bitwise the unfused ops")
                note("rmsnorm_residual", case, compare(
                    "rmsnorm_residual", y, ref.ref_rmsnorm_residual(x, r, s)[1],
                    dt, torch))
                one_kernel("rmsnorm_residual", case,
                           lambda: ops.rmsnorm_residual(x, r, s))
    for T, En in ((8, E), (128, G3_D)):
        x, s = randn(T, En, dtype=bf), 0.1 * randn(En, dtype=bf)
        w1 = (1.0 + s.float()).to(bf)
        b_ms, b_by = bound(2 * x.numel() * 2 + s.numel() * 2, 5 * x.numel(),
                           torch.float32)
        add("rmsnorm", dict(
            shape=f"gemma3 x ({T}, {En}) bf16",
            max_abs_err=compare("rmsnorm", ops.rmsnorm(x, s), ref.ref_rmsnorm(x, s),
                                bf, torch),
            ms=time_ms(lambda: ops.rmsnorm(x, s), torch),
            plain_ms=time_plain(lambda: ref.ref_rmsnorm(x, s), torch),
            library_ms=(time_ms(lambda: F.rms_norm(x, (En,), w1, 1e-6), torch)
                        if hasattr(F, "rms_norm") else None),
            bound_ms=b_ms, bound_by=b_by, plan="-"))

    # ---- matmul at every gemma3 projection (M 8 a decode tick, 128 a
    # chunk) and the tied head (M 8 a tick, 1 a chunk's last row); weights
    # at the init scale; float32 at M 8 for the projections
    for tag, K, N, nt in G3_MATMULS:
        b = (0.02 * (randn(N, K) if nt else randn(K, N))).to(bf)
        for M in ((8, 1) if nt else (8, 128)):
            a = randn(M, K, dtype=bf)
            case = f"{tag} M={M} K={K} N={N}{' NT' if nt else ''} bf16"
            got = ops.matmul(a, b, trans_b=nt)
            note("matmul", case, compare("matmul", got, ref.ref_matmul(a, b, nt),
                                         bf, torch))
            twice("matmul", case, bf, lambda: ops.matmul(a, b, trans_b=nt), got)
            b_ms, b_by = bound((M * K + K * N + M * N) * 2, 2 * M * N * K, bf)
            p = _mm.plan(M, N, K, bf, nt)
            add("matmul", dict(
                shape=f"{tag} a ({M}, {K}) @ {'(%d, %d)^T' % (N, K) if nt else '(%d, %d)' % (K, N)} bf16",
                M=M, K=K, N=N, trans_b=nt, max_abs_err=compare(
                    "matmul", got, ref.ref_matmul(a, b, nt), bf, torch),
                plan=f"bn={p.bn} split={p.split} kt={p.kt} bm={p.bm} blocks={p.blocks}",
                ms=time_ms(lambda: ops.matmul(a, b, trans_b=nt), torch),
                plain_ms=time_plain(lambda: ref.ref_matmul(a, b, nt), torch),
                library_ms=time_ms(lambda: torch.matmul(a, b.t() if nt else b), torch),
                bound_ms=b_ms, bound_by=b_by))
        if not nt:
            bf32, a32 = b.float(), randn(8, K)
            case = f"{tag} M=8 K={K} N={N} float32"
            note("matmul", case, compare("matmul", ops.matmul(a32, bf32),
                                         ref.ref_matmul(a32, bf32), torch.float32,
                                         torch))
            one_kernel("matmul", case, lambda: ops.matmul(a32, bf32))
            del bf32
        del b
    torch.cuda.empty_cache()
    for name, r in timed:
        lib = "none" if r["library_ms"] is None else f"{1e3 * r['library_ms']:.2f}"
        print(f"  {name} time {r['shape']}: us={1e3 * r['ms']:.2f} "
              f"bound_us={1e3 * r['bound_ms']:.2f} plain_us={1e3 * r['plain_ms']:.2f} "
              f"library_us={lib} [{r['plan']}]")


# hymba-1.5b: 25 q heads over 25 kv slots (at tp=1 each of its 5 kv heads is
# stored once per q head: group 1), head_dim 64, windows of 1024 on 29 of
# its 32 layers; 50 SSD heads of 64 with state 16; d_model 1600
HY_H, HY_D, HY_E, HY_WIN = 25, 64, 1600, 1024
HY_SSD_H, HY_SSD_P, HY_SSD_N = 50, 64, 16
# every matmul shape of hymba-1.5b's main path: (name, K, N, trans_b); wq,
# wk and wv are (1600, 1600) as wo is, in_z and in_x (1600, 3200), out
# (3200, 1600)
HY_MATMULS = (("hymba wq/wk/wv/wo", 1600, 1600, False),
              ("hymba in_z/in_x", 1600, 3200, False),
              ("hymba in_dt", 1600, 50, False),
              ("hymba in_B/in_C", 1600, 16, False),
              ("hymba out", 3200, 1600, False),
              ("hymba w_gate/w_up", 1600, 5504, False),
              ("hymba w_down", 5504, 1600, False),
              ("hymba LM head", 1600, 32001, True))
# the shapes timed (the rest are checked only)
HY_TIMED = ("hymba in_dt", "hymba in_B/in_C", "hymba w_gate/w_up",
            "hymba w_down", "hymba LM head")


def _hymba_kernels(torch, F, randn, gen, note, one_kernel, rows):
    """The kernel cases at hymba-1.5b's shapes, against their plain
    versions: paged decode over bf16 and int8 pools (B 8, 25 heads at group
    1, D 64, pages of 16, n_max 128, lengths 100-2000) with the window of
    1024 and without (its 3 global layers), float32 and bf16 q; the
    contiguous decode over a 1024-slot ring past its wrap, float and int8
    lanes; flash over the prefill chunk (Sq 128 at q_offset 1400 in 2048
    gathered keys) with the window and without; the SSD scan at Bt 1, S
    128, H 50, P 64, N 16 (float32 and bf16, from a zero, a float32 and an
    int8 state, with and without trailing dt = 0 rows); the gated norm
    over 3200 channels and the norm at E 1600; matmul at every hymba
    projection (in_dt's N 50 takes the plans without 16-byte weight loads,
    in_B/in_C's N 16 the narrowest) and the 32,001-row tied head.  Every
    bf16 case runs twice (bitwise-equal outputs) and every case is one
    kernel node in a CUDA graph.  Times
    (bf16, L2-warm) beside the bound, the plain version (``time_plain``)
    and the library call where one computes the same (SDPA, with a mask
    for a window or an offset; ``torch.matmul``; ``F.rms_norm``); appended
    to each kernel's ``by_shape``."""
    from repro_torch.kernels import decode_attention as _dec
    from repro_torch.kernels import flash_attention as _fl
    from repro_torch.kernels import matmul as _mm
    from repro_torch.kernels import ops, ref
    H, D = HY_H, HY_D
    bf = torch.bfloat16
    timed = []

    def add(name, r):
        row = rows[name]
        row.setdefault("by_shape", [{k: v for k, v in row.items()}])
        row["by_shape"].append(r)
        timed.append((name, r))

    def twice(kname, case, dt, call, got):
        if dt == bf:
            check(torch.equal(got, call()), f"{kname} {case}: two calls differ")
        one_kernel(kname, case, call)

    # ---- paged decode: 8 slots over a shuffled pool of 1025 pages of 16
    B, psz, n_max = 8, 16, 128
    n_pages = B * n_max + 1
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(5)) + 1
    bt = perm[:B * n_max].reshape(B, n_max).to(torch.int32).cuda()
    lengths = [100, 513, 1023, 1024, 1025, 1500, 1777, 2000]
    length = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    for quant in (False, True):
        if quant:
            kp, vp = (torch.randint(-127, 128, (n_pages, H, psz, D), generator=gen,
                                    device="cuda", dtype=torch.int8) for _ in range(2))
            sc = dict(k_scale=0.05 * torch.rand(n_pages, psz, generator=gen, device="cuda"),
                      v_scale=0.05 * torch.rand(n_pages, psz, generator=gen, device="cuda"))
        else:
            kp, vp, sc = randn(n_pages, H, psz, D, dtype=bf), randn(n_pages, H, psz, D,
                                                                   dtype=bf), {}
        kname = "paged_decode_attention" + ("_i8" if quant else "")
        for dt in (torch.float32, bf):
            for win in (HY_WIN, 0):
                q = randn(B, H, D, dtype=dt)
                pools = (kp, vp) if quant else (kp.to(dt), vp.to(dt))

                def call():
                    return ops.paged_decode_attention(q, *pools, bt, length,
                                                      window=win, **sc)

                def plain():
                    return ref.ref_paged_decode_attention(q, *pools, bt, length,
                                                          window=win, **sc)

                case = (f"hymba {H}/{H} window={win} D={D} n_max={n_max} "
                        f"lengths={lengths} q {dtype_name(dt)}"
                        f"{', int8 pools' if quant else ''}")
                got = call()
                err = compare(kname, got, plain(), dt, torch)
                note(kname, case, err)
                twice(kname, case, dt, call, got)
                if dt != bf:
                    continue
                kv = [L - (max(0, L - win) if win else 0) for L in lengths]
                elt = 1 if quant else 2
                b_ms, b_by = bound(2 * q.numel() * 2 + bt.numel() * 4 + B * 4 +
                                   2 * H * sum(kv) * D * elt +
                                   (2 * sum(kv) * 4 if quant else 0),
                                   4 * D * H * sum(kv) + (2 * D * H * sum(kv) if quant else 0),
                                   torch.int8 if quant else bf)
                p = _dec.plan(B, H, 1, D, psz, n_max, bf, quant, 1, win)
                add(kname, dict(
                    shape=f"hymba B={B} H={H} group 1 D={D} psz={psz} n_max={n_max} "
                          f"window={win} lengths={lengths} q bf16, "
                          f"{'int8' if quant else 'bf16'} pools",
                    max_abs_err=err,
                    plan=f"nw={p.nw} split={p.split} blocks={p.split * B * H}",
                    ms=time_ms(call, torch), plain_ms=time_plain(plain, torch),
                    library_ms=None, bound_ms=b_ms, bound_by=b_by))
        del kp, vp, sc
    print("  paged decode attention: hymba's 25 heads at group 1, windows of "
          "1024 and none, float and int8 pools, against the plain versions")

    # ---- the contiguous decode over a window layer's ring of 1024 slots:
    # positions past the wrap read min(pos + 1, 1024) slots
    S, DQ = HY_WIN, 1.0 / 16.0
    positions = [1500, 1023, 2000, 300, 1024, 5000, 1100, 0]
    lc = torch.tensor([min(p_ + 1, S) for p_ in positions], dtype=torch.int32,
                      device="cuda")
    full = torch.full((B,), S, dtype=torch.int32, device="cuda")
    for quant in (False, True):
        kname = "decode_attention" + ("_i8" if quant else "")
        for dt in (torch.float32, bf):
            qc = randn(B, H, D, dtype=dt)
            if quant:
                kc, vc = (torch.randint(-127, 128, (B, H, S, D), generator=gen,
                                        device="cuda", dtype=torch.int8) for _ in range(2))

                def call(len_):
                    return ops.decode_attention_i8(qc, kc, vc, len_, DQ)

                def plain(len_):
                    return ref.ref_decode_attention_i8(qc, kc, vc, len_, DQ)
            else:
                kc, vc = randn(B, H, S, D, dtype=dt), randn(B, H, S, D, dtype=dt)

                def call(len_):
                    return ops.decode_attention(qc, kc, vc, len_)

                def plain(len_):
                    return ref.ref_decode_attention(qc, kc, vc, len_)
            case = (f"hymba ring S={S} D={D} positions={positions} q "
                    f"{dtype_name(dt)}{', int8 lanes' if quant else ''}")
            got = call(lc)
            note(kname, case, compare(kname, got, plain(lc), dt, torch))
            twice(kname, case, dt, lambda: call(lc), got)
            if dt != bf:
                continue
            elt = 1 if quant else 2
            b_ms, b_by = bound(2 * qc.numel() * 2 + 2 * H * B * S * D * elt + B * 4,
                               (6 if quant else 4) * D * H * B * S,
                               torch.int8 if quant else bf)
            p = _dec.contiguous_plan(B, H, S, D, bf, quant, 1)
            add(kname, dict(
                shape=f"hymba ring B={B} H={H} group 1 S={S} D={D} lengths all "
                      f"{S} q bf16, {'int8' if quant else 'bf16'} lanes",
                max_abs_err=compare(kname, call(full), plain(full), bf, torch),
                plan=f"nw={p.nw} split={p.split} blocks={p.split * B * H}",
                ms=time_ms(lambda: call(full), torch),
                plain_ms=time_plain(lambda: plain(full), torch),
                library_ms=None if quant else time_ms(
                    lambda: F.scaled_dot_product_attention(
                        qc[:, :, None], kc, vc), torch),
                bound_ms=b_ms, bound_by=b_by))
            del kc, vc

    # ---- flash over the serve phase's prefill chunk: Sq 128 at q_offset
    # 1400 in the 2048-key gathered stream, with the window and without (a
    # global layer); q_offset as the chunk step hands it over (an int32 on
    # the card)
    Sq, Skv, q_off = 128, 2048, 1400
    off = torch.tensor([q_off], dtype=torch.int32, device="cuda")
    qpos = torch.arange(Sq, device="cuda")[:, None] + q_off
    kpos = torch.arange(Skv, device="cuda")[None, :]
    for dt in (torch.float32, bf):
        for win in (HY_WIN, 0):
            q, k, v = (randn(H, Sq, D, dtype=dt), randn(H, Skv, D, dtype=dt),
                       randn(H, Skv, D, dtype=dt))

            def call():
                return ops.flash_attention(q, k, v, window=win, q_offset=off)

            def plain():
                return ref.ref_flash_attention(q, k, v, window=win, q_offset=q_off)

            case = (f"hymba {H}/{H} Sq={Sq} Skv={Skv} D={D} q_offset={q_off} "
                    f"window={win} {dtype_name(dt)}")
            got = call()
            err = compare("flash_attention", got, plain(), dt, torch)
            note("flash_attention", case, err)
            twice("flash_attention", case, dt, call, got)
            if dt != bf:
                continue
            mask = kpos <= qpos
            if win:
                mask &= kpos > qpos - win
            pairs, kv_read = int(mask.sum()), int(mask.any(0).sum())
            b_ms, b_by = bound((2 * q.numel() + 2 * H * kv_read * D) * 2,
                               4 * D * H * pairs, bf)

            def sdpa():
                return F.scaled_dot_product_attention(q[None], k[None], v[None],
                                                      attn_mask=mask[None, None])

            compare(f"SDPA yardstick hymba window={win}", sdpa()[0], plain(), bf,
                    torch)
            p = _fl.plan(H, Sq, Skv, D, bf, win, 1)
            add("flash_attention", dict(
                shape=f"hymba H={H} group 1 Sq={Sq} Skv={Skv} D={D} "
                      f"q_offset={q_off} window={win} bf16",
                max_abs_err=err, plan=f"wq={p.wq} split={p.split}",
                ms=time_ms(call, torch), plain_ms=time_plain(plain, torch),
                library_ms=time_ms(sdpa, torch), bound_ms=b_ms, bound_by=b_by))

    # ---- the SSD scan at hymba's heads: a 128-token chunk (two of the
    # kernel's 64-row chunks), H 50, P 64, N 16, from a zero, a float32 and
    # an int8 state (one head's scale 0), with and without 37 trailing
    # dt = 0 rows (a prompt's last chunk); y and the final state
    Hs, Ps, Ns, S = HY_SSD_H, HY_SSD_P, HY_SSD_N, 128

    def ssd_inputs(dt_, pad):
        x = randn(1, S, Hs, Ps, dtype=dt_)
        dtv = 0.1 * randn(1, S, Hs).abs()
        if pad:
            dtv[:, -pad:] = 0.0
        A = -(randn(Hs).abs() + 0.5)
        return x, dtv, randn(1, S, Ns, dtype=dt_), randn(1, S, Ns, dtype=dt_), A

    def int8_state():
        q = torch.randint(-127, 128, (1, Hs, Ps, Ns), generator=gen, device="cuda",
                          dtype=torch.int8)
        scale = 0.02 * torch.rand(1, Hs, generator=gen, device="cuda")
        scale[0, 7] = 0.0
        return q, scale

    def ssd_call(name, inputs, s0):
        return ops.ssd_scan(*inputs, s0) if name == "ssd_scan" else \
            ops.ssd_scan_i8(*inputs, *s0)

    def ssd_plain(name, inputs, s0):
        return ref.ref_ssd_scan(*inputs, s0) if name == "ssd_scan" else \
            ref.ref_ssd_scan(*inputs, ref.ref_dequant_state(*s0))

    state_elems = Hs * Ps * Ns
    io_bytes = (2 * S * Hs * Ps + 2 * S * Ns) * 2 + S * Hs * 4 + Hs * 4
    for dt_ in (torch.float32, bf):
        for pad in (0, 37):
            inputs = ssd_inputs(dt_, pad)
            for name, s0, s0_bytes, what in (
                    ("ssd_scan", None, 0, "zero"),
                    ("ssd_scan", randn(1, Hs, Ps, Ns), 4 * state_elems, "float32"),
                    ("ssd_scan_i8", int8_state(), state_elems + 4 * Hs, "int8")):
                case = (f"hymba Bt=1 S={S} H={Hs} P={Ps} N={Ns} trailing dt=0 "
                        f"rows={pad} {dtype_name(dt_)}, {what} state")
                (y, st), (wy, wst) = ssd_call(name, inputs, s0), ssd_plain(name, inputs, s0)
                err = max(compare(name, y, wy, dt_, torch, SSD_TOL[dtype_name(dt_)]),
                          compare(f"{name} final state", st, wst, torch.float32,
                                  torch, SSD_TOL["float32"]))
                note(name, case, err)
                if dt_ == bf:
                    y2, st2 = ssd_call(name, inputs, s0)
                    check(torch.equal(y, y2) and torch.equal(st, st2),
                          f"{name} {case}: two calls differ")
                one_kernel(name, case, lambda n=name, s=s0: ssd_call(n, inputs, s))
                if dt_ != bf or pad:
                    continue
                # the chunked form's products on bf16 tensor cores, per 64-row
                # chunk: C h^T and the update (2 + 2 ops per token and state
                # element), C B^T and W x on and below the diagonal
                tri = 2 * (64 * 65 // 2)
                b_ms, b_by = bound(io_bytes + s0_bytes + 4 * state_elems,
                                   4 * S * state_elems + 2 * tri * Hs * (Ns + Ps), bf)
                add(name, dict(
                    shape=f"hymba Bt=1 S={S} H={Hs} P={Ps} N={Ns} x/B/C bf16, "
                          f"{what} state0",
                    max_abs_err=err, plan="-",
                    ms=time_ms(lambda n=name, s=s0: ssd_call(n, inputs, s), torch),
                    plain_ms=time_plain(lambda n=name, s=s0: ssd_plain(n, inputs, s),
                                        torch),
                    library_ms=None, bound_ms=b_ms, bound_by=b_by))

    # ---- the norms: the gated norm over d_inner 3200 (y and z bf16 as the
    # SSD heads give them, out bf16), ln1/ln2/final at E 1600; a decode
    # tick's 8 rows and a chunk's 128
    for T in (8, 128):
        y, z = randn(T, 2 * HY_E, dtype=bf), 2.0 * randn(T, 2 * HY_E, dtype=bf)
        sg = 0.1 * randn(2 * HY_E, dtype=bf)
        case = f"hymba T={T} n={2 * HY_E} bf16"
        got = ops.rmsnorm_gated(y, z, sg, out_dtype=bf)
        note("rmsnorm_gated", case, compare(
            "rmsnorm_gated", got, ref.ref_rmsnorm_gated(y, z, sg, out_dtype=bf), bf,
            torch))
        twice("rmsnorm_gated", case, bf,
              lambda: ops.rmsnorm_gated(y, z, sg, out_dtype=bf), got)
        x, s = randn(T, HY_E, dtype=bf), 0.1 * randn(HY_E, dtype=bf)
        case = f"hymba T={T} E={HY_E} bf16"
        got = ops.rmsnorm(x, s)
        note("rmsnorm", case, compare("rmsnorm", got, ref.ref_rmsnorm(x, s), bf, torch))
        twice("rmsnorm", case, bf, lambda: ops.rmsnorm(x, s), got)
        if T == 8:
            b_ms, b_by = bound(3 * y.numel() * 2 + sg.numel() * 2, 8 * y.numel(),
                               torch.float32)
            add("rmsnorm_gated", dict(
                shape=f"hymba y, z ({T}, {2 * HY_E}) bf16, out bf16",
                max_abs_err=compare("rmsnorm_gated",
                                    ops.rmsnorm_gated(y, z, sg, out_dtype=bf),
                                    ref.ref_rmsnorm_gated(y, z, sg, out_dtype=bf),
                                    bf, torch),
                plan="-", ms=time_ms(lambda: ops.rmsnorm_gated(y, z, sg, out_dtype=bf),
                                     torch),
                plain_ms=time_plain(lambda: ref.ref_rmsnorm_gated(y, z, sg,
                                                                  out_dtype=bf), torch),
                library_ms=None, bound_ms=b_ms, bound_by=b_by))

    # ---- matmul at every hymba projection (M 8 a decode tick, 128 a
    # chunk) and the tied head (M 8 a tick, 1 a chunk's last row); weights
    # at the init scale; float32 at M 8 (the parity phase's)
    for tag, K, N, nt in HY_MATMULS:
        b = (0.02 * (randn(N, K) if nt else randn(K, N))).to(bf)
        for M in ((8, 1) if nt else (8, 128)):
            a = randn(M, K, dtype=bf)
            case = f"{tag} M={M} K={K} N={N}{' NT' if nt else ''} bf16"
            got = ops.matmul(a, b, trans_b=nt)
            err = compare("matmul", got, ref.ref_matmul(a, b, nt), bf, torch)
            note("matmul", case, err)
            twice("matmul", case, bf, lambda: ops.matmul(a, b, trans_b=nt), got)
            if tag not in HY_TIMED:
                continue
            b_ms, b_by = bound((M * K + K * N + M * N) * 2, 2 * M * N * K, bf)
            p = _mm.plan(M, N, K, bf, nt)
            w = f"({N}, {K})^T" if nt else f"({K}, {N})"
            add("matmul", dict(
                shape=f"{tag} a ({M}, {K}) @ {w} bf16",
                M=M, K=K, N=N, trans_b=nt, max_abs_err=err,
                plan=f"bn={p.bn} split={p.split} kt={p.kt} bm={p.bm} blocks={p.blocks} "
                     f"vec={p.vec}",
                ms=time_ms(lambda: ops.matmul(a, b, trans_b=nt), torch),
                plain_ms=time_plain(lambda: ref.ref_matmul(a, b, nt), torch),
                library_ms=time_ms(lambda: torch.matmul(a, b.t() if nt else b), torch),
                bound_ms=b_ms, bound_by=b_by))
        bf32, a32 = b.float(), randn(8, K)
        case = f"{tag} M=8 K={K} N={N}{' NT' if nt else ''} float32"
        note("matmul", case, compare("matmul", ops.matmul(a32, bf32, trans_b=nt),
                                     ref.ref_matmul(a32, bf32, nt), torch.float32,
                                     torch))
        one_kernel("matmul", case, lambda: ops.matmul(a32, bf32, trans_b=nt))
        del b, bf32
    torch.cuda.empty_cache()
    for name, r in timed:
        lib = "none" if r["library_ms"] is None else f"{1e3 * r['library_ms']:.2f}"
        print(f"  {name} time {r['shape']}: us={1e3 * r['ms']:.2f} "
              f"bound_us={1e3 * r['bound_ms']:.2f} plain_us={1e3 * r['plain_ms']:.2f} "
              f"library_us={lib} [{r['plan']}]")


# mistral-large-123b's widths: 96 q heads over 8 kv heads of 128 (group 12
# at tp=1), d_model 12288, d_ff 28672, the untied 32768-row head
ML_HQ, ML_HK, ML_D, ML_E, ML_F, ML_V = 96, 8, 128, 12288, 28672, 32768
ML_MATMULS = (("mistral wq", ML_E, ML_HQ * ML_D, False),
              ("mistral wk/wv", ML_E, ML_HK * ML_D, False),
              ("mistral wo", ML_HQ * ML_D, ML_E, False),
              ("mistral w_gate/w_up", ML_E, ML_F, False),
              ("mistral w_down", ML_F, ML_E, False),
              ("mistral LM head (untied)", ML_E, ML_V, True))


def _mistral_kernels(torch, F, randn, gen, note, one_kernel, replay_check,
                     rows):
    """The kernel cases at mistral-large-123b's shapes, against their plain
    versions: flash over serve-mistral's prefill chunk (Sq 32 at q_offset
    256 over 288 keys, and the first chunk at q_offset 0; 96 q over 8 kv
    heads, group 12, D 128; q_offset an int32 on the card); paged decode
    at B 8, group 12, D 128 (pages of 16, n_max 16, ragged lengths to 256,
    an idle lane; a graph replayed after the lengths change); the norm and
    the residual norm at E 12288; matmul at M 8 (a decode tick) and 32 (a
    chunk) for wq, wk/wv, wo, w_gate/w_up and w_down (K and N up to
    28672), and the untied head (32768, 12288) NT at M 8 and 1 (a chunk's
    last row).  float32 and bf16; every bf16 case runs twice (bitwise-
    equal outputs) and every case is one kernel node in a CUDA graph.
    Times (bf16, L2-warm) beside the bound, the plain version and the
    library call where one computes the same (SDPA with enable_gqa=True
    and a mask for the offset; ``F.rms_norm``; ``torch.matmul``); appended
    to each kernel's ``by_shape``."""
    from repro_torch.kernels import decode_attention as _dec
    from repro_torch.kernels import flash_attention as _fl
    from repro_torch.kernels import matmul as _mm
    from repro_torch.kernels import ops, ref
    Hq, Hk, D = ML_HQ, ML_HK, ML_D
    R = Hq // Hk
    bf = torch.bfloat16
    timed = []

    def add(name, r):
        row = rows[name]
        row.setdefault("by_shape", [{k: v for k, v in row.items()}])
        row["by_shape"].append(r)
        timed.append((name, r))

    def twice(kname, case, dt, call, got):
        if dt == bf:
            check(torch.equal(got, call()), f"{kname} {case}: two calls differ")
        one_kernel(kname, case, call)

    # ---- flash: the chunk at q_offset 256 over 288 keys (a 256-token
    # prefix), and the first chunk
    for dt in (torch.float32, bf):
        for Sq, Skv, q_off in ((32, 288, 256), (32, 32, 0)):
            q, k, v = (randn(Hq, Sq, D, dtype=dt), randn(Hk, Skv, D, dtype=dt),
                       randn(Hk, Skv, D, dtype=dt))
            off = torch.tensor([q_off], dtype=torch.int32, device="cuda")

            def call():
                return ops.flash_attention(q, k, v, q_offset=off)

            def plain():
                return ref.ref_flash_attention(q, k, v, q_offset=q_off)

            case = (f"mistral {Hq}/{Hk} Sq={Sq} Skv={Skv} D={D} "
                    f"q_offset={q_off} {dtype_name(dt)}")
            got = call()
            err = compare("flash_attention", got, plain(), dt, torch)
            note("flash_attention", case, err)
            twice("flash_attention", case, dt, call, got)
            if dt != bf or q_off == 0:
                continue
            mask = (torch.arange(Skv, device="cuda")[None, :]
                    <= torch.arange(Sq, device="cuda")[:, None] + q_off)
            pairs, kv_read = int(mask.sum()), int(mask.any(0).sum())
            b_ms, b_by = bound((2 * q.numel() + 2 * Hk * kv_read * D) * 2,
                               4 * D * Hq * pairs, bf)

            def sdpa():
                return F.scaled_dot_product_attention(
                    q[None], k[None], v[None], attn_mask=mask[None, None],
                    enable_gqa=True)

            compare("SDPA yardstick mistral", sdpa()[0], plain(), bf, torch)
            p = _fl.plan(Hq, Sq, Skv, D, bf, 0, R)
            rb = _fl.heads_per_block(R)
            add("flash_attention", dict(
                shape=f"mistral Hq={Hq} Hk={Hk} group {R} Sq={Sq} Skv={Skv} "
                      f"D={D} q_offset={q_off} bf16",
                max_abs_err=err,
                plan=f"wq={p.wq} split={p.split} heads_per_block={rb} blocks="
                     f"{p.split * (Hq // rb) * -(-Sq // (16 * p.wq // rb))}",
                ms=time_ms(call, torch), plain_ms=time_plain(plain, torch),
                library_ms=time_ms(sdpa, torch), bound_ms=b_ms, bound_by=b_by))

    # ---- paged decode: 8 slots over a shuffled pool of pages of 16, ragged
    # lengths to 256 (serve-mistral's budget), the last slot an idle lane
    B, psz, n_max = 8, 16, 16
    n_pages = B * n_max + 1
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(7)) + 1
    bt = perm[:B * n_max].reshape(B, n_max).to(torch.int32).cuda()
    bt[-1] = 0
    lengths = [1, 17, 33, 100, 160, 192, 256, 1]
    length = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    for dt in (torch.float32, bf):
        q = randn(B, Hq, D, dtype=dt)
        kp, vp = randn(n_pages, Hk, psz, D, dtype=dt), randn(n_pages, Hk, psz, D,
                                                            dtype=dt)

        def call():
            return ops.paged_decode_attention(q, kp, vp, bt, length)

        def plain():
            return ref.ref_paged_decode_attention(q, kp, vp, bt, length)

        case = (f"mistral {Hq}/{Hk} group {R} D={D} n_max={n_max} "
                f"lengths={lengths} {dtype_name(dt)}")
        got = call()
        err = compare("paged_decode_attention", got, plain(), dt, torch)
        note("paged_decode_attention", case, err)
        twice("paged_decode_attention", case, dt, call, got)
        replay_check("paged_decode_attention", case, call, length,
                     [256, 1, 16, 200, 33, 5, 128, 1])
        if dt != bf:
            continue
        toks = sum(lengths)
        b_ms, b_by = bound(2 * q.numel() * 2 + 2 * Hk * toks * D * 2 +
                           bt.numel() * 4 + B * 4, 4 * D * Hq * toks, bf)
        p = _dec.plan(B, Hq, 1, D, psz, n_max, bf, False, R)
        add("paged_decode_attention", dict(
            shape=f"mistral B={B} Hq={Hq} Hk={Hk} group {R} D={D} psz={psz} "
                  f"n_max={n_max} lengths={lengths} bf16",
            max_abs_err=err,
            plan=f"nw={p.nw} split={p.split} blocks={p.split * B * Hk}",
            ms=time_ms(call, torch), plain_ms=time_plain(plain, torch),
            library_ms=None, bound_ms=b_ms, bound_by=b_by))
    del kp, vp

    # ---- the norms at E 12288: a decode tick's 8 rows and a chunk's 32
    for T in (8, 32):
        x, r = randn(T, ML_E, dtype=bf), randn(T, ML_E, dtype=bf)
        sc = 0.1 * randn(ML_E, dtype=bf)
        case = f"mistral T={T} E={ML_E} bf16"
        got = ops.rmsnorm(x, sc)
        err = compare("rmsnorm", got, ref.ref_rmsnorm(x, sc), bf, torch)
        note("rmsnorm", case, err)
        twice("rmsnorm", case, bf, lambda: ops.rmsnorm(x, sc), got)
        xs, normed = ops.rmsnorm_residual(x, r, sc)
        check(torch.equal(xs, x + r) and torch.equal(normed, ops.rmsnorm(x + r, sc)),
              f"rmsnorm_residual {case}: not bitwise the unfused ops")
        note("rmsnorm_residual", case, 0.0)
        one_kernel("rmsnorm_residual", case, lambda: ops.rmsnorm_residual(x, r, sc))
        if T != 8:
            continue
        b_ms, b_by = bound(2 * x.numel() * 2 + sc.numel() * 2, 5 * x.numel(),
                           torch.float32)                # the math is float32
        w1 = (1.0 + sc.float()).to(bf)
        add("rmsnorm", dict(
            shape=f"mistral x ({T}, {ML_E}) bf16", max_abs_err=err, plan="-",
            ms=time_ms(lambda: ops.rmsnorm(x, sc), torch),
            plain_ms=time_plain(lambda: ref.ref_rmsnorm(x, sc), torch),
            library_ms=(time_ms(lambda: F.rms_norm(x, (ML_E,), w1, 1e-6), torch)
                        if hasattr(F, "rms_norm") else None),
            bound_ms=b_ms, bound_by=b_by))

    # ---- matmul: every projection at M 8 and 32, the untied head at M 8
    # and 1; weights at the init scale; float32 at M 8 (the parity phase's
    # kernel, at full width here)
    for tag, K, N, nt in ML_MATMULS:
        b = (0.02 * (randn(N, K) if nt else randn(K, N))).to(bf)
        for M in ((8, 1) if nt else (8, 32)):
            a = randn(M, K, dtype=bf)
            case = f"{tag} M={M} K={K} N={N}{' NT' if nt else ''} bf16"
            got = ops.matmul(a, b, trans_b=nt)
            err = compare("matmul", got, ref.ref_matmul(a, b, nt), bf, torch)
            note("matmul", case, err)
            twice("matmul", case, bf, lambda: ops.matmul(a, b, trans_b=nt), got)
            if M == 1:
                continue
            b_ms, b_by = bound((M * K + K * N + M * N) * 2, 2 * M * N * K, bf)
            p = _mm.plan(M, N, K, bf, nt)
            w = f"({N}, {K})^T" if nt else f"({K}, {N})"
            add("matmul", dict(
                shape=f"{tag} a ({M}, {K}) @ {w} bf16",
                M=M, K=K, N=N, trans_b=nt, max_abs_err=err,
                plan=f"bn={p.bn} split={p.split} kt={p.kt} bm={p.bm} blocks={p.blocks} "
                     f"smem={p.smem} vec={p.vec}",
                ms=time_ms(lambda: ops.matmul(a, b, trans_b=nt), torch),
                plain_ms=time_plain(lambda: ref.ref_matmul(a, b, nt), torch),
                library_ms=time_ms(lambda: torch.matmul(a, b.t() if nt else b), torch),
                bound_ms=b_ms, bound_by=b_by))
        bf32, a32 = b.float(), randn(8, K)
        del b
        case = f"{tag} M=8 K={K} N={N}{' NT' if nt else ''} float32"
        note("matmul", case, compare("matmul", ops.matmul(a32, bf32, trans_b=nt),
                                     ref.ref_matmul(a32, bf32, nt), torch.float32,
                                     torch))
        one_kernel("matmul", case, lambda: ops.matmul(a32, bf32, trans_b=nt))
        del bf32
        torch.cuda.empty_cache()
    for name, r in timed:
        lib = "none" if r["library_ms"] is None else f"{1e3 * r['library_ms']:.2f}"
        print(f"  {name} time {r['shape']}: us={1e3 * r['ms']:.2f} "
              f"bound_us={1e3 * r['bound_ms']:.2f} plain_us={1e3 * r['plain_ms']:.2f} "
              f"library_us={lib} [{r['plan']}]")


# tinyllama-42m-64h's widths: 64 q = 64 kv heads of head_dim 8 (the paper's
# Fig. 6 variant), d_model 512
P64_H, P64_D = 64, 8


def _paper64h_kernels(torch, F, randn, gen, note, one_kernel, replay_check,
                      rows):
    """The attention kernel cases at tinyllama-42m-64h's shapes (64 heads of
    head_dim 8, group 1), against their plain versions, float32 and bf16:
    flash over serve's prefill chunk (Sq 32 at q_offset 224 in 256 keys,
    the offset an int32 on the card), the first chunk and a whole
    160-token prompt; paged decode and verify (Q 5 and 8) over float and
    int8 pools (B 8, pages of 16, n_max 16, ragged lengths, an idle lane,
    zero-scale rows; a graph replayed after the lengths change); the
    contiguous decode over float and fixed-scale int8 lanes (S 256, ragged
    and zero lengths, NaN past every float row's length).  Every bf16 case
    runs twice (bitwise-equal outputs) and every case is one kernel node in
    a CUDA graph.  Times (bf16, L2-warm) beside the bound, the plain
    version and SDPA where it computes the same (a mask for the offset
    chunk and the lengths, ``is_causal`` for the prompt); appended to each
    kernel's ``by_shape``."""
    from repro_torch.kernels import decode_attention as _dec
    from repro_torch.kernels import flash_attention as _fl
    from repro_torch.kernels import ops, ref
    H, D = P64_H, P64_D
    bf = torch.bfloat16
    timed = []

    def add(name, r):
        row = rows[name]
        row.setdefault("by_shape", [{k: v for k, v in row.items()}])
        row["by_shape"].append(r)
        timed.append((name, r))

    def checked(kname, case, dt, call, plain):
        got = call()
        err = compare(kname, got, plain(), dt, torch)
        note(kname, case, err)
        if dt == bf:
            check(torch.equal(got, call()), f"{kname} {case}: two calls differ")
        one_kernel(kname, case, call)
        return err

    # ---- flash: the chunk at q_offset 224 over 256 keys, the first chunk,
    # and a whole prompt of 160 (the contiguous engine's prefill)
    for dt in (torch.float32, bf):
        for Sq, Skv, q_off in ((32, 256, 224), (32, 32, 0), (160, 160, 0)):
            q, k, v = (randn(H, Sq, D, dtype=dt), randn(H, Skv, D, dtype=dt),
                       randn(H, Skv, D, dtype=dt))
            off = torch.tensor([q_off], dtype=torch.int32, device="cuda")

            def call():
                return ops.flash_attention(q, k, v, q_offset=off)

            def plain():
                return ref.ref_flash_attention(q, k, v, q_offset=q_off)

            case = (f"64h H={H} Sq={Sq} Skv={Skv} D={D} q_offset={q_off} "
                    f"{dtype_name(dt)}")
            err = checked("flash_attention", case, dt, call, plain)
            if dt != bf or (Sq, q_off) == (32, 0):
                continue
            mask = (torch.arange(Skv, device="cuda")[None, :]
                    <= torch.arange(Sq, device="cuda")[:, None] + q_off)
            pairs, kv_read = int(mask.sum()), int(mask.any(0).sum())
            b_ms, b_by = bound((2 * q.numel() + 2 * H * kv_read * D) * 2,
                               4 * D * H * pairs, bf)
            if q_off:
                def sdpa():
                    return F.scaled_dot_product_attention(
                        q[None], k[None], v[None], attn_mask=mask[None, None])
            else:
                def sdpa():
                    return F.scaled_dot_product_attention(
                        q[None], k[None], v[None], is_causal=True)
            compare("SDPA yardstick 64h", sdpa()[0], plain(), bf, torch)
            p = _fl.plan(H, Sq, Skv, D, bf)
            add("flash_attention", dict(
                shape=f"64h H={H} Sq={Sq} Skv={Skv} D={D} q_offset={q_off} bf16",
                max_abs_err=err,
                plan=f"wq={p.wq} split={p.split} blocks="
                     f"{p.split * H * -(-Sq // (16 * p.wq))}",
                ms=time_ms(call, torch), plain_ms=time_plain(plain, torch),
                library_ms=time_ms(sdpa, torch), bound_ms=b_ms, bound_by=b_by))

    # ---- paged decode and verify: 8 slots over a shuffled pool of pages of
    # 16, ragged lengths, the last slot an idle lane on scratch page 0
    B, psz, n_max = 8, 16, 16
    n_pages = B * n_max + 1
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(8)) + 1
    bt_full = perm[:B * n_max].reshape(B, n_max).to(torch.int32).cuda()
    bt_full[-1] = 0

    def table(lengths, nq):
        out = bt_full.clone()
        for b, L in enumerate(lengths):
            out[b, min(-(-(L + nq - 1) // psz), n_max):] = 0
        return out

    def int8_pool():
        pool = torch.randint(-127, 128, (n_pages, H, psz, D), generator=gen,
                             device="cuda", dtype=torch.int8)
        scale = 0.05 * torch.rand(n_pages, psz, generator=gen, device="cuda")
        return pool, scale

    lengths = [1, 15, 16, 17, 100, 250, 249, 1]
    for nq in (1, 5, 8):
        lens = [min(L, n_max * psz - nq + 1) for L in lengths]
        length = torch.tensor(lens, dtype=torch.int32, device="cuda")
        bt = table(lens, nq)
        for dt in (torch.float32, bf):
            q = randn(B, H, D, dtype=dt) if nq == 1 else randn(B, H, nq, D, dtype=dt)
            (kq, ks), (vq, vs) = int8_pool(), int8_pool()
            ks[int(bt[4, 0]), psz // 2:] = 0.0           # a recycled page's reset rows
            pools = {False: ((randn(n_pages, H, psz, D, dtype=dt),
                              randn(n_pages, H, psz, D, dtype=dt)), {}),
                     True: ((kq, vq), dict(k_scale=ks, v_scale=vs))}
            for quant, ((kp, vp), sc) in pools.items():
                if nq == 1:
                    kname = "paged_decode_attention"
                    fn, pfn = ops.paged_decode_attention, ref.ref_paged_decode_attention
                else:
                    kname = "paged_verify_attention"
                    fn, pfn = ops.paged_verify_attention, ref.ref_paged_verify_attention
                kname += "_i8" if quant else ""

                def call():
                    return fn(q, kp, vp, bt, length, **sc)

                def plain():
                    return pfn(q, kp, vp, bt, length, **sc)

                case = (f"64h B={B} H={H} Q={nq} D={D} psz={psz} n_max={n_max} "
                        f"lengths={lens} q {dtype_name(dt)}"
                        f"{', int8 pools' if quant else ''}")
                err = checked(kname, case, dt, call, plain)
                if nq == 1:
                    replay_check(kname, case, call, length,
                                 [40, 3, 200, 16, 1, 129, 64, 1])
                if dt != bf or nq == 8:
                    continue
                n_kv = [min(L + nq - 1, n_max * psz) for L in lens]
                pairs = sum(min(L + i, n_max * psz) for L in lens for i in range(nq))
                elt = 1 if quant else 2
                b_ms, b_by = bound(2 * q.numel() * 2 + 2 * H * sum(n_kv) * D * elt
                                   + (2 * sum(n_kv) * 4 if quant else 0)
                                   + bt.numel() * 4 + B * 4,
                                   4 * D * H * pairs
                                   + (2 * D * H * sum(n_kv) if quant else 0),
                                   torch.int8 if quant else bf)
                p = _dec.plan(B, H, nq, D, psz, n_max, bf, quant)
                add(kname, dict(
                    shape=f"64h B={B} H={H} Q={nq} D={D} psz={psz} n_max={n_max} "
                          f"lengths={lens} q bf16, {'int8' if quant else 'bf16'} pools",
                    max_abs_err=err,
                    plan=f"nw={p.nw} split={p.split} blocks={p.split * B * H}",
                    ms=time_ms(call, torch), plain_ms=time_plain(plain, torch),
                    library_ms=None, bound_ms=b_ms, bound_by=b_by))

    # ---- contiguous decode over float and fixed-scale int8 lanes, S 256
    S, DQ = 256, 1.0 / 16.0
    lens = [256, 1, 13, 255, 0, 64, 200, 100]
    lc = torch.tensor(lens, dtype=torch.int32, device="cuda")
    for dt in (torch.float32, bf):
        qc = randn(B, H, D, dtype=dt)
        for quant in (False, True):
            if quant:
                kc, vc = (torch.randint(-127, 128, (B, H, S, D), generator=gen,
                                        device="cuda", dtype=torch.int8)
                          for _ in range(2))
                kname = "decode_attention_i8"

                def call():
                    return ops.decode_attention_i8(qc, kc, vc, lc, DQ)

                def plain():
                    return ref.ref_decode_attention_i8(qc, kc, vc, lc, DQ)
            else:
                kc, vc = randn(B, H, S, D, dtype=dt), randn(B, H, S, D, dtype=dt)
                kin, vin = kc.clone(), vc.clone()
                for b, L in enumerate(lens):           # NaN past each row's length
                    kin[b, :, L:] = float("nan")
                    vin[b, :, L:] = float("nan")
                kname = "decode_attention"

                def call():
                    return ops.decode_attention(qc, kin, vin, lc)

                def plain():
                    return ref.ref_decode_attention(qc, kc, vc, lc)
            case = (f"64h B={B} H={H} S={S} D={D} lengths={lens} q "
                    f"{dtype_name(dt)}{', int8 lanes' if quant else ''}")
            err = checked(kname, case, dt, call, plain)
            if dt != bf:
                continue
            toks = sum(lens)
            elt = 1 if quant else 2
            b_ms, b_by = bound(2 * qc.numel() * 2 + 2 * H * toks * D * elt + B * 4,
                               (6 if quant else 4) * D * H * toks,
                               torch.int8 if quant else bf)
            kmask = (torch.arange(S, device="cuda")[None, :] < lc[:, None])[:, None, None]
            p = _dec.contiguous_plan(B, H, S, D, bf, quant)
            add(kname, dict(
                shape=f"64h B={B} H={H} S={S} D={D} lengths={lens} q bf16, "
                      f"{'int8' if quant else 'bf16'} lanes",
                max_abs_err=err,
                plan=f"nw={p.nw} split={p.split} blocks={p.split * B * H}",
                ms=time_ms(call, torch), plain_ms=time_plain(plain, torch),
                library_ms=None if quant else time_ms(
                    lambda: F.scaled_dot_product_attention(
                        qc[:, :, None], kc, vc, attn_mask=kmask), torch),
                bound_ms=b_ms, bound_by=b_by))
    for name, r in timed:
        lib = "none" if r["library_ms"] is None else f"{1e3 * r['library_ms']:.2f}"
        print(f"  {name} time {r['shape']}: us={1e3 * r['ms']:.2f} "
              f"bound_us={1e3 * r['bound_ms']:.2f} plain_us={1e3 * r['plain_ms']:.2f} "
              f"library_us={lib} [{r['plan']}]")


# seamless-m4t-large-v2's widths: 16 q = 16 kv heads of 64, d_model 1024, a
# plain FFN of 8192, the tied 256,206-row head, an encoder memory of 4096
# frames (256 pages of 16 a request)
SM_H, SM_D, SM_E, SM_F, SM_V, SM_S = 16, 64, 1024, 8192, 256_206, 4096
SM_MATMULS = (("seamless wq/wk/wv/wo", SM_E, SM_E, False),
              ("seamless w_up", SM_E, SM_F, False),
              ("seamless w_down", SM_F, SM_E, False),
              ("seamless LM head (tied)", SM_E, SM_V, True))


def _seamless_kernels(torch, F, randn, gen, note, one_kernel, replay_check,
                      rows):
    """The kernel cases at seamless-m4t-large-v2's shapes, against their
    plain versions: flash without the causal mask (the cross-attention of
    a prefill chunk, Sq 32 over the 4096 frames' keys, and of a
    contiguous whole-prompt prefill, Sq 100), the encoder's causal flash
    over all 4096 frames (float32 at 512, the parity phase's memory);
    paged decode through a 256-page cross block table (B 8, 16 heads of
    64, pages of 16, every key visible: length 4096, an idle lane on
    scratch page 0; a graph replayed after the lengths change) over float
    and int8 pools; the contiguous decode at S 4096 (the contiguous
    engine's cross lanes); matmul at M 4096 (the encoder's projections and
    FFN), at M 8 and 32 (the decoder's), and the tied head at M 8 and 1
    (N % 8 = 6).  float32 and bf16; every bf16 case runs twice
    (bitwise-equal outputs) and every case is one kernel node in a CUDA
    graph.  Times (bf16, L2-warm) beside the bound, the plain version and
    the library call (SDPA, ``is_causal`` for the encoder; ``torch.matmul``);
    appended to each kernel's ``by_shape``."""
    from repro_torch.kernels import decode_attention as _dec
    from repro_torch.kernels import flash_attention as _fl
    from repro_torch.kernels import matmul as _mm
    from repro_torch.kernels import ops, ref
    H, D = SM_H, SM_D
    bf = torch.bfloat16
    timed = []

    def add(name, r):
        row = rows[name]
        row.setdefault("by_shape", [{k: v for k, v in row.items()}])
        row["by_shape"].append(r)
        timed.append((name, r))

    def checked(kname, case, dt, call, plain):
        got = call()
        err = compare(kname, got, plain(), dt, torch)
        note(kname, case, err)
        if dt == bf:
            check(torch.equal(got, call()), f"{kname} {case}: two calls differ")
        one_kernel(kname, case, call)
        return err

    # ---- flash: cross-attention without the causal mask over the 4096
    # frames' keys (a prefill chunk of 32, a whole prompt of 100), and the
    # encoder's causal self-attention over every frame
    cases = [(torch.float32, 32, SM_S, False), (bf, 32, SM_S, False),
             (torch.float32, 100, SM_S, False), (bf, 100, SM_S, False),
             (torch.float32, 512, 512, True), (bf, SM_S, SM_S, True)]
    for dt, Sq, Skv, causal in cases:
        q, k, v = (randn(H, Sq, D, dtype=dt), randn(H, Skv, D, dtype=dt),
                   randn(H, Skv, D, dtype=dt))

        def call():
            return ops.flash_attention(q, k, v, causal=causal)

        def plain():
            return ref.ref_flash_attention(q, k, v, causal=causal)

        what = "encoder, causal" if causal else "cross, causal=False"
        case = f"seamless {what} H={H} Sq={Sq} Skv={Skv} D={D} {dtype_name(dt)}"
        err = checked("flash_attention", case, dt, call, plain)
        if dt != bf:
            continue
        pairs = Sq * (Sq + 1) // 2 if causal else Sq * Skv
        b_ms, b_by = bound((2 * q.numel() + 2 * H * Skv * D) * 2,
                           4 * D * H * pairs, bf)

        def sdpa():
            return F.scaled_dot_product_attention(q[None], k[None], v[None],
                                                  is_causal=causal)

        compare("SDPA yardstick seamless", sdpa()[0], plain(), bf, torch)
        p = _fl.plan(H, Sq, Skv, D, bf)
        add("flash_attention", dict(
            shape=case, max_abs_err=err,
            plan=f"wq={p.wq} split={p.split} blocks="
                 f"{p.split * H * -(-Sq // (16 * p.wq))}",
            ms=time_ms(call, torch), plain_ms=time_plain(plain, torch),
            library_ms=time_ms(sdpa, torch), bound_ms=b_ms, bound_by=b_by))
        del q, k, v
    torch.cuda.empty_cache()

    # ---- paged decode through the cross block table: 8 slots, 256 pages
    # of 16 each over a shuffled pool, every one of the 4096 keys visible
    # (cur_pos = S_enc - 1), the last slot an idle lane on scratch page 0
    B, psz, n_max = 8, 16, SM_S // 16
    n_pages = B * n_max + 1
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(9)) + 1
    bt = perm[:B * n_max].reshape(B, n_max).to(torch.int32).cuda()
    bt[-1] = 0
    lens = [SM_S] * B
    length = torch.tensor(lens, dtype=torch.int32, device="cuda")
    for dt in (torch.float32, bf):
        q = randn(B, H, D, dtype=dt)
        kq = torch.randint(-127, 128, (n_pages, H, psz, D), generator=gen,
                           device="cuda", dtype=torch.int8)
        vq = torch.randint(-127, 128, (n_pages, H, psz, D), generator=gen,
                           device="cuda", dtype=torch.int8)
        ks = 0.05 * torch.rand(n_pages, psz, generator=gen, device="cuda")
        vs = 0.05 * torch.rand(n_pages, psz, generator=gen, device="cuda")
        pools = {False: ((randn(n_pages, H, psz, D, dtype=dt),
                          randn(n_pages, H, psz, D, dtype=dt)), {}),
                 True: ((kq, vq), dict(k_scale=ks, v_scale=vs))}
        for quant, ((kp, vp), sc) in pools.items():
            kname = "paged_decode_attention" + ("_i8" if quant else "")

            def call():
                return ops.paged_decode_attention(q, kp, vp, bt, length, **sc)

            def plain():
                return ref.ref_paged_decode_attention(q, kp, vp, bt, length,
                                                      **sc)

            case = (f"seamless cross B={B} H={H} D={D} psz={psz} n_max={n_max} "
                    f"length {SM_S} q {dtype_name(dt)}"
                    f"{', int8 pools' if quant else ''}")
            err = checked(kname, case, dt, call, plain)
            replay_check(kname, case, call, length,
                         [SM_S, 1, 17, 2000, 4095, 256, 3000, SM_S])
            if dt != bf:
                continue
            toks, elt = sum(lens), 1 if quant else 2
            b_ms, b_by = bound(2 * q.numel() * 2 + 2 * H * toks * D * elt
                               + (2 * toks * 4 if quant else 0)
                               + bt.numel() * 4 + B * 4,
                               4 * D * H * toks + (2 * D * H * toks if quant else 0),
                               torch.int8 if quant else bf)
            p = _dec.plan(B, H, 1, D, psz, n_max, bf, quant)
            add(kname, dict(
                shape=case, max_abs_err=err,
                plan=f"nw={p.nw} split={p.split} blocks={p.split * B * H}",
                ms=time_ms(call, torch), plain_ms=time_plain(plain, torch),
                library_ms=None, bound_ms=b_ms, bound_by=b_by))
        del pools, kq, vq
    torch.cuda.empty_cache()

    # ---- the contiguous decode over the cross lanes: S 4096, every key
    # valid (JAX's cur_pos = S_enc: length min(S_enc + 1, S_enc))
    lc = torch.full((B,), SM_S, dtype=torch.int32, device="cuda")
    for dt in (torch.float32, bf):
        qc = randn(B, H, D, dtype=dt)
        kc, vc = randn(B, H, SM_S, D, dtype=dt), randn(B, H, SM_S, D, dtype=dt)

        def call():
            return ops.decode_attention(qc, kc, vc, lc)

        def plain():
            return ref.ref_decode_attention(qc, kc, vc, lc)

        case = f"seamless cross lanes B={B} H={H} S={SM_S} D={D} q {dtype_name(dt)}"
        err = checked("decode_attention", case, dt, call, plain)
        if dt != bf:
            continue
        toks = B * SM_S
        b_ms, b_by = bound(2 * qc.numel() * 2 + 2 * H * toks * D * 2 + B * 4,
                           4 * D * H * toks, bf)
        p = _dec.contiguous_plan(B, H, SM_S, D, bf, False)
        add("decode_attention", dict(
            shape=case, max_abs_err=err,
            plan=f"nw={p.nw} split={p.split} blocks={p.split * B * H}",
            ms=time_ms(call, torch), plain_ms=time_plain(plain, torch),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qc[:, :, None], kc, vc), torch),
            bound_ms=b_ms, bound_by=b_by))
        del kc, vc

    # ---- matmul: the encoder's products at M 4096 (every frame), the
    # decoder's at M 8 (a decode tick) and 32 (a chunk), the tied head at
    # M 8 and 1; float32 at M 512 (the parity phase's encoder)
    for tag, K, N, nt in SM_MATMULS:
        b = (0.02 * (randn(N, K) if nt else randn(K, N))).to(bf)
        for M in ((8, 1) if nt else (SM_S, 32, 8)):
            a = randn(M, K, dtype=bf)
            case = f"{tag} M={M} K={K} N={N}{' NT' if nt else ''} bf16"
            got = ops.matmul(a, b, trans_b=nt)
            err = compare("matmul", got, ref.ref_matmul(a, b, nt), bf, torch)
            note("matmul", case, err)
            check(torch.equal(got, ops.matmul(a, b, trans_b=nt)),
                  f"matmul {case}: two calls differ")
            one_kernel("matmul", case, lambda: ops.matmul(a, b, trans_b=nt))
            if M not in (SM_S, 8):
                continue
            b_ms, b_by = bound((M * K + K * N + M * N) * 2, 2 * M * N * K, bf)
            p = _mm.plan(M, N, K, bf, nt)
            w = f"({N}, {K})^T" if nt else f"({K}, {N})"
            add("matmul", dict(
                shape=f"{tag} a ({M}, {K}) @ {w} bf16",
                M=M, K=K, N=N, trans_b=nt, max_abs_err=err,
                plan=f"bn={p.bn} split={p.split} kt={p.kt} bm={p.bm} "
                     f"blocks={p.blocks} smem={p.smem} vec={p.vec}",
                ms=time_ms(lambda: ops.matmul(a, b, trans_b=nt), torch),
                plain_ms=time_plain(lambda: ref.ref_matmul(a, b, nt), torch),
                library_ms=time_ms(lambda: torch.matmul(a, b.t() if nt else b),
                                   torch),
                bound_ms=b_ms, bound_by=b_by))
        if not nt:
            a32, b32 = randn(512, K), b.float()
            case = f"{tag} M=512 K={K} N={N} float32"
            note("matmul", case, compare("matmul", ops.matmul(a32, b32),
                                         ref.ref_matmul(a32, b32), torch.float32,
                                         torch))
            one_kernel("matmul", case, lambda: ops.matmul(a32, b32))
        del b
        torch.cuda.empty_cache()
    for name, r in timed:
        lib = "none" if r["library_ms"] is None else f"{1e3 * r['library_ms']:.2f}"
        print(f"  {name} time {r['shape']}: us={1e3 * r['ms']:.2f} "
              f"bound_us={1e3 * r['bound_ms']:.2f} plain_us={1e3 * r['plain_ms']:.2f} "
              f"library_us={lib} [{r['plan']}]")


# deepseek-moe-16b's experts: 64 of width 1408 over d_model 2048, top-6,
# 2 shared (one dense FFN of 2816); mixtral-8x22b's: 8 of 16384 over 6144
DS_N, DS_E, DS_F, DS_K, DS_SHARED = 64, 2048, 1408, 6, 2
MX_N, MX_E, MX_F, MX_K = 8, 6144, 16384, 2


def _moe_kernels(torch, randn, gen, note, one_kernel, rows):
    """The expert matmul (``ops.expert_matmul``) against its plain version
    at deepseek-moe-16b's shapes (64 experts, E 2048 and F 1408 both ways
    round: w_gate/w_up and w_down) for capacities 8 (a decode tick of 8
    slots) and 16 (a chunk of 32, a verify of 8 x 5), with the shared
    experts' dense products beside them (matmul at M 8 and 16, 2048 x 2816
    and 2816 x 2048) and the router's float32 product (matmul at M 8, 32
    and 40 over 2048 x 64: K split over a cluster), and at mixtral-8x22b's
    (8 experts, E 6144 and F 16384, capacity 16; its router 6144 x 8).  Counts: a decode tick's routing of 8 rows
    (deepseek's top-6: about 34 of 64 experts hold 1-2 rows, the rest are
    empty; mixtral's top-2 over 8), buckets
    empty, partly filled and full in turn, all full, all empty; every row
    past a count holds NaN in the input (never read: the output is finite,
    zeros past the counts).  float32 and bf16; bf16 runs twice (bitwise
    equal) and every case is one kernel node in a CUDA graph.  Times (every
    bf16 case at deepseek's shapes, mixtral's decode routing and full
    buckets; L2-warm) beside the bound (the weight bytes of the non-empty experts,
    the filled activation rows and the whole output, over the card's
    bandwidth), the plain version and ``torch.bmm`` over every expert;
    appended to the kernel's ``by_shape`` (the JSON line's row: deepseek's
    w_gate/w_up at a decode tick)."""
    from repro_torch.kernels import matmul as _mm
    from repro_torch.kernels import ops, ref
    bf = torch.bfloat16
    timed = []

    def add(name, r):
        if name not in rows:
            rows[name] = dict(r, by_shape=[])
        rows[name]["by_shape"].append(r)
        timed.append((name, r))

    def routed(n, C, k, rows_, seed):
        """Fill counts of a top-k routing of ``rows_`` rows, clamped to C."""
        g = torch.Generator().manual_seed(seed)
        c = torch.zeros(n, dtype=torch.int32)
        for _ in range(rows_):
            c[torch.randperm(n, generator=g)[:k]] += 1
        return c.clamp(max=C)

    def fills(n, C, k, seed):
        return {"decode-routing": routed(n, C, k, 8, seed),
                "empty/partial/full": torch.tensor(
                    [(0, 1, C // 2, C)[i % 4] for i in range(n)],
                    dtype=torch.int32),
                "all full": torch.full((n,), C, dtype=torch.int32),
                "all empty": torch.zeros(n, dtype=torch.int32)}

    def case(tag, n, C, K, N, dt, counts, w, timed_case):
        cnt = counts.cuda()
        live = torch.arange(C, device="cuda")[None, :] < cnt[:, None]
        x = torch.where(live[..., None], randn(n, C, K, dtype=dt),
                        torch.full((), float("nan"), dtype=dt, device="cuda"))
        got = ops.expert_matmul(x, w, cnt)
        err = compare("expert_matmul", got, ref.ref_expert_matmul(x, w, cnt),
                      dt, torch)
        check(not got[~live].any(), f"expert_matmul {tag}: rows past the "
                                    f"counts are not zero")
        desc = (f"{tag} n={n} C={C} K={K} N={N} fill={int(cnt.sum())} rows in "
                f"{int((cnt > 0).sum())} experts {dtype_name(dt)}")
        note("expert_matmul", desc, err)
        if dt == bf:
            check(torch.equal(got, ops.expert_matmul(x, w, cnt)),
                  f"expert_matmul {desc}: two calls differ")
        one_kernel("expert_matmul", desc, lambda: ops.expert_matmul(x, w, cnt))
        if not timed_case:
            return
        rows_ = int(cnt.sum())
        b_ms, b_by = bound(int((cnt > 0).sum()) * K * N * 2 + rows_ * K * 2
                           + n * C * N * 2 + n * 4, 2 * rows_ * K * N, bf)
        xz = torch.nan_to_num(x, nan=0.0)
        p = _mm.expert_plan(C, N, K, bf)
        add("expert_matmul", dict(
            shape=f"{tag} x ({n}, {C}, {K}) @ w ({n}, {K}, {N}) bf16, "
                  f"{rows_} rows in {int((cnt > 0).sum())} of {n} experts",
            max_abs_err=err,
            plan=f"bn={p.bn} split={p.split} kt={p.kt} bm={p.bm} "
                 f"blocks={p.blocks} x {n} experts smem={p.smem}",
            ms=time_ms(lambda: ops.expert_matmul(x, w, cnt), torch),
            plain_ms=time_plain(lambda: ref.ref_expert_matmul(x, w, cnt),
                                torch),
            library_ms=time_ms(lambda: torch.bmm(xz, w), torch),
            bound_ms=b_ms, bound_by=b_by))

    # deepseek: w_gate/w_up (E -> F) and w_down (F -> E), capacities 8, 16
    for tag, K, N in (("deepseek w_gate/w_up", DS_E, DS_F),
                      ("deepseek w_down", DS_F, DS_E)):
        for dt in (torch.float32, bf):
            w = (0.02 * randn(DS_N, K, N)).to(dt)
            for C in (8, 16):
                for fname, counts in fills(DS_N, C, DS_K, C + K).items():
                    case(f"{tag} [{fname}]", DS_N, C, K, N, dt, counts, w,
                         dt == bf)
            del w
    # the shared experts' dense FFN beside them, at M 8 and 16
    Fs = DS_SHARED * DS_F
    for tag, K, N in (("deepseek shared w_gate/w_up", DS_E, Fs),
                      ("deepseek shared w_down", Fs, DS_E)):
        b = (0.02 * randn(K, N)).to(bf)
        for M in (8, 16):
            a = randn(M, K, dtype=bf)
            case_ = f"{tag} M={M} K={K} N={N} bf16"
            err = compare("matmul", ops.matmul(a, b), ref.ref_matmul(a, b), bf,
                          torch)
            note("matmul", case_, err)
            one_kernel("matmul", case_, lambda: ops.matmul(a, b))
            b_ms, b_by = bound((M * K + K * N + M * N) * 2, 2 * M * N * K, bf)
            p = _mm.plan(M, N, K, bf, False)
            add("matmul", dict(
                shape=f"{tag} a ({M}, {K}) @ ({K}, {N}) bf16", M=M, K=K, N=N,
                trans_b=False, max_abs_err=err,
                plan=f"bn={p.bn} split={p.split} kt={p.kt} bm={p.bm} "
                     f"blocks={p.blocks} smem={p.smem} vec={p.vec}",
                ms=time_ms(lambda: ops.matmul(a, b), torch),
                plain_ms=time_plain(lambda: ref.ref_matmul(a, b), torch),
                library_ms=time_ms(lambda: torch.matmul(a, b), torch),
                bound_ms=b_ms, bound_by=b_by))
    # the routers' float32 products (JAX's, from bf16 activations and
    # weights): deepseek's (T, 2048) @ (2048, 64) at a decode tick, a chunk
    # and a verify of 8 x 5, mixtral's (T, 6144) @ (6144, 8); K split over
    # a cluster (a single tile)
    for tag, K, N in (("deepseek router", DS_E, DS_N), ("mixtral router", MX_E,
                                                       MX_N)):
        b = randn(K, N, dtype=bf).float()
        for M in (8, 32, 40):
            a = randn(M, K, dtype=bf).float()
            p = _mm.plan(M, N, K, torch.float32, False)
            case_ = f"{tag} M={M} K={K} N={N} float32 split={p.split}"
            got = ops.matmul(a, b)
            err = compare("matmul", got, ref.ref_matmul(a, b), torch.float32,
                          torch)
            note("matmul", case_, err)
            check(torch.equal(got, ops.matmul(a, b)),
                  f"matmul {case_}: two calls differ")
            one_kernel("matmul", case_, lambda: ops.matmul(a, b))
            if M != 8:
                continue
            b_ms, b_by = bound((M * K + K * N + M * N) * 4, 2 * M * N * K,
                               torch.float32)
            add("matmul", dict(
                shape=f"{tag} a ({M}, {K}) @ ({K}, {N}) float32", M=M, K=K,
                N=N, trans_b=False, max_abs_err=err,
                plan=f"simt bm={p.bm} split={p.split} kt={p.kt} "
                     f"blocks={p.blocks}",
                ms=time_ms(lambda: ops.matmul(a, b), torch),
                plain_ms=time_plain(lambda: ref.ref_matmul(a, b), torch),
                library_ms=time_ms(lambda: torch.matmul(a, b), torch),
                bound_ms=b_ms, bound_by=b_by))
    # mixtral: 8 experts of 16384 over 6144 (1.61 GB of bf16 a projection)
    for tag, K, N in (("mixtral w_gate/w_up", MX_E, MX_F),
                      ("mixtral w_down", MX_F, MX_E)):
        for dt in (torch.float32, bf):
            w = (0.02 * randn(MX_N, K, N)).to(dt)
            for fname, counts in fills(MX_N, 16, MX_K, K).items():
                case(f"{tag} [{fname}]", MX_N, 16, K, N, dt, counts, w,
                     dt == bf and fname in ("decode-routing", "all full"))
            del w
            torch.cuda.empty_cache()
    for name, r in timed:
        lib = "none" if r["library_ms"] is None else f"{1e3 * r['library_ms']:.2f}"
        print(f"  {name} time {r['shape']}: us={1e3 * r['ms']:.2f} "
              f"bound_us={1e3 * r['bound_ms']:.2f} plain_us={1e3 * r['plain_ms']:.2f} "
              f"library_us={lib} [{r['plan']}]")


def _requests(Request, rng, n, lo, hi, max_new, vocab):
    import numpy as np
    return [Request(rid=i, prompt=rng.randint(2, vocab, int(L)).astype(np.int32),
                    max_new_tokens=max_new)
            for i, L in enumerate(rng.randint(lo, hi + 1, n))]


def _motif_requests(Request, rng, n, lo, hi, max_new, vocab):
    """Repetitive prompts, the traffic prompt-lookup drafting serves: a
    shared 8-token prefix, then a 3- or 4-token motif tiled to a length in
    [lo, hi] (``tests/test_spec_decode.py``'s shape at serving lengths)."""
    import numpy as np
    shared = rng.randint(2, vocab, 8)
    out = []
    for i, L in enumerate(rng.randint(lo, hi + 1, n)):
        motif = rng.randint(2, vocab, 3 + i % 2)
        body = np.tile(motif, -(-int(L) // len(motif)))[:int(L) - 8]
        out.append(Request(rid=i, prompt=np.concatenate([shared, body]).astype(
            np.int32), max_new_tokens=max_new))
    return out


def _run_engine(torch, cfg, plan, params, reqs, device, slots=4, paged=True,
                setup=None, **kw):
    """Serve ``reqs`` on a fresh engine, paged or contiguous (``kw``: e.g.
    ``graphs``, ``overlap``, ``speculative``; ``setup(engine)`` runs before
    the requests are submitted).  -> (engine, tokens per
    request, live logits of every step in dispatch order (prefill chunks or
    whole prompts; decode rows and verify columns of live slots), logits
    row behind each emitted token of the one-token path per rid).  The
    logits are read from each step's output right after it runs."""
    from repro_torch.serving import ServingEngine
    if paged:
        eng = ServingEngine.build_paged(cfg, plan, slots, 256, params,
                                        page_size=16, prefill_chunk=32,
                                        device=device, **kw)
    else:
        eng = ServingEngine(cfg, plan, slots, 256, params, device=device, **kw)
    steps, emitted = [], {}

    def keep(rid, row):
        emitted.setdefault(rid, []).append(row.numpy().copy())

    def rec_step(dispatch):
        def wrapped(*args):
            step = dispatch(*args)
            if step is not None:
                kind, live = step[0], step[1]
                lg = eng.steps[kind].outputs[0].float().cpu()
                if kind == "decode":
                    steps.append(torch.cat([lg[b] for b, _ in live]))
                    for b, rid in live:
                        keep(rid, lg[b])
                else:
                    steps.append(torch.cat([
                        lg[b, :len(step[2].get(b, [])) + 1].reshape(-1)
                        for b, _ in live]))
            return step
        return wrapped

    if paged:
        prefill_round = eng._prefill_round

        def rec_round(i, entry):
            prefill_round(i, entry)
            row = eng.steps["chunk"].outputs[0].float().cpu().reshape(-1)
            steps.append(row)
            if entry[2] is not None:          # this chunk completes a prompt
                keep(entry[1], row)

        eng._prefill_round = rec_round
        eng._dispatch_step = rec_step(eng._dispatch_step)
    else:
        prefill, prefill_into, last = eng.prefill_fn, eng._prefill_into, []

        def rec_prefill(*args):
            logits, cache = prefill(*args)
            last[:] = [logits.float().cpu().reshape(-1)]
            steps.append(last[0])
            return logits, cache

        def rec_prefill_into(b, req):
            prefill_into(b, req)
            keep(req.rid, last[0])

        eng.prefill_fn, eng._prefill_into = rec_prefill, rec_prefill_into
        eng._dispatch_decode = rec_step(eng._dispatch_decode)
    if setup is not None:
        setup(eng)
    for r in reqs:
        eng.submit(r)
    eng.run()
    check(all(r.done for r in reqs), f"parity: unfinished requests on {device}")
    check(eng._inflight is None and eng.drain() == 0,
          f"parity: work in flight or slots still admitted on {device}")
    leak_check("parity", eng)
    return eng, [r.out_tokens for r in reqs], torch.cat(steps), emitted


def leak_check(name, eng):
    """After ``drain()``, on every replica: every page free or held by the
    prefix cache or the cross-KV cache, and free after the caches are
    evicted whole; every slab free."""
    for r in range(eng.R if eng.paged else 0):
        alloc = eng.allocators[r]
        usable = alloc.n_pages - alloc.n_reserved
        caches = [c for c in (eng.prefix_caches[r], eng.cross_caches[r]
                              if eng.cross_caches else None) if c]
        cached = sum(c.n_cached_pages for c in caches)
        check(alloc.n_free + cached == usable,
              f"{name}: replica {r}'s pool leaked "
              f"{usable - cached - alloc.n_free} pages on {eng.device}")
        for c in caches:
            c.evict(usable)
        if caches:
            check(alloc.n_free == usable and
                  all(c.n_cached_pages == 0 for c in caches),
                  f"{name}: pages left after a full evict on {eng.device}")
    check(all(s.n_free == eng.n_slabs - 1 for s in eng.slab_allocators),
          f"{name}: slabs not leak-free after drain() on {eng.device}")


def _eager_serial(torch, name, want, *args, **kw):
    """The same engine on the card with ``graphs=False, overlap=False``
    (eager steps, the serial loop): its greedy tokens must equal ``want``,
    the default engine's (graphs and overlap on)."""
    got = _run_engine(torch, *args, "cuda", graphs=False, overlap=False, **kw)[1]
    check(got == want, f"{name}: graphed-overlap and eager-serial engines differ "
                       f"on cuda\n  {want}\n  {got}")


def _same(name, a, b, tol):
    """Tokens identical, then live logits of every step within ``tol``."""
    (ta, la), (tb, lb) = a, b
    check(ta == tb, f"{name}: greedy tokens differ\n  {ta}\n  {tb}")
    check(la.shape == lb.shape, f"{name}: step schedules differ")
    err = (la - lb).abs()
    check(bool((err <= tol["atol"] + tol["rtol"] * lb.abs()).all()),
          f"{name}: logits differ by {err.max().item():.3e} beyond {tol}")
    return err.max().item(), lb.abs().max().item()


def phase_parity(torch):
    """fp32 at full width: the card (kernels) against the CPU (plain
    versions) for the one-token engine, the speculative engine and the int8
    pool engine; the speculative engine against the one-token engine on
    the card; the int8 pools' logit drift against float pools."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import model
    from repro_torch.core.partition import ShardingPlan
    from repro_torch.serving import Request
    cfg = get_config("tinyllama-42m")
    plan = ShardingPlan(kv_cache_dtype="float32")
    plan_i8 = ShardingPlan(kv_cache_dtype="int8")
    base = model.init_params(cfg, plan, torch.Generator().manual_seed(0),
                             device="cpu", dtype="float32")
    # weights x10 so greedy decoding does not collapse onto repeating the
    # prompt's last token (which the 0.02-scale init does at this width)
    params = model.tree_map(lambda t: t * 10, base)
    prompts = [np.random.RandomState(7 + i).randint(2, cfg.vocab_size, L)
               for i, L in enumerate((23, 40, 77, 130))]

    def reqs():
        return [Request(rid=i, prompt=pr.astype(np.int32), max_new_tokens=16)
                for i, pr in enumerate(prompts)]

    runs = {dev: _run_engine(torch, cfg, plan, params, reqs(), dev)
            for dev in ("cuda", "cpu")}
    err, mx = _same("parity", runs["cuda"][1:3], runs["cpu"][1:3], PARITY_TOL)
    toks = runs["cuda"][1]
    _eager_serial(torch, "parity", toks, cfg, plan, params, reqs())
    print(f"parity: tinyllama-42m float32 engine on cuda vs cpu: live logits "
          f"of every step ({runs['cuda'][2].numel()} values) max_abs_err="
          f"{err:.3e} (|logit| max {mx:.2f}, tol rtol={PARITY_TOL['rtol']} "
          f"atol={PARITY_TOL['atol']}); greedy tokens identical, and to the "
          f"eager-serial engine on cuda: 4 requests x 16 tokens, "
          f"{len({t for r in toks for t in r})} distinct")

    # weights x1.75: greedy decoding repeats motifs often enough for drafts
    # to be accepted and rejected, without collapsing onto one token; and
    # int8 pools stay clear of the x10 weights' sensitivity, where one
    # quantization step flipped by float rounding (card against CPU) can
    # change later tokens
    mid = model.tree_map(lambda t: t * 1.75, base)

    def spec_reqs():
        return _motif_requests(Request, np.random.RandomState(11), 4, 24, 48,
                               16, cfg.vocab_size)

    spec = {dev: _run_engine(torch, cfg, plan, mid, spec_reqs(), dev,
                             speculative=4) for dev in ("cuda", "cpu")}
    one = _run_engine(torch, cfg, plan, mid, spec_reqs(), "cuda")
    err, mx = _same("parity-spec", spec["cuda"][1:3], spec["cpu"][1:3],
                    PARITY_TOL)
    check(spec["cuda"][1] == one[1], f"parity-spec: speculative and one-token "
          f"engines differ on cuda\n  {spec['cuda'][1]}\n  {one[1]}")
    _eager_serial(torch, "parity-spec", spec["cuda"][1], cfg, plan, mid,
                  spec_reqs(), speculative=4)
    st = spec["cuda"][0].stats
    check(st.spec_accepted > 0, f"parity-spec: no draft accepted {st}")
    print(f"parity-spec: speculative=4 engine on cuda vs cpu: live logits "
          f"max_abs_err={err:.3e} (|logit| max {mx:.2f}); greedy tokens "
          f"identical to cpu, to the eager-serial engine and to the one-token "
          f"engine on cuda (4 requests x "
          f"16 tokens, {len({t for r in one[1] for t in r})} distinct); "
          f"verify slot-steps={st.spec_steps} drafted={st.spec_drafted} "
          f"accepted={st.spec_accepted} ticks={st.ticks} vs one-token "
          f"{one[0].stats.ticks}")

    i8 = {dev: _run_engine(torch, cfg, plan_i8, mid, reqs(), dev)
          for dev in ("cuda", "cpu")}
    err, mx = _same("parity-int8", i8["cuda"][1:3], i8["cpu"][1:3],
                    INT8_PARITY_TOL)
    _eager_serial(torch, "parity-int8", i8["cuda"][1], cfg, plan_i8, mid, reqs())
    def drift(fp_run, i8_run):
        """Max |logit| difference between float and int8 pools behind each
        emitted token, up to each request's first differing token (the
        contexts are equal until then)."""
        out, n_pos = 0.0, 0
        for rid, rows in fp_run[3].items():
            diff = [i for i, (a, b) in enumerate(zip(fp_run[1][rid],
                                                     i8_run[1][rid])) if a != b]
            n = diff[0] + 1 if diff else len(rows)
            for a, b in zip(rows[:n], i8_run[3][rid][:n]):
                out = max(out, float(np.abs(a - b).max()))
                n_pos += 1
        return ("identical" if fp_run[1] == i8_run[1] else "differ"), out, n_pos

    fp_mid = _run_engine(torch, cfg, plan, mid, reqs(), "cuda")
    init = {kvd: _run_engine(torch, cfg, ShardingPlan(kv_cache_dtype=kvd), base,
                             reqs(), "cuda") for kvd in ("float32", "int8")}
    print(f"parity-int8: int8-pool engine on cuda vs cpu: live logits "
          f"max_abs_err={err:.3e} (|logit| max {mx:.2f}, tol rtol="
          f"{INT8_PARITY_TOL['rtol']} atol={INT8_PARITY_TOL['atol']}); greedy "
          f"tokens identical, and to the eager-serial engine on cuda.  int8 vs "
          f"float pools on cuda (tokens, max logit "
          f"drift over emitted positions; scripts/check_quant_accuracy.py "
          f"DRIFT_BOUND 0.05 at init-scale weights): init-scale weights "
          f"%s %.4f over %d; x1.75 weights %s %.4f over %d"
          % (*drift(init["float32"], init["int8"]), *drift(fp_mid, i8["cuda"])))

    # both together: the int8 verify kernel inside the engine
    spec_i8 = {dev: _run_engine(torch, cfg, plan_i8, mid, spec_reqs(), dev,
                                speculative=4) for dev in ("cuda", "cpu")}
    one_i8 = _run_engine(torch, cfg, plan_i8, mid, spec_reqs(), "cuda")
    err, mx = _same("parity-spec-int8", spec_i8["cuda"][1:3],
                    spec_i8["cpu"][1:3], INT8_PARITY_TOL)
    check(spec_i8["cuda"][1] == one_i8[1], f"parity-spec-int8: speculative "
          f"and one-token int8-pool engines differ on cuda\n  "
          f"{spec_i8['cuda'][1]}\n  {one_i8[1]}")
    _eager_serial(torch, "parity-spec-int8", spec_i8["cuda"][1], cfg, plan_i8,
                  mid, spec_reqs(), speculative=4)
    st = spec_i8["cuda"][0].stats
    check(st.spec_accepted > 0, f"parity-spec-int8: no draft accepted {st}")
    print(f"parity-spec-int8: speculative=4 int8-pool engine on cuda vs cpu: "
          f"live logits max_abs_err={err:.3e} (|logit| max {mx:.2f}, tol rtol="
          f"{INT8_PARITY_TOL['rtol']} atol={INT8_PARITY_TOL['atol']}); greedy "
          f"tokens identical to cpu, to the eager-serial engine and to the "
          f"one-token int8-pool engine on "
          f"cuda; verify slot-steps={st.spec_steps} drafted={st.spec_drafted} "
          f"accepted={st.spec_accepted}")


def phase_parity_qwen3(torch):
    """Full-width, full-depth qwen3-0.6b (28 layers, 16 q over 8 kv heads,
    head_dim 128, qk-norm, vocab 151936) in float32, engines on the card
    (the GQA kernels, qk-norm through the norm kernel) against engines on
    the CPU (plain versions): float pools (weights x10, also against the
    eager-serial engine on the card), int8 pools with speculative=4 on
    repetitive prompts and the contiguous engine (weights x10), all with
    random q_norm/k_norm scales (0.3 randn; the init's are zeros).  The
    speculative run keeps the init scale: there greedy decoding repeats
    (the tied head favours the input token), so prompt lookup drafts and
    the verify kernel runs; at x1.75 it drafted nothing.  Identical
    greedy tokens, live logits of every step within the
    tolerances of the tinyllama phases, leak-free after drain()."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import model
    from repro_torch.core.partition import ShardingPlan
    from repro_torch.serving import Request
    cfg = get_config("qwen3-0.6b")
    plan = ShardingPlan(kv_cache_dtype="float32")
    plan_i8 = ShardingPlan(kv_cache_dtype="int8")
    base = model.init_params(cfg, plan, torch.Generator().manual_seed(0),
                             device="cpu", dtype="float32")
    prompts = [np.random.RandomState(7 + i).randint(2, cfg.vocab_size, L)
               for i, L in enumerate((23, 40, 77))]

    def reqs():
        return [Request(rid=i, prompt=pr.astype(np.int32), max_new_tokens=16)
                for i, pr in enumerate(prompts)]

    def spec_reqs():
        return _motif_requests(Request, np.random.RandomState(11), 3, 24, 48,
                               16, cfg.vocab_size)

    # the init's q_norm/k_norm scales are zeros, under which the norm
    # kernel's scale term at head_dim 128 is never compared: random ones
    def qk_scales(tree, seed):
        g = torch.Generator().manual_seed(seed)
        tree = model.tree_map(lambda t: t, tree)
        for group in tree["stacks"]:
            for layer in group:
                for name in ("q_norm", "k_norm"):
                    t = layer["attn"][name]
                    layer["attn"][name] = (0.3 * torch.randn(
                        t.shape, generator=g)).to(t.dtype)
        return tree

    base = qk_scales(base, 1)
    x10 = qk_scales(model.tree_map(lambda t: t * 10, base), 2)
    runs = {dev: _run_engine(torch, cfg, plan, x10, reqs(), dev)
            for dev in ("cuda", "cpu")}
    err, mx = _same("parity-qwen3", runs["cuda"][1:3], runs["cpu"][1:3],
                    PARITY_TOL)
    toks = runs["cuda"][1]
    _eager_serial(torch, "parity-qwen3", toks, cfg, plan, x10, reqs())
    print(f"parity-qwen3: qwen3-0.6b float32, float pools, engine on cuda vs "
          f"cpu: live logits of every step ({runs['cuda'][2].numel()} values) "
          f"max_abs_err={err:.3e} (|logit| max {mx:.2f}, tol rtol="
          f"{PARITY_TOL['rtol']} atol={PARITY_TOL['atol']}); greedy tokens "
          f"identical, and to the eager-serial engine on cuda: 3 requests x 16 "
          f"tokens, {len({t for r in toks for t in r})} distinct")
    del runs

    spec = {dev: _run_engine(torch, cfg, plan_i8, base, spec_reqs(), dev,
                             speculative=4) for dev in ("cuda", "cpu")}
    err, mx = _same("parity-qwen3[int8, spec]", spec["cuda"][1:3],
                    spec["cpu"][1:3], INT8_PARITY_TOL)
    st = spec["cuda"][0].stats
    check(st.spec_steps > 0, f"parity-qwen3[int8, spec]: the verify step "
                             f"never ran {st}")
    toks = spec["cuda"][1]
    print(f"parity-qwen3: int8 pools, speculative=4, engine on cuda vs cpu: "
          f"live logits max_abs_err={err:.3e} (|logit| max {mx:.2f}, tol rtol="
          f"{INT8_PARITY_TOL['rtol']} atol={INT8_PARITY_TOL['atol']}); greedy "
          f"tokens identical ({len({t for r in toks for t in r})} distinct); "
          f"verify slot-steps={st.spec_steps} drafted={st.spec_drafted} "
          f"accepted={st.spec_accepted}")
    del spec

    contig = {dev: _run_engine(torch, cfg, plan, x10, reqs(), dev, paged=False)
              for dev in ("cuda", "cpu")}
    err, mx = _same("parity-qwen3[contiguous]", contig["cuda"][1:3],
                    contig["cpu"][1:3], PARITY_TOL)
    print(f"parity-qwen3: contiguous engine, float32 lanes, on cuda vs cpu: "
          f"live logits max_abs_err={err:.3e} (|logit| max {mx:.2f}); greedy "
          f"tokens identical")


# parity-gemma3: gemma3-12b's features and kernel shapes (16 q over 8 kv
# heads x 256, qk-norm, sandwich norms, the scaled embedding, gelu, 5 window
# layers to 1 global) at a width a host CPU runs in float32 (PERF.md §4)
G3_PARITY_CUT = dict(n_layers=6, d_model=1024, d_ff=4096, vocab_size=32000,
                     sliding_window=64)


def phase_parity_gemma3(torch):
    """gemma3-12b cut to d_model 1024, d_ff 4096, vocab 32000, 6 layers and
    a window of 64 (``G3_PARITY_CUT``), everything else as published, in
    float32: engines on the card (the windowed paged kernels, head_dim 256
    everywhere) against engines on the CPU (plain versions), 3 requests of
    80-200 prompt tokens plus 16 new, so every window bites: float pools
    (also against the eager-serial engine on the card), int8 pools with
    speculative=4 on repetitive prompts, and the contiguous engine at
    budget 256, whose window layers keep rings of 64 (read by a clamped
    prefix length on the card), its tokens also equal to the paged
    engine's.  Weights at the init scale, q_norm/k_norm and post-norm
    scales 0.3 randn (the init's zeros would leave the norms' scale terms
    uncompared).  Greedy decoding repeats a few tokens here (each
    sublayer's output is normed to unit RMS, and flat attention makes it
    the context's average); sharper attention (q_norm/k_norm scales near
    9) gave more distinct tokens but logits that move by 0.16 under a
    3e-7 relative change of the weights on the CPU alone, no test of the
    kernels.  Identical greedy tokens, live logits of every step within
    the tinyllama tolerances, leak-free after drain()."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import model
    from repro_torch.core.partition import ShardingPlan
    from repro_torch.serving import Request
    cfg = dataclasses.replace(get_config("gemma3-12b"), name="gemma3-12b-parity",
                              **G3_PARITY_CUT)
    plan = ShardingPlan(kv_cache_dtype="float32")
    plan_i8 = ShardingPlan(kv_cache_dtype="int8")
    params = model.init_params(cfg, plan, torch.Generator().manual_seed(0),
                               device="cpu", dtype="float32")
    g = torch.Generator().manual_seed(1)
    for group in params["stacks"]:
        for layer in group:
            for name in ("q_norm", "k_norm"):
                t = layer["attn"][name]
                layer["attn"][name] = 0.3 * torch.randn(t.shape, generator=g)
            for name in ("post_ln1", "post_ln2"):
                t = layer[name]["scale"]
                layer[name]["scale"] = 0.3 * torch.randn(t.shape, generator=g)
    win = cfg.sliding_window
    prompts = [np.random.RandomState(7 + i).randint(2, cfg.vocab_size, L)
               for i, L in enumerate((80, 137, 200))]
    check(min(len(p) for p in prompts) > win, "parity-gemma3: a prompt inside "
                                              "the window")

    def reqs():
        return [Request(rid=i, prompt=pr.astype(np.int32), max_new_tokens=16)
                for i, pr in enumerate(prompts)]

    runs = {dev: _run_engine(torch, cfg, plan, params, reqs(), dev)
            for dev in ("cuda", "cpu")}
    err, mx = _same("parity-gemma3", runs["cuda"][1:3], runs["cpu"][1:3],
                    PARITY_TOL)
    toks = runs["cuda"][1]
    _eager_serial(torch, "parity-gemma3", toks, cfg, plan, params, reqs())
    print(f"parity-gemma3: gemma3-12b cut to {G3_PARITY_CUT} float32, float "
          f"pools, engine on cuda vs cpu: live logits of every step "
          f"({runs['cuda'][2].numel()} values) max_abs_err={err:.3e} (|logit| "
          f"max {mx:.2f}, tol rtol={PARITY_TOL['rtol']} atol="
          f"{PARITY_TOL['atol']}); greedy tokens identical, and to the "
          f"eager-serial engine on cuda: 3 requests x 16 tokens, "
          f"{len({t for r in toks for t in r})} distinct")
    del runs

    def spec_reqs():
        return _motif_requests(Request, np.random.RandomState(11), 3, 80, 200,
                               16, cfg.vocab_size)

    spec = {dev: _run_engine(torch, cfg, plan_i8, params, spec_reqs(), dev,
                             speculative=4) for dev in ("cuda", "cpu")}
    err, mx = _same("parity-gemma3[int8, spec]", spec["cuda"][1:3],
                    spec["cpu"][1:3], INT8_PARITY_TOL)
    st = spec["cuda"][0].stats
    check(st.spec_steps > 0, f"parity-gemma3[int8, spec]: the verify step "
                             f"never ran {st}")
    print(f"parity-gemma3: int8 pools, speculative=4 (R 2 x Q 5 = 10 rows), "
          f"engine on cuda vs cpu: live logits max_abs_err={err:.3e} (|logit| "
          f"max {mx:.2f}, tol rtol={INT8_PARITY_TOL['rtol']} atol="
          f"{INT8_PARITY_TOL['atol']}); greedy tokens identical; verify "
          f"slot-steps={st.spec_steps} drafted={st.spec_drafted} "
          f"accepted={st.spec_accepted}")
    del spec

    contig = {dev: _run_engine(torch, cfg, plan, params, reqs(), dev,
                               paged=False) for dev in ("cuda", "cpu")}
    err, mx = _same("parity-gemma3[contiguous]", contig["cuda"][1:3],
                    contig["cpu"][1:3], PARITY_TOL)
    check(contig["cuda"][1] == toks, f"parity-gemma3: contiguous and paged "
          f"engines differ on cuda\n  {contig['cuda'][1]}\n  {toks}")
    ring = contig["cuda"][0].cache[0][0]["kv"]["k"].shape[3]
    check(ring == win, f"parity-gemma3: a window layer's ring holds {ring} "
                       f"slots, not {win}")
    print(f"parity-gemma3: contiguous engine (budget 256, window layers' rings "
          f"of {ring} slots), float32 lanes, on cuda vs cpu: live logits "
          f"max_abs_err={err:.3e} (|logit| max {mx:.2f}); greedy tokens "
          f"identical, and to the paged engine on cuda")


# parity-hymba: hymba-1.5b cut in depth (5 layers: full attention at {0, 2,
# 4}) and window (1024 -> 64), every width as published
HY_PARITY_CUT = dict(n_layers=5, sliding_window=64)
# float32 logits, card against CPU, 5 hybrid layers at init scale: held to
# 1e-4 absolute
HY_PARITY_TOL = dict(rtol=0.0, atol=1e-4)


def phase_parity_hymba(torch):
    """hymba-1.5b cut to 5 layers (full attention at {0, 2, 4}) and a
    window of 64 (``HY_PARITY_CUT``), every width as published (d_model
    1600, 25 q over 5 kv heads of 64 stored as 25 kv slots, 50 SSD heads
    of 64 with state 16, d_ff 5504, vocab 32001), in float32 with weights
    at the init scale: engines on the card (every kernel at hymba's
    shapes) against engines on the CPU (plain versions), 3 requests of
    80-200 prompt tokens plus 16 new, so every window bites.  Float pools
    and float32 slabs (also against the eager-serial engine on the card),
    int8 pools and int8 slabs, the contiguous engine at budget 256 (the
    window layers' rings of 64; tokens also equal to the paged engine's),
    and int8 pools and slabs with ``preempt(b)`` forced mid-prefill and
    mid-decode (the KV pages and the slab stashed on the host and
    restored: tokens identical to the uninterrupted run).  Identical greedy
    tokens; live logits of every step within 1e-4 (float, contiguous) or
    the int8 tolerance; leak-free after drain()."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import model
    from repro_torch.core.partition import ShardingPlan
    from repro_torch.serving import Request, ServingEngine
    cfg = dataclasses.replace(get_config("hymba-1.5b"), name="hymba-1.5b-parity",
                              dtype="float32", **HY_PARITY_CUT)
    check([i for i, s in enumerate(cfg.layer_specs()) if s.attn == "full"] ==
          [0, 2, 4], "parity-hymba: full attention not at layers 0, 2 and 4")
    plan = ShardingPlan(kv_cache_dtype="float32")
    plan_i8 = ShardingPlan(kv_cache_dtype="int8", ssm_cache_dtype="int8")
    params = model.init_params(cfg, plan, torch.Generator().manual_seed(0),
                               device="cpu")
    win = cfg.sliding_window
    prompts = [np.random.RandomState(17 + i).randint(2, cfg.vocab_size, L)
               for i, L in enumerate((80, 137, 200))]
    check(min(len(p) for p in prompts) > win, "parity-hymba: a prompt inside "
                                              "the window")

    def reqs():
        return [Request(rid=i, prompt=pr.astype(np.int32), max_new_tokens=16)
                for i, pr in enumerate(prompts)]

    runs = {dev: _run_engine(torch, cfg, plan, params, reqs(), dev)
            for dev in ("cuda", "cpu")}
    err, mx = _same("parity-hymba", runs["cuda"][1:3], runs["cpu"][1:3],
                    HY_PARITY_TOL)
    toks = runs["cuda"][1]
    _eager_serial(torch, "parity-hymba", toks, cfg, plan, params, reqs())
    print(f"parity-hymba: hymba-1.5b cut to {HY_PARITY_CUT} float32, float "
          f"pools and float32 slabs, engine on cuda vs cpu: live logits of "
          f"every step ({runs['cuda'][2].numel()} values) max_abs_err="
          f"{err:.3e} (|logit| max {mx:.2f}, tol atol="
          f"{HY_PARITY_TOL['atol']}); greedy tokens identical, and to the "
          f"eager-serial engine on cuda: 3 requests x 16 tokens, "
          f"{len({t for r in toks for t in r})} distinct")
    del runs

    i8 = {dev: _run_engine(torch, cfg, plan_i8, params, reqs(), dev)
          for dev in ("cuda", "cpu")}
    err, mx = _same("parity-hymba[int8]", i8["cuda"][1:3], i8["cpu"][1:3],
                    INT8_PARITY_TOL)
    toks_i8 = i8["cuda"][1]
    print(f"parity-hymba: int8 pools and int8 slabs, engine on cuda vs cpu: "
          f"live logits max_abs_err={err:.3e} (|logit| max {mx:.2f}, tol "
          f"rtol={INT8_PARITY_TOL['rtol']} atol={INT8_PARITY_TOL['atol']}); "
          f"greedy tokens identical")
    del i8

    contig = {dev: _run_engine(torch, cfg, plan, params, reqs(), dev,
                               paged=False) for dev in ("cuda", "cpu")}
    err, mx = _same("parity-hymba[contiguous]", contig["cuda"][1:3],
                    contig["cpu"][1:3], HY_PARITY_TOL)
    check(contig["cuda"][1] == toks, f"parity-hymba: contiguous and paged "
          f"engines differ on cuda\n  {contig['cuda'][1]}\n  {toks}")
    rings = [e["kv"]["k"].shape[3] for e in contig["cuda"][0].cache[0]]
    check(sorted(set(rings)) == [win, 256], f"parity-hymba: rings of {rings}")
    print(f"parity-hymba: contiguous engine (budget 256, window layers' rings "
          f"of {win} slots, SSD lanes), float32, on cuda vs cpu: live logits "
          f"max_abs_err={err:.3e} (|logit| max {mx:.2f}); greedy tokens "
          f"identical, and to the paged engine on cuda")
    del contig

    restored = []

    def force(eng, tick):
        """Preempt a prefilling slot at tick 2 and a decoding one at ticks
        8 and 20."""
        state = {2: "prefill", 8: "decode", 20: "decode"}.get(tick)
        for b in range(eng.B):
            if state and eng.slot_state[b] == state:
                eng.preempt(b)
                return

    eng = ServingEngine.build_paged(cfg, plan_i8, 2, 256, params, page_size=16,
                                    prefill_chunk=32, device="cuda")
    restore = eng._restore_slot

    def counted_restore(r, adm, stash):
        restored.append(stash["n_kv_pages"])
        restore(r, adm, stash)

    eng._restore_slot = counted_restore
    got = _serve_arrivals(eng, reqs(), 3, 1, preempt=force)
    st = eng.stats
    check(got == toks_i8, f"parity-hymba[int8, preempted]: forced preemption "
                          f"changed tokens\n  {got}\n  {toks_i8}")
    check(0 < st.slab_restores == st.preemptions and all(restored),
          f"parity-hymba[int8, preempted]: {st.preemptions} preemptions, "
          f"{st.slab_restores} restores of {restored} KV pages")
    print(f"parity-hymba: int8 pools and slabs, preempt(b) forced mid-prefill "
          f"and mid-decode on cuda: greedy tokens identical to the "
          f"uninterrupted run; preemptions={st.preemptions} slab_restores="
          f"{st.slab_restores} kv_pages_restored={restored} "
          f"prefill_tokens_skipped={st.prefill_tokens_skipped}")


# parity-mistral: mistral-large-123b cut in width and depth, keeping its
# group of 12 q heads a kv slot and its untied 32768-row head
ML_PARITY_CUT = dict(n_layers=3, d_model=768, n_heads=12, n_kv_heads=1,
                     head_dim=64, d_ff=2048)
# float32 logits, card against CPU: held to 1e-4 absolute
ML_PARITY_TOL = dict(rtol=0.0, atol=1e-4)


def phase_parity_mistral(torch):
    """mistral-large-123b cut to 3 layers, d_model 768, 12 q heads over 1
    kv head of 64 (R 12, mistral's group), d_ff 2048 (``ML_PARITY_CUT``),
    its vocab of 32768 and untied head kept, float32 at the init scale:
    engines on the card (flash and paged decode at group 12, the head's NT
    product on a tensor of its own) against engines on the CPU (plain
    versions), 3 requests of 40-130 prompt tokens plus 16 new: float pools
    (also against the eager-serial engine on the card) and the contiguous
    engine (also against the paged engine on the card).  Logits of every
    step within 1e-4, identical greedy tokens, leak-free.  Then a
    speculative engine on the card is refused at construction (R 12 x Q 2
    rows past the verify kernel's m16: ROADMAP Queue 2 item 1)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import model
    from repro_torch.core.partition import ShardingPlan, model_layout
    from repro_torch.serving import Request, ServingEngine
    cfg = dataclasses.replace(get_config("mistral-large-123b"),
                              name="mistral-large-123b-parity", dtype="float32",
                              **ML_PARITY_CUT)
    lay = model_layout(cfg, ShardingPlan()).attn
    check(lay.r == 12 and not cfg.tie_embeddings,
          f"parity-mistral: r={lay.r}, tie_embeddings={cfg.tie_embeddings}")
    plan = ShardingPlan(kv_cache_dtype="float32")
    params = model.init_params(cfg, plan, torch.Generator().manual_seed(0),
                               device="cpu")
    prompts = [np.random.RandomState(27 + i).randint(2, cfg.vocab_size, L)
               for i, L in enumerate((40, 77, 130))]

    def reqs():
        return [Request(rid=i, prompt=pr.astype(np.int32), max_new_tokens=16)
                for i, pr in enumerate(prompts)]

    out = {}
    for paged in (True, False):
        tag = "paged" if paged else "contiguous"
        runs = {dev: _run_engine(torch, cfg, plan, params, reqs(), dev,
                                 paged=paged) for dev in ("cuda", "cpu")}
        err, mx = _same(f"parity-mistral[{tag}]", runs["cuda"][1:3],
                        runs["cpu"][1:3], ML_PARITY_TOL)
        out[tag] = toks = runs["cuda"][1]
        n_distinct = len({t for r in toks for t in r})
        check(n_distinct > 3, f"parity-mistral[{tag}]: greedy decoding "
                              f"collapsed {toks}")
        if paged:
            _eager_serial(torch, "parity-mistral", toks, cfg, plan, params, reqs())
        print(f"parity-mistral: mistral-large-123b cut to {ML_PARITY_CUT} "
              f"(r={lay.r}, kv slots {lay.n_kv_loc}, untied head "
              f"({cfg.vocab_size}, {cfg.d_model})) float32, {tag} engine on cuda "
              f"vs cpu: live logits of every step ({runs['cuda'][2].numel()} "
              f"values) max_abs_err={err:.3e} (|logit| max {mx:.2f}, tol atol="
              f"{ML_PARITY_TOL['atol']}); greedy tokens identical"
              f"{', and to the eager-serial engine on cuda' if paged else ''}: "
              f"3 requests x 16 tokens, {n_distinct} distinct")
        del runs
    check(out["paged"] == out["contiguous"], f"parity-mistral: contiguous and "
          f"paged engines differ on cuda\n  {out['contiguous']}\n  {out['paged']}")
    try:
        ServingEngine.build_paged(cfg, plan, 2, 256, params, page_size=16,
                                  prefill_chunk=32, speculative=1, device="cuda")
    except ValueError as e:
        check("ROADMAP Queue 2 item 1" in str(e),
              f"parity-mistral: speculation refused for another reason: {e}")
        print(f"parity-mistral: contiguous tokens equal the paged engine's on "
              f"cuda; speculative=1 refused at construction on cuda: {e}")
    else:
        raise SmokeFailure("parity-mistral: a speculative engine at R 12 was "
                           "built on the card")


def phase_parity_64h(torch):
    """tinyllama-42m-64h at full width and depth (8 layers, 64 heads of
    head_dim 8) in float32, weights x10: engines on the card (every
    attention kernel at D 8) against engines on the CPU (plain versions),
    4 requests of 23-130 prompt tokens plus 16 new: the paged engine (also
    against the eager-serial engine on the card) and the contiguous engine
    (also against the paged engine on the card).  Live logits of every step
    within the tinyllama tolerance, identical greedy tokens, leak-free."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import model
    from repro_torch.core.partition import ShardingPlan
    from repro_torch.serving import Request
    cfg = get_config("tinyllama-42m-64h")
    check((cfg.n_heads, cfg.head_dim_) == (P64_H, P64_D),
          f"parity-64h: {cfg.n_heads} heads of {cfg.head_dim_}")
    plan = ShardingPlan(kv_cache_dtype="float32")
    base = model.init_params(cfg, plan, torch.Generator().manual_seed(0),
                             device="cpu", dtype="float32")
    params = model.tree_map(lambda t: t * 10, base)
    prompts = [np.random.RandomState(17 + i).randint(2, cfg.vocab_size, L)
               for i, L in enumerate((23, 40, 77, 130))]

    def reqs():
        return [Request(rid=i, prompt=pr.astype(np.int32), max_new_tokens=16)
                for i, pr in enumerate(prompts)]

    out = {}
    for paged in (True, False):
        tag = "paged" if paged else "contiguous"
        runs = {dev: _run_engine(torch, cfg, plan, params, reqs(), dev,
                                 paged=paged) for dev in ("cuda", "cpu")}
        err, mx = _same(f"parity-64h[{tag}]", runs["cuda"][1:3],
                        runs["cpu"][1:3], PARITY_TOL)
        out[tag] = toks = runs["cuda"][1]
        n_distinct = len({t for r in toks for t in r})
        check(n_distinct > 3, f"parity-64h[{tag}]: greedy decoding collapsed "
                              f"{toks}")
        if paged:
            _eager_serial(torch, "parity-64h", toks, cfg, plan, params, reqs())
        print(f"parity-64h: tinyllama-42m-64h ({cfg.n_layers} layers, "
              f"{cfg.n_heads} heads x {cfg.head_dim_}) float32, {tag} engine "
              f"on cuda vs cpu: live logits of every step "
              f"({runs['cuda'][2].numel()} values) max_abs_err={err:.3e} "
              f"(|logit| max {mx:.2f}, tol rtol={PARITY_TOL['rtol']} atol="
              f"{PARITY_TOL['atol']}); greedy tokens identical"
              f"{', and to the eager-serial engine on cuda' if paged else ''}: "
              f"4 requests x 16 tokens, {n_distinct} distinct")
        del runs
    check(out["paged"] == out["contiguous"], f"parity-64h: contiguous and "
          f"paged engines differ on cuda\n  {out['contiguous']}\n  {out['paged']}")
    print("parity-64h: contiguous tokens equal the paged engine's on cuda")


# parity-seamless: seamless-m4t-large-v2 cut in width and depth for the
# CPU side, keeping its head_dim 64, layernorm, the plain gelu FFN and an
# encoder memory of 512 frames (32 cross pages of 16)
SM_PARITY_CUT = dict(n_layers=3, n_enc_layers=2, d_model=512, n_heads=8,
                     n_kv_heads=8, d_ff=2048, vocab_size=32000,
                     enc_seq_len=512)
# weights x5 but the layernorms' (scale 1, bias 0: x5 there would scale
# every attention logit x25 more): |logit| up to ~11, 55 distinct tokens.
# The int8 runs at x2: their pools and lanes quantize the encoder memory's
# K/V, whose float32 sums differ between the card and the CPU in the last
# bits, and at x5 the attention is peaked enough that a K/V value moved one
# step changes greedy tokens (on the CPU alone, frames perturbed by one part
# in a million flipped the int8 paged engine's tokens at x5, not at x2)
SM_PARITY_SCALE, SM_PARITY_SCALE_INT8 = 5.0, 2.0


def _scaled_but_norms(tree, s, key=""):
    """Every weight of ``tree`` times ``s`` but the norms' (the subtrees
    under an ``ln*`` or ``final_norm`` key)."""
    if isinstance(tree, dict):
        return {k: _scaled_but_norms(v, s, k if k.startswith(
            ("ln", "final_norm")) else key) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_scaled_but_norms(v, s, key) for v in tree]
    return tree if key else tree * s


def phase_parity_seamless(torch):
    """seamless-m4t-large-v2 cut to 3 decoder and 2 encoder layers, d_model
    512, 8 heads of 64, d_ff 2048, vocab 32000 and 512 frames
    (``SM_PARITY_CUT``), float32, weights x5 (int8 runs x2) but the
    layernorms': engines on the card (flash
    without the causal mask over the cross keys, the encoder's causal
    flash, paged decode through the cross block table, the contiguous
    decode over the cross lanes) against engines on the CPU (plain
    versions), 4 requests of 23-130 prompt tokens plus 16 new over two
    frame tensors (request i the (i mod 2)-th).  The paged engine over
    float pools (also against the eager-serial engine on the card) and
    over int8 pools (cross pools int8 too), each with 2 encodes and 2
    cross hits; the contiguous engine over float32 lanes (tokens also
    equal to the paged engine's on the card) and over int8 lanes (the
    cross lanes a bare int8 cast, JAX's trap).  Identical greedy tokens;
    live logits of every step within the tinyllama tolerance (int8: the
    int8 one); leak-free after drain(), cross-cached pages counted."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import model
    from repro_torch.core.partition import ShardingPlan
    from repro_torch.serving import Request
    cfg = dataclasses.replace(get_config("seamless-m4t-large-v2"),
                              name="seamless-m4t-large-v2-parity",
                              dtype="float32", **SM_PARITY_CUT)
    check(cfg.head_dim_ == SM_D and cfg.norm == "layernorm" and
          not cfg.gated_ffn, "parity-seamless: not seamless's layer")
    plan = ShardingPlan(kv_cache_dtype="float32")
    plan_i8 = ShardingPlan(kv_cache_dtype="int8")
    base = model.init_params(cfg, plan, torch.Generator().manual_seed(0),
                             device="cpu")
    params = {False: _scaled_but_norms(base, SM_PARITY_SCALE),
              True: _scaled_but_norms(base, SM_PARITY_SCALE_INT8)}
    frames = [np.random.RandomState(40 + g).randn(
        cfg.enc_seq_len, cfg.d_model).astype(np.float32) for g in range(2)]
    prompts = [np.random.RandomState(17 + i).randint(2, cfg.vocab_size, L)
               for i, L in enumerate((23, 40, 77, 130))]

    def reqs():
        return [Request(rid=i, prompt=pr.astype(np.int32), max_new_tokens=16,
                        frames=frames[i % 2]) for i, pr in enumerate(prompts)]

    out = {}
    for tag, pl, paged, tol in (
            ("paged", plan, True, PARITY_TOL),
            ("paged, int8 pools", plan_i8, True, INT8_PARITY_TOL),
            ("contiguous", plan, False, PARITY_TOL),
            ("contiguous, int8 lanes", plan_i8, False, INT8_PARITY_TOL)):
        quant = pl is plan_i8
        runs = {dev: _run_engine(torch, cfg, pl, params[quant], reqs(), dev,
                                 paged=paged) for dev in ("cuda", "cpu")}
        err, mx = _same(f"parity-seamless[{tag}]", runs["cuda"][1:3],
                        runs["cpu"][1:3], tol)
        out[tag] = toks = runs["cuda"][1]
        n_distinct = len({t for r in toks for t in r})
        check(n_distinct > 3, f"parity-seamless[{tag}]: greedy decoding "
                              f"collapsed {toks}")
        enc = ""
        if paged:
            st = runs["cuda"][0].stats
            check((st.cross_encodes, st.cross_hits, st.cross_lookups) ==
                  (2, 2, 4), f"parity-seamless[{tag}]: {st.cross_encodes} "
                             f"encodes, {st.cross_hits}/{st.cross_lookups} hits")
            enc = (f"; cross_encodes={st.cross_encodes} cross_hits="
                   f"{st.cross_hits}/{st.cross_lookups}")
        if tag == "paged":
            _eager_serial(torch, "parity-seamless", toks, cfg, pl,
                          params[quant], reqs())
        print(f"parity-seamless: seamless-m4t-large-v2 cut to {SM_PARITY_CUT} "
              f"float32 x{SM_PARITY_SCALE_INT8 if quant else SM_PARITY_SCALE:g}"
              f" (norms x1), {tag} engine on cuda "
              f"vs cpu: "
              f"live logits of every step ({runs['cuda'][2].numel()} values) "
              f"max_abs_err={err:.3e} (|logit| max {mx:.2f}, tol rtol="
              f"{tol['rtol']} atol={tol['atol']}); greedy tokens identical"
              f"{', and to the eager-serial engine on cuda' if tag == 'paged' else ''}"
              f": 4 requests x 16 tokens over 2 frame tensors, {n_distinct} "
              f"distinct{enc}")
        del runs
    check(out["paged"] == out["contiguous"], f"parity-seamless: contiguous "
          f"and paged engines differ on cuda\n  {out['contiguous']}\n  "
          f"{out['paged']}")
    print("parity-seamless: contiguous tokens equal the paged engine's on cuda")


# parity-sample: tinyllama-42m at full width cut to 4 of its 8 layers, and
# the two samplers of the CPU tests
# parity-deepseek: deepseek-moe-16b cut to 1 dense and 2 MoE layers and a
# narrow width for the CPU side, keeping its 64 experts, top-6, 2 shared
# experts, 16 heads of 128, vocab 102400 and untied head
DS_PARITY_CUT = dict(n_layers=3, d_model=256, moe_d_ff=128,
                     dense_ff_override=1024)


def phase_parity_deepseek(torch):
    """deepseek-moe-16b cut to 3 layers (the dense first layer and 2 MoE
    layers), d_model 256, experts of 128, the dense layer's FFN 1024
    (``DS_PARITY_CUT``), float32, weights x10 (the router's too: at the
    init scale the 64 routing probabilities of a row lie within 1e-6 of
    each other and greedy decoding collapses): engines on the card (the
    expert matmul, the router's float32 product on the CUDA-core kernel)
    against engines on the CPU (plain versions), 3 requests of 40-130
    prompt tokens plus 16 new: the paged engine (also against the
    eager-serial engine on the card) and the contiguous engine.  Live
    logits of every step within the tinyllama tolerance (x10 weights too:
    |logit| up to ~17), identical greedy tokens, the same
    pairs dropped by capacity, leak-free.  Prints the smallest gap between
    the k-th and (k+1)-th routing probability of any routed row on the CPU
    side (padding rows and idle lanes too): a flip at a near-tie would be
    explained by it."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import model, moe
    from repro_torch.core.partition import ShardingPlan
    from repro_torch.serving import Request
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"),
                              name="deepseek-moe-16b-parity", dtype="float32",
                              **DS_PARITY_CUT)
    check([s.ffn for s in cfg.layer_specs()] == ["dense", "moe", "moe"] and
          (cfg.n_experts, cfg.top_k, cfg.n_shared_experts) == (64, 6, 2),
          f"parity-deepseek: layers {[s.ffn for s in cfg.layer_specs()]}")
    plan = ShardingPlan(kv_cache_dtype="float32")
    base = model.init_params(cfg, plan, torch.Generator().manual_seed(0),
                             device="cpu")
    params = model.tree_map(lambda t: t * 10, base)
    prompts = [np.random.RandomState(41 + i).randint(2, cfg.vocab_size, L)
               for i, L in enumerate((40, 77, 130))]

    def reqs():
        return [Request(rid=i, prompt=pr.astype(np.int32), max_new_tokens=16)
                for i, pr in enumerate(prompts)]

    gaps, topk = [], moe.router_topk

    def gap_recorded(x, w, k, n):
        out = topk(x, w, k, n)
        probs = torch.softmax(x.float() @ w.float(), dim=-1)
        srt = torch.sort(probs, dim=-1, descending=True).values
        gaps.append(float((srt[:, k - 1] - srt[:, k]).min()))
        return out

    for paged in (True, False):
        tag = "paged" if paged else "contiguous"
        runs, drops = {}, {}
        for dev in ("cuda", "cpu"):
            moe.reset_dropped_pairs()
            if dev == "cpu":
                moe.router_topk = gap_recorded
            try:
                runs[dev] = _run_engine(torch, cfg, plan, params, reqs(), dev,
                                        paged=paged)
            finally:
                moe.router_topk = topk
            drops[dev] = moe.dropped_pairs()
        err, mx = _same(f"parity-deepseek[{tag}]", runs["cuda"][1:3],
                        runs["cpu"][1:3], PARITY_TOL)
        check(drops["cuda"] == drops["cpu"], f"parity-deepseek[{tag}]: "
              f"{drops['cuda']} pairs dropped on cuda, {drops['cpu']} on cpu")
        toks = runs["cuda"][1]
        n_distinct = len({t for r in toks for t in r})
        check(n_distinct > 3, f"parity-deepseek[{tag}]: greedy decoding "
                              f"collapsed {toks}")
        if paged:
            _eager_serial(torch, "parity-deepseek", toks, cfg, plan, params,
                          reqs())
        print(f"parity-deepseek: deepseek-moe-16b cut to {DS_PARITY_CUT} "
              f"({cfg.n_experts} experts top-{cfg.top_k}, "
              f"{cfg.n_shared_experts} shared, weights x10) float32, {tag} "
              f"engine on cuda vs cpu: live logits of every step "
              f"({runs['cuda'][2].numel()} values) max_abs_err={err:.3e} "
              f"(|logit| max {mx:.2f}, tol rtol={PARITY_TOL['rtol']} atol="
              f"{PARITY_TOL['atol']}); greedy tokens identical"
              f"{', and to the eager-serial engine on cuda' if paged else ''}: "
              f"3 requests x 16 tokens, {n_distinct} distinct; pairs dropped "
              f"by capacity {drops['cuda']} on both; smallest routing gap "
              f"(k-th - (k+1)-th probability, cpu) {min(gaps):.3e} over "
              f"{len(gaps)} router calls")
        del runs


SAMPLE_DEPTH = 4
SAMPLERS = {"top_k": dict(temperature=0.7, top_k=40),
            "top_p": dict(temperature=1.0, top_p=0.9)}


def phase_parity_sample(torch):
    """Sampled decoding on the card against the CPU in fp32: tinyllama-42m
    at full width cut to 4 of its 8 layers (``SAMPLE_DEPTH``), weights
    x0.5, the same weights, requests and ``rng_seed`` on both: the paged
    engine with temperature 0.7, top_k 40 and with temperature 1.0, top_p
    0.9, each with speculation k = 3 on 8 repetitive prompts and 32 new
    tokens (also against the one-token engine on the card: speculation
    changes no draw).  At x0.5 the top 40 often hold a motif's tokens, so
    top_k's samples meet drafts and the verify kernel runs (and accepts
    some); top_p's nucleus at temperature 1.0 spans most of the 32000
    tokens, whose draws hardly ever recur in the context, so its drafts
    rarely hit (the CPU tests verify top_p's drafts at vocab 512).  Under PriorityScheduler(preemption=True) with the
    first sampler, every 3rd request urgent and arriving while others run,
    ``preempt(b)`` forced at ticks 4 and 11 (also against the uninterrupted
    FCFS run on the card); the contiguous engine with the first sampler
    (also against the paged engine on the card).  Identical sampled tokens
    (every request's own stream, one draw per emitted row), live logits of
    every step within the parity tolerance, leak-free."""
    import dataclasses
    import functools

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import model
    from repro_torch.core.partition import ShardingPlan
    from repro_torch.serving import (PriorityScheduler, Request, SamplerConfig,
                                     ServingEngine)
    cfg = dataclasses.replace(get_config("tinyllama-42m"), n_layers=SAMPLE_DEPTH)
    plan = ShardingPlan(kv_cache_dtype="float32")
    params = model.tree_map(lambda t: t * 0.5, model.init_params(
        cfg, plan, torch.Generator().manual_seed(0), device="cpu",
        dtype="float32"))

    def spec_reqs():
        return _motif_requests(Request, np.random.RandomState(11), 8, 24, 48,
                               32, cfg.vocab_size)

    for kind, sk in SAMPLERS.items():
        kw = dict(sampler=SamplerConfig(**sk), rng_seed=7)
        spec = {dev: _run_engine(torch, cfg, plan, params, spec_reqs(), dev,
                                 speculative=3, **kw) for dev in ("cuda", "cpu")}
        err, mx = _same(f"parity-sample[{kind}, spec]", spec["cuda"][1:3],
                        spec["cpu"][1:3], PARITY_TOL)
        one = _run_engine(torch, cfg, plan, params, spec_reqs(), "cuda", **kw)[1]
        toks = spec["cuda"][1]
        check(toks == one, f"parity-sample[{kind}]: speculative and one-token "
                           f"engines differ on cuda\n  {toks}\n  {one}")
        st = spec["cuda"][0].stats
        check(kind != "top_k" or st.spec_accepted > 0,
              f"parity-sample[{kind}]: no draft accepted {st}")
        print(f"parity-sample: tinyllama-42m at {SAMPLE_DEPTH} layers float32, "
              f"{sk}, speculative=3 engine on cuda vs cpu: live logits "
              f"max_abs_err={err:.3e} (|logit| max {mx:.2f}); sampled tokens "
              f"identical, and to the one-token engine on cuda (8 requests x "
              f"32 tokens, {len({t for r in toks for t in r})} distinct); "
              f"verify slot-steps={st.spec_steps} drafted={st.spec_drafted} "
              f"accepted={st.spec_accepted}")
        del spec

    sampler = SamplerConfig(**SAMPLERS["top_k"])

    def mixed():
        out = _requests(Request, np.random.RandomState(9), 7, 8, 70, 16,
                        cfg.vocab_size)
        for r in out:
            r.priority = 10 if r.rid % 3 == 2 else 0
        return out

    def force(eng, tick):
        if tick in (4, 11):
            b = next((b for b in range(eng.B) if eng.admissions[b] is not None),
                     None)
            if b is not None:
                eng.preempt(b)

    def engine(dev, **kw):
        return ServingEngine.build_paged(cfg, plan, 2, 256, params, page_size=16,
                                         prefill_chunk=32, sampler=sampler,
                                         rng_seed=7, device=dev, **kw)

    want = _serve_arrivals(engine("cuda"), mixed(), 2, 6)
    got, stats = {}, {}
    for dev in ("cuda", "cpu"):
        eng = engine(dev, prefix_cache=True, scheduler=functools.partial(
            PriorityScheduler, preemption=True))
        got[dev] = _serve_arrivals(eng, mixed(), 2, 6, preempt=force)
        stats[dev] = eng.stats
    check(got["cuda"] == got["cpu"], f"parity-sample[preempted]: cuda and cpu "
          f"differ\n  {got['cuda']}\n  {got['cpu']}")
    check(got["cuda"] == want, f"parity-sample[preempted]: preemption changed "
          f"sampled tokens\n  {got['cuda']}\n  {want}")
    st = stats["cuda"]
    check(st.preemptions > 2, f"parity-sample[preempted]: {st.preemptions} "
                              f"preemptions")
    print(f"parity-sample: {SAMPLERS['top_k']}, priority with preemption and "
          f"preempt(b) forced at ticks 4 and 11, engine on cuda vs cpu: sampled "
          f"tokens identical, and to FCFS without preemption on cuda (7 requests "
          f"x 16); preemptions={st.preemptions} prefill_tokens_skipped="
          f"{st.prefill_tokens_skipped}")

    prompts = [np.random.RandomState(7 + i).randint(2, cfg.vocab_size, L)
               for i, L in enumerate((23, 40, 77, 130))]

    def reqs():
        return [Request(rid=i, prompt=pr.astype(np.int32), max_new_tokens=16)
                for i, pr in enumerate(prompts)]

    kw = dict(sampler=sampler, rng_seed=7)
    contig = {dev: _run_engine(torch, cfg, plan, params, reqs(), dev,
                               paged=False, **kw) for dev in ("cuda", "cpu")}
    err, mx = _same("parity-sample[contiguous]", contig["cuda"][1:3],
                    contig["cpu"][1:3], PARITY_TOL)
    paged = _run_engine(torch, cfg, plan, params, reqs(), "cuda", **kw)[1]
    check(contig["cuda"][1] == paged, f"parity-sample: contiguous and paged "
          f"engines differ on cuda\n  {contig['cuda'][1]}\n  {paged}")
    print(f"parity-sample: {SAMPLERS['top_k']}, contiguous engine on cuda vs "
          f"cpu: live logits max_abs_err={err:.3e} (|logit| max {mx:.2f}); "
          f"sampled tokens identical, and to the paged engine on cuda")


def phase_parity_ssm(torch):
    """Full-width mamba2-370m (48 layers) in float32 at the port's init
    scale, engines on the card (kernels) against engines on the CPU (plain
    versions), from float32 and from int8 state slabs: identical greedy
    tokens, more than one distinct, live logits within tolerance, slabs
    leak-free after drain()."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import model
    from repro_torch.core.partition import ShardingPlan
    from repro_torch.serving import Request
    # float32 conv-tail slabs too (they follow cfg.dtype)
    cfg = dataclasses.replace(get_config("mamba2-370m"), dtype="float32")
    plan = ShardingPlan(kv_cache_dtype="float32")
    params = model.init_params(cfg, plan, torch.Generator().manual_seed(0),
                               device="cpu")
    prompts = [np.random.RandomState(7 + i).randint(2, cfg.vocab_size, L)
               for i, L in enumerate((23, 40, 77, 130))]

    def reqs():
        return [Request(rid=i, prompt=pr.astype(np.int32), max_new_tokens=16)
                for i, pr in enumerate(prompts)]

    out = {}
    for slabs, tol in (("float32", SSM_PARITY_TOL), ("int8", SSM_INT8_PARITY_TOL)):
        plan_s = ShardingPlan(kv_cache_dtype="float32",
                              ssm_cache_dtype="int8" if slabs == "int8" else "")
        runs = {dev: _run_engine(torch, cfg, plan_s, params, reqs(), dev)
                for dev in ("cuda", "cpu")}
        err, mx = _same(f"parity-ssm[{slabs}]", runs["cuda"][1:3],
                        runs["cpu"][1:3], tol)
        toks = runs["cuda"][1]
        _eager_serial(torch, f"parity-ssm[{slabs}]", toks, cfg, plan_s, params,
                      reqs())
        n_distinct = len({t for r in toks for t in r})
        check(n_distinct > 1, f"parity-ssm[{slabs}]: greedy decoding emitted "
                              f"one token only {toks}")
        print(f"parity-ssm: mamba2-370m float32, {slabs} slabs, engine on cuda "
              f"vs cpu: live logits of every step "
              f"({runs['cuda'][2].numel()} values) max_abs_err={err:.3e} "
              f"(|logit| max {mx:.2f}, tol rtol={tol['rtol']} "
              f"atol={tol['atol']}); greedy tokens identical, and to the "
              f"eager-serial engine on cuda: 4 requests x 16 "
              f"tokens, {n_distinct} distinct; slabs leak-free")
        out[slabs] = toks
    same = sum(a == b for ra, rb in zip(out["float32"], out["int8"])
               for a, b in zip(ra, rb))
    print(f"parity-ssm: int8 against float32 slabs on cuda: {same} of "
          f"{sum(len(r) for r in out['float32'])} tokens equal position by "
          f"position")


def phase_parity_contig(torch):
    """The contiguous engine, full-width tinyllama-42m in float32, card
    (decode-attention and flash kernels) against CPU (plain versions):
    float lanes at weights x10 (the parity phase's setup), identical greedy
    tokens to the CPU and to the paged engine on the card; fixed-scale int8
    lanes at weights x1.75, identical to the CPU."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import model
    from repro_torch.core.partition import ShardingPlan
    from repro_torch.serving import Request
    cfg = get_config("tinyllama-42m")
    plan = ShardingPlan(kv_cache_dtype="float32")
    plan_i8 = ShardingPlan(kv_cache_dtype="int8")
    base = model.init_params(cfg, plan, torch.Generator().manual_seed(0),
                             device="cpu", dtype="float32")
    prompts = [np.random.RandomState(7 + i).randint(2, cfg.vocab_size, L)
               for i, L in enumerate((23, 40, 77, 130))]

    def reqs():
        return [Request(rid=i, prompt=pr.astype(np.int32), max_new_tokens=16)
                for i, pr in enumerate(prompts)]

    x10 = model.tree_map(lambda t: t * 10, base)
    runs = {dev: _run_engine(torch, cfg, plan, x10, reqs(), dev, paged=False)
            for dev in ("cuda", "cpu")}
    err, mx = _same("parity-contig", runs["cuda"][1:3], runs["cpu"][1:3],
                    PARITY_TOL)
    paged = _run_engine(torch, cfg, plan, x10, reqs(), "cuda")
    toks = runs["cuda"][1]
    check(toks == paged[1], f"parity-contig: contiguous and paged engines "
          f"differ on cuda\n  {toks}\n  {paged[1]}")
    _eager_serial(torch, "parity-contig", toks, cfg, plan, x10, reqs(),
                  paged=False)
    print(f"parity-contig: tinyllama-42m float32 contiguous engine on cuda vs "
          f"cpu: live logits of every step ({runs['cuda'][2].numel()} values) "
          f"max_abs_err={err:.3e} (|logit| max {mx:.2f}, tol rtol="
          f"{PARITY_TOL['rtol']} atol={PARITY_TOL['atol']}); greedy tokens "
          f"identical to cpu, to the eager engine and to the paged engine on "
          f"cuda: 4 requests x 16 "
          f"tokens, {len({t for r in toks for t in r})} distinct")

    mid = model.tree_map(lambda t: t * 1.75, base)
    i8 = {dev: _run_engine(torch, cfg, plan_i8, mid, reqs(), dev, paged=False)
          for dev in ("cuda", "cpu")}
    err, mx = _same("parity-contig-int8", i8["cuda"][1:3], i8["cpu"][1:3],
                    CONTIG_INT8_PARITY_TOL)
    _eager_serial(torch, "parity-contig-int8", i8["cuda"][1], cfg, plan_i8, mid,
                  reqs(), paged=False)
    fp = _run_engine(torch, cfg, plan, mid, reqs(), "cuda", paged=False)
    same = sum(a == b for ra, rb in zip(fp[1], i8["cuda"][1])
               for a, b in zip(ra, rb))
    print(f"parity-contig-int8: fixed-scale int8 lanes on cuda vs cpu: live "
          f"logits max_abs_err={err:.3e} (|logit| max {mx:.2f}, tol rtol="
          f"{CONTIG_INT8_PARITY_TOL['rtol']} atol="
          f"{CONTIG_INT8_PARITY_TOL['atol']}); greedy tokens identical, and "
          f"to the eager engine on cuda; "
          f"against float lanes on cuda {same} of "
          f"{sum(len(r) for r in fp[1])} tokens equal position by position")


def phase_parity_contig_ssm(torch):
    """The contiguous engine on full-width mamba2-370m in float32 at the
    port's init scale: card (the SSD scan from a zero state over each whole
    prompt) against CPU, identical greedy tokens, live logits within
    ``SSM_PARITY_TOL``, and tokens identical to the paged engine (float32
    slabs) on the card."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import model
    from repro_torch.core.partition import ShardingPlan
    from repro_torch.serving import Request
    cfg = dataclasses.replace(get_config("mamba2-370m"), dtype="float32")
    plan = ShardingPlan(kv_cache_dtype="float32")
    params = model.init_params(cfg, plan, torch.Generator().manual_seed(0),
                               device="cpu")
    prompts = [np.random.RandomState(7 + i).randint(2, cfg.vocab_size, L)
               for i, L in enumerate((23, 40, 77, 130))]

    def reqs():
        return [Request(rid=i, prompt=pr.astype(np.int32), max_new_tokens=16)
                for i, pr in enumerate(prompts)]

    runs = {dev: _run_engine(torch, cfg, plan, params, reqs(), dev, paged=False)
            for dev in ("cuda", "cpu")}
    err, mx = _same("parity-contig-ssm", runs["cuda"][1:3], runs["cpu"][1:3],
                    SSM_PARITY_TOL)
    toks = runs["cuda"][1]
    n_distinct = len({t for r in toks for t in r})
    check(n_distinct > 1, f"parity-contig-ssm: one token only {toks}")
    paged = _run_engine(torch, cfg, plan, params, reqs(), "cuda")
    check(toks == paged[1], f"parity-contig-ssm: contiguous and paged engines "
          f"differ on cuda\n  {toks}\n  {paged[1]}")
    _eager_serial(torch, "parity-contig-ssm", toks, cfg, plan, params, reqs(),
                  paged=False)
    print(f"parity-contig-ssm: mamba2-370m float32 contiguous engine on cuda "
          f"vs cpu: live logits of every step ({runs['cuda'][2].numel()} "
          f"values) max_abs_err={err:.3e} (|logit| max {mx:.2f}, tol rtol="
          f"{SSM_PARITY_TOL['rtol']} atol={SSM_PARITY_TOL['atol']}); greedy "
          f"tokens identical to cpu, to the eager engine and to the paged "
          f"engine on cuda: 4 requests x 16 tokens, {n_distinct} distinct")


def _prefix_requests(Request, rng, n, lo, hi, max_new, vocab, shared=100):
    """Requests behind one shared ``shared``-token prefix, each with its own
    random suffix of lo to hi tokens: the traffic the prefix cache serves
    (a system prompt).  A prefix that is not a multiple of the page ends
    mid-page, so every hit copies that page on write."""
    import numpy as np
    head = rng.randint(2, vocab, shared)
    return [Request(rid=i, prompt=np.concatenate(
                [head, rng.randint(2, vocab, int(L))]).astype(np.int32),
                    max_new_tokens=max_new)
            for i, L in enumerate(rng.randint(lo, hi + 1, n))]


def phase_parity_prefix(torch):
    """The prefix cache at full width, fp32: tinyllama requests behind a
    shared 40-token prefix (2 pages and 8 tokens: every hit copies a page
    on write), 2 slots, so later admissions hit what earlier prefills
    inserted.  Float pools one-token (weights x10) and int8 pools with
    speculative=4, drafts searched along the cache's token paths (x1.75):
    the card against the CPU (tokens identical, live logits within
    tolerance), against the same engine without the cache and against
    itself with graphs=False, overlap=False (tokens identical); COW copies
    and skipped prefill tokens on the card; leak-free after drain() and a
    full evict."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import model
    from repro_torch.core.partition import ShardingPlan
    from repro_torch.serving import Request
    cfg = get_config("tinyllama-42m")
    base = model.init_params(cfg, ShardingPlan(kv_cache_dtype="float32"),
                             torch.Generator().manual_seed(0), device="cpu",
                             dtype="float32")

    def reqs():
        return _prefix_requests(Request, np.random.RandomState(5), 6, 4, 60,
                                16, cfg.vocab_size, shared=40)

    for name, kvd, scale, k, tol in (
            ("parity-prefix", "float32", 10, 0, PARITY_TOL),
            ("parity-prefix-spec-int8", "int8", 1.75, 4, INT8_PARITY_TOL)):
        plan = ShardingPlan(kv_cache_dtype=kvd)
        params = model.tree_map(lambda t, s=scale: t * s, base)
        kw = dict(slots=2, speculative=k)
        runs = {dev: _run_engine(torch, cfg, plan, params, reqs(), dev,
                                 prefix_cache=True, **kw)
                for dev in ("cuda", "cpu")}
        err, mx = _same(name, runs["cuda"][1:3], runs["cpu"][1:3], tol)
        toks = runs["cuda"][1]
        off = _run_engine(torch, cfg, plan, params, reqs(), "cuda", **kw)[1]
        check(off == toks, f"{name}: the cache on and off differ on cuda\n  "
                           f"{toks}\n  {off}")
        _eager_serial(torch, name, toks, cfg, plan, params, reqs(),
                      prefix_cache=True, **kw)
        st = runs["cuda"][0].stats
        check(st.cow_copies > 0 and st.prefill_tokens_skipped > 0,
              f"{name}: no prefix reuse on cuda {st}")
        check(not k or st.spec_accepted > 0, f"{name}: no draft accepted {st}")
        print(f"{name}: {kvd} pools, speculative={k}, 6 requests behind a "
              f"40-token prefix, 2 slots, on cuda vs cpu: live logits "
              f"max_abs_err={err:.3e} (|logit| max {mx:.2f}, tol rtol="
              f"{tol['rtol']} atol={tol['atol']}); greedy tokens identical to "
              f"cpu, to the cache off and to the eager-serial engine on cuda "
              f"({len({t for r in toks for t in r})} distinct); hits="
              f"{st.prefix_hits}/{st.prefix_lookups} prefill_tokens_skipped="
              f"{st.prefill_tokens_skipped} cow_copies={st.cow_copies}"
              + (f" drafted={st.spec_drafted} accepted={st.spec_accepted}"
                 if k else ""))


def _two_prefix_requests(Request, rng, n, lo, hi, max_new, vocab, shared=40):
    """``_prefix_requests`` behind two system prompts, request i behind the
    (i mod 2)-th: prefix affinity then spreads them over two replicas."""
    import numpy as np
    heads = [rng.randint(2, vocab, shared) for _ in range(2)]
    return [Request(rid=i, prompt=np.concatenate(
                [heads[i % 2], rng.randint(2, vocab, int(L))]).astype(np.int32),
                    max_new_tokens=max_new)
            for i, L in enumerate(rng.randint(lo, hi + 1, n))]


def _replica_counts(eng):
    """Per-replica (role, routed, prefills, tokens, handoffs out/in, pages
    out/in)."""
    return [(x.role, x.routed, x.prefills, x.decoded_tokens, x.handoffs_out,
             x.handoffs_in, x.pages_transferred_out, x.pages_transferred_in)
            for x in eng.stats.replicas]


def phase_parity_dp(torch, name="parity-dp", **reps):
    """Replicas on the card, fp32 at full width and depth: tinyllama (x10
    float pools, x1.75 int8 pools) over dp = 2 replicas of 2 slots (or
    ``disagg``), FCFS with the prefix cache, 8 requests behind two 40-token
    system prompts: the card against the CPU (greedy tokens identical,
    live logits within tolerance, the same routing and per-replica
    counters, handoffs included) and against itself with graphs=False,
    overlap=False; every replica leak-free.  dp = 2 is held against dp = 1
    on the CPU only (the tests): on the card the matmul's plan may change
    with M = 2 x slots rows."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import model
    from repro_torch.core.partition import ShardingPlan
    from repro_torch.serving import Request
    reps = reps or dict(dp=2)
    cfg = get_config("tinyllama-42m")
    base = model.init_params(cfg, ShardingPlan(kv_cache_dtype="float32"),
                             torch.Generator().manual_seed(0), device="cpu",
                             dtype="float32")

    def reqs():
        return _two_prefix_requests(Request, np.random.RandomState(5), 8, 4,
                                    60, 16, cfg.vocab_size)

    for kvd, scale, tol in (("float32", 10, PARITY_TOL),
                            ("int8", 1.75, INT8_PARITY_TOL)):
        plan = ShardingPlan(kv_cache_dtype=kvd)
        params = model.tree_map(lambda t, s=scale: t * s, base)
        kw = dict(slots=2, prefix_cache=True, **reps)
        runs = {dev: _run_engine(torch, cfg, plan, params, reqs(), dev, **kw)
                for dev in ("cuda", "cpu")}
        err, mx = _same(f"{name}[{kvd}]", runs["cuda"][1:3], runs["cpu"][1:3],
                        tol)
        toks = runs["cuda"][1]
        _eager_serial(torch, f"{name}[{kvd}]", toks, cfg, plan, params, reqs(),
                      **kw)
        eng, cpu = runs["cuda"][0], runs["cpu"][0]
        st = eng.stats
        counts = _replica_counts(eng)
        check(counts == _replica_counts(cpu) and (st.handoffs,
              st.pages_transferred, st.prefix_hits, st.cow_copies) ==
              (cpu.stats.handoffs, cpu.stats.pages_transferred,
               cpu.stats.prefix_hits, cpu.stats.cow_copies),
              f"{name}[{kvd}]: per-replica counters differ card vs cpu\n  "
              f"{counts}\n  {_replica_counts(cpu)}")
        check(all(c[3] > 0 for c in counts) if "disagg" not in reps
              else st.handoffs == 8, f"{name}[{kvd}]: {counts}")
        print(f"{name}: {kvd} pools, {reps}, 2 slots a replica, 8 requests "
              f"behind two 40-token prefixes, on cuda vs cpu: live logits "
              f"max_abs_err={err:.3e} (|logit| max {mx:.2f}, tol rtol="
              f"{tol['rtol']} atol={tol['atol']}); greedy tokens identical to "
              f"cpu and to the eager-serial engine on cuda "
              f"({len({t for r in toks for t in r})} distinct); replicas "
              f"(role, routed, prefills, tokens, handoffs out/in, pages "
              f"out/in) {counts} equal on cpu; handoffs={st.handoffs} "
              f"pages_transferred={st.pages_transferred} prefix_hits="
              f"{st.prefix_hits}/{st.prefix_lookups} cow_copies="
              f"{st.cow_copies}")


def phase_parity_disagg(torch):
    """``phase_parity_dp`` at disagg 1:1: every request prefills on
    replica 0 and hands off to replica 1; handoff counts card == cpu."""
    phase_parity_dp(torch, "parity-disagg", dp=2, disagg=(1, 1))


# parity-elastic's membership schedule, (tick, "scale", N) or (tick, "kill",
# r): 2 -> 3 replicas, replica 1 killed (its orphans re-admitted), -> 1 when
# replica 0 has a free slot (replica 1's last slot migrates), then -> 2
ELASTIC_PARITY_EVENTS = ((4, "scale", 3), (10, "kill", 1), (42, "scale", 1),
                         (46, "scale", 2))


def _membership(events, log):
    """A ``membership_hook`` applying ``events`` at the top of the tick each
    names (as the launcher's ``--scale-events`` does); each change appends
    (tick, kind, value, replicas after it, migrations so far) to ``log``, a
    kill its ``RecoveryReport``'s rids too."""
    pending = list(events)

    def hook(eng):
        while pending and eng.stats.ticks >= pending[0][0]:
            tick, kind, val = pending.pop(0)
            if kind == "scale":
                eng.scale_to(val)
                log.append((tick, kind, val, eng.R, eng.stats.migrations))
            else:
                rep = eng.kill_replica(val)
                log.append((tick, kind, val, eng.R, eng.stats.migrations,
                            rep.replica, rep.active_rids, rep.queued_rids))
    return hook


def _elastic_counts(eng):
    """(scale events, crashes, migrations, migrated pages, readmitted,
    preemptions, pages transferred, replicas)."""
    st = eng.stats
    return (st.scale_events, st.crashes, st.migrations, st.migrated_pages,
            st.readmitted, st.preemptions, st.pages_transferred, eng.R)


def phase_parity_elastic(torch):
    """Elastic replicas on the card, fp32 at full width and depth:
    tinyllama (x10 float pools, x1.75 int8 pools) over dp = 2 replicas of
    2 slots, FCFS with the prefix cache, 10 requests behind two 40-token
    system prompts, under ``ELASTIC_PARITY_EVENTS`` (a join, a crash, a
    drain that migrates a slot's pages, a join): the card against the CPU
    (greedy tokens identical, live logits within tolerance, each request's
    replica, the membership counters and the kill's ``RecoveryReport``
    equal) and against itself with graphs=False, overlap=False; every
    replica leak-free after ``drain()``.  Every membership change drops
    the step graphs and captures them again over the new pools.  Launch
    counts are set to 0 just before each card engine serves and read just
    after (the CPU path counts none).  -> the card runs' launches, summed
    over both pool dtypes."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import model
    from repro_torch.core.partition import ShardingPlan
    from repro_torch.kernels import ops
    from repro_torch.serving import Request
    name = "parity-elastic"
    cfg = get_config("tinyllama-42m")
    base = model.init_params(cfg, ShardingPlan(kv_cache_dtype="float32"),
                             torch.Generator().manual_seed(0), device="cpu",
                             dtype="float32")

    def reqs():
        return _two_prefix_requests(Request, np.random.RandomState(6), 10, 4,
                                    60, 16, cfg.vocab_size)

    launches = dict.fromkeys(ops.launch_counts(), 0)
    for kvd, scale, tol in (("float32", 10, PARITY_TOL),
                            ("int8", 1.75, INT8_PARITY_TOL)):
        plan = ShardingPlan(kv_cache_dtype=kvd)
        params = model.tree_map(lambda t, s=scale: t * s, base)
        runs = {}
        for dev in ("cuda", "cpu"):
            log, rs = [], reqs()
            torch.cuda.synchronize()
            ops.reset_launch_counts()        # this engine's path starts here
            out = _run_engine(
                torch, cfg, plan, params, rs, dev, slots=2,
                prefix_cache=True, dp=2,
                setup=lambda e, log=log: setattr(
                    e, "membership_hook",
                    _membership(ELASTIC_PARITY_EVENTS, log)))
            torch.cuda.synchronize()
            for kn, v in ops.launch_counts().items():   # ends here
                launches[kn] += v
            runs[dev] = (out, log, [r.replica for r in rs])
        (eng, *got), log, reps = runs["cuda"]
        (cpu, *want), cpu_log, cpu_reps = runs["cpu"]
        err, mx = _same(f"{name}[{kvd}]", got[:2], want[:2], tol)
        counts = _elastic_counts(eng)
        check((log, reps, counts) == (cpu_log, cpu_reps, _elastic_counts(cpu)),
              f"{name}[{kvd}]: membership differs card vs cpu\n  {log} "
              f"{reps} {counts}\n  {cpu_log} {cpu_reps} {_elastic_counts(cpu)}")
        check(len(log) == len(ELASTIC_PARITY_EVENTS) and counts[1] == 1 and
              counts[2] > 0, f"{name}[{kvd}]: the schedule did not apply, "
                             f"kill or migrate: {log} {counts}")
        _eager_serial(torch, f"{name}[{kvd}]", got[0], cfg, plan, params,
                      reqs(), slots=2, prefix_cache=True, dp=2,
                      setup=lambda e: setattr(
                          e, "membership_hook",
                          _membership(ELASTIC_PARITY_EVENTS, [])))
        print(f"{name}: {kvd} pools, dp 2 -> 3 -> kill -> 1 -> 2 at ticks "
              f"{[e[0] for e in ELASTIC_PARITY_EVENTS]}, 2 slots a replica, "
              f"10 requests behind two 40-token prefixes, on cuda vs cpu: "
              f"live logits max_abs_err={err:.3e} (|logit| max {mx:.2f}, "
              f"tol rtol={tol['rtol']} atol={tol['atol']}); greedy tokens "
              f"identical to cpu and to the eager-serial engine on cuda; "
              f"changes {log}; (scale_events, crashes, migrations, "
              f"migrated_pages, readmitted, preemptions, pages_transferred, "
              f"dp_final)={counts} and each request's replica {reps} equal "
              f"on cpu; leak-free after drain()")
    for kn in ELASTIC_KERNELS:
        check(launches[kn] > 0, f"{name}: kernel {kn} never launched")
    print(f"{name}: launches on cuda "
          f"{ {kn: v for kn, v in launches.items() if v} }")
    return launches


# parity-spill's seamless: full width (d 1024, 16 heads of 64, 4096 frames,
# vocab 256,206) cut to 2 decoder and 2 encoder layers of 24 each
SPILL_SM_DEPTH = dict(n_layers=2, n_enc_layers=2)


class _SpillMeter:
    """Wraps ``ServingEngine``'s spill and restore for the duration of a
    ``with``: every call's wall (the card synchronized before and after),
    pages and payload bytes, under ``tag`` and the device, and every
    restore's writes ``(id of the engine, replica, kind, pages,
    payloads)``."""

    def __init__(self, torch, cls):
        self.torch, self.cls = torch, cls
        self.calls = {"spill": [], "restore": []}
        self.writes = []
        self.tag = ""
        self._now = None

    def __enter__(self):
        cls, torch, meter = self.cls, self.torch, self
        self._orig = {n: getattr(cls, n) for n in (
            "spill_state", "_restore_from_spill", "_gather_pages",
            "_scatter_pages")}
        orig = self._orig

        def timed(what):
            def call(eng, *a, **k):
                cuda = eng.device.type == "cuda"
                if cuda:
                    torch.cuda.synchronize()
                meter._now = [0, 0]
                t0 = time.perf_counter()
                out = orig[what](eng, *a, **k)
                if cuda:
                    torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0)
                meter.calls[what.strip("_").split("_")[0]].append(
                    (meter.tag, eng.device.type, ms, *meter._now))
                return out
            return call

        def nbytes(ts):
            return sum(t.numel() * t.element_size() for t in ts)

        def gather(eng, r, kind, pages):
            out = orig["_gather_pages"](eng, r, kind, pages)
            meter._now[0] += len(pages)
            meter._now[1] += nbytes(out)
            return out

        def scatter(eng, r, kind, pages, payloads):
            orig["_scatter_pages"](eng, r, kind, pages, payloads)
            meter._now[0] += len(pages)
            meter._now[1] += nbytes(payloads)
            meter.writes.append((id(eng), r, kind, list(pages), payloads))

        cls.spill_state = timed("spill_state")
        cls._restore_from_spill = timed("_restore_from_spill")
        cls._gather_pages, cls._scatter_pages = gather, scatter
        return self

    def __exit__(self, *exc):
        for n, fn in self._orig.items():
            setattr(self.cls, n, fn)

    def line(self, what, device="cuda"):
        """The ``device`` calls of ``what`` that moved pages: tag, ms, MB,
        pages and GB/s each."""
        return "; ".join(
            f"{tag}: {ms:.3f} ms {b / 1e6:.3f} MB {pg} pages "
            f"{b / ms / 1e6:.2f} GB/s"
            for tag, dev, ms, pg, b in self.calls[what]
            if dev == device and pg)


def _on_card(eng, r, kind, pages):
    """Replica ``r``'s ``pages`` of every pool of ``kind``, copied on the
    engine's device."""
    idx = eng._page_index(r, pages)
    return [pool.index_select(1, idx) for pool in eng._kind_pools(kind)]


def _pages_equal(torch, eng, r, kind, pages, want):
    return all(torch.equal(a, b) for a, b in
               zip(_on_card(eng, r, kind, pages), want, strict=True))


def _serve_all(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run()
    check(all(r.done for r in reqs) and eng._inflight is None,
          f"parity-spill: unfinished requests on {eng.device}")
    return [list(r.out_tokens) for r in reqs]


def _spill_round(torch, cfg, plan, params, reqs, dev, meter, label):
    """parity-spill on one device: a cold dp-2 engine with a store serves
    ``reqs()``, then ``scale_to(1)`` (the drain spills replica 1's radix
    entries, the restore writes them into replica 0), pages checked
    against the pre-drain copies; one more request and tick, checked
    again; the survivor spills everything; a fresh dp-2 engine starts from
    the store and re-serves the prompts.  Pools of 64 pages a replica: no
    eviction before the checks.  -> (cold tokens, warm tokens, summary of
    the store, counters and placements, entries restored at the scale,
    pages checked); both engines leak-free."""
    import numpy as np

    from repro_torch.serving import HostSpillStore, Request, ServingEngine

    def build(**kw):
        return ServingEngine.build_paged(cfg, plan, 2, 256, params,
                                         page_size=16, n_pages=64,
                                         prefill_chunk=32, prefix_cache=True,
                                         dp=2, device=dev, **kw)

    store = HostSpillStore()
    eng = build(spill=store)
    cold_reqs = reqs()
    cold = _serve_all(eng, cold_reqs)
    before = {toks: _on_card(eng, 1, "kv", pages)
              for toks, pages in eng.prefix_caches[1].entries()}
    check(before, f"parity-spill: replica 1 cached nothing on {dev}")
    meter.writes.clear()
    meter.tag = f"{label}, drain 2 -> 1 / restore into replica 0"
    eng.scale_to(1)
    key_of = {id(pl): toks for toks, (_, pl) in store.radix.items()}
    restored = [(key_of[id(pl)], pages) for e, r, kind, pages, pl
                in meter.writes if e == id(eng)]
    meter.writes.clear()
    check(restored and all(t in before for t, _ in restored),
          f"parity-spill: nothing of replica 1 restored on {dev}")

    def verify(when):
        """Every restored page the cache holds, at its place on the
        entry's path, against the pre-drain copy (a page allocated for an
        entry whose prefix the tree already held was dropped at once, and
        may have been allocated again since).  -> pages checked."""
        n_checked = 0
        for toks, pages in restored:
            n, held = eng.prefix_caches[0].lookup(list(toks))
            keep = [i for i, (p, q) in enumerate(zip(held, pages)) if p == q]
            check(n == len(toks) and keep, f"parity-spill: {toks[:4]}... is "
                                           f"not cached {when} on {dev}")
            check(_pages_equal(torch, eng, 0, "kv", [pages[i] for i in keep],
                               [w[:, keep] for w in before[toks]]),
                  f"parity-spill: restored pages differ from the pre-drain "
                  f"pages {when} on {dev}: {toks[:4]}...")
            n_checked += len(keep)
        return n_checked

    verify("after the restore")
    late = Request(rid=99, prompt=np.arange(3, 40, dtype=np.int32),
                   max_new_tokens=4)
    eng.submit(late)
    eng.tick()                       # its plan resets recycled scale rows
    n_checked = verify("after the next plan")
    eng.run()
    meter.tag = f"{label}, every entry of dp 1 / warm start at dp 2"
    eng.spill_state(store)
    summary = [sorted((t, n) for t, (n, _) in store.radix.items()),
               store.pages_saved, store.pages_restored, list(late.out_tokens)]
    eng.drain()
    leak_check("parity-spill", eng)
    del eng
    warm = build(spill=store)
    meter.writes.clear()
    summary.append(store.pages_restored)
    again = [Request(rid=r.rid + 100, prompt=r.prompt.copy(),
                     max_new_tokens=r.max_new_tokens) for r in cold_reqs]
    toks = _serve_all(warm, again)
    st = warm.stats
    summary += [st.prefix_hits, st.prefill_tokens_skipped,
                [r.replica for r in again], _replica_counts(warm)]
    warm.drain()
    leak_check("parity-spill", warm)
    return cold, toks, summary, len(restored), n_checked


def phase_parity_spill(torch):
    """Host spill of cached pages on the card (``_spill_round``): tinyllama
    at full width and depth in fp32 (x10 float pools, x1.75 int8 pools), 2
    replicas of 2 slots, FCFS with the prefix cache, parity-elastic's 10
    requests behind two 40-token prefixes; the card against the CPU.
    Then the cross-KV warm start on seamless at full width
    (``SPILL_SM_DEPTH``), card only.  Launch counts are set to 0 just
    before each card round (tinyllama: the cold run, the scale, the warm
    start; seamless: the warm start) and read just after it.  -> those
    launches, summed."""
    import dataclasses
    import functools

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import model
    from repro_torch.core.partition import ShardingPlan
    from repro_torch.kernels import ops
    from repro_torch.serving import HostSpillStore, Request, ServingEngine
    name = "parity-spill"
    cfg = get_config("tinyllama-42m")
    base = model.init_params(cfg, ShardingPlan(kv_cache_dtype="float32"),
                             torch.Generator().manual_seed(0), device="cpu",
                             dtype="float32")

    def reqs():
        return _two_prefix_requests(Request, np.random.RandomState(6), 10, 4,
                                    60, 16, cfg.vocab_size)

    launches = dict.fromkeys(ops.launch_counts(), 0)

    def count(fn):
        torch.cuda.synchronize()
        ops.reset_launch_counts()        # the warm engine's path starts here
        out = fn()
        torch.cuda.synchronize()
        for kn, v in ops.launch_counts().items():   # ends here
            launches[kn] += v
        return out

    with _SpillMeter(torch, ServingEngine) as meter:
        for kvd, scale in (("float32", 10), ("int8", 1.75)):
            plan = ShardingPlan(kv_cache_dtype=kvd)
            params = model.tree_map(lambda t, s=scale: t * s, base)
            got = {}
            for dev in ("cuda", "cpu"):
                fn = functools.partial(_spill_round, torch, cfg, plan, params,
                                       reqs, dev, meter, kvd)
                got[dev] = count(fn) if dev == "cuda" else fn()
            cold, warm, summary, n_rest, n_checked = got["cuda"]
            check(warm == cold, f"{name}[{kvd}]: warm-start tokens differ "
                                f"from the cold run's on cuda\n  {cold}\n  "
                                f"{warm}")
            check((cold, warm) == got["cpu"][:2], f"{name}[{kvd}]: tokens "
                                                 f"differ card vs cpu")
            check(summary == got["cpu"][2] and n_rest == got["cpu"][3],
                  f"{name}[{kvd}]: store, counters or placement differ card "
                  f"vs cpu\n  {summary}\n  {got['cpu'][2]}")
            check(summary[5] > 0, f"{name}[{kvd}]: no prefix hit after the "
                                  f"warm start")
            print(f"{name}: tinyllama-42m fp32, {kvd} pools, dp 2 x 2 slots, "
                  f"10 requests behind two 40-token prefixes; scale_to(1) "
                  f"spilled replica 1 and restored {n_rest} entries into "
                  f"replica 0: pages and scale rows torch.equal to the "
                  f"pre-drain pages on cuda, {n_checked} of them again after "
                  f"the next plan; warm start (pages_saved={summary[1]}, "
                  f"pages_restored={summary[2]} -> {summary[4]}): tokens "
                  f"identical to the cold run's and to cpu, prefix_hits="
                  f"{summary[5]} prefill_tokens_skipped={summary[6]}, "
                  f"replicas {summary[7]} equal on cpu")
            del got
            _free_card(torch)

        # the cross-KV warm start: seamless at full width, cut depth
        sm = dataclasses.replace(get_config("seamless-m4t-large-v2"),
                                 **SPILL_SM_DEPTH)
        plan = ShardingPlan()
        params = model.init_params(sm, plan, torch.Generator(
            device="cuda").manual_seed(0), device="cuda")
        frames = np.random.RandomState(41).randn(
            sm.enc_seq_len, sm.d_model).astype(np.float32)
        prompt = np.random.RandomState(42).randint(2, sm.vocab_size, 40)

        def build(**kw):
            return ServingEngine.build_paged(sm, plan, 2, 256, params,
                                             page_size=16, prefill_chunk=32,
                                             device="cuda", **kw)

        def one(rid):
            return [Request(rid=rid, prompt=prompt.astype(np.int32),
                            max_new_tokens=16, frames=frames)]

        eng = build()
        cold = _serve_all(eng, one(0))
        (key, pages), = eng.cross_caches[0].entries()
        before = _on_card(eng, 0, "cross", pages)
        meter.tag = "seamless, one encode / warm start"
        store = eng.spill_state(HostSpillStore())
        eng.drain()
        del eng
        _free_card(torch)

        def warm_start():
            w = build(spill=store)
            (key2, pages2), = w.cross_caches[0].entries()
            check(key2 == key and _pages_equal(torch, w, 0, "cross", pages2,
                                               before),
                  f"{name}[seamless]: restored cross pages differ from the "
                  f"spilled encode's")
            return w, _serve_all(w, one(1))

        w, warm = count(warm_start)
        meter.writes.clear()
        st = w.stats
        check(warm == cold, f"{name}[seamless]: warm-start tokens differ from "
                            f"the cold run's\n  {cold}\n  {warm}")
        check((st.cross_hits, st.cross_encodes) == (1, 0),
              f"{name}[seamless]: cross_hits={st.cross_hits} "
              f"cross_encodes={st.cross_encodes} after the warm start")
        w.drain()
        leak_check(name, w)
        print(f"{name}[seamless]: seamless-m4t-large-v2 at full width, "
              f"{SPILL_SM_DEPTH}, bfloat16, {sm.enc_seq_len} frames: one "
              f"encode ({len(pages)} cross pages) spilled and restored into "
              f"a fresh engine, torch.equal; the same frames then hit "
              f"(cross_hits={st.cross_hits} cross_encodes={st.cross_encodes})"
              f" with the cold run's {len(warm[0])} tokens")
        del w
        _free_card(torch)
    print(f"{name}: spill on cuda (pinned host, synchronized): "
          f"{meter.line('spill')}")
    print(f"{name}: restore on cuda: {meter.line('restore')}")
    for kn in ELASTIC_KERNELS:
        check(launches[kn] > 0, f"{name}: kernel {kn} never launched")
    print(f"{name}: launches on cuda "
          f"{ {kn: v for kn, v in launches.items() if v} }")
    return launches


def _serve_arrivals(eng, reqs, first, every, preempt=None, max_ticks=3000):
    """Serve ``reqs`` with arrivals over time: the first ``first`` at
    once, then one more every ``every`` ticks; ``preempt(eng, tick)`` may
    evict slots before each tick.  -> each request's tokens."""
    waiting = list(reqs)
    tick = 0
    while waiting or eng.has_pending() or \
            any(a is not None for a in eng.admissions):
        check(tick < max_ticks, "serve: ran out of ticks")
        while waiting and (len(reqs) - len(waiting) < first or
                           tick >= every * (len(reqs) - len(waiting) -
                                            first + 1)):
            eng.submit(waiting.pop(0))
        if preempt is not None:
            preempt(eng, tick)
        eng.tick()
        tick += 1
    eng._barrier()
    check(all(r.done for r in reqs), "serve: unfinished requests")
    check(eng.drain() == 0, "serve: slots still admitted")
    leak_check("serve", eng)
    return [r.out_tokens for r in reqs]


def phase_parity_preempt(torch):
    """Preemption on the card, fp32 at full width.  tinyllama (weights x10):
    ``PriorityScheduler(preemption=True)`` with every 3rd request urgent,
    arriving while low-priority requests hold both slots, the victims'
    pages donated to the prefix cache, overlap on (verdicts deferred past
    collect) and off: greedy tokens identical to FCFS without preemption,
    preemptions > 0.  mamba2-370m from float32 and int8 slabs with
    ``preempt(b)`` forced mid-prefill and mid-decode (each slab stashed on
    the host and restored): tokens identical to the uninterrupted run,
    slab_restores > 0."""
    import dataclasses
    import functools

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import model
    from repro_torch.core.partition import ShardingPlan
    from repro_torch.serving import (PriorityScheduler, Request,
                                     ServingEngine)
    cfg = get_config("tinyllama-42m")
    plan = ShardingPlan(kv_cache_dtype="float32")
    params = model.tree_map(lambda t: t * 10, model.init_params(
        cfg, plan, torch.Generator().manual_seed(0), device="cpu",
        dtype="float32"))

    def reqs():
        out = _requests(Request, np.random.RandomState(9), 9, 8, 70, 16,
                        cfg.vocab_size)
        for r in out:
            r.priority = 10 if r.rid % 3 == 2 else 0
        return out

    def engine(**kw):
        return ServingEngine.build_paged(cfg, plan, 2, 256, params,
                                         page_size=16, prefill_chunk=32,
                                         device="cuda", **kw)

    want = _serve_arrivals(engine(), reqs(), 2, 6)
    for overlap in (True, False):
        eng = engine(prefix_cache=True, overlap=overlap,
                     scheduler=functools.partial(PriorityScheduler,
                                                 preemption=True))
        got = _serve_arrivals(eng, reqs(), 2, 6)
        st = eng.stats
        check(got == want, f"parity-preempt: priority with preemption "
                           f"(overlap={overlap}) and FCFS differ\n  {got}\n  "
                           f"{want}")
        check(st.preemptions > 0, f"parity-preempt: nothing preempted {st}")
        print(f"parity-preempt: tinyllama-42m float32, priority with "
              f"preemption, overlap={'on' if overlap else 'off'}: greedy tokens "
              f"identical to FCFS without preemption (9 requests x 16); "
              f"preemptions={st.preemptions} plan_invalidations="
              f"{st.plan_invalidations} prefill_tokens_skipped="
              f"{st.prefill_tokens_skipped} ticks={st.ticks}")

    cfg = dataclasses.replace(get_config("mamba2-370m"), dtype="float32")
    params = model.init_params(cfg, plan, torch.Generator().manual_seed(0),
                               device="cpu")

    def ssm_reqs():
        return [Request(rid=i, prompt=np.random.RandomState(7 + i).randint(
                    2, cfg.vocab_size, L).astype(np.int32), max_new_tokens=16)
                for i, L in enumerate((23, 77, 40))]

    def force(eng, tick):
        """Preempt a prefilling slot at tick 2 and a decoding one at ticks
        8 and 20."""
        state = {2: "prefill", 8: "decode", 20: "decode"}.get(tick)
        for b in range(eng.B):
            if state and eng.slot_state[b] == state:
                eng.preempt(b)
                return

    for slabs in ("float32", "int8"):
        plan_s = ShardingPlan(kv_cache_dtype="float32",
                              ssm_cache_dtype="int8" if slabs == "int8" else "")

        def engine_s():
            return ServingEngine.build_paged(cfg, plan_s, 2, 256, params,
                                             page_size=16, prefill_chunk=32,
                                             device="cuda")

        want = _serve_arrivals(engine_s(), ssm_reqs(), 3, 1)
        eng = engine_s()
        got = _serve_arrivals(eng, ssm_reqs(), 3, 1, preempt=force)
        st = eng.stats
        check(got == want, f"parity-preempt[mamba2 {slabs} slabs]: forced "
                           f"preemption changed tokens\n  {got}\n  {want}")
        check(st.slab_restores > 0 and st.slab_restores == st.preemptions,
              f"parity-preempt[mamba2 {slabs} slabs]: {st.preemptions} "
              f"preemptions, {st.slab_restores} restores")
        print(f"parity-preempt: mamba2-370m float32, {slabs} slabs, "
              f"preempt(b) forced mid-prefill and mid-decode: greedy tokens "
              f"identical to the uninterrupted run "
              f"({len({t for r in got for t in r})} distinct); preemptions="
              f"{st.preemptions} slab_restores={st.slab_restores} "
              f"prefill_tokens_skipped={st.prefill_tokens_skipped}")


SERVE_PHASES = {
    # name: (arch, pool dtype, slab dtype, speculative k, prompts)
    "serve": ("tinyllama-42m", "bfloat16", "", 0, "random"),
    "serve-spec": ("tinyllama-42m", "bfloat16", "", 4, "motif"),
    "serve-int8": ("tinyllama-42m", "int8", "", 0, "random"),
    "serve-spec-int8": ("tinyllama-42m", "int8", "", 4, "motif"),
    "serve-ssm": ("mamba2-370m", "bfloat16", "", 0, "random"),
    "serve-ssm-int8": ("mamba2-370m", "bfloat16", "int8", 0, "random"),
    "serve-contig": ("tinyllama-42m", "bfloat16", "", 0, "random"),
    "serve-contig-int8": ("tinyllama-42m", "int8", "", 0, "random"),
    "serve-prefix": ("tinyllama-42m", "bfloat16", "", 0, "prefix"),
    "serve-qwen3": ("qwen3-0.6b", "bfloat16", "", 0, "random"),
    "serve-gemma3": ("gemma3-12b", "bfloat16", "", 0, "long"),
    "serve-hymba": ("hymba-1.5b", "bfloat16", "", 0, "long"),
    "serve-mistral": ("mistral-large-123b", "bfloat16", "", 0, "random"),
    "serve-sample": ("tinyllama-42m", "bfloat16", "", 0, "random"),
    "serve-64h": ("tinyllama-42m-64h", "bfloat16", "", 0, "random"),
    "serve-seamless": ("seamless-m4t-large-v2", "bfloat16", "", 0, "frames"),
    "serve-deepseek": ("deepseek-moe-16b", "bfloat16", "", 0, "random"),
    "serve-dp": ("tinyllama-42m", "bfloat16", "", 0, "random"),
    "serve-disagg": ("tinyllama-42m", "bfloat16", "", 0, "random"),
}
# the phases served by replicas on the one card: serve's model and mix, 32
# requests, over 2 replicas of SLOTS slots (their own pools, allocators and
# schedulers, one step set; the router places the requests), or 1 prefill
# and 1 decode replica handing finished page runs over
SERVE_REPLICAS = {"serve-dp": dict(dp=2),
                  "serve-disagg": dict(dp=2, disagg=(1, 1))}
SERVE_REQUESTS = {"serve-dp": 32, "serve-disagg": 32}
# the phases served at a cut depth, full width: mamba2's 48 layers to 12
# (the profiles of the three mamba2 runs took 199 s at 48 layers and 101-131
# s at 24, the host-bound share of the script that varies most from call to
# call); parity-ssm keeps all 48
SERVE_DEPTH = {"serve-ssm": 12, "serve-ssm-int8": 12,
               # mistral's 88 layers hold 245.2 GB of bf16 weights; 20 hold
               # 55.4 GB, with the embedding table and the untied head 57.0 GB
               # on the 80 GB card, beside the pools and the step graphs
               "serve-mistral": 20,
               # gemma3's 48 layers to 24 (4 of its 6-layer window patterns)
               # and hymba's 32 to 16 (full attention at 0, 8 and 15), so
               # that serve-seamless and its profile fit the script's time
               # (their profiles took 78.8 and 105.0 s at full depth)
               "serve-gemma3": 24, "serve-hymba": 16}
# the phases that sample (every other phase is greedy): serve-sample is
# serve's model and mix, drawn with the JAX launcher's top_k 40
SERVE_SAMPLER = {"serve-sample": dict(temperature=0.7, top_k=40)}
# the sampled phases served again eager-serial for their tokens alone (no
# profile)
SAMPLE_AB_PHASES = ("serve-sample",)
# the phases served by the contiguous engine (the others are paged)
CONTIG_PHASES = ("serve-contig", "serve-contig-int8")
# the phases served again with eager steps and the serial loop
AB_PHASES = ("serve", "serve-ssm", "serve-contig")
# the mixer kernels each serving phase must launch: attention in its decode
# or verify ticks (and flash attention in its prefill chunks or whole
# prompts); the SSD scan in its prefill chunks, once per layer, and never in
# a decode tick; a hybrid all three
PHASE_MIXER = {"serve": ("paged_decode_attention",),
               "serve-spec": ("paged_verify_attention",),
               "serve-int8": ("paged_decode_attention_i8",),
               "serve-spec-int8": ("paged_verify_attention_i8",),
               "serve-ssm": ("ssd_scan",),
               "serve-ssm-int8": ("ssd_scan_i8",),
               "serve-contig": ("decode_attention",),
               "serve-contig-int8": ("decode_attention_i8",),
               "serve-prefix": ("paged_decode_attention",),
               "serve-qwen3": ("paged_decode_attention",),
               "serve-gemma3": ("paged_decode_attention",),
               "serve-hymba": ("paged_decode_attention", "flash_attention",
                               "ssd_scan"),
               "serve-mistral": ("paged_decode_attention", "flash_attention"),
               "serve-sample": ("paged_decode_attention",),
               "serve-64h": ("paged_decode_attention",),
               "serve-seamless": ("paged_decode_attention", "flash_attention"),
               "serve-deepseek": ("paged_decode_attention", "flash_attention"),
               "serve-dp": ("paged_decode_attention",),
               "serve-disagg": ("paged_decode_attention",)}
# the norm kernel's three variants: alone (the first layer's input norm),
# with the residual add before it, and mamba2's gated norm
NORMS = ("rmsnorm", "rmsnorm_residual", "rmsnorm_gated")


SLOTS, SB, PSZ, CH, NEW = 8, 256, 16, 32, 32
# serve-gemma3 and serve-hymba: a 2048-token budget, chunks of 128, prompts
# of 512-1536 tokens (half past the window of 1024), weights drawn on the
# card
LONG = dict(sb=2048, ch=128, lo=512, hi=1536)


def _phase_shape(name):
    """(seq_budget, prefill chunk) of serve phase ``name``."""
    kind = SERVE_PHASES[name][4]
    return (LONG["sb"], LONG["ch"]) if kind == "long" else (SB, CH)


def _long_requests(Request, rng, n, lo, hi, max_new, vocab, win):
    """Random prompts of ``lo``-``hi`` tokens, half of them past the arch's
    window ``win`` (1024 for gemma3 and hymba), in a shuffled order."""
    import numpy as np
    lens = np.concatenate([rng.randint(lo, win + 1, n // 2),
                           rng.randint(win + 1, hi + 1, n - n // 2)])
    rng.shuffle(lens)
    return [Request(rid=i, prompt=rng.randint(2, vocab, int(L)).astype(np.int32),
                    max_new_tokens=max_new) for i, L in enumerate(lens)]


# serve-seamless: 16 requests of serve's random mix over 4 frame tensors
# (request i the (i mod 4)-th): 4 encodes, 12 cross hits
SM_FRAME_GROUPS = 4


def _frames_requests(Request, rng, n, lo, hi, max_new, vocab, frames):
    """``_requests``'s mix, request i carrying ``frames[i % len(frames)]``."""
    reqs = _requests(Request, rng, n, lo, hi, max_new, vocab)
    for r in reqs:
        r.frames = frames[r.rid % len(frames)]
    return reqs


def _free_card(torch):
    """Release what the previous phase left on the card (its model,
    pools and graph memory) before the next one draws its own."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _serve_setup(torch, name):
    """Serve phase ``name``'s model, an engine factory and its 16 requests:
    the full-width arch, bfloat16 weights, 8 slots, prompts 16-160 tokens,
    32 new (random prompts, or repetitive motifs where speculation runs;
    serve-prefix: a shared 100-token prefix and 16-64 tokens of each
    request's own, served with the prefix cache; serve-gemma3: full-width
    gemma3-12b drawn on the card, a 2048-token budget, chunks of 128,
    prompts of 512-1536 tokens, ``LONG``; serve-hymba the same for
    full-width hymba-1.5b; serve-mistral: full-width mistral-large-123b
    at 20 of its 88 layers (``SERVE_DEPTH``), drawn on the card, the
    random mix; serve-sample: serve's model and mix, sampled
    (``SERVE_SAMPLER``); serve-seamless: full-width, full-depth
    seamless-m4t-large-v2 drawn on the card, serve's random mix over
    ``SM_FRAME_GROUPS`` frame tensors; serve-dp and serve-disagg: serve's
    model and mix, 32 requests, over ``SERVE_REPLICAS``); the contiguous
    engine for ``CONTIG_PHASES``, else the paged one."""
    import dataclasses
    import functools

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import model
    from repro_torch.core.partition import ShardingPlan
    from repro_torch.serving import Request, SamplerConfig, ServingEngine
    arch, kvd, ssmd, k, kind = SERVE_PHASES[name]
    cfg = get_config(arch)
    if name in SERVE_DEPTH:
        cfg = dataclasses.replace(cfg, n_layers=SERVE_DEPTH[name])
    plan = ShardingPlan(kv_cache_dtype=kvd, ssm_cache_dtype=ssmd)
    sampler = SamplerConfig(**SERVE_SAMPLER.get(name, {}))
    # full-width gemma3 (11.8 B parameters), hymba, mistral (28.5 B at 20
    # layers) and deepseek-moe (16.4 B) draw on the card
    gen = torch.Generator(device="cuda" if kind in ("long", "frames") or
                          arch in ("mistral-large-123b", "deepseek-moe-16b")
                          else "cpu")
    params = model.init_params(cfg, plan, gen.manual_seed(0), device="cuda")
    frames = [np.random.RandomState(100 + g).randn(
        cfg.enc_seq_len, cfg.d_model).astype(np.float32)
        for g in range(SM_FRAME_GROUPS)] if kind == "frames" else None
    make = {"random": _requests, "motif": _motif_requests,
            "prefix": _prefix_requests,
            "long": functools.partial(_long_requests,
                                      win=cfg.sliding_window),
            "frames": functools.partial(_frames_requests,
                                        frames=frames)}[kind]
    lo, hi = {"prefix": (16, 64), "long": (LONG["lo"], LONG["hi"])}.get(
        kind, (16, 160))
    sb, ch = _phase_shape(name)

    def engine(graphs=True, overlap=True, prefix_cache=kind == "prefix"):
        if name in CONTIG_PHASES:
            return ServingEngine(cfg, plan, SLOTS, sb, params, graphs=graphs,
                                 sampler=sampler, device="cuda")
        return ServingEngine.build_paged(cfg, plan, SLOTS, sb, params,
                                         page_size=PSZ, prefill_chunk=ch,
                                         speculative=k, overlap=overlap,
                                         prefix_cache=prefix_cache,
                                         sampler=sampler, graphs=graphs,
                                         device="cuda",
                                         **SERVE_REPLICAS.get(name, {}))

    def requests(seed=0, n=None, new=NEW):
        return make(Request, np.random.RandomState(seed),
                    n or SERVE_REQUESTS.get(name, 16), lo, hi, new,
                    cfg.vocab_size)

    return cfg, engine, requests


# the kernels of the port, by the names their functions carry in a graph
OUR_KERNELS = ("matmul_mma_kernel", "matmul_simt_kernel", "expert_mma_kernel",
               "expert_simt_kernel", "flash_mma_kernel",
               "flash_simt_kernel", "paged_mma_kernel", "paged_simt_kernel",
               "contig_simt_kernel", "ssd_mma_kernel", "ssd_simt_kernel",
               "_rmsnorm_kernel")


def graph_report(torch, name, steps, calls):
    """Each captured step graph of an engine, read node by node: kernel
    nodes (the port's kernels by name, which must be the step's counted
    launches per replay, and PyTorch's, the greedy argmax among them; the
    page-copy graph launches none of the port's kernels, and neither it nor
    the cross-KV write graph takes an argmax), memcpy and memset nodes, the memory its capture reserved, and
    the launches of the phase (counted launches x replays)."""
    out = {}
    for kind, step in steps.items():
        nodes = read_graph(step.graph, names=True)
        kern = [n for k, n in nodes if k == 0]
        ours = sum(any(f in n for f in OUR_KERNELS) for n in kern)
        counted = sum(step.launches.values())
        check(ours == counted, f"{name}: the {kind} graph holds {ours} of the "
                               f"port's kernels, its capture counted {counted}")
        plain = kind in ("copy", "cross", "transfer")   # no ids come out
        check(plain != any("ArgMax" in n for n in kern),
              f"{name}: the {kind} graph {'holds' if plain else 'lacks'}"
              f" an argmax kernel")
        n_copy = sum(k == 1 for k, _ in nodes)
        n_set = sum(k == 2 for k, _ in nodes)
        replays = calls[kind]
        what = (f"PyTorch's {sorted({n[:80] for n in kern})}"
                if kind in ("copy", "transfer")
                else f"the port's {ours} = counted launches per replay, "
                     f"PyTorch's {len(kern) - ours}"
                     f"{'' if plain else ' with the argmax'}")
        print(f"  graph[{kind}]: kernel_nodes={len(kern)} ({what}) "
              f"memcpy_nodes={n_copy} memset_nodes={n_set} "
              f"other_nodes={len(nodes) - len(kern) - n_copy - n_set} "
              f"pool_MiB={step.pool_bytes / 2**20:.2f} replays={replays} "
              f"launches={counted} x {replays} = {counted * replays}")
        out[kind] = dict(kernel_nodes=len(kern), ours=ours, memcpy=n_copy,
                         memset=n_set, pool_bytes=step.pool_bytes,
                         replays=replays)
    return out


def sync_check(torch, name, engine, requests):
    """Serve the phase's requests on a fresh default engine, every tick's
    plan and dispatch (with the preemptions deferred past collect) under
    ``torch.cuda.set_sync_debug_mode("error")`` (collect outside it):
    dispatch never blocks the host, and only collect waits (the JAX
    engine's async-barrier invariant)."""
    eng = engine()
    reqs = requests(seed=2)
    for r in reqs:
        eng.submit(r)

    def strict(fn, what):
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        except RuntimeError as e:
            raise SmokeFailure(f"{name}: {what} synchronized with the card: "
                               f"{e}") from e
        finally:
            torch.cuda.set_sync_debug_mode(0)

    ticks, plan = 0, {}

    def dispatch():
        eng._run_deferred_preempts(plan["tick"])
        eng._dispatch_phase(plan["tick"])

    while eng.has_pending() or any(a is not None for a in eng.admissions):
        strict(lambda: plan.update(tick=eng._plan_phase()), "plan")
        eng._collect_phase()
        strict(dispatch, "dispatch")
        ticks += 1
    eng._barrier()
    check(all(r.done for r in reqs), f"{name}: sync check left requests")
    print(f"  sync check: {ticks} ticks, every plan and dispatch under "
          f"set_sync_debug_mode('error'), collect outside it")


def phase_serve(torch, name, graphs=True, overlap=True):
    """One serve phase (``SERVE_PHASES``) after a warm-up run, on the
    default engine (steps in CUDA graphs, the pipelined tick) or with
    ``graphs=False, overlap=False`` (eager steps, the serial loop).  The
    launch counts are set to 0 just before the requests are submitted and
    read just after the last token; each step call, eager or a replay,
    counts its kernels."""
    import numpy as np

    from repro_torch.core import moe
    from repro_torch.kernels import ops
    arch, kvd, ssmd, k, kind = SERVE_PHASES[name]
    _free_card(torch)                         # the previous phase's model
    cfg, engine, requests = _serve_setup(torch, name)
    sb, ch = _phase_shape(name)
    variant = "graphed-overlap" if graphs else "eager-serial"
    warm = engine(graphs, overlap)                     # first-call costs
    for r in requests(seed=1, n=2, new=4):
        warm.submit(r)
    warm.run()

    t0 = time.perf_counter()
    eng = engine(graphs, overlap)
    build_s = time.perf_counter() - t0
    graph_steps = dict(eng.steps)
    kinds = ("prefill", "decode", "verify", "cross")
    per_phase = {kd: dict.fromkeys(ops.launch_counts(), 0) for kd in kinds}
    calls = dict.fromkeys(kinds, 0)

    def counted(kd, fn):
        def wrapped(*args, **kw):
            before = ops.launch_counts()
            out = fn(*args, **kw)
            for kn, v in ops.launch_counts().items():
                per_phase[kd][kn] += v - before[kn]
            calls[kd] += 1
            return out
        return wrapped

    if eng.paged:
        eng.steps["chunk"] = counted("prefill", eng.steps["chunk"])
    else:
        eng.prefill_fn = counted("prefill", eng.prefill_fn)   # eager, per length
    eng.steps["decode"] = counted("decode", eng.steps["decode"])
    if k:
        eng.steps["verify"] = counted("verify", eng.steps["verify"])
    if "cross" in eng.steps:                  # the encodes (enc-dec)
        eng.steps["cross"] = counted("cross", eng.steps["cross"])
    reqs = requests()
    torch.cuda.synchronize()
    moe.reset_dropped_pairs()
    ops.reset_launch_counts()                 # main path starts here
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    stats = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()            # main path ends here
    dropped = moe.dropped_pairs()
    check(all(r.done for r in reqs), f"{name}: not every request completed")
    check(all(0 < len(r.out_tokens) <= NEW for r in reqs), f"{name}: token counts")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens),
          f"{name}: token ids out of range")
    check(eng.drain() == 0, f"{name}: slots still admitted after run()")
    cross = {}
    if "cross" in graph_steps:
        # one encode alone: the write step's graph replayed (the last
        # request's frames into its own pages again), CUDA events around it
        n_rep, ev = 3, [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        for _ in range(n_rep):
            graph_steps["cross"]()
        ev[1].record()
        ev[1].synchronize()
        cross = dict(encodes=stats.cross_encodes, hits=stats.cross_hits,
                     lookups=stats.cross_lookups,
                     encode_ms=ev[0].elapsed_time(ev[1]) / n_rep)
        want = (SM_FRAME_GROUPS, len(reqs) - SM_FRAME_GROUPS, len(reqs))
        check((stats.cross_encodes, stats.cross_hits, stats.cross_lookups) ==
              want == (calls["cross"], want[1], want[2]),
              f"{name}: {stats.cross_encodes} encodes ({calls['cross']} write "
              f"steps), {stats.cross_hits}/{stats.cross_lookups} cross hits, "
              f"not {want}")
    xfer = {}
    if eng.disagg is not None:
        # one handoff alone: the transfer graph replayed (the last
        # handoff's pages again, into pages drain() freed), CUDA events
        # around it
        check(stats.handoffs == len(reqs) and stats.pages_transferred > 0,
              f"{name}: {stats.handoffs} handoffs of {len(reqs)} requests, "
              f"{stats.pages_transferred} pages")
        n_rep, ev = 20, [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        for _ in range(n_rep):
            graph_steps["transfer"]()
        ev[1].record()
        ev[1].synchronize()
        xfer = dict(handoffs=stats.handoffs, pages=stats.pages_transferred,
                    us=1e3 * ev[0].elapsed_time(ev[1]) / n_rep)
    prefix = ""
    if any(c is not None for c in eng.prefix_caches):
        check(stats.cow_copies > 0 and stats.prefill_tokens_skipped > 0,
              f"{name}: no prefix reuse {stats}")
        cached = sum(c.n_cached_pages for c in eng.prefix_caches)
        prefix = (f"prefix_hit_rate={stats.prefix_hit_rate:.3f} ({stats.prefix_hits}/"
                  f"{stats.prefix_lookups}) prefill_tokens_skipped="
                  f"{stats.prefill_tokens_skipped} of "
                  f"{sum(len(r.prompt) for r in reqs)} cow_copies={stats.cow_copies} "
                  f"cached_pages={cached} ")
    leak_check(name, eng)
    steps = [kd for kd in ("decode", "verify") if calls[kd]]
    check(all(per_phase[kd]["matmul"] > 0 for kd in ["prefill"] + steps),
          f"{name}: matmul not launched in every step kind {per_phase}")
    mixers = PHASE_MIXER[name]
    mixer = mixers[0]               # the decode or verify tick's, or the SSD scan
    n_layers = cfg.n_layers
    specs = cfg.layer_specs()
    has_attn = any("kv" in s.cache_kinds() for s in specs)
    ssm = any("ssm" in s.cache_kinds() for s in specs)
    ffn = any(s.ffn != "none" for s in specs)
    # every step runs the norm family once per norm of the model: the plain
    # norm for the first layer's input (and qwen3's and gemma3's qk-norm, q
    # and k in every layer, and gemma3's post_ln1 and post_ln2), every
    # later norm with the residual add before it fused in (2L of them with
    # an FFN, mamba2's L), and the SSD heads' gated norm in every layer
    # (mamba2, hymba); each decode tick launches as many counted kernels as
    # the layers hold: 4 attention projections and the attention kernel, 6
    # SSD projections and the gated norm, 3 FFN products and ln2, ln1, and
    # the final norm and the head (tinyllama 10L + 2, qwen3 12L + 2, gemma3
    # 14L + 2, mamba2 8L + 2, hymba 17L + 2)
    # (layernorm, seamless's, is plain PyTorch: no norm kernel at all; an
    # enc-dec layer adds cross-attention's 2 projections and its attention
    # kernel, and seamless's plain FFN has 2 products: 10L + 1)
    qk = 2 if cfg.qk_norm else 0
    post = 2 if cfg.sandwich_norm else 0
    ln = cfg.norm == "layernorm"
    xattn = any(s.cross_attn for s in specs)
    per_norm = {"rmsnorm": 0 if ln else 1 + (qk + post) * n_layers,
                "rmsnorm_residual": 0 if ln else n_layers * (2 if ffn else 1),
                "rmsnorm_gated": n_layers if ssm else 0}
    for kd in ["prefill"] + steps:
        got = {kn: per_phase[kd][kn] for kn in NORMS}
        check(got == {kn: v * calls[kd] for kn, v in per_norm.items()},
              f"{name}: norm launches {got} in {calls[kd]} {kd} steps, not "
              f"{per_norm} per step")
    norms_layer = 0 if ln else 1 + ffn + qk + post
    # FFN products a layer: a dense FFN's 3 (2 ungated); an MoE layer's
    # router (float32), its 3 expert products and its shared experts' 3
    dense_k = 3 if cfg.gated_ffn else 2
    n_moe = sum(s.ffn == "moe" for s in specs)
    ffn_k = sum(dense_k if s.ffn == "dense" else
                1 + dense_k + (dense_k if cfg.n_shared_experts else 0)
                if s.ffn == "moe" else 0 for s in specs)
    per_tick = (5 * has_attn + 7 * ssm + 3 * xattn + norms_layer) * n_layers \
        + ffn_k + (1 if ln else 2)
    check(sum(per_phase["decode"].values()) == per_tick * calls["decode"],
          f"{name}: {sum(per_phase['decode'].values())} kernels in "
          f"{calls['decode']} decode ticks, not {per_tick} per tick")
    if not eng.paged:
        # whole-prompt flash attention in every prefill, the decode kernel
        # in every decode tick, once per layer each; no other mixer kernel
        check(per_phase["prefill"]["flash_attention"] == n_layers * calls["prefill"]
              > 0 and per_phase["prefill"][mixer] == 0 and
              per_phase["decode"][mixer] == n_layers * calls["decode"] > 0 and
              per_phase["decode"]["flash_attention"] == 0,
              f"{name}: flash_attention not launched {n_layers} times per "
              f"prefill and {mixer} {n_layers} times per decode tick {per_phase}")
        others = [kn for kn, v in launches.items()
                  if v and kn not in NORMS + ("matmul", "flash_attention", mixer)]
        check(not others, f"{name}: paged, SSM or other decode kernels "
                          f"launched {others}")
    elif eng.has_slabs and has_attn:
        # a hybrid: flash attention and the SSD scan in every layer of every
        # prefill chunk, the paged decode kernel in every layer of every
        # decode tick, and no other mixer kernel
        per = {kd: {kn: per_phase[kd][kn] for kn in mixers}
               for kd in ("prefill", "decode")}
        want = {"prefill": {kn: n_layers * calls["prefill"] if kn != mixer else 0
                            for kn in mixers},
                "decode": {kn: n_layers * calls["decode"] if kn == mixer else 0
                           for kn in mixers}}
        check(per == want and calls["prefill"] > 0 and calls["decode"] > 0,
              f"{name}: mixer launches {per}, not {want}")
        others = [kn for kn, v in launches.items()
                  if v and kn not in NORMS + ("matmul",) + mixers]
        check(not others, f"{name}: unexpected kernels launched {others}")
    elif eng.has_slabs:
        n_ssm = n_layers
        check(per_phase["prefill"][mixer] == n_ssm * calls["prefill"] > 0 and
              per_phase["decode"][mixer] == 0,
              f"{name}: {mixer} not launched {n_ssm} times per prefill chunk "
              f"and never in a decode tick {per_phase}")
        others = [kn for kn, v in launches.items()
                  if v and kn not in NORMS + ("matmul", mixer)]
        check(not others, f"{name}: unexpected kernels launched {others}")
    elif xattn:
        # self- and cross-attention: flash twice per layer in every chunk
        # (causal, then without the mask over the cross keys), paged decode
        # twice per layer in every decode tick (the self pages, then the
        # cross pages); each encode flash once per encoder layer and the
        # encoder's 6 products per layer, then each decoder layer's cross
        # K/V projections
        L_enc = cfg.n_enc_layers
        want = {"prefill": {"flash_attention": 2 * n_layers, "matmul":
                            8 * n_layers + 1, "paged_decode_attention": 0},
                "decode": {"flash_attention": 0, "matmul": 8 * n_layers + 1,
                           "paged_decode_attention": 2 * n_layers},
                "cross": {"flash_attention": L_enc, "matmul":
                          6 * L_enc + 2 * n_layers, "paged_decode_attention": 0}}
        got = {kd: {kn: per_phase[kd][kn] for kn in w} for kd, w in want.items()}
        want = {kd: {kn: v * calls[kd] for kn, v in w.items()}
                for kd, w in want.items()}
        check(got == want and calls["prefill"] > 0 and calls["decode"] > 0
              and calls["cross"] > 0,
              f"{name}: launches {got} in {calls} steps, not {want}")
        others = [kn for kn, v in launches.items()
                  if v and kn not in ("matmul",) + mixers]
        check(not others, f"{name}: unexpected kernels launched {others}")
    else:
        check(per_phase["prefill"]["flash_attention"] > 0,
              f"{name}: flash_attention not launched in prefill {per_phase}")
        check(per_phase["verify" if k else "decode"][mixer] > 0,
              f"{name}: {mixer} not launched {per_phase}")
        check(launches["flash_attention"] > 0,
              f"{name}: kernel flash_attention never launched")
    # the expert matmul: each MoE layer's gate, up and down products in
    # every step, and nowhere else
    for kd in ["prefill"] + steps:
        check(per_phase[kd]["expert_matmul"] == 3 * n_moe * calls[kd],
              f"{name}: expert_matmul launched {per_phase[kd]['expert_matmul']} "
              f"times in {calls[kd]} {kd} steps, not {3 * n_moe} per step")
    if n_moe:
        check(launches["expert_matmul"] > 0, f"{name}: kernel expert_matmul "
                                             f"never launched")
    if eng.paged:
        check(launches["decode_attention"] == launches["decode_attention_i8"] == 0,
              f"{name}: the contiguous decode attention launched in a paged phase")
    if k:
        check(stats.spec_accepted > 0, f"{name}: no draft accepted")
    window = ""
    if cfg.sliding_window:
        # decode row j of a request (j = 0 after the prefill's token) sits
        # at position len(prompt) + j and sees len(prompt) + j + 1 keys; a
        # window layer reads the last sliding_window of them
        rows = [len(r.prompt) + j + 1 for r in reqs
                for j in range(len(r.out_tokens) - 1)]
        bite = sum(n > cfg.sliding_window for n in rows)
        check(bite > 0, f"{name}: no decode row reached past the window")
        window = (f"window_rows={bite} of {len(rows)} decode rows read a "
                  f"window of {cfg.sliding_window} shorter than their prefix "
                  f"(up to {max(rows)} keys) ")
    for kn in (() if ln else ("rmsnorm", "rmsnorm_residual")) + \
            ("matmul",) + mixers + (("rmsnorm_gated",) if ssm else ()):
        check(launches[kn] > 0, f"{name}: kernel {kn} never launched")
    ttft = np.asarray(stats.ttft_s) * 1e3
    per_call = {kd: {kn: v / max(calls[kd], 1) for kn, v in c.items() if v}
                for kd, c in per_phase.items()}
    step_calls = {"chunk": calls["prefill"], "decode": calls["decode"],
                  "verify": calls["verify"], "copy": stats.cow_copies,
                  "cross": calls["cross"], "transfer": stats.handoffs}
    spec = (f"acceptance_rate={stats.spec_accepted / max(stats.spec_drafted, 1):.3f} "
            f"tokens_per_drafted_slot_step={stats.accepted_tokens_per_tick:.3f} "
            f"verify_ticks={calls['verify']} per_verify_tick={per_call['verify']} "
            if k else "")
    store = ", ".join(
        ([f"{kvd} {'pools' if eng.paged else 'lanes'}"] if has_attn else []) +
        ([f"{ssmd or 'float32'} slabs"] if eng.has_slabs else []))
    layout = f"page={PSZ} chunk={ch}" if eng.paged else "contiguous"
    if eng.R > 1:
        layout += (f" dp={eng.R}" + (f" disagg={eng.disagg[0]}:{eng.disagg[1]}"
                                     if eng.disagg else "") +
                   " routed=" + "/".join(str(x.routed) for x in stats.replicas)
                   + " tokens_by_replica=" + "/".join(
                       str(x.decoded_tokens) for x in stats.replicas))
    decoding = (f"sampled {SERVE_SAMPLER[name]}" if name in SERVE_SAMPLER
                else "greedy")
    print(f"{name}: [{variant}] {arch} bf16 weights, {store}, {decoding}, "
          f"speculative={k}, "
          f"{kind} prompts, slots={SLOTS} seq_budget={sb} {layout} "
          f"requests={len(reqs)} tokens={stats.decoded_tokens} "
          f"ticks={stats.ticks} wall_s={wall:.3f} "
          f"wall_per_tick_ms={1e3 * wall / stats.ticks:.3f} "
          f"tok_per_s={stats.decoded_tokens / wall:.1f} "
          f"engine_build_s={build_s:.2f} "
          f"plan_ahead_ticks={stats.plan_ahead_ticks} "
          f"collect_wait_ms={1e3 * stats.collect_wait_s:.1f} "
          f"dispatch_to_collect_share={stats.device_busy_fraction:.3f} "
          f"ttft_p50_ms={np.percentile(ttft, 50):.1f} "
          f"ttft_p99_ms={np.percentile(ttft, 99):.1f} "
          f"tpot_p50_ms={np.median(stats.tpot_s) * 1e3:.2f} {spec}{prefix}"
          f"{window}" + (f"moe_pairs_dropped_by_capacity={dropped} "
                         if n_moe else "") +
          (f"handoffs={xfer['handoffs']} pages_transferred={xfer['pages']} "
           f"transfer_us_per_call={xfer['us']:.2f} " if xfer else "") +
          (f"cross_encodes={cross['encodes']} cross_hit_rate="
                         f"{cross['hits'] / cross['lookups']:.3f} ({cross['hits']}/"
                         f"{cross['lookups']}) encode_ms={cross['encode_ms']:.3f} "
                         f"per_encode={per_call['cross']} " if cross else "") +
          f"launches={ {kn: v for kn, v in launches.items() if v} } "
          f"{'prefill_chunks' if eng.paged else 'prefills'}={calls['prefill']} "
          f"decode_ticks={calls['decode']} "
          f"per_{'prefill_chunk' if eng.paged else 'prefill'}={per_call['prefill']} "
          f"per_decode_tick={per_call['decode']}")
    graphs_out = {}
    if graphs:
        graphs_out = graph_report(torch, name, graph_steps, step_calls)
        if eng.paged:
            sync_check(torch, name, engine, requests)
    if any(c is not None for c in eng.prefix_caches):
        # the same requests with the cache off, in this call
        off = engine(graphs, overlap, prefix_cache=False)
        off_reqs = requests()
        for r in off_reqs:
            off.submit(r)
        off.run()
        check([r.out_tokens for r in off_reqs] == [r.out_tokens for r in reqs],
              f"{name}: greedy tokens differ with the cache off")
        print(f"  {name}: greedy tokens identical with the cache off "
              f"({off.stats.ticks} ticks there)")
    return dict(launches=launches, per_call=per_call, wall=wall,
                ticks=stats.ticks, tokens=stats.decoded_tokens,
                chunks=calls["prefill"], graphs=graphs_out,
                tokens_by_request=[r.out_tokens for r in reqs],
                weight_bytes=sum(t.numel() * t.element_size()
                                 for t in eng.model.parameters()),
                cross=cross, dropped=dropped, xfer=xfer,
                routed=[x.routed for x in stats.replicas],
                ttft_p50_ms=float(np.percentile(ttft, 50)),
                tpot_p50_ms=float(np.median(stats.tpot_s) * 1e3))


# serve-elastic: serve-dp's engine and mix under these membership changes,
# (tick, "scale", N) or (tick, "kill", r): 2 -> 1 -> 2 -> 1 replicas; the
# replica that joins at tick 40 starts empty (every request was routed at
# submit), so the kill at 60 takes replica 0, the one that serves
SERVE_ELASTIC_EVENTS = ((20, "scale", 1), (40, "scale", 2), (60, "kill", 0))
# the kernels the elastic path launches (tinyllama, bf16 pools)
ELASTIC_KERNELS = ("rmsnorm", "rmsnorm_residual", "matmul", "flash_attention",
                   "paged_decode_attention")


def phase_serve_elastic(torch, served):
    """serve-dp's model, engine (2 replicas x 8 slots, bf16 pools, graphs,
    the pipelined tick) and 32 requests under ``SERVE_ELASTIC_EVENTS``,
    after serve and serve-dp in this call.  Each membership change's wall
    time, split into the barrier (collecting the tick in flight), the
    drain (migrations or preemptions), the pools' re-scatter, the step
    graphs' capture (with their staging) and the rest (host bookkeeping;
    each part timed to a synchronize); migrations, pages and readmitted
    requests; after each change the decode and chunk graphs' kernel nodes,
    which must be serve-dp's at R = 2 and serve's at R = 1, and
    ``torch.cuda.memory_reserved``, which must not grow by more than one
    step set's graph pools over the 2 -> 1 -> 2 -> 1 cycle.  Launch counts
    set to 0 just before the requests are submitted and read just after
    the last token (a rebuild's capture warm-up calls launch kernels too:
    counted, and printed apart); every request completes, leak-free."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.serving import engine as engine_mod
    name = "serve-elastic"
    _free_card(torch)
    cfg, engine, requests = _serve_setup(torch, "serve-dp")
    eng = engine()
    parts, active, changes = {}, [False], []

    def part(key, fn):
        def wrapped(*args, **kw):
            if not active[0]:
                return fn(*args, **kw)
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            parts[key] = parts.get(key, 0.0) + time.perf_counter() - t0
            return out
        return wrapped

    eng._barrier = part("barrier", eng._barrier)
    eng._drain_replicas = part("drain", eng._drain_replicas)
    eng._build_io = part("capture", eng._build_io)
    eng._build_steps = part("capture", eng._build_steps)
    reshard = engine_mod.reshard_replica_pools
    engine_mod.reshard_replica_pools = part("reshard", reshard)
    pending = list(SERVE_ELASTIC_EVENTS)

    def hook(e):
        while pending and e.stats.ticks >= pending[0][0]:
            tick, kind, val = pending.pop(0)
            parts.clear()
            before = ops.launch_counts()
            mig = (e.stats.migrations, e.stats.migrated_pages,
                   e.stats.preemptions, e.stats.readmitted)
            active[0] = True
            t0 = time.perf_counter()
            if kind == "scale":
                e.scale_to(val)
            else:
                e.kill_replica(val)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            active[0] = False
            after = ops.launch_counts()
            nodes = {kd: sum(k == 0 for k, _ in read_graph(e.steps[kd].graph))
                     for kd in ("decode", "chunk")}
            changes.append(dict(
                tick=tick, kind=kind, value=val, R=e.R, wall_ms=1e3 * wall,
                parts_ms={k: 1e3 * v for k, v in parts.items()},
                migrations=e.stats.migrations - mig[0],
                pages=e.stats.migrated_pages - mig[1],
                preemptions=e.stats.preemptions - mig[2],
                readmitted=e.stats.readmitted - mig[3],
                warmup_launches=sum(after.values()) - sum(before.values()),
                nodes=nodes, reserved=torch.cuda.memory_reserved(),
                pool_bytes=sum(st.pool_bytes for st in e.steps.values())))

    eng.membership_hook = hook
    reqs = requests()
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()                 # main path starts here
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        stats = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()            # main path ends here
    finally:
        engine_mod.reshard_replica_pools = reshard
    check(len(changes) == len(SERVE_ELASTIC_EVENTS),
          f"{name}: {len(changes)} of {len(SERVE_ELASTIC_EVENTS)} changes ran")
    check(all(r.done for r in reqs), f"{name}: not every request completed")
    check(all(0 < len(r.out_tokens) <= NEW for r in reqs), f"{name}: token counts")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens),
          f"{name}: token ids out of range")
    check(eng.drain() == 0, f"{name}: slots still admitted after run()")
    leak_check(name, eng)
    for kn in ELASTIC_KERNELS:
        check(launches[kn] > 0, f"{name}: kernel {kn} never launched")
    want = {2: served["serve-dp"]["graphs"], 1: served["serve"]["graphs"]}
    for c in changes:
        ref = {kd: want[c["R"]][kd]["kernel_nodes"] for kd in c["nodes"]}
        check(c["nodes"] == ref,
              f"{name}: after the change at tick {c['tick']} (R = {c['R']}) "
              f"the graphs hold {c['nodes']} kernel nodes, not {ref}")
    grow = changes[2]["reserved"] - changes[0]["reserved"]
    check(grow <= changes[2]["pool_bytes"],
          f"{name}: memory reserved grew {grow} B over the 2 -> 1 -> 2 -> 1 "
          f"cycle, past one step set's graph pools "
          f"({changes[2]['pool_bytes']} B)")
    for c in changes:
        print(f"  {name} change: tick={c['tick']} {c['kind']} {c['value']} -> "
              f"R={c['R']} wall_ms={c['wall_ms']:.2f} "
              + " ".join(f"{k}_ms={v:.2f}" for k, v in c["parts_ms"].items())
              + f" other_ms={c['wall_ms'] - sum(c['parts_ms'].values()):.2f} "
              f"migrations={c['migrations']} migrated_pages={c['pages']} "
              f"preemptions={c['preemptions']} readmitted={c['readmitted']} "
              f"capture_warmup_launches={c['warmup_launches']} "
              f"decode_graph_kernels={c['nodes']['decode']} chunk_graph_"
              f"kernels={c['nodes']['chunk']} memory_reserved_MiB="
              f"{c['reserved'] / 2**20:.1f} step_set_pool_MiB="
              f"{c['pool_bytes'] / 2**20:.2f}")
    tps = {ph: served[ph]["tokens"] / served[ph]["wall"]
           for ph in ("serve", "serve-dp")}
    print(f"{name}: [graphed-overlap] {cfg.name} bf16 weights, bfloat16 "
          f"pools, greedy, random prompts, slots={SLOTS} seq_budget={SB} "
          f"page={PSZ} chunk={CH} dp 2 -> "
          + " -> ".join(str(c["R"]) for c in changes)
          + f" requests={len(reqs)} tokens={stats.decoded_tokens} "
          f"ticks={stats.ticks} wall_s={wall:.3f} tok_per_s="
          f"{stats.decoded_tokens / wall:.1f} (serve {tps['serve']:.1f}, "
          f"serve-dp {tps['serve-dp']:.1f} in this call) scale_events="
          f"{stats.scale_events} crashes={stats.crashes} migrations="
          f"{stats.migrations} migrated_pages={stats.migrated_pages} "
          f"readmitted={stats.readmitted} preemptions={stats.preemptions} "
          f"memory_growth_over_cycle_MiB={grow / 2**20:.2f} "
          f"ttft_p50_ms={np.percentile(stats.ttft_s, 50) * 1e3:.1f} "
          f"launches={ {kn: v for kn, v in launches.items() if v} }")
    return dict(launches=launches, changes=changes, wall=wall,
                tokens=stats.decoded_tokens, ticks=stats.ticks)


def phase_profile(torch, name, serve_wall_s, graphs=True, overlap=True):
    """Device time by kernel over serve phase ``name``'s workload, traced
    with torch.profiler (CUDA activity only; the kernels of a graph replay
    are traced one by one), and the CUDA runtime calls that block the
    host (synchronizations and copies).  The busy share divides the
    traced device time by the untraced phase's wall time: the same work,
    so what is left is time the device waited on the host."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    _free_card(torch)
    _, engine, requests = _serve_setup(torch, name)
    tag = name if graphs else f"{name}, eager-serial"
    eng = engine(graphs, overlap)
    for r in requests():
        eng.submit(r)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.run()
        torch.cuda.synchronize()
    launches = ops.launch_counts()
    rows, host = [], []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
        elif ev.key.startswith(("cudaStreamSynchronize", "cudaMemcpy",
                                "cudaDeviceSynchronize", "cudaEventSynchronize")):
            host.append(f"{ev.key} {ev.count} calls "
                        f"{getattr(ev, 'self_cpu_time_total', 0) / 1e3:.1f} ms")
    check(rows, f"profile[{tag}]: the trace holds no device time")
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    print(f"profile[{tag}]: device_ms={total:.2f} wall_ms="
          f"{serve_wall_s * 1e3:.1f} device_busy_share="
          f"{total / (serve_wall_s * 1e3):.3f} blocking runtime calls: "
          f"{'; '.join(host) or 'none recorded'}")
    for ms, n, key in rows[:10]:
        print(f"  {ms:9.3f} ms {n:6d} calls {100 * ms / total:5.1f}%  {key[:100]}")
    shares = {}
    # matmul, flash attention, the SSD scan and paged attention in the serve
    # trace: each kernel's device functions (never more of them in the trace
    # than its wrappers' launches), calls, device time per call and share.  The
    # trace may hold fewer: the profiler drops kernel records it cannot
    # place in its capture window (its "Out-of-range" count), from none to
    # hundreds per trace on the H100, anywhere in it.  One kernel per call
    # is checked exactly in the kernel phase (graph_nodes); here the loss
    # is printed.
    for kname, fns, wrappers in (
            ("matmul", ("matmul_mma_kernel", "matmul_simt_kernel"), ("matmul",)),
            ("expert matmul", ("expert_mma_kernel", "expert_simt_kernel"),
             ("expert_matmul",)),
            ("flash_attention", ("flash_mma_kernel", "flash_simt_kernel"),
             ("flash_attention",)),
            ("ssd_scan", ("ssd_mma_kernel", "ssd_simt_kernel"),
             ("ssd_scan", "ssd_scan_i8")),
            ("paged attention", ("paged_mma_kernel", "paged_simt_kernel"),
             ("paged_decode_attention", "paged_decode_attention_i8",
              "paged_verify_attention", "paged_verify_attention_i8")),
            # the same tensor-core kernel, with the contiguous policy, in
            # the contiguous phases (no paged wrapper launches there)
            ("contiguous decode attention", ("paged_mma_kernel", "contig_simt_kernel"),
             ("decode_attention", "decode_attention_i8")),
            ("the norm family", ("_rmsnorm_kernel",), NORMS)):
        n_launch = sum(launches[w] for w in wrappers)
        if not n_launch:
            continue
        got = [(ms, n) for ms, n, key in rows if any(f in key for f in fns)]
        k_ms, k_calls = sum(r[0] for r in got), sum(r[1] for r in got)
        check(k_calls <= n_launch,
              f"profile[{tag}]: {k_calls} {kname} kernels in the trace for "
              f"{n_launch} launches")
        print(f"profile[{tag}]: {kname} calls={k_calls} of "
              f"launches={n_launch} (records dropped by the profiler: "
              f"{n_launch - k_calls}) device_ms={k_ms:.2f} "
              f"per_call_us={1e3 * k_ms / max(k_calls, 1):.2f} "
              f"share_of_device={k_ms / total:.3f}")
        shares[kname] = k_ms / total
    return dict(device_ms=total, busy=total / (serve_wall_s * 1e3),
                shares=shares)


# the offload phase: examples/offload_streaming.py's toy (8 groups of two
# float32 layers, E 512, F 2048, x of B 8 x S 128 rows), then the FFN
# weights of one mistral-large-123b layer (w_gate, w_up, w_down at E 12288,
# F 28672 in bf16: 2.11 GB a group) streamed as 4 groups at M 8
OFFLOAD_TOY = dict(groups=8, E=512, F=2048, rows=8 * 128)
OFFLOAD_ML_GROUPS = 4


def _timeline_overlap(ex, ref_ev, what):
    """Device times (ms after ``ref_ev``) of each group's copy and compute
    from the executor's CUDA events; checks that group i+1's copy started
    before group i's compute ended and ran while it ran."""
    t = [{k: ref_ev.elapsed_time(rec[k]) for k in
          ("copy_start", "copy_end", "compute_start", "compute_end")}
         for rec in ex.timeline]
    for i in range(len(t) - 1):
        check(t[i + 1]["copy_start"] < t[i]["compute_end"] and
              t[i + 1]["copy_end"] > t[i]["compute_start"],
              f"offload[{what}]: group {i + 1}'s copy "
              f"[{t[i + 1]['copy_start']:.3f}, {t[i + 1]['copy_end']:.3f}] ms did "
              f"not overlap group {i}'s compute [{t[i]['compute_start']:.3f}, "
              f"{t[i]['compute_end']:.3f}] ms")
    return t


def phase_offload(torch, smi_line):
    """Host-offload streaming (``repro_torch.runtime.offload``): pinned host
    groups copied on a side CUDA stream, into two staging buffers in turn,
    one group ahead of the compute that reads them.  (1) The toy of ``examples/offload_streaming.py``, through
    the port's float32 matmul: the streamed result equals the all-resident
    run bitwise.  (2) The FFN weights of one mistral-large-123b layer as
    ``OFFLOAD_ML_GROUPS`` groups of 2.11 GB of bf16 (drawn on the card,
    copied into pinned host memory; 2 groups if that much cannot be
    pinned), at M 8 through the port's bf16 matmul: equal to the resident
    run bitwise.  Each stream's CUDA events show group i+1's copy issued
    and running while group i computes.  Prints the host-to-device rate
    measured on this card, compute per group, streamed and resident wall,
    and ``required_bandwidth`` against the measured link: the paper's §V-C
    arithmetic on the card."""
    import gc

    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.runtime.offload import (OffloadExecutor, host_link_rate,
                                             required_bandwidth, tree_map)
    bf = torch.bfloat16

    def sync():
        torch.cuda.synchronize()

    def stream(host, fn, x):
        """(output, executor, wall s, the event its timeline is read
        against) of one measured stream after a warm-up stream."""
        OffloadExecutor(host).stream_forward(x, [fn] * len(host))
        sync()
        ex = OffloadExecutor(host)
        ref_ev = torch.cuda.Event(enable_timing=True)
        ref_ev.record()
        t0 = time.perf_counter()
        y = ex.stream_forward(x, [fn] * len(host))
        sync()
        return y, ex, time.perf_counter() - t0, ref_ev

    def resident_run(groups, fn, x):
        y = x
        for p in groups:
            y = fn(y, p)
        return y

    def per_group_ms(fn, x, p, reps=5):
        samples = []
        for _ in range(reps):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn(x, p)
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end))
        return statistics.median(samples)

    # ---- (1) the example's toy, float32
    E, Fd, rows = OFFLOAD_TOY["E"], OFFLOAD_TOY["F"], OFFLOAD_TOY["rows"]
    rng = np.random.RandomState(0)
    toy_host = [{"w1": rng.randn(E, Fd).astype(np.float32) * 0.02,
                 "w2": rng.randn(Fd, E).astype(np.float32) * 0.02}
                for _ in range(OFFLOAD_TOY["groups"])]
    x = torch.from_numpy(rng.randn(rows, E).astype(np.float32)).cuda()

    def toy(x, p):
        return x + ops.matmul(F.silu(ops.matmul(x, p["w1"])), p["w2"])

    ops.reset_launch_counts()
    y, ex, wall, ref_ev = stream(toy_host, toy, x)
    launches = ops.launch_counts()["matmul"]
    check(launches == 2 * 2 * OFFLOAD_TOY["groups"],
          f"offload[toy]: {launches} matmul launches in two streams")
    resident = [tree_map(lambda a: torch.from_numpy(a).cuda(), g) for g in toy_host]
    check(torch.equal(y, resident_run(resident, toy, x)),
          "offload[toy]: the streamed result differs from the resident run")
    tl = _timeline_overlap(ex, ref_ev, "toy")
    rate, nbytes = host_link_rate(ex.host_groups[0])
    comp = per_group_ms(toy, x, resident[0])
    need = required_bandwidth(nbytes, comp / 1e3)
    print(f"offload[toy]: {OFFLOAD_TOY['groups']} groups of {nbytes / 1e6:.1f} MB "
          f"float32 (E {E}, F {Fd}, {rows} rows), pinned: streamed equals the "
          f"resident run bitwise; every group i+1's copy overlapped group i's "
          f"compute (CUDA events; copy {tl[1]['copy_end'] - tl[1]['copy_start']:.3f} "
          f"ms, compute {tl[0]['compute_end'] - tl[0]['compute_start']:.3f} ms a "
          f"group in the stream) wall_streamed_ms={wall * 1e3:.3f} "
          f"h2d_GBps={rate / 1e9:.2f} compute_ms_per_group={comp:.3f} "
          f"required_GBps={need / 1e9:.2f} => streaming "
          f"{'free' if need < rate else 'exposed'}; stage_dispatch_ms="
          f"{ex.stats.stage_s * 1e3:.2f} compute_dispatch_ms="
          f"{ex.stats.compute_s * 1e3:.2f}")
    del resident, ex, y
    _free_card(torch)

    # ---- (2) one mistral-large-123b layer's FFN, bf16, M 8
    E, Fd = ML_E, ML_F
    shapes = (("w_gate", (E, Fd)), ("w_up", (E, Fd)), ("w_down", (Fd, E)))
    gen = torch.Generator(device="cuda").manual_seed(3)
    host, note = [], ""
    try:
        for _ in range(OFFLOAD_ML_GROUPS):
            g = {}
            for name, shape in shapes:
                h = torch.empty(shape, dtype=bf, pin_memory=True)
                h.copy_((0.02 * torch.randn(shape, generator=gen,
                                            device="cuda")).to(bf))
                g[name] = h
            host.append(g)
    except RuntimeError as e:
        if len(host) < 2:
            raise SmokeFailure(f"offload[mistral]: could not pin 2 groups: {e}")
        host = host[:2]
        note = f" (only 2 groups: pinning group {len(host) + 1} failed: {e})"
    sync()
    x8 = torch.randn(8, E, generator=gen, device="cuda").to(bf)

    def ffn(x, p):
        gate = ops.matmul(x, p["w_gate"])
        up = ops.matmul(x, p["w_up"])
        return ops.matmul((F.silu(gate.float()) * up.float()).to(bf), p["w_down"])

    y, ex, wall, ref_ev = stream(host, ffn, x8)
    tl = _timeline_overlap(ex, ref_ev, "mistral")
    resident = [tree_map(lambda a: a.to("cuda"), g) for g in host]
    sync()
    t0 = time.perf_counter()
    want = resident_run(resident, ffn, x8)
    sync()
    wall_res = time.perf_counter() - t0
    check(torch.equal(y, want),
          "offload[mistral]: the streamed result differs from the resident run")
    check(bool(torch.isfinite(y.float()).all()), "offload[mistral]: non-finite")
    rate, nbytes = host_link_rate(host[0])
    comp = per_group_ms(ffn, x8, resident[0])
    need = required_bandwidth(nbytes, comp / 1e3)
    copy_ms = statistics.median(r["copy_end"] - r["copy_start"] for r in tl)
    print(f"offload[mistral]: {len(host)} groups of one mistral-large-123b layer's "
          f"FFN (w_gate, w_up ({E}, {Fd}), w_down ({Fd}, {E}) bf16: "
          f"{nbytes / 1e9:.2f} GB a group, {len(host) * nbytes / 1e9:.2f} GB "
          f"pinned){note} at M 8: streamed equals resident bitwise; group i+1's "
          f"copy overlapped group i's compute in every step; h2d_GBps="
          f"{rate / 1e9:.2f} copy_ms_per_group_in_stream={copy_ms:.3f} "
          f"compute_ms_per_group={comp:.3f} wall_streamed_ms={wall * 1e3:.3f} "
          f"wall_resident_ms={wall_res * 1e3:.3f} required_GBps="
          f"{need / 1e9:.1f} vs measured {rate / 1e9:.2f} => streaming "
          f"{'free' if need < rate else 'exposed'} (x{need / rate:.1f} the "
          f"link); {smi_line}")
    del host, resident, ex, y, want
    gc.collect()
    _free_card(torch)


def phase_sim(torch):
    """The port's copy of the paper's analytical multi-MCU model
    (``repro_torch.sim``), run on the card's machine, where no JAX is
    installed: the calibrated Siracusa model's headline metrics."""
    from repro_torch.sim import calibrate
    from repro_torch.sim.siracusa import SiracusaConfig
    m = calibrate.paper_metrics(SiracusaConfig())
    check(not any(n == "jax" or n.startswith(("jax.", "repro."))
                  for n in sys.modules), "sim: jax or the JAX package imported")
    print(f"sim: Siracusa model (repro_torch.sim, no jax in this process): "
          f"tinyllama-42m AR 8 chips speedup={m['ar_speedup8']:.1f}x "
          f"t_block={m['ar_t8_ms']:.2f} ms e_block={m['ar_e8_mj']:.2f} mJ; prompt "
          f"8 chips {m['prompt_speedup8']:.1f}x; mobilebert 4 chips "
          f"{m['mb_speedup4']:.2f}x ({m['mb_t4_ms']:.1f} ms); tinyllama-42m-64h "
          f"64 chips {m['ar64_speedup64']:.1f}x, energy ratio "
          f"{m['ar64_energy_ratio']:.2f}x; loss vs the paper's targets "
          f"{calibrate.loss(m):.4f}")


# name: (route, source, the TPU kernel it replaces)
_PAGED = "src/repro_torch/kernels/csrc/paged_decode.cu"
KERNELS = {
    "rmsnorm": ("triton", "src/repro_torch/kernels/rmsnorm.py",
                "src/repro/kernels/rmsnorm.py:25"),
    "rmsnorm_residual": ("triton", "src/repro_torch/kernels/rmsnorm.py",
                         "src/repro/kernels/rmsnorm.py:25"),
    "rmsnorm_gated": ("triton", "src/repro_torch/kernels/rmsnorm.py",
                      "src/repro/kernels/rmsnorm.py:25"),
    "matmul": ("cuda", "src/repro_torch/kernels/csrc/matmul.cu",
               "src/repro/kernels/matmul.py:36"),
    # port-only: JAX computes the experts' products as an XLA einsum, no
    # Pallas kernel
    "expert_matmul": ("cuda", "src/repro_torch/kernels/csrc/matmul.cu",
                      "src/repro/core/moe.py:79"),
    "flash_attention": ("cuda", "src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:78"),
    "paged_decode_attention": ("cuda", _PAGED,
                               "src/repro/kernels/decode_attention.py:179"),
    "paged_decode_attention_i8": ("cuda", _PAGED,
                                  "src/repro/kernels/decode_attention.py:134"),
    "paged_verify_attention": ("cuda", _PAGED,
                               "src/repro/kernels/decode_attention.py:249"),
    "paged_verify_attention_i8": ("cuda", _PAGED,
                                  "src/repro/kernels/decode_attention.py:289"),
    "ssd_scan": ("cuda", "src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:84"),
    "ssd_scan_i8": ("cuda", "src/repro_torch/kernels/csrc/ssd_scan.cu",
                    "src/repro/kernels/ssd_scan.py:67"),
    "decode_attention": ("cuda", _PAGED, "src/repro/kernels/decode_attention.py:59"),
    "decode_attention_i8": ("cuda", _PAGED, "src/repro/kernels/decode_attention.py:59"),
}


def _seamless_line(served, prof, smi_line):
    """The ``seamless[serve-seamless]`` line: widths, weight bytes, the
    cross-KV cache's work (encodes, hit rate, one encode's time) and the
    serve numbers with the profile's busy share, device time and matmul
    share, beside the card."""
    from repro_torch.configs import get_config
    name = "serve-seamless"
    sv, pr = served[name], prof[name]
    cfg = get_config(SERVE_PHASES[name][0])
    cr = sv["cross"]
    print(f"seamless[{name}]: {cfg.name} {cfg.n_enc_layers} encoder + "
          f"{cfg.n_layers} decoder layers, d_model={cfg.d_model} heads="
          f"{cfg.n_heads}/{cfg.n_kv_heads} head_dim={cfg.head_dim_} "
          f"d_ff={cfg.d_ff} (plain gelu) vocab={cfg.vocab_size} tied, "
          f"{cfg.enc_seq_len} frames; weights on the card "
          f"{sv['weight_bytes'] / 1e9:.2f} GB bf16; {SM_FRAME_GROUPS} frame "
          f"tensors: encodes={cr['encodes']} cross_hit_rate="
          f"{cr['hits'] / cr['lookups']:.3f} ({cr['hits']}/{cr['lookups']}) "
          f"encode_ms={cr['encode_ms']:.3f}; tok_per_s="
          f"{sv['tokens'] / sv['wall']:.1f} ticks={sv['ticks']} "
          f"ttft_p50_ms={sv['ttft_p50_ms']:.1f} tpot_p50_ms="
          f"{sv['tpot_p50_ms']:.2f} busy_share={pr['busy']:.3f} device_ms="
          f"{pr['device_ms']:.2f} matmul_share="
          f"{pr['shares'].get('matmul', 0.0):.3f}; {smi_line}")


def _deepseek_line(served, prof, smi_line):
    """The ``deepseek[serve-deepseek]`` line: widths, experts, weight bytes,
    the serve numbers, the pairs dropped by capacity over its chunks and
    ticks, and the profile's busy share, device time and the matmul's and
    the expert matmul's shares, beside the card."""
    from repro_torch.configs import get_config
    name = "serve-deepseek"
    sv, pr = served[name], prof[name]
    cfg = get_config(SERVE_PHASES[name][0])
    print(f"deepseek[{name}]: {cfg.name} {cfg.n_layers} layers (the first a "
          f"dense FFN of {cfg.dense_ff_override}), d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} head_dim={cfg.head_dim_} "
          f"experts={cfg.n_experts} of {cfg.moe_d_ff} top-{cfg.top_k} + "
          f"{cfg.n_shared_experts} shared, vocab={cfg.vocab_size} untied; "
          f"weights on the card {sv['weight_bytes'] / 1e9:.2f} GB bf16; "
          f"tok_per_s={sv['tokens'] / sv['wall']:.1f} ticks={sv['ticks']} "
          f"wall_per_tick_ms={1e3 * sv['wall'] / sv['ticks']:.3f} "
          f"prefill_chunks={sv['chunks']} ttft_p50_ms={sv['ttft_p50_ms']:.1f} "
          f"tpot_p50_ms={sv['tpot_p50_ms']:.2f} pairs_dropped_by_capacity="
          f"{sv['dropped']} busy_share={pr['busy']:.3f} device_ms="
          f"{pr['device_ms']:.2f} matmul_share="
          f"{pr['shares'].get('matmul', 0.0):.3f} expert_matmul_share="
          f"{pr['shares'].get('expert matmul', 0.0):.3f}; {smi_line}")


def _replicas_line(served, prof, smi_line):
    """The ``dp[serve-dp, serve-disagg vs serve]`` line: each phase's tok/s,
    ticks, busy share, device time, routing (and handoffs, pages moved and
    one transfer's time), and its decode and chunk graphs' nodes beside
    serve's one replica (the same counted kernels: the decode step at B =
    2 x SLOTS rows, the chunk step one chunk of one replica a replay)."""
    rows = []
    for name in ("serve-dp", "serve-disagg", "serve"):
        sv, pr = served[name], prof[name]
        g, c = sv["graphs"]["decode"], sv["graphs"]["chunk"]
        xf = sv["xfer"]
        rows.append(
            f"{name} tok_per_s={sv['tokens'] / sv['wall']:.1f} "
            f"requests={len(sv['tokens_by_request'])} ticks={sv['ticks']} "
            f"wall_per_tick_ms={1e3 * sv['wall'] / sv['ticks']:.3f} "
            f"busy_share={pr['busy']:.3f} device_ms={pr['device_ms']:.2f} "
            f"routed={sv['routed']} decode_graph=({g['kernel_nodes']} kernels, "
            f"{g['ours']} the port's, {g['memcpy']} memcpy) chunk_graph=("
            f"{c['kernel_nodes']} kernels, {c['ours']} the port's)"
            + (f" handoffs={xf['handoffs']} pages={xf['pages']} "
               f"transfer_us={xf['us']:.2f}" if xf else ""))
    print("dp[serve-dp, serve-disagg vs serve]: " + " | ".join(rows) +
          f"; {smi_line}")


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run this script "
              f"from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 3
    from repro_torch.kernels import build
    # float32 products on the card in full float32, never TF32, for the
    # plain versions and the yardsticks alike
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_s = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = round(time.perf_counter() - t0, 1)
        return out

    try:
        smi_line = timed("env", phase_env, torch, build)
        rows = timed("kernels", phase_kernels, torch, F)
        timed("parity", phase_parity, torch)
        timed("parity-qwen3", phase_parity_qwen3, torch)
        timed("parity-gemma3", phase_parity_gemma3, torch)
        timed("parity-hymba", phase_parity_hymba, torch)
        timed("parity-mistral", phase_parity_mistral, torch)
        timed("parity-64h", phase_parity_64h, torch)
        timed("parity-seamless", phase_parity_seamless, torch)
        timed("parity-deepseek", phase_parity_deepseek, torch)
        timed("parity-sample", phase_parity_sample, torch)
        timed("parity-ssm", phase_parity_ssm, torch)
        timed("parity-contig", phase_parity_contig, torch)
        timed("parity-contig-ssm", phase_parity_contig_ssm, torch)
        timed("parity-prefix", phase_parity_prefix, torch)
        timed("parity-preempt", phase_parity_preempt, torch)
        timed("parity-dp", phase_parity_dp, torch)
        timed("parity-disagg", phase_parity_disagg, torch)
        parity_elastic = timed("parity-elastic", phase_parity_elastic, torch)
        parity_spill = timed("parity-spill", phase_parity_spill, torch)
        served = {name: timed(name, phase_serve, torch, name)
                  for name in SERVE_PHASES}
        elastic = timed("serve-elastic", phase_serve_elastic, torch, served)
        # the same phases with eager steps and the serial loop, in this call
        eager = {name: timed(f"{name}[eager-serial]", phase_serve, torch, name,
                             False, False) for name in AB_PHASES}
        # the sampled phases' eager-serial runs, for their tokens alone
        eager_sampled = {name: timed(f"{name}[eager-serial]", phase_serve, torch,
                                     name, False, False)
                         for name in SAMPLE_AB_PHASES}
        for name, out in list(eager.items()) + list(eager_sampled.items()):
            check(out["tokens_by_request"] == served[name]["tokens_by_request"],
                  f"{name}: eager-serial tokens differ from graphed-overlap")
        prof = {name: timed(f"profile[{name}]", phase_profile, torch, name,
                            out["wall"]) for name, out in served.items()}
        prof_eager = {name: timed(f"profile[{name}, eager-serial]",
                                  phase_profile, torch, name, out["wall"],
                                  False, False) for name, out in eager.items()}
        for name in AB_PHASES:
            rows_ab = []
            for tag, sv, pr in (("graphed-overlap", served[name], prof[name]),
                                ("eager-serial", eager[name], prof_eager[name])):
                rows_ab.append(
                    f"{tag} tok_per_s={sv['tokens'] / sv['wall']:.1f} "
                    f"wall_per_tick_ms={1e3 * sv['wall'] / sv['ticks']:.3f} "
                    f"ticks={sv['ticks']} busy_share={pr['busy']:.3f}")
            print(f"ab[{name}]: " + " | ".join(rows_ab) + " (greedy tokens "
                  f"identical)")
        # serve-prefix beside serve, in this call
        rows_px = []
        for name in ("serve", "serve-prefix"):
            sv = served[name]
            rows_px.append(
                f"{name} tok_per_s={sv['tokens'] / sv['wall']:.1f} "
                f"wall_per_tick_ms={1e3 * sv['wall'] / sv['ticks']:.3f} "
                f"ticks={sv['ticks']} busy_share={prof[name]['busy']:.3f} "
                f"device_ms={prof[name]['device_ms']:.2f} "
                f"prefill_chunks={sv['chunks']} flash_launches="
                f"{sv['launches']['flash_attention']}")
        print("prefix[serve-prefix vs serve]: " + " | ".join(rows_px))
        # serve-sample beside serve, in this call: the host's draws
        rows_sm = []
        for name in ("serve-sample", "serve"):
            sv = served[name]
            rows_sm.append(
                f"{name} tok_per_s={sv['tokens'] / sv['wall']:.1f} "
                f"wall_per_tick_ms={1e3 * sv['wall'] / sv['ticks']:.3f} "
                f"ticks={sv['ticks']} busy_share={prof[name]['busy']:.3f} "
                f"device_ms={prof[name]['device_ms']:.2f}")
        print("sample[serve-sample vs serve]: " + " | ".join(rows_sm) +
              " (serve-sample's eager-serial tokens identical)")
        from repro_torch.configs import get_config
        from repro_torch.core.partition import ShardingPlan, model_layout
        ml = get_config(SERVE_PHASES["serve-mistral"][0])
        lay = model_layout(ml, ShardingPlan()).attn
        sv = served["serve-mistral"]
        print(f"mistral[serve-mistral]: {ml.name} d_model={ml.d_model} "
              f"heads={ml.n_heads}/{ml.n_kv_heads} head_dim={ml.head_dim_} "
              f"d_ff={ml.d_ff} vocab={ml.vocab_size} untied head, layers="
              f"{SERVE_DEPTH['serve-mistral']} of {ml.n_layers}; r={lay.r} "
              f"kv_slots={lay.n_kv_loc}; weights on the card "
              f"{sv['weight_bytes'] / 1e9:.2f} GB bf16; tok_per_s="
              f"{sv['tokens'] / sv['wall']:.1f} ticks={sv['ticks']} "
              f"wall_per_tick_ms={1e3 * sv['wall'] / sv['ticks']:.3f} "
              f"prefill_chunks={sv['chunks']} ttft_p50_ms={sv['ttft_p50_ms']:.1f} "
              f"tpot_p50_ms={sv['tpot_p50_ms']:.2f} busy_share="
              f"{prof['serve-mistral']['busy']:.3f} device_ms="
              f"{prof['serve-mistral']['device_ms']:.2f}; {smi_line}")
        # serve-64h beside serve, in this call: 64 heads of 8 against 8 of 64
        rows_64 = []
        for name in ("serve-64h", "serve"):
            sv = served[name]
            rows_64.append(
                f"{name} tok_per_s={sv['tokens'] / sv['wall']:.1f} "
                f"wall_per_tick_ms={1e3 * sv['wall'] / sv['ticks']:.3f} "
                f"ticks={sv['ticks']} busy_share={prof[name]['busy']:.3f} "
                f"device_ms={prof[name]['device_ms']:.2f}")
        print("64h[serve-64h vs serve]: " + " | ".join(rows_64))
        _seamless_line(served, prof, smi_line)
        _deepseek_line(served, prof, smi_line)
        _replicas_line(served, prof, smi_line)
        timed("sim", phase_sim, torch)
        timed("offload", phase_offload, torch, smi_line)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        r = rows[name]
        by_phase = {ph: out["launches"][name] for ph, out in served.items()}
        by_phase["serve-elastic"] = elastic["launches"][name]
        by_phase["parity-elastic"] = parity_elastic[name]
        by_phase["parity-spill"] = parity_spill[name]
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": sum(by_phase.values()), "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"], "max_abs_err_all_cases": r["max_abs_err_all_cases"],
            "launches_by_phase": by_phase,
            "per_step": {ph: {kd: c[name] for kd, c in out["per_call"].items()
                              if name in c}
                         for ph, out in served.items()},
            **({"by_shape": r["by_shape"]} if "by_shape" in r else {})})
    print(f"total_s={time.perf_counter() - t_start:.1f} phase_s={phase_s}")
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
