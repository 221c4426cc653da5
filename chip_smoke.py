#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card: the quickest proof that
the port still builds, runs its Hopper kernels and serves on the GPU.

    python3 chip_smoke.py

Run from the root of a checkout (it puts ``src/`` on ``sys.path``).  It
imports nothing of JAX and nothing of the JAX package.  Phases, one line
each (and a few detail lines):

1. env      the card (nvidia-smi name and power limit), torch and CUDA
            versions, and the time to build every kernel from ``src/``.
2. kernels  each of the four kernels against its plain PyTorch version on
            the card, at the main path's shapes plus ragged cases, with the
            stated tolerance; median times (CUDA graphs of back-to-back
            calls, CUDA events) of the kernel, the plain version and the one
            PyTorch call that computes the same function (a yardstick only;
            the port never calls it).
3. parity   full-width tinyllama-42m in float32: 4 requests through the
            engine on the card (kernels) and on the CPU (plain versions):
            the logits of every prefill chunk (first tokens included)
            within tolerance, greedy tokens identical.
4. serve    full-width tinyllama-42m, bfloat16 weights and pools, 8 slots,
            16 requests: every request completes, the pool is leak-free
            after drain(), and each kernel's launch count moved in the
            phases it belongs to.  Prints tok/s and TTFT.
5. profile  the serve workload again under torch.profiler: device time by
            kernel, and the device's busy share of the serve phase.

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
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}   # bf16 tensor, fp32 CUDA-core
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),       # tests/test_kernels.py:16-18
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
PARITY_TOL = dict(rtol=1e-3, atol=1e-3)   # float32 logits after 8 layers, x10 weights


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


def compare(name, got, want, dtype, torch):
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    err = (got - want).abs()
    tol = TOL[dtype_name(dtype)]
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
    x = torch.randn(4, 512, device="cuda")
    t0 = time.perf_counter()
    ops.rmsnorm(x, torch.zeros(512, device="cuda"))       # compiles the Triton kernel
    torch.cuda.synchronize()
    triton_s = time.perf_counter() - t0
    print(f"env: card='{smi_line}' torch={torch.__version__} "
          f"cuda={torch.version.cuda} device={torch.cuda.get_device_name(0)} "
          f"count={torch.cuda.device_count()} build_cuda_s={cuda_s:.1f} "
          f"build_triton_s={triton_s:.1f}")
    for stem, log in sorted(build.BUILD_LOG.items()):
        for line in log.splitlines():
            if "Used" in line or "spill" in line.lower():
                print(f"  ptxas[{stem}]: {line.strip()}")
    return smi_line


def phase_kernels(torch, F):
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    rows = {}
    worst = {}

    def note(kname, case, err):
        print(f"  {kname} {case}: max_abs_err={err:.3e}")
        worst[kname] = max(worst.get(kname, 0.0), err)

    # ---- rmsnorm: T = 8 decode rows / 32 chunk rows, E = 512
    for dt in (torch.float32, torch.bfloat16):
        for T in (8, 32, 33):
            x, s = randn(T, 512, dtype=dt), 0.1 * randn(512, dtype=dt)
            note("rmsnorm", f"T={T} {dtype_name(dt)}",
                 compare("rmsnorm", ops.rmsnorm(x, s), ref.ref_rmsnorm(x, s),
                         dt, torch))
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

    # ---- matmul: projections, FFN and the tied head (NT), ragged M; weights
    # at the model's init scale (0.02), as the main path feeds them
    for dt in (torch.float32, torch.bfloat16):
        for M in (8, 32, 33):
            for K, N, nt in ((512, 512, False), (512, 2048, False),
                             (2048, 512, False), (512, 32000, True)):
                a = randn(M, K, dtype=dt)         # activations ~ N(0, 1)
                b = (0.02 * randn(N, K) if nt else 0.02 * randn(K, N)).to(dt)
                note("matmul", f"M={M} K={K} N={N}{' NT' if nt else ''} "
                               f"{dtype_name(dt)}",
                     compare("matmul", ops.matmul(a, b, trans_b=nt),
                             ref.ref_matmul(a, b, nt), dt, torch))
    a = randn(8, 512, dtype=torch.bfloat16)
    table = (0.02 * randn(32000, 512)).to(torch.bfloat16)
    err = compare("matmul", ops.matmul(a, table, trans_b=True),
                  ref.ref_matmul(a, table, True), torch.bfloat16, torch)
    b_ms, b_by = bound((a.numel() + table.numel() + 8 * 32000) * 2,
                       2 * 8 * 512 * 32000, torch.bfloat16)
    rows["matmul"] = dict(
        shape="LM head a (8, 512) @ table (32000, 512)^T bf16", max_abs_err=err,
        ms=time_ms(lambda: ops.matmul(a, table, trans_b=True), torch),
        plain_ms=time_ms(lambda: ref.ref_matmul(a, table, True), torch),
        library_ms=time_ms(lambda: torch.matmul(a, table.t()), torch),
        bound_ms=b_ms, bound_by=b_by)

    # ---- flash attention: one prefill chunk of 32 over a 256-key stream
    H, Sq, Skv, D = 8, 32, 256, 64
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (randn(H, Sq, D, dtype=dt), randn(H, Skv, D, dtype=dt),
                   randn(H, Skv, D, dtype=dt))
        for q_off, win in ((0, 0), (96, 0), (224, 0), (None, 0), (224, 64)):
            note("flash_attention", f"q_offset={q_off} window={win} "
                                    f"{dtype_name(dt)}",
                 compare("flash_attention",
                         ops.flash_attention(q, k, v, window=win, q_offset=q_off),
                         ref.ref_flash_attention(q, k, v, window=win,
                                                 q_offset=q_off), dt, torch))
    q, k, v = (randn(H, Sq, D, dtype=torch.bfloat16),
               randn(H, Skv, D, dtype=torch.bfloat16),
               randn(H, Skv, D, dtype=torch.bfloat16))
    q_off = 224
    err = compare("flash_attention", ops.flash_attention(q, k, v, q_offset=q_off),
                  ref.ref_flash_attention(q, k, v, q_offset=q_off),
                  torch.bfloat16, torch)
    mask = (torch.arange(Skv, device="cuda")[None, :]
            <= torch.arange(Sq, device="cuda")[:, None] + q_off)
    pairs = int(mask.sum())
    kv_read = int(mask.any(0).sum())        # keys some query attends to
    b_ms, b_by = bound((q.numel() * 2 + 2 * H * kv_read * D) * 2,
                       4 * D * H * pairs, torch.bfloat16)
    rows["flash_attention"] = dict(
        shape=f"H={H} Sq={Sq} Skv={Skv} D={D} q_offset={q_off} bf16",
        max_abs_err=err,
        ms=time_ms(lambda: ops.flash_attention(q, k, v, q_offset=q_off), torch),
        plain_ms=time_ms(lambda: ref.ref_flash_attention(q, k, v, q_offset=q_off),
                         torch),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], attn_mask=mask[None, None]), torch),
        bound_ms=b_ms, bound_by=b_by)

    # ---- paged decode: 8 slots over a shuffled pool, ragged lengths
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
        note("paged_decode_attention", f"lengths={lengths} {dtype_name(dt)}",
             compare("paged_decode_attention",
                     ops.paged_decode_attention(qd, kp, vp, bt, length),
                     ref.ref_paged_decode_attention(qd, kp, vp, bt, length),
                     dt, torch))
    qd = randn(B, H, D, dtype=torch.bfloat16)
    kp = randn(n_pages, H, psz, D, dtype=torch.bfloat16)
    vp = randn(n_pages, H, psz, D, dtype=torch.bfloat16)
    err = compare("paged_decode_attention",
                  ops.paged_decode_attention(qd, kp, vp, bt, length),
                  ref.ref_paged_decode_attention(qd, kp, vp, bt, length),
                  torch.bfloat16, torch)
    toks = sum(lengths)
    b_ms, b_by = bound(2 * qd.numel() * 2 + 2 * H * toks * D * 2
                       + bt.numel() * 4 + B * 4, 4 * D * H * toks, torch.bfloat16)
    rows["paged_decode_attention"] = dict(
        shape=f"B={B} H={H} D={D} psz={psz} n_max={n_max} lengths={lengths} bf16",
        max_abs_err=err,
        ms=time_ms(lambda: ops.paged_decode_attention(qd, kp, vp, bt, length), torch),
        plain_ms=time_ms(lambda: ref.ref_paged_decode_attention(qd, kp, vp, bt,
                                                                length), torch),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)

    for name, r in rows.items():
        r["max_abs_err_all_cases"] = worst[name]
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"kernels: {name} [{r['shape']}] ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} library_ms={lib} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"max_abs_err={worst[name]:.3e}")
    return rows


def _requests(Request, rng, n, lo, hi, max_new, vocab):
    import numpy as np
    return [Request(rid=i, prompt=rng.randint(2, vocab, int(L)).astype(np.int32),
                    max_new_tokens=max_new)
            for i, L in enumerate(rng.randint(lo, hi + 1, n))]


def phase_parity(torch):
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import model
    from repro_torch.core.partition import ShardingPlan
    from repro_torch.serving import Request, ServingEngine
    cfg = get_config("tinyllama-42m")
    plan = ShardingPlan(kv_cache_dtype="float32")
    # weights x10 so greedy decoding does not collapse onto repeating the
    # prompt's last token (which the 0.02-scale init does at this width)
    params = model.tree_map(lambda t: t * 10, model.init_params(
        cfg, plan, torch.Generator().manual_seed(0), device="cpu",
        dtype="float32"))
    prompts = [np.random.RandomState(7 + i).randint(2, cfg.vocab_size, L)
               for i, L in enumerate((23, 40, 77, 130))]

    def serve(device):
        """-> (greedy tokens per request, logits of every prefill chunk in
        call order; the last chunk of each prompt gives its first token)."""
        eng = ServingEngine.build_paged(cfg, plan, 4, 256, params, page_size=16,
                                        prefill_chunk=32, device=device)
        chunk_logits = []
        step = eng.prefill_fn

        def recording(*args):
            logits, cache = step(*args)
            chunk_logits.append(logits.float().cpu())
            return logits, cache

        eng.prefill_fn = recording
        reqs = [Request(rid=i, prompt=pr.astype(np.int32), max_new_tokens=16)
                for i, pr in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        check(all(r.done for r in reqs), f"parity: unfinished requests on {device}")
        return [r.out_tokens for r in reqs], torch.cat(chunk_logits)

    (t_gpu, lg_gpu), (t_cpu, lg_cpu) = serve("cuda"), serve("cpu")
    check(lg_gpu.shape == lg_cpu.shape, "parity: prefill schedules differ")
    err = (lg_gpu - lg_cpu).abs()
    check(bool((err <= PARITY_TOL["atol"] + PARITY_TOL["rtol"] * lg_cpu.abs()).all()),
          f"parity: prefill logits differ by {err.max().item():.3e}")
    check(t_gpu == t_cpu, f"parity: greedy tokens differ\n  cuda={t_gpu}\n  cpu={t_cpu}")
    distinct = len({t for toks in t_gpu for t in toks})
    print(f"parity: tinyllama-42m float32 engine on cuda vs cpu: logits of "
          f"{lg_gpu.shape[0]} prefill chunks (incl. every first token) max_abs_err="
          f"{err.max().item():.3e} (|logit| max {lg_cpu.abs().max().item():.2f}, "
          f"tol rtol={PARITY_TOL['rtol']} atol={PARITY_TOL['atol']}); greedy "
          f"tokens identical: 4 requests x 16 tokens, {distinct} distinct")


def phase_serve(torch):
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import model
    from repro_torch.core.partition import ShardingPlan
    from repro_torch.kernels import ops
    from repro_torch.serving import Request, ServingEngine
    cfg = get_config("tinyllama-42m")
    plan = ShardingPlan(kv_cache_dtype="bfloat16")
    params = model.init_params(cfg, plan, torch.Generator().manual_seed(0),
                               device="cuda")
    SLOTS, SB, PSZ, CH, NEW = 8, 256, 16, 32, 32

    def engine():
        return ServingEngine.build_paged(cfg, plan, SLOTS, SB, params,
                                         page_size=PSZ, prefill_chunk=CH,
                                         device="cuda")

    warm = engine()                                    # first-call costs
    for r in _requests(Request, np.random.RandomState(1), 2, 16, 160, 4,
                       cfg.vocab_size):
        warm.submit(r)
    warm.run()

    eng = engine()
    per_phase = {"prefill": dict.fromkeys(ops.launch_counts(), 0),
                 "decode": dict.fromkeys(ops.launch_counts(), 0)}
    calls = {"prefill": 0, "decode": 0}

    def counted(phase, fn):
        def wrapped(*args, **kw):
            before = ops.launch_counts()
            out = fn(*args, **kw)
            for k, v in ops.launch_counts().items():
                per_phase[phase][k] += v - before[k]
            calls[phase] += 1
            return out
        return wrapped

    eng.prefill_fn = counted("prefill", eng.prefill_fn)
    eng.decode_fn = counted("decode", eng.decode_fn)
    reqs = _requests(Request, np.random.RandomState(0), 16, 16, 160, NEW,
                     cfg.vocab_size)
    torch.cuda.synchronize()
    ops.reset_launch_counts()                 # main path starts here
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    stats = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()            # main path ends here
    check(all(r.done for r in reqs), "serve: not every request completed")
    check(all(0 < len(r.out_tokens) <= NEW for r in reqs), "serve: token counts")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens),
          "serve: token ids out of range")
    check(eng.drain() == 0, "serve: slots still admitted after run()")
    n_usable = eng.allocator.n_pages - eng.allocator.n_reserved
    check(eng.allocator.n_free == n_usable,
          f"serve: pool leaked {n_usable - eng.allocator.n_free} pages")
    for k in ("rmsnorm", "matmul"):
        check(per_phase["prefill"][k] > 0 and per_phase["decode"][k] > 0,
              f"serve: {k} not launched in both prefill and decode {per_phase}")
    check(per_phase["prefill"]["flash_attention"] > 0,
          f"serve: flash_attention not launched in prefill {per_phase}")
    check(per_phase["decode"]["paged_decode_attention"] > 0,
          f"serve: paged_decode_attention not launched in decode {per_phase}")
    for k, v in launches.items():
        check(v > 0, f"serve: kernel {k} never launched on the main path")
    ttft = np.asarray(stats.ttft_s) * 1e3
    per_call = {ph: {k: v / max(calls[ph], 1) for k, v in c.items()}
                for ph, c in per_phase.items()}
    print(f"serve: tinyllama-42m bf16 slots={SLOTS} seq_budget={SB} page={PSZ} "
          f"chunk={CH} requests={len(reqs)} tokens={stats.decoded_tokens} "
          f"ticks={stats.ticks} wall_s={wall:.3f} "
          f"tok_per_s={stats.decoded_tokens / wall:.1f} "
          f"ttft_p50_ms={np.percentile(ttft, 50):.1f} "
          f"ttft_p99_ms={np.percentile(ttft, 99):.1f} "
          f"tpot_p50_ms={np.median(stats.tpot_s) * 1e3:.2f} "
          f"launches={launches} prefill_chunks={calls['prefill']} "
          f"decode_ticks={calls['decode']} per_prefill_chunk="
          f"{per_call['prefill']} per_decode_tick={per_call['decode']}")
    return launches, per_call, wall


def phase_profile(torch, serve_wall_s):
    """Device time by kernel over the serve phase's workload, traced with
    torch.profiler (CUDA activity only).  The busy share divides the traced
    device time by the untraced serve phase's wall time: the same work, so
    what is left is time the device waited on the host."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import model
    from repro_torch.core.partition import ShardingPlan
    from repro_torch.serving import Request, ServingEngine
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config("tinyllama-42m")
    plan = ShardingPlan(kv_cache_dtype="bfloat16")
    params = model.init_params(cfg, plan, torch.Generator().manual_seed(0),
                               device="cuda")
    eng = ServingEngine.build_paged(cfg, plan, 8, 256, params, page_size=16,
                                    prefill_chunk=32, device="cuda")
    for r in _requests(Request, np.random.RandomState(0), 16, 16, 160, 32,
                       cfg.vocab_size):
        eng.submit(r)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.run()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    check(rows, "profile: the trace holds no device time")
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    print(f"profile: serve workload device_ms={total:.2f} serve_wall_ms="
          f"{serve_wall_s * 1e3:.1f} device_busy_share="
          f"{total / (serve_wall_s * 1e3):.3f}")
    for ms, n, key in rows[:12]:
        print(f"  {ms:9.3f} ms {n:6d} calls {100 * ms / total:5.1f}%  {key[:100]}")


KERNELS = {
    "rmsnorm": ("triton", "src/repro_torch/kernels/rmsnorm.py",
                "src/repro/kernels/rmsnorm.py:25"),
    "matmul": ("cuda", "src/repro_torch/kernels/csrc/matmul.cu",
               "src/repro/kernels/matmul.py:36"),
    "flash_attention": ("cuda", "src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:78"),
    "paged_decode_attention": ("cuda", "src/repro_torch/kernels/csrc/paged_decode.cu",
                               "src/repro/kernels/decode_attention.py:179"),
}


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
    try:
        smi_line = phase_env(torch, build)
        rows = phase_kernels(torch, F)
        phase_parity(torch)
        launches, per_call, serve_wall_s = phase_serve(torch)
        phase_profile(torch, serve_wall_s)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        r = rows[name]
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"], "max_abs_err_all_cases": r["max_abs_err_all_cases"],
            "per_prefill_chunk": per_call["prefill"][name],
            "per_decode_tick": per_call["decode"][name]})
    print(f"total_s={time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
