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
2. kernels  each of the thirteen kernel variants (rmsnorm alone, with the
            residual add fused in and as mamba2's gated norm, matmul, flash
            attention, paged decode and paged verify over float and int8
            pools, the SSD scan from a float or an int8 state, decode
            attention over contiguous float or fixed-scale int8 lanes)
            against its plain PyTorch
            version on the card, at the main paths' shapes plus ragged cases
            (for the norm family T in {8, 32, 160}, E 512 and 1024, the
            residual variant's sum bitwise x + r and its norm bitwise
            ops.rmsnorm(x + r), the gated one over n = 2048 with y, z and
            the output each float32 or bf16, one kernel node per call;
            (for matmul every product of both models at M in {8, 32, 33,
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
            with and without windows, the offset as an int32 on the card (a
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
            changes equal to the eager call), with the stated tolerance; median
            times (CUDA graphs of back-to-back calls, CUDA events) of the
            kernel, the plain version and the one PyTorch call that
            computes the same function where there is one (a yardstick
            only; the port never calls it).
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
            printed.  parity-ssm: full-width mamba2-370m in float32, card
            against CPU, from float32 and from int8 state slabs: identical
            greedy tokens (more than one distinct), live logits within
            tolerance, slabs leak-free after drain().  parity-contig: the
            contiguous engine on tinyllama-42m, float32 lanes (tokens also
            equal to the paged engine's on the card) and fixed-scale int8
            lanes; parity-contig-ssm: the contiguous engine on mamba2-370m
            (tokens also equal to the paged engine's on the card).
4. serve    bfloat16 weights, 8 slots, 16 requests, in eight phases:
            full-width tinyllama-42m in serve (bfloat16 pools, random
            prompts), serve-spec (k=4, repetitive prompts), serve-int8
            (int8 pools, random prompts) and serve-spec-int8, full-width
            mamba2-370m (48 layers) in serve-ssm (float32 state slabs) and
            serve-ssm-int8 (int8 slabs), and tinyllama-42m on the
            contiguous engine in serve-contig (bfloat16 lanes) and
            serve-contig-int8 (fixed-scale int8 lanes).  Every request
            completes, pools and slabs are leak-free after drain(), and
            each kernel launched in the steps it belongs to (launch counts
            set to 0 just before each phase and read just after; the SSD
            scan 48 times per prefill chunk, never in a decode tick; the
            contiguous decode kernel (its int8 variant in
            serve-contig-int8) once per layer in every contiguous
            decode tick and in no paged phase, flash attention once per
            layer in every whole-prompt prefill, no paged kernel in a
            contiguous phase; the norm family once per norm of the model
            in every step: one plain norm, the rest with the residual add
            fused in, mamba2's gated norm in every layer; 10L + 2 counted
            kernels per tinyllama decode tick, 8L + 2 per mamba2 tick).
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
5. profile  each serve phase's workload again under torch.profiler:
            device time by kernel, the host-blocking CUDA runtime calls,
            the device's busy share of the phase, and the calls, device
            time per call and share of matmul, flash attention, the SSD
            scan, paged and contiguous decode attention and the norm family
            (never more kernels in the trace than
            launches; the kernel phase checks one kernel per call exactly,
            in CUDA graphs; the kernels of a graph replay are traced one
            by one); for the eager-serial runs of serve, serve-ssm and
            serve-contig too.

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


# Every matmul of the two models' main paths: (name, K, N, trans_b).
MATMULS = (("tinyllama wq/wk/wv/wo", 512, 512, False),
           ("tinyllama w_gate/w_up", 512, 2048, False),
           ("tinyllama w_down", 2048, 512, False),
           ("tinyllama LM head", 512, 32000, True),
           ("mamba2 in_z/in_x", 1024, 2048, False),
           ("mamba2 in_dt", 1024, 32, False),
           ("mamba2 in_B/in_C", 1024, 128, False),
           ("mamba2 out", 2048, 1024, False),
           ("mamba2 LM head", 1024, 50280, True))
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

    # ---- rmsnorm: T = 8 decode rows / 32 chunk rows, E = 512; each call one
    # kernel node in a CUDA graph
    for dt in (torch.float32, torch.bfloat16):
        for T in (8, 32, 33):
            x, s = randn(T, 512, dtype=dt), 0.1 * randn(512, dtype=dt)
            case = f"T={T} {dtype_name(dt)}"
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

    # ---- matmul: every main-path product of both models at the rows a step
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
                           (224, 32)):
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
    # and the whole prompt Sq = Skv = 160; the row of the JSON line is the
    # chunk at q_offset 224, as before
    # (the offset as the chunk step hands it over: an int32 on the card)
    D = 64
    flash_rows = []
    for Sq, Skv, q_off in ((32, 256, 0), (32, 256, 96), (32, 256, 224),
                           (160, 160, 0)):
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

    for name, r in rows.items():
        r["max_abs_err_all_cases"] = max(worst[name], r["max_abs_err"])
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"kernels: {name} [{r['shape']}] ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} library_ms={lib} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"max_abs_err={r['max_abs_err_all_cases']:.3e}")
    return rows


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
                **kw):
    """Serve ``reqs`` on a fresh engine, paged or contiguous (``kw``: e.g.
    ``graphs``, ``overlap``, ``speculative``).  -> (engine, tokens per
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
    for r in reqs:
        eng.submit(r)
    eng.run()
    check(all(r.done for r in reqs), f"parity: unfinished requests on {device}")
    check(eng._inflight is None and eng.drain() == 0,
          f"parity: work in flight or slots still admitted on {device}")
    check(not paged or eng.allocator.n_free ==
          eng.allocator.n_pages - eng.allocator.n_reserved,
          f"parity: pool not leak-free after drain() on {device}")
    check(not eng.has_slabs or eng.slab_allocator.n_free == eng.n_slabs - 1,
          f"parity: slabs not leak-free after drain() on {device}")
    return eng, [r.out_tokens for r in reqs], torch.cat(steps), emitted


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
}
# the phases served by the contiguous engine (the others are paged)
CONTIG_PHASES = ("serve-contig", "serve-contig-int8")
# the phases served again with eager steps and the serial loop
AB_PHASES = ("serve", "serve-ssm", "serve-contig")
# the mixer kernel each serving phase must launch: attention in its decode or
# verify ticks; the SSD scan in its prefill chunks, once per layer, and never
# in a decode tick
PHASE_MIXER = {"serve": "paged_decode_attention",
               "serve-spec": "paged_verify_attention",
               "serve-int8": "paged_decode_attention_i8",
               "serve-spec-int8": "paged_verify_attention_i8",
               "serve-ssm": "ssd_scan",
               "serve-ssm-int8": "ssd_scan_i8",
               "serve-contig": "decode_attention",
               "serve-contig-int8": "decode_attention_i8"}
# the norm kernel's three variants: alone (the first layer's input norm),
# with the residual add before it, and mamba2's gated norm
NORMS = ("rmsnorm", "rmsnorm_residual", "rmsnorm_gated")


SLOTS, SB, PSZ, CH, NEW = 8, 256, 16, 32, 32


def _serve_setup(torch, name):
    """Serve phase ``name``'s model, an engine factory and its 16 requests:
    the full-width arch, bfloat16 weights, 8 slots, prompts 16-160 tokens,
    32 new (random prompts, or repetitive motifs where speculation runs);
    the contiguous engine for ``CONTIG_PHASES``, else the paged one."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import model
    from repro_torch.core.partition import ShardingPlan
    from repro_torch.serving import Request, ServingEngine
    arch, kvd, ssmd, k, kind = SERVE_PHASES[name]
    cfg = get_config(arch)
    plan = ShardingPlan(kv_cache_dtype=kvd, ssm_cache_dtype=ssmd)
    params = model.init_params(cfg, plan, torch.Generator().manual_seed(0),
                               device="cuda")
    make = _requests if kind == "random" else _motif_requests

    def engine(graphs=True, overlap=True):
        if name in CONTIG_PHASES:
            return ServingEngine(cfg, plan, SLOTS, SB, params, graphs=graphs,
                                 device="cuda")
        return ServingEngine.build_paged(cfg, plan, SLOTS, SB, params,
                                         page_size=PSZ, prefill_chunk=CH,
                                         speculative=k, overlap=overlap,
                                         graphs=graphs, device="cuda")

    def requests(seed=0, n=16, new=NEW):
        return make(Request, np.random.RandomState(seed), n, 16, 160, new,
                    cfg.vocab_size)

    return cfg, engine, requests


# the kernels of the port, by the names their functions carry in a graph
OUR_KERNELS = ("matmul_mma_kernel", "matmul_simt_kernel", "flash_mma_kernel",
               "flash_simt_kernel", "paged_mma_kernel", "paged_simt_kernel",
               "contig_simt_kernel", "ssd_mma_kernel", "ssd_simt_kernel",
               "_rmsnorm_kernel")


def graph_report(torch, name, steps, calls):
    """Each captured step graph of an engine, read node by node: kernel
    nodes (the port's kernels by name, which must be the step's counted
    launches per replay, and PyTorch's, the greedy argmax among them),
    memcpy and memset nodes, the memory its capture reserved, and the
    launches of the phase (counted launches x replays)."""
    out = {}
    for kind, step in steps.items():
        nodes = read_graph(step.graph, names=True)
        kern = [n for k, n in nodes if k == 0]
        ours = sum(any(f in n for f in OUR_KERNELS) for n in kern)
        counted = sum(step.launches.values())
        check(ours == counted, f"{name}: the {kind} graph holds {ours} of the "
                               f"port's kernels, its capture counted {counted}")
        check(any("ArgMax" in n for n in kern),
              f"{name}: no argmax kernel in the {kind} graph")
        n_copy = sum(k == 1 for k, _ in nodes)
        n_set = sum(k == 2 for k, _ in nodes)
        replays = calls[kind]
        print(f"  graph[{kind}]: kernel_nodes={len(kern)} (the port's {ours} = "
              f"counted launches per replay, PyTorch's {len(kern) - ours} "
              f"with the argmax) memcpy_nodes={n_copy} memset_nodes={n_set} "
              f"other_nodes={len(nodes) - len(kern) - n_copy - n_set} "
              f"pool_MiB={step.pool_bytes / 2**20:.2f} replays={replays} "
              f"launches={counted} x {replays} = {counted * replays}")
        out[kind] = dict(kernel_nodes=len(kern), ours=ours, memcpy=n_copy,
                         memset=n_set, pool_bytes=step.pool_bytes,
                         replays=replays)
    return out


def sync_check(torch, name, engine, requests):
    """Serve the phase's requests on a fresh default engine, every tick's
    plan and dispatch under ``torch.cuda.set_sync_debug_mode("error")``
    (collect outside it): dispatch never blocks the host, and only
    collect waits (the JAX engine's async-barrier invariant)."""
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

    ticks = 0
    while eng.has_pending() or any(a is not None for a in eng.admissions):
        strict(eng._plan_phase, "plan")
        eng._collect_phase()
        strict(eng._dispatch_phase, "dispatch")
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

    from repro_torch.kernels import ops
    arch, kvd, ssmd, k, kind = SERVE_PHASES[name]
    cfg, engine, requests = _serve_setup(torch, name)
    variant = "graphed-overlap" if graphs else "eager-serial"
    warm = engine(graphs, overlap)                     # first-call costs
    for r in requests(seed=1, n=2, new=4):
        warm.submit(r)
    warm.run()

    t0 = time.perf_counter()
    eng = engine(graphs, overlap)
    build_s = time.perf_counter() - t0
    graph_steps = dict(eng.steps)
    kinds = ("prefill", "decode", "verify")
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
    reqs = requests()
    torch.cuda.synchronize()
    ops.reset_launch_counts()                 # main path starts here
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    stats = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()            # main path ends here
    check(all(r.done for r in reqs), f"{name}: not every request completed")
    check(all(0 < len(r.out_tokens) <= NEW for r in reqs), f"{name}: token counts")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens),
          f"{name}: token ids out of range")
    check(eng.drain() == 0, f"{name}: slots still admitted after run()")
    if eng.paged:
        n_usable = eng.allocator.n_pages - eng.allocator.n_reserved
        check(eng.allocator.n_free == n_usable,
              f"{name}: pool leaked {n_usable - eng.allocator.n_free} pages")
    if eng.has_slabs:
        check(eng.slab_allocator.n_free == eng.n_slabs - 1,
              f"{name}: slabs leaked")
    steps = [kd for kd in ("decode", "verify") if calls[kd]]
    check(all(per_phase[kd]["matmul"] > 0 for kd in ["prefill"] + steps),
          f"{name}: matmul not launched in every step kind {per_phase}")
    mixer = PHASE_MIXER[name]
    n_layers = cfg.n_layers
    # every step runs the norm family once per norm of the model: the plain
    # norm for the first layer's input, every later norm with the residual
    # add before it fused in (tinyllama 2L of them, mamba2 L), and mamba2's
    # gated norm in every layer; each decode tick launches as many counted
    # kernels as before the fusion (tinyllama 10L + 2, mamba2 8L + 2)
    ssm = arch.startswith("mamba2")
    per_norm = {"rmsnorm": 1, "rmsnorm_residual": n_layers * (1 if ssm else 2),
                "rmsnorm_gated": n_layers if ssm else 0}
    for kd in ["prefill"] + steps:
        got = {kn: per_phase[kd][kn] for kn in NORMS}
        check(got == {kn: v * calls[kd] for kn, v in per_norm.items()},
              f"{name}: norm launches {got} in {calls[kd]} {kd} steps, not "
              f"{per_norm} per step")
    per_tick = (8 if ssm else 10) * n_layers + 2
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
    elif eng.has_slabs:
        n_ssm = n_layers
        check(per_phase["prefill"][mixer] == n_ssm * calls["prefill"] > 0 and
              per_phase["decode"][mixer] == 0,
              f"{name}: {mixer} not launched {n_ssm} times per prefill chunk "
              f"and never in a decode tick {per_phase}")
        others = [kn for kn, v in launches.items()
                  if v and kn not in NORMS + ("matmul", mixer)]
        check(not others, f"{name}: unexpected kernels launched {others}")
    else:
        check(per_phase["prefill"]["flash_attention"] > 0,
              f"{name}: flash_attention not launched in prefill {per_phase}")
        check(per_phase["verify" if k else "decode"][mixer] > 0,
              f"{name}: {mixer} not launched {per_phase}")
        check(launches["flash_attention"] > 0,
              f"{name}: kernel flash_attention never launched")
    if eng.paged:
        check(launches["decode_attention"] == launches["decode_attention_i8"] == 0,
              f"{name}: the contiguous decode attention launched in a paged phase")
    if k:
        check(stats.spec_accepted > 0, f"{name}: no draft accepted")
    for kn in ("rmsnorm", "rmsnorm_residual", "matmul", mixer) + \
            (("rmsnorm_gated",) if ssm else ()):
        check(launches[kn] > 0, f"{name}: kernel {kn} never launched")
    ttft = np.asarray(stats.ttft_s) * 1e3
    per_call = {kd: {kn: v / max(calls[kd], 1) for kn, v in c.items() if v}
                for kd, c in per_phase.items()}
    step_calls = {"chunk": calls["prefill"], "decode": calls["decode"],
                  "verify": calls["verify"]}
    spec = (f"acceptance_rate={stats.spec_accepted / max(stats.spec_drafted, 1):.3f} "
            f"tokens_per_drafted_slot_step={stats.accepted_tokens_per_tick:.3f} "
            f"verify_ticks={calls['verify']} per_verify_tick={per_call['verify']} "
            if k else "")
    store = (f"{ssmd or 'float32'} slabs" if eng.has_slabs else
             f"{kvd} {'pools' if eng.paged else 'lanes'}")
    layout = f"page={PSZ} chunk={CH}" if eng.paged else "contiguous"
    print(f"{name}: [{variant}] {arch} bf16 weights, {store}, speculative={k}, "
          f"{kind} prompts, slots={SLOTS} seq_budget={SB} {layout} "
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
          f"tpot_p50_ms={np.median(stats.tpot_s) * 1e3:.2f} {spec}"
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
    return dict(launches=launches, per_call=per_call, wall=wall,
                ticks=stats.ticks, tokens=stats.decoded_tokens,
                graphs=graphs_out, tokens_by_request=[r.out_tokens for r in reqs])


def phase_profile(torch, name, serve_wall_s, graphs=True, overlap=True):
    """Device time by kernel over serve phase ``name``'s workload, traced
    with torch.profiler (CUDA activity only; the kernels of a graph replay
    are traced one by one), and the CUDA runtime calls that block the
    host (synchronizations and copies).  The busy share divides the
    traced device time by the untraced phase's wall time: the same work,
    so what is left is time the device waited on the host."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
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
    return dict(device_ms=total, busy=total / (serve_wall_s * 1e3))


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
        timed("parity-ssm", phase_parity_ssm, torch)
        timed("parity-contig", phase_parity_contig, torch)
        timed("parity-contig-ssm", phase_parity_contig_ssm, torch)
        served = {name: timed(name, phase_serve, torch, name)
                  for name in SERVE_PHASES}
        # the same phases with eager steps and the serial loop, in this call
        eager = {name: timed(f"{name}[eager-serial]", phase_serve, torch, name,
                             False, False) for name in AB_PHASES}
        for name, out in eager.items():
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
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        r = rows[name]
        by_phase = {ph: out["launches"][name] for ph, out in served.items()}
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
