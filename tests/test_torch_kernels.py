"""The port's plain kernel versions (``repro_torch.kernels.ref`` through
``kernels.ops`` on CPU tensors) against the JAX package's Pallas kernels
run in interpret mode, and against its ``kernels/ref.py`` oracles, on the
same numpy inputs.  Tolerances are ``tests/test_kernels.py``'s: fp32 1e-4,
bf16 2e-2.  The Hopper kernels themselves run only on the card, where
``chip_smoke.py`` holds each against these plain versions."""
import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attention as jattn
from repro.kernels import ref as jref
from repro.kernels.decode_attention import paged_decode_attention as pl_paged
from repro.kernels.flash_attention import flash_attention as pl_flash
from repro.kernels.matmul import matmul as pl_matmul
from repro.kernels.rmsnorm import rmsnorm as pl_rmsnorm
from repro_torch.kernels import decode_attention as k_decode
from repro_torch.kernels import flash_attention as k_flash
from repro_torch.kernels import matmul as k_matmul
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as k_rmsnorm
from repro_torch.kernels import ssd_scan as k_ssd

DTYPES = [("float32", jnp.float32, torch.float32),
          ("bfloat16", jnp.bfloat16, torch.bfloat16)]


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else \
        dict(rtol=1e-4, atol=1e-4)


def _both(x, jdt, tdt):
    x = np.asarray(x, np.float32)
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _close(got_torch, want_jax, name):
    np.testing.assert_allclose(got_torch.float().numpy(),
                               np.asarray(want_jax, np.float32), **_tol(name))


@pytest.mark.parametrize("t,e", [(64, 128), (100, 256), (33, 512)])
@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
def test_rmsnorm_matches_pallas(t, e, name, jdt, tdt):
    rng = np.random.RandomState(t + e)
    xj, xt = _both(rng.randn(t, e), jdt, tdt)
    sj, st = _both(rng.randn(e) * 0.1, jdt, tdt)
    got = ops.rmsnorm(xt, st)
    _close(got, pl_rmsnorm(xj, sj, bs=32, interpret=True), name)
    _close(got, jref.ref_rmsnorm(xj, sj), name)


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 256, 128)])
@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
def test_matmul_matches_pallas(m, k, n, name, jdt, tdt):
    rng = np.random.RandomState(m + k + n)
    aj, at = _both(rng.randn(m, k), jdt, tdt)
    bj, bt = _both(rng.randn(k, n), jdt, tdt)
    got = ops.matmul(at, bt)
    _close(got, pl_matmul(aj, bj, bm=128, bk=128, bn=128, interpret=True), name)
    _close(got, jref.ref_matmul(aj, bj), name)


@pytest.mark.parametrize("m,k,n", [(8, 512, 96), (33, 72, 200), (1, 40, 7)])
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
def test_matmul_ragged_and_transposed_match_ref(m, k, n, trans_b, name, jdt,
                                                tdt):
    """Shapes the Pallas kernel cannot take (it needs dividing blocks):
    decode's M = 8, odd N, and the tied head's (N, K) operand."""
    rng = np.random.RandomState(m * k + n)
    aj, at = _both(rng.randn(m, k), jdt, tdt)
    b = rng.randn(n, k) if trans_b else rng.randn(k, n)
    bj, bt = _both(b, jdt, tdt)
    want = jref.ref_matmul(aj, bj.T if trans_b else bj)
    _close(ops.matmul(at, bt, trans_b=trans_b), want, name)


# Every matmul of the two models' main paths, as (K, N, trans_b):
# tinyllama-42m q/k/v/o, gate/up, down and the tied head (N, K); mamba2-370m
# in_z/in_x, in_dt, in_B/in_C, out and the tied head.
MAIN_MATMULS = [(512, 512, False), (512, 2048, False), (2048, 512, False),
                (512, 32000, True), (1024, 2048, False), (1024, 32, False),
                (1024, 128, False), (2048, 1024, False), (1024, 50280, True)]


@pytest.mark.parametrize("m", [8, 32, 33, 40, 160])
@pytest.mark.parametrize("k,n,trans_b", MAIN_MATMULS)
def test_matmul_plan_limits_at_main_shapes(k, n, trans_b, m):
    """The bf16 launch plan at the rows a step hands over (decode 8, chunk
    32, ragged 33, k=4 verify 40, a whole prompt up to 160): no block
    streams more than 32 KB of weights per tile, a 2 MB weight puts a
    block on each of the 132 SMs and a smaller one a block per 16 KB, the
    split divides the K tiles within a cluster of 8, shared memory fits
    in 227 KB, and the tiles cover the output."""
    p = k_matmul.plan(m, n, k, torch.bfloat16, trans_b)
    assert p.kernel == "mma" and p.vec
    k_tiles = -(-k // p.bk)
    assert p.bk * p.bn == 4096 and p.bn in (16, 32, 64)
    assert k_tiles % p.split == 0 and p.kt == k_tiles // p.split
    assert p.split in (1, 2, 4, 8)
    assert p.bn * p.kt * p.bk * 2 == p.tile_bytes <= 32 * 1024
    if k * n * 2 >= 2 * 2**20:
        assert p.blocks >= 132
    else:                              # small weights: a block per 16 KB
        assert p.blocks >= -(-k * n * 2 // (16 * 1024))
    assert p.smem <= 232448
    assert p.bm % 8 == 0 and p.bm <= 64
    assert (p.n_tiles - 1) * p.bn < n <= p.n_tiles * p.bn
    assert (p.m_tiles - 1) * p.bm < m <= p.m_tiles * p.bm
    # a split's blocks share one tile; a split-1 block may walk several
    assert p.grid_n == p.n_tiles if p.split > 1 else 1 <= p.grid_n <= p.n_tiles


@pytest.mark.parametrize("trans_b,bn,bm,kt,split,tiles,want", [
    # ring + K-warp partials + split inboxes + activations (odd chunk stride)
    (True, 16, 8, 4, 1, 6, 2 * 4 * 8192 + 4 * 8 * 16 * 4 + 8 * 129 * 16),
    (True, 32, 8, 2, 1, 9, 4 * 2 * 8192 + 2 * 8 * 32 * 4 + 8 * 33 * 16),
    (True, 64, 40, 1, 1, 1, 8192 + 40 * 9 * 16),
    (False, 16, 8, 4, 1, 6, 6 * 8192 + 4 * 8 * 16 * 4 + 8 * 129 * 16),
    (False, 64, 8, 1, 8, 1, 8192 + 8 * 64 * 4 + 8 * 64 * 4 + 8 * 9 * 16),
    (False, 64, 40, 2, 1, 1, 2 * 8192 + 40 * 17 * 16),
    (False, 32, 56, 4, 2, 1,
     4 * 8192 + 2 * 56 * 32 * 4 + 56 * 32 * 4 + 56 * 65 * 16),
])
def test_matmul_smem_layout(trans_b, bn, bm, kt, split, tiles, want):
    """The shared memory the plan asks for, term by term as csrc/matmul.cu
    lays it out (smem_bytes), which refuses a launch that differs: an
    (N, K) weight rings 4 whole tiles of up to 16 KB or 2 larger, a (K, N)
    weight up to 6 pieces of 8 KB."""
    assert k_matmul._smem_bytes(trans_b, bn, bm, kt, split, tiles) == want


def test_matmul_plan_mirrors_the_kernel_source():
    """The plan's ring constants are the ones csrc/matmul.cu compiles."""
    src = (Path(k_matmul.__file__).parent / "csrc" / "matmul.cu").read_text()
    assert re.search(rf"constexpr int STAGE = {k_matmul.STAGE};", src)
    assert re.search(rf"constexpr int STAGES = {k_matmul.STAGES};", src)
    assert re.search(r"constexpr int THREADS = 128;", src)
    assert re.search(rf"__launch_bounds__\(THREADS, {k_matmul.MAX_BLOCKS_SM}\)", src)


@pytest.mark.parametrize("m,n,k,trans_b,vec", [
    (8, 520, 1004, False, False), (33, 300, 1004, True, False),
    (8, 50, 512, False, False), (8, 50, 512, True, True),
    (1, 7, 40, False, False), (5, 64, 0, True, True)])
def test_matmul_plan_takes_ragged_shapes(m, n, k, trans_b, vec):
    """K or N off a multiple of 8 gathers chunks element by element (no
    cp.async) in the same kernel; the plan still covers the output."""
    p = k_matmul.plan(m, n, k, torch.bfloat16, trans_b)
    assert p.kernel == "mma" and p.vec is vec
    assert p.split * p.kt * p.bk >= k and p.n_tiles * p.bn >= n
    assert p.smem <= 232448


def test_matmul_plan_float32_stays_on_cuda_cores():
    for m, bm in ((8, 32), (32, 32), (33, 64), (160, 64)):
        p = k_matmul.plan(m, 32000, 512, torch.float32, True)
        assert (p.kernel, p.bm, p.bn, p.split, p.smem) == ("simt", bm, 64, 1, 0)


def _misaligned(rows, cols, dtype):
    """A contiguous (rows, cols) view two bytes past a 16-byte boundary."""
    return torch.zeros(rows * cols + 1, dtype=dtype)[1:].view(rows, cols)


@pytest.mark.parametrize("refuse", [
    lambda: k_matmul.launch_plan(_misaligned(8, 512, torch.bfloat16),
                                 torch.zeros(512, 64, dtype=torch.bfloat16),
                                 False),
    lambda: k_matmul.launch_plan(torch.zeros(8, 512, dtype=torch.bfloat16),
                                 _misaligned(64, 512, torch.bfloat16), True),
    lambda: k_matmul.launch_plan(torch.zeros(8, 512, dtype=torch.bfloat16),
                                 torch.zeros(256, 64, dtype=torch.bfloat16),
                                 False),
    lambda: k_matmul.plan(8, 64, 10**7, torch.bfloat16, False),
    lambda: k_matmul.plan(8, 64, 512, torch.float16, False),
    lambda: k_matmul.plan(0, 64, 512, torch.bfloat16, False),
])
def test_matmul_launch_plan_refuses_what_the_kernel_cannot_take(refuse):
    """Misaligned operands, mismatched inner dims, a K range beyond shared
    memory and dtypes without a kernel raise ValueError before any launch."""
    with pytest.raises(ValueError):
        refuse()


def test_matmul_float32_takes_misaligned_operands():
    """The CUDA-core kernel reads element by element: any address."""
    p = k_matmul.launch_plan(_misaligned(8, 512, torch.float32),
                             torch.zeros(512, 64), False)
    assert p.kernel == "simt"


# the flash call sites: the paged prefill chunk (8 heads, 32 queries over
# the 256-key gathered prefix) and the contiguous whole prompt (Sq = Skv,
# 16-160), at each head dim the kernel takes, with and without a window
FLASH_SHAPES = [(8, 32, 256), (8, 16, 16), (8, 23, 23), (8, 130, 130),
                (8, 160, 160)]


@pytest.mark.parametrize("window", [0, 32])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("h,sq,skv", FLASH_SHAPES)
def test_flash_plan_limits_at_main_shapes(h, sq, skv, d, window):
    """The bf16 launch plan: a cluster of at most 8 blocks and no more
    ranks than key tiles, shared memory within 227 KB, and the split only
    stops doubling at the SMs (or at the window's span)."""
    p = k_flash.plan(h, sq, skv, d, torch.bfloat16, window)
    assert p.kernel == "mma" and p.split in (1, 2, 4, 8)
    assert p.wq == min(4, -(-sq // 16))
    row_tiles, n_tiles = -(-sq // (16 * p.wq)), -(-skv // 64)
    assert p.smem <= 232448
    assert p.smem == k_flash._smem_bytes(d, p.wq, p.split)
    assert p.split <= max(1, n_tiles)
    if p.split < 8 and p.split * 2 <= n_tiles and not window:
        assert h * row_tiles * p.split >= 132


class _CInt(int):
    """An int with C's integer division and remainder (toward zero)."""

    def _c(f):
        return lambda a, b: _CInt(f(int(a), int(b)))

    def _div(a, b):
        q = abs(a) // abs(b)
        return q if (a < 0) == (b < 0) else -q

    __add__ = __radd__ = _c(lambda a, b: a + b)
    __sub__ = _c(lambda a, b: a - b)
    __rsub__ = _c(lambda a, b: b - a)
    __mul__ = __rmul__ = _c(lambda a, b: a * b)
    __truediv__ = _c(_div)
    __mod__ = _c(lambda a, b: a - b * _CInt._div(a, b))


@pytest.mark.parametrize("n_tiles", [1, 4, 9])
@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_flash_kernel_deals_each_visible_tile_once(split, n_tiles):
    """The kernel's own formulas (t_first, my_n in csrc/flash_attention.cu,
    evaluated with C's integer arithmetic): for every range [t_begin, t_end)
    of key tiles a block's rows can see, the ranks of a cluster walk each
    tile of it exactly once, tile t on rank t % split, and none outside it."""
    src = (Path(k_flash.__file__).parent / "csrc" /
           "flash_attention.cu").read_text()
    first = re.search(r"const int t_first = (.+?);\n", src).group(1)
    count = re.search(r"const int my_n = t_first < t_end \? (.+?) : 0;\n",
                      src).group(1)
    for t_begin in range(n_tiles + 1):
        for t_end in range(t_begin, n_tiles + 1):
            dealt = []
            for rank in range(split):
                env = {"rank": _CInt(rank), "split": _CInt(split),
                       "t_begin": _CInt(t_begin), "t_end": _CInt(t_end)}
                env["t_first"] = t_first = eval(first, {}, env)
                my_n = eval(count, {}, env) if t_first < t_end else 0
                tiles = [t_first + i * split for i in range(my_n)]
                assert all(t % split == rank for t in tiles)
                dealt += tiles
            assert sorted(dealt) == list(range(t_begin, t_end))


def test_flash_plan_reads_no_q_offset():
    """The launch geometry depends only on the shapes: the plan takes no
    q_offset, and the chunk shape gets its cluster split however far into
    the prompt the chunk sits."""
    import inspect
    assert "q_offset" not in inspect.signature(k_flash.plan).parameters
    p = k_flash.plan(8, 32, 256, 64, torch.bfloat16)
    assert (p.wq, p.split) == (2, 4)


@pytest.mark.parametrize("d,wq,split,want", [
    (64, 2, 1, 2 * 2 * 64 * 9 * 16),
    (64, 2, 4, 2 * 2 * 64 * 9 * 16 + 4 * (4 * 8 * 66 + 5 * 8)),
    (128, 4, 8, 2 * 2 * 64 * 17 * 16 + 4 * (8 * 8 * 130 + 9 * 8)),
    (32, 1, 2, 2 * 2 * 64 * 5 * 16 + 4 * (2 * 8 * 34 + 3 * 8)),
])
def test_flash_smem_layout(d, wq, split, want):
    """Shared memory term by term as csrc/flash_attention.cu lays it out
    (smem_bytes), which refuses a launch that differs: the two-stage K/V
    ring at an odd chunk stride, then the inbox of a split."""
    assert k_flash._smem_bytes(d, wq, split) == want


def test_flash_plan_mirrors_the_kernel_source():
    """The plan's constants are the ones csrc/flash_attention.cu compiles."""
    src = (Path(k_flash.__file__).parent / "csrc" /
           "flash_attention.cu").read_text()
    assert re.search(rf"constexpr int KV_TILE = {k_flash.KV_TILE};", src)
    assert re.search(rf"constexpr int WQ_MAX = {k_flash.WQ_MAX};", src)
    assert re.search(rf"constexpr int KV_STAGES = {k_flash.KV_STAGES};", src)
    assert re.search(r"return d / 8 \+ 1;", src)
    assert "asm" not in src             # the tensor-core kit of common.cuh
    assert "mma_bf16(" in src and "ldsm_x4_trans(" in src


def test_flash_plan_float32_stays_on_cuda_cores():
    for sq in (16, 32, 160):
        p = k_flash.plan(8, sq, 256, 64, torch.float32)
        assert (p.kernel, p.wq, p.split, p.smem) == ("simt", 4, 1, 0)


@pytest.mark.parametrize("refuse", [
    lambda: k_flash.plan(8, 32, 256, 96, torch.bfloat16),
    lambda: k_flash.plan(8, 32, 256, 64, torch.float16),
    lambda: k_flash.plan(0, 32, 256, 64, torch.bfloat16),
    lambda: k_flash.plan(70000, 32, 256, 64, torch.bfloat16),
])
def test_flash_plan_refuses_what_the_kernel_cannot_take(refuse):
    with pytest.raises(ValueError):
        refuse()


@pytest.mark.parametrize("sq,skv,causal,win", [
    (64, 64, True, 0), (32, 96, True, 0), (64, 64, True, 16),
    (32, 32, False, 0)])
@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
def test_flash_attention_matches_pallas(sq, skv, causal, win, name, jdt, tdt):
    """The Pallas contract: queries are the suffix of the key stream."""
    rng = np.random.RandomState(sq + skv + win)
    qj, qt = _both(rng.randn(2, sq, 32), jdt, tdt)
    kj, kt = _both(rng.randn(2, skv, 32), jdt, tdt)
    vj, vt = _both(rng.randn(2, skv, 32), jdt, tdt)
    got = ops.flash_attention(qt, kt, vt, causal=causal, window=win)
    _close(got, pl_flash(qj, kj, vj, causal=causal, window=win, bq=32,
                         bkv=32, interpret=True), name)
    _close(got, jref.ref_flash_attention(qj, kj, vj, causal=causal,
                                         window=win), name)


@pytest.mark.parametrize("q_offset,win", [(0, 0), (40, 0), (96, 0), (40, 24)])
@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
def test_flash_attention_q_offset_matches_core(q_offset, win, name, jdt, tdt):
    """The prefill chunk's placement: queries at ``q_offset`` inside a longer
    gathered stream whose tail past the chunk must be masked causally — the
    JAX package's ``core.attention.flash_attention`` computes it."""
    rng = np.random.RandomState(q_offset + win)
    H, Sq, Skv, D = 4, 32, 128, 32
    qj, qt = _both(rng.randn(H, Sq, D), jdt, tdt)
    kj, kt = _both(rng.randn(H, Skv, D), jdt, tdt)
    vj, vt = _both(rng.randn(H, Skv, D), jdt, tdt)
    want = jattn.flash_attention(qj[None, :, None], kj[None], vj[None],
                                 causal=True, window=win,
                                 q_offset=q_offset)[0, :, 0]
    _close(ops.flash_attention(qt, kt, vt, window=win, q_offset=q_offset),
           want, name)


def _paged_case(rng, B, H, D, psz, n_max, lengths):
    n_pages = B * n_max + 1
    bt = (rng.permutation(n_pages - 1)[:B * n_max] + 1).reshape(B, n_max)
    bt[-1] = 0                                   # idle lane: scratch page
    return (rng.randn(B, H, D), rng.randn(n_pages, H, psz, D),
            rng.randn(n_pages, H, psz, D), bt.astype(np.int32),
            np.asarray(lengths, np.int32))


@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
def test_paged_decode_matches_pallas(name, jdt, tdt):
    """Lengths crossing page boundaries, a shuffled block table and an idle
    lane on the scratch page; ``length`` counts valid tokens (pos + 1)."""
    rng = np.random.RandomState(3)
    q, kp, vp, bt, length = _paged_case(rng, 5, 4, 32, 8, 4,
                                        [1, 8, 9, 32, 1])
    qj, qt = _both(q, jdt, tdt)
    kj, kt = _both(kp, jdt, tdt)
    vj, vt = _both(vp, jdt, tdt)
    got = ops.paged_decode_attention(qt, kt, vt, torch.from_numpy(bt),
                                     torch.from_numpy(length))
    _close(got, pl_paged(qj, kj, vj, jnp.asarray(bt), jnp.asarray(length),
                         interpret=True), name)


# The paged kernels' launch plan (kernels/decode_attention.py::plan) at
# serve's shapes (8 slots x 8 heads, n_max 16) and others the kernel takes:
# decode (nq 1) and verify (nq 2-8), each head dim, pages of 8 and 16, float
# and int8 pools
PAGED_SHAPES = [(8, 8, 16), (8, 8, 8), (2, 3, 16), (1, 1, 1), (64, 32, 64)]


@pytest.mark.parametrize("quant", [False, True], ids=["bf16-pools", "int8-pools"])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("nq", [1, 5, 8])
@pytest.mark.parametrize("b,h,psz", PAGED_SHAPES)
def test_paged_plan_limits_at_main_shapes(b, h, psz, nq, d, quant):
    """The bf16 launch plan: a cluster of at most 8 blocks and no more ranks
    than 16-key tiles in n_max * psz keys (so at most n_max at pages of 16
    or fewer), 1-4 warps, shared memory within 227 KB, and the split only
    stops doubling at the SMs or at the tiles."""
    n_max = 16
    p = k_decode.plan(b, h, nq, d, psz, n_max, torch.bfloat16, quant)
    n_tiles = -(-n_max * psz // 16)
    assert p.kernel == "mma" and p.split in (1, 2, 4, 8)
    assert p.split <= n_tiles and p.split <= n_max
    assert p.nw == min(4, -(-n_tiles // p.split))
    assert p.smem <= 232448
    assert p.smem == k_decode._smem_bytes(d, quant, nq, p.nw, p.split)
    if p.split < 8 and p.split * 2 <= n_tiles:
        assert b * h * p.split >= 132
    if (b, h, psz) == (8, 8, 16):
        assert (p.split, p.nw) == (4, 4)


@functools.lru_cache(maxsize=None)
def _paged_dealing_formulas():
    """The kernel's lines n_kv, n_tiles, k_lo (its windowed form), t_lo,
    t_first and my_n, compiled as Python expressions."""
    src = (Path(k_decode.__file__).parent / "csrc" /
           "paged_decode.cu").read_text()
    lines = [re.search(rf"const int {v} = (.+?);", src).group(1)
             for v in ("n_kv", "n_tiles")]
    k_lo = re.search(r"const int k_lo = WINDOW \? (.+?) : 0;", src).group(1)
    lines += [k_lo] + [re.search(rf"const int {v} = (.+?);", src).group(1)
                       for v in ("t_lo", "t_first")]
    count = re.search(r"const int my_n = t_first < n_tiles \? (.+?) : 0;",
                      src).group(1)
    assert "KT" in lines[1] and "KT" in lines[3] and "window" in k_lo
    return [compile(e, "paged_decode.cu", "eval") for e in lines + [count]]


def _paged_dealt(split, psz, n_max, nw, nq, length, window):
    """Evaluate the kernel's dealing lines for one slot: -> (n_kv, k_lo,
    tiles dealt, keys read, {page: ranks})."""
    n_kv_e, n_tiles_e, k_lo_e, t_lo_e, first_e, count_e = \
        _paged_dealing_formulas()
    env = {"min": lambda a, b: _CInt(min(a, b)),
           "max": lambda a, b: _CInt(max(a, b)),
           "KT": _CInt(16), "psz": _CInt(psz), "n_max": _CInt(n_max),
           "split": _CInt(split), "nw": _CInt(nw), "nq": _CInt(nq),
           "length": _CInt(length), "window": _CInt(window)}
    env["n_kv"] = n_kv = eval(n_kv_e, {}, env)
    env["n_tiles"] = n_tiles = eval(n_tiles_e, {}, env)
    env["k_lo"] = k_lo = eval(k_lo_e, {}, env) if window > 0 else _CInt(0)
    env["t_lo"] = eval(t_lo_e, {}, env)
    tiles, keys, pages = [], [], {}
    for rank in range(split):
        for warp in range(nw):
            env.update(rank=_CInt(rank), warp=_CInt(warp))
            env["t_first"] = t_first = eval(first_e, {}, env)
            my_n = eval(count_e, {}, env) if t_first < n_tiles else 0
            for i in range(my_n):
                t = t_first + i * split * nw
                assert (t - env["t_lo"]) % split == rank
                tiles.append(t)
                kp = [k for k in range(16 * t, 16 * t + 16) if k < n_kv]
                keys += kp
                for k in kp:
                    pages.setdefault(k // psz, set()).add(rank)
    return n_kv, k_lo, tiles, keys, pages


@pytest.mark.parametrize("psz", [8, 16])
@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_paged_kernel_deals_each_visible_page_once(split, psz):
    """The kernel's own formulas (n_kv, n_tiles, t_first, my_n in
    csrc/paged_decode.cu, evaluated with C's integer arithmetic): for every
    length from 0 to n_max * psz + 7 and every nq from 1 to 8, the warps of
    a cluster walk each 16-key tile the deepest query sees exactly once and
    no other (keys past n_max * psz never), tile t on rank t % split; so
    every visible page goes to exactly one rank (a 16-key tile holds one
    page of 16 or two of 8)."""
    n_max = 4
    for nw in range(1, 5):
        for nq in range(1, 9):
            for length in range(n_max * psz + 8):
                _, _, tiles, keys, pages = _paged_dealt(split, psz, n_max, nw,
                                                        nq, length, 0)
                want = min(length + nq - 1, n_max * psz)
                assert sorted(tiles) == list(range(-(-max(want, 0) // 16)))
                assert sorted(keys) == list(range(max(want, 0)))
                assert sorted(pages) == list(range(-(-max(want, 0) // psz)))
                assert all(len(r) == 1 for r in pages.values())


@pytest.mark.parametrize("psz", [8, 16])
@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_paged_kernel_deals_a_windows_tiles_once(split, psz):
    """With a sliding window, the same lines deal the tiles from the one
    holding query 0's first key, ``length - window``, to the deepest
    query's last: every key some query's window holds is read exactly
    once, tile t on rank (t - t_lo) % split, and no tile wholly below the
    lowest window start is read."""
    n_max = 4
    for window in (1, 5, 16, 17, 40):
        for nw in (1, 3, 4):
            for nq in (1, 2, 5, 8):
                for length in range(1, n_max * psz + 1):
                    n_kv, k_lo, tiles, keys, pages = _paged_dealt(
                        split, psz, n_max, nw, nq, length, window)
                    seen = {k for i in range(nq)
                            for k in range(max(0, length + i - window),
                                           min(length + i, n_max * psz))}
                    assert k_lo == max(0, length - window) == min(seen)
                    assert sorted(tiles) == list(range(k_lo // 16,
                                                       -(-n_kv // 16)))
                    assert len(keys) == len(set(keys)) and seen <= set(keys)
                    assert all(len(r) == 1 for r in pages.values())


def test_paged_plan_reads_no_length():
    """The launch geometry depends only on the shapes: the plan takes no
    length, so one captured launch serves every tick."""
    import inspect
    assert "length" not in inspect.signature(k_decode.plan).parameters
    for nq in (1, 5):
        p = k_decode.plan(8, 8, nq, 64, 16, 16, torch.bfloat16)
        assert (p.kernel, p.nw, p.split) == ("mma", 4, 4)


@pytest.mark.parametrize("d,quant,nq,nw,split,want", [
    # per warp two stages of a 16-key K and V tile (odd chunk stride; int8
    # adds 32 scales), then the inbox: rows, m and l per warp; weights, 1/L
    (64, False, 5, 4, 4, 4 * 2 * (2 * 16 * 9 * 16)
     + 4 * (16 * 2 * 66 + 17 * 2)),
    (64, True, 1, 4, 4, 4 * 2 * (2 * 16 * 5 * 16 + 128)
     + 4 * (16 * 1 * 66 + 17 * 1)),
    (128, False, 8, 4, 4, 4 * 2 * (2 * 16 * 17 * 16)
     + 4 * (16 * 2 * 130 + 17 * 2)),
    (32, True, 8, 2, 4, 2 * 2 * (2 * 16 * 3 * 16 + 128)
     + 4 * (8 * 2 * 34 + 9 * 2)),
    (32, False, 1, 1, 1, 2 * (2 * 16 * 5 * 16) + 4 * (1 * 1 * 34 + 2 * 1)),
])
def test_paged_smem_layout(d, quant, nq, nw, split, want):
    """Shared memory term by term as csrc/paged_decode.cu lays it out
    (smem_bytes), which refuses a launch that differs."""
    assert k_decode._smem_bytes(d, quant, nq, nw, split) == want


def test_paged_plan_mirrors_the_kernel_source():
    """The plan's constants are the ones csrc/paged_decode.cu compiles."""
    src = (Path(k_decode.__file__).parent / "csrc" /
           "paged_decode.cu").read_text()
    assert re.search(rf"constexpr int KT = {k_decode.KT};", src)
    assert re.search(rf"constexpr int NW_MAX = {k_decode.NW_MAX};", src)
    assert re.search(rf"constexpr int KV_STAGES = {k_decode.KV_STAGES};", src)
    assert re.search(rf"constexpr int MAX_NQ = {k_decode.MAX_NQ};", src)
    assert re.search(rf"constexpr int NW = {k_decode._SIMT_WARPS};", src)
    assert re.search(r"return \(quant \? d / 16 : d / 8\) \+ 1;", src)
    assert "asm" not in src             # the tensor-core kit of common.cuh
    assert "mma_bf16(" in src and "ldsm_x4_trans(" in src
    assert "cp_async_16(" in src and "map_shared_rank(" in src


def test_paged_plan_float32_stays_on_cuda_cores():
    for nq in (1, 5, 8):
        for quant in (False, True):
            p = k_decode.plan(8, 8, nq, 64, 16, 16, torch.float32, quant)
            assert (p.kernel, p.nw, p.split, p.smem) == ("simt", 4, 1, 0)


# (B, H, nq, D, psz, dtype): shapes no paged kernel takes
PAGED_REFUSED = [(8, 8, 1, 96, 16, torch.bfloat16),
                 (8, 8, 9, 64, 16, torch.bfloat16),
                 (8, 8, 2, 64, 16, torch.float16),
                 (1, 70000, 1, 32, 1, torch.bfloat16)]


@pytest.mark.parametrize("b,h,nq,d,psz,dt", PAGED_REFUSED)
def test_paged_plan_refuses_what_the_kernel_cannot_take(b, h, nq, d, psz, dt):
    with pytest.raises(ValueError):
        k_decode.plan(b, h, nq, d, psz, 16, dt)


class _Reached(Exception):
    """Raised in place of building a kernel: the wrapper got that far."""


@pytest.fixture
def paged_wrapper_without_card(monkeypatch):
    """The paged wrappers with the device check and the kernel build taken
    out (there is no card here): a call runs every other check and the
    plan, and ends at the kernel's C entry with ``_Reached``."""
    def check(t, name, ndim, dtypes):
        if t.dim() != ndim or t.dtype not in dtypes:
            raise ValueError(f"{name}: {t.dim()} dims, {t.dtype}")

    def reached(stem, symbol, argtypes):
        raise _Reached(symbol, len(argtypes))

    monkeypatch.setattr(k_decode.build, "check_cuda_tensor", check)
    monkeypatch.setattr(k_decode.build, "kernel_function", reached)


def _paged_call(b, h, nq, d, psz, dt, quant=False):
    n_max = 2
    q = torch.zeros(b, h, nq, d, dtype=dt)
    pool_dt = torch.int8 if quant else dt
    pools = [torch.zeros(b * n_max, h, psz, d, dtype=pool_dt)
             for _ in range(2)]
    sc = dict(k_scale=torch.zeros(b * n_max, psz),
              v_scale=torch.zeros(b * n_max, psz)) if quant else {}
    args = (torch.zeros(b, n_max, dtype=torch.int32),
            torch.ones(b, dtype=torch.int32))
    if nq == 1:
        return k_decode.paged_decode_attention(q[:, :, 0], *pools, *args, **sc)
    return k_decode.paged_verify_attention(q, *pools, *args, **sc)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16-pools", "int8-pools"])
@pytest.mark.parametrize("b,h,nq,d,psz,dt", PAGED_REFUSED)
def test_paged_wrappers_refuse_what_the_plan_refuses(
        paged_wrapper_without_card, b, h, nq, d, psz, dt, quant):
    with pytest.raises(ValueError):
        _paged_call(b, h, nq, d, psz, dt, quant)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16-pools", "int8-pools"])
@pytest.mark.parametrize("nq", [1, 2, 8])
def test_paged_wrappers_pass_what_the_plan_takes(paged_wrapper_without_card,
                                                 nq, quant):
    """Shapes the plan takes reach the C entry, whose argument list is the
    source's own (the plan's nw, split and smem before the stream)."""
    with pytest.raises(_Reached) as hit:
        _paged_call(3, 2, nq, 32, 8, torch.bfloat16, quant)
    symbol, n_args = hit.value.args
    src = (Path(k_decode.__file__).parent / "csrc" /
           "paged_decode.cu").read_text()
    sig = re.search(rf'extern "C" int {symbol}\((.+?)\)', src, re.S).group(1)
    assert n_args == sig.count(",") + 1
    assert re.search(r"int nw, int split, int smem,\s+void\* stream$", sig)


@pytest.mark.parametrize("which", ["q", "k_pages"])
def test_paged_wrapper_refuses_misaligned_bf16_operands(
        paged_wrapper_without_card, which):
    """The tensor-core kernel reads q and the pools in 16-byte pieces: a
    view that starts off a 16-byte boundary is refused, never launched."""
    b, h, nq, d, psz, n_max = 2, 2, 2, 32, 8, 2
    shapes = {"q": (b, h, nq, d), "k_pages": (b * n_max, h, psz, d)}
    t = {k: torch.zeros(v, dtype=torch.bfloat16) for k, v in shapes.items()}
    n = t[which].numel()
    t[which] = torch.zeros(n + 1, dtype=torch.bfloat16)[1:].view(shapes[which])
    with pytest.raises(ValueError, match="16-byte"):
        k_decode.paged_verify_attention(
            t["q"], t["k_pages"], torch.zeros(shapes["k_pages"],
                                              dtype=torch.bfloat16),
            torch.zeros(b, n_max, dtype=torch.int32),
            torch.ones(b, dtype=torch.int32))


# ------------------------------------------------ contiguous decode plan
# (B, H, S, D, split, nw): the serve shape, tinyllama's longest lane, a
# lane of one tile, chip_smoke's ragged S = 300, one (row, head) pair
CONTIG_PLANS = [(8, 8, 256, 64, 4, 4), (8, 8, 1024, 64, 4, 4),
                (8, 8, 16, 64, 1, 1), (6, 4, 300, 32, 8, 3),
                (6, 4, 300, 128, 8, 3), (1, 1, 1024, 64, 8, 4)]


@pytest.mark.parametrize("quant", [False, True], ids=["bf16-lanes", "int8-lanes"])
@pytest.mark.parametrize("b,h,s,d,split,nw", CONTIG_PLANS)
def test_contiguous_plan_limits(b, h, s, d, split, nw, quant):
    """A contiguous lane set is a pool of one page of S rows per row: its
    plan is the paged plan at nq 1, psz S, n_max 1 (split 4 x 4 warps, 256
    blocks, at the serve shape and at S 1024, where 64 (row, head) pairs x
    4 ranks already reach the SMs), its shared memory the source's
    formula at nq 1, within 227 KB."""
    p = k_decode.contiguous_plan(b, h, s, d, torch.bfloat16, quant)
    assert p == k_decode.plan(b, h, 1, d, s, 1, torch.bfloat16, quant)
    assert (p.kernel, p.split, p.nw) == ("mma", split, nw)
    assert p.smem == k_decode._smem_bytes(d, quant, 1, nw, split) <= 232448


def test_contiguous_plan_reads_no_length():
    import inspect
    assert "length" not in inspect.signature(k_decode.contiguous_plan).parameters
    p32 = k_decode.contiguous_plan(8, 8, 256, 64, torch.float32, True)
    assert (p32.kernel, p32.nw, p32.split, p32.smem) == ("simt", 8, 1, 0)


def test_contiguous_plan_mirrors_the_kernel_source():
    """The float32 contiguous kernel's warps, and the C entry's check of a
    tensor-core plan at nq 1 with the paged formula, are the source's."""
    src = (Path(k_decode.__file__).parent / "csrc" /
           "paged_decode.cu").read_text()
    assert re.search(rf"constexpr int CONTIG_NW = "
                     rf"{k_decode._CONTIG_SIMT_WARPS};", src)
    body = re.search(r"int run_contig\(.+?\n}\n", src, re.S).group(0)
    assert "mma_plan_fits(D, QUANT, R, nw, split, smem)" in body
    assert "launch_mma_d<BK, true>(D, q, k, v, nullptr, nullptr, nullptr, " \
           "len, o, B, H, R, 1, S, 1," in " ".join(body.split())
    assert not (Path(k_decode.__file__).parent / "csrc" /
                "decode_attention.cu").exists()


@pytest.mark.parametrize("refuse", [
    dict(d=96), dict(dt=torch.float16), dict(lanes=torch.float32),
    dict(misaligned=True)])
@pytest.mark.parametrize("quant", [False, True], ids=["float-lanes", "int8-lanes"])
def test_contiguous_wrapper_refuses_what_no_kernel_takes(
        paged_wrapper_without_card, refuse, quant):
    d, dt = refuse.get("d", 32), refuse.get("dt", torch.bfloat16)
    q = torch.zeros(2, 3, d, dtype=dt)
    lane_dt = refuse.get("lanes", torch.int8 if quant else dt)
    k = torch.zeros(2, 3, 40, d, dtype=lane_dt)
    if refuse.get("misaligned"):
        k = torch.zeros(k.numel() + 1, dtype=lane_dt)[1:].view(k.shape)
    with pytest.raises(ValueError):
        k_decode.decode_attention(q, k, torch.zeros_like(k),
                                  torch.ones(2, dtype=torch.int32),
                                  kv_scale=1 / 16 if quant else None)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True], ids=["float-lanes", "int8-lanes"])
def test_contiguous_wrappers_reach_their_entry(paged_wrapper_without_card,
                                               quant, dt):
    """Shapes the plan takes reach the C entry of csrc/paged_decode.cu,
    whose argument list is the source's own (int8: dq after the scale)."""
    q = torch.zeros(2, 3, 32, dtype=dt)
    k = torch.zeros(2, 3, 40, 32, dtype=torch.int8 if quant else dt)
    with pytest.raises(_Reached) as hit:
        k_decode.decode_attention(q, k, k.clone(), torch.ones(2, dtype=torch.int32),
                                  kv_scale=1 / 16 if quant else None)
    symbol, n_args = hit.value.args
    assert symbol == "repro_decode_attention" + ("_i8" if quant else "")
    src = (Path(k_decode.__file__).parent / "csrc" /
           "paged_decode.cu").read_text()
    sig = re.search(rf'extern "C" int {symbol}\((.+?)\)', src, re.S).group(1)
    assert n_args == sig.count(",") + 1
    assert re.search(r"float scale, (float dq, )?int dtype, int nw, int split,"
                     r" int smem,\s+void\* stream$", " ".join(sig.split()))


# The bf16 kernel's rounding (csrc/paged_decode.cu), emulated in float64 at
# chip_smoke.py's paged shapes: B 8, H 8, D 64, pages of 16, n_max 16, its
# ragged lengths (verify Q 5), the plan's split 4 x 4 warps
_PAGED_LENGTHS = {1: [1, 15, 16, 17, 100, 255, 256, 1],
                  5: [1, 12, 16, 17, 100, 250, 254, 1]}


def _emulated_paged(q, kp, vp, bt, length, ks, vs, nw, split):
    """The tensor-core kernel's arithmetic in float64: 16-key tiles dealt
    over split x nw warps, scores of bf16 q against the pool rows (int8
    values exact), each column times its k_scale, the online softmax in the
    log2 domain per warp, P (int8: P * v_scale) rounded to bf16 for P V while
    l sums the unrounded p, and the warps merged in (rank, warp) order."""
    NEG = -1e30
    B, H, nq, D = q.shape
    psz, n_max = kp.shape[2], bt.shape[1]
    scale_log2 = D ** -0.5 / np.log(2.0)
    n_kv = (length + nq - 1).clamp(max=n_max * psz)
    see = (length[:, None] + torch.arange(nq)).clamp(max=n_max * psz)
    parts = []
    for rank in range(split):
        for warp in range(nw):
            m = torch.full((B, H, nq), NEG, dtype=torch.float64)
            l = torch.zeros(B, H, nq, dtype=torch.float64)
            o = torch.zeros(B, H, nq, D, dtype=torch.float64)
            t = rank + split * warp
            while 16 * t < n_max * psz:
                kpos = 16 * t + torch.arange(16)
                inside = kpos[None, :] < n_kv[:, None]                 # (B, 16)
                page = bt[:, (kpos // psz).clamp(max=n_max - 1)].long()
                row = kpos % psz
                k = kp[page, :, row].permute(0, 2, 1, 3) * inside[:, None, :, None]
                v = vp[page, :, row].permute(0, 2, 1, 3) * inside[:, None, :, None]
                s = q @ k.transpose(-1, -2)                            # (B, H, nq, 16)
                if ks is not None:
                    s = s * ks[page, row][:, None, None, :]
                valid = (kpos[None, None, :] < see[:, :, None])[:, None]
                s = torch.where(valid, s * scale_log2, torch.full_like(s, NEG))
                mx = torch.maximum(m, s.amax(-1))
                corr = torch.exp2(m - mx)
                p = torch.where(s <= NEG, torch.zeros_like(s),
                                torch.exp2(s - mx[..., None]))
                l = l * corr + p.sum(-1)
                if vs is not None:
                    p = p * vs[page, row][:, None, None, :]
                p = p.to(torch.bfloat16).double()
                o = o * corr[..., None] + p @ v
                m = mx
                t += split * nw
            parts.append((m, l, o))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    w = [torch.where(m <= NEG, torch.zeros_like(m), torch.exp2(m - M))
         for m, _, _ in parts]
    L = sum(wi * l for wi, (_, l, _) in zip(w, parts))
    O = sum(wi[..., None] * o for wi, (_, _, o) in zip(w, parts))
    inv = torch.where(L > 0, 1.0 / L.clamp_min(1e-300), torch.zeros_like(L))
    return O * inv[..., None]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("nq", [1, 5], ids=["decode", "verify"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16-pools", "int8-pools"])
def test_paged_bf16_rounding_stays_within_tolerance(seed, nq, quant):
    """With P (int8 pools: P * v_scale) rounded to bf16 for P V, int8 rows
    taken exactly and k_scale applied per score column, the kernel's result
    stays within bf16's 2e-2 of the plain version (kernels/ref.py, which
    dequantizes in float32 as the Pallas i8 kernels do), at under half the
    tolerance.  At these seeds P's rounding alone moves the output by at
    most 0.13 of the tolerance with bf16 pools and 0.43 with int8 pools
    (outputs that cancel to near 0 feel it most), and the emulated bf16
    output differs from the plain version's by at most 0.25 and 0.43 of
    it."""
    g = torch.Generator().manual_seed(seed)
    B, H, D, psz, n_max = 8, 8, 64, 16, 16
    n_pages = B * n_max + 1
    bt = (torch.randperm(n_pages - 1, generator=g)[:B * n_max] + 1) \
        .reshape(B, n_max).to(torch.int32)
    bt[-1] = 0                                   # idle lane: scratch page
    length = torch.tensor(_PAGED_LENGTHS[nq], dtype=torch.int32)
    q = torch.randn(B, H, nq, D, generator=g).to(torch.bfloat16)
    if quant:
        kp, vp = (torch.randint(-127, 128, (n_pages, H, psz, D), generator=g,
                                dtype=torch.int8) for _ in range(2))
        ks, vs = (0.05 * torch.rand(n_pages, psz, generator=g)
                  for _ in range(2))
        ks[int(bt[4, 0]), psz // 2:] = 0.0       # a recycled page's reset rows
        sc = dict(k_scale=ks, v_scale=vs)
        exact_pools = (kp, vp)
    else:
        kp, vp = (torch.randn(n_pages, H, psz, D, generator=g)
                  .to(torch.bfloat16) for _ in range(2))
        ks = vs = None
        sc = {}
        exact_pools = (kp.float(), vp.float())
    p = k_decode.plan(B, H, nq, D, psz, n_max, torch.bfloat16, quant)
    got = _emulated_paged(q.double(), kp.double(), vp.double(), bt, length,
                          None if ks is None else ks.double(),
                          None if vs is None else vs.double(), p.nw, p.split)

    def share(a, b):                              # of bf16's 2e-2 tolerance
        return ((a.double() - b.double()).abs()
                / (2e-2 + 2e-2 * b.double().abs())).max().item()

    exact = ref.ref_paged_verify_attention(q.float(), *exact_pools, bt,
                                           length, **sc)
    want = ref.ref_paged_verify_attention(q, kp, vp, bt, length, **sc)
    assert share(got, exact) < 0.5, "P's bf16 rounding"
    assert share(got.to(torch.bfloat16), want) < 0.5, "the bf16 output"


@pytest.mark.parametrize("S", [256, 1024])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16-lanes", "int8-lanes"])
def test_contiguous_bf16_rounding_stays_within_tolerance(S, quant):
    """The tensor-core kernel over contiguous lanes is the paged one over
    a pool of one page per row (page b of row b, psz S): emulated with its
    plan's dealing at the serve shape and at S 1024, int8 lanes exact with
    dq = 1/16 on the score columns and folded into P, it stays within
    bf16's 2e-2 of the plain version at under half the tolerance."""
    g = torch.Generator().manual_seed(S)
    B, H, D = 8, 8, 64
    length = torch.tensor([S, 1, 13, S - 1, 0, 64, S // 2 + 7, 1],
                          dtype=torch.int32)
    q = torch.randn(B, H, 1, D, generator=g).to(torch.bfloat16)
    if quant:
        k, v = (torch.randint(-127, 128, (B, H, S, D), generator=g,
                              dtype=torch.int8) for _ in range(2))
        dq = torch.full((B, S), 1 / 16, dtype=torch.float64)
        exact = (k.float() / 16, v.float() / 16)
        want = ref.ref_decode_attention_i8(q[:, :, 0], k, v, length, 1 / 16)
    else:
        k, v = (torch.randn(B, H, S, D, generator=g).to(torch.bfloat16)
                for _ in range(2))
        dq = None
        exact = (k.float(), v.float())
        want = ref.ref_decode_attention(q[:, :, 0], k, v, length)
    p = k_decode.contiguous_plan(B, H, S, D, torch.bfloat16, quant)
    bt = torch.arange(B, dtype=torch.int32)[:, None]
    got = _emulated_paged(q.double(), k.double(), v.double(), bt, length, dq,
                          dq, p.nw, p.split)[:, :, 0]

    def share(a, b):                              # of bf16's 2e-2 tolerance
        return ((a.double() - b.double()).abs()
                / (2e-2 + 2e-2 * b.double().abs())).max().item()

    exact = ref.ref_decode_attention(q[:, :, 0].float(), *exact, length)
    assert share(got, exact) < 0.5, "P's bf16 rounding"
    assert share(got.to(torch.bfloat16), want) < 0.5, "the bf16 output"


def test_ops_on_cpu_take_the_plain_path_and_count_nothing():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(4, 64).astype(np.float32))
    ops.reset_launch_counts()
    ops.rmsnorm(x, torch.zeros(64))
    ops.matmul(x, x.t().contiguous())
    ops.flash_attention(x[None], x[None], x[None])
    q, kp, vp, bt, length = _paged_case(rng, 2, 2, 32, 4, 2, [3, 1])
    ops.paged_decode_attention(*(torch.from_numpy(a.astype(np.float32))
                                 for a in (q, kp, vp)),
                               torch.from_numpy(bt), torch.from_numpy(length))
    ops.paged_verify_attention(*(torch.from_numpy(a.astype(np.float32))
                                 for a in (q[:, :, None], kp, vp)),
                               torch.from_numpy(bt), torch.from_numpy(length))
    xs, dts, bc = torch.zeros(1, 3, 2, 4), torch.zeros(1, 3, 2), \
        torch.zeros(1, 3, 8)
    ops.ssd_scan(xs, dts, bc, bc, -torch.ones(2))
    ops.ssd_scan_i8(xs, dts, bc, bc, -torch.ones(2),
                    torch.zeros(1, 2, 4, 8, dtype=torch.int8), torch.zeros(1, 2))
    ops.decode_attention(x[None, :2, :32], x.reshape(1, 2, 4, 32),
                         x.reshape(1, 2, 4, 32), torch.ones(1, dtype=torch.int32))
    lanes = torch.ones(1, 2, 4, 32, dtype=torch.int8)
    ops.decode_attention_i8(x[None, :2, :32], lanes, lanes,
                            torch.ones(1, dtype=torch.int32), 1 / 16)
    ops.decode_attention(x[None, :2, :32], lanes, lanes,
                         torch.ones(1, dtype=torch.int32), kv_scale=1 / 16)
    ops.rmsnorm_residual(x, x, torch.zeros(64))
    ops.rmsnorm_gated(x, x, torch.zeros(64), out_dtype=torch.bfloat16)
    ops.expert_matmul(x.reshape(2, 2, 64), x.reshape(2, 64, 2),
                      torch.tensor([1, 2], dtype=torch.int32))
    assert ops.launch_counts() == {"rmsnorm": 0, "rmsnorm_residual": 0,
                                   "rmsnorm_gated": 0, "matmul": 0,
                                   "expert_matmul": 0,
                                   "flash_attention": 0,
                                   "paged_decode_attention": 0,
                                   "paged_decode_attention_i8": 0,
                                   "paged_verify_attention": 0,
                                   "paged_verify_attention_i8": 0,
                                   "ssd_scan": 0, "ssd_scan_i8": 0,
                                   "decode_attention": 0,
                                   "decode_attention_i8": 0}


@pytest.mark.parametrize("launch", [
    lambda x: k_rmsnorm.rmsnorm(x, x[0]),
    lambda x: k_matmul.matmul(x, x),
    lambda x: k_flash.flash_attention(x[None], x[None], x[None]),
    lambda x: k_decode.paged_decode_attention(
        x[None], x[None, None], x[None, None],
        torch.zeros((1, 1), dtype=torch.int32),
        torch.ones(1, dtype=torch.int32)),
    lambda x: k_decode.paged_verify_attention(
        x[None, None, :2], x[None, None], x[None, None],
        torch.zeros((1, 1), dtype=torch.int32),
        torch.ones(1, dtype=torch.int32)),
    lambda x: k_decode.paged_decode_attention(
        x[None], x[None, None].to(torch.int8), x[None, None].to(torch.int8),
        torch.zeros((1, 1), dtype=torch.int32),
        torch.ones(1, dtype=torch.int32), k_scale=x[:1], v_scale=x[:1]),
    lambda x: k_ssd.ssd_scan(x[None, None, :, :16], x[None, :1], x[None, :1],
                             x[None, :1], x[0]),
    lambda x: k_decode.decode_attention(x[None, :1], x[None, None],
                                        x[None, None],
                                        torch.ones(1, dtype=torch.int32)),
    lambda x: k_decode.decode_attention(
        x[None, :1], x[None, None].to(torch.int8), x[None, None].to(torch.int8),
        torch.ones(1, dtype=torch.int32), kv_scale=1 / 16),
    lambda x: k_rmsnorm.rmsnorm_residual(x, x, x[0]),
    lambda x: k_rmsnorm.rmsnorm_gated(x, x, x[0]),
])
def test_kernel_launchers_refuse_cpu_tensors(launch):
    """A launcher takes CUDA tensors only; it never computes on the CPU."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        launch(torch.zeros(32, 32))
