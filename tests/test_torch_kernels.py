"""The port's plain kernel versions (``repro_torch.kernels.ref`` through
``kernels.ops`` on CPU tensors) against the JAX package's Pallas kernels
run in interpret mode, and against its ``kernels/ref.py`` oracles, on the
same numpy inputs.  Tolerances are ``tests/test_kernels.py``'s: fp32 1e-4,
bf16 2e-2.  The Hopper kernels themselves run only on the card, where
``chip_smoke.py`` holds each against these plain versions."""
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
    assert ops.launch_counts() == {"rmsnorm": 0, "matmul": 0,
                                   "flash_attention": 0,
                                   "paged_decode_attention": 0,
                                   "paged_decode_attention_i8": 0,
                                   "paged_verify_attention": 0,
                                   "paged_verify_attention_i8": 0,
                                   "ssd_scan": 0, "ssd_scan_i8": 0,
                                   "decode_attention": 0}


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
])
def test_kernel_launchers_refuse_cpu_tensors(launch):
    """A launcher takes CUDA tensors only; it never computes on the CPU."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        launch(torch.zeros(32, 32))
