"""Launcher of the Hopper matmul kernel (``csrc/matmul.cu``), and of its
instantiation over an expert axis.

``matmul`` replaces ``src/repro/kernels/matmul.py::matmul``.  See the source
for what bounds it and how it is built; ``kernels.ops.matmul`` is the entry
point.  ``expert_matmul`` runs the same kernel over the experts of an MoE
layer (grid z), each expert reading only its bucket's filled rows (the
product JAX computes as an XLA einsum, ``src/repro/core/moe.py:79``; no
Pallas kernel); ``kernels.ops.expert_matmul`` is its entry point.

``plan`` chooses every launch from (M, N, K, dtype, trans_b) alone, in
plain Python, so the CPU tests can hold it to its limits; the C entry point
checks the plan against the shape and refuses one that does not fit.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
_EXPERT_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p]

SMS = 132                    # H100 SXM
SMEM_MAX = 232448            # dynamic shared memory a block may use (227 KB)
SMEM_SM = 233472             # shared memory of one SM (228 KB), 1 KB kept per block
STAGE = 4096                 # bf16 weight elements per ring piece (8 KB)
STAGES = 6                   # ring depth of a (K, N) weight (csrc/matmul.cu)
MAX_BLOCKS_SM = 4            # __launch_bounds__(128, 4)
MAX_TILE_BYTES = 32 * 1024   # weight bytes one block streams for one tile
BIG_WEIGHT = 2 * 2**20       # weights this large want a block on every SM
SMALL_TILE = 16 * 1024       # below that, one block per 16 KB of weight
SPLITS = (1, 2, 4, 8)        # blocks of a cluster sharing one tile's K
BM_MAX = 64                  # activation rows per block; more tile grid y
BNS = (64, 32, 16)           # weight columns per block, widest first
SIMT_BN = 64                 # float32 CUDA-core kernel: 32x64 or 64x64 tiles
SIMT_FEW, SIMT_LONG_K = 4, 2048   # float32: fewer tiles over a longer K split K


@dataclass(frozen=True)
class Plan:
    """One launch: ``kernel`` "mma" (bfloat16 tensor cores) or "simt"
    (float32 CUDA cores); ``bm`` x ``bn`` output tiles, ``n_tiles`` x
    ``m_tiles`` of them; K split over the ``split`` blocks of a cluster,
    each walking ``kt`` pieces of ``bk`` rows; ``grid_n`` blocks along N
    per split rank (fewer than ``n_tiles`` when split-1 blocks walk several
    tiles); ``smem`` bytes of dynamic shared memory; ``vec``: 16-byte
    cp.async chunks (K % 8 == 0, and N % 8 == 0 for a (K, N) weight)."""
    kernel: str
    bm: int
    bn: int
    bk: int
    split: int
    kt: int
    m_tiles: int
    n_tiles: int
    grid_n: int
    smem: int
    vec: bool

    @property
    def blocks(self) -> int:
        return self.grid_n * self.split * self.m_tiles

    @property
    def tile_bytes(self) -> int:
        """Weight bytes one block streams in series for one output tile."""
        return self.bn * self.kt * self.bk * (2 if self.kernel == "mma" else 4)


def _smem_bytes(trans_b: bool, bn: int, bm: int, kt: int, split: int,
                tiles: int) -> int:
    """csrc/matmul.cu::smem_bytes for a block that streams up to ``tiles``
    tiles of kt pieces of 8 KB: the ring (an (N, K) weight: 4 whole tiles
    of up to 16 KB or 2 larger; a (K, N) weight: up to STAGES pieces), the
    float32 partial tiles of the K warps (when BN < 64 or split > 1), the
    split inboxes, then the bm-row activation slice at an odd stride of
    16-byte chunks."""
    if trans_b:
        ring = min(tiles, 4 if kt <= 2 else 2) * kt
    else:
        ring = min(STAGES, kt * tiles)
    wk = 64 // bn                         # warps splitting K
    red = wk * bm * bn * 4 if wk > 1 or split > 1 else 0
    inbox = split * _cdiv(bm * bn, split) * 4 if split > 1 else 0
    return (ring * STAGE * 2 + red + inbox
            + bm * ((kt * (STAGE // bn) // 8) | 1) * 16)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _mma_candidates(M: int, N: int, K: int, bm: int, vec: bool,
                    trans_b: bool):
    m_tiles = _cdiv(M, bm)
    for bn in BNS:
        bk = STAGE // bn
        k_tiles = _cdiv(K, bk)
        n_tiles = _cdiv(N, bn)
        for split in SPLITS:
            if k_tiles % split or (k_tiles == 0 and split > 1):
                continue
            kt = k_tiles // split
            grids = [n_tiles]             # one tile per block
            if split == 1:                # persistent: as many as stay resident
                smem = _smem_bytes(trans_b, bn, bm, kt, 1, n_tiles)
                per_sm = min(MAX_BLOCKS_SM, SMEM_SM // (smem + 1024))
                grid_n = min(n_tiles, max(1, SMS * per_sm // m_tiles))
                if grid_n < n_tiles:
                    grids.append(grid_n)
            for grid_n in grids:
                smem = _smem_bytes(trans_b, bn, bm, kt, split,
                                   _cdiv(n_tiles, grid_n))
                if smem <= SMEM_MAX:
                    yield Plan("mma", bm, bn, bk, split, kt, m_tiles, n_tiles,
                               grid_n, smem, vec)


@functools.lru_cache(maxsize=None)
def plan(M: int, N: int, K: int, dtype: torch.dtype, trans_b: bool) -> Plan:
    """The launch for a (M, K) @ (K, N) product (B stored (N, K) with
    ``trans_b``).  bfloat16, in order:

    1. activation rows: one tile of up to 64 rows, or M / ceil(M / 64)
       rounded up to 8 (smaller only where the K range would not fit in
       shared memory);
    2. keep the plans whose blocks stream at most 32 KB of weights per
       tile (all of them, if none does) and are no wider than N needs;
    3. the blocks wanted: one per SM for a weight of 2 MB or more, else
       one per 16 KB of weight (a small weight is bound by latency);
    4. if a plan without a split gives that many, take the widest such
       block (the fewest activation re-reads and K-warp partials); its
       blocks walk several tiles each where one tile per block would give
       at least twice as many blocks as stay resident;
    5. else take the widest block that a split over a cluster brings to
       that count, with its smallest split.

    float32 takes the CUDA-core kernel: 32 x 64 tiles up to 32 rows, 64 x
    64 above; fewer than ``SIMT_FEW`` tiles over K >= ``SIMT_LONG_K`` (an
    MoE router) split K over a cluster of up to 8, each rank walking at
    least 16 steps of 16 rows.  Raises ValueError for a shape no plan can
    take."""
    if M <= 0 or N <= 0 or K < 0:
        raise ValueError(f"matmul: no plan for M={M} N={N} K={K}")
    if dtype == torch.float32:
        bm = 32 if M <= 32 else 64
        n_tiles, m_tiles, steps = _cdiv(N, SIMT_BN), _cdiv(M, bm), _cdiv(K, 16)
        split = 1
        if n_tiles * m_tiles < SIMT_FEW and K >= SIMT_LONG_K:
            while split < 8 and steps >= 2 * split * 16:
                split *= 2
        return Plan("simt", bm, SIMT_BN, 16, split, _cdiv(steps, split),
                    m_tiles, n_tiles, n_tiles, 0, False)
    if dtype != torch.bfloat16:
        raise ValueError(f"matmul: dtype {dtype} has no kernel")
    vec = K % 8 == 0 and (trans_b or N % 8 == 0)
    bm0 = min(BM_MAX, (_cdiv(M, _cdiv(M, BM_MAX)) + 7) // 8 * 8)
    for bm in [bm0] + [b for b in (32, 16, 8) if b < bm0]:
        cands = list(_mma_candidates(M, N, K, bm, vec, trans_b))
        if cands:
            break
    else:
        raise ValueError(f"matmul: K={K} is too long for the kernel's shared "
                         f"memory ({SMEM_MAX} bytes a block)")
    if cands[0].m_tiles > 65535:
        raise ValueError(f"matmul: M={M} needs more than 65535 row tiles")
    fit = [c for c in cands if c.bn <= max(16, _cdiv(N, 16) * 16)]
    cands = [c for c in fit if c.tile_bytes <= MAX_TILE_BYTES] or fit
    weight = N * K * 2
    want = SMS if weight >= BIG_WEIGHT else min(SMS, _cdiv(weight, SMALL_TILE))
    whole = [c for c in cands if c.split == 1 and c.blocks >= want]
    if whole:
        bn = max(c.bn for c in whole)
        walk = [c for c in whole if c.bn == bn and c.n_tiles >= 2 * c.grid_n]
        return walk[0] if walk else next(c for c in whole if c.bn == bn and
                                         c.grid_n == c.n_tiles)
    split = [c for c in cands if c.blocks >= want] or cands
    return min(split, key=lambda c: (-c.bn, c.split))


@functools.lru_cache(maxsize=None)
def expert_plan(M: int, N: int, K: int, dtype: torch.dtype) -> Plan:
    """The launch of one expert's (M, K) @ (K, N) product, run over the
    experts on grid z (``expert_matmul``).  The expert axis already gives
    the card its blocks (tens of experts, or a few of tens of MB each), so
    where ``plan`` cuts one product into many small tiles this takes the
    widest tile (bn 64, the only width the expert kernel instantiates: a
    weight row's 128 contiguous bytes) with one tile a block, then the
    smallest split whose block fits two to an SM, else the smallest split:
    the rule read off a sweep of every candidate on the card at deepseek's
    and mixtral's shapes (``scripts/torch_expert_plans.py``, PERF.md §6).
    float32: ``plan``'s.  Raises ValueError for a shape no plan can take."""
    p = plan(M, N, K, dtype, False)
    if p.kernel != "mma":
        return p
    cands = sorted((c for c in _mma_candidates(M, N, K, p.bm, p.vec, False)
                    if c.bn == 64 and c.grid_n == c.n_tiles),
                   key=lambda c: c.split)
    if not cands:
        raise ValueError(f"expert_matmul: no 64-column plan for M={M} N={N} "
                         f"K={K} within {SMEM_MAX} bytes of shared memory")
    two = [c for c in cands if 2 * (c.smem + 1024) <= SMEM_SM]
    return (two or cands)[0]


def launch_plan(a, b, trans_b: bool) -> Plan:
    """The plan for ``a @ b`` (``b`` read as (N, K) with ``trans_b``),
    after the checks that need no card: matching inner dims and, for the
    tensor-core kernel, 16-byte aligned operands.  Raises ValueError."""
    M, K = a.shape
    N, Kb = (b.shape[0], b.shape[1]) if trans_b else (b.shape[1], b.shape[0])
    if Kb != K:
        raise ValueError(f"matmul: inner dims differ, a {tuple(a.shape)} b "
                         f"{tuple(b.shape)} trans_b={trans_b}")
    p = plan(M, N, K, a.dtype, bool(trans_b))
    if p.kernel == "mma" and (a.data_ptr() % 16 or b.data_ptr() % 16):
        raise ValueError(f"matmul: the tensor-core kernel needs 16-byte "
                         f"aligned operands, got addresses {a.data_ptr():#x} "
                         f"and {b.data_ptr():#x}")
    return p


def matmul(a, b, *, trans_b: bool = False):
    """a: (M, K) @ b: (K, N), or b: (N, K) when ``trans_b`` -> (M, N) in
    a.dtype, on the card."""
    build.check_cuda_tensor(a, "matmul a", 2, _DTYPES)
    build.check_cuda_tensor(b, "matmul b", 2, (a.dtype,))
    if b.device != a.device:
        raise ValueError(f"matmul: a on {a.device}, b on {b.device}")
    M, N = a.shape[0], b.shape[0] if trans_b else b.shape[1]
    if M == 0 or N == 0:
        if a.shape[1] != (b.shape[1] if trans_b else b.shape[0]):
            raise ValueError(f"matmul: inner dims differ, a {tuple(a.shape)} "
                             f"b {tuple(b.shape)} trans_b={trans_b}")
        return torch.empty((M, N), dtype=a.dtype, device=a.device)
    p = launch_plan(a, b, trans_b)
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    fn = build.kernel_function("matmul", "repro_matmul", _ARGTYPES)
    with torch.cuda.device(a.device):
        rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, a.shape[1],
                int(trans_b), build.dtype_code(a.dtype), p.bm, p.bn, p.split,
                p.grid_n, p.smem, int(p.vec), build.stream_of(a))
    build.check_launch(rc, "matmul")
    return out


def expert_matmul(x, w, counts):
    """x: (n, C, K) @ w: (n, K, N), expert by expert -> (n, C, N) in x.dtype,
    on the card: expert e reads rows ``[0, counts[e])`` of its bucket x[e]
    and writes zeros past them; an expert whose count is 0 reads nothing
    of w[e].  ``counts``: (n,) int32 on x's device, read there (a CUDA
    graph replays with new counts).  The launch is ``expert_plan(C, N, K)``
    over n experts."""
    build.check_cuda_tensor(x, "expert_matmul x", 3, _DTYPES)
    build.check_cuda_tensor(w, "expert_matmul w", 3, (x.dtype,))
    build.check_cuda_tensor(counts, "expert_matmul counts", 1, (torch.int32,))
    n, C, K = x.shape
    if w.shape[0] != n or w.shape[1] != K or counts.shape[0] != n:
        raise ValueError(f"expert_matmul: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)} and counts {tuple(counts.shape)} "
                         f"do not match")
    if w.device != x.device or counts.device != x.device:
        raise ValueError(f"expert_matmul: x on {x.device}, w on {w.device}, "
                         f"counts on {counts.device}")
    if n > 65535:
        raise ValueError(f"expert_matmul: {n} experts, more than grid z takes")
    N = w.shape[2]
    out = torch.empty((n, C, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    p = expert_plan(C, N, K, x.dtype)
    if p.kernel == "mma" and (x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError(f"expert_matmul: the tensor-core kernel needs 16-byte "
                         f"aligned operands, got addresses {x.data_ptr():#x} "
                         f"and {w.data_ptr():#x}")
    fn = build.kernel_function("matmul", "repro_expert_matmul",
                               _EXPERT_ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), counts.data_ptr(),
                n, C, N, K, build.dtype_code(x.dtype), p.bm, p.bn, p.split,
                p.grid_n, p.smem, int(p.vec), build.stream_of(x))
    build.check_launch(rc, "expert_matmul")
    return out
