"""Launcher of the Hopper flash-attention kernel
(``csrc/flash_attention.cu``).

Replaces ``src/repro/kernels/flash_attention.py::flash_attention``.  See the
source for what bounds it and how it is built; ``kernels.ops`` is the
entry point.

``plan`` chooses every launch from (H, Sq, Skv, D, dtype, window, group)
alone, in plain Python, so the CPU tests can hold it to its limits; never from
``q_offset``, which the kernel reads from device memory (one int32): the
prefill chunk's offset is per-tick data, and a CUDA graph of the chunk step
replays with whatever offset was last copied there.  The C entry point
checks the plan against the shape and refuses one that does not fit.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (8, 32, 64, 128, 256)
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
             + [ctypes.c_int] * 2 + [ctypes.c_float] + [ctypes.c_int] * 4
             + [ctypes.c_void_p])

SMS = 132                # H100 SXM
KV_TILE = 64             # keys per tile (csrc/flash_attention.cu)
KV_TILE_WIDE = 32        # keys per tile at head_dim > 128
KV_STAGES = 2            # ring depth of K/V tiles
WQ_MAX = 4               # warps per block, 16 query rows each
SPLITS = (1, 2, 4, 8)    # blocks of a cluster sharing one row tile's keys


@dataclass(frozen=True)
class Plan:
    """One launch: ``kernel`` "mma" (bfloat16 tensor cores) or "simt"
    (float32 CUDA cores); ``wq`` warps of 16 query rows a block (for the
    mma kernel ``heads_per_block`` q heads x ``row_warps`` each); the key
    tiles dealt out over the ``split`` blocks of a cluster; ``smem`` bytes
    of dynamic shared memory."""
    kernel: str
    wq: int
    split: int
    smem: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _rows_per(wq: int, split: int) -> int:
    return _cdiv(16 * wq, split)


def heads_per_block(group: int) -> int:
    """csrc/flash_attention.cu::heads_per_block: the q heads of one kv head
    a block of the mma kernel serves, the largest divisor of ``group`` up
    to WQ_MAX."""
    return max(d for d in range(1, WQ_MAX + 1) if group % d == 0)


def row_warps(Sq: int, rb: int) -> int:
    """csrc/flash_attention.cu::row_warps: warps of 16 query rows per q
    head in a block of ``rb`` heads, within WQ_MAX warps."""
    return min(_cdiv(Sq, 16), WQ_MAX // rb)


def kv_tile(d: int) -> int:
    """csrc/flash_attention.cu::kv_tile: keys per K/V tile, 32 at head_dim
    256 (its registers and shared memory), else 64."""
    return KV_TILE_WIDE if d > 128 else KV_TILE


def _smem_bytes(d: int, wq: int, split: int) -> int:
    """csrc/flash_attention.cu::smem_bytes: the K/V ring (``kv_tile(d)``
    rows of d / 8 + 1 chunks of 16 bytes), at head_dim 256 each warp's 16
    query rows in bf16 at the same stride, and with a split the inbox: per
    rank the owner's rows of d floats with their m and l, then a weight per
    (row, rank) and 1 / L per row."""
    ring = KV_STAGES * 2 * kv_tile(d) * (d // 8 + 1) * 16
    if d > 128:
        ring += wq * 16 * (d // 8 + 1) * 16
    if split == 1:
        return ring
    rp = _rows_per(wq, split)
    return ring + 4 * (split * rp * (d + 2) + (split + 1) * rp)


@functools.lru_cache(maxsize=None)
def plan(H: int, Sq: int, Skv: int, D: int, dtype: torch.dtype,
         window: int = 0, group: int = 1) -> Plan:
    """The launch for ``flash_attention`` at these shapes: ``H`` q heads,
    ``group`` of them per kv head.  bfloat16: one block per row tile and
    ``rb = heads_per_block(group)`` q heads of one kv head, ``rb`` x
    ``row_warps(Sq, rb)`` warps of 16 query rows (``min(4, ceil(Sq / 16))``
    at group 1), so each K/V tile serves ``rb`` heads; the key tiles are
    split over a cluster of up to 8 blocks,
    doubling while fewer blocks than SMs run and the rows can see that many
    tiles (all of them; with a window, as many as the window and the
    block's rows span); tiles of ``kv_tile(D)`` keys.  float32: the
    CUDA-core kernel, 16 rows of one q head a block, no split.  Raises
    ValueError for shapes no kernel takes."""
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} not in {HEAD_DIMS}")
    if H <= 0 or Sq <= 0 or Skv < 0:
        raise ValueError(f"flash_attention: no plan for H={H} Sq={Sq} "
                         f"Skv={Skv}")
    if group < 1 or H % group:
        raise ValueError(f"flash_attention: {H} q heads do not split into "
                         f"groups of {group} per kv head")
    kt = kv_tile(D)
    n_tiles = _cdiv(Skv, kt)
    if dtype == torch.float32:
        return Plan("simt", 4, 1, 0)
    if dtype != torch.bfloat16:
        raise ValueError(f"flash_attention: dtype {dtype} has no kernel")
    rb = heads_per_block(group)
    wr = row_warps(Sq, rb)
    wq = rb * wr
    row_tiles = _cdiv(Sq, 16 * wr)
    heads = H // rb                     # one block per rb q heads and row tile
    if heads * row_tiles > 65535:
        raise ValueError(f"flash_attention: {heads} head groups x "
                         f"{row_tiles} row tiles exceed the grid")
    span = n_tiles
    if window > 0:
        span = min(n_tiles, (window + 16 * wr - 2) // kt + 2)
    split = 1
    for s in SPLITS[1:]:
        if s <= span and heads * row_tiles * split < SMS:
            split = s
    return Plan("mma", wq, split, _smem_bytes(D, wq, split))


_OFFSETS: dict = {}      # (device, value) -> a constant int32 offset on the card


def offset_tensor(value: int, device) -> torch.Tensor:
    """A constant ``q_offset`` as the one int32 on the card the kernel
    reads, made once per (device, value) and never written again (never
    made under graph capture: a graphed step passes its own tensor)."""
    key = (torch.device(device), int(value))
    t = _OFFSETS.get(key)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("flash_attention: pass q_offset as a device "
                               "tensor inside a CUDA graph capture")
        t = _OFFSETS[key] = torch.full((1,), key[1], dtype=torch.int32,
                                       device=key[0])
    return t


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale=None, q_offset=None):
    """q: (H, Sq, D); k/v: (Hk, Skv, D), Hk dividing H, q head h reading kv
    head h // (H // Hk) -> (H, Sq, D).
    Query row i sits at position ``q_offset + i`` (default ``Skv - Sq``);
    ``q_offset`` is an int or a one-element int32 tensor on q's device, which
    the kernel reads there."""
    build.check_cuda_tensor(q, "flash_attention q", 3, _DTYPES)
    build.check_cuda_tensor(k, "flash_attention k", 3, (q.dtype,))
    build.check_cuda_tensor(v, "flash_attention v", 3, (q.dtype,))
    H, Sq, D = q.shape
    Hk, Skv = k.shape[0], k.shape[1]
    if k.shape != (Hk, Skv, D) or v.shape != k.shape or Hk == 0 or H % Hk:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}: k/v must be "
                         f"(Hk, Skv, D) with Hk dividing the q heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} not in {HEAD_DIMS}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    scale = float(scale if scale is not None else D ** -0.5)
    if q_offset is None:
        q_offset = Skv - Sq
    if isinstance(q_offset, torch.Tensor):
        if q_offset.device != q.device or q_offset.dtype != torch.int32 or \
                q_offset.numel() != 1:
            raise ValueError(f"flash_attention: q_offset must be one int32 on "
                             f"{q.device}, got {q_offset.dtype} "
                             f"{tuple(q_offset.shape)} on {q_offset.device}")
    else:
        q_offset = offset_tensor(q_offset, q.device)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    group = H // Hk
    p = plan(H, Sq, Skv, D, q.dtype, int(window), group)
    if p.kernel == "mma" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: the tensor-core kernel needs "
                         "16-byte aligned q, k and v")
    fn = build.kernel_function("flash_attention", "repro_flash_attention",
                               _ARGTYPES)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                H, group, Sq, Skv, D, q_offset.data_ptr(), int(causal),
                int(window), scale,
                build.dtype_code(q.dtype), p.wq, p.split, p.smem,
                build.stream_of(q))
    build.check_launch(rc, "flash_attention")
    return out
