"""Launchers of the Hopper decode-attention kernel (``csrc/paged_decode.cu``):
paged decode and verify over float or int8 pools, and decode over a
contiguous cache of float or fixed-scale int8 lanes, which the same kernel
reads as a pool of one page per row.

Replace ``src/repro/kernels/decode_attention.py::paged_decode_attention``
(float and int8 pools), ``::paged_verify_attention`` (float and int8
pools) and ``::decode_attention`` (a contiguous cache).  See the source
for what bounds them and how they are built; ``kernels.ops`` is the entry
point.

``plan`` chooses every paged launch, and ``contiguous_plan`` every
contiguous one, from the shapes and the sliding window alone (``group`` q
heads per kv head among them: GQA), in plain Python, so the CPU tests can
hold them to their limits; never from ``length``, which the kernel reads
on the card, so a CUDA graph of a step replays one launch for every tick.
The C entries check the plan against the shape and refuse one that does
not fit.  The paged entries take a sliding window (JAX's rule: query i at
``length - 1 + i`` sees keys ``> length - 1 + i - window``); the
contiguous ones take none (a window's ring needs only a clamped length,
``core.attention.decode_attention``).
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (8, 32, 64, 128, 256)
MAX_NQ = 8           # verify queries per slot (csrc/paged_decode.cu)
MAX_ROWS = 16        # query rows of one kv head in the kernel's m16: group x nq
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# scale, dtype, the plan's nw, split and smem, stream
_PLAN_TAIL = [_F, _I, _I, _I, _I, _P]
_ARGTYPES = {        # the paged entries end their ints with the window
    "repro_paged_decode": [_P] * 6 + [_I] * 7 + _PLAN_TAIL,
    "repro_paged_decode_i8": [_P] * 8 + [_I] * 7 + _PLAN_TAIL,
    "repro_paged_verify": [_P] * 6 + [_I] * 8 + _PLAN_TAIL,
    "repro_paged_verify_i8": [_P] * 8 + [_I] * 8 + _PLAN_TAIL,
    "repro_decode_attention": [_P] * 5 + [_I] * 5 + _PLAN_TAIL,
    "repro_decode_attention_i8": [_P] * 5 + [_I] * 5 + [_F] + _PLAN_TAIL,  # + dq
}

SMS = 132                # H100 SXM
KT = 16                  # keys per tile (csrc/paged_decode.cu)
NW_MAX = 4               # warps per block
KV_STAGES = 2            # ring depth of each warp's K/V tiles
SPLITS = (1, 2, 4, 8)    # blocks of a cluster sharing one (kv head, slot)
_SIMT_WARPS = 4          # the float32 kernel's warps per block
_CONTIG_SIMT_WARPS = 8   # the float32 contiguous kernel's warps per block


@dataclass(frozen=True)
class Plan:
    """One paged launch: ``kernel`` "mma" (bfloat16 q, tensor cores) or
    "simt" (float32 q, CUDA cores); ``nw`` warps a block; the key tiles of
    a (head, slot) dealt out over the ``split`` blocks of a cluster;
    ``smem`` bytes of dynamic shared memory."""
    kernel: str
    nw: int
    split: int
    smem: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _smem_bytes(d: int, quant: bool, rows: int, nw: int, split: int) -> int:
    """csrc/paged_decode.cu::smem_bytes for ``rows`` = group x nq query
    rows: per warp a ring of KV_STAGES stages, each a 16-key K and V tile
    (rows of d / 8 chunks of 16 bytes in bf16, d / 16 in int8, plus one at
    an odd stride; int8 adds the 16 keys' k and v scales), at d 256 the
    block's 16 query rows in bf16 (d / 8 + 1 chunks each), then the inbox:
    per warp of the cluster the owner's rows of d floats with their m and
    l, then a weight per (row, warp) and 1 / L per row."""
    row_chunks = (d // 16 if quant else d // 8) + 1
    stage = 2 * KT * row_chunks * 16 + (2 * KT * 4 if quant else 0)
    q_stage = 16 * (d // 8 + 1) * 16 if d > 128 else 0
    rp, parts = _cdiv(rows, split), nw * split
    return nw * KV_STAGES * stage + q_stage + \
        4 * (parts * rp * (d + 2) + (parts + 1) * rp)


@functools.lru_cache(maxsize=None)
def plan(B: int, H: int, nq: int, D: int, psz: int, n_max: int,
         dtype: torch.dtype, quant: bool = False, group: int = 1,
         window: int = 0) -> Plan:
    """The launch for a paged decode (``nq`` 1) or verify call at these
    shapes: ``H`` q heads, ``group`` of them per kv head (GQA); ``dtype``
    is q's, ``quant`` says the pools are int8; ``window`` the sliding
    window (0: none).  bfloat16: one cluster of ``split`` blocks per (kv
    head, slot), whose m16 holds the group's ``group * nq`` query rows (at
    most 16), the split doubling while fewer blocks than SMs run and there
    are that many 16-key tiles in the keys a slot's queries can see:
    ``n_max * psz``, or with a window the tiles its ``window + nq - 1``
    keys can touch (flash's model, ``kernels.flash_attention.plan``);
    ``nw`` warps a block, as many as the rank's share of those tiles, at
    most 4.  float32: the CUDA-core kernel, 4 warps per (q head, slot), no
    split.  Raises ValueError for shapes no kernel takes, and for ``group
    * nq`` > 16 on both."""
    if D not in HEAD_DIMS:
        raise ValueError(f"paged attention: head_dim {D} not in {HEAD_DIMS}")
    if group < 1 or H % group:
        raise ValueError(f"paged attention: {H} q heads do not split into "
                         f"groups of {group} per kv head")
    if group * nq > MAX_ROWS:
        raise ValueError(f"paged attention: {group} q heads per kv head x "
                         f"{nq} queries = {group * nq} query rows per slot; "
                         f"the kernel's m16 holds at most {MAX_ROWS}")
    if not 1 <= nq <= MAX_NQ:
        raise ValueError(f"paged attention: {nq} queries per slot, not 1 to "
                         f"{MAX_NQ}")
    if min(B, H, psz, n_max) <= 0 or max(B, H) > 65535 or window < 0:
        raise ValueError(f"paged attention: no plan for B={B} H={H} "
                         f"psz={psz} n_max={n_max} window={window}")
    if dtype == torch.float32:
        return Plan("simt", _SIMT_WARPS, 1, 0)
    if dtype != torch.bfloat16:
        raise ValueError(f"paged attention: dtype {dtype} has no kernel")
    n_tiles = _cdiv(n_max * psz, KT)
    if window > 0:                      # the tiles window + nq - 1 keys touch
        n_tiles = min(n_tiles, (window + nq - 2) // KT + 2)
    pairs = B * (H // group)            # one cluster per (kv head, slot)
    split = 1
    for s in SPLITS[1:]:
        if s <= n_tiles and pairs * split < SMS:
            split = s
    nw = min(NW_MAX, _cdiv(n_tiles, split))
    return Plan("mma", nw, split,
                _smem_bytes(D, quant, group * nq, nw, split))


def _check(name, q, k_pages, v_pages, block_table, length, k_scale, v_scale):
    """The checks every variant makes (q's rank is the caller's);
    -> (B, H, group, D, psz, n_max), ``group`` q heads per pool head."""
    quant = k_scale is not None or v_scale is not None
    build.check_cuda_tensor(q, f"{name} q", q.dim(), _DTYPES)
    pool_dt = (torch.int8,) if quant else (q.dtype,)
    build.check_cuda_tensor(k_pages, f"{name} k_pages", 4, pool_dt)
    build.check_cuda_tensor(v_pages, f"{name} v_pages", 4, pool_dt)
    build.check_cuda_tensor(block_table, f"{name} block_table", 2,
                            (torch.int32,))
    build.check_cuda_tensor(length, f"{name} length", 1, (torch.int32,))
    B, H, D = q.shape[0], q.shape[1], q.shape[-1]
    n_pages, Hk, psz, Dk = k_pages.shape
    if Dk != D or Hk == 0 or H % Hk or v_pages.shape != k_pages.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)} pools "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}: "
                         f"pool heads must divide the q heads")
    if block_table.shape[0] != B or length.shape[0] != B:
        raise ValueError(f"{name}: block_table {tuple(block_table.shape)} / "
                         f"length {tuple(length.shape)} do not cover B={B}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {D} not in {HEAD_DIMS}")
    tensors = [q, k_pages, v_pages, block_table, length]
    if quant:
        for s, sname in ((k_scale, "k_scale"), (v_scale, "v_scale")):
            build.check_cuda_tensor(s, f"{name} {sname}", 2, (torch.float32,))
            if tuple(s.shape) != (n_pages, psz):
                raise ValueError(f"{name}: {sname} {tuple(s.shape)} != "
                                 f"(n_pages, psz) = {(n_pages, psz)}")
        tensors += [k_scale, v_scale]
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices {devs}")
    return B, H, H // Hk, D, psz, block_table.shape[1]


def _launch(symbol, q, k_pages, v_pages, block_table, length, k_scale,
            v_scale, scale, window, nq=None):
    B, H, group, D, psz, n_max = _check(symbol, q, k_pages, v_pages,
                                        block_table, length, k_scale, v_scale)
    scale = float(scale if scale is not None else D ** -0.5)
    window = int(window)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    p = plan(B, H, nq or 1, D, psz, n_max, q.dtype, k_scale is not None,
             group, window)
    if p.kernel == "mma" and any(t.data_ptr() % 16
                                 for t in (q, k_pages, v_pages)):
        raise ValueError(f"{symbol}: the tensor-core kernel needs 16-byte "
                         f"aligned q and pools")
    fn = build.kernel_function("paged_decode", symbol, _ARGTYPES[symbol])
    scales = [] if k_scale is None else [k_scale.data_ptr(),
                                         v_scale.data_ptr()]
    dims = [B, H, group] + ([] if nq is None else [nq]) + [D, psz, n_max,
                                                            window]
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), *scales,
                block_table.data_ptr(), length.data_ptr(), out.data_ptr(),
                *dims, scale, build.dtype_code(q.dtype), p.nw, p.split,
                p.smem, build.stream_of(q))
    build.check_launch(rc, symbol)
    return out


def paged_decode_attention(q, k_pages, v_pages, block_table, length, *,
                           scale=None, k_scale=None, v_scale=None, window=0):
    """q: (B, H, D); k_pages/v_pages: (n_pages, Hk, psz, D), Hk dividing H
    (q head h reads pool head h // (H // Hk)), in q's dtype, or int8 with
    ``k_scale``/``v_scale`` (n_pages, psz) float32; block_table:
    (B, n_max) int32; length: (B,) int32 valid-token counts (``pos + 1``,
    not the inclusive position); ``window`` > 0: only the last ``window``
    keys, ``kpos >= length - window`` -> (B, H, D) in q's dtype."""
    if q.dim() != 3:
        raise ValueError(f"paged_decode: q {tuple(q.shape)} is not (B, H, D)")
    symbol = "repro_paged_decode" if k_scale is None else \
        "repro_paged_decode_i8"
    return _launch(symbol, q, k_pages, v_pages, block_table, length,
                   k_scale, v_scale, scale, window)


def paged_verify_attention(q, k_pages, v_pages, block_table, length, *,
                           scale=None, k_scale=None, v_scale=None, window=0):
    """q: (B, H, Q, D) with Q <= 8 and (H // Hk) x Q <= 16 (``plan``
    refuses more, naming both), query i of slot b at position
    ``length[b] - 1 + i`` seeing keys ``kpos < length[b] + i`` (and with
    ``window`` > 0 ``kpos >= length[b] + i - window``); pools, scales,
    block_table and length as in ``paged_decode_attention`` -> (B, H, Q,
    D) in q's dtype."""
    if q.dim() != 4 or q.shape[2] < 1:
        raise ValueError(f"paged_verify: q {tuple(q.shape)} is not (B, H, Q, "
                         f"D) with Q >= 1")
    symbol = "repro_paged_verify" if k_scale is None else \
        "repro_paged_verify_i8"
    return _launch(symbol, q, k_pages, v_pages, block_table, length,
                   k_scale, v_scale, scale, window, nq=q.shape[2])


@functools.lru_cache(maxsize=None)
def contiguous_plan(B: int, H: int, S: int, D: int, dtype: torch.dtype,
                    quant: bool = False, group: int = 1) -> Plan:
    """The launch for a decode call of ``H`` q heads over contiguous lanes
    (B, H // group, S, D); ``dtype`` is q's, ``quant`` says the lanes are
    int8.  bfloat16: the paged plan of the same kernel at nq 1, psz S,
    n_max 1 (row b's lane is its one page).  float32: the CUDA-core
    contiguous kernel, 8 warps, no split.  Raises ValueError for shapes no
    kernel takes."""
    p = plan(B, H, 1, D, S, 1, dtype, quant, group)
    return Plan("simt", _CONTIG_SIMT_WARPS, 1, 0) if p.kernel == "simt" else p


def decode_attention(q, k, v, length, *, scale=None, kv_scale=None):
    """q: (B, H, D); k/v: (B, Hk, S, D), Hk dividing H (q head h reads lane
    head h // (H // Hk)), in q's dtype, or int8 lanes whose values times
    ``kv_scale`` (a float) are the keys and values; length:
    (B,) int32 valid-key counts (``pos + 1``; keys at or past it are never
    read) -> (B, H, D) in q's dtype."""
    quant = kv_scale is not None
    name = "decode_attention_i8" if quant else "decode_attention"
    build.check_cuda_tensor(q, f"{name} q", 3, _DTYPES)
    lane_dt = (torch.int8,) if quant else (q.dtype,)
    build.check_cuda_tensor(k, f"{name} k", 4, lane_dt)
    build.check_cuda_tensor(v, f"{name} v", 4, lane_dt)
    build.check_cuda_tensor(length, f"{name} length", 1, (torch.int32,))
    B, H, D = q.shape
    Hk, S = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Hk, S, D) or v.shape != k.shape or Hk == 0 \
            or H % Hk:
        raise ValueError(f"{name}: q {tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)}: k/v must be (B, Hk, S, D) with "
                         f"q's B and D and Hk dividing its heads")
    if length.shape[0] != B:
        raise ValueError(f"{name}: length {tuple(length.shape)} does not "
                         f"cover B={B}")
    if len({t.device for t in (q, k, v, length)}) != 1:
        raise ValueError(f"{name}: tensors on several devices")
    group = H // Hk
    p = contiguous_plan(B, H, S, D, q.dtype, quant, group)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: q, k and v must be 16-byte aligned (the "
                         f"kernels read rows with 16-byte loads)")
    scale = float(scale if scale is not None else D ** -0.5)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    symbol = "repro_" + name
    fn = build.kernel_function("paged_decode", symbol, _ARGTYPES[symbol])
    dq = [float(kv_scale)] if quant else []
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
                out.data_ptr(), B, H, group, S, D, scale, *dq,
                build.dtype_code(q.dtype), p.nw, p.split, p.smem,
                build.stream_of(q))
    build.check_launch(rc, name)
    return out
