// Paged attention for Hopper over the slot's pages, in four variants that
// share one kernel: decode (one query per slot) and speculative verify
// (nq <= 8 queries per slot), each over float pools (in q's dtype) or int8
// pools with one float32 scale per token row.  The same kernel serves
// decode over a contiguous cache (two more variants, float lanes and
// fixed-scale int8 lanes; see "Contiguous lanes" below).  Head dims 8, 32,
// 64, 128 and 256.
//
//   q (B, H, nq, D) (decode: nq = 1, q (B, H, D)); k/v pools (n_pages,
//   H / R, psz, D); int8 scales k_scale/v_scale (n_pages, psz) float32;
//   block_table (B, n_max) int32; length (B,) int32, the count of valid
//   tokens ahead of query 0 (the engine's inclusive pos + 1)
//   -> o (B, H, nq, D) in q's dtype.
// GQA: R query heads share one kv head, q head h reading kv head h / R (the
// JAX model path's grouping, repro.core.attention's (G, R) layout).
// Query i sits at position length - 1 + i and sees keys kpos < length + i
// (the drafts' own KV is already in the pool); with a sliding window
// (window > 0) only keys kpos > length - 1 + i - window (JAX's rule,
// repro.core.attention); pages past n_max are never read (keys are clamped
// to n_max * psz).  Online softmax in float32; a query with no valid key
// gives 0.
//
// Replaces: src/repro/kernels/decode_attention.py::paged_decode_attention
//   (_paged_decode_kernel, _paged_decode_kernel_i8; pallas_call at :237)
//   and ::paged_verify_attention (_paged_verify_kernel,
//   _paged_verify_kernel_i8; pallas_call at :389).
// Bound on this card: each (slot, head) reads its keys and values once and
//   does ~4 * nq operations per element read: bytes bound it (serve's 8
//   slots x 8 heads, ~0.4 us), and int8 pools halve the bytes, plus 4 bytes
//   per row for each scale.  What limits a kernel this small is latency:
//   the launch, the round trips for length, the block table and the pages,
//   and the steps that depend on each other.
//
// Design of the bfloat16 kernel (q in bf16, pools in bf16 or int8), and
// what each choice does about that:
//  - Enough blocks: a (kv head, slot) pair is one thread-block cluster of
//    `split` <= 8 blocks of `nw` <= 4 warps.  The keys are cut into 16-key
//    tiles; tile t_lo + j goes to rank j % split and, of that rank's tiles,
//    to warp (j / split) % nw (t_first, my_n below: the one dealing
//    formula), t_lo being 0, or with a window the tile that holds query 0's
//    first key, length - window: the tiles below it are never read.  Each
//    warp computes its own tiles from length on the card, so the launch
//    depends only on the shapes and the window
//    (kernels/decode_attention.py::plan sizes the split from the window's
//    span), never on length: a CUDA graph of a step captures one launch for
//    every tick.  A rank or warp left with no tile still meets the cluster
//    barrier and pushes empty rows (m = NEG, l = 0).
//  - Memory-level parallelism: each warp streams its tiles through its own
//    two-stage ring in shared memory by 16-byte cp.async (the next tile in
//    flight while this one is scored; every warp of every rank loads at
//    once).  A tile's 16 rows are read straight from the pool through the
//    block's own block-table row (the Pallas kernels' scalar prefetch),
//    row by row, so a tile takes any page size: one page of 16, part of a
//    longer page, or two pages of 8 (psz 8 fills one tile with two pages;
//    keys past what the deepest query sees are zero-filled and masked).  No
//    gathered copy of the cache is ever made: the paper's minimal off-chip
//    traffic.  Rows sit at an odd stride of 16-byte chunks, so the 8 rows
//    one ldmatrix phase reads fall in 8 distinct bank groups.
//  - Tensor cores, FA2-style: the m16 of mma.sync m16n8k16 holds the query
//    rows of the kv head's R q heads, row r nq + i for q head r and query i
//    (R nq <= 16; the rest are zero and see no key), each row with its own
//    bounds [lo, see) (lo only with a window: the WINDOW instantiations;
//    without one the kernel is the window-free code), so each K/V tile is
//    read from the pool once for all R heads.  S = Q K^T
//    takes K through ldmatrix; the online softmax runs on the accumulator
//    fragments in the log2 domain; P stays in registers as the A fragment
//    of P V, with V through ldmatrix.trans.  P is rounded to bf16 only for
//    that product, as the Pallas kernels cast p to v's dtype; the row sum l
//    adds the float32 p.
//  - int8 pools without a float dequant pass: int8 values in [-127, 127]
//    are exact in bf16, so K and V fragments are built from the int8 rows
//    with no rounding; k_scale multiplies each score column after Q K^T in
//    float32, and v_scale is folded into P before P V.  The one rounding
//    the Pallas i8 kernels do not make is that of P * v_scale to bf16 for
//    the product (tests/test_torch_kernels.py emulates it).
//  - head_dim 256 (gemma3): the output rows alone are 128 float registers a
//    thread, so the Q fragments (64 more) are not kept in registers there:
//    the block stages its 16 query rows once in shared memory (odd chunk
//    stride) and each warp reads them by ldmatrix at every k step.  At D <=
//    128 Q stays in registers, the instantiations' code unchanged.
//  - head_dim 8 (tinyllama-42m-64h): Q K^T is one mma.sync m16n8k8 step
//    (its A fragment the first half of the k16 one; K through ldmatrix x2,
//    or int8 pairs packed exactly), and P V's output a single n8 tile (V
//    through ldmatrix x2.trans).  An int8 row is 8 bytes: one 8-byte
//    cp.async into a 16-byte stored row, whose upper half is never read.
//  - The warps' (m, l, O) rows meet in the owner rank's inbox through
//    distributed shared memory in the same launch (local shared memory when
//    split is 1): each warp pushes its rows to the rank that owns them, and
//    after one cluster barrier the owner weighs them in (rank, warp) order.
//    One kernel per call, no workspace, no atomics: bitwise repeatable.  A
//    warp with no valid key for a row left m = NEG and l = 0 there; it gets
//    weight 0 without forming exp(NEG - NEG), and a row no warp saw gives 0.
//
// float32 q keeps a CUDA-core kernel (its 1e-4 tolerance excludes bf16 and
// TF32 products), over float32 or int8 pools: one block of four warps per
// (q head h, slot), reading kv head h / R, the warps taking pages in turn,
// each K/V row loaded once into registers (int8 rows dequantised through
// the row's scale) and scored against every query that may see it; the
// warps' states merge through shared memory.  A lane holds the columns
// lane + 32 c (at D 8 lanes 0-7 one each, the rest zeros).
//
// Contiguous lanes (repro_decode_attention, repro_decode_attention_i8):
//   q (B, H, D); k/v (B, H / R, S, D) in q's dtype, or int8 whose values
//   times one float `dq` are the keys and values (the engine's fixed-scale
//   lanes, dq = 1/16); length (B,) int32 -> o (B, H, D) in q's dtype; key j of row
//   b is valid when j < length[b] (clamped to S), and no key at or past it
//   is read.  A sliding window's ring (S = the window W) needs no window
//   here: after the write of position p the ring holds exactly positions
//   (p - W, p], and before it wraps slots [0, p] hold positions 0..p, so
//   the caller passes length min(p + 1, W) (repro_torch/core/attention.py).
// Replaces: src/repro/kernels/decode_attention.py::decode_attention
//   (_decode_kernel; pallas_call at :72).
// Bound on this card: each (row, head) reads its valid keys and values
//   once (one byte an element in int8), ~4 operations per element: bytes.
//   At the serve shape (B 8, H 8, S 256, D 64, bf16) 4.2 MB, 1.26 us; what
//   limits it is latency, as above.
// Design: a lane set (B, H, S, D) is a pool of B pages of psz = S rows in
//   which row b's one page is page b (n_max = 1), so the bfloat16 kernel
//   above serves it with a contiguous addressing policy (template CONTIG):
//   key j of row b is row (b H / R + h) S + j for kv head h, computed, with
//   no block table read (one dependent round trip fewer); the kv head's R
//   q heads are the m16's rows, as in the paged policy.  Its plan is the paged plan at
//   nq 1, psz S, n_max 1 (kernels/decode_attention.py::contiguous_plan),
//   so the tiles of a long lane are dealt over the cluster as a long page's
//   are.  int8 lanes enter the tensor cores exactly; dq, a power of two,
//   scales each score column and is folded into P, both exact, so the
//   result is that of the bf16 kernel on the dequantised lanes, up to the
//   order of accumulation, with no dequantised copy of the cache ever made.
//   float32 q keeps the CUDA-core kernel of the first contiguous port
//   (contig_simt_kernel): eight warps per (q head, row) taking 32-key tiles
//   of [0, length) of kv head h / R, one key a lane, int8 lanes dequantised
//   on load.
#include <cooperative_groups.h>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;
using repro::cluster_arrive;
using repro::cluster_wait;
using repro::cp_async_16;
using repro::cp_async_4;
using repro::cp_async_8;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::ldsm_x2;
using repro::ldsm_x2_trans;
using repro::ldsm_x4;
using repro::ldsm_x4_trans;
using repro::mma_bf16;
using repro::mma_bf16_k8;
using repro::NEG;
using repro::pack_bf16;
using repro::to_float;
using repro::warp_max;
using repro::warp_sum;

constexpr int MAX_NQ = 8;     // verify queries per slot (k + 1 <= 8)

// ------------------------------------------------- bfloat16: tensor cores
constexpr int KT = 16;        // keys per tile: the k of P V, two n8 tiles of S
constexpr int NW_MAX = 4;     // warps per block
constexpr int KV_STAGES = 2;  // ring depth of each warp's K/V tiles

// Geometry of a launch, shared by the kernel and the host check; mirrored
// by kernels/decode_attention.py (_smem_bytes).  `rows` is the m16's query
// rows, R nq.  A stored K or V row holds
// the pool row's 16-byte chunks (D / 8 in bf16, D / 16 in int8) at an odd
// stride; an int8 stage adds the tile's k and v scales.  Each warp has
// KV_STAGES stages; then the inbox holds, for each of the nw * split warps
// of the cluster, the owner's rows_per rows of D floats with their m and l,
// then the owner's weights (one per row and warp) and 1 / L (one per row).
__host__ __device__ constexpr int row_chunks(int d, bool quant) {
  return (quant ? d / 16 : d / 8) + 1;
}
__host__ __device__ constexpr int stage_bytes(int d, bool quant) {
  return 2 * KT * row_chunks(d, quant) * 16 + (quant ? 2 * KT * 4 : 0);
}
__host__ __device__ constexpr int rows_per(int rows, int split) {
  return (rows + split - 1) / split;
}
__host__ __device__ constexpr int ring_bytes(int d, bool quant, int nw) {
  return nw * KV_STAGES * stage_bytes(d, quant);
}
// head_dim 256: the block's 16 query rows staged in bf16 at an odd stride
// of 16-byte chunks, between the ring and the inbox (none at d <= 128)
__host__ __device__ constexpr int q_stage_bytes(int d) { return d > 128 ? 16 * (d / 8 + 1) * 16 : 0; }
__host__ __device__ constexpr int smem_bytes(int d, bool quant, int rows, int nw, int split) {
  return ring_bytes(d, quant, nw) + q_stage_bytes(d) +
         4 * (nw * split * rows_per(rows, split) * (d + 2) +
              (nw * split + 1) * rows_per(rows, split));
}

// Two int8 values at p, p + step (bytes), as one packed bf16 pair: exact.
__device__ __forceinline__ unsigned pack_i8(const int8_t* p, int step) {
  return pack_bf16((float)p[0], (float)p[step]);
}

// Grid (split, H kv heads, B), cluster (split, 1, 1), nw warps; the R q
// heads of kv head h are q heads h R .. h R + R - 1.  PT: the pools'
// element type, bf16 or int8 (then KS/VS hold the rows' scales).  CONTIG:
// contiguous lanes, a pool of B pages of psz = S rows, row b's page being
// b (n_max 1; BT, KS and VS unused; int8 lanes dequantised by dq).
// WINDOW: a sliding window of `window` > 0 keys (paged only).
template <int D, typename PT, bool CONTIG, bool WINDOW>
__global__ void __launch_bounds__(NW_MAX * 32)
paged_mma_kernel(const bf16* __restrict__ Q, const PT* __restrict__ KP,
                 const PT* __restrict__ VP, const float* __restrict__ KS,
                 const float* __restrict__ VS, const int* __restrict__ BT,
                 const int* __restrict__ LEN, bf16* __restrict__ O, int H, int R, int nq,
                 int psz, int n_max, int window, float scale_log2, float dq, int nw,
                 int split) {
  static_assert(!(CONTIG && WINDOW), "a contiguous ring needs no window");
  constexpr bool QUANT = std::is_same<PT, int8_t>::value;
  constexpr bool QSMEM = D > 128;               // Q from shared memory (head_dim 256)
  constexpr bool K8 = D == 8;                   // head_dim 8: one m16n8k8 step
  constexpr bool ROW8 = K8 && QUANT;            // an 8-byte pool row: one 8-byte piece
  constexpr int EPC = 16 / sizeof(PT);          // pool elements per 16-byte chunk
  constexpr int CPR = ROW8 ? 1 : D / EPC;       // chunks (pieces) per pool row
  constexpr int RS = row_chunks(D, QUANT);      // chunks per stored row (odd)
  constexpr int RB = RS * 16;                   // bytes per stored row
  constexpr int TILE = KT * RB;                 // bytes of one stored K (or V) tile
  constexpr int STAGE = stage_bytes(D, QUANT);
  constexpr int DK = K8 ? 1 : D / 16;           // k steps of Q K^T
  constexpr int NO = D / 8;                     // output tiles (8 columns)
  constexpr int QRB = (D / 8 + 1) * 16;         // bytes per staged Q row (odd chunk stride)
  extern __shared__ __align__(16) unsigned char smem[];

  const int rank = blockIdx.x;                  // grid x == split: the cluster rank
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int nr = R * nq;                        // query rows: q head r, query i at r nq + i
  unsigned char* ring = smem + warp * KV_STAGES * STAGE;
  unsigned char* qstage = smem + ring_bytes(D, QUANT, nw);   // QSMEM only
  float* inbox = reinterpret_cast<float*>(qstage + q_stage_bytes(D));
  if (split > 1) cluster_arrive();              // this block has started

  const int length = LEN[b];
  const int n_kv = min(length + nq - 1, n_max * psz);   // keys the deepest query sees
  const int n_tiles = (max(n_kv, 0) + KT - 1) / KT;
  // query 0's first key (the lowest of the rows' window starts) and its tile
  const int k_lo = WINDOW ? max(0, length - window) : 0;
  const int t_lo = k_lo / KT;
  const int t_first = t_lo + rank + split * warp;
  const int my_n = t_first < n_tiles ? (n_tiles - 1 - t_first) / (split * nw) + 1 : 0;
  const int* bt = CONTIG ? nullptr : BT + (size_t)b * n_max;
  // the pool row holding key kpos (< n_kv): row b's own lane, or its page
  auto pool_row = [&](int kpos) -> size_t {
    if constexpr (CONTIG)
      return ((size_t)b * H + h) * psz + kpos;
    else
      return ((size_t)bt[kpos / psz] * H + h) * psz + kpos % psz;
  };

  auto issue = [&](int i) {                     // the warp's i-th tile into stage i % 2
    unsigned char* st = ring + (i % KV_STAGES) * STAGE;
    const int key0 = (t_first + i * split * nw) * KT;
    for (int c = lane; c < KT * CPR; c += 32) {
      const int r = c / CPR, cc = c % CPR, kpos = key0 + r;
      const bool in = kpos < n_kv;
      const size_t off = in ? pool_row(kpos) * D + cc * EPC : 0;
      if constexpr (ROW8) {
        cp_async_8(st + r * RB, KP + off, in ? 8 : 0);
        cp_async_8(st + TILE + r * RB, VP + off, in ? 8 : 0);
      } else {
        cp_async_16(st + r * RB + cc * 16, KP + off, in ? 16 : 0);
        cp_async_16(st + TILE + r * RB + cc * 16, VP + off, in ? 16 : 0);
      }
    }
    if (QUANT && !CONTIG && lane < KT) {
      const int kpos = key0 + lane;
      const bool in = kpos < n_kv;
      const size_t row = in ? (size_t)bt[kpos / psz] * psz + kpos % psz : 0;
      cp_async_4(st + 2 * TILE + lane * 4, KS + row, in ? 4 : 0);
      cp_async_4(st + 2 * TILE + (KT + lane) * 4, VS + row, in ? 4 : 0);
    }
    cp_async_commit();
  };
  if (my_n > 0) issue(0);

  // Q fragments of the kv head's query rows (zeros past nr), loaded once:
  // its R q heads' rows are contiguous in q (B, H R, nq, D).  Head dim 256:
  // the rows are staged once in shared memory instead (read by ldmatrix)
  const bf16* q = Q + ((size_t)b * H + h) * nr * D;
  unsigned qf[QSMEM ? 1 : DK][4];
  if constexpr (QSMEM) {
    for (int c = tid; c < 16 * (D / 8); c += nw * 32) {
      const int row = c / (D / 8), cc = c % (D / 8);
      *reinterpret_cast<uint4*>(qstage + row * QRB + cc * 16) =
          row < nr ? *reinterpret_cast<const uint4*>(q + (size_t)row * D + cc * 8)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();
  } else {
#pragma unroll
    for (int kk = 0; kk < DK; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = g + 8 * (i & 1), col = kk * 16 + 2 * t4 + 8 * (i >> 1);
        qf[kk][i] = row < nr && !(K8 && i >= 2)   // k8: a0, a1 only
                        ? *reinterpret_cast<const unsigned*>(q + (size_t)row * D + col)
                        : 0u;
      }
  }

  // per lane: rows g and g + 8 (index r), each seeing keys kpos < see[r]
  // (row e is query e % nq; none past nr), log2-domain max m, partial row
  // sum l over the lane's columns (summed over the quad at the end), and
  // output columns 8 nt + 2 t4 (+1)
  // e % nq without a division (e < R nq: at most R - 1 steps; none at R =
  // 1, where a runtime % per row cost ~0.07 us of a 6.7 us verify on an
  // H100, scripts/torch_kernel_ab.py)
  // With a window, row e also sees only keys kpos >= lo[r] = length + i -
  // window (JAX's kpos > pos_i - window, pos_i = length - 1 + i).
  int see[2], lo[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int e = g + 8 * r;
    int i = e;
    for (int k = 1; k < R && i >= nq; ++k) i -= nq;
    see[r] = e < nr ? min(length + i, n_max * psz) : 0;
    lo[r] = WINDOW ? length + i - window : 0;
  }
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float o[NO][4];
#pragma unroll
  for (int nt = 0; nt < NO; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[nt][i] = 0.f;
  const int mat = lane >> 3, mrow = lane & 7;   // ldmatrix: this lane's tile and row

  for (int i = 0; i < my_n; ++i) {
    if (i + 1 < my_n) {
      issue(i + 1);
      cp_async_wait<1>();                       // tile i has landed
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const unsigned char* ks = ring + (i % KV_STAGES) * STAGE;
    const unsigned char* vs = ks + TILE;
    const float* kscale = reinterpret_cast<const float*>(ks + 2 * TILE);   // int8 only
    const int key0 = (t_first + i * split * nw) * KT;

    // S = Q K^T over the tile's 16 keys: two score tiles
    float s[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    if constexpr (K8) {                         // keys g and 8 + g, columns 2 t4 (+1)
      unsigned bk[2];
      if constexpr (QUANT) {
        const int8_t* k0 = reinterpret_cast<const int8_t*>(ks) + g * RB + 2 * t4;
        bk[0] = pack_i8(k0, 1);
        bk[1] = pack_i8(k0 + 8 * RB, 1);
      } else {
        ldsm_x2(bk, ks + ((mat & 1) * 8 + mrow) * RB);
      }
      mma_bf16_k8(s[0], qf[0], bk);
      mma_bf16_k8(s[1], qf[0], bk + 1);
    }
#pragma unroll
    for (int kk = 0; kk < (K8 ? 0 : DK); ++kk) {
      unsigned bk[4];
      if constexpr (QUANT) {                    // keys g and 8 + g, columns 2 t4 (+1), +8
        const int8_t* k0 = reinterpret_cast<const int8_t*>(ks) + g * RB + kk * 16 + 2 * t4;
        bk[0] = pack_i8(k0, 1);
        bk[1] = pack_i8(k0 + 8, 1);
        bk[2] = pack_i8(k0 + 8 * RB, 1);
        bk[3] = pack_i8(k0 + 8 * RB + 8, 1);
      } else {
        ldsm_x4(bk, ks + ((mat >> 1) * 8 + mrow) * RB + (kk * 2 + (mat & 1)) * 16);
      }
      if constexpr (QSMEM) {                    // A fragment: rows (mat & 1) 8 + mrow, k half mat >> 1
        unsigned qa[4];
        ldsm_x4(qa, qstage + ((mat & 1) * 8 + mrow) * QRB + (kk * 2 + (mat >> 1)) * 16);
        mma_bf16(s[0], qa, bk);
        mma_bf16(s[1], qa, bk + 2);
      } else {
        mma_bf16(s[0], qf[kk], bk);
        mma_bf16(s[1], qf[kk], bk + 2);
      }
    }

    // scale (int8: each key's k_scale, or the lanes' dq), mask, running
    // max, correction
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = nt * 8 + 2 * t4 + (e & 1);
        const float x = QUANT ? s[nt][e] * (CONTIG ? dq : kscale[key]) : s[nt][e];
        const bool ok = key0 + key < see[e >> 1] && (!WINDOW || key0 + key >= lo[e >> 1]);
        s[nt][e] = ok ? x * scale_log2 : NEG;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m[r] - mx[r]);            // 1 while both are NEG: l and o are 0 then
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
      o[nt][0] *= corr[0];
      o[nt][1] *= corr[0];
      o[nt][2] *= corr[1];
      o[nt][3] *= corr[1];
    }
    // p in float32 (masked: 0, never exp(NEG - NEG)); l sums it unrounded;
    // int8: the A fragment carries p * v_scale of its key (or p * dq)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = s[nt][e] <= NEG ? 0.f : exp2f(s[nt][e] - m[e >> 1]);
        l[e >> 1] += p;
        s[nt][e] = QUANT ? p * (CONTIG ? dq : kscale[KT + nt * 8 + 2 * t4 + (e & 1)]) : p;
      }
    unsigned a[4];
    a[0] = pack_bf16(s[0][0], s[0][1]);
    a[1] = pack_bf16(s[0][2], s[0][3]);
    a[2] = pack_bf16(s[1][0], s[1][1]);
    a[3] = pack_bf16(s[1][2], s[1][3]);
    // O += bf16(P) V over the tile's 16 keys
    if constexpr (QUANT) {
#pragma unroll
      for (int nt = 0; nt < NO; ++nt) {         // keys 2 t4 (+1), +8, column 8 nt + g
        const int8_t* v0 = reinterpret_cast<const int8_t*>(vs) + 2 * t4 * RB + nt * 8 + g;
        const unsigned bv[2] = {pack_i8(v0, RB), pack_i8(v0 + 8 * RB, RB)};
        mma_bf16(o[nt], a, bv);
      }
    } else if constexpr (K8) {                  // 8 output columns: one tile
      unsigned bv[2];
      ldsm_x2_trans(bv, vs + ((mat & 1) * 8 + mrow) * RB);
      mma_bf16(o[0], a, bv);
    } else {
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {     // 16 output columns: two tiles
        unsigned bv[4];
        ldsm_x4_trans(bv, vs + ((mat & 1) * 8 + mrow) * RB + (dp * 2 + (mat >> 1)) * 16);
        mma_bf16(o[2 * dp], a, bv);
        mma_bf16(o[2 * dp + 1], a, bv + 2);
      }
    }
    __syncwarp();                               // the warp is done with this stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  // Query row e belongs to rank e / rp.  Each warp stores its unnormalised
  // rows and their (m, l) into the owner's inbox, slot rank * nw + warp.
  const int rp = rows_per(nr, split);
  const int slot = rp * (D + 2);
  const int parts = nw * split;
  if (split > 1) cluster_wait();                // every block of the cluster has started
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    if (row >= nr) continue;
    const int owner = row / rp;
    float* box = split > 1 ? cg::this_cluster().map_shared_rank(inbox, owner) : inbox;
    float* dst = box + (rank * nw + warp) * slot + (row - owner * rp) * (D + 2);
#pragma unroll
    for (int nt = 0; nt < NO; ++nt)
      *reinterpret_cast<float2*>(dst + nt * 8 + 2 * t4) = make_float2(o[nt][2 * r], o[nt][2 * r + 1]);
    if (t4 == 0) {
      dst[D] = m[r];
      dst[D + 1] = l[r];
    }
  }
  __syncwarp();
  if (split > 1) {
    cluster_arrive();
    cluster_wait();                             // every partial has arrived
  } else {
    __syncthreads();
  }
  const int nthreads = nw * 32;
  const int rows_mine = min(rp, nr - rank * rp);
  float* wts = inbox + parts * slot;            // [rp][parts] weights, then [rp] 1 / L
  for (int e = tid; e < rows_mine; e += nthreads) {
    float M = NEG;
    for (int j = 0; j < parts; ++j) M = fmaxf(M, inbox[j * slot + e * (D + 2) + D]);
    float L = 0.f;
    for (int j = 0; j < parts; ++j) {
      const float mj = inbox[j * slot + e * (D + 2) + D];
      const float w = mj <= NEG ? 0.f : exp2f(mj - M);
      wts[e * parts + j] = w;
      L += w * inbox[j * slot + e * (D + 2) + D + 1];
    }
    wts[rp * parts + e] = L > 0.f ? 1.f / L : 0.f;
  }
  __syncthreads();
  bf16* out = O + (((size_t)b * H + h) * nr + rank * rp) * D;
  for (int e = tid; e < rows_mine * D; e += nthreads) {
    const int ro = e / D, d = e % D;
    float acc = 0.f;
    for (int j = 0; j < parts; ++j) acc += wts[ro * parts + j] * inbox[j * slot + ro * (D + 2) + d];
    out[e] = __float2bfloat16_rn(acc * wts[rp * parts + ro]);
  }
}

template <int D, typename PT, bool CONTIG, bool WINDOW>
int launch_mma(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
               const void* bt, const void* len, void* o, int B, int H, int R, int nq,
               int psz, int n_max, int window, float scale, float dq, int nw, int split,
               int smem, cudaStream_t stream) {
  auto kernel = paged_mma_kernel<D, PT, CONTIG, WINDOW>;
  static int granted = 48 * 1024;               // dynamic shared memory allowed so far
  if (smem > granted) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    granted = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, H / R, B);              // one cluster per (kv head, slot)
  cfg.blockDim = dim3(nw * 32, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaLaunchKernelEx(&cfg, kernel, (const bf16*)q, (const PT*)kp, (const PT*)vp,
                     (const float*)ks, (const float*)vs, (const int*)bt, (const int*)len,
                     (bf16*)o, H / R, R, nq, psz, n_max, window, scale_log2, dq, nw, split);
  return (int)cudaGetLastError();
}

// The tensor-core kernel at head dim D in {8, 32, 64, 128, 256}; H q heads, R
// of them per kv head; WINDOW: window > 0.
template <typename PT, bool CONTIG, bool WINDOW>
int launch_mma_dw(int D, const void* q, const void* kp, const void* vp, const void* ks,
                  const void* vs, const void* bt, const void* len, void* o, int B, int H,
                  int R, int nq, int psz, int n_max, int window, float scale, float dq, int nw,
                  int split, int smem, cudaStream_t stream) {
#define REPRO_PAGED_MMA(DIM)                                                              \
  launch_mma<DIM, PT, CONTIG, WINDOW>(q, kp, vp, ks, vs, bt, len, o, B, H, R, nq, psz, n_max, \
                                      window, scale, dq, nw, split, smem, stream)
  switch (D) {
    case 8: return REPRO_PAGED_MMA(8);
    case 32: return REPRO_PAGED_MMA(32);
    case 64: return REPRO_PAGED_MMA(64);
    case 128: return REPRO_PAGED_MMA(128);
    default: return REPRO_PAGED_MMA(256);
  }
#undef REPRO_PAGED_MMA
}

template <typename PT, bool CONTIG>
int launch_mma_d(int D, const void* q, const void* kp, const void* vp, const void* ks,
                 const void* vs, const void* bt, const void* len, void* o, int B, int H,
                 int R, int nq, int psz, int n_max, int window, float scale, float dq, int nw,
                 int split, int smem, cudaStream_t stream) {
  if constexpr (!CONTIG)
    if (window > 0)
      return launch_mma_dw<PT, false, true>(D, q, kp, vp, ks, vs, bt, len, o, B, H, R, nq, psz,
                                          n_max, window, scale, dq, nw, split, smem, stream);
  return launch_mma_dw<PT, CONTIG, false>(D, q, kp, vp, ks, vs, bt, len, o, B, H, R, nq, psz,
                                          n_max, 0, scale, dq, nw, split, smem, stream);
}

bool head_dim_ok(int D) { return D == 8 || D == 32 || D == 64 || D == 128 || D == 256; }

// A tensor-core plan the kernel takes: `rows` = R nq query rows in the
// m16, 1 <= nw <= 4 warps, split 1, 2, 4 or 8, smem as smem_bytes().
bool mma_plan_fits(int D, bool quant, int rows, int nw, int split, int smem) {
  return rows >= 1 && rows <= 16 && nw >= 1 && nw <= NW_MAX && split >= 1 && split <= 8 &&
         !(split & (split - 1)) && smem == smem_bytes(D, quant, rows, nw, split);
}

// ------------------------------------------------ float32: CUDA cores
constexpr int NW = 4;         // warps per block

template <typename PT, int D, int NQ>
__global__ void __launch_bounds__(NW * 32)
paged_simt_kernel(const float* __restrict__ Q, const PT* __restrict__ KP,
                  const PT* __restrict__ VP, const float* __restrict__ KS,
                  const float* __restrict__ VS, const int* __restrict__ BT,
                  const int* __restrict__ LEN, float* __restrict__ O, int H, int R, int nq,
                  int psz, int n_max, int window, float scale) {
  constexpr int DPL = (D + 31) / 32;
  constexpr bool QUANT = std::is_same<PT, int8_t>::value;
  __shared__ float sm[NW][NQ], sl[NW][NQ];
  __shared__ float sacc[NW][NQ][D];
  const int h = blockIdx.x, b = blockIdx.y;   // q head h reads kv head h / R
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool col_ok = D >= 32 || lane < D;   // the lane holds columns (else zeros)
  const int Hk = H / R, hk = h / R;
  const int length = LEN[b];
  const int n_kv = length + nq - 1;          // keys the deepest query sees
  const int n_used = n_kv <= 0 ? 0 : min((n_kv + psz - 1) / psz, n_max);
  // with a window, pages below the one holding query 0's first key are skipped
  const int p_lo = window > 0 ? max(0, length - window) / psz : 0;
  const size_t qrow = ((size_t)b * H + h) * nq;

  float q[NQ][DPL], acc[NQ][DPL], m[NQ], l[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      q[i][c] = i < nq && col_ok ? Q[(qrow + i) * D + lane + 32 * c] : 0.f;
      acc[i][c] = 0.f;
    }
  }

  for (int pi = p_lo + warp; pi < n_used; pi += NW) {
    const size_t page = (size_t)BT[(size_t)b * n_max + pi];
    const PT* kpage = KP + (page * Hk + hk) * psz * D;
    const PT* vpage = VP + (page * Hk + hk) * psz * D;
    const int n_tok = min(psz, n_kv - pi * psz);
    for (int t = 0; t < n_tok; ++t) {
      const int kpos = pi * psz + t;
      float kr[DPL], vr[DPL];
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        kr[c] = col_ok ? to_float(kpage[t * D + lane + 32 * c]) : 0.f;
        vr[c] = col_ok ? to_float(vpage[t * D + lane + 32 * c]) : 0.f;
      }
      if (QUANT) {
        const float ks = KS[page * psz + t], vs = VS[page * psz + t];
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          kr[c] *= ks;
          vr[c] *= vs;
        }
      }
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        if (i >= nq || kpos >= length + i ||            // uniform over the warp
            (window > 0 && kpos < length + i - window))
          continue;
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < DPL; ++c) s = fmaf(q[i][c], kr[c], s);
        s = warp_sum(s) * scale;
        const float m_new = fmaxf(m[i], s);
        const float corr = expf(m[i] - m_new);
        const float p = expf(s - m_new);
        l[i] = l[i] * corr + p;
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[i][c] = fmaf(p, vr[c], acc[i][c] * corr);
        m[i] = m_new;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    if (lane == 0) {
      sm[warp][i] = m[i];
      sl[warp][i] = l[i];
    }
    if (col_ok)
#pragma unroll
      for (int c = 0; c < DPL; ++c) sacc[warp][i][lane + 32 * c] = acc[i][c];
  }
  __syncthreads();
  for (int i = warp; i < nq; i += NW) {
    float mx = NEG;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm[w][i]);
    float den = 0.f, out[DPL];
#pragma unroll
    for (int c = 0; c < DPL; ++c) out[c] = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(sm[w][i] - mx);
      den = fmaf(sl[w][i], f, den);
#pragma unroll
      for (int c = 0; c < DPL; ++c)
        out[c] = col_ok ? fmaf(sacc[w][i][lane + 32 * c], f, out[c]) : 0.f;
    }
    const float inv = 1.f / fmaxf(den, 1e-20f);
    if (col_ok)
#pragma unroll
      for (int c = 0; c < DPL; ++c) O[(qrow + i) * D + lane + 32 * c] = out[c] * inv;
  }
}

template <typename PT, int NQ>
int launch_simt(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
                const void* bt, const void* len, void* o, int B, int H, int R, int nq, int D,
                int psz, int n_max, int window, float scale, cudaStream_t stream) {
  const dim3 grid(H, B), block(NW * 32);
#define REPRO_PAGED_SIMT(DIM)                                                             \
  paged_simt_kernel<PT, DIM, NQ><<<grid, block, 0, stream>>>(                             \
      (const float*)q, (const PT*)kp, (const PT*)vp, (const float*)ks, (const float*)vs,  \
      (const int*)bt, (const int*)len, (float*)o, H, R, nq, psz, n_max, window, scale)
  switch (D) {
    case 8: REPRO_PAGED_SIMT(8); break;
    case 32: REPRO_PAGED_SIMT(32); break;
    case 64: REPRO_PAGED_SIMT(64); break;
    case 128: REPRO_PAGED_SIMT(128); break;
    default: REPRO_PAGED_SIMT(256); break;
  }
#undef REPRO_PAGED_SIMT
  return (int)cudaGetLastError();
}

// Check the plan against the shape and launch it.  H q heads, R of them
// per kv head (H % R == 0, R nq <= 16); window 0 (none) or > 0 keys.
// dtype 0 (float32 q; float32 or int8 pools): the CUDA-core kernel, nw 4,
// split 1, smem 0.  dtype 1 (bfloat16 q; bfloat16 or int8 pools): the
// tensor-core kernel with 1 <= nw <= 4 warps, split 1, 2, 4 or 8, smem as
// smem_bytes().
template <bool QUANT, int NQ>
int run(int dtype, const void* q, const void* kp, const void* vp, const void* ks,
        const void* vs, const void* bt, const void* len, void* o, int B, int H, int R, int nq,
        int D, int psz, int n_max, int window, float scale, int nw, int split, int smem,
        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || H <= 0 || B > 65535 || H > 65535 || nq < 1 || nq > NQ || psz <= 0 ||
      n_max <= 0 || !head_dim_ok(D) || R < 1 || H % R || R * nq > 16 || window < 0)
    return (int)cudaErrorInvalidValue;
  using FP = typename std::conditional<QUANT, int8_t, float>::type;
  using BP = typename std::conditional<QUANT, int8_t, bf16>::type;
  if (dtype == 0) {
    if (nw != NW || split != 1 || smem != 0) return (int)cudaErrorInvalidValue;
    return launch_simt<FP, NQ>(q, kp, vp, ks, vs, bt, len, o, B, H, R, nq, D, psz, n_max,
                               window, scale, s);
  }
  if (dtype != 1 || !mma_plan_fits(D, QUANT, R * nq, nw, split, smem))
    return (int)cudaErrorInvalidValue;
  return launch_mma_d<BP, false>(D, q, kp, vp, ks, vs, bt, len, o, B, H, R, nq, psz, n_max,
                                 window, scale, 1.f, nw, split, smem, s);
}

// ------------------------------ float32 over contiguous lanes: CUDA cores
constexpr int CONTIG_NW = 8;     // warps per block
constexpr int CONTIG_TILE = 32;  // keys per warp tile: one per lane

// 16 bytes of a lane row as floats: 4 float32 or 16 int8 values.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void load16(const int8_t* p, float* out) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = (float)c[i];
}

// 8 bytes of an int8 lane row (head_dim 8) as floats.
__device__ __forceinline__ void load8(const int8_t* p, float* out) {
  const int2 v = *reinterpret_cast<const int2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = (float)c[i];
}

// One block per (q head h, row), reading kv head h / R's lane, eight warps
// taking 32-key tiles of [0, length) in turn; in a tile each lane scores one
// key (its row by 16-byte loads, dotted with q staged in shared memory), the
// warp takes one max and one sum over its 32 scores and accumulates the
// tile's value rows one at a time, each lane holding D / 32 output columns
// (at D 8 lanes 0-7 one each; an int8 row is one 8-byte load);
// the warps merge through shared memory.  KV float (dq unused) or int8 (values times dq).
template <typename KV, int D>
__global__ void __launch_bounds__(CONTIG_NW * 32)
contig_simt_kernel(const float* __restrict__ Q, const KV* __restrict__ K,
                   const KV* __restrict__ V, const int* __restrict__ LEN, float* __restrict__ O,
                   int H, int R, int S, float scale, float dq) {
  constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  constexpr int DPL = (D + 31) / 32;             // output columns per lane
  constexpr int VEC = 16 / sizeof(KV) < D ? 16 / sizeof(KV) : D;   // elements per load
  __shared__ float sq[D];
  __shared__ float sm[CONTIG_NW], sl[CONTIG_NW];
  __shared__ float sacc[CONTIG_NW][D];
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool col_ok = D >= 32 || lane < D;       // the lane holds output columns
  const int col0 = col_ok ? lane : 0;
  const int n = max(0, min(LEN[b], S));          // valid keys of this row
  const size_t bh = (size_t)b * H + h;
  const size_t lane_kv = (size_t)b * (H / R) + h / R;   // the kv head's lane
  const KV* krow = K + lane_kv * S * D;
  const KV* vrow = V + lane_kv * S * D;
  auto deq = [&](float x) { return QUANT ? x * dq : x; };

  for (int d = threadIdx.x; d < D; d += CONTIG_NW * 32) sq[d] = Q[bh * D + d];
  __syncthreads();

  float m = NEG, l = 0.f, acc[DPL];
#pragma unroll
  for (int c = 0; c < DPL; ++c) acc[c] = 0.f;

  for (int t0 = warp * CONTIG_TILE; t0 < n; t0 += CONTIG_NW * CONTIG_TILE) {
    const int j = t0 + lane;                     // this lane's key
    float s = NEG;
    if (j < n) {
      const KV* kp = krow + (size_t)j * D;
      float dot = 0.f;
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += VEC) {
        float kv[VEC];
        if constexpr (VEC * sizeof(KV) == 16)
          load16(kp + d0, kv);
        else
          load8(kp + d0, kv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) dot = fmaf(sq[d0 + i], deq(kv[i]), dot);
      }
      s = dot * scale;
    }
    const float m_new = fmaxf(m, warp_max(s));   // the tile has a valid key
    const float corr = expf(m - m_new);
    const float p = j < n ? expf(s - m_new) : 0.f;
    l = l * corr + warp_sum(p);
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[c] *= corr;
    const int cnt = min(CONTIG_TILE, n - t0);    // uniform over the warp
    for (int i = 0; i < cnt; ++i) {
      const float pi = __shfl_sync(0xffffffffu, p, i);
      const KV* vp = vrow + (size_t)(t0 + i) * D;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[c] = fmaf(pi, deq(to_float(vp[col0 + 32 * c])), acc[c]);
    }
    m = m_new;
  }

  if (lane == 0) {
    sm[warp] = m;
    sl[warp] = l;
  }
  if (col_ok)
#pragma unroll
    for (int c = 0; c < DPL; ++c) sacc[warp][lane + 32 * c] = acc[c];
  __syncthreads();
  float mx = NEG;
#pragma unroll
  for (int w = 0; w < CONTIG_NW; ++w) mx = fmaxf(mx, sm[w]);
  float den = 0.f;
#pragma unroll
  for (int w = 0; w < CONTIG_NW; ++w) den = fmaf(sl[w], expf(sm[w] - mx), den);
  const float inv = 1.f / fmaxf(den, 1e-20f);
  for (int d = threadIdx.x; d < D; d += CONTIG_NW * 32) {
    float out = 0.f;
#pragma unroll
    for (int w = 0; w < CONTIG_NW; ++w) out = fmaf(sacc[w][d], expf(sm[w] - mx), out);
    O[bh * D + d] = out * inv;
  }
}

template <typename KV>
int launch_contig_simt(const void* q, const void* k, const void* v, const void* len, void* o,
                       int B, int H, int R, int S, int D, float scale, float dq,
                       cudaStream_t stream) {
  const dim3 grid(H, B), block(CONTIG_NW * 32);
#define REPRO_CONTIG_SIMT(DIM)                                                              \
  contig_simt_kernel<KV, DIM><<<grid, block, 0, stream>>>(                                  \
      (const float*)q, (const KV*)k, (const KV*)v, (const int*)len, (float*)o, H, R, S,    \
      scale, dq)
  switch (D) {
    case 8: REPRO_CONTIG_SIMT(8); break;
    case 32: REPRO_CONTIG_SIMT(32); break;
    case 64: REPRO_CONTIG_SIMT(64); break;
    case 128: REPRO_CONTIG_SIMT(128); break;
    default: REPRO_CONTIG_SIMT(256); break;
  }
#undef REPRO_CONTIG_SIMT
  return (int)cudaGetLastError();
}

// Check the plan against the shape and launch it.  H q heads, R of them
// per kv head (H % R == 0, R <= 16).  dtype 0 (float32 q; float32 or int8
// lanes): the CUDA-core kernel, nw 8, split 1, smem 0.  dtype 1 (bfloat16
// q; bfloat16 or int8 lanes): the tensor-core kernel with the contiguous
// policy, its plan that of nq 1, psz S, n_max 1 (R rows in the m16).
template <bool QUANT>
int run_contig(int dtype, const void* q, const void* k, const void* v, const void* len, void* o,
               int B, int H, int R, int S, int D, float scale, float dq, int nw, int split,
               int smem, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || H <= 0 || B > 65535 || H > 65535 || S <= 0 || !head_dim_ok(D) || R < 1 ||
      H % R || R > 16)
    return (int)cudaErrorInvalidValue;
  using FK = typename std::conditional<QUANT, int8_t, float>::type;
  using BK = typename std::conditional<QUANT, int8_t, bf16>::type;
  if (dtype == 0) {
    if (nw != CONTIG_NW || split != 1 || smem != 0) return (int)cudaErrorInvalidValue;
    return launch_contig_simt<FK>(q, k, v, len, o, B, H, R, S, D, scale, dq, s);
  }
  if (dtype != 1 || !mma_plan_fits(D, QUANT, R, nw, split, smem))
    return (int)cudaErrorInvalidValue;
  return launch_mma_d<BK, true>(D, q, k, v, nullptr, nullptr, nullptr, len, o, B, H, R, 1, S, 1,
                                0, scale, dq, nw, split, smem, s);
}

}  // namespace

// The four C entries, each one launch of the plan
// kernels/decode_attention.py::plan chose (nw, split, smem; see run()).
// dtype: 0 = float32, 1 = bfloat16 (q and output; the pools too in the
// float variants); H q heads over H / R kv heads of the pools, R nq <= 16;
// head_dim D in {8, 32, 64, 128, 256}; verify takes 1 <= nq <= 8; window 0
// (none) or the sliding window's keys.
// All tensors contiguous; bf16 q and pools 16-byte aligned.  Each returns a
// CUDA error code: a plan that does not fit the shape is
// cudaErrorInvalidValue, never a launch; else cudaGetLastError() after it.
extern "C" int repro_paged_decode(const void* q, const void* kp, const void* vp,
                                  const void* block_table, const void* length, void* o,
                                  int B, int H, int R, int D, int psz, int n_max,
                                  int window, float scale, int dtype,
                                  int nw, int split, int smem, void* stream) {
  return run<false, 1>(dtype, q, kp, vp, nullptr, nullptr, block_table, length, o, B, H, R, 1,
                       D, psz, n_max, window, scale, nw, split, smem, stream);
}

extern "C" int repro_paged_decode_i8(const void* q, const void* kp, const void* vp,
                                     const void* k_scale, const void* v_scale,
                                     const void* block_table, const void* length, void* o,
                                     int B, int H, int R, int D, int psz, int n_max,
                                     int window, float scale, int dtype,
                                     int nw, int split, int smem, void* stream) {
  return run<true, 1>(dtype, q, kp, vp, k_scale, v_scale, block_table, length, o, B, H, R, 1,
                      D, psz, n_max, window, scale, nw, split, smem, stream);
}

extern "C" int repro_paged_verify(const void* q, const void* kp, const void* vp,
                                  const void* block_table, const void* length, void* o,
                                  int B, int H, int R, int nq, int D, int psz, int n_max,
                                  int window, float scale, int dtype,
                                  int nw, int split, int smem, void* stream) {
  return run<false, MAX_NQ>(dtype, q, kp, vp, nullptr, nullptr, block_table, length, o, B, H,
                            R, nq, D, psz, n_max, window, scale, nw, split, smem, stream);
}

extern "C" int repro_paged_verify_i8(const void* q, const void* kp, const void* vp,
                                     const void* k_scale, const void* v_scale,
                                     const void* block_table, const void* length, void* o,
                                     int B, int H, int R, int nq, int D, int psz,
                                     int n_max, int window, float scale, int dtype,
                                     int nw, int split, int smem, void* stream) {
  return run<true, MAX_NQ>(dtype, q, kp, vp, k_scale, v_scale, block_table, length, o, B, H,
                           R, nq, D, psz, n_max, window, scale, nw, split, smem, stream);
}

// Decode over contiguous lanes, each one launch of the plan
// kernels/decode_attention.py::contiguous_plan chose (see run_contig()).
// dtype: 0 = float32, 1 = bfloat16 (q, output, and the lanes of
// repro_decode_attention; repro_decode_attention_i8 takes int8 lanes whose
// values times dq are the keys and values); H q heads over H / R kv heads
// of the lanes (B, H / R, S, D); head_dim D in {8, 32, 64, 128, 256}.
// All tensors contiguous; q and the lanes 16-byte aligned.  Each returns a
// CUDA error code, as the paged entries do.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* length, void* o, int B, int H, int R, int S,
                                      int D, float scale, int dtype, int nw, int split,
                                      int smem, void* stream) {
  return run_contig<false>(dtype, q, k, v, length, o, B, H, R, S, D, scale, 1.f, nw, split,
                           smem, stream);
}

extern "C" int repro_decode_attention_i8(const void* q, const void* k, const void* v,
                                         const void* length, void* o, int B, int H, int R,
                                         int S, int D, float scale, float dq, int dtype,
                                         int nw, int split, int smem, void* stream) {
  return run_contig<true>(dtype, q, k, v, length, o, B, H, R, S, D, scale, dq, nw, split, smem,
                          stream);
}
