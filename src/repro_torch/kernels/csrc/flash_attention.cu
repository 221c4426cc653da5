// Flash attention for Hopper: q (H, Sq, D), k/v (H / R, Skv, D) -> o (H, Sq,
// D); R q heads share one kv head, q head h reading kv head h / R (GQA, the
// JAX model path's grouping).  Query row i sits at position q_offset + i, key j
// at position j; a key is valid when j < Skv, j <= q_pos (causal) and
// j > q_pos - window (window > 0).  Online softmax in float32; a row with no
// valid key gives 0.
//
// Replaces: src/repro/kernels/flash_attention.py:78 flash_attention
//   (_flash_kernel, pallas_call at :93).  The Pallas contract puts the
//   queries at the suffix of the key stream (q_offset = Skv - Sq); the
//   prefill chunk needs them at the chunk's start inside a longer gathered
//   stream whose tail past the chunk is garbage, so q_offset is an argument.
//   It is read from device memory (one int32), once per block: the chunk
//   step's offset is per-tick data, so a CUDA graph of the step replays
//   with whatever offset the engine last copied there.
// Bound on this card: the chunk step (8 heads, Sq = 32 queries against a
//   256-key gathered stream, D 64) reads K and V once (0.5 MB) and does
//   ~4 D operations per (query, key) pair: bytes bound it, at ~0.2 us.
//   What limits a kernel this small is latency: the launch, one round trip
//   to L2 for its tiles, and the steps that depend on each other.
//
// Design of the bfloat16 kernel, and what each choice does about that:
//  - Tensor cores, FA2-style: one warp owns 16 query rows, the m16 of
//    mma.sync m16n8k16 (bf16 in, float32 accumulate).  Its Q fragments are
//    loaded once into registers.  S = Q K^T takes K through ldmatrix from
//    the key tile; the online softmax runs on the accumulator fragments
//    (a row's max and sum need two xor-shuffles inside the lane quad that
//    holds it, in the log2 domain: exp2 of scores prescaled by log2 e).
//  - P stays in registers: two adjacent 16 x 8 score tiles, rounded to
//    bf16, are the 16 x 16 A fragment of P V, with V through ldmatrix.trans.
//    P is rounded to bf16 only for that product, as the Pallas kernel casts
//    p to v's dtype (:66); the row sum l adds the float32 p (:64).
//  - 64-key tiles of K and V arrive by 16-byte cp.async into a two-stage
//    ring (the next tile in flight while this one multiplies), rows at an
//    odd stride of 16-byte chunks so the 8 rows one ldmatrix phase reads
//    fall in 8 distinct bank groups; keys past Skv are zero-filled.
//  - GQA: a block serves rb q heads of one kv head (rb the largest divisor
//    of R up to 4), `wr` warps of 16 query rows each (wq = rb wr <= 4
//    warps; wr = min(ceil(Sq / 16), 4 / rb)), so every K/V tile a block
//    loads feeds its rb heads: at R <= 4 (and 6, 8, 12, ...: R / rb
//    blocks) K and V are read once per kv head (or R / rb times), not once
//    per q head.
//  - Enough blocks: the key tiles are dealt out over the `split` <= 8
//    blocks of a thread-block cluster (tile t to rank t % split; grid x =
//    split, cluster (split, 1, 1); grid y = group of rb q heads x row tile
//    of wr warps' rows).  Each rank skips the tiles above the causal diagonal and left
//    of the window of its rows itself, so the launch depends only on the
//    shapes, never on the value of q_offset.  The ranks' (m, l, O) meet
//    through distributed shared memory in the same launch: each pushes its
//    rows into the inbox of the rank that owns them, and after a cluster
//    barrier the owner weighs them in rank order.  One kernel per call, no
//    workspace, no atomics: bitwise repeatable.  A rank with no valid key
//    for a row left m = NEG and l = 0 there; it gets weight 0 without
//    forming exp(NEG - NEG), and a row no rank saw gives 0.
//  - head_dim 256 (gemma3): a warp's 16 output rows are 128 float registers
//    a thread, so its Q fragments (64 more) are staged in shared memory
//    (each warp its own 16 rows, odd chunk stride) and read by ldmatrix at
//    every k step, and the key tiles are 32 keys (kv_tile): the ring of two
//    64-key stages alone would be 135 KB, and with Q and a split's inbox
//    past the 227 KB a block may hold.  D <= 128 keeps 64-key tiles and Q
//    in registers, the instantiations' code unchanged.
//  - head_dim 8 (tinyllama-42m-64h, 64 heads of 8): Q K^T is one mma.sync
//    m16n8k8 step (a k of 8), its A fragment the first half of the k16
//    one, K through ldmatrix x4 (four 8-key score tiles at once); P V's
//    output is a single n8 tile, V through ldmatrix x2.trans.  A stored
//    row is one 16-byte chunk at a stride of two (the same d / 8 + 1).
//  kernels/flash_attention.py::plan picks wq and split from the shapes and
//  the C entry refuses a plan whose shared memory differs from smem_bytes.
//
// float32 keeps a CUDA-core kernel (its 1e-4 tolerance excludes bf16 and
// TF32 products): one block per (q head h, 16-query tile) over kv head
// h / R, four warps of four rows, each 64-key tile (32 for D >= 128) of K and
// V staged as float (in dynamic shared memory at D = 256: 81 KB); a lane
// holds output columns lane + 32 c (at D 8 lanes 0-7 one each).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;
using repro::cluster_arrive;
using repro::cluster_wait;
using repro::cp_async_16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::ldsm_x2_trans;
using repro::ldsm_x4;
using repro::ldsm_x4_trans;
using repro::mma_bf16;
using repro::mma_bf16_k8;
using repro::NEG;
using repro::pack_bf16;
using repro::warp_max;
using repro::warp_sum;

// ------------------------------------------------- bfloat16: tensor cores
constexpr int KV_TILE = 64;   // keys per tile
constexpr int KV_TILE_WIDE = 32;  // keys per tile at head_dim > 128
constexpr int WQ_MAX = 4;     // warps per block, 16 query rows each
constexpr int KV_STAGES = 2;  // ring depth of K/V tiles

// Geometry of a launch, shared by the kernel and the host check; mirrored
// by kernels/flash_attention.py (_smem_bytes and plan).  wq is the block's
// warps, rb q heads x wr row warps.  A stored K or V row holds
// D / 8 chunks of 16 bytes at an odd stride; the inbox holds, for each of
// the `split` ranks, the owner's rows_per rows of D floats and their m and
// l, then the owner's weights (split per row) and 1 / L (one per row).
__host__ __device__ constexpr int kv_stride(int d) { return d / 8 + 1; }
__host__ __device__ constexpr int kv_tile(int d) { return d > 128 ? KV_TILE_WIDE : KV_TILE; }
__host__ __device__ constexpr int rows_per(int wq, int split) {
  return (16 * wq + split - 1) / split;
}
__host__ __device__ constexpr int ring_bytes(int d) { return KV_STAGES * 2 * kv_tile(d) * kv_stride(d) * 16; }
// head_dim > 128: each warp's 16 query rows staged in bf16, between the
// ring and the inbox
__host__ __device__ constexpr int q_stage_bytes(int d, int wq) {
  return d > 128 ? wq * 16 * kv_stride(d) * 16 : 0;
}
__host__ __device__ constexpr int heads_per_block(int r) {  // the largest divisor of R <= WQ_MAX
  int rb = 1;
  for (int d = 2; d <= WQ_MAX; ++d)
    if (r % d == 0) rb = d;
  return rb;
}
__host__ __device__ constexpr int row_warps(int sq, int rb) {
  return (sq + 15) / 16 < WQ_MAX / rb ? (sq + 15) / 16 : WQ_MAX / rb;
}
__host__ __device__ constexpr int smem_bytes(int d, int wq, int split) {
  return ring_bytes(d) + q_stage_bytes(d, wq) +
         (split > 1 ? 4 * (split * rows_per(wq, split) * (d + 2) + (split + 1) * rows_per(wq, split))
                    : 0);
}

// Grid (split, H / rb head groups x row tiles), cluster (split, 1, 1),
// wq = rb wr warps: warp w serves q head hb rb + w / wr (kv head hb rb / R),
// rows (w % wr) 16 of the tile.  GROUPED is R > 1; at R = 1 the kernel
// keeps the one-head forms (no head arithmetic, the epilogue indexed by
// element): the grouped forms cost ~0.3 us of a 7 us call there
// (scripts/torch_kernel_ab.py, H100).
template <int D, bool GROUPED>
__global__ void __launch_bounds__(WQ_MAX * 32)
flash_mma_kernel(const bf16* __restrict__ Q, const bf16* __restrict__ K,
                 const bf16* __restrict__ V, bf16* __restrict__ O, int Sq, int Skv,
                 const int* __restrict__ q_off, int causal, int window, float scale_log2,
                 int R, int rb, int wr, int split, int row_tiles) {
  constexpr int KT = kv_tile(D);        // keys per tile
  constexpr int KS = kv_stride(D);      // chunks per stored K/V row
  constexpr bool K8 = D == 8;           // Q K^T in one m16n8k8 step
  constexpr int DK = K8 ? 1 : D / 16;   // k steps of Q K^T
  constexpr int NS = KT / 8;            // score tiles (8 keys) per key tile
  constexpr int NO = D / 8;             // output tiles (8 columns)
  constexpr int TILE = KT * KS * 8;     // bf16 elements of one stored tile
  constexpr bool QSMEM = D > 128;       // Q fragments from shared memory
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);   // [stage][K, V][KT][KS * 8]

  const int rank = blockIdx.x;          // grid x == split: the cluster rank
  const int rt = blockIdx.y % row_tiles, h0 = blockIdx.y / row_tiles * rb;
  const int hk = GROUPED ? h0 / R : h0; // the block's kv head
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wq = rb * wr, nthreads = wq * 32;
  bf16* qstage = reinterpret_cast<bf16*>(smem + ring_bytes(D));   // QSMEM: [warp][16][KS * 8]
  float* inbox = reinterpret_cast<float*>(smem + ring_bytes(D) + q_stage_bytes(D, wq));
  const int g = lane >> 2, t4 = lane & 3;
  const int h = GROUPED ? h0 + warp / wr : h0;  // the warp's q head
  const int q0 = rt * 16 * wr;          // the block's first query row (of every head)
  const int r0 = q0 + (GROUPED ? warp % wr : warp) * 16;  // the warp's
  const bf16* q = Q + (size_t)h * Sq * D;
  const bf16* k = K + (size_t)hk * Skv * D;
  const bf16* v = V + (size_t)hk * Skv * D;
  if (split > 1) cluster_arrive();      // this block has started

  // the key tiles the block's rows can see, and this rank's share of them.
  // The offset is read from the device; without a window the rank's first
  // tile does not depend on it, so that tile is requested while the
  // offset's load is still in flight
  const int q_offset = __ldg(q_off);
  const int n_tiles = (Skv + KT - 1) / KT;
  int t_begin = 0;
  if (window > 0) {
    const int first = q_offset + q0 - window + 1;  // the first key row q0 can see
    t_begin = first <= 0 ? 0 : min(n_tiles, first / KT);
  }
  const int t_first = t_begin + ((rank - t_begin % split) % split + split) % split;

  auto issue = [&](int i) {             // the rank's i-th tile into stage i % 2
    bf16* ks = ring + (i % KV_STAGES) * 2 * TILE;
    const int key0 = (t_first + i * split) * KT;
    for (int c = tid; c < KT * (D / 8); c += nthreads) {
      const int r = c / (D / 8), cc = c % (D / 8);
      const bool in = key0 + r < Skv;
      const size_t off = in ? (size_t)(key0 + r) * D + cc * 8 : 0;
      cp_async_16(ks + (r * KS + cc) * 8, k + off, in ? 16 : 0);
      cp_async_16(ks + TILE + (r * KS + cc) * 8, v + off, in ? 16 : 0);
    }
    cp_async_commit();
  };
  const bool early = window <= 0 && t_first < n_tiles;
  if (early) issue(0);

  const int pos_hi = q_offset + min(q0 + 16 * wr, Sq) - 1;
  int t_end = n_tiles;
  if (causal) t_end = pos_hi < 0 ? 0 : min(n_tiles, pos_hi / KT + 1);
  const int my_n = t_first < t_end ? (t_end - 1 - t_first) / split + 1 : 0;
  if (!early && my_n > 0) issue(0);
  if (early && my_n == 0) cp_async_wait<0>();   // a tile the rank does not use

  // Q fragments of the warp's 16 rows (zeros past Sq), loaded once (head
  // dim > 128: staged in the warp's own rows of shared memory instead)
  unsigned qf[QSMEM ? 1 : DK][4];
  bf16* qs = qstage + warp * 16 * KS * 8;
  if constexpr (QSMEM) {
    for (int c = lane; c < 16 * (D / 8); c += 32) {
      const int row = c / (D / 8), cc = c % (D / 8);
      *reinterpret_cast<uint4*>(qs + (row * KS + cc) * 8) =
          r0 + row < Sq ? *reinterpret_cast<const uint4*>(q + (size_t)(r0 + row) * D + cc * 8)
                        : make_uint4(0u, 0u, 0u, 0u);
    }
    __syncwarp();
  } else {
#pragma unroll
    for (int kk = 0; kk < DK; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + g + 8 * (i & 1), col = kk * 16 + 2 * t4 + 8 * (i >> 1);
        qf[kk][i] = row < Sq && !(K8 && i >= 2)   // k8: a0, a1 only
                        ? *reinterpret_cast<const unsigned*>(q + (size_t)row * D + col)
                        : 0u;
      }
  }

  // per lane: rows g and g + 8 of the warp's 16 (index r), log2-domain max
  // m, partial row sum l over the lane's columns (summed over the quad at
  // the end), and output columns 8 nt + 2 t4 (+1)
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float o[NO][4];
#pragma unroll
  for (int nt = 0; nt < NO; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[nt][i] = 0.f;
  const int qpos[2] = {q_offset + r0 + g, q_offset + r0 + g + 8};
  const int mat = lane >> 3, mrow = lane & 7;   // ldmatrix: this lane's tile and row

  for (int i = 0; i < my_n; ++i) {
    if (i + 1 < my_n) {
      issue(i + 1);
      cp_async_wait<1>();               // tile i has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = ring + (i % KV_STAGES) * 2 * TILE;
    const bf16* vs = ks + TILE;
    const int key0 = (t_first + i * split) * KT;

    float s[NS][4];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    if constexpr (K8) {
#pragma unroll
      for (int nf = 0; nf < NS / 4; ++nf) {   // 32 keys: four score tiles
        unsigned b[4];
        ldsm_x4(b, ks + (nf * 32 + mat * 8 + mrow) * KS * 8);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16_k8(s[4 * nf + j], qf[0], b + j);
      }
    }
#pragma unroll
    for (int kk = 0; kk < (K8 ? 0 : DK); ++kk) {
      unsigned qa[4];                   // QSMEM: A fragment, rows (mat & 1) 8 + mrow, k half mat >> 1
      if constexpr (QSMEM) ldsm_x4(qa, qs + (((mat & 1) * 8 + mrow) * KS + kk * 2 + (mat >> 1)) * 8);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {   // 16 keys: two score tiles
        unsigned b[4];
        ldsm_x4(b, ks + ((np * 16 + (mat >> 1) * 8 + mrow) * KS + kk * 2 + (mat & 1)) * 8);
        if constexpr (QSMEM) {
          mma_bf16(s[2 * np], qa, b);
          mma_bf16(s[2 * np + 1], qa, b + 2);
        } else {
          mma_bf16(s[2 * np], qf[kk], b);
          mma_bf16(s[2 * np + 1], qf[kk], b + 2);
        }
      }
    }

    // mask, running max, correction
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + nt * 8 + 2 * t4 + (e & 1);
        const int qp = qpos[e >> 1];
        const bool ok = key < Skv && (!causal || key <= qp) && (window <= 0 || key > qp - window);
        s[nt][e] = ok ? s[nt][e] * scale_log2 : NEG;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m[r] - mx[r]);    // 1 while both are NEG: l and o are 0 then
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
    // p in float32 (masked: 0, never exp(NEG - NEG)); l sums it unrounded
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = s[nt][e] <= NEG ? 0.f : exp2f(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        l[e >> 1] += p;
      }
    // O += bf16(P) V, 16 keys per step
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      unsigned a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      if constexpr (K8) {               // 8 output columns: one tile
        unsigned b[2];
        ldsm_x2_trans(b, vs + (kk * 16 + (mat & 1) * 8 + mrow) * KS * 8);
        mma_bf16(o[0], a, b);
      }
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {   // 16 output columns: two tiles
        unsigned b[4];
        ldsm_x4_trans(b, vs + ((kk * 16 + (mat & 1) * 8 + mrow) * KS + dp * 2 + (mat >> 1)) * 8);
        mma_bf16(o[2 * dp], a, b);
        mma_bf16(o[2 * dp + 1], a, b + 2);
      }
    }
    __syncthreads();                    // every warp is done with this stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (split == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + 8 * r;
      if (row >= Sq) continue;
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
      bf16* dst = O + ((size_t)h * Sq + row) * D + 2 * t4;
#pragma unroll
      for (int nt = 0; nt < NO; ++nt)
        *reinterpret_cast<unsigned*>(dst + nt * 8) =
            pack_bf16(o[nt][2 * r] * inv, o[nt][2 * r + 1] * inv);
    }
    return;
  }

  // split > 1: block row e (warp w's rows are 16 w .. 16 w + 15) belongs to
  // rank e / rp.  Each rank stores its unnormalised rows and their (m, l)
  // into the owner's inbox, slot `rank`.
  const int rp = rows_per(wq, split);
  const int slot = rp * (D + 2);
  cg::cluster_group cluster = cg::this_cluster();
  cluster_wait();                       // every block of the cluster has started
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r;
    const int owner = row / rp;
    float* dst = cluster.map_shared_rank(inbox, owner) + rank * slot + (row - owner * rp) * (D + 2);
#pragma unroll
    for (int nt = 0; nt < NO; ++nt)
      *reinterpret_cast<float2*>(dst + nt * 8 + 2 * t4) = make_float2(o[nt][2 * r], o[nt][2 * r + 1]);
    if (t4 == 0) {
      dst[D] = m[r];
      dst[D + 1] = l[r];
    }
  }
  cluster_arrive();
  cluster_wait();                       // every partial has arrived
  float* wts = inbox + split * slot;    // [rp][split] weights, then [rp] 1 / L
  for (int e = tid; e < rp; e += nthreads) {
    float M = NEG;
    for (int j = 0; j < split; ++j) M = fmaxf(M, inbox[j * slot + e * (D + 2) + D]);
    float L = 0.f;
    for (int j = 0; j < split; ++j) {
      const float mj = inbox[j * slot + e * (D + 2) + D];
      const float w = mj <= NEG ? 0.f : exp2f(mj - M);
      wts[e * split + j] = w;
      L += w * inbox[j * slot + e * (D + 2) + D + 1];
    }
    wts[rp * split + e] = L > 0.f ? 1.f / L : 0.f;
  }
  __syncthreads();
  if constexpr (!GROUPED) {             // one head: block row e is query row q0 + e
    const int rows_mine = min(rp, min(16 * wq, Sq - q0) - rank * rp);
    for (int e = tid; e < rows_mine * D; e += nthreads) {
      const int ro = e / D, d = e % D;
      float acc = 0.f;
      for (int j = 0; j < split; ++j) acc += wts[ro * split + j] * inbox[j * slot + ro * (D + 2) + d];
      O[((size_t)h * Sq + q0 + rank * rp + ro) * D + d] =
          __float2bfloat16_rn(acc * wts[rp * split + ro]);
    }
    return;
  }
  // The rank's rows are block rows br = rank rp + ro: q head h0 + br / (16
  // wr), query row q0 + br % (16 wr).  A thread walks its rows in order and
  // steps (head, row) along, so the loop divides by nothing at run time: in
  // a call this small, with two or four warps on an SM, each such division
  // per element cost ~0.1 us (scripts/torch_kernel_ab.py, H100).  With
  // nthreads a multiple of D
  // above it, a pass covers nthreads / D rows at one column a thread.
  const int rows_h = 16 * wr;           // block rows of one q head
  const bool multi = nthreads > D && nthreads % D == 0;
  const int step = multi ? nthreads / D : 1, ro0 = multi ? tid / D : 0;
  const int col = multi ? tid % D : tid;
  int hq = h0 + (rank * rp + ro0) / rows_h, row = q0 + (rank * rp + ro0) % rows_h;
  for (int ro = ro0; ro < rp; ro += step) {
    if (row < Sq) {
      bf16* dst = O + ((size_t)hq * Sq + row) * D;
      for (int d = col; d < D; d += nthreads) {
        float acc = 0.f;
        for (int j = 0; j < split; ++j) acc += wts[ro * split + j] * inbox[j * slot + ro * (D + 2) + d];
        dst[d] = __float2bfloat16_rn(acc * wts[rp * split + ro]);
      }
    }
    row += step;
    if (row >= q0 + rows_h) {           // step <= 16 <= rows_h: one wrap at most
      row -= rows_h;
      ++hq;
    }
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, int H, int R, int Sq,
               int Skv, const int* q_offset, int causal, int window, float scale, int wq,
               int split, int smem, cudaStream_t stream) {
  const bool grouped = R > 1;
  auto kernel = grouped ? flash_mma_kernel<D, true> : flash_mma_kernel<D, false>;
  static int granted[2] = {48 * 1024, 48 * 1024};  // dynamic shared memory allowed so far
  if (smem > granted[grouped]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    granted[grouped] = smem;
  }
  const int rb = heads_per_block(R), wr = wq / rb;
  const int row_tiles = (Sq + 16 * wr - 1) / (16 * wr);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, H / rb * row_tiles, 1);
  cfg.blockDim = dim3(wq * 32, 1, 1);
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
  cudaLaunchKernelEx(&cfg, kernel, (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, Sq,
                     Skv, q_offset, causal, window, scale_log2, R, rb, wr, split, row_tiles);
  return (int)cudaGetLastError();
}

// ------------------------------------------------ float32: CUDA cores
constexpr int BQ = 16;        // query rows per block
constexpr int NW = 4;         // warps per block
constexpr int ROWS = BQ / NW; // query rows per warp

template <int D>
__global__ void __launch_bounds__(NW * 32)
flash_simt_kernel(const float* __restrict__ Q, const float* __restrict__ K,
                  const float* __restrict__ V, float* __restrict__ O, int Sq, int Skv,
                  const int* __restrict__ q_off, int causal, int window, float scale, int R) {
  constexpr int BKV = D <= 64 ? 64 : 32;  // keys per tile
  constexpr int KPL = BKV / 32;           // keys per lane
  constexpr int DPL = (D + 31) / 32;      // output columns per lane (D 8: lanes 0-7)
  constexpr bool DYN = D > 128;           // tiles past static shared memory's 48 KB
  // Qs [BQ][D], Ks [BKV][D + 1] (+1: lanes read different rows), Vs [BKV][D]
  __shared__ float st_smem[DYN ? 1 : BQ * D + BKV * (D + 1) + BKV * D];
  extern __shared__ float dyn_smem[];
  float* base = DYN ? dyn_smem : st_smem;
  auto Qs = reinterpret_cast<float (*)[D]>(base);
  auto Ks = reinterpret_cast<float (*)[D + 1]>(base + BQ * D);
  auto Vs = reinterpret_cast<float (*)[D]>(base + BQ * D + BKV * (D + 1));

  const int h = blockIdx.y;             // q head h reads kv head h / R
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool col_ok = D >= 32 || lane < D;   // the lane holds output columns
  const int col0 = col_ok ? lane : 0;
  const float* q = Q + (size_t)h * Sq * D;
  const float* k = K + (size_t)(h / R) * Skv * D;
  const float* v = V + (size_t)(h / R) * Skv * D;
  float* o = O + (size_t)h * Sq * D;

  for (int i = threadIdx.x; i < BQ * D; i += NW * 32) {
    const int r = i / D, d = i % D;
    Qs[r][d] = (q0 + r < Sq) ? q[(size_t)(q0 + r) * D + d] : 0.f;
  }

  // kv tiles this block's rows can see
  const int q_offset = *q_off;
  const int q_rows = min(BQ, Sq - q0);
  const int pos_lo = q_offset + q0;
  const int pos_hi = q_offset + q0 + q_rows - 1;
  const int n_tiles = (Skv + BKV - 1) / BKV;
  int t_end = n_tiles;
  if (causal) t_end = pos_hi < 0 ? 0 : min(n_tiles, pos_hi / BKV + 1);
  int t_begin = 0;
  if (window > 0) {
    const int first = pos_lo - window + 1;      // first key row lo can see
    t_begin = first <= 0 ? 0 : first / BKV;
  }

  float m[ROWS], l[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BKV;
    __syncthreads();                            // previous tile fully consumed
    for (int i = threadIdx.x; i < BKV * D; i += NW * 32) {
      const int j = i / D, d = i % D;
      const bool in = k0 + j < Skv;
      Ks[j][d] = in ? k[(size_t)(k0 + j) * D + d] : 0.f;
      Vs[j][d] = in ? v[(size_t)(k0 + j) * D + d] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int row = warp * ROWS + r;
      if (q0 + row >= Sq) break;                // uniform across the warp
      const int qpos = q_offset + q0 + row;
      float s[KPL];
      bool ok[KPL];
      float tile_max = NEG;
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) {
        const int j = lane + 32 * kk;
        const int kpos = k0 + j;
        ok[kk] = kpos < Skv && (!causal || kpos <= qpos) &&
                 (window <= 0 || kpos > qpos - window);
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot = fmaf(Qs[row][d], Ks[j][d], dot);
        s[kk] = ok[kk] ? dot * scale : NEG;
        tile_max = fmaxf(tile_max, s[kk]);
      }
      tile_max = warp_max(tile_max);
      const float m_new = fmaxf(m[r], tile_max);
      const float corr = expf(m[r] - m_new);
      float p[KPL];
      float psum = 0.f;
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) {
        p[kk] = ok[kk] ? expf(s[kk] - m_new) : 0.f;
        psum += p[kk];
      }
      l[r] = l[r] * corr + warp_sum(psum);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[r][c] *= corr;
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) {
#pragma unroll 8
        for (int src = 0; src < 32; ++src) {
          const float pj = __shfl_sync(0xffffffffu, p[kk], src);
          const int j = src + 32 * kk;
#pragma unroll
          for (int c = 0; c < DPL; ++c) acc[r][c] = fmaf(pj, Vs[j][col0 + 32 * c], acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = warp * ROWS + r;
    if (q0 + row >= Sq) break;
    const float inv = 1.f / fmaxf(l[r], 1e-20f);
    if (!col_ok) continue;
#pragma unroll
    for (int c = 0; c < DPL; ++c)
      o[(size_t)(q0 + row) * D + lane + 32 * c] = acc[r][c] * inv;
  }
}

template <int D>
int launch_simt(const void* q, const void* k, const void* v, void* o, int H, int R, int Sq,
                int Skv, const int* q_offset, int causal, int window, float scale,
                cudaStream_t stream) {
  dim3 grid((Sq + BQ - 1) / BQ, H);
  constexpr int BKV = D <= 64 ? 64 : 32;
  const int dyn = D > 128 ? (BQ * D + BKV * (2 * D + 1)) * 4 : 0;
  if (dyn > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_simt_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (e != cudaSuccess) return (int)e;
  }
  flash_simt_kernel<D><<<grid, NW * 32, dyn, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, Sq, Skv, q_offset, causal,
      window, scale, R);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch of the plan kernels/flash_attention.py::plan chose.  H q heads
// over H / R kv heads (R >= 1, H % R == 0).  dtype: 0 = float32 (CUDA
// cores: wq 4, split 1, smem 0), 1 = bfloat16 (tensor cores: wq = rb
// row_warps(Sq, rb) warps of 16 rows, rb = heads_per_block(R), split 1, 2,
// 4 or 8, smem as smem_bytes(); q, k, v 16-byte aligned).  head_dim D in {8, 32, 64,
// 128, 256}.  All
// tensors contiguous row-major; q_offset points at one int32 on the device.
// Returns a CUDA error code: a plan that does not fit the shape is
// cudaErrorInvalidValue, never a launch.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int H, int R, int Sq, int Skv, int D, const int* q_offset,
                                     int causal, int window, float scale, int dtype,
                                     int wq, int split, int smem, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (H <= 0 || Sq <= 0 || Skv < 0 || (D != 8 && D != 32 && D != 64 && D != 128 && D != 256) ||
      q_offset == nullptr || R < 1 || H % R)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (wq != NW || split != 1 || smem != 0) return (int)cudaErrorInvalidValue;
    switch (D) {
      case 8:
        return launch_simt<8>(q, k, v, o, H, R, Sq, Skv, q_offset, causal, window, scale, s);
      case 32:
        return launch_simt<32>(q, k, v, o, H, R, Sq, Skv, q_offset, causal, window, scale, s);
      case 64:
        return launch_simt<64>(q, k, v, o, H, R, Sq, Skv, q_offset, causal, window, scale, s);
      case 128:
        return launch_simt<128>(q, k, v, o, H, R, Sq, Skv, q_offset, causal, window, scale, s);
      default:
        return launch_simt<256>(q, k, v, o, H, R, Sq, Skv, q_offset, causal, window, scale, s);
    }
  }
  const int rb = heads_per_block(R), wr = row_warps(Sq, rb);
  if (dtype != 1 || wq != rb * wr || split < 1 || split > 8 || (split & (split - 1)) ||
      smem != smem_bytes(D, wq, split) ||
      (long long)(H / rb) * ((Sq + 16 * wr - 1) / (16 * wr)) > 65535)
    return (int)cudaErrorInvalidValue;
  switch (D) {
    case 8:
      return launch_mma<8>(q, k, v, o, H, R, Sq, Skv, q_offset, causal, window, scale, wq, split,
                           smem, s);
    case 32:
      return launch_mma<32>(q, k, v, o, H, R, Sq, Skv, q_offset, causal, window, scale, wq, split,
                            smem, s);
    case 64:
      return launch_mma<64>(q, k, v, o, H, R, Sq, Skv, q_offset, causal, window, scale, wq, split,
                            smem, s);
    case 128:
      return launch_mma<128>(q, k, v, o, H, R, Sq, Skv, q_offset, causal, window, scale, wq, split,
                             smem, s);
    default:
      return launch_mma<256>(q, k, v, o, H, R, Sq, Skv, q_offset, causal, window, scale, wq, split,
                             smem, s);
  }
}
