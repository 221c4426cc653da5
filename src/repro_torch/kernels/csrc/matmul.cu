// Matrix product for Hopper: C (M, N) = A (M, K) @ B, float32 accumulator,
// rounded once to A's dtype (float32 or bfloat16).  B is (K, N) row-major,
// or (N, K) row-major with trans_b (the tied LM head reads the embedding
// table as it is stored, so the table is never transposed).
//
// Replaces: src/repro/kernels/matmul.py:36 matmul (_matmul_kernel,
//   pallas_call at :45).  The Pallas kernel walks K on its sequential grid
//   axis into a float32 VMEM accumulator and needs dividing blocks; here K
//   is split over the blocks of a cluster, and M, N and K edges are masked.
//
// Bound on this card.  Every main-path shape is memory-bound: M rows (8 in
//   a decode tick, 32 in a paged prefill chunk, 40 in a k=4 verify tick,
//   16-160 in a whole-prompt prefill) against a K x N bf16 weight do M
//   operations per weight byte, far under the ~295 at which bf16 turns
//   compute-bound on the H100.  The least time is reading the weight once
//   at 3.35 TB/s:
//     tinyllama-42m  512 x 512 (q, k, v, o)        0.52 MB   0.16 us
//                    512 x 2048, 2048 x 512 (FFN)  2.1 MB    0.63 us
//                    LM head 32000 x 512 (NT)      32.8 MB   9.8 us
//     mamba2-370m    1024 x 32, 1024 x 128         66, 262 KB: launch latency
//                    1024 x 2048, 2048 x 1024      4.2 MB    1.25 us
//                    LM head 50280 x 1024 (NT)     103 MB    30.7 us
//
// Design of the bfloat16 kernel, and what each choice does about that bound:
//  - Tensor cores through mma.sync m16n8k16 (bf16 in, float32 accumulate),
//    the weight in the 16-row operand and the activation rows in the 8-wide
//    one ("swap AB": C^T = B^T A^T).  A decode tick's 8 rows fill one
//    instruction, 32 or 40 rows four or five.  mma.sync, not wgmma: every
//    shape is memory-bound, so wgmma's higher rate buys nothing, while its
//    64-row warpgroup tiles would cut the number of blocks the skinny
//    shapes need.  Up to 16 activation rows sum odd and even k steps into
//    two accumulator sets, added at the end: two dependent mma chains.
//  - Operands through ldmatrix: the (N, K) weight as stored, the (K, N)
//    weight with ldmatrix.trans, the activations (M, K) as stored.  Shared
//    tiles stay bf16; the weight's are XOR-swizzled in 16-byte chunks and
//    the activations' rows padded to an odd count of chunks, so each
//    ldmatrix phase reads eight distinct bank groups.
//  - The weight streams through a ring in shared memory, 16-byte cp.async
//    copies that skip L1 and zero-fill past the edges.  A (K, N) weight
//    streams K pieces of 8 KB (BN columns x 4096 / BN rows), up to 6 of them,
//    5 ahead of the one being read.  An (N, K) weight, the tied LM heads,
//    streams whole output tiles: BN rows of the block's K range are one
//    contiguous run of memory, which L2 serves faster than the same bytes
//    cut into per-row K slices; 4 tiles of up to 16 KB or 2 larger
//    ones sit in the ring.  A block's tile holds at most 32 KB of weights.
//  - The activation slice (the block's rows of M over its K range) is
//    copied once per block, with the first weight copy, through L1
//    (cp.async.ca): every block of an SM reads the same bytes, and through
//    L2 alone hundreds of blocks asking for the same few lines at once
//    slow the weight stream behind them.  M above 64 is tiled over grid y.
//  - Enough blocks, in one launch.  A weight of 2 MB or more runs on at
//    least 132 blocks, a smaller one on a block per 16 KB.  Where the
//    column tiles alone give fewer, K is split over the S <= 8 blocks of a
//    thread-block cluster (grid x = N tiles x S, cluster (S, 1, 1)); where
//    they give more than stay resident (the heads), each block walks
//    several tiles and its ring streams on across them.  Inside a block
//    the four warps take 16-column slabs and, when BN < 64, halves or
//    quarters of each piece's K; those warps hand their float32 sums to
//    warp 0 of the slab through shared memory.  Split blocks sum through
//    distributed shared memory: each stores its part of every element into
//    the owner block's inbox, and after a cluster barrier the owner adds
//    them in rank order.  No workspace, no second kernel, no atomics: the
//    result is bitwise the same from run to run.
//  - Ragged edges: rows past M, columns past N and K past its end are
//    zero-filled at load and masked at store.  With K % 8 == 0 (and N % 8
//    == 0 for a (K, N) weight) every 16-byte chunk lies wholly inside or
//    outside and goes through cp.async (`vec`); otherwise the same kernel
//    gathers each chunk element by element.  The wrapper refuses operands
//    that are not 16-byte aligned.
//
// float32 keeps a CUDA-core kernel in full float32, on purpose (TF32 would
// break the fp32 tolerance and the parity phases' token identity): one
// block per 32 x 64 or 64 x 64 output tile, K walked in 16-wide steps.
//
// kernels/matmul.py::plan chooses every launch (tile, split, grid, shared
// memory) in Python; the entry point checks the plan against the shape.
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
using repro::cp_async_wait_upto;
using repro::ldsm_x2;
using repro::ldsm_x4;
using repro::ldsm_x4_trans;
using repro::mma_bf16;
using repro::swz;
using repro::swz_row;

// ------------------------------------------------- bfloat16: tensor cores
constexpr int THREADS = 128;    // four warps
constexpr int STAGE = 4096;     // weight elements per ring piece (8 KB)
constexpr int STAGES = 6;       // ring depth of a (K, N) weight, in pieces

// 8 bfloat16 of a row into shared memory: `avail` of them (0..8) lie inside
// the matrix, the rest are zeros.  `vec`: the chunk is 16-byte aligned and
// wholly inside or outside, so one cp.async copies (or zero-fills) it,
// through L2 only (CA false: a weight is read once) or L1 too (CA: every
// block of an SM reads the same activations).
template <bool CA = false>
__device__ __forceinline__ void load_chunk(bf16* dst, const bf16* src, int avail,
                                           bool vec, const bf16* base) {
  if (vec) {
    cp_async_16<CA>(dst, avail > 0 ? src : base, avail > 0 ? 16 : 0);
    return;
  }
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned lo = 2 * i < avail ? s[2 * i] : 0u;
    const unsigned hi = 2 * i + 1 < avail ? s[2 * i + 1] : 0u;
    w[i] = lo | (hi << 16);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Geometry of a launch, shared by the kernel and the host check; mirrored
// by kernels/matmul.py (_smem_bytes).  BN weight columns per block: 16,
// 32 or 64, one 16-column slab per warp; with BN < 64 the warps of a slab
// split each piece's K in 4 or 2.
__host__ __device__ constexpr int warps_k(int bn) { return 64 / bn; }
// activation row stride in 16-byte chunks: odd, so 8 rows at one chunk
// column fall in 8 distinct bank groups
__host__ __device__ constexpr int a_stride(int kt, int bn) {
  return (kt * (STAGE / bn) / 8) | 1;
}
// The ring, in 8 KB pieces, for a block that streams `tiles` output tiles
// of kt pieces each: a (K, N) weight streams K pieces of BN x BK, up to
// STAGES at a time; an (N, K) weight streams whole tiles (BN rows of the
// block's K range, contiguous in memory), 4 of up to 16 KB or 2 larger
// ones at a time.
__host__ __device__ constexpr int ring_tiles(int kt, int tiles) {
  const int rt = kt <= 2 ? 4 : 2;
  return tiles < rt ? tiles : rt;
}
__host__ __device__ constexpr int ring_pieces(bool trans_b, int kt, int tiles) {
  return trans_b ? ring_tiles(kt, tiles) * kt : (kt * tiles < STAGES ? kt * tiles : STAGES);
}
__host__ __device__ constexpr int red_floats(int bn, int bm, int split) {
  return (warps_k(bn) > 1 || split > 1) ? warps_k(bn) * bm * bn : 0;
}
__host__ __device__ constexpr int inbox_per(int bn, int bm, int split) {
  return (bm * bn + split - 1) / split;
}
__host__ __device__ constexpr int smem_bytes(bool trans_b, int bn, int bm, int kt, int split,
                                             int tiles) {
  return ring_pieces(trans_b, kt, tiles) * STAGE * 2 + red_floats(bn, bm, split) * 4 +
         (split > 1 ? split * inbox_per(bn, bm, split) * 4 : 0) + bm * a_stride(kt, bn) * 16;
}

// One launch.  Grid (grid_n x split, m tiles), cluster (split, 1, 1).  The
// `split` blocks of a cluster share one BN-column tile and take consecutive
// K ranges of kt pieces each; with split == 1 a block walks the column
// tiles blockIdx.x, + grid_n, ... (persistent), its activation slice
// loaded once and its ring streaming on across tile boundaries.
template <int BN, int MG, bool TRANS_B>
__global__ void __launch_bounds__(THREADS, 4)
matmul_mma_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W, bf16* __restrict__ C,
                  int M, int N, int K, int bm, int split, int kt, int vec) {
  constexpr int WN = BN / 16;             // warps across the columns
  constexpr int WK = 4 / WN;              // warps across a piece's K rows
  constexpr int BK = STAGE / BN;          // K rows per piece: 256, 128 or 64
  constexpr int KW = BK / WK;             // K rows per warp per piece: 64
  static_assert(WN * WK == 4 && KW % 16 == 0, "four warps cover a piece");
  extern __shared__ __align__(16) unsigned char smem[];
  const int grid_n = gridDim.x / split;
  const int n_tiles = (N + BN - 1) / BN;
  const int max_tiles = (n_tiles + grid_n - 1) / grid_n;
  const int KS = kt * BK;                 // the K range of one block
  const int astr = a_stride(kt, BN);
  const int per = inbox_per(BN, bm, split);
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* red = reinterpret_cast<float*>(smem + ring_pieces(TRANS_B, kt, max_tiles) * STAGE * 2);
  float* inbox = red + red_floats(BN, bm, split);
  bf16* As = reinterpret_cast<bf16*>(inbox + (split > 1 ? split * per : 0));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wn = warp % WN, wk = warp / WN;
  const int rank = blockIdx.x % split;    // the block's rank in its cluster
  const int first = blockIdx.x / split;
  const int my_tiles = first < n_tiles ? (n_tiles - 1 - first) / grid_n + 1 : 0;
  const int m0 = blockIdx.y * bm;
  const int rows = min(bm, M - m0);
  const int mgv = (rows + 7) / 8;         // 8-row groups holding a valid row
  const int k_begin = rank * KS;
  const bool v = vec != 0;
  if (split > 1) cluster_arrive();        // this block has started

  // the activation slice (only the groups that hold a row), with the first
  // commit group of the weight
  for (int i = tid; i < mgv * 8 * (KS / 8); i += THREADS) {
    const int r = i / (KS / 8), c = i % (KS / 8);
    const int gm = m0 + r, gk = k_begin + c * 8;
    const int avail = gm < M ? max(0, min(8, K - gk)) : 0;
    load_chunk<true>(As + (r * astr + c) * 8, A + (size_t)gm * K + gk, avail, v, A);
  }
  // activation fragments: group 0 at the block's first K row (+ 8 rows per
  // group, + 16 of K per k step, + BK per piece)
  const bf16* abase = As + ((lane & 7) * astr + wk * KW / 8 + ((lane >> 3) & 1)) * 8;
  const int agroup = 8 * astr * 8;

  // With few accumulators, odd and even k steps sum into two sets, added
  // at the end (a fixed order): two dependent mma chains instead of one.
  constexpr int SETS = MG <= 2 ? 2 : 1;
  float acc[SETS][MG][4];
  auto zero = [&]() {
#pragma unroll
    for (int q = 0; q < SETS; ++q)
#pragma unroll
      for (int g = 0; g < MG; ++g)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[q][g][i] = 0.f;
  };
  // 16 of K at k step j of piece t: the caller loads the weight fragment
  // a; the activation rows of every valid group multiply it
  auto mma_step = [&](const unsigned (&a)[4], int t, int j) {
    const bf16* as = abase + t * BK + 16 * j;
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      if (g < mgv) {
        unsigned b[2];
        ldsm_x2(b, as + g * agroup);
        mma_bf16(acc[j % SETS][g], a, b);
      }
    }
  };

  // The epilogue of one output tile.  Accumulator element i of a lane:
  // column wn * 16 + lane / 4 + 8 * (i / 2) of the tile, activation row
  // g * 8 + 2 * (lane % 4) + i % 2.
  auto finish = [&](int n0) {
    if (SETS == 2) {
#pragma unroll
      for (int g = 0; g < MG; ++g)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[0][g][i] += acc[SETS - 1][g][i];
    }
    const int cl = lane >> 2, rl = 2 * (lane & 3);
    if (split == 1) {
      if (WK > 1) {                       // warps 1.. of a K split hand their sums
        if (wk > 0) {                     // to warp 0 of their column slab
          float* mine = red + (wk - 1) * bm * BN;
#pragma unroll
          for (int g = 0; g < MG; ++g) {
            if (g >= mgv) continue;
            const int n = wn * 16 + cl, m = g * 8 + rl;
#pragma unroll
            for (int i = 0; i < 4; ++i)
              mine[(m + (i & 1)) * BN + n + 8 * (i >> 1)] = acc[0][g][i];
          }
        }
        __syncthreads();
        if (wk > 0) return;
#pragma unroll
        for (int w = 1; w < WK; ++w)      // in K order
#pragma unroll
          for (int g = 0; g < MG; ++g) {
            if (g >= mgv) continue;
            const int n = wn * 16 + cl, m = g * 8 + rl;
#pragma unroll
            for (int i = 0; i < 4; ++i)
              acc[0][g][i] += red[(w - 1) * bm * BN + (m + (i & 1)) * BN + n + 8 * (i >> 1)];
          }
      }
      // one warp holds each sum: store it
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        if (g >= mgv) continue;
        const int n = n0 + wn * 16 + cl, m = m0 + g * 8 + rl;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int mi = m + (i & 1), ni = n + 8 * (i >> 1);
          if (mi < M && ni < N) C[(size_t)mi * N + ni] = __float2bfloat16_rn(acc[0][g][i]);
        }
      }
      return;
    }
    // partial tiles red[wk][m][n] of the block's bm rows and BN columns
    float* mine = red + wk * bm * BN;
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      if (g >= mgv) continue;
      const int n = wn * 16 + cl, m = g * 8 + rl;
#pragma unroll
      for (int i = 0; i < 4; ++i) mine[(m + (i & 1)) * BN + n + 8 * (i >> 1)] = acc[0][g][i];
    }
    __syncthreads();
    const int cols = min(BN, N - n0);
    // split > 1 (one tile per block): reduce-scatter through distributed
    // shared memory.  Element e of the tile belongs to block e / per; each
    // block sums its K warps and stores the result into the owner's inbox,
    // slot `rank`.  After the cluster barrier each block adds its inbox in
    // rank order: a fixed order, so the result is the same on every run.
    cg::cluster_group cluster = cg::this_cluster();
    cluster_wait();                       // every block of the cluster has started
    for (int e = tid; e < bm * BN; e += THREADS) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < WK; ++w) sum += red[w * bm * BN + e];
      const int q = e / per;
      cluster.map_shared_rank(inbox, q)[rank * per + e - q * per] = sum;
    }
    cluster_arrive();
    cluster_wait();                       // every partial has arrived
    for (int e = rank * per + tid; e < min(rows * BN, (rank + 1) * per); e += THREADS) {
      const int m = e / BN, n = e % BN;
      if (n >= cols) continue;
      float sum = 0.f;
      for (int r = 0; r < split; ++r) sum += inbox[r * per + e - rank * per];
      C[(size_t)(m0 + m) * N + n0 + n] = __float2bfloat16_rn(sum);
    }
  };

  if constexpr (TRANS_B) {
    // (N, K) weight: each output tile is BN rows of the block's K range,
    // one contiguous run of memory when split == 1; it is copied whole, in
    // its memory order, into a ring of `rt` tiles, one commit group each,
    // and read once it has landed.  Rows hold cpr 16-byte chunks (a
    // multiple of 8), XOR-swizzled by row.
    const int cpr = KS / 8;
    const int rt = ring_tiles(kt, max_tiles);
    const int dr = THREADS / cpr, dc = THREADS % cpr;   // a thread's step between chunks
    int issued = 0, ld_slot = 0;
    auto issue_tile = [&]() {
      const int n0 = (first + issued * grid_n) * BN;
      bf16* dst = ring + ld_slot * kt * STAGE;
      const bf16* src = W + (size_t)n0 * K + k_begin;
      int r = tid / cpr, c = tid % cpr;
      for (int i = tid; i < BN * cpr; i += THREADS) {
        const int avail = n0 + r < N ? max(0, min(8, K - (k_begin + c * 8))) : 0;
        load_chunk(dst + swz_row(r, c, cpr) * 8, src + (size_t)r * K + c * 8, avail, v, W);
        r += dr;
        c += dc;
        if (c >= cpr) {
          c -= cpr;
          ++r;
        }
      }
      cp_async_commit();
      ++issued;
      ld_slot = ld_slot + 1 == rt ? 0 : ld_slot + 1;
    };
    while (issued < min(rt, my_tiles)) issue_tile();
    int rd_slot = 0;
    for (int tile = 0; tile < my_tiles; ++tile) {
      cp_async_wait_upto(issued - tile - 1);   // this tile has landed
      __syncthreads();
      const bf16* ts = ring + rd_slot * kt * STAGE;
      zero();
#pragma unroll 4
      for (int t = 0; t < kt; ++t) {
#pragma unroll
        for (int j = 0; j < KW / 16; ++j) {
          unsigned a[4];                  // 16 weight rows x 16 of k
          const int r = wn * 16 + (lane & 15);
          const int c = t * (BK / 8) + (wk * KW + 16 * j) / 8 + (lane >> 4);
          ldsm_x4(a, ts + swz_row(r, c, cpr) * 8);
          mma_step(a, t, j);
        }
      }
      rd_slot = rd_slot + 1 == rt ? 0 : rd_slot + 1;
      if (issued < my_tiles) {
        __syncthreads();                  // every warp is done with this slot
        issue_tile();
      }
      finish((first + tile * grid_n) * BN);
    }
  } else {
    // (K, N) weight: K pieces of BN columns x BK rows stream through a ring
    // of up to STAGES, STAGES - 1 ahead of the one being read, one commit
    // group each.  Each thread copies CPT chunks of a piece, all in chunk
    // column lc of stored rows lr, lr + DR, ...: their shared offsets are
    // fixed, their sources advance by BK rows per piece and are set anew
    // per tile.
    constexpr int CPR = BN / 8;           // chunks per stored row of a piece
    constexpr int CPT = STAGE / 8 / THREADS;
    constexpr int DR = THREADS / CPR;
    const int total = my_tiles * kt;      // pieces this block streams
    const int lc = tid % CPR, lr = tid / CPR;
    int soff[CPT];
#pragma unroll
    for (int p = 0; p < CPT; ++p) soff[p] = swz<CPR>(lr + p * DR, lc) * 8;
    int ld_tile = 0, ld_t = 0, ld_slot = 0, s_next = 0;
    int cavail = 0;                       // elements of the thread's column chunk inside
    const bf16* lsrc = W;
    auto set_tile = [&](int tile) {
      const int n0 = (first + tile * grid_n) * BN;
      cavail = max(0, min(8, N - (n0 + lc * 8)));
      lsrc = W + (size_t)(k_begin + lr) * N + n0 + lc * 8;
    };
    if (total > 0) set_tile(0);
    auto issue = [&]() {
      if (s_next < total) {
        bf16* dst = ring + ld_slot * STAGE;
        const int k0 = k_begin + ld_t * BK;
        const bf16* src = lsrc + (size_t)ld_t * BK * N;
#pragma unroll
        for (int p = 0; p < CPT; ++p)
          load_chunk(dst + soff[p], src + (size_t)p * DR * N,
                     k0 + lr + p * DR < K ? cavail : 0, v, W);
        if (++ld_t == kt) {
          ld_t = 0;
          if (++ld_tile < my_tiles) set_tile(ld_tile);
        }
      }
      cp_async_commit();                  // empty groups keep the count uniform
      ++s_next;
      ld_slot = ld_slot == STAGES - 1 ? 0 : ld_slot + 1;
    };
#pragma unroll
    for (int p = 0; p < STAGES - 1; ++p) issue();

    int woff[KW / 16];                    // weight fragments within a piece
#pragma unroll
    for (int j = 0; j < KW / 16; ++j) {
      const int mat = lane >> 3;
      woff[j] = swz<CPR>(wk * KW + 16 * j + (mat >> 1) * 8 + (lane & 7), wn * 2 + (mat & 1)) * 8;
    }
    int rd_slot = 0;
    for (int tile = 0; tile < my_tiles; ++tile) {
      zero();
      for (int t = 0; t < kt; ++t) {
        cp_async_wait<STAGES - 2>();      // this piece has landed ...
        __syncthreads();                  // ... and every warp is done with the last
        issue();                          // STAGES - 1 ahead, into the last one's slot
        const bf16* ws = ring + rd_slot * STAGE;
#pragma unroll
        for (int j = 0; j < KW / 16; ++j) {
          unsigned a[4];                  // 16 weight columns x 16 of k
          ldsm_x4_trans(a, ws + woff[j]);
          mma_step(a, t, j);
        }
        rd_slot = rd_slot == STAGES - 1 ? 0 : rd_slot + 1;
      }
      finish((first + tile * grid_n) * BN);
    }
  }
}

template <int BN, int MG, bool TRANS_B>
int launch_mma(const void* a, const void* b, void* c, int M, int N, int K, int bm, int split,
               int grid_n, int kt, int smem, int vec, cudaStream_t stream) {
  auto kernel = matmul_mma_kernel<BN, MG, TRANS_B>;
  static int granted = 48 * 1024;         // dynamic shared memory allowed so far
  if (smem > granted) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    granted = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_n * split, (M + bm - 1) / bm, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  cudaLaunchKernelEx(&cfg, kernel, (const bf16*)a, (const bf16*)b, (bf16*)c, M, N, K, bm,
                     split, kt, vec);
  return (int)cudaGetLastError();
}

template <int BN, bool TRANS_B>
int dispatch_mg(const void* a, const void* b, void* c, int M, int N, int K, int bm, int split,
                int grid_n, int kt, int smem, int vec, cudaStream_t s) {
  if (bm <= 8)
    return launch_mma<BN, 1, TRANS_B>(a, b, c, M, N, K, bm, split, grid_n, kt, smem, vec, s);
  if (bm <= 16)
    return launch_mma<BN, 2, TRANS_B>(a, b, c, M, N, K, bm, split, grid_n, kt, smem, vec, s);
  if (bm <= 32)
    return launch_mma<BN, 4, TRANS_B>(a, b, c, M, N, K, bm, split, grid_n, kt, smem, vec, s);
  return launch_mma<BN, 8, TRANS_B>(a, b, c, M, N, K, bm, split, grid_n, kt, smem, vec, s);
}

template <bool TRANS_B>
int dispatch_bn(const void* a, const void* b, void* c, int M, int N, int K, int bm, int bn,
                int split, int grid_n, int kt, int smem, int vec, cudaStream_t s) {
  switch (bn) {
    case 16: return dispatch_mg<16, TRANS_B>(a, b, c, M, N, K, bm, split, grid_n, kt, smem, vec, s);
    case 32: return dispatch_mg<32, TRANS_B>(a, b, c, M, N, K, bm, split, grid_n, kt, smem, vec, s);
    case 64: return dispatch_mg<64, TRANS_B>(a, b, c, M, N, K, bm, split, grid_n, kt, smem, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ------------------------------------------------ float32: CUDA cores
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int SBK = 16;
constexpr int SBN = 64;

template <int BM, bool TRANS_B>
__global__ void __launch_bounds__((BM / TM) * (SBN / TN))
matmul_simt_kernel(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C,
                   int M, int N, int K) {
  constexpr int NT = (BM / TM) * (SBN / TN);
  __shared__ float As[SBK][BM + 4];   // As[k][m]
  __shared__ float Bs[SBK][SBN + 4];  // Bs[k][n]
  const int tid = threadIdx.x;
  const int tx = tid % (SBN / TN);
  const int ty = tid / (SBN / TN);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * SBN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += SBK) {
    for (int i = tid; i < BM * SBK; i += NT) {   // consecutive threads: consecutive k
      const int m = i / SBK, k = i % SBK;
      const int gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0.f;
    }
    for (int i = tid; i < SBK * SBN; i += NT) {
      if (TRANS_B) {                               // B is (N, K): coalesce along k
        const int n = i / SBK, k = i % SBK;
        const int gn = n0 + n, gk = k0 + k;
        Bs[k][n] = (gn < N && gk < K) ? B[(size_t)gn * K + gk] : 0.f;
      } else {                                     // B is (K, N): coalesce along n
        const int k = i / SBN, n = i % SBN;
        const int gn = n0 + n, gk = k0 + k;
        Bs[k][n] = (gn < N && gk < K) ? B[(size_t)gk * N + gn] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < SBK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[k][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[k][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < N) C[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

template <int BM>
int launch_simt(const void* a, const void* b, void* c, int M, int N, int K, int trans_b,
                cudaStream_t stream) {
  dim3 grid((N + SBN - 1) / SBN, (M + BM - 1) / BM);
  dim3 block((BM / TM) * (SBN / TN));
  if (trans_b)
    matmul_simt_kernel<BM, true><<<grid, block, 0, stream>>>(
        (const float*)a, (const float*)b, (float*)c, M, N, K);
  else
    matmul_simt_kernel<BM, false><<<grid, block, 0, stream>>>(
        (const float*)a, (const float*)b, (float*)c, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch of the plan kernels/matmul.py::plan chose.  dtype: 0 =
// float32 (CUDA cores: bm 32 or 64, bn 64, split 1, grid_n the column
// tiles, smem 0), 1 = bfloat16 (tensor cores: bm a multiple of 8 up to 64,
// bn 16, 32 or 64, split 1, 2, 4 or 8 dividing the K tiles of 4096 / bn rows,
// grid_n the column tiles with split > 1 and at most that with split 1,
// smem as smem_bytes()).  All tensors contiguous row-major; with vec,
// 16-byte aligned, K % 8 == 0 and, without trans_b, N % 8 == 0.  Returns a
// CUDA error code: a plan that does not fit the shape is
// cudaErrorInvalidValue, never a launch.
extern "C" int repro_matmul(const void* a, const void* b, void* c, int M, int N, int K,
                            int trans_b, int dtype, int bm, int bn, int split, int grid_n,
                            int smem, int vec, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (M <= 0 || N <= 0 || K < 0 || grid_n <= 0) return (int)cudaErrorInvalidValue;
  const int n_tiles = (N + bn - 1) / bn;
  if (dtype == 0) {
    if (bn != SBN || split != 1 || smem != 0 || grid_n != n_tiles)
      return (int)cudaErrorInvalidValue;
    if (bm == 32) return launch_simt<32>(a, b, c, M, N, K, trans_b, s);
    if (bm == 64) return launch_simt<64>(a, b, c, M, N, K, trans_b, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype != 1 || (bn != 16 && bn != 32 && bn != 64) || bm <= 0 || bm > 64 ||
      bm % 8 || split < 1 || split > 8 || (split & (split - 1)) || grid_n > n_tiles || (split > 1 && grid_n != n_tiles))
    return (int)cudaErrorInvalidValue;
  const int k_tiles = (K + STAGE / bn - 1) / (STAGE / bn);
  if (k_tiles % split) return (int)cudaErrorInvalidValue;
  const int kt = k_tiles / split;
  if (smem != smem_bytes(trans_b != 0, bn, bm, kt, split, (n_tiles + grid_n - 1) / grid_n))
    return (int)cudaErrorInvalidValue;
  if (trans_b)
    return dispatch_bn<true>(a, b, c, M, N, K, bm, bn, split, grid_n, kt, smem, vec, s);
  return dispatch_bn<false>(a, b, c, M, N, K, bm, bn, split, grid_n, kt, smem, vec, s);
}
