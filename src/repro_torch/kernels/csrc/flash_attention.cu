// Flash attention for Hopper: q (H, Sq, D), k/v (H, Skv, D) -> o (H, Sq, D),
// one kv head per q head.  Query row i sits at position q_offset + i, key j
// at position j; a key is valid when j < Skv, j <= q_pos (causal) and
// j > q_pos - window (window > 0).  Online softmax in float32; a row with no
// valid key gives 0.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention
//   (_flash_kernel).  The Pallas contract puts the queries at the suffix of
//   the key stream (q_offset = Skv - Sq); the prefill chunk needs them at
//   the chunk's start inside a longer gathered stream whose tail past the
//   chunk is garbage, so q_offset is an argument here.
// Bound on this card: the chunk step (Sq = 32 queries against a 256-key
//   gathered stream) reads K and V once and does ~2 * D operations per
//   (query, key) pair: few operations per byte, so bytes bound it.
// Design: one block per (head, 16-query tile), four warps of four query
//   rows each.  The block walks the kv tiles its rows can see (tiles above
//   the causal diagonal and left of the window are skipped), staging each
//   64-key tile of K and V in shared memory as float; each lane scores two
//   keys per row, and the row's running max, sum and D/32 output columns
//   per lane stay in registers.  The S x S score matrix never leaves the SM.
#include "common.cuh"

namespace {

using repro::from_float;
using repro::NEG;
using repro::to_float;
using repro::warp_max;
using repro::warp_sum;

constexpr int BQ = 16;        // query rows per block
constexpr int NW = 4;         // warps per block
constexpr int ROWS = BQ / NW; // query rows per warp

template <typename T, int D>
__global__ void __launch_bounds__(NW * 32)
flash_kernel(const T* __restrict__ Q, const T* __restrict__ K, const T* __restrict__ V,
             T* __restrict__ O, int Sq, int Skv, int q_offset, int causal, int window,
             float scale) {
  constexpr int BKV = D <= 64 ? 64 : 32;  // keys per tile
  constexpr int KPL = BKV / 32;           // keys per lane
  constexpr int DPL = D / 32;             // output columns per lane
  __shared__ float Qs[BQ][D];
  __shared__ float Ks[BKV][D + 1];        // +1: lanes read different rows
  __shared__ float Vs[BKV][D];

  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* q = Q + (size_t)h * Sq * D;
  const T* k = K + (size_t)h * Skv * D;
  const T* v = V + (size_t)h * Skv * D;
  T* o = O + (size_t)h * Sq * D;

  for (int i = threadIdx.x; i < BQ * D; i += NW * 32) {
    const int r = i / D, d = i % D;
    Qs[r][d] = (q0 + r < Sq) ? to_float(q[(size_t)(q0 + r) * D + d]) : 0.f;
  }

  // kv tiles this block's rows can see
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
      Ks[j][d] = in ? to_float(k[(size_t)(k0 + j) * D + d]) : 0.f;
      Vs[j][d] = in ? to_float(v[(size_t)(k0 + j) * D + d]) : 0.f;
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
          for (int c = 0; c < DPL; ++c) acc[r][c] = fmaf(pj, Vs[j][lane + 32 * c], acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = warp * ROWS + r;
    if (q0 + row >= Sq) break;
    const float inv = 1.f / fmaxf(l[r], 1e-20f);
#pragma unroll
    for (int c = 0; c < DPL; ++c)
      o[(size_t)(q0 + row) * D + lane + 32 * c] = from_float<T>(acc[r][c] * inv);
  }
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             int H, int Sq, int Skv, int D, int q_offset, int causal, int window,
             float scale, cudaStream_t stream) {
  dim3 grid((Sq + BQ - 1) / BQ, H);
  dim3 block(NW * 32);
  switch (D) {
    case 32:
      flash_kernel<T, 32><<<grid, block, 0, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                                      (T*)o, Sq, Skv, q_offset, causal,
                                                      window, scale);
      break;
    case 64:
      flash_kernel<T, 64><<<grid, block, 0, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                                      (T*)o, Sq, Skv, q_offset, causal,
                                                      window, scale);
      break;
    case 128:
      flash_kernel<T, 128><<<grid, block, 0, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                                       (T*)o, Sq, Skv, q_offset, causal,
                                                       window, scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim D in {32, 64, 128}.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int H, int Sq, int Skv, int D, int q_offset,
                                     int causal, int window, float scale, int dtype,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, H, Sq, Skv, D, q_offset, causal, window,
                           scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, H, Sq, Skv, D, q_offset, causal,
                                   window, scale, s);
  return (int)cudaErrorInvalidValue;
}
