// Paged decode attention for Hopper: one query per (slot, head) over the
// slot's pages.  q (B, H, D); k/v pools (n_pages, H, psz, D); block_table
// (B, n_max) int32; length (B,) int32, the count of valid tokens (the
// engine's inclusive pos + 1) -> o (B, H, D).  Online softmax in float32; a
// slot with length 0 gives 0.
//
// Replaces: src/repro/kernels/decode_attention.py::paged_decode_attention
//   (_paged_decode_kernel, float pools).
// Bound on this card: each (slot, head) reads its length x D keys and
//   values once and does ~4 operations per element read: bytes bound it.
// Design: one block per (head, slot).  The block reads its own block-table
//   row (the Pallas kernel's scalar prefetch) and loads each page's K and V
//   rows straight from the pool by page id: no gathered copy of the cache is
//   ever made, the paper's minimal off-chip traffic.  Four warps take pages
//   in turn; per token a warp forms the score with one column pair per lane
//   and a warp sum, and keeps its running max, sum and D/32 output columns
//   per lane in registers.  The warps' partial softmax states merge through
//   shared memory at the end.  Idle lanes point at scratch page 0 with
//   length 1: they read one valid row and their output is ignored.
#include "common.cuh"

namespace {

using repro::from_float;
using repro::NEG;
using repro::to_float;
using repro::warp_sum;

constexpr int NW = 4;   // warps per block

template <typename T, int D>
__global__ void __launch_bounds__(NW * 32)
paged_decode_kernel(const T* __restrict__ Q, const T* __restrict__ KP,
                    const T* __restrict__ VP, const int* __restrict__ BT,
                    const int* __restrict__ LEN, T* __restrict__ O, int H, int psz,
                    int n_max, float scale) {
  constexpr int DPL = D / 32;
  __shared__ float sm[NW], sl[NW];
  __shared__ float sacc[NW][D];
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int length = LEN[b];
  const int n_used = length <= 0 ? 0 : min((length + psz - 1) / psz, n_max);

  float q[DPL];
#pragma unroll
  for (int c = 0; c < DPL; ++c) q[c] = to_float(Q[((size_t)b * H + h) * D + lane + 32 * c]);

  float m = NEG, l = 0.f, acc[DPL];
#pragma unroll
  for (int c = 0; c < DPL; ++c) acc[c] = 0.f;

  for (int pi = warp; pi < n_used; pi += NW) {
    const size_t page = (size_t)BT[(size_t)b * n_max + pi];
    const T* kpage = KP + (page * H + h) * psz * D;
    const T* vpage = VP + (page * H + h) * psz * D;
    const int n_tok = min(psz, length - pi * psz);
    for (int t = 0; t < n_tok; ++t) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < DPL; ++c) s = fmaf(q[c], to_float(kpage[t * D + lane + 32 * c]), s);
      s = warp_sum(s) * scale;
      const float m_new = fmaxf(m, s);
      const float corr = expf(m - m_new);
      const float p = expf(s - m_new);
      l = l * corr + p;
#pragma unroll
      for (int c = 0; c < DPL; ++c)
        acc[c] = fmaf(p, to_float(vpage[t * D + lane + 32 * c]), acc[c] * corr);
      m = m_new;
    }
  }

  if (lane == 0) {
    sm[warp] = m;
    sl[warp] = l;
  }
#pragma unroll
  for (int c = 0; c < DPL; ++c) sacc[warp][lane + 32 * c] = acc[c];
  __syncthreads();
  if (warp == 0) {
    float mx = NEG;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm[w]);
    float den = 0.f, out[DPL];
#pragma unroll
    for (int c = 0; c < DPL; ++c) out[c] = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(sm[w] - mx);
      den = fmaf(sl[w], f, den);
#pragma unroll
      for (int c = 0; c < DPL; ++c) out[c] = fmaf(sacc[w][lane + 32 * c], f, out[c]);
    }
    const float inv = 1.f / fmaxf(den, 1e-20f);
#pragma unroll
    for (int c = 0; c < DPL; ++c)
      O[((size_t)b * H + h) * D + lane + 32 * c] = from_float<T>(out[c] * inv);
  }
}

template <typename T>
int dispatch(const void* q, const void* kp, const void* vp, const int* bt, const int* len,
             void* o, int B, int H, int D, int psz, int n_max, float scale,
             cudaStream_t stream) {
  dim3 grid(H, B);
  dim3 block(NW * 32);
  switch (D) {
    case 32:
      paged_decode_kernel<T, 32><<<grid, block, 0, stream>>>(
          (const T*)q, (const T*)kp, (const T*)vp, bt, len, (T*)o, H, psz, n_max, scale);
      break;
    case 64:
      paged_decode_kernel<T, 64><<<grid, block, 0, stream>>>(
          (const T*)q, (const T*)kp, (const T*)vp, bt, len, (T*)o, H, psz, n_max, scale);
      break;
    case 128:
      paged_decode_kernel<T, 128><<<grid, block, 0, stream>>>(
          (const T*)q, (const T*)kp, (const T*)vp, bt, len, (T*)o, H, psz, n_max, scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pools and output); head_dim D in
// {32, 64, 128}.  All tensors contiguous.
extern "C" int repro_paged_decode(const void* q, const void* kp, const void* vp,
                                  const void* block_table, const void* length, void* o,
                                  int B, int H, int D, int psz, int n_max, float scale,
                                  int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int* bt = (const int*)block_table;
  const int* len = (const int*)length;
  if (dtype == 0)
    return dispatch<float>(q, kp, vp, bt, len, o, B, H, D, psz, n_max, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, kp, vp, bt, len, o, B, H, D, psz, n_max, scale, s);
  return (int)cudaErrorInvalidValue;
}
