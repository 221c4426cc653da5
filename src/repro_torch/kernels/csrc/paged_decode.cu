// Paged attention for Hopper over the slot's pages, in four variants that
// share one kernel template: decode (one query per slot) and speculative
// verify (nq <= 8 queries per slot), each over float pools (in q's dtype)
// or int8 pools with one float32 scale per token row.
//
//   q (B, H, nq, D) (decode: nq = 1, q (B, H, D)); k/v pools (n_pages, H,
//   psz, D); int8 scales k_scale/v_scale (n_pages, psz) float32;
//   block_table (B, n_max) int32; length (B,) int32, the count of valid
//   tokens ahead of query 0 (the engine's inclusive pos + 1)
//   -> o (B, H, nq, D) in q's dtype.
// Query i sits at position length - 1 + i and sees keys kpos < length + i
// (the drafts' own KV is already in the pool).  Online softmax in float32;
// a query with no valid key gives 0.
//
// Replaces: src/repro/kernels/decode_attention.py::paged_decode_attention
//   (_paged_decode_kernel, _paged_decode_kernel_i8) and
//   ::paged_verify_attention (_paged_verify_kernel, _paged_verify_kernel_i8).
// Bound on this card: each (slot, head) reads its keys and values once and
//   does ~4 * nq operations per element read: bytes bound it, and int8
//   pools halve (bf16) or quarter (fp32) them, plus 4 bytes per row for
//   each scale.
// Design: one block per (head, slot).  The block reads its own block-table
//   row (the Pallas kernels' scalar prefetch) and loads each page's K and V
//   rows straight from the pool by page id: no gathered copy of the cache
//   is ever made, the paper's minimal off-chip traffic.  Four warps take
//   pages in turn.  A warp loads each K/V row ONCE into registers (one
//   column pair per lane; int8 rows at one byte per element, dequantised
//   in registers through the row's scale as the Pallas i8 kernels do) and
//   scores it against every query that may see it, so verify streams the
//   pool once per step for all nq positions.  Per query a warp keeps its
//   running max, sum and D/32 output columns per lane; the warps' partial
//   softmax states merge through shared memory at the end.  The page count
//   comes from the deepest query's view, length + nq - 1, clamped to
//   n_max.  Idle lanes point at scratch page 0 with length 1: they read
//   one row and their output is ignored.
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

using repro::from_float;
using repro::NEG;
using repro::to_float;
using repro::warp_sum;

constexpr int NW = 4;        // warps per block
constexpr int MAX_NQ = 8;    // verify queries per slot (k + 1 <= 8)

template <typename QT, typename PT, int D, int NQ>
__global__ void __launch_bounds__(NW * 32)
paged_attn_kernel(const QT* __restrict__ Q, const PT* __restrict__ KP,
                  const PT* __restrict__ VP, const float* __restrict__ KS,
                  const float* __restrict__ VS, const int* __restrict__ BT,
                  const int* __restrict__ LEN, QT* __restrict__ O, int H, int nq, int psz,
                  int n_max, float scale) {
  constexpr int DPL = D / 32;
  constexpr bool QUANT = std::is_same<PT, int8_t>::value;
  __shared__ float sm[NW][NQ], sl[NW][NQ];
  __shared__ float sacc[NW][NQ][D];
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int length = LEN[b];
  const int n_kv = length + nq - 1;          // keys the deepest query sees
  const int n_used = n_kv <= 0 ? 0 : min((n_kv + psz - 1) / psz, n_max);
  const size_t qrow = ((size_t)b * H + h) * nq;

  float q[NQ][DPL], acc[NQ][DPL], m[NQ], l[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      q[i][c] = i < nq ? to_float(Q[(qrow + i) * D + lane + 32 * c]) : 0.f;
      acc[i][c] = 0.f;
    }
  }

  for (int pi = warp; pi < n_used; pi += NW) {
    const size_t page = (size_t)BT[(size_t)b * n_max + pi];
    const PT* kpage = KP + (page * H + h) * psz * D;
    const PT* vpage = VP + (page * H + h) * psz * D;
    const int n_tok = min(psz, n_kv - pi * psz);
    for (int t = 0; t < n_tok; ++t) {
      const int kpos = pi * psz + t;
      float kr[DPL], vr[DPL];
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        kr[c] = to_float(kpage[t * D + lane + 32 * c]);
        vr[c] = to_float(vpage[t * D + lane + 32 * c]);
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
        if (i >= nq || kpos >= length + i) continue;   // uniform over the warp
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
      for (int c = 0; c < DPL; ++c) out[c] = fmaf(sacc[w][i][lane + 32 * c], f, out[c]);
    }
    const float inv = 1.f / fmaxf(den, 1e-20f);
#pragma unroll
    for (int c = 0; c < DPL; ++c)
      O[(qrow + i) * D + lane + 32 * c] = from_float<QT>(out[c] * inv);
  }
}

template <typename QT, typename PT, int NQ>
int launch(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
           const void* bt, const void* len, void* o, int B, int H, int nq, int D, int psz,
           int n_max, float scale, void* stream) {
  if (nq < 1 || nq > NQ) return (int)cudaErrorInvalidValue;
  const dim3 grid(H, B), block(NW * 32);
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_PAGED_ATTN(DIM)                                                             \
  paged_attn_kernel<QT, PT, DIM, NQ><<<grid, block, 0, s>>>(                              \
      (const QT*)q, (const PT*)kp, (const PT*)vp, (const float*)ks, (const float*)vs,     \
      (const int*)bt, (const int*)len, (QT*)o, H, nq, psz, n_max, scale)
  switch (D) {
    case 32: REPRO_PAGED_ATTN(32); break;
    case 64: REPRO_PAGED_ATTN(64); break;
    case 128: REPRO_PAGED_ATTN(128); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_PAGED_ATTN
  return (int)cudaGetLastError();
}

// Pick q's type (dtype: 0 = float32, 1 = bfloat16); the pools are in q's
// type (float variants) or int8 (QUANT).
template <bool QUANT, int NQ>
int by_dtype(int dtype, const void* q, const void* kp, const void* vp, const void* ks,
             const void* vs, const void* bt, const void* len, void* o, int B, int H, int nq,
             int D, int psz, int n_max, float scale, void* stream) {
  if (dtype == 0)
    return launch<float, typename std::conditional<QUANT, int8_t, float>::type, NQ>(
        q, kp, vp, ks, vs, bt, len, o, B, H, nq, D, psz, n_max, scale, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16,
                  typename std::conditional<QUANT, int8_t, __nv_bfloat16>::type, NQ>(
        q, kp, vp, ks, vs, bt, len, o, B, H, nq, D, psz, n_max, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The four C entries.  dtype: 0 = float32, 1 = bfloat16 (q and output; the
// pools too in the float variants); head_dim D in {32, 64, 128}; verify
// takes 1 <= nq <= 8.  All tensors contiguous.  Each returns
// cudaGetLastError() after its launch.
extern "C" int repro_paged_decode(const void* q, const void* kp, const void* vp,
                                  const void* block_table, const void* length, void* o,
                                  int B, int H, int D, int psz, int n_max, float scale,
                                  int dtype, void* stream) {
  return by_dtype<false, 1>(dtype, q, kp, vp, nullptr, nullptr, block_table, length, o, B,
                            H, 1, D, psz, n_max, scale, stream);
}

extern "C" int repro_paged_decode_i8(const void* q, const void* kp, const void* vp,
                                     const void* k_scale, const void* v_scale,
                                     const void* block_table, const void* length, void* o,
                                     int B, int H, int D, int psz, int n_max, float scale,
                                     int dtype, void* stream) {
  return by_dtype<true, 1>(dtype, q, kp, vp, k_scale, v_scale, block_table, length, o, B, H,
                           1, D, psz, n_max, scale, stream);
}

extern "C" int repro_paged_verify(const void* q, const void* kp, const void* vp,
                                  const void* block_table, const void* length, void* o,
                                  int B, int H, int nq, int D, int psz, int n_max,
                                  float scale, int dtype, void* stream) {
  return by_dtype<false, MAX_NQ>(dtype, q, kp, vp, nullptr, nullptr, block_table, length, o,
                                 B, H, nq, D, psz, n_max, scale, stream);
}

extern "C" int repro_paged_verify_i8(const void* q, const void* kp, const void* vp,
                                     const void* k_scale, const void* v_scale,
                                     const void* block_table, const void* length, void* o,
                                     int B, int H, int nq, int D, int psz, int n_max,
                                     float scale, int dtype, void* stream) {
  return by_dtype<true, MAX_NQ>(dtype, q, kp, vp, k_scale, v_scale, block_table, length, o,
                                B, H, nq, D, psz, n_max, scale, stream);
}
