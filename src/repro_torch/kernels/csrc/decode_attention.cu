// Decode attention for Hopper over a contiguous cache: one query per (row,
// head) against that row's first `length` keys.
//
//   q (B, H, D); k/v (B, H, S, D) in q's type (float32 or bfloat16);
//   length (B,) int32, the count of valid keys (the engine's inclusive
//   pos + 1) -> o (B, H, D) in q's type.
// Key j of row b is valid when j < length[b] (clamped to S).  Online softmax
// in float32; a row with no valid key gives 0, as the Pallas kernel does
// (acc / max(l, 1e-20) with acc = 0).
//
// Replaces: src/repro/kernels/decode_attention.py:59 decode_attention
//   (_decode_kernel, :22).  The Pallas kernel walks S in bkv tiles on its
//   sequential grid axis, pads S up to a tile with jnp.pad and still DMAs
//   the tiles past `length`; here a ragged S is masked, never padded, and
//   no key at or past `length` is read.
// Bound on this card: each (row, head) reads its valid keys and values
//   once, sum_b H * length_b * D * 2 * sizeof(T) bytes, and does ~4
//   operations per element read: bytes bound it.  At the serve shape (B 8,
//   H 8, S 256, D 64, bf16, full lengths) that is 4.2 MB, 1.25 us at
//   3.35 TB/s; at these sizes launch and latency dominate.
// Design: one block per (head, row), eight warps.  The warps take 32-key
//   tiles of [0, length) in turn.  In a tile each lane scores one key: it
//   reads its key's row with 16-byte loads and dots it with q, which the
//   block stages once in shared memory as float.  The warp then takes one
//   max and one sum over its 32 scores (not one reduction per key), and
//   accumulates the tile's value rows, one row at a time, each lane
//   holding D/32 output columns, with the key's weight broadcast from its
//   lane.  Each warp keeps its running max, sum and columns in float32
//   registers; the warps merge through shared memory at the end, as
//   csrc/paged_decode.cu does.
#include <cstdint>

#include "common.cuh"

namespace {

using repro::from_float;
using repro::NEG;
using repro::warp_max;
using repro::warp_sum;

constexpr int NW = 8;     // warps per block
constexpr int TILE = 32;  // keys per warp tile: one per lane

// 16 bytes of a row as floats: 4 float32 or 8 bfloat16 values.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NW * 32)
decode_kernel(const T* __restrict__ Q, const T* __restrict__ K, const T* __restrict__ V,
              const int* __restrict__ LEN, T* __restrict__ O, int H, int S, float scale) {
  constexpr int DPL = D / 32;                    // output columns per lane
  constexpr int VEC = 16 / sizeof(T);            // elements per 16-byte load
  __shared__ float sq[D];
  __shared__ float sm[NW], sl[NW];
  __shared__ float sacc[NW][D];
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = max(0, min(LEN[b], S));          // valid keys of this row
  const size_t bh = (size_t)b * H + h;
  const T* krow = K + bh * S * D;
  const T* vrow = V + bh * S * D;

  for (int d = threadIdx.x; d < D; d += NW * 32) sq[d] = repro::to_float(Q[bh * D + d]);
  __syncthreads();

  float m = NEG, l = 0.f, acc[DPL];
#pragma unroll
  for (int c = 0; c < DPL; ++c) acc[c] = 0.f;

  for (int t0 = warp * TILE; t0 < n; t0 += NW * TILE) {
    const int j = t0 + lane;                     // this lane's key
    float s = NEG;
    if (j < n) {
      const T* kp = krow + (size_t)j * D;
      float dot = 0.f;
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += VEC) {
        float kv[VEC];
        load16(kp + d0, kv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) dot = fmaf(sq[d0 + i], kv[i], dot);
      }
      s = dot * scale;
    }
    const float m_new = fmaxf(m, warp_max(s));   // the tile has a valid key
    const float corr = expf(m - m_new);
    const float p = j < n ? expf(s - m_new) : 0.f;
    l = l * corr + warp_sum(p);
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[c] *= corr;
    const int cnt = min(TILE, n - t0);           // uniform over the warp
    for (int i = 0; i < cnt; ++i) {
      const float pi = __shfl_sync(0xffffffffu, p, i);
      const T* vp = vrow + (size_t)(t0 + i) * D;
#pragma unroll
      for (int c = 0; c < DPL; ++c)
        acc[c] = fmaf(pi, repro::to_float(vp[lane + 32 * c]), acc[c]);
    }
    m = m_new;
  }

  if (lane == 0) {
    sm[warp] = m;
    sl[warp] = l;
  }
#pragma unroll
  for (int c = 0; c < DPL; ++c) sacc[warp][lane + 32 * c] = acc[c];
  __syncthreads();
  float mx = NEG;
#pragma unroll
  for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm[w]);
  float den = 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w) den = fmaf(sl[w], expf(sm[w] - mx), den);
  const float inv = 1.f / fmaxf(den, 1e-20f);
  for (int d = threadIdx.x; d < D; d += NW * 32) {
    float out = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) out = fmaf(sacc[w][d], expf(sm[w] - mx), out);
    O[bh * D + d] = from_float<T>(out * inv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* len, void* o, int B,
           int H, int S, int D, float scale, void* stream) {
  const dim3 grid(H, B), block(NW * 32);
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_DECODE(DIM)                                                                \
  decode_kernel<T, DIM><<<grid, block, 0, s>>>((const T*)q, (const T*)k, (const T*)v,    \
                                               (const int*)len, (T*)o, H, S, scale)
  switch (D) {
    case 32: REPRO_DECODE(32); break;
    case 64: REPRO_DECODE(64); break;
    case 128: REPRO_DECODE(128); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_DECODE
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and the output); head_dim D in
// {32, 64, 128}; all tensors contiguous, k and v 16-byte aligned.  Returns
// cudaGetLastError() after the launch.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* length, void* o, int B, int H, int S,
                                      int D, float scale, int dtype, void* stream) {
  if (dtype == 0)
    return launch<float>(q, k, v, length, o, B, H, S, D, scale, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, length, o, B, H, S, D, scale, stream);
  return (int)cudaErrorInvalidValue;
}
