// Shared helpers of the port's CUDA kernels: float32/bfloat16 (and int8
// payload) loads and float32/bfloat16 stores through float, warp
// reductions, and the tensor-core kit of the bfloat16 kernels (matmul,
// flash attention, the SSD scan, paged attention): cp.async copies,
// ldmatrix, mma.sync m16n8k16, the thread-block cluster barrier and the
// shared-tile swizzle.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return (float)x; }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, of which the first `src_bytes`
// (0 or 16) are read and the rest zero-filled; through L2 only (CA false:
// data read once) or L1 too (CA: every block of an SM reads the same bytes).
// `src` must be a valid address even when nothing is read.
template <bool CA = false>
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int src_bytes) {
  if (CA)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(src_bytes)
                 : "memory");
}

// 4 bytes from global to shared memory, of which the first `src_bytes` (0
// or 4) are read and the rest zero-filled (cp.async's .ca form: the 4- and
// 8-byte sizes have no .cg).  `src` must be a valid address either way.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cp.async.wait_group with a count known only at run time (0..3)
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// ldmatrix: 8x8 tiles of 16-bit values from shared memory, lanes 8i..8i+7
// giving the row addresses of tile i; .trans hands out the transpose.
__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(unsigned* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// d (16 x 8, float32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col).
// Fragments, g = lane / 4, t = lane % 4: a0 (row g, cols 2t, 2t+1), a1 (row
// g+8, the same), a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, the same); b0
// (rows 2t, 2t+1, col g), b1 (rows 2t+8, 2t+9, col g); d0, d1 (row g, cols
// 2t, 2t+1), d2, d3 (row g+8, the same).  Two adjacent 16 x 8 accumulator
// tiles are, packed to bf16, one 16 x 16 A fragment.
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats rounded to bfloat16 and packed, `lo` in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Thread-block cluster barrier, split in two: arrive early, wait before the
// first access to another block's shared memory.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Chunk (r, c) of a shared tile whose rows hold cpr 16-byte chunks, a
// multiple of 8: the chunk index XOR the row mod 8.
__device__ __forceinline__ int swz_row(int r, int c, int cpr) { return r * cpr + (c ^ (r & 7)); }

// The same for rows of CPR chunks, CPR a power of two: swz_row for CPR >=
// 8, else the low three bits of the linear index XOR the next three.
// Either way 8 consecutive rows at one chunk column, which one ldmatrix
// phase reads, fall in 8 distinct bank groups.
template <int CPR>
__device__ __forceinline__ int swz(int r, int c) {
  if (CPR >= 8) return swz_row(r, c, CPR);
  const int L = r * CPR + c;
  return L ^ ((L >> 3) & 7);
}

// Masked scores carry this value, as in the Pallas kernels: a row with no
// valid key keeps m = NEG and l = 0, and its output is 0.
constexpr float NEG = -1e30f;

}  // namespace repro
