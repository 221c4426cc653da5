// Tiled GEMM for Hopper: C (M, N) = A (M, K) @ B, float32 accumulator,
// output in A's dtype (float32 or bfloat16).  B is (K, N) row-major, or
// (N, K) row-major with trans_b (the tied LM head reads the embedding table
// as it is stored, so the 32000 x 512 table is never transposed).
//
// Replaces: src/repro/kernels/matmul.py::matmul (_matmul_kernel).
// Bound on this card: at the main path's shapes (M = 8 decode rows or 32
//   prefill rows against 512..32000-column weights) the work is a few
//   operations per weight byte, far under the ~295 the H100 needs in bf16
//   before compute limits, so the bound is reading the weights once.
// Design: one block per BM x BN output tile with M small enough that one
//   row tile covers it, so each weight element is read from device memory
//   once; tiles of A and B are staged in shared memory as float, each thread
//   keeps a 4 x 4 register tile of sums.  Ragged M, N and K are masked at
//   load and store (the Pallas kernel needed dividing shapes).  It uses the
//   CUDA cores, not the tensor cores: simple and right first.
#include "common.cuh"

namespace {

using repro::from_float;
using repro::to_float;

constexpr int TM = 4;
constexpr int TN = 4;
constexpr int BK = 16;

template <typename T, int BM, int BN, bool TRANS_B>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
matmul_kernel(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C,
              int M, int N, int K) {
  constexpr int NT = (BM / TM) * (BN / TN);
  __shared__ float As[BK][BM + 4];   // As[k][m]
  __shared__ float Bs[BK][BN + 4];   // Bs[k][n]
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {   // consecutive threads: consecutive k
      const int m = i / BK, k = i % BK;
      const int gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < K) ? to_float(A[(size_t)gm * K + gk]) : 0.f;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      if (TRANS_B) {                              // B is (N, K): coalesce along k
        const int n = i / BK, k = i % BK;
        const int gn = n0 + n, gk = k0 + k;
        Bs[k][n] = (gn < N && gk < K) ? to_float(B[(size_t)gn * K + gk]) : 0.f;
      } else {                                    // B is (K, N): coalesce along n
        const int k = i / BN, n = i % BN;
        const int gn = n0 + n, gk = k0 + k;
        Bs[k][n] = (gn < N && gk < K) ? to_float(B[(size_t)gk * N + gn]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
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
      if (gn < N) C[(size_t)gm * N + gn] = from_float<T>(acc[i][j]);
    }
  }
}

template <typename T, int BM, int BN>
void launch(const void* a, const void* b, void* c, int M, int N, int K, int trans_b,
            cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  dim3 block((BM / TM) * (BN / TN));
  if (trans_b)
    matmul_kernel<T, BM, BN, true><<<grid, block, 0, stream>>>(
        (const T*)a, (const T*)b, (T*)c, M, N, K);
  else
    matmul_kernel<T, BM, BN, false><<<grid, block, 0, stream>>>(
        (const T*)a, (const T*)b, (T*)c, M, N, K);
}

template <typename T>
void dispatch(const void* a, const void* b, void* c, int M, int N, int K, int trans_b,
              cudaStream_t stream) {
  // decode (M = 8) and prefill chunks (M = 32) fit one 32-row tile
  if (M <= 32)
    launch<T, 32, 64>(a, b, c, M, N, K, trans_b, stream);
  else
    launch<T, 64, 64>(a, b, c, M, N, K, trans_b, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  All tensors contiguous row-major.
extern "C" int repro_matmul(const void* a, const void* b, void* c, int M, int N, int K,
                            int trans_b, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    dispatch<float>(a, b, c, M, N, K, trans_b, s);
  else if (dtype == 1)
    dispatch<__nv_bfloat16>(a, b, c, M, N, K, trans_b, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
