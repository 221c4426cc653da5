// Chunked mamba2 SSD scan for Hopper: y (Bt, S, H, P) and the final state
// (Bt, H, P, N) of h_t = exp(dt_t A) h_{t-1} + dt_t x_t (x) B_t, y_t = C_t . h_t,
// from a zero, float32 or int8 (per-(row, head) scale) initial state.  x, B, C
// and y in float32 or bfloat16, dt and A in float32, all arithmetic float32.
// No D skip term (the caller adds it, as with the Pallas kernel).
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan (_ssd_kernel/_ssd_body,
//   and _ssd_kernel_i8, which seeds the state from an int8 slab).  Unlike the
//   Pallas kernel it starts from a given state, takes any S (a partial last
//   chunk is masked, not padded) and returns the final state, which the
//   serving slabs carry from one prefill chunk to the next.
// Bound on this card: at the serve chunk (Bt 1, S 32, H 32, P 64, N 128) the
//   inputs are ~0.3 MB and the state 1 MB each way, against ~20 MFLOP: bytes
//   bound it (~0.7 us).  The recurrence is sequential over chunks, so what
//   limits this kernel in practice is latency, not either roof.
// Design: the state rows h[p, :] depend only on x[:, p], so one block per
//   (batch row, head, 16-row tile of P) walks the chunks in order with its
//   16 x N state tile in shared memory (the serve shape gives 4 x 32 = 128
//   blocks on 132 SMs; the Pallas (H, P, N) scratch would be one program).
//   Per chunk of Q = 64 rows (the kernel's own constant; the chunked form is
//   exact for any Q) the block loads dt, B, C and its x columns, forms
//   cs = cumsum(dt A), the masked Q x Q matrix
//   W_ij = (C_i . B_j) exp(cs_i - cs_j) dt_j for j <= i (the exponent is
//   only formed where j <= i, so it never overflows), then
//   y_i = sum_j W_ij x_j + exp(cs_i) C_i . h_prev and
//   h = exp(cs_last) h_prev + sum_j exp(cs_last - cs_j) dt_j x_j (x) B_j.
//   Every block of a head recomputes C B^T; that is cheap.  Shared memory
//   rows are padded to N + 1 floats, so column walks hit distinct banks:
//   4 * (2 Q (N+1) + 16 (N+1) + 16 Q + Q (Q+1) + 3 Q) bytes, 95,808 at
//   N = 128, set with cudaFuncSetAttribute above 48 KB.  CUDA cores only.
#include "common.cuh"

namespace {

using repro::from_float;
using repro::to_float;

constexpr int Q = 64;     // rows per chunk
constexpr int TP = 16;    // state rows (head_dim columns) per block
constexpr int NT = 128;   // threads per block

size_t smem_bytes(int N) {
  const size_t ns = (size_t)N + 1;
  return sizeof(float) * (2 * Q * ns + TP * ns + Q * TP + Q * (Q + 1) + 3 * Q);
}

template <typename T>
__global__ void __launch_bounds__(NT)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const T* __restrict__ Bm, const T* __restrict__ Cm,
                const float* __restrict__ A, const float* __restrict__ s0f,
                const int8_t* __restrict__ s0q, const float* __restrict__ s0scale,
                T* __restrict__ y, float* __restrict__ st_out,
                int S, int H, int P, int N) {
  extern __shared__ float smem[];
  const int NS = N + 1;
  float* Bs = smem;                 // [Q][NS]
  float* Cs = Bs + Q * NS;          // [Q][NS]
  float* st = Cs + Q * NS;          // [TP][NS]   the state tile
  float* xs = st + TP * NS;         // [Q][TP]
  float* W = xs + Q * TP;           // [Q][Q + 1]
  float* cs = W + Q * (Q + 1);      // [Q]  inclusive cumsum of dt * A
  float* dtv = cs + Q;              // [Q]
  float* wend = dtv + Q;            // [Q]  exp(cs_last - cs_j) * dt_j

  const int p0 = blockIdx.x * TP;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const float a = A[h];
  const size_t row_bh = (size_t)b * H + h;

  for (int e = tid; e < TP * N; e += NT) {
    const int p = e / N, n = e % N;
    const size_t g = (row_bh * P + p0 + p) * N + n;
    float v = 0.f;
    if (s0f != nullptr)
      v = s0f[g];
    else if (s0q != nullptr)
      v = (float)s0q[g] * s0scale[row_bh];
    st[p * NS + n] = v;
  }

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int L = min(Q, S - c0);
    __syncthreads();              // the previous chunk's readers are done
    for (int e = tid; e < L * N; e += NT) {
      const int i = e / N, n = e % N;
      const size_t g = ((size_t)b * S + c0 + i) * N + n;
      Bs[i * NS + n] = to_float(Bm[g]);
      Cs[i * NS + n] = to_float(Cm[g]);
    }
    for (int e = tid; e < L * TP; e += NT) {
      const int i = e / TP, p = e % TP;
      xs[i * TP + p] = to_float(x[(((size_t)b * S + c0 + i) * H + h) * P + p0 + p]);
    }
    if (tid < L) dtv[tid] = dt[((size_t)b * S + c0 + tid) * H + h];
    __syncthreads();
    if (tid == 0) {               // L <= 64 dependent adds
      float run = 0.f;
      for (int i = 0; i < L; ++i) {
        run = fmaf(dtv[i], a, run);
        cs[i] = run;
      }
    }
    __syncthreads();
    if (tid < L) wend[tid] = expf(cs[L - 1] - cs[tid]) * dtv[tid];
    for (int e = tid; e < L * L; e += NT) {
      const int i = e / L, j = e % L;
      float w = 0.f;
      if (j <= i) {               // mask before exp: cs_i - cs_j <= 0 here
        float g = 0.f;
        for (int n = 0; n < N; ++n) g = fmaf(Cs[i * NS + n], Bs[j * NS + n], g);
        w = g * expf(cs[i] - cs[j]) * dtv[j];
      }
      W[i * (Q + 1) + j] = w;
    }
    __syncthreads();
    for (int e = tid; e < L * TP; e += NT) {
      const int i = e / TP, p = e % TP;
      float intra = 0.f;
      for (int j = 0; j <= i; ++j) intra = fmaf(W[i * (Q + 1) + j], xs[j * TP + p], intra);
      float inter = 0.f;
      for (int n = 0; n < N; ++n) inter = fmaf(Cs[i * NS + n], st[p * NS + n], inter);
      y[(((size_t)b * S + c0 + i) * H + h) * P + p0 + p] =
          from_float<T>(fmaf(expf(cs[i]), inter, intra));
    }
    __syncthreads();              // every reader of the previous state is done
    const float decay = expf(cs[L - 1]);
    for (int e = tid; e < TP * N; e += NT) {
      const int p = e / N, n = e % N;
      float acc = st[p * NS + n] * decay;
      for (int j = 0; j < L; ++j)
        acc = fmaf(wend[j] * xs[j * TP + p], Bs[j * NS + n], acc);
      st[p * NS + n] = acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < TP * N; e += NT) {
    const int p = e / N, n = e % N;
    st_out[(row_bh * P + p0 + p) * N + n] = st[p * NS + n];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* B, const void* C, const void* A,
           const void* s0, const void* s0_scale, void* y, void* st_out, int Bt, int S,
           int H, int P, int N, int s0_kind, cudaStream_t stream) {
  static size_t granted = 48 * 1024;     // dynamic shared memory allowed so far
  const size_t smem = smem_bytes(N);
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    granted = smem;
  }
  dim3 grid(P / TP, H, Bt);
  ssd_scan_kernel<T><<<grid, NT, smem, stream>>>(
      (const T*)x, (const float*)dt, (const T*)B, (const T*)C, (const float*)A,
      s0_kind == 1 ? (const float*)s0 : nullptr,
      s0_kind == 2 ? (const int8_t*)s0 : nullptr,
      s0_kind == 2 ? (const float*)s0_scale : nullptr, (T*)y, (float*)st_out, S, H, P, N);
  return (int)cudaGetLastError();
}

}  // namespace

// s0_kind: 0 = zero initial state, 1 = float32 state0, 2 = int8 state0 with
// (Bt, H) float32 scales.  dtype (x, B, C, y): 0 = float32, 1 = bfloat16.
// All tensors contiguous row-major; P a multiple of 16.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* B, const void* C,
                              const void* A, const void* s0, const void* s0_scale, void* y,
                              void* st_out, int Bt, int S, int H, int P, int N, int s0_kind,
                              int dtype, void* stream) {
  if (P % TP != 0 || s0_kind < 0 || s0_kind > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, dt, B, C, A, s0, s0_scale, y, st_out, Bt, S, H, P, N, s0_kind, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, B, C, A, s0, s0_scale, y, st_out, Bt, S, H, P, N,
                                 s0_kind, s);
  return (int)cudaErrorInvalidValue;
}
