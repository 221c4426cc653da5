// Chunked mamba2 SSD scan for Hopper: y (Bt, S, H, P) and the final state
// (Bt, H, P, N) of h_t = exp(dt_t A) h_{t-1} + dt_t x_t (x) B_t, y_t = C_t . h_t,
// from a zero, float32 or int8 (per-(row, head) scale) initial state.  x, B, C
// and y in float32 or bfloat16, dt and A in float32, the state in float32.
// No D skip term (the caller adds it, as with the Pallas kernel).
//
// Replaces: src/repro/kernels/ssd_scan.py:84 ssd_scan (_ssd_kernel/_ssd_body
//   :22/:33, and _ssd_kernel_i8 :67, which seeds the state from an int8 slab;
//   pallas_call at :116).  Unlike the Pallas kernel it starts from a given
//   state, takes any S (a partial last chunk is masked, not padded) and
//   returns the final state, which the serving slabs carry from one prefill
//   chunk to the next.
// Bound on this card: at the serve chunk (Bt 1, S 32, H 32, P 64, N 128) the
//   inputs are ~0.3 MB, the state 1 MB in (0.26 MB as int8) and 1 MB out,
//   against ~46 MFLOP of bf16 products: bytes bound it (~0.71 us, ~0.48 us
//   from an int8 state).  The recurrence is sequential over chunks and each
//   chunk is a few dependent products, so what limits a kernel this small
//   is latency: the launch, the state's round trip, and the steps in series.
//
// The chunked form, per chunk of L <= Q = 64 rows (exact for any Q):
//   cs = cumsum(dt A), W_ij = (C_i . B_j) exp(cs_i - cs_j) dt_j for j <= i
//   (the exponent only formed where j <= i, so it never overflows),
//   y_i = sum_j W_ij x_j + exp(cs_i) C_i . h_prev,
//   h = exp(cs_last) h_prev + sum_j exp(cs_last - cs_j) dt_j x_j (x) B_j.
//
// Design of the bfloat16 kernel, and what each choice does about that:
//  - One block per (batch row, head), P / 16 warps (4 at P = 64); warp w
//    owns the state rows p in [16 w, 16 w + 16) for the whole scan, in
//    mma.sync accumulator fragments (float32, N / 2 per lane): the state is
//    read once from global memory into registers (the int8 slab dequantized
//    there, q * scale in float32), updated in registers, written once.
//  - Tensor cores (mma.sync m16n8k16, bf16 in, float32 accumulate) for every
//    product of a chunk, all transposed so the warp's p rows are the m16:
//    G = C B^T (exact: bf16 inputs), y^T = h C^T + x^T W^T, and the update
//    h += (f o x)^T B with f_j = exp(cs_last - cs_j) dt_j.  x, B and C come
//    through ldmatrix (x and B transposed) from shared memory; the state is
//    the A operand straight from its accumulator fragments.
//  - Precision: the final state is held to float32's 1e-3 and y to bf16's
//    2e-2.  C, B and x are bf16 inputs, exact in the products.  Every
//    float32 operand, the state (in h C^T), f o x (in the update) and W (in
//    x^T W^T), enters the mma as two bf16 terms, hi = bf16(v) and lo =
//    bf16(v - hi), two products each: v is kept to ~2^-16 of itself.  As
//    one term, its ~2^-9 error per term adds up over the chunk's rows and
//    the state's columns: in a float64 emulation of the serve chunk
//    (tests/test_torch_ssm.py::test_ssd_bf16_operands_need_two_terms) the
//    state as one term misses y's tolerance and f o x as one term misses
//    the final state's; W as one term misses y on some seeds.
//  - C B^T once per (chunk, head): its 16 x 16 tiles on and below the
//    diagonal are dealt out over the warps, scaled into W (its two bf16
//    terms) in shared memory, and read by all of them after one barrier.
//  - The cumsum of dt A is one warp's shuffle scan, run while the chunk's
//    x, B and C arrive by 16-byte cp.async (rows past L zero-filled).
//  - Shared memory holds LP = min(Q, S) rounded up to 16 rows of x, B, C
//    and W's two terms (27 KB at the serve chunk), rows at an odd stride of
//    16-byte chunks so the 8 rows one ldmatrix phase reads fall in 8 bank
//    groups.
//  Two barriers per chunk, three from the second chunk on.  One kernel per
//  call, no atomics: bitwise repeatable.
//
// float32 keeps a CUDA-core kernel (1e-3 in float32 arithmetic): one block
// per (batch row, head, 16-row tile of P), 128 threads, the chunk's rows,
// W and the 16 x N state tile in shared memory as float (rows padded to
// N + 1 floats), sized for min(Q, S) chunk rows.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using repro::cp_async_16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::ldsm_x4;
using repro::ldsm_x4_trans;
using repro::mma_bf16;
using repro::pack_bf16;

constexpr int Q = 64;     // rows per chunk (both kernels)

// ------------------------------------------------- bfloat16: tensor cores
constexpr int MMA_MAX_N = 128;   // state size one warp's registers hold
constexpr int MMA_MAX_P = 128;   // head_dim: P / 16 warps, at most 8

// Geometry, shared by the kernel and its launch.  lp: chunk rows held, min(Q, S)
// rounded up to 16; each stored row of x, B, C and W's hi and lo terms
// holds its 16-byte chunks at an odd stride; then 4 floats per row (cs,
// exp(cs), dt, f).
__host__ __device__ constexpr int chunk_rows(int S) { return ((S < Q ? S : Q) + 15) / 16 * 16; }
__host__ __device__ constexpr int odd_stride(int cols) { return cols / 8 + 1; }
__host__ __device__ constexpr int mma_smem_bytes(int lp, int P, int N) {
  return 16 * lp * (odd_stride(P) + 2 * odd_stride(N) + 2 * odd_stride(lp)) + 16 * lp;
}

// Two bf16 terms of v: hi = bf16(v), lo = bf16(v - hi), packed in pairs.
__device__ __forceinline__ void split2(float v0, float v1, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(v0 - __low2float(h), v1 - __high2float(h));
}

// Grid (H, Bt), P / 16 warps.
template <int LP>
__global__ void __launch_bounds__(MMA_MAX_P / 16 * 32)
ssd_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
               const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
               const float* __restrict__ A, const float* __restrict__ s0f,
               const int8_t* __restrict__ s0q, const float* __restrict__ s0scale,
               bf16* __restrict__ y, float* __restrict__ st_out, int S, int H, int P, int N) {
  constexpr int NTM = MMA_MAX_N / 8;     // state tiles (8 columns) a lane can hold
  constexpr int YT = LP / 8;             // y^T tiles (8 chunk rows)
  constexpr int KJ = LP / 16;            // k steps over chunk rows
  constexpr int WS = LP / 8 + 1;         // W row stride, chunks
  extern __shared__ __align__(16) unsigned char smem[];
  const int XS = odd_stride(P), NS = odd_stride(N);
  bf16* xs = reinterpret_cast<bf16*>(smem);    // [LP][XS * 8]  x rows of the chunk
  bf16* bs = xs + LP * XS * 8;                 // [LP][NS * 8]  B
  bf16* cs_ = bs + LP * NS * 8;                // [LP][NS * 8]  C
  bf16* ws = cs_ + LP * NS * 8;                // [LP][WS * 8]  W, hi term
  bf16* wl = ws + LP * WS * 8;                 // [LP][WS * 8]  W, lo term
  float* csv = reinterpret_cast<float*>(wl + LP * WS * 8);   // [LP] cumsum of dt A
  float* ecs = csv + LP;                       // [LP] exp(cs)
  float* dtv = ecs + LP;                       // [LP] dt (0 past L)
  float* fv = dtv + LP;                        // [LP] exp(cs_last - cs_j) dt_j

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads / 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int mat = lane >> 3, mrow = lane & 7;  // ldmatrix: this lane's tile and row
  const int nt_n = N / 8;
  const size_t row_bh = (size_t)b * H + h;
  const float a = A[h];

  // the warp's 16 state rows in accumulator fragments: tile nt holds
  // (p0 + g, 8 nt + 2 t4 (+1)) in [0], [1] and row p0 + g + 8 in [2], [3]
  const int p0 = warp * 16;
  float st[NTM][4];
#pragma unroll
  for (int nt = 0; nt < NTM; ++nt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float2 v = make_float2(0.f, 0.f);
      if (nt < nt_n) {
        const size_t gi = (row_bh * P + p0 + g + 8 * r) * N + nt * 8 + 2 * t4;
        if (s0f != nullptr) {
          v = *reinterpret_cast<const float2*>(s0f + gi);
        } else if (s0q != nullptr) {
          const char2 c = *reinterpret_cast<const char2*>(s0q + gi);
          const float sc = s0scale[row_bh];
          v = make_float2((float)c.x * sc, (float)c.y * sc);
        }
      }
      st[nt][2 * r] = v.x;
      st[nt][2 * r + 1] = v.y;
    }
  }

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int L = min(Q, S - c0);
    if (c0 > 0) __syncthreads();        // the previous chunk's readers are done
    // x, B, C rows of the chunk (zeros past L), 16 bytes a copy
    for (int e = tid; e < LP * (P / 8); e += nthreads) {
      const int i = e / (P / 8), c = e % (P / 8);
      const bool in = i < L;
      cp_async_16(xs + (i * XS + c) * 8,
                  in ? x + (((size_t)b * S + c0 + i) * H + h) * P + c * 8 : x, in ? 16 : 0);
    }
    for (int e = tid; e < LP * (N / 8); e += nthreads) {
      const int i = e / (N / 8), c = e % (N / 8);
      const bool in = i < L;
      const size_t off = in ? ((size_t)b * S + c0 + i) * N + c * 8 : 0;
      cp_async_16(bs + (i * NS + c) * 8, Bm + off, in ? 16 : 0);
      cp_async_16(cs_ + (i * NS + c) * 8, Cm + off, in ? 16 : 0);
    }
    cp_async_commit();
    if (warp == 0) {                    // cumsum of dt A: a shuffle scan, 2 rows a lane
      float d[2], c[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = lane + 32 * r;
        d[r] = i < L ? dt[((size_t)b * S + c0 + i) * H + h] : 0.f;
        c[r] = d[r] * a;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, c[r], o);
          if (lane >= o) c[r] += u;
        }
      }
      c[1] += __shfl_sync(0xffffffffu, c[0], 31);
      const float last = __shfl_sync(0xffffffffu, c[(L - 1) >> 5], (L - 1) & 31);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = lane + 32 * r;
        if (i < LP) {
          csv[i] = c[r];
          ecs[i] = expf(c[r]);
          dtv[i] = d[r];
          fv[i] = expf(last - c[r]) * d[r];   // rows past L: dt 0, cs flat
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    // W = (C B^T) o exp(cs_i - cs_j) dt_j on and below the diagonal, zero
    // above: 16 x 16 tiles dealt out over the warps
    for (int u = warp; u < KJ * KJ; u += nwarps) {
      const int mi = u / KJ, nj = u % KJ;
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      if (nj <= mi) {
        for (int kn = 0; kn < N / 16; ++kn) {
          unsigned fa[4], fb[4];
          ldsm_x4(fa, cs_ + ((mi * 16 + (mat & 1) * 8 + mrow) * NS + kn * 2 + (mat >> 1)) * 8);
          ldsm_x4(fb, bs + ((nj * 16 + (mat >> 1) * 8 + mrow) * NS + kn * 2 + (mat & 1)) * 8);
          mma_bf16(acc[0], fa, fb);
          mma_bf16(acc[1], fa, fb + 2);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = mi * 16 + g + 8 * r;
          const int j = nj * 16 + half * 8 + 2 * t4;
          float w0 = 0.f, w1 = 0.f;
          if (j <= i) w0 = acc[half][2 * r] * expf(csv[i] - csv[j]) * dtv[j];
          if (j + 1 <= i) w1 = acc[half][2 * r + 1] * expf(csv[i] - csv[j + 1]) * dtv[j + 1];
          split2(w0, w1, *reinterpret_cast<unsigned*>(ws + i * WS * 8 + j),
                 *reinterpret_cast<unsigned*>(wl + i * WS * 8 + j));
        }
    }
    __syncthreads();

    // y^T (the warp's 16 p rows x LP chunk rows) = exp(cs_i) (h C^T) + x^T W^T
    float yt[YT][4];
#pragma unroll
    for (int it = 0; it < YT; ++it)
#pragma unroll
      for (int e = 0; e < 4; ++e) yt[it][e] = 0.f;
#pragma unroll
    for (int kn = 0; kn < NTM / 2; ++kn) {
      if (kn >= N / 16) break;
      unsigned hi[4], lo[4];
      split2(st[2 * kn][0], st[2 * kn][1], hi[0], lo[0]);
      split2(st[2 * kn][2], st[2 * kn][3], hi[1], lo[1]);
      split2(st[2 * kn + 1][0], st[2 * kn + 1][1], hi[2], lo[2]);
      split2(st[2 * kn + 1][2], st[2 * kn + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int np = 0; np < KJ; ++np) {
        unsigned fb[4];
        ldsm_x4(fb, cs_ + ((np * 16 + (mat >> 1) * 8 + mrow) * NS + kn * 2 + (mat & 1)) * 8);
        mma_bf16(yt[2 * np], hi, fb);
        mma_bf16(yt[2 * np], lo, fb);
        mma_bf16(yt[2 * np + 1], hi, fb + 2);
        mma_bf16(yt[2 * np + 1], lo, fb + 2);
      }
    }
#pragma unroll
    for (int it = 0; it < YT; ++it) {
      const int i = it * 8 + 2 * t4;
      const float e0 = ecs[i], e1 = ecs[i + 1];
      yt[it][0] *= e0;
      yt[it][1] *= e1;
      yt[it][2] *= e0;
      yt[it][3] *= e1;
    }
    unsigned xa[KJ][4];                 // x^T fragments: rows p, k = chunk rows j
#pragma unroll
    for (int kj = 0; kj < KJ; ++kj) {
      ldsm_x4_trans(xa[kj], xs + ((kj * 16 + (mat >> 1) * 8 + mrow) * XS + warp * 2 + (mat & 1)) * 8);
#pragma unroll
      for (int np = 0; np < KJ; ++np) {
        if (np < kj) continue;          // W is zero above the diagonal
        const int off = (np * 16 + (mat >> 1) * 8 + mrow) * WS * 8 + (kj * 2 + (mat & 1)) * 8;
        unsigned fh[4], fl[4];
        ldsm_x4(fh, ws + off);
        ldsm_x4(fl, wl + off);
        mma_bf16(yt[2 * np], xa[kj], fh);
        mma_bf16(yt[2 * np], xa[kj], fl);
        mma_bf16(yt[2 * np + 1], xa[kj], fh + 2);
        mma_bf16(yt[2 * np + 1], xa[kj], fl + 2);
      }
    }
#pragma unroll
    for (int it = 0; it < YT; ++it)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = it * 8 + 2 * t4 + (e & 1), p = p0 + g + 8 * (e >> 1);
        if (i < L) y[(((size_t)b * S + c0 + i) * H + h) * P + p] = __float2bfloat16_rn(yt[it][e]);
      }

    // h = exp(cs_last) h + (f o x)^T B, f o x in two bf16 terms
    const float decay = ecs[L - 1];
#pragma unroll
    for (int nt = 0; nt < NTM; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] *= decay;
#pragma unroll
    for (int kj = 0; kj < KJ; ++kj) {
      const int j = kj * 16 + 2 * t4;
      const float f0 = fv[j], f1 = fv[j + 1], f8 = fv[j + 8], f9 = fv[j + 9];
      unsigned hi[4], lo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {     // a0, a1: columns j, j+1; a2, a3: j+8, j+9
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&xa[kj][q]);
        const float fl = q < 2 ? f0 : f8, fh = q < 2 ? f1 : f9;
        split2(__low2float(v) * fl, __high2float(v) * fh, hi[q], lo[q]);
      }
#pragma unroll
      for (int nn = 0; nn < NTM / 2; ++nn) {
        if (nn >= N / 16) break;
        unsigned fb[4];
        ldsm_x4_trans(fb, bs + ((kj * 16 + (mat & 1) * 8 + mrow) * NS + nn * 2 + (mat >> 1)) * 8);
        mma_bf16(st[2 * nn], hi, fb);
        mma_bf16(st[2 * nn], lo, fb);
        mma_bf16(st[2 * nn + 1], hi, fb + 2);
        mma_bf16(st[2 * nn + 1], lo, fb + 2);
      }
    }
  }

#pragma unroll
  for (int nt = 0; nt < NTM; ++nt) {
    if (nt >= nt_n) break;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const size_t gi = (row_bh * P + p0 + g + 8 * r) * N + nt * 8 + 2 * t4;
      *reinterpret_cast<float2*>(st_out + gi) = make_float2(st[nt][2 * r], st[nt][2 * r + 1]);
    }
  }
}

template <int LP>
int launch_mma(const void* x, const void* dt, const void* B, const void* C, const void* A,
               const void* s0, const void* s0_scale, void* y, void* st_out, int Bt, int S,
               int H, int P, int N, int s0_kind, cudaStream_t stream) {
  auto kernel = ssd_mma_kernel<LP>;
  const int smem = mma_smem_bytes(LP, P, N);
  static int granted = 48 * 1024;       // dynamic shared memory allowed so far
  if (smem > granted) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    granted = smem;
  }
  kernel<<<dim3(H, Bt), P / 16 * 32, smem, stream>>>(
      (const bf16*)x, (const float*)dt, (const bf16*)B, (const bf16*)C, (const float*)A,
      s0_kind == 1 ? (const float*)s0 : nullptr, s0_kind == 2 ? (const int8_t*)s0 : nullptr,
      s0_kind == 2 ? (const float*)s0_scale : nullptr, (bf16*)y, (float*)st_out, S, H, P, N);
  return (int)cudaGetLastError();
}

// ------------------------------------------------ float32: CUDA cores
constexpr int TP = 16;    // state rows (head_dim columns) per block
constexpr int NT = 128;   // threads per block

size_t simt_smem_bytes(int S, int N) {
  const size_t ns = (size_t)N + 1, ql = S < Q ? S : Q;
  return sizeof(float) * (2 * ql * ns + TP * ns + ql * TP + ql * (ql + 1) + 3 * ql);
}

__global__ void __launch_bounds__(NT)
ssd_simt_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ Bm, const float* __restrict__ Cm,
                const float* __restrict__ A, const float* __restrict__ s0f,
                const int8_t* __restrict__ s0q, const float* __restrict__ s0scale,
                float* __restrict__ y, float* __restrict__ st_out,
                int S, int H, int P, int N) {
  extern __shared__ float fsmem[];
  const int NS = N + 1;
  const int QL = min(Q, S);         // chunk rows held
  float* Bs = fsmem;                // [QL][NS]
  float* Cs = Bs + QL * NS;         // [QL][NS]
  float* st = Cs + QL * NS;         // [TP][NS]   the state tile
  float* xs = st + TP * NS;         // [QL][TP]
  float* W = xs + QL * TP;          // [QL][QL + 1]
  float* cs = W + QL * (QL + 1);    // [QL]  inclusive cumsum of dt * A
  float* dtv = cs + QL;             // [QL]
  float* wend = dtv + QL;           // [QL]  exp(cs_last - cs_j) * dt_j

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
      Bs[i * NS + n] = Bm[g];
      Cs[i * NS + n] = Cm[g];
    }
    for (int e = tid; e < L * TP; e += NT) {
      const int i = e / TP, p = e % TP;
      xs[i * TP + p] = x[(((size_t)b * S + c0 + i) * H + h) * P + p0 + p];
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
      W[i * (QL + 1) + j] = w;
    }
    __syncthreads();
    for (int e = tid; e < L * TP; e += NT) {
      const int i = e / TP, p = e % TP;
      float intra = 0.f;
      for (int j = 0; j <= i; ++j) intra = fmaf(W[i * (QL + 1) + j], xs[j * TP + p], intra);
      float inter = 0.f;
      for (int n = 0; n < N; ++n) inter = fmaf(Cs[i * NS + n], st[p * NS + n], inter);
      y[(((size_t)b * S + c0 + i) * H + h) * P + p0 + p] =
          fmaf(expf(cs[i]), inter, intra);
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

int launch_simt(const void* x, const void* dt, const void* B, const void* C, const void* A,
                const void* s0, const void* s0_scale, void* y, void* st_out, int Bt, int S,
                int H, int P, int N, int s0_kind, cudaStream_t stream) {
  static int granted = 48 * 1024;       // dynamic shared memory allowed so far
  const int smem = (int)simt_smem_bytes(S, N);
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_simt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    granted = smem;
  }
  dim3 grid(P / TP, H, Bt);
  ssd_simt_kernel<<<grid, NT, smem, stream>>>(
      (const float*)x, (const float*)dt, (const float*)B, (const float*)C, (const float*)A,
      s0_kind == 1 ? (const float*)s0 : nullptr,
      s0_kind == 2 ? (const int8_t*)s0 : nullptr,
      s0_kind == 2 ? (const float*)s0_scale : nullptr, (float*)y, (float*)st_out, S, H, P, N);
  return (int)cudaGetLastError();
}

}  // namespace

// s0_kind: 0 = zero initial state, 1 = float32 state0, 2 = int8 state0 with
// (Bt, H) float32 scales.  dtype (x, B, C, y): 0 = float32 (CUDA cores; P a
// multiple of 16, N <= 256), 1 = bfloat16 (tensor cores; P and N multiples
// of 16 up to 128, x, B, C 16-byte aligned).  All tensors contiguous
// row-major.  Returns a CUDA error code: a shape no kernel takes is
// cudaErrorInvalidValue.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* B, const void* C,
                              const void* A, const void* s0, const void* s0_scale, void* y,
                              void* st_out, int Bt, int S, int H, int P, int N, int s0_kind,
                              int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (Bt <= 0 || S <= 0 || H <= 0 || P % 16 || P <= 0 || N <= 0 || s0_kind < 0 || s0_kind > 2)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (N > 256) return (int)cudaErrorInvalidValue;
    return launch_simt(x, dt, B, C, A, s0, s0_scale, y, st_out, Bt, S, H, P, N, s0_kind, s);
  }
  if (dtype != 1 || P > MMA_MAX_P || N % 16 || N > MMA_MAX_N) return (int)cudaErrorInvalidValue;
  switch (chunk_rows(S)) {
    case 16:
      return launch_mma<16>(x, dt, B, C, A, s0, s0_scale, y, st_out, Bt, S, H, P, N, s0_kind, s);
    case 32:
      return launch_mma<32>(x, dt, B, C, A, s0, s0_scale, y, st_out, Bt, S, H, P, N, s0_kind, s);
    case 48:
      return launch_mma<48>(x, dt, B, C, A, s0, s0_scale, y, st_out, Bt, S, H, P, N, s0_kind, s);
    default:
      return launch_mma<64>(x, dt, B, C, A, s0, s0_scale, y, st_out, Bt, S, H, P, N, s0_kind, s);
  }
}
