// K14: the preferred inter-pod affinity scores of a batch's templates.
//
// Replaces kubernetes_tpu/scheduler/kernels/affinity.py
// _affinity_scores_jit (:47), a single XLA matrix product on the TPU:
//
//   out[u, n] = sum_t weights[u, t] * counts[t, n]
//
// weights f32 [U, T] (signed preferred-term weights), counts f32 [T, N]
// (match / carry counts), out f32 [U, N]. The whole of the JAX function is
// this product, so the product is the kernel (no library GEMM).
//
// Exactness: each output sums its terms in ascending term order, one
// correctly rounded __fmaf_rn a term (an explicit intrinsic: -fmad=false
// does not touch it). Preferred weights (1-100, signed) and counts are
// integers, and on integer-valued inputs whose partial sums stay below
// 2^24 every product and sum is exact, so the result equals the plain
// version's bit for bit. On arbitrary f32 inputs the term order differs
// from the plain product's: each order is within T · 2^-24 · sum_t |w · c|
// of the exact sum. No tensor cores: TF32 keeps 11 significant bits, and
// 3xTF32 drops the low x low product, so neither meets that bound on
// arbitrary f32.
//
// Bound: operations. 2·U·T·N f32 operations against 4·(U·T + T·N + U·N)
// bytes: at U = 1,024, T = 2,048, N = 8,192, 3.4e10 operations (0.51 ms
// at 67 TFLOP/s) against 109 MB (0.033 ms at 3.35 TB/s). An FFMA is two
// of those operations in one instruction, so the FP32 pipes are the limit
// and everything else has to hide behind them.
//
// Design: an FP32 SIMT GEMM. The 64 x 64 tile it replaces (4 x 4 sums a
// thread: 8 shared-memory loads for 16 multiply-adds, scalar global
// copies with no overlap, __fmul_rn + __fadd_rn, two instructions a term)
// took 2.24 ms. Here a 256-thread block owns a 128 x 128 output tile,
// 8 templates x 8 nodes a thread in registers (rows ty*4 + {0..3} and
// 64 + ty*4 + {0..3}, columns likewise from tx*4: two float4s of nodes, 64
// apart, so a warp's reads of a counts row are conflict-free). The term
// axis runs in chunks of KTPU_AS_BK = 8 through a ring of KTPU_AS_STAGES
// = 3 shared-memory stages filled by cp.async, one cp.async.wait_group
// and one barrier a chunk, the next two chunks' copies in flight under
// this chunk's arithmetic; the copy's source size zero-fills the tails in
// U, T and N. Two instances: where T and N are multiples of 4 and every
// base is 16-byte aligned (the padded shapes), 16-byte copies and float4
// stores; any other shape, 4-byte copies and scalar stores. At U =
// 1,024, T = 2,048, N = 8,192 on an H100 (700 W) the first took 0.925
// ms and the second 1.107 ms on the same values (chip_smoke.py's
// affinity_scores row and its ms_4byte_instance).
// cp.async cannot transpose, so the weight tile keeps the [U, T] layout
// (rows padded to 48 bytes) and a thread reads its 8 templates as
// float4s of 4 terms: per 4 terms, 8 float4 reads of weights and 8 of
// counts for 256 FFMAs. 161 registers (16-byte) and 127 (4-byte), no
// spill, under __launch_bounds__(256, 1). 30,720 bytes of static shared
// memory.
#include <cuda_runtime.h>
#include <stdint.h>

#define KTPU_AS_BM 128      // templates per block tile
#define KTPU_AS_BN 128      // nodes per block tile
#define KTPU_AS_BK 8        // terms per stage
#define KTPU_AS_WROW 12     // floats a weight-tile row (BK + 4 of padding)
#define KTPU_AS_STAGES 3    // shared-memory stages of the copy ring
#define KTPU_AS_THREADS 256

__device__ __forceinline__ void ktpu_cp_async16(float* dst, const float* src,
                                                int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void ktpu_cp_async4(float* dst, const float* src,
                                               int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void ktpu_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void ktpu_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// this thread's share of a stage's copies: a float4 of 4 terms of one
// weight-tile row and a float4 of 4 nodes of one counts-tile row
struct KtpuAsCopy {
  const float* w_row;   // weights[u, 0] of its template (w if u >= U)
  const float* c_col;   // counts[ck, n]: its row of the first chunk
  int wr, wk;           // its weight-tile row and term
  int ck, cn;           // its counts-tile row and node
  int n;                // the node of cn
  bool w_in;            // u < U
};

// copy the chunk of terms [t0, t0 + BK) into one stage; out-of-range
// elements read zero (source size 0, the source clamped to the tensor's
// start). VEC: T and N are multiples of 4 and every base 16-byte
// aligned, so a thread's 4 terms or 4 nodes are all in or all out and
// go in one 16-byte copy (and its 4 nodes of a row out in one float4
// store); otherwise in four 4-byte copies.
template <bool VEC>
__device__ __forceinline__ void ktpu_as_load(
    const KtpuAsCopy& cp, const float* __restrict__ w,
    const float* __restrict__ cnt, float (*s_w)[KTPU_AS_WROW],
    float (*s_c)[KTPU_AS_BN], int t0, int T, int N) {
  const int tw = t0 + cp.wk;
  float* dw = &s_w[cp.wr][cp.wk];
  const bool t_in = t0 + cp.ck < T;
  const float* src = cp.c_col + (size_t)t0 * N;
  float* dc = &s_c[cp.ck][cp.cn];
  if (VEC) {
    const bool wok = cp.w_in && tw < T;
    ktpu_cp_async16(dw, wok ? cp.w_row + tw : w, wok ? 16 : 0);
    const bool cok = t_in && cp.n < N;
    ktpu_cp_async16(dc, cok ? src : cnt, cok ? 16 : 0);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const bool ok = cp.w_in && tw + e < T;
    ktpu_cp_async4(dw + e, ok ? cp.w_row + tw + e : w, ok ? 4 : 0);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const bool ok = t_in && cp.n + e < N;
    ktpu_cp_async4(dc + e, ok ? src + e : cnt, ok ? 4 : 0);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(KTPU_AS_THREADS, 1)
ktpu_affinity_scores_kernel(const float* __restrict__ w,
                            const float* __restrict__ cnt,
                            float* __restrict__ out, int U, int T, int N) {
  __shared__ __align__(16) float s_w[KTPU_AS_STAGES][KTPU_AS_BM]
                                    [KTPU_AS_WROW];
  __shared__ __align__(16) float s_c[KTPU_AS_STAGES][KTPU_AS_BK]
                                    [KTPU_AS_BN];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int u0 = blockIdx.y * KTPU_AS_BM, n0 = blockIdx.x * KTPU_AS_BN;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  KtpuAsCopy cp;
  cp.wr = tid >> 1;
  cp.wk = (tid & 1) * 4;
  cp.ck = tid >> 5;
  cp.cn = (tid & 31) * 4;
  cp.n = n0 + cp.cn;
  cp.w_in = u0 + cp.wr < U;
  cp.w_row = cp.w_in ? w + (size_t)(u0 + cp.wr) * T : w;
  cp.c_col = cnt + (size_t)cp.ck * N + cp.n;

  const int n_chunks = (T + KTPU_AS_BK - 1) / KTPU_AS_BK;
#pragma unroll
  for (int s = 0; s < KTPU_AS_STAGES - 1; ++s) {
    if (s < n_chunks)
      ktpu_as_load<VEC>(cp, w, cnt, s_w[s], s_c[s], s * KTPU_AS_BK, T, N);
    ktpu_cp_async_commit();
  }
  for (int kc = 0; kc < n_chunks; ++kc) {
    // this thread's copies of chunk kc have landed; the barrier makes
    // everyone's visible and frees the stage chunk kc - 1 was read from
    ktpu_cp_async_wait<KTPU_AS_STAGES - 2>();
    __syncthreads();
    const int next = kc + KTPU_AS_STAGES - 1;
    if (next < n_chunks) {
      const int st = next % KTPU_AS_STAGES;
      ktpu_as_load<VEC>(cp, w, cnt, s_w[st], s_c[st], next * KTPU_AS_BK, T,
                        N);
    }
    ktpu_cp_async_commit();   // an empty group keeps the count in step

    const int st = kc % KTPU_AS_STAGES;
#pragma unroll
    for (int kk = 0; kk < KTPU_AS_BK; kk += 4) {
      float4 a[8];   // 4 terms of each of this thread's 8 templates
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            &s_w[st][(i >> 2) * 64 + ty * 4 + (i & 3)][kk]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 b0 =
            *reinterpret_cast<const float4*>(&s_c[st][kk + k][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&s_c[st][kk + k][64 + tx * 4]);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = k == 0 ? a[i].x : k == 1 ? a[i].y
                         : k == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = __fmaf_rn(av, b[j], acc[i][j]);
        }
      }
    }
  }
  ktpu_cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int u = u0 + (i >> 2) * 64 + ty * 4 + (i & 3);
    if (u >= U) continue;
    float* row = out + (size_t)u * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 64 + tx * 4;
      if (VEC) {   // N % 4 == 0: the float4 is all in or all out
        if (n < N)
          *reinterpret_cast<float4*>(row + n) =
              make_float4(acc[i][h * 4], acc[i][h * 4 + 1],
                          acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < N) row[n + e] = acc[i][h * 4 + e];
      }
    }
  }
}

extern "C" int ktpu_affinity_scores(const float* weights, const float* counts,
                                    float* out, int U, int T, int N,
                                    void* stream) {
  if (U < 0 || T < 0 || N < 0) return (int)cudaErrorInvalidValue;
  if (U == 0 || N == 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((N + KTPU_AS_BN - 1) / KTPU_AS_BN),
                  (unsigned)((U + KTPU_AS_BM - 1) / KTPU_AS_BM));
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec = T % 4 == 0 && N % 4 == 0 &&
                   (((uintptr_t)weights | (uintptr_t)counts |
                     (uintptr_t)out) & 15u) == 0;
  if (vec)
    ktpu_affinity_scores_kernel<true><<<grid, KTPU_AS_THREADS, 0, s>>>(
        weights, counts, out, U, T, N);
  else
    ktpu_affinity_scores_kernel<false><<<grid, KTPU_AS_THREADS, 0, s>>>(
        weights, counts, out, U, T, N);
  return (int)cudaGetLastError();
}
