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
// Exactness: the sum runs in ascending term order with __fmul_rn /
// __fadd_rn (no contraction under -fmad=false). Preferred weights (1-100,
// signed) and counts are integers, and on integer-valued inputs whose
// partial sums stay below 2^24 every product and sum is exact, so the
// result equals the plain version's bit for bit. On arbitrary f32 inputs
// the term order differs from the plain product's: each order is within
// T · 2^-24 · sum_t |w · c| of the exact sum.
//
// Bound: operations. 2·U·T·N f32 operations against 4·(U·T + T·N + U·N)
// bytes: at U = 1,024, T = 2,048, N = 8,192, 3.4e10 operations (0.51 ms
// at 67 TFLOP/s) against 109 MB (0.033 ms at 3.35 TB/s).
//
// Design: K13's tiling. A 256-thread block owns a 64 x 64 tile of the
// output, 4 templates x 4 nodes a thread in registers; the term axis runs
// in chunks of 16 staged in shared memory (the weight tile transposed, so
// a thread reads its 4 templates as one float4; the count tile read
// coalesced along the nodes); a thread's nodes are 16 apart.
#include <cuda_runtime.h>
#include <stdint.h>

#define KTPU_AS_TU 64       // templates per block tile
#define KTPU_AS_TN 64       // nodes per block tile
#define KTPU_AS_TT 16       // terms per shared-memory chunk
#define KTPU_AS_PAD 4       // row padding of the weight tile
#define KTPU_AS_THREADS 256

__global__ void __launch_bounds__(KTPU_AS_THREADS)
ktpu_affinity_scores_kernel(const float* __restrict__ w,
                            const float* __restrict__ cnt,
                            float* __restrict__ out, int U, int T, int N) {
  __shared__ __align__(16) float s_w[KTPU_AS_TT][KTPU_AS_TU + KTPU_AS_PAD];
  __shared__ float s_c[KTPU_AS_TT][KTPU_AS_TN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int u0 = blockIdx.y * KTPU_AS_TU, n0 = blockIdx.x * KTPU_AS_TN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int t0 = 0; t0 < T; t0 += KTPU_AS_TT) {
    for (int i = tid; i < KTPU_AS_TT * KTPU_AS_TN; i += KTPU_AS_THREADS) {
      const int tt = i / KTPU_AS_TN, nn = i % KTPU_AS_TN;
      const int t = t0 + tt, n = n0 + nn;
      s_c[tt][nn] = (t < T && n < N) ? cnt[(size_t)t * N + n] : 0.0f;
    }
    for (int i = tid; i < KTPU_AS_TU * KTPU_AS_TT; i += KTPU_AS_THREADS) {
      const int uu = i / KTPU_AS_TT, tt = i % KTPU_AS_TT;
      const int u = u0 + uu, t = t0 + tt;
      s_w[tt][uu] = (u < U && t < T) ? w[(size_t)u * T + t] : 0.0f;
    }
    __syncthreads();
    const int tn = T - t0 < KTPU_AS_TT ? T - t0 : KTPU_AS_TT;
    for (int tt = 0; tt < tn; ++tt) {
      const float4 v = *reinterpret_cast<const float4*>(&s_w[tt][ty * 4]);
      const float wv[4] = {v.x, v.y, v.z, v.w};
      float cv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) cv[j] = s_c[tt][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(wv[i], cv[j]));
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int u = u0 + ty * 4 + i;
    if (u >= U) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) out[(size_t)u * N + n] = acc[i][j];
    }
  }
}

extern "C" int ktpu_affinity_scores(const float* weights, const float* counts,
                                    float* out, int U, int T, int N,
                                    void* stream) {
  if (U < 0 || T < 0 || N < 0) return (int)cudaErrorInvalidValue;
  if (U == 0 || N == 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((N + KTPU_AS_TN - 1) / KTPU_AS_TN),
                  (unsigned)((U + KTPU_AS_TU - 1) / KTPU_AS_TU));
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  ktpu_affinity_scores_kernel<<<grid, KTPU_AS_THREADS, 0,
                                (cudaStream_t)stream>>>(weights, counts, out,
                                                        U, T, N);
  return (int)cudaGetLastError();
}
