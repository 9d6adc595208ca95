// K13: the required inter-pod (anti-)affinity mask of a batch's templates.
//
// Replaces kubernetes_tpu/scheduler/kernels/affinity.py
// _affinity_masks_jit (:39), which XLA lowered to three matrix products on
// the TPU:
//
//   viol[u, n] = (sum_t sd[u, t] * (1 - hd[t, n])
//                 + sum_t sp[u, t] * (1 - pr[t, n]))
//                + sum_t sa[u, t] * pr[t, n],     pr = present & has_dom
//   mask[u, n] = viol[u, n] == 0
//
// has_dom / present are bool [T, N], the three selectors f32 [U, T], the
// mask bool [U, N] (U, T are the wrapper's power-of-two buckets).
//
// Exact: TopologyIndex.required_masks only ever passes 0/1 selectors, so
// every product is 0 or 1 and every partial sum an integer below 2^24,
// exact in any order. The three sums run in ascending term order with
// __fmul_rn / __fadd_rn (no contraction under -fmad=false) and add as
// (a + b) + c, so the mask equals the plain version's, and JAX's, bit for
// bit.
//
// Bound: operations. 6·U·T·N f32 operations (a multiply and an add per
// term of each sum) against 2·T·N + 12·U·T + U·N bytes: at U = 1,024,
// T = 2,048, N = 8,192, 1.0e11 operations (1.5 ms at 67 TFLOP/s) against
// 67 MB (0.020 ms at 3.35 TB/s).
//
// Design: a 256-thread block owns a 64-template x 64-node tile of the
// mask; each thread keeps 4 templates x 4 nodes x 3 sums in registers.
// The term axis runs in chunks of 16: the block stages the three selector
// tiles (transposed, so a thread reads its 4 templates as one float4) and
// the 0/1 has_dom / present' values (read as bytes, coalesced along the
// nodes) in shared memory, then every thread walks the chunk. A thread's
// nodes are 16 apart, so a warp's reads of the node tile fall on distinct
// banks. No tensor cores: the mask is exact in f32 here, and a bit-packed
// or int8 form is later work.
#include <cuda_runtime.h>
#include <stdint.h>

#define KTPU_AM_TU 64       // templates per block tile
#define KTPU_AM_TN 64       // nodes per block tile
#define KTPU_AM_TT 16       // terms per shared-memory chunk
#define KTPU_AM_PAD 4       // row padding of the selector tiles
#define KTPU_AM_THREADS 256

__global__ void __launch_bounds__(KTPU_AM_THREADS)
ktpu_affinity_masks_kernel(const unsigned char* __restrict__ hd,
                           const unsigned char* __restrict__ pr,
                           const float* __restrict__ sd,
                           const float* __restrict__ sp,
                           const float* __restrict__ sa,
                           unsigned char* __restrict__ out, int U, int T,
                           int N) {
  __shared__ __align__(16)
      float s_sel[3][KTPU_AM_TT][KTPU_AM_TU + KTPU_AM_PAD];
  __shared__ float s_hd[KTPU_AM_TT][KTPU_AM_TN];
  __shared__ float s_pr[KTPU_AM_TT][KTPU_AM_TN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int u0 = blockIdx.y * KTPU_AM_TU, n0 = blockIdx.x * KTPU_AM_TN;
  float a[4][4], b[4][4], c[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = b[i][j] = c[i][j] = 0.0f;

  for (int t0 = 0; t0 < T; t0 += KTPU_AM_TT) {
    for (int i = tid; i < KTPU_AM_TT * KTPU_AM_TN; i += KTPU_AM_THREADS) {
      const int tt = i / KTPU_AM_TN, nn = i % KTPU_AM_TN;
      const int t = t0 + tt, n = n0 + nn;
      bool h = false, p = false;
      if (t < T && n < N) {
        const size_t o = (size_t)t * N + n;
        h = hd[o] != 0;
        p = h && pr[o] != 0;
      }
      s_hd[tt][nn] = h ? 1.0f : 0.0f;
      s_pr[tt][nn] = p ? 1.0f : 0.0f;
    }
    for (int i = tid; i < KTPU_AM_TU * KTPU_AM_TT; i += KTPU_AM_THREADS) {
      const int uu = i / KTPU_AM_TT, tt = i % KTPU_AM_TT;
      const int u = u0 + uu, t = t0 + tt;
      float x = 0.0f, y = 0.0f, z = 0.0f;
      if (u < U && t < T) {
        const size_t o = (size_t)u * T + t;
        x = sd[o];
        y = sp[o];
        z = sa[o];
      }
      s_sel[0][tt][uu] = x;
      s_sel[1][tt][uu] = y;
      s_sel[2][tt][uu] = z;
    }
    __syncthreads();
    const int tn = T - t0 < KTPU_AM_TT ? T - t0 : KTPU_AM_TT;
    for (int tt = 0; tt < tn; ++tt) {
      const float4 vd =
          *reinterpret_cast<const float4*>(&s_sel[0][tt][ty * 4]);
      const float4 vp =
          *reinterpret_cast<const float4*>(&s_sel[1][tt][ty * 4]);
      const float4 va =
          *reinterpret_cast<const float4*>(&s_sel[2][tt][ty * 4]);
      const float wd[4] = {vd.x, vd.y, vd.z, vd.w};
      const float wp[4] = {vp.x, vp.y, vp.z, vp.w};
      const float wa[4] = {va.x, va.y, va.z, va.w};
      float xd[4], xp[4], xa[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float h = s_hd[tt][tx + 16 * j];
        const float p = s_pr[tt][tx + 16 * j];
        xd[j] = __fsub_rn(1.0f, h);
        xp[j] = __fsub_rn(1.0f, p);
        xa[j] = p;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          a[i][j] = __fadd_rn(a[i][j], __fmul_rn(wd[i], xd[j]));
          b[i][j] = __fadd_rn(b[i][j], __fmul_rn(wp[i], xp[j]));
          c[i][j] = __fadd_rn(c[i][j], __fmul_rn(wa[i], xa[j]));
        }
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
      if (n < N)
        out[(size_t)u * N + n] =
            __fadd_rn(__fadd_rn(a[i][j], b[i][j]), c[i][j]) == 0.0f;
    }
  }
}

extern "C" int ktpu_affinity_masks(const bool* has_dom, const bool* present,
                                   const float* sel_dom,
                                   const float* sel_present,
                                   const float* sel_absent, bool* out, int U,
                                   int T, int N, void* stream) {
  if (U < 0 || T < 0 || N < 0) return (int)cudaErrorInvalidValue;
  if (U == 0 || N == 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((N + KTPU_AM_TN - 1) / KTPU_AM_TN),
                  (unsigned)((U + KTPU_AM_TU - 1) / KTPU_AM_TU));
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  ktpu_affinity_masks_kernel<<<grid, KTPU_AM_THREADS, 0,
                               (cudaStream_t)stream>>>(
      reinterpret_cast<const unsigned char*>(has_dom),
      reinterpret_cast<const unsigned char*>(present), sel_dom, sel_present,
      sel_absent, reinterpret_cast<unsigned char*>(out), U, T, N);
  return (int)cudaGetLastError();
}
