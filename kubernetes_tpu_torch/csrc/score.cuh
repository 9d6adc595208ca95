// Shared f32 arithmetic of the class scan: the masked score of one
// (template class, node row) pair, the SelectorSpread score of one node,
// and the (row, seq) tie-break hash. Included by class_ms_init.cu (K1)
// and class_scan.cu (K2) so the table build and the scan's winner-column
// refresh can never drift apart.
//
// Bit-exactness with the JAX reference (kubernetes_tpu/scheduler/kernels/
// batch.py) is the contract: every add, multiply and divide below is an
// explicit round-to-nearest intrinsic, so no FMA contraction can merge a
// multiply into the following add (the library is also built with
// -fmad=false), and every division is IEEE division, not a reciprocal.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define KTPU_NEG (-1e30f)
#define KTPU_NEG_THRESHOLD (-1e29f)
#define KTPU_MAX_PRIORITY 10.0f
// SelectorSpread zone blend: the reference rounds the Python doubles
// (1 - 2/3) and 2/3 to f32 at the multiply; the casts below do the same
#define KTPU_NODE_WEIGHT ((float)(1.0 - 2.0 / 3.0))
#define KTPU_ZONE_WEIGHT ((float)(2.0 / 3.0))
// tie penalty scale 0.5 / 65536 = 2^-17 (exact in f32)
#define KTPU_TIE_SCALE 7.62939453125e-06f

struct KtpuNodeCfg {
  const float* alloc;        // [N, R]
  const float* max_pods;     // [N]
  const bool* node_ok;       // [N]
  const bool* mem_pressure;  // [N]
  const bool* valid;         // [N]
};

struct KtpuClasses {
  const float* req;          // [C, R]
  const float* nz;           // [C, 2]
  const bool* blocked;       // [C]
  const int* mask_idx;       // [C]
  const int* score_idx;      // [C]
  const bool* unique_masks;  // [M, N]
  const float* unique_scores;  // [S, N]
  int C;
};

// LeastRequested + BalancedAllocation (batch.py _class_resource_score)
__device__ __forceinline__ float ktpu_resource_score(
    float cap_cpu, float cap_mem, float req_cpu, float req_mem,
    float rw0, float rw1) {
  const float safe_cpu = fmaxf(cap_cpu, 1.0f);
  const float safe_mem = fmaxf(cap_mem, 1.0f);
  const float lr_c = (cap_cpu > 0.0f && req_cpu <= cap_cpu)
      ? floorf(__fdiv_rn(__fmul_rn(__fsub_rn(cap_cpu, req_cpu),
                                   KTPU_MAX_PRIORITY), safe_cpu))
      : 0.0f;
  const float lr_m = (cap_mem > 0.0f && req_mem <= cap_mem)
      ? floorf(__fdiv_rn(__fmul_rn(__fsub_rn(cap_mem, req_mem),
                                   KTPU_MAX_PRIORITY), safe_mem))
      : 0.0f;
  const float lr = floorf(__fdiv_rn(__fadd_rn(lr_c, lr_m), 2.0f));
  const float cpu_frac = cap_cpu > 0.0f ? __fdiv_rn(req_cpu, safe_cpu)
                                        : 1.0f;
  const float mem_frac = cap_mem > 0.0f ? __fdiv_rn(req_mem, safe_mem)
                                        : 1.0f;
  float ba = floorf(__fadd_rn(
      __fmul_rn(__fsub_rn(1.0f, fabsf(__fsub_rn(cpu_frac, mem_frac))),
                KTPU_MAX_PRIORITY),
      4e-6f));
  if (cpu_frac >= 1.0f || mem_frac >= 1.0f) ba = 0.0f;
  return __fadd_rn(__fmul_rn(rw0, lr), __fmul_rn(rw1, ba));
}

// Masked score of class c at node row n (batch.py _class_col /
// _class_ms_init): NEG where the class does not fit. `used_n` is the
// node's [R] usage row; nz0/nz1/cnt its non-zero usage and pod count.
__device__ __forceinline__ float ktpu_class_score(
    const KtpuNodeCfg& cfg, const KtpuClasses& cl, float rw0, float rw1,
    int c, int n, int N, int R, const float* used_n, float nz0, float nz1,
    float cnt) {
  const float* alloc_n = cfg.alloc + (size_t)n * R;
  const float* req_c = cl.req + (size_t)c * R;
  bool fits = true;
  for (int r = 0; r < R; ++r)
    fits = fits && (__fadd_rn(req_c[r], used_n[r]) <= alloc_n[r]);
  fits = fits && (__fadd_rn(cnt, 1.0f) <= cfg.max_pods[n]);
  fits = fits && !(cl.blocked[c] && cfg.mem_pressure[n]);
  fits = fits && cfg.node_ok[n] && cfg.valid[n];
  fits = fits && cl.unique_masks[(size_t)cl.mask_idx[c] * N + n];
  const float s = __fadd_rn(
      ktpu_resource_score(alloc_n[0], alloc_n[1],
                          __fadd_rn(nz0, cl.nz[2 * c]),
                          __fadd_rn(nz1, cl.nz[2 * c + 1]), rw0, rw1),
      cl.unique_scores[(size_t)cl.score_idx[c] * N + n]);
  return fits ? s : KTPU_NEG;
}

// SelectorSpread score of one node (batch.py _spread_score) from the
// batch-wide reductions: maxc (max feasible count), zs (zone sums),
// maxz (max named-zone sum) and have_zones.
__device__ __forceinline__ float ktpu_spread_score(
    float cnt, int zone, const float* zs, int Z, float maxc, float maxz,
    bool have_zones) {
  const float node_s = maxc > 0.0f
      ? __fdiv_rn(__fmul_rn(KTPU_MAX_PRIORITY, __fsub_rn(maxc, cnt)),
                  fmaxf(maxc, 1.0f))
      : KTPU_MAX_PRIORITY;
  // out-of-range zone ids clamp, as the reference's gather does
  const int zi = zone < 0 ? 0 : (zone >= Z ? Z - 1 : zone);
  const float zone_s = (zone > 0 && maxz > 0.0f)
      ? __fdiv_rn(__fmul_rn(KTPU_MAX_PRIORITY, __fsub_rn(maxz, zs[zi])),
                  fmaxf(maxz, 1.0f))
      : KTPU_MAX_PRIORITY;
  const float blended = have_zones
      ? __fadd_rn(__fmul_rn(node_s, KTPU_NODE_WEIGHT),
                  __fmul_rn(KTPU_ZONE_WEIGHT, zone_s))
      : node_s;
  return floorf(blended);
}

// (row, seq) tie penalty (batch.py _tie_penalized): the int32 products
// wrap, so they are taken in uint32 (signed overflow is undefined in C++)
// with the same low 16 bits.
__device__ __forceinline__ float ktpu_tie_penalized(float masked, int row,
                                                    uint32_t seq_term) {
  const uint32_t h =
      ((uint32_t)row * 2654435769u + seq_term) & 0xFFFFu;
  return __fsub_rn(masked, __fmul_rn((float)h, KTPU_TIE_SCALE));
}
