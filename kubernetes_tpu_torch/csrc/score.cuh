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
// the widest usage row a kernel folds into a local or shared array (the
// nominated overlay); the wrappers check R against it
#define KTPU_MAX_R 64

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

// LeastRequested's term of one resource (batch.py _least_requested):
// 0 where the node has no capacity or the request exceeds it
__device__ __forceinline__ float ktpu_lr_term(float cap, float req) {
  return (cap > 0.0f && req <= cap)
      ? floorf(__fdiv_rn(__fmul_rn(__fsub_rn(cap, req), KTPU_MAX_PRIORITY),
                         fmaxf(cap, 1.0f)))
      : 0.0f;
}

// BalancedAllocation's fraction of one resource (batch.py
// _balanced_allocation): 1 where the node has no capacity
__device__ __forceinline__ float ktpu_frac_term(float cap, float req) {
  return cap > 0.0f ? __fdiv_rn(req, fmaxf(cap, 1.0f)) : 1.0f;
}

// the two terms of each resource combined: rw0 LeastRequested + rw1
// BalancedAllocation
__device__ __forceinline__ float ktpu_resource_combine(
    float lr_c, float lr_m, float cpu_frac, float mem_frac, float rw0,
    float rw1) {
  const float lr = floorf(__fdiv_rn(__fadd_rn(lr_c, lr_m), 2.0f));
  float ba = floorf(__fadd_rn(
      __fmul_rn(__fsub_rn(1.0f, fabsf(__fsub_rn(cpu_frac, mem_frac))),
                KTPU_MAX_PRIORITY),
      4e-6f));
  if (cpu_frac >= 1.0f || mem_frac >= 1.0f) ba = 0.0f;
  return __fadd_rn(__fmul_rn(rw0, lr), __fmul_rn(rw1, ba));
}

// LeastRequested + BalancedAllocation (batch.py _class_resource_score);
// its four divisions are independent, so a warp may split them over
// lanes (class_step.cuh's shared refresh) with the same roundings
__device__ __forceinline__ float ktpu_resource_score(
    float cap_cpu, float cap_mem, float req_cpu, float req_mem,
    float rw0, float rw1) {
  return ktpu_resource_combine(
      ktpu_lr_term(cap_cpu, req_cpu), ktpu_lr_term(cap_mem, req_mem),
      ktpu_frac_term(cap_cpu, req_cpu), ktpu_frac_term(cap_mem, req_mem),
      rw0, rw1);
}

// Masked score of one class at one node from values already read: the
// class's request row req_c [R], its non-zero request (cnz0, cnz1) and
// blocked flag, the node's allocatable row alloc_n [R], usage row used_n
// [R], non-zero usage, pod count, max pods, memory pressure, node_ok &&
// valid, the class's static mask and score at the node. NEG where the
// class does not fit.
__device__ __forceinline__ float ktpu_class_score_at(
    const float* req_c, float cnz0, float cnz1, bool blocked_c,
    const float* alloc_n, const float* used_n, float nz0, float nz1,
    float cnt, float max_pods_n, bool mem_pressure_n, bool ok_n,
    bool mask_v, float static_v, float rw0, float rw1, int R) {
  bool fits = true;
  for (int r = 0; r < R; ++r)
    fits = fits && (__fadd_rn(req_c[r], used_n[r]) <= alloc_n[r]);
  fits = fits && (__fadd_rn(cnt, 1.0f) <= max_pods_n);
  fits = fits && !(blocked_c && mem_pressure_n);
  fits = fits && ok_n;
  fits = fits && mask_v;
  const float s = __fadd_rn(
      ktpu_resource_score(alloc_n[0], alloc_n[1], __fadd_rn(nz0, cnz0),
                          __fadd_rn(nz1, cnz1), rw0, rw1),
      static_v);
  return fits ? s : KTPU_NEG;
}

// Masked score of class c at node row n (batch.py _class_col /
// _class_ms_init): ktpu_class_score_at on the tables. `used_n` is the
// node's [R] usage row; nz0/nz1/cnt its non-zero usage and pod count.
__device__ __forceinline__ float ktpu_class_score(
    const KtpuNodeCfg& cfg, const KtpuClasses& cl, float rw0, float rw1,
    int c, int n, int N, int R, const float* used_n, float nz0, float nz1,
    float cnt) {
  return ktpu_class_score_at(
      cl.req + (size_t)c * R, cl.nz[2 * c], cl.nz[2 * c + 1],
      cl.blocked[c], cfg.alloc + (size_t)n * R, used_n, nz0, nz1, cnt,
      cfg.max_pods[n], cfg.mem_pressure[n], cfg.node_ok[n] && cfg.valid[n],
      cl.unique_masks[(size_t)cl.mask_idx[c] * N + n],
      cl.unique_scores[(size_t)cl.score_idx[c] * N + n], rw0, rw1, R);
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

// ktpu_spread_score with the zone's part taken from a table: zpart is
// KTPU_ZONE_WEIGHT times the zone score of the node's zone, which
// ktpu_spread_zone_part computes once a zone (the same roundings)
__device__ __forceinline__ float ktpu_spread_zone_part(float zsum,
                                                      float maxz) {
  const float zone_s = maxz > 0.0f
      ? __fdiv_rn(__fmul_rn(KTPU_MAX_PRIORITY, __fsub_rn(maxz, zsum)),
                  fmaxf(maxz, 1.0f))
      : KTPU_MAX_PRIORITY;
  return __fmul_rn(KTPU_ZONE_WEIGHT, zone_s);
}

// the node's part of ktpu_spread_score: a function of its count alone,
// which a warp may compute once a count value
__device__ __forceinline__ float ktpu_spread_node_part(float cnt,
                                                       float maxc) {
  return maxc > 0.0f
      ? __fdiv_rn(__fmul_rn(KTPU_MAX_PRIORITY, __fsub_rn(maxc, cnt)),
                  fmaxf(maxc, 1.0f))
      : KTPU_MAX_PRIORITY;
}

// ktpu_spread_score from the node's part and the zone's
__device__ __forceinline__ float ktpu_spread_blend(float node_s,
                                                   float zpart,
                                                   bool have_zones) {
  const float blended = have_zones
      ? __fadd_rn(__fmul_rn(node_s, KTPU_NODE_WEIGHT), zpart)
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
