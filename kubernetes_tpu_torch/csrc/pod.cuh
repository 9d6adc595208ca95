// The per-(pod, node row) step of the classic scan: the pod's feasibility
// at one row against the row's effective usage, and its base score there.
// Included by pod_scan.cu (K7) and filter_score.cu (K8, which stages its
// rows and tests them as ktpu_pod_fits does without the overlay); written
// so that a member scan (the gang kernel's trial window over the same
// step) can include it as well.
//
// Replaces kubernetes_tpu/scheduler/kernels/batch.py _pod_feasible (:117)
// and _pod_score (:127) with _least_requested / _balanced_allocation
// (:84 / :98). LeastRequested + BalancedAllocation are the same f32
// arithmetic as the class route's _class_resource_score (:282-303, which
// says so at :287-289), so ktpu_pod_base calls ktpu_resource_score: one
// copy on the card for both routes.
#pragma once

#include "score.cuh"

// One pod's batch-varying rows: its request [R], its non-zero cpu and
// memory request (the scores' column), and whether memory pressure
// blocks it.
struct KtpuPod {
  const float* req;   // [R]
  float nz0, nz1;
  bool blocked;
};

// _pod_feasible at row r. The effective usage is the reference's
// (used + nom used) - (self ? req : 0) and (count + nom count) -
// (self ? 1 : 0), in that association (batch.py :705-709): the nominee's
// own reservation is taken out at its nominated row only, and every other
// row subtracts 0.0, which is exact. Without the overlay (nom_r null) the
// usage is read as it is (the reference adds and subtracts zeros).
// `mask` is the pod's static mask at the row.
//
// ktpu_pod_fits_ex takes the exemption as a row of its own: `ex_r` [R]
// and `ex_cnt` are what the row's reservations less (null: 0.0). The gang
// scan passes its unit's reservations there (gang_scan.cu).
__device__ __forceinline__ bool ktpu_pod_fits_ex(
    const KtpuNodeCfg& cfg, int r, int R, const KtpuPod& pod, bool mask,
    const float* used_r, const float* nom_r, float cnt, float nom_cnt,
    const float* ex_r, float ex_cnt) {
  if (!(mask && cfg.node_ok[r] && cfg.valid[r])) return false;
  if (pod.blocked && cfg.mem_pressure[r]) return false;
  float c = cnt;
  if (nom_r != nullptr) c = __fsub_rn(__fadd_rn(cnt, nom_cnt), ex_cnt);
  if (!(__fadd_rn(c, 1.0f) <= cfg.max_pods[r])) return false;
  const float* alloc_r = cfg.alloc + (size_t)r * R;
  for (int j = 0; j < R; ++j) {
    float eff = used_r[j];
    if (nom_r != nullptr)
      eff = __fsub_rn(__fadd_rn(eff, nom_r[j]),
                      ex_r != nullptr ? ex_r[j] : 0.0f);
    if (!(__fadd_rn(pod.req[j], eff) <= alloc_r[j])) return false;
  }
  return true;
}

__device__ __forceinline__ bool ktpu_pod_fits(
    const KtpuNodeCfg& cfg, int r, int R, const KtpuPod& pod, bool mask,
    const float* used_r, const float* nom_r, float cnt, float nom_cnt,
    bool self) {
  return ktpu_pod_fits_ex(cfg, r, R, pod, mask, used_r, nom_r, cnt, nom_cnt,
                          self ? pod.req : nullptr, self ? 1.0f : 0.0f);
}

// LeastRequested + BalancedAllocation of _pod_score at a row: rw0 and rw1
// over the row's non-zero usage plus the pod's non-zero request (K8
// takes it apart from the static score, on the rows a pod fits).
__device__ __forceinline__ float ktpu_pod_resource_at(
    float alloc0, float alloc1, float nz_used0, float nz_used1,
    float pod_nz0, float pod_nz1, float rw0, float rw1) {
  return ktpu_resource_score(alloc0, alloc1, __fadd_rn(nz_used0, pod_nz0),
                             __fadd_rn(nz_used1, pod_nz1), rw0, rw1);
}

// _pod_score at a row from its values: ktpu_pod_resource_at, then the
// pod's static score at the row, each a rounding of its own
__device__ __forceinline__ float ktpu_pod_base_at(
    float alloc0, float alloc1, float nz_used0, float nz_used1,
    float pod_nz0, float pod_nz1, float rw0, float rw1,
    float static_score) {
  return __fadd_rn(ktpu_pod_resource_at(alloc0, alloc1, nz_used0, nz_used1,
                                        pod_nz0, pod_nz1, rw0, rw1),
                   static_score);
}

// _pod_score at row r of the tables
__device__ __forceinline__ float ktpu_pod_base(
    const KtpuNodeCfg& cfg, int r, int R, const KtpuPod& pod, float nz_used0,
    float nz_used1, float rw0, float rw1, float static_score) {
  const float* alloc_r = cfg.alloc + (size_t)r * R;
  return ktpu_pod_base_at(alloc_r[0], alloc_r[1], nz_used0, nz_used1,
                          pod.nz0, pod.nz1, rw0, rw1, static_score);
}
