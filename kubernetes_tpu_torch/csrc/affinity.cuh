// The inter-pod affinity carries of the class scan (K2): required
// (anti-)affinity counters and preferred credits, per pod and per node
// row, with the winner's writes. Included by class_scan.cu.
//
// Replaces kubernetes_tpu/scheduler/kernels/batch.py _term_hits (:356),
// _topo_bad (:366), _topo_scatter (:387), _soft_raw (:254), _soft_score
// (:269) and _soft_write (:429). Every table is [terms, rows] or [terms,
// domains]; a term id of -1 is padding and a domain of -1 means "the node
// carries no value for the term's topology key": neither ever hits, and
// the writes they make add 0.0 at the clamped index, as the reference's
// .at[].add does. The counts are integer-valued f32 below 2^24, so their
// sums are exact in any order; the writes still run on one thread in k
// order, with no float atomics.
#pragma once

#include "score.cuh"

struct KtpuTopo {
  const int* dom;           // [T, N] term -> node's domain, -1 none
  float* cnt;               // [T, D] winners matching the term, in/out
  float* tot;               // [T]    the same summed over domains
  float* carry;             // [T, D] winners carrying it (dir2 only)
  const int* anti_tids;     // [P, K] terms the pod carries as anti
  const int* aff_tids;      // [P, K] waived required affinity terms
  const int* match_tids;    // [P, K] terms the pod matches
  const int* cmatch_tids;   // [P, K] dir2 reads (matches of carried)
  const int* canti_tids;    // [P, K] dir2 writes
  int T, D, K, dir2;
};

struct KtpuSoft {
  const int* dom;           // [Ts, N]
  float* cnt;               // [Ts, Ds] credit accumulators, in/out
  const float* base;        // [Sb, N]  frozen raw row per template
  const int* base_idx;      // [P]      -1: the pod takes no soft term
  const int* read_tids;     // [P, Ks]
  const float* read_w;      // [P, Ks]  signed read weights
  const int* write_tids;    // [P, Ks]
  const float* write_w;     // [P, Ks]
  const float* weight;      // scalar: the InterPodAffinityPriority weight
  int Ds, Ks;
};

// _term_hits for one (term, row): the row's domain holds a hit in `table`
__device__ __forceinline__ bool ktpu_term_hit(const int* dom,
                                              const float* table, int t,
                                              int r, int N, int D) {
  if (t < 0) return false;
  const int d = dom[(size_t)t * N + r];
  return d >= 0 && table[(size_t)t * D + d] > 0.0f;
}

// _topo_bad for pod p at row r: direction 1 (an anti term the pod
// carries is matched in the row's domain), direction 2 (a term the pod
// matches is carried there) and waived required affinity (some winner
// matched the term, but none in this row's domain)
__device__ __forceinline__ bool ktpu_topo_bad(const KtpuTopo& tp, int p,
                                              int r, int N) {
  const size_t row = (size_t)p * tp.K;
  for (int k = 0; k < tp.K; ++k) {
    if (ktpu_term_hit(tp.dom, tp.cnt, tp.anti_tids[row + k], r, N, tp.D))
      return true;
    if (tp.dir2 && ktpu_term_hit(tp.dom, tp.carry, tp.cmatch_tids[row + k],
                                 r, N, tp.D))
      return true;
    const int t = tp.aff_tids[row + k];
    if (t >= 0 && tp.tot[t] > 0.0f &&
        !ktpu_term_hit(tp.dom, tp.cnt, t, r, N, tp.D))
      return true;
  }
  return false;
}

// add 1.0 (0.0 for a pad, an out-of-domain entry or a pod that did not
// bind) at (term, the winner's domain) for each of the pod's K terms
__device__ __forceinline__ void ktpu_scatter_counts(
    const int* dom, float* table, float* tot, const int* tids, int K,
    int D, int best, int N, bool ok) {
  for (int k = 0; k < K; ++k) {
    const int t = tids[k];
    const int tc = t > 0 ? t : 0;
    const int d = dom[(size_t)tc * N + best];
    const float val = (t >= 0 && d >= 0 && ok) ? 1.0f : 0.0f;
    float* x = table + (size_t)tc * D + (d > 0 ? d : 0);
    *x = __fadd_rn(*x, val);
    if (tot != nullptr) tot[tc] = __fadd_rn(tot[tc], val);
  }
}

// _topo_scatter: the winner's match counts (and carry counts with dir2)
__device__ __forceinline__ void ktpu_topo_scatter(const KtpuTopo& tp,
                                                  int p, int best, int N,
                                                  bool ok) {
  const size_t row = (size_t)p * tp.K;
  ktpu_scatter_counts(tp.dom, tp.cnt, tp.tot, tp.match_tids + row, tp.K,
                      tp.D, best, N, ok);
  if (tp.dir2)
    ktpu_scatter_counts(tp.dom, tp.carry, nullptr, tp.canti_tids + row,
                        tp.K, tp.D, best, N, ok);
}

// _soft_raw for pod p at row r: the template's base row plus the signed
// running credits, summed k ascending (where, then multiply: a negative
// weight on a zero count is -0.0, as in the reference)
__device__ __forceinline__ float ktpu_soft_raw(const KtpuSoft& sf, int p,
                                               int r, int N) {
  const size_t row = (size_t)p * sf.Ks;
  float delta = 0.0f;
  for (int k = 0; k < sf.Ks; ++k) {
    const int t = sf.read_tids[row + k];
    const int tc = t > 0 ? t : 0;
    const int d = sf.dom[(size_t)tc * N + r];
    const float at = (t >= 0 && d >= 0)
        ? sf.cnt[(size_t)tc * sf.Ds + d] : 0.0f;
    delta = __fadd_rn(delta, __fmul_rn(sf.read_w[row + k], at));
  }
  const int bi = sf.base_idx[p] > 0 ? sf.base_idx[p] : 0;
  return __fadd_rn(sf.base[(size_t)bi * N + r], delta);
}

// _soft_score at one row from the block's min (mn) and max (mx) of raw
// over the feasible rows; exactly 0.0 without a span (no feasible row
// gives mn = +inf and NaN arithmetic, which the branch never returns) or
// for a pod without a soft term
__device__ __forceinline__ float ktpu_soft_term(float raw, float mn,
                                                float mx, bool use,
                                                float weight) {
  const bool span_ok = mx > mn && isfinite(mn);
  if (!(span_ok && use)) return 0.0f;
  const float norm = floorf(__fadd_rn(
      __fdiv_rn(__fmul_rn(KTPU_MAX_PRIORITY, __fsub_rn(raw, mn)),
                fmaxf(__fsub_rn(mx, mn), 1e-30f)),
      4e-6f));
  return __fmul_rn(weight, norm);
}

// _soft_write: the winner's credits at the chosen node's domains
__device__ __forceinline__ void ktpu_soft_write(const KtpuSoft& sf, int p,
                                                int best, int N, bool ok) {
  const size_t row = (size_t)p * sf.Ks;
  for (int k = 0; k < sf.Ks; ++k) {
    const int t = sf.write_tids[row + k];
    const int tc = t > 0 ? t : 0;
    const int d = sf.dom[(size_t)tc * N + best];
    const float w = (t >= 0 && d >= 0 && ok) ? sf.write_w[row + k] : 0.0f;
    float* x = sf.cnt + (size_t)tc * sf.Ds + (d > 0 ? d : 0);
    *x = __fadd_rn(*x, w);
  }
}
