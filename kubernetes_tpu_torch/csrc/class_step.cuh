// One pod's step of the serial class scan, shared by K2 (class_scan.cu)
// and K12 (spec_scan.cu, whose repair branch replays a cohort through it),
// so the two cannot drift.
//
// Replaces kubernetes_tpu/scheduler/kernels/batch.py _class_pod_step
// (:503), the one shared copy the reference's serial scan and its
// speculative kernel's repair branch both run. In the reference's order:
//   1. feasibility: the pod's class row of the [C, N] masked-score
//      table, and with topology counters `fits &= ~topo_bad`; with the
//      nominated overlay (NOM) the table already holds the phantom
//      reservations, and the pod's own nominated row is recomputed with
//      its own reservation taken out (batch.py :515-528): the thread that
//      owns that row computes it once and uses it in both passes;
//   2. one block reduction over the feasible rows: with soft credits the
//      min and max of the raw inter-pod score; with spread groups the
//      max count, have_zones and the shared-memory zone sums
//      (integer-valued f32, exact in any order below 2^24);
//   3. score = base + soft + spread, the tie-penalized first-max argmax
//      (ties to the lowest row);
//   4. the winner's used / nonzero_used / pod_count / spread columns, and
//      on thread 0, in k order, its topology and credit writes;
//   5. the winner's column of the table refreshed over all C classes
//      (ktpu_class_score, shared with K1); with NOM against the winner's
//      usage plus its reservations (batch.py :556-562), folded into a
//      shared row as the usage columns are written;
//   6. assign and the bits of the chosen score into the packed [2, P].
// Every thread of the block calls it for the same pod; each thread owns
// node rows tid, tid + blockDim.x, ... It ends on a block barrier.
#pragma once

#include "score.cuh"
#include "affinity.cuh"

// The host's parameter block of the class scans: the pointer fields in the
// order of kubernetes_tpu_torch/scheduler/kernels/batch.py _SCAN_PTRS,
// then the ints of _SCAN_INTS (ctypes lays the Structure out as C does).
// A term's pointers are null when the batch does not carry it.
struct KtpuScanParams {
  const float* alloc;
  const float* max_pods;
  const bool* node_ok;
  const bool* mem_pressure;
  const bool* valid;
  const float* class_req;
  const float* class_nz;
  const bool* class_blocked;
  const int* class_mask_idx;
  const int* class_score_idx;
  const bool* unique_masks;
  const float* unique_scores;
  const float* rw;
  float* used;
  float* nz_used;
  float* pod_count;
  float* ms;
  const int* class_idx;
  const int* seq;
  const bool* active;
  const int* spread_gidx;
  const float* spread_match;
  float* spread;
  const int* zone_of;
  const float* zinit;
  const float* spread_w;
  const int* anti_dom;
  float* topo_cnt;
  float* topo_tot;
  float* topo_carry;
  const int* anti_tids;
  const int* aff_tids;
  const int* match_tids;
  const int* cmatch_tids;
  const int* canti_tids;
  const int* soft_dom;
  float* soft_cnt;
  const float* soft_base;
  const int* soft_base_idx;
  const int* read_tids;
  const float* read_w;
  const int* write_tids;
  const float* write_w;
  const float* soft_w;
  const float* nom_used;
  const float* nom_count;
  const int* nom_row;
  int* packed;
  int N, R, C, P, G, Z, T, D, K, Ts, Ds, Ks, Sb;
  int has_spread, has_topo, has_dir2, has_soft, has_nom;
};

struct KtpuScanArgs {
  KtpuNodeCfg cfg;
  KtpuClasses cl;
  const float* rw;          // [2]
  float* used;              // [N, R]   in/out (a copy of the input)
  float* nz_used;           // [N, 2]   in/out
  float* pod_count;         // [N]      in/out
  float* ms;                // [C, N]   in/out
  const int* class_idx;     // [P]
  const int* seq;           // [P]
  const bool* active;       // [P]
  const int* spread_gidx;   // [P]      (spread only)
  const float* spread_match;  // [P, G]
  float* spread;            // [G, N]   in/out
  const int* zone_of;       // [N]
  const float* zinit;       // [Z]
  const float* spread_w;    // scalar
  KtpuTopo topo;            // (topology counters only)
  KtpuSoft soft;            // (soft credits only)
  const float* nom_used;    // [N, R]   (nominated overlay only)
  const float* nom_count;   // [N]
  const int* nom_row;       // [P]      the pod's own nominated row or -1
  int N, R, C, P, G, Z;
  int* packed;              // [2, P]
};

static KtpuScanArgs ktpu_scan_args(const KtpuScanParams* h) {
  KtpuScanArgs a;
  a.cfg = KtpuNodeCfg{h->alloc, h->max_pods, h->node_ok, h->mem_pressure,
                      h->valid};
  a.cl = KtpuClasses{h->class_req, h->class_nz, h->class_blocked,
                     h->class_mask_idx, h->class_score_idx,
                     h->unique_masks, h->unique_scores, h->C};
  a.rw = h->rw;
  a.used = h->used;
  a.nz_used = h->nz_used;
  a.pod_count = h->pod_count;
  a.ms = h->ms;
  a.class_idx = h->class_idx;
  a.seq = h->seq;
  a.active = h->active;
  a.spread_gidx = h->spread_gidx;
  a.spread_match = h->spread_match;
  a.spread = h->spread;
  a.zone_of = h->zone_of;
  a.zinit = h->zinit;
  a.topo = KtpuTopo{h->anti_dom, h->topo_cnt, h->topo_tot, h->topo_carry,
                    h->anti_tids, h->aff_tids, h->match_tids,
                    h->cmatch_tids, h->canti_tids, h->T, h->D, h->K,
                    h->has_dir2};
  a.soft = KtpuSoft{h->soft_dom, h->soft_cnt, h->soft_base,
                    h->soft_base_idx, h->read_tids, h->read_w,
                    h->write_tids, h->write_w, h->soft_w, h->Ds, h->Ks};
  a.spread_w = h->spread_w;
  a.nom_used = h->nom_used;
  a.nom_count = h->nom_count;
  a.nom_row = h->nom_row;
  a.N = h->N;
  a.R = h->R;
  a.C = h->C;
  a.P = h->P;
  a.G = h->G;
  a.Z = h->has_spread ? h->Z : 0;
  a.packed = h->packed;
  return a;
}

// the instance (SPREAD, TOPO, SOFT) of a batch's terms, as the launchers'
// switch numbers it
static int ktpu_scan_terms(const KtpuScanParams* h) {
  return (h->has_spread ? 4 : 0) | (h->has_topo ? 2 : 0) |
         (h->has_soft ? 1 : 0);
}

// the step's loop invariants, read once per launch
struct KtpuStepConst {
  float rw0, rw1;           // resource weights
  float sw;                 // spread weight (SPREAD)
  float soft_w;             // InterPodAffinityPriority weight (SOFT)
};

template <bool SPREAD, bool SOFT>
__device__ __forceinline__ KtpuStepConst ktpu_step_const(
    const KtpuScanArgs& a) {
  return KtpuStepConst{a.rw[0], a.rw[1], SPREAD ? a.spread_w[0] : 0.0f,
                       SOFT ? a.soft.weight[0] : 0.0f};
}

// Pod p's step; zs is the dynamic shared [Z] of zone sums (SPREAD). Its
// own shared scratch (per-warp partials of the reductions; with NOM the
// winner's usage row plus its reservations, and the nominee's own row
// with its reservation taken out) is declared here, so an instance
// allocates only the arrays its terms use.
template <bool SPREAD, bool TOPO, bool SOFT, bool NOM>
__device__ __forceinline__ void ktpu_class_pod_step(
    const KtpuScanArgs& a, int p, const KtpuStepConst& kc, float* zs) {
  __shared__ float w_pen[32];
  __shared__ int w_row[32];
  __shared__ float w_val[32];
  __shared__ float w_maxc[32];
  __shared__ int w_hz[32];
  __shared__ float w_mn[32];
  __shared__ float w_mx[32];
  __shared__ float s_eff[NOM ? KTPU_MAX_R : 1];
  __shared__ float s_cnt;
  __shared__ float s_self[NOM ? KTPU_MAX_R : 1];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  const int N = a.N, R = a.R;
  const float rw0 = kc.rw0, rw1 = kc.rw1;
  const float inf = __int_as_float(0x7f800000);
  const int u = a.class_idx[p];
  const float* ms_u = a.ms + (size_t)u * N;
  const uint32_t seq_term = (uint32_t)a.seq[p] * 40503u;
  // the self-exempt base of the pod's own nominated row, on the thread
  // that owns the row (the only one that reads it)
  int nr = -1;
  float corr = 0.0f;
  if (NOM) {
    nr = a.nom_row[p];
    if (nr >= N) nr = -1;
    if (nr >= 0 && nr % nthreads == tid) {
      for (int j = 0; j < R; ++j)
        s_self[j] = __fsub_rn(
            __fadd_rn(a.used[(size_t)nr * R + j],
                      a.nom_used[(size_t)nr * R + j]),
            a.cl.req[(size_t)u * R + j]);
      corr = ktpu_class_score(
          a.cfg, a.cl, rw0, rw1, u, nr, N, R, s_self, a.nz_used[2 * nr],
          a.nz_used[2 * nr + 1],
          __fsub_rn(__fadd_rn(a.pod_count[nr], a.nom_count[nr]), 1.0f));
    }
  }

  // ---- reductions over the feasible set (soft min/max, spread)
  float maxc = 0.0f, maxz = 0.0f, sw_use = 0.0f, mn = inf, mx = -inf;
  bool have_zones = false;
  bool soft_use = false;
  const float* cnt_g = nullptr;
  if (SPREAD) {
    const int g = a.spread_gidx[p];
    sw_use = __fmul_rn(kc.sw, g >= 0 ? 1.0f : 0.0f);
    cnt_g = a.spread + (size_t)(g > 0 ? g : 0) * N;
    for (int z = tid; z < a.Z; z += nthreads) zs[z] = a.zinit[z];
    __syncthreads();
  }
  if (SOFT) soft_use = a.soft.base_idx[p] >= 0;
  if (SPREAD || SOFT) {
    float lmax = 0.0f, lmn = inf, lmx = -inf;
    int lhz = 0;
    for (int r = tid; r < N; r += nthreads) {
      const float base = (NOM && r == nr) ? corr : ms_u[r];
      bool fit = base > KTPU_NEG_THRESHOLD;
      if (TOPO) fit = fit && !ktpu_topo_bad(a.topo, p, r, N);
      if (SOFT && fit) {
        const float raw = ktpu_soft_raw(a.soft, p, r, N);
        lmn = fminf(lmn, raw);
        lmx = fmaxf(lmx, raw);
      }
      if (SPREAD) {
        const float cf = fit ? cnt_g[r] : 0.0f;
        const int z = a.zone_of[r];
        lmax = fmaxf(lmax, cf);
        if (fit && z > 0) lhz = 1;
        // zone 0 ("no zone label") never enters maxz or a zone score
        if (cf != 0.0f && z > 0 && z < a.Z) atomicAdd(&zs[z], cf);
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      if (SPREAD) {
        lmax = fmaxf(lmax, __shfl_xor_sync(0xffffffffu, lmax, o));
        lhz |= __shfl_xor_sync(0xffffffffu, lhz, o);
      }
      if (SOFT) {
        lmn = fminf(lmn, __shfl_xor_sync(0xffffffffu, lmn, o));
        lmx = fmaxf(lmx, __shfl_xor_sync(0xffffffffu, lmx, o));
      }
    }
    if (lane == 0) {
      w_maxc[warp] = lmax;
      w_hz[warp] = lhz;
      w_mn[warp] = lmn;
      w_mx[warp] = lmx;
    }
    __syncthreads();
    int hz = 0;
    for (int w = 0; w < nwarps; ++w) {
      maxc = fmaxf(maxc, w_maxc[w]);
      hz |= w_hz[w];
      mn = fminf(mn, w_mn[w]);
      mx = fmaxf(mx, w_mx[w]);
    }
    have_zones = hz != 0;
    if (SPREAD)
      for (int z = 1; z < a.Z; ++z) maxz = fmaxf(maxz, zs[z]);
  }

  // ---- tie-penalized first-max argmax over this thread's rows
  float bpen = -inf, bval = KTPU_NEG;
  int brow = 0x7fffffff;
  for (int r = tid; r < N; r += nthreads) {
    const float base = (NOM && r == nr) ? corr : ms_u[r];
    bool fit = base > KTPU_NEG_THRESHOLD;
    if (TOPO) fit = fit && !ktpu_topo_bad(a.topo, p, r, N);
    float score = base;
    if (SOFT)
      score = __fadd_rn(score, ktpu_soft_term(
          ktpu_soft_raw(a.soft, p, r, N), mn, mx, soft_use, kc.soft_w));
    if (SPREAD)
      score = __fadd_rn(score, __fmul_rn(sw_use, ktpu_spread_score(
          cnt_g[r], a.zone_of[r], zs, a.Z, maxc, maxz, have_zones)));
    const float masked = fit ? score : KTPU_NEG;
    const float pen = ktpu_tie_penalized(masked, r, seq_term);
    if (pen > bpen) {  // rows ascend: strict > keeps the first max
      bpen = pen;
      brow = r;
      bval = masked;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float open = __shfl_xor_sync(0xffffffffu, bpen, o);
    const int orow = __shfl_xor_sync(0xffffffffu, brow, o);
    const float oval = __shfl_xor_sync(0xffffffffu, bval, o);
    if (open > bpen || (open == bpen && orow < brow)) {
      bpen = open;
      brow = orow;
      bval = oval;
    }
  }
  if (lane == 0) {
    w_pen[warp] = bpen;
    w_row[warp] = brow;
    w_val[warp] = bval;
  }
  __syncthreads();
  bpen = w_pen[0];
  brow = w_row[0];
  bval = w_val[0];
  for (int w = 1; w < nwarps; ++w) {
    if (w_pen[w] > bpen || (w_pen[w] == bpen && w_row[w] < brow)) {
      bpen = w_pen[w];
      brow = w_row[w];
      bval = w_val[w];
    }
  }
  const int best = brow;
  const float chosen = bval;
  const bool ok = chosen > KTPU_NEG_THRESHOLD && a.active[p];
  const float okf = ok ? 1.0f : 0.0f;

  // ---- the winner's usage columns (added even when !ok, as 0 * req)
  const int n_upd = R + 3 + (SPREAD ? a.G : 0);
  for (int j = tid; j < n_upd; j += nthreads) {
    if (j < R) {
      float* x = a.used + (size_t)best * R + j;
      *x = __fadd_rn(*x, __fmul_rn(okf, a.cl.req[(size_t)u * R + j]));
      if (NOM) s_eff[j] = __fadd_rn(*x, a.nom_used[(size_t)best * R + j]);
    } else if (j < R + 2) {
      const int k = j - R;
      float* x = a.nz_used + (size_t)best * 2 + k;
      *x = __fadd_rn(*x, __fmul_rn(okf, a.cl.nz[(size_t)u * 2 + k]));
    } else if (j == R + 2) {
      a.pod_count[best] = __fadd_rn(a.pod_count[best], okf);
      if (NOM) s_cnt = __fadd_rn(a.pod_count[best], a.nom_count[best]);
    } else {
      const int gg = j - R - 3;
      float* x = a.spread + (size_t)gg * N + best;
      *x = __fadd_rn(*x, __fmul_rn(a.spread_match[(size_t)p * a.G + gg],
                                   okf));
    }
  }
  // every thread has read the tables (the barrier above): one thread
  // applies the winner's writes, in pod and k order
  if (tid == 0) {
    if (TOPO) ktpu_topo_scatter(a.topo, p, best, N, ok);
    if (SOFT) ktpu_soft_write(a.soft, p, best, N, ok);
  }
  __syncthreads();

  // ---- refresh the winner's column over every class
  for (int c = tid; c < a.cl.C; c += nthreads)
    a.ms[(size_t)c * N + best] = NOM
        ? ktpu_class_score(a.cfg, a.cl, rw0, rw1, c, best, N, R, s_eff,
                           a.nz_used[2 * best], a.nz_used[2 * best + 1],
                           s_cnt)
        : ktpu_class_score(a.cfg, a.cl, rw0, rw1, c, best, N, R,
                           a.used + (size_t)best * R, a.nz_used[2 * best],
                           a.nz_used[2 * best + 1], a.pod_count[best]);
  if (tid == 0) {
    a.packed[p] = ok ? best : -1;
    a.packed[a.P + p] = __float_as_int(chosen);
  }
  __syncthreads();
}
