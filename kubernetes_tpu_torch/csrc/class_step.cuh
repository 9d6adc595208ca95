// One pod's step of the serial class scan, shared by K2 (class_scan.cu)
// and K12 (spec_scan.cu, whose repair branch replays a cohort through it),
// so the two cannot drift; K15 (shard_scan.cu) shares its parameter block
// and score.cuh's arithmetic.
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
//      (score.cuh's class score, shared with K1); with NOM against the
//      winner's usage plus its reservations (batch.py :556-562);
//   6. assign and the bits of the chosen score into the packed [2, P].
// Every thread of the block calls it for the same pod; each thread owns
// node rows tid, tid + blockDim.x, ...
//
// Two forms, one per K2 design (each design's kernel calls its own):
//   ktpu_class_pod_step (the global design and K12's repair): the tables
//     in global memory; the partial reductions folded by every thread
//     over the 32 warp partials; the refresh after a barrier; it ends on
//     a block barrier.
//   ktpu_class_pod_step_shared (the shared design): the table, the class
//     constants and the held spread counts in shared memory, the pod's
//     scalars staged; folds by shuffles in every warp, zone sums merged a
//     (warp, zone), zone scores once a zone, the refresh's loads beside
//     the update's and the refresh in the winner's warp (its notes).
#pragma once

#include "score.cuh"
#include "affinity.cuh"
#include "prof.cuh"

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
  long long* prof;   // the profiling instance's clock stamps, or null
  int N, R, C, P, G, Z, T, D, K, Ts, Ds, Ks, Sb;
  int has_spread, has_topo, has_dir2, has_soft, has_nom;
  int prof_every;    // stamp every prof_every-th pod
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
  long long* prof;          // the profiling instance's stamps (prof.cuh)
  int prof_every;
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
  a.prof = h->prof;
  a.prof_every = h->prof_every;
  return a;
}

// the instance (SPREAD, TOPO, SOFT) of a batch's terms, as the launchers'
// switch numbers it
static int ktpu_scan_terms(const KtpuScanParams* h) {
  return (h->has_spread ? 4 : 0) | (h->has_topo ? 2 : 0) |
         (h->has_soft ? 1 : 0);
}

// a profiling launch of K12 or K15 takes the uniform or the spread
// batch's instance (terms 0 or 4, no overlay) with a stride of at least
// one
static bool ktpu_scan_prof_ok(const KtpuScanParams* h) {
  const int terms = ktpu_scan_terms(h);
  return !h->has_nom && (terms == 0 || terms == 4) && h->prof_every >= 1;
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
template <bool SPREAD, bool TOPO, bool SOFT, bool NOM, bool PROF = false>
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
  if (PROF && tid == 0) ktpu_prof_stamp(a.prof, a.prof_every, p, 0);
  const int u = a.class_idx[p];
  const float* ms_u = a.ms + (size_t)u * N;
  const uint32_t seq_term = (uint32_t)a.seq[p] * 40503u;
  if (PROF && tid == 0)
    ktpu_prof_stamp(a.prof, a.prof_every, p, 1, u + (int)seq_term);
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
  if (PROF && tid == 0) ktpu_prof_stamp(a.prof, a.prof_every, p, 2);
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
  if (PROF && tid == 0)
    ktpu_prof_stamp(a.prof, a.prof_every, p, 3, __float_as_int(maxz));

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
  if (PROF && tid == 0) ktpu_prof_stamp(a.prof, a.prof_every, p, 4);
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
  if (PROF && tid == 0)
    ktpu_prof_stamp(a.prof, a.prof_every, p, 5, best + (ok ? 1 : 0));

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
  if (PROF && tid == 0) ktpu_prof_stamp(a.prof, a.prof_every, p, 6);

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
  if (PROF && tid == 0) ktpu_prof_stamp(a.prof, a.prof_every, p, 7);
}

// ================================================================
// The shared-table step (K2's shared instance, class_scan.cu)
// ================================================================

// rows a thread of the shared-table step holds at most (N <= 8,192 at
// 512 threads): its passes keep each row's feasibility, count and zone
// (and soft raw score) in registers from the first pass to the second
#define KTPU_STEP_KC 16
// zones the shared step folds through warp partials and a shuffle table
#define KTPU_STEP_ZW 32

// one pod's scalars, staged a chunk ahead in shared memory
struct KtpuPodIn {
  int u;              // class
  uint32_t seq_term;  // seq * 40503, the tie hash's pod term
  bool active;
  int gidx;           // spread group (SPREAD)
  int nom_row;        // own nominated row (NOM)
  int soft_base;      // soft base row, -1 none (SOFT)
};

// the warp's first max of (pen, row) carrying val; every lane ends with it
__device__ __forceinline__ void ktpu_argmax_warp(float& pen, int& row,
                                                 float& val) {
  for (int o = 16; o > 0; o >>= 1) {
    const float open = __shfl_xor_sync(0xffffffffu, pen, o);
    const int orow = __shfl_xor_sync(0xffffffffu, row, o);
    const float oval = __shfl_xor_sync(0xffffffffu, val, o);
    if (open > pen || (open == pen && orow < row)) {
      pen = open;
      row = orow;
      val = oval;
    }
  }
}

// Pod p's step with the [C, N] table (a.ms), the class constants (a.cl's
// req, nz, blocked, mask_idx, score_idx) and, where they fit, the spread
// counts (a.spread) in shared memory, and the pod's scalars staged (pin).
// The block has KC rows a thread at most (N <= KC * blockDim.x) and
// C <= 32. The same arithmetic as ktpu_class_pod_step,
// in the reference's order; what differs is where values live and who
// reduces them:
//   - the reductions and the argmax fold with shuffles, in every warp
//     (each reads the block's warp partials once), the pass keeping two
//     running maxima so that its compares overlap;
//   - spread with Z <= 32: each thread sums its rows' counts by zone while
//     the zone repeats, and a warp's lanes of one zone merge
//     (__match_any_sync, __reduce_add_sync) into one add a (warp, zone)
//     of a warp-private row; every warp sums those rows for its lane's
//     zone, so KTPU_ZONE_WEIGHT times each zone's score is computed once
//     a zone, in lane z, and read by shuffle. The counts are
//     integer-valued below 2^24, so every order of adds is exact; a count
//     that is not goes to the zone's sum by an atomic add of its own.
//     Z > 32 keeps K2's shared-memory atomics and a zone score a row;
//   - each row's feasibility, spread count and zone (and soft raw score)
//     kept in registers from the first pass to the second;
//   - before the block fold, each warp loads its own candidate's usage,
//     allocatable, counts and refresh values (one round trip, beside the
//     barrier); the warp whose candidate wins, which owns the winner row,
//     applies the update and refreshes the winner's column, the only
//     reader of that column and row before the next update, so the step
//     needs no barrier after them, unless it carries topology or credit
//     writes (thread 0's, read by every thread) or Z > 32 zones.
// zs: [Z] zone sums (Z > 32: at zinit on entry, reset for the next pod);
// zw: [nwarps, 32] the warps' zone partials (Z <= 32: zero on entry,
// each warp zeroes its own row for the next pod); zinit: [Z]; all in
// shared memory.
template <bool SPREAD, bool TOPO, bool SOFT, bool NOM, bool PROF = false,
          int KC = KTPU_STEP_KC>
__device__ __forceinline__ void ktpu_class_pod_step_shared(
    const KtpuScanArgs& a, int p, const KtpuPodIn& pin,
    const KtpuStepConst& kc, float* zs, int* zw, const float* zinit) {
  // the argmax partials, by pod parity: a warp may write the next pod's
  // while another still reads this pod's (no barrier after the update)
  __shared__ float w_pen[2][32];
  __shared__ int w_row[2][32];
  __shared__ float w_val[2][32];
  __shared__ float w_maxc[32];
  __shared__ int w_hz[32];
  __shared__ float w_mn[32];
  __shared__ float w_mx[32];
  // the winner's usage after the write (+ reservations with NOM) and its
  // allocatable, from the winning warp's lanes to its refresh lanes
  __shared__ float s_use[KTPU_MAX_R];
  __shared__ float s_alloc[KTPU_MAX_R];
  __shared__ float s_self[NOM ? KTPU_MAX_R : 1];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  const int N = a.N, R = a.R, C = a.C, Z = a.Z, G = a.G;
  const float rw0 = kc.rw0, rw1 = kc.rw1;
  const float inf = __int_as_float(0x7f800000);
  if (PROF && tid == 0) ktpu_prof_stamp(a.prof, a.prof_every, p, 0);
  const int u = pin.u;
  const float* ms_u = a.ms + (size_t)u * N;
  const uint32_t seq_term = pin.seq_term;
  // this pod's spread match for the group of lane gg (G <= 32 here)
  float m_lane = 0.0f;
  if (SPREAD && lane < G) m_lane = a.spread_match[(size_t)p * G + lane];
  if (PROF && tid == 0)
    ktpu_prof_stamp(a.prof, a.prof_every, p, 1, u + (int)seq_term);
  // the self-exempt base of the pod's own nominated row, on the thread
  // that owns the row (the only one that reads it)
  int nr = -1;
  float corr = 0.0f;
  if (NOM) {
    nr = pin.nom_row;
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

  // ---- pass 1 (spread or soft): feasibility and the reductions
  uint32_t fitbits = 0u;
  // the rows' spread counts, kept without soft credits (registers); with
  // them the second pass reads the counts again
  constexpr bool CNTC = SPREAD && !SOFT;
  float cnt_k[CNTC ? KC : 1];
  // a row's zone, two to a register: its id clamped to [0, Z) (Z <=
  // 12,288), bit 14 set when the id is below Z, bit 15 when it is named
  // (> 0); all the thread's rows loaded before the pass adds anything
  uint32_t zone_k[SPREAD ? (KC + 1) / 2 : 1];
  // the soft raw score is kept only without spread groups (registers);
  // with them the second pass computes it again
  constexpr bool RAWC = SOFT && !SPREAD;
  float raw_k[RAWC ? KC : 1];
  float maxc = 0.0f, sw_use = 0.0f, mn = inf, mx = -inf;
  float zp_lane = 0.0f;   // lane z: KTPU_ZONE_WEIGHT x zone z's score
  // lane c: the node part of a count of c (not with soft credits, whose
  // registers it would spill)
  constexpr bool MEMO = SPREAD && !SOFT;
  float np_lane = 0.0f;
  const float zp_none = __fmul_rn(KTPU_ZONE_WEIGHT, KTPU_MAX_PRIORITY);
  float maxz = 0.0f;
  bool have_zones = false;
  const bool soft_use = SOFT && pin.soft_base >= 0;
  const bool zwarp = Z <= KTPU_STEP_ZW;
  const float* cnt_g = nullptr;
  if constexpr (SPREAD) {
    const int g = pin.gidx;
    sw_use = __fmul_rn(kc.sw, g >= 0 ? 1.0f : 0.0f);
    cnt_g = a.spread + (size_t)(g > 0 ? g : 0) * N;
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int r = tid + k * nthreads;
      uint32_t code = 0u;
      if (r < N) {
        const int z = __ldg(a.zone_of + r);
        code = (uint32_t)(z < 0 ? 0 : (z >= Z ? Z - 1 : z)) |
               (z < Z ? 0x4000u : 0u) | (z > 0 ? 0x8000u : 0u);
      }
      if (k % 2 == 0)
        zone_k[k / 2] = code;
      else
        zone_k[k / 2] |= code << 16;
    }
  }
  if (SPREAD || SOFT) {
    float lmax = 0.0f, lmn = inf, lmx = -inf;
    int lhz = 0;
    int run_z = -1;        // the zone this thread's run of rows adds to
    int run_s = 0;         // their counts' sum
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int r = tid + k * nthreads;
      if (r >= N) {
        if constexpr (CNTC) cnt_k[k] = 0.0f;
        continue;
      }
      const float base = (NOM && r == nr) ? corr : ms_u[r];
      bool fit = base > KTPU_NEG_THRESHOLD;
      if (TOPO) fit = fit && !ktpu_topo_bad(a.topo, p, r, N);
      if (fit) fitbits |= 1u << k;
      if constexpr (SOFT) {
        if (fit) {
          const float raw = ktpu_soft_raw(a.soft, p, r, N);
          if constexpr (RAWC) raw_k[k] = raw;
          lmn = fminf(lmn, raw);
          lmx = fmaxf(lmx, raw);
        }
      }
      if constexpr (SPREAD) {
        const float c = cnt_g[r];
        if constexpr (CNTC) cnt_k[k] = c;
        const uint32_t code = (zone_k[k / 2] >> (16 * (k % 2))) & 0xFFFFu;
        const int z = (int)(code & 0x3FFFu);
        const bool named = (code & 0x8000u) != 0u;
        const bool in_z = (code & 0x4000u) != 0u;
        const float cf = fit ? c : 0.0f;
        lmax = fmaxf(lmax, cf);
        if (fit && named) lhz = 1;
        // zone 0 ("no zone label") never enters maxz or a zone score
        if (cf != 0.0f && named && in_z) {
          if (!zwarp || !(cf == floorf(cf) && cf > 0.0f &&
                          cf < 16777216.0f)) {
            atomicAdd(&zs[z], cf);   // not a small count: on its own
          } else if (z == run_z) {
            run_s += (int)cf;
          } else {
            if (run_z >= 0)
              atomicAdd(&zw[warp * KTPU_STEP_ZW + run_z], run_s);
            run_z = z;
            run_s = (int)cf;
          }
        }
      }
    }
    if (SPREAD && zwarp) {
      // the warp's runs merged by zone: one add a (warp, zone)
      const unsigned grp = __match_any_sync(0xffffffffu, run_z);
      const unsigned sum = __reduce_add_sync(grp, (unsigned)run_s);
      if (run_z >= 0 && lane == __ffs(grp) - 1)
        atomicAdd(&zw[warp * KTPU_STEP_ZW + run_z], (int)sum);
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
    __syncthreads();   // the warp partials and the zone sums are complete
    lmax = lane < nwarps ? w_maxc[lane] : 0.0f;
    lhz = lane < nwarps ? w_hz[lane] : 0;
    lmn = lane < nwarps ? w_mn[lane] : inf;
    lmx = lane < nwarps ? w_mx[lane] : -inf;
    // lane z's zone sum: zinit plus the warps' integer partials (exact
    // below 2^24) plus any count that was not a small integer
    float zsum = 0.0f, lz = 0.0f;
    if (SPREAD && zwarp && lane < Z) {
      int isum = 0;
      for (int w = 0; w < nwarps; ++w) isum += zw[w * KTPU_STEP_ZW + lane];
      zsum = __fadd_rn(__fadd_rn(zinit[lane], (float)isum), zs[lane]);
      if (lane > 0) lz = zsum;
    }
    if (SPREAD && !zwarp)
      for (int z = 1 + lane; z < Z; z += 32) lz = fmaxf(lz, zs[z]);
    for (int o = 16; o > 0; o >>= 1) {
      lmax = fmaxf(lmax, __shfl_xor_sync(0xffffffffu, lmax, o));
      lhz |= __shfl_xor_sync(0xffffffffu, lhz, o);
      lmn = fminf(lmn, __shfl_xor_sync(0xffffffffu, lmn, o));
      lmx = fmaxf(lmx, __shfl_xor_sync(0xffffffffu, lmx, o));
      lz = fmaxf(lz, __shfl_xor_sync(0xffffffffu, lz, o));
    }
    maxc = lmax;
    have_zones = lhz != 0;
    mn = lmn;
    mx = lmx;
    maxz = lz;
    if (SPREAD && zwarp && lane < Z)
      zp_lane = ktpu_spread_zone_part(zsum, maxz);
    if (MEMO) np_lane = ktpu_spread_node_part((float)lane, maxc);
  }
  if (PROF && tid == 0)
    ktpu_prof_stamp(a.prof, a.prof_every, p, 3, __float_as_int(maxz));

  // ---- pass 2: the tie-penalized first max over this thread's rows,
  // two running maxima (even and odd k) merged at the end
  float bpen[2] = {-inf, -inf}, bval[2] = {KTPU_NEG, KTPU_NEG};
  int brow[2] = {0x7fffffff, 0x7fffffff};
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    const int r = tid + k * nthreads;
    float zpart = zp_none;
    if constexpr (SPREAD) {
      const uint32_t code = (zone_k[k / 2] >> (16 * (k % 2))) & 0xFFFFu;
      const int zi = (int)(code & 0x3FFFu);
      const bool named = (code & 0x8000u) != 0u;
      if (zwarp) {
        // every lane takes part in the shuffle, rows or not
        const float zt = __shfl_sync(0xffffffffu, zp_lane, zi & 31);
        if (named) zpart = zt;
      } else if (named && r < N) {
        zpart = ktpu_spread_zone_part(zs[zi], maxz);
      }
    }
    // the row's count, and the node part of a count that is a small
    // integer read from its lane (every lane shuffles, rows or not)
    float cval = 0.0f, np = 0.0f;
    bool small = false;
    if constexpr (SPREAD) {
      if (r < N) {
        if constexpr (CNTC) cval = cnt_k[k];
        else cval = cnt_g[r];
      }
      if constexpr (MEMO) {
        small = cval >= 0.0f && cval < 32.0f && cval == floorf(cval);
        np = __shfl_sync(0xffffffffu, np_lane, small ? (int)cval : 0);
      }
    }
    if (r >= N) continue;
    const float base = (NOM && r == nr) ? corr : ms_u[r];
    bool fit;
    if (SPREAD || SOFT) {
      fit = ((fitbits >> k) & 1u) != 0u;
    } else {
      fit = base > KTPU_NEG_THRESHOLD;
      if (TOPO) fit = fit && !ktpu_topo_bad(a.topo, p, r, N);
    }
    float score = base;
    if constexpr (SOFT) {
      float raw = 0.0f;
      if constexpr (RAWC) raw = raw_k[k];
      else if (fit) raw = ktpu_soft_raw(a.soft, p, r, N);
      score = __fadd_rn(score, ktpu_soft_term(raw, mn, mx, soft_use,
                                              kc.soft_w));
    }
    if constexpr (SPREAD) {
      const float node_s = small ? np : ktpu_spread_node_part(cval, maxc);
      score = __fadd_rn(score, __fmul_rn(sw_use, ktpu_spread_blend(
          node_s, zpart, have_zones)));
    }
    const float masked = fit ? score : KTPU_NEG;
    const float pen = ktpu_tie_penalized(masked, r, seq_term);
    const int h = k & 1;
    if (pen > bpen[h]) {  // rows ascend: strict > keeps the first max
      bpen[h] = pen;
      brow[h] = r;
      bval[h] = masked;
    }
  }
  float cpen = bpen[0], cval = bval[0];
  int crow = brow[0];
  if (bpen[1] > cpen || (bpen[1] == cpen && brow[1] < crow)) {
    cpen = bpen[1];
    crow = brow[1];
    cval = bval[1];
  }
  ktpu_argmax_warp(cpen, crow, cval);
  const int wb = p & 1;
  if (lane == 0) {
    w_pen[wb][warp] = cpen;
    w_row[wb][warp] = crow;
    w_val[wb][warp] = cval;
  }
  // the warp's candidate row's values, loaded while the block folds: its
  // usage and allocatable (lane j: columns j and j + 32), counts, node
  // flags, and class c = lane's mask and static score there
  const int cand = crow < N ? crow : 0;
  float sp_used[2] = {0.0f, 0.0f}, sp_alloc[2] = {0.0f, 0.0f};
  float sp_nom[2] = {0.0f, 0.0f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h;
    if (j < R) {
      sp_used[h] = a.used[(size_t)cand * R + j];
      sp_alloc[h] = a.cfg.alloc[(size_t)cand * R + j];
      if (NOM) sp_nom[h] = a.nom_used[(size_t)cand * R + j];
    }
  }
  const float sp_nz0 = a.nz_used[2 * (size_t)cand];
  const float sp_nz1 = a.nz_used[2 * (size_t)cand + 1];
  const float sp_cnt = a.pod_count[cand];
  const float sp_nomc = NOM ? a.nom_count[cand] : 0.0f;
  const float sp_maxp = a.cfg.max_pods[cand];
  const bool sp_mp = a.cfg.mem_pressure[cand];
  const bool sp_ok = a.cfg.node_ok[cand] && a.cfg.valid[cand];
  bool sp_mask = false;
  float sp_stat = 0.0f;
  if (lane < C) {
    sp_mask = a.cl.unique_masks[(size_t)a.cl.mask_idx[lane] * N + cand];
    sp_stat = a.cl.unique_scores[(size_t)a.cl.score_idx[lane] * N + cand];
  }
  float sp_spread = 0.0f;   // lane gg's spread count at the candidate
  if (SPREAD && lane < G) sp_spread = a.spread[(size_t)lane * N + cand];
  __syncthreads();
  if (PROF && tid == 0) ktpu_prof_stamp(a.prof, a.prof_every, p, 4);
  float fpen = lane < nwarps ? w_pen[wb][lane] : -inf;
  int best = lane < nwarps ? w_row[wb][lane] : 0x7fffffff;
  float chosen = lane < nwarps ? w_val[wb][lane] : KTPU_NEG;
  ktpu_argmax_warp(fpen, best, chosen);
  const bool ok = chosen > KTPU_NEG_THRESHOLD && pin.active;
  const float okf = ok ? 1.0f : 0.0f;
  // the next pod's zone partials start from zero: each warp its own row
  // (every warp read them above the argmax barrier); Z > 32: zs from zinit
  if (SPREAD && zwarp) zw[warp * KTPU_STEP_ZW + lane] = 0;
  if (SPREAD)
    for (int z = tid; z < Z; z += nthreads) zs[z] = zwarp ? 0.0f : zinit[z];
  // every thread has read the tables (the barrier above): one thread
  // applies the winner's writes, in pod and k order
  if (tid == 0) {
    if (TOPO) ktpu_topo_scatter(a.topo, p, best, N, ok);
    if (SOFT) ktpu_soft_write(a.soft, p, best, N, ok);
    a.packed[p] = ok ? best : -1;
    a.packed[a.P + p] = __float_as_int(chosen);
  }

  // ---- the winning warp: the winner's usage (added even when !ok, as
  // 0 * req) and its column over every class
  if (crow == best) {
    // the profile's last three stamps come from this warp's lane 0
    if (PROF && lane == 0)
      ktpu_prof_stamp(a.prof, a.prof_every, p, 5, best + (ok ? 1 : 0));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + 32 * h;
      if (j < R) {
        const float v = __fadd_rn(
            sp_used[h], __fmul_rn(okf, a.cl.req[(size_t)u * R + j]));
        a.used[(size_t)best * R + j] = v;
        s_use[j] = NOM ? __fadd_rn(v, sp_nom[h]) : v;
        s_alloc[j] = sp_alloc[h];
      }
    }
    const float nz0 = __fadd_rn(sp_nz0, __fmul_rn(okf, a.cl.nz[2 * u]));
    const float nz1 = __fadd_rn(sp_nz1, __fmul_rn(okf, a.cl.nz[2 * u + 1]));
    const float cnt = __fadd_rn(sp_cnt, okf);
    if (lane == 0) {
      a.nz_used[2 * (size_t)best] = nz0;
      a.nz_used[2 * (size_t)best + 1] = nz1;
      a.pod_count[best] = cnt;
    }
    if (SPREAD && lane < G)
      a.spread[(size_t)lane * N + best] =
          __fadd_rn(sp_spread, __fmul_rn(m_lane, okf));
    for (int gg = lane + 32; SPREAD && gg < G; gg += 32) {
      float* x = a.spread + (size_t)gg * N + best;
      *x = __fadd_rn(*x, __fmul_rn(a.spread_match[(size_t)p * G + gg],
                                   okf));
    }
    __syncwarp();
    if (PROF && lane == 0) ktpu_prof_stamp(a.prof, a.prof_every, p, 6);
    // the column, 8 classes a pass: class c0 + lane / 4 on four lanes,
    // part s = lane % 4 checking columns s, s + 4, ... and computing one
    // of the resource score's four divisions (score.cuh's terms, the
    // same roundings as ktpu_class_score_at)
    const float cnt_eff = NOM ? __fadd_rn(cnt, sp_nomc) : cnt;
    const int sub = lane & 3, base_lane = lane & ~3;
    for (int c0 = 0; c0 < C; c0 += 8) {
      const int c = c0 + (lane >> 2);
      const int cc = c < C ? c : 0;
      const float* req_c = a.cl.req + (size_t)cc * R;
      bool f = true;
      for (int j = sub; j < R; j += 4)
        f = f && (__fadd_rn(req_c[j], s_use[j]) <= s_alloc[j]);
      // every lane shuffles (no short cut past a shuffle)
      const int f1 = __shfl_xor_sync(0xffffffffu, f ? 1 : 0, 1);
      f = f && f1 != 0;
      const int f2 = __shfl_xor_sync(0xffffffffu, f ? 1 : 0, 2);
      f = f && f2 != 0;
      const float cap = s_alloc[sub & 1];
      const float req = __fadd_rn((sub & 1) ? nz1 : nz0,
                                  a.cl.nz[2 * cc + (sub & 1)]);
      const float part = sub < 2 ? ktpu_lr_term(cap, req)
                                 : ktpu_frac_term(cap, req);
      const float lr_c = __shfl_sync(0xffffffffu, part, base_lane);
      const float lr_m = __shfl_sync(0xffffffffu, part, base_lane + 1);
      const float f_cpu = __shfl_sync(0xffffffffu, part, base_lane + 2);
      const float f_mem = __shfl_sync(0xffffffffu, part, base_lane + 3);
      // class cc's mask and static score, loaded by lane cc
      const bool m_c = __shfl_sync(0xffffffffu, sp_mask ? 1 : 0, cc & 31);
      const float st_c = __shfl_sync(0xffffffffu, sp_stat, cc & 31);
      if (c < C && sub == 0) {
        const float sc = __fadd_rn(
            ktpu_resource_combine(lr_c, lr_m, f_cpu, f_mem, rw0, rw1), st_c);
        const bool fits = f && (__fadd_rn(cnt_eff, 1.0f) <= sp_maxp) &&
                          !(a.cl.blocked[c] && sp_mp) && sp_ok && m_c;
        a.ms[(size_t)c * N + best] = fits ? sc : KTPU_NEG;
      }
    }
    __syncwarp();
    if (PROF && lane == 0) ktpu_prof_stamp(a.prof, a.prof_every, p, 7);
  }
  // thread 0's topology and credit writes, and Z > 32's zone sums, before
  // any thread reads them for the next pod
  if (TOPO || SOFT || (SPREAD && !zwarp)) __syncthreads();
}
