// K9: the all-or-nothing member scan over one gang batch, in ONE launch.
//
// Replaces kubernetes_tpu/scheduler/kernels/gang.py gang_schedule_batch
// (:93, the lax.scan of one_entry :131-239, the all-or-nothing mask and
// the scatter to the pod axis :275-293): the route of every batch that
// carries a PodGroup member.
//
// The batch's placement units (gangs, and every singleton as a gang of
// one) come flattened into T entries (kernels/gang.py's docstring), each
// unit a contiguous run from a start entry to an end entry, walked in
// order. Per entry:
//   1. at a start entry: the unit's state resets (gang_dom from pin_dom,
//      gang_ok true); with the capacity gate (CAP), for a constrained,
//      un-pinned gang with need > 0, every row's member slots against the
//      committed usage (plus the nominated overlay) are summed per domain
//      into `domcap`, and a row is eligible when its domain holds the
//      whole gang (:165-188). The slots are integer-valued and at most
//      max_pods, so the per-domain sums stay integers below 2^24 at the
//      card's sizes (N * max_pods = 8,192 * 110) and the float atomics
//      add them exactly, in any order. With no eligible row the gate is
//      off for the gang (every row stays eligible);
//   2. a member (pod_idx >= 0) takes K7's step (pod.cuh's arithmetic):
//      feasibility against the running usage under its mask and the
//      domain mask (:189-193), the soft credits read from the running
//      accumulators (:205-211), the tie-penalized first-max argmax (ties
//      to the lowest row); the chosen score is the masked value at the
//      winner, also for a member of a gang that is rejected later. A
//      member that places writes its usage and credits, pins the gang's
//      domain, and a member that does not clears gang_ok;
//   3. at an end entry: the unit's verdict goes to ok_units[gang_id].
// With the overlay's own-gang exemption (`mates`, kernels/gang.py's
// docstring), a unit of more than one entry opens by summing its
// members' reservations per row into gex_used / gex_cnt, in entry order,
// each row by the thread that owns it; its members and its capacity gate
// read the overlay less those, and its end entry clears them. Every
// thread reads gex only at its own rows, so they need no barrier.
// The trial window is an undo log instead of the reference's second copy
// of the usage: inside a unit of more than one entry, each placing member
// first saves the R + 3 usage values of its row and the Ks credit cells
// it writes; a rejected gang restores them in reverse order, which gives
// back the committed bits exactly (no subtraction). A singleton places
// straight into the committed state: a member that does not place writes
// nothing. After the scan, every entry of a rejected gang is masked to -1
// and the entries scatter to the pod axis (-1 / NEG for pods no entry
// names).
//
// Two designs of that walk (kernels/gang.py gang_design picks one):
//
//   cluster (ktpu_gang_scan_cluster, where the state fits): one
//     thread-block cluster of 16 CTAs (Hopper's largest, a non-portable
//     size: at the portable 8 the row pass of the CTAs holding the
//     gang path's 5,000 live rows still set the pace, PERF.md), CTA k
//     owning rows [k * Nl, (k + 1) * Nl), Nl = ceil(N / 16), up to 512
//     threads a CTA and 4 rows a thread (N <= 32,768). Each CTA loads its
//     rows' state into shared memory once a launch, struct of arrays so
//     a warp's loads are contiguous: alloc [R], used [R], nz_used [2],
//     pod_count, max_pods and a flag byte (node_ok && valid, memory
//     pressure, the gate's eligibility): 81 bytes a row at R = 8, 41 KB
//     a CTA at N = 8,192; the committed used / nz_used / pod_count go
//     back at the end. The entries' scalars and their pods' are staged 64
//     at a time. A member's rows read only the pod's mask and static
//     score rows and the domain row from L2, spread over 16 SMs, and
//     those of the next member load while the cluster waits at the
//     exchange.
//     One exchange an entry (cluster_xchg.cuh, shared with K7's and
//     K15's cluster designs): each warp folds its (penalized score, row,
//     masked score, domain) with shuffles and its lane q stores the
//     warp's candidate into CTA q's slot array (distributed shared
//     memory; two arrays alternate by entry parity), then arrives at CTA
//     q's mbarrier of that array (st.async: the store itself completes
//     there as transaction bytes, no release fence); every thread waits
//     on its own CTA's mbarrier (try_wait.parity.acquire.cluster) and
//     every warp folds the
//     16 x 16 candidates with the same comparator: the same winner
//     everywhere, no block barrier, no cluster barrier and no serial fold
//     on one thread. A slot array is written again only two exchanges
//     later, after every warp of every CTA has arrived for the exchange in
//     between, which it does only after reading this one. The thread that owns the winner row applies the usage
//     in shared memory and keeps its undo record (the rows in a per-CTA
//     copy of log_row, the values in log_vals, both read back only by
//     that CTA). Soft instances exchange their min / max partials the same
//     way (exact in any order) and end each entry on a cluster barrier
//     that publishes CTA 0's credit writes, made in k order on one
//     thread, and their undo. The capacity gate's slot sums go to one of
//     two global [N] buffers by float atomics (integer-valued, exact in
//     any order; each CTA zeroes its slice of the other buffer for the
//     next gate), then one cluster barrier, each row's eligibility in its
//     flag byte, and the OR over the cluster by a second exchange.
//   block (ktpu_gang_scan, any batch): one persistent block of 1,024
//     threads, thread t owning rows t, t + 1,024, ..., the state in
//     global memory and the warp partials folded by every thread in turn.
//
// Bound: the dependency chain from one entry to the next, not bytes or
// operations. The cluster design's chain an entry: the row pass (1 row a
// thread at N = 8,192, the state in shared memory, the table values
// already loaded), a warp's shuffle fold, the distributed stores, the
// wait for the slowest warp's, the fold of 256 candidates and the
// owner's update; a gated start adds two cluster barriers. The block design's:
// the row pass over 8 rows a thread on one SM (78.6% of an entry on the
// gang batch, PERF.md), three or four block barriers, a serial fold of 32
// partials.
#include <cooperative_groups.h>

#include "score.cuh"
#include "affinity.cuh"
#include "pod.cuh"
#include "prof.cuh"
#include "cluster_xchg.cuh"

// The host's parameter block: the pointer fields in the order of
// kubernetes_tpu_torch/scheduler/kernels/gang.py _GANG_PTRS, then the ints
// of _GANG_INTS. The soft, nominated and capacity pointers are null when
// the batch does not carry them.
struct KtpuGangScanParams {
  const float* alloc;
  const float* max_pods;
  const bool* node_ok;
  const bool* mem_pressure;
  const bool* valid;
  const bool* unique_masks;
  const float* unique_scores;
  const float* rw;
  float* used;
  float* nz_used;
  float* pod_count;
  const float* req;
  const float* nz_req;
  const bool* blocked;
  const int* mask_idx;
  const int* score_idx;
  const int* seq;
  const bool* active;
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
  const int* pod_idx;
  const bool* start;
  const bool* end;
  const int* gang_id;
  const int* entry_dom;
  const int* pin_dom;
  const int* dom_tab;
  const float* need;
  const float* greq;
  int* log_row;
  float* log_vals;
  float* log_soft;
  int* log_cell;
  int* entry_assign;
  float* entry_score;
  int* ok_units;
  float* domcap;
  bool* elig;
  float* gex_used;
  float* gex_cnt;
  int* packed;
  long long* prof;   // the profiling instance's clock stamps, or null
  int N, R, P, T, K, Ts, Ds, Ks, Sb;
  int has_soft, has_nom, has_cap, mates;
  int prof_every;    // stamp every prof_every-th entry
};

#define KTPU_GANG_THREADS 1024
// threads of the block design: the soft instances run at 512 (128
// registers a thread) so that no instance spills
template <bool SOFT>
__host__ __device__ constexpr int ktpu_gang_threads() {
  return SOFT ? 512 : KTPU_GANG_THREADS;
}

// the undo log's restore: every record of the open gang in reverse
// order, one usage column per thread (the thread that saved it) and the
// credit cells on thread 0 (which saved them); the caller's barrier
// publishes the restored values
__device__ __forceinline__ void ktpu_gang_undo(const KtpuGangScanParams& a,
                                               int n_log, bool soft) {
  const int R = a.R, W = a.R + 3;
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    for (int q = n_log - 1; q >= 0; --q) {
      const int r = a.log_row[q];
      const float old = a.log_vals[(size_t)q * W + j];
      if (j < R) a.used[(size_t)r * R + j] = old;
      else if (j < R + 2) a.nz_used[(size_t)r * 2 + (j - R)] = old;
      else a.pod_count[r] = old;
    }
  }
  if (soft && threadIdx.x == 0) {
    for (int q = n_log - 1; q >= 0; --q)
      for (int k = a.Ks - 1; k >= 0; --k) {
        const size_t e = (size_t)q * a.Ks + k;
        a.soft_cnt[a.log_cell[e]] = a.log_soft[e];
      }
  }
}

template <bool SOFT, bool NOM, bool CAP, bool PROF>
__global__ void __launch_bounds__(ktpu_gang_threads<SOFT>(), 1)
ktpu_gang_scan_kernel(KtpuGangScanParams a) {
  __shared__ float w_pen[32];
  __shared__ int w_row[32];
  __shared__ float w_val[32];
  __shared__ float w_mn[32];
  __shared__ float w_mx[32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  const int N = a.N, R = a.R, T = a.T, P = a.P, W = a.R + 3;
  const float rw0 = a.rw[0], rw1 = a.rw[1];
  const float inf = __int_as_float(0x7f800000);
  const KtpuNodeCfg cfg{a.alloc, a.max_pods, a.node_ok, a.mem_pressure,
                        a.valid};
  const KtpuSoft sf{a.soft_dom, a.soft_cnt, a.soft_base, a.soft_base_idx,
                    a.read_tids, a.read_w, a.write_tids, a.write_w,
                    a.soft_w, a.Ds, a.Ks};
  const float soft_w = SOFT ? a.soft_w[0] : 0.0f;
  const bool keep_bits = SOFT && N <= 32 * nthreads;

  for (int t = tid; t < T; t += nthreads) a.ok_units[t] = 0;
  // block-uniform unit state: every thread computes the same values
  int gang_dom = -1;
  bool gang_ok = true;
  bool elig_on = false;
  bool in_trial = false;
  bool mates_on = false;  // the open unit reads the overlay less gex
  int unit_t0 = 0;
  int n_log = 0;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    if (PROF && tid == 0) ktpu_prof_stamp(a.prof, a.prof_every, t, 0);
    const int pi = a.pod_idx[t];
    const int di = a.entry_dom[t];
    const bool constrained = di >= 0;
    const int* dom_row = a.dom_tab + (size_t)(di > 0 ? di : 0) * N;
    if (a.start[t]) {
      in_trial = !a.end[t];
      n_log = 0;
      gang_dom = a.pin_dom[t];
      gang_ok = true;
      elig_on = false;
      mates_on = NOM && a.mates && in_trial;
      unit_t0 = t;
      if (mates_on) {
        // the unit's own reservations, per row in entry order
        for (int e = t;; ++e) {
          const int pe = a.pod_idx[e];
          const int r = pe >= 0 ? a.nom_row[pe] : -1;
          if (r >= 0 && r < N && r % nthreads == tid) {
            for (int j = 0; j < R; ++j)
              a.gex_used[(size_t)r * R + j] = __fadd_rn(
                  a.gex_used[(size_t)r * R + j], a.req[(size_t)pe * R + j]);
            a.gex_cnt[r] = __fadd_rn(a.gex_cnt[r], 1.0f);
          }
          if (a.end[e]) break;
        }
      }
      if (CAP && constrained && a.pin_dom[t] < 0 && a.need[t] > 0.0f) {
        // ---- the capacity gate against the committed usage
        for (int r = tid; r < N; r += nthreads) a.domcap[r] = 0.0f;
        __syncthreads();
        const float* q = a.greq + (size_t)t * R;
        for (int r = tid; r < N; r += nthreads) {
          const int d = dom_row[r];
          if (!(d >= 0 && d < N && cfg.node_ok[r] && cfg.valid[r]))
            continue;
          float per = inf;
          const float* alloc_r = cfg.alloc + (size_t)r * R;
          const float* used_r = a.used + (size_t)r * R;
          for (int j = 0; j < R; ++j) {
            if (!(q[j] > 0.0f)) continue;
            float u = used_r[j];
            if (NOM) u = __fadd_rn(u, a.nom_used[(size_t)r * R + j]);
            if (NOM && mates_on)
              u = __fsub_rn(u, a.gex_used[(size_t)r * R + j]);
            per = fminf(per, floorf(__fdiv_rn(__fsub_rn(alloc_r[j], u),
                                              fmaxf(q[j], 1e-9f))));
          }
          float c = a.pod_count[r];
          if (NOM) c = __fadd_rn(c, a.nom_count[r]);
          if (NOM && mates_on) c = __fsub_rn(c, a.gex_cnt[r]);
          float slots = fminf(per, floorf(__fsub_rn(cfg.max_pods[r], c)));
          slots = fmaxf(slots, 0.0f);
          if (slots != 0.0f) atomicAdd(&a.domcap[d], slots);
        }
        __syncthreads();
        const float need = a.need[t];
        int lany = 0;
        for (int r = tid; r < N; r += nthreads) {
          const int d = dom_row[r];
          const bool e = d >= 0 && a.domcap[d < N ? d : N - 1] >= need;
          a.elig[r] = e;
          lany |= e ? 1 : 0;
        }
        lany = __syncthreads_or(lany);
        elig_on = lany != 0;
      }
    }
    if (PROF && tid == 0) ktpu_prof_stamp(a.prof, a.prof_every, t, 1, pi);

    if (pi >= 0) {
      // ---- one member: K7's step over the domain-masked rows
      KtpuPod pod;
      pod.req = a.req + (size_t)pi * R;
      pod.nz0 = a.nz_req[2 * pi];
      pod.nz1 = a.nz_req[2 * pi + 1];
      pod.blocked = a.blocked[pi];
      const bool* mask = a.unique_masks + (size_t)a.mask_idx[pi] * N;
      const float* stat = a.unique_scores + (size_t)a.score_idx[pi] * N;
      const uint32_t seq_term = (uint32_t)a.seq[pi] * 40503u;
      const int nr = NOM ? a.nom_row[pi] : -1;
      const int gd = gang_dom;
      const bool eo = elig_on;
      const bool mo = mates_on;
      auto fit_at = [&](int r) -> bool {
        bool m = mask[r];
        if (constrained) {
          const int d = dom_row[r];
          m = m && d >= 0 && (gd < 0 || d == gd) && (!eo || a.elig[r]);
        }
        // the exemption: the unit's reservations, or the pod's own
        const bool self = NOM && r == nr;
        return ktpu_pod_fits_ex(
            cfg, r, R, pod, m, a.used + (size_t)r * R,
            NOM ? a.nom_used + (size_t)r * R : nullptr, a.pod_count[r],
            NOM ? a.nom_count[r] : 0.0f,
            mo ? a.gex_used + (size_t)r * R : self ? pod.req : nullptr,
            mo ? a.gex_cnt[r] : self ? 1.0f : 0.0f);
      };
      // soft credits: min and max of raw over the feasible rows
      float mn = inf, mx = -inf;
      bool soft_use = false;
      uint32_t bits = 0u;
      if (SOFT) {
        soft_use = a.soft_base_idx[pi] >= 0;
        float lmn = inf, lmx = -inf;
        for (int r = tid, k = 0; r < N; r += nthreads, ++k) {
          const bool fit = fit_at(r);
          if (keep_bits && fit) bits |= 1u << k;
          if (fit) {
            const float raw = ktpu_soft_raw(sf, pi, r, N);
            lmn = fminf(lmn, raw);
            lmx = fmaxf(lmx, raw);
          }
        }
        for (int o = 16; o > 0; o >>= 1) {
          lmn = fminf(lmn, __shfl_xor_sync(0xffffffffu, lmn, o));
          lmx = fmaxf(lmx, __shfl_xor_sync(0xffffffffu, lmx, o));
        }
        if (lane == 0) {
          w_mn[warp] = lmn;
          w_mx[warp] = lmx;
        }
        __syncthreads();
        for (int w = 0; w < nwarps; ++w) {
          mn = fminf(mn, w_mn[w]);
          mx = fmaxf(mx, w_mx[w]);
        }
      }
      // tie-penalized first-max argmax over this thread's rows
      float bpen = -inf, bval = KTPU_NEG;
      int brow = 0x7fffffff;
      for (int r = tid, k = 0; r < N; r += nthreads, ++k) {
        const bool fit = keep_bits ? ((bits >> k) & 1u) != 0u : fit_at(r);
        float masked = KTPU_NEG;
        if (fit) {
          float score = ktpu_pod_base(cfg, r, R, pod, a.nz_used[2 * r],
                                      a.nz_used[2 * r + 1], rw0, rw1,
                                      stat[r]);
          if (SOFT)
            score = __fadd_rn(score, ktpu_soft_term(
                ktpu_soft_raw(sf, pi, r, N), mn, mx, soft_use, soft_w));
          masked = score;
        }
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
      if (PROF && tid == 0) ktpu_prof_stamp(a.prof, a.prof_every, t, 2);
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
      if (PROF && tid == 0)
        ktpu_prof_stamp(a.prof, a.prof_every, t, 3, best);
      // fits[best] & active: a feasible row's masked score is its score,
      // far above the threshold; an infeasible one's is NEG
      const bool ok = chosen > KTPU_NEG_THRESHOLD && a.active[pi];
      if (ok) {
        // ---- the winner's usage, saved first inside a trial
        for (int j = tid; j < W; j += nthreads) {
          float* x = j < R ? a.used + (size_t)best * R + j
                   : j < R + 2 ? a.nz_used + (size_t)best * 2 + (j - R)
                               : a.pod_count + best;
          const float add = j < R ? pod.req[j]
                          : j < R + 2 ? a.nz_req[(size_t)pi * 2 + (j - R)]
                                      : 1.0f;
          if (in_trial) a.log_vals[(size_t)n_log * W + j] = *x;
          *x = __fadd_rn(*x, add);
        }
        // every thread has read the tables (the barrier above): thread 0
        // saves and writes the credit cells in k order
        if (SOFT && tid == 0) {
          const size_t row = (size_t)pi * sf.Ks;
          for (int k = 0; k < sf.Ks; ++k) {
            const int tt = sf.write_tids[row + k];
            const int tc = tt > 0 ? tt : 0;
            const int d = sf.dom[(size_t)tc * N + best];
            const float w = (tt >= 0 && d >= 0) ? sf.write_w[row + k] : 0.0f;
            const size_t cell = (size_t)tc * sf.Ds + (d > 0 ? d : 0);
            float* x = sf.cnt + cell;
            if (in_trial) {
              a.log_soft[(size_t)n_log * sf.Ks + k] = *x;
              a.log_cell[(size_t)n_log * sf.Ks + k] = (int)cell;
            }
            *x = __fadd_rn(*x, w);
          }
        }
        if (tid == 0 && in_trial) a.log_row[n_log] = best;
        if (in_trial) ++n_log;
        if (constrained && gang_dom < 0) gang_dom = dom_row[best];
      }
      gang_ok = gang_ok && ok;
      if (tid == 0) {
        a.entry_assign[t] = ok ? best : -1;
        a.entry_score[t] = chosen;
      }
    }
    if (PROF && tid == 0) ktpu_prof_stamp(a.prof, a.prof_every, t, 4);

    if (a.end[t]) {
      if (tid == 0) {
        const int g = a.gang_id[t];
        if (g >= 0 && g < T) a.ok_units[g] = gang_ok ? 1 : 0;
      }
      if (in_trial && !gang_ok && n_log > 0) {
        __syncthreads();  // thread 0's last log_row entry is visible
        ktpu_gang_undo(a, n_log, SOFT);
      }
      if (mates_on) {
        // gex back to zero, each row by its owner
        for (int e = unit_t0; e <= t; ++e) {
          const int pe = a.pod_idx[e];
          const int r = pe >= 0 ? a.nom_row[pe] : -1;
          if (r >= 0 && r < N && r % nthreads == tid) {
            for (int j = 0; j < R; ++j) a.gex_used[(size_t)r * R + j] = 0.0f;
            a.gex_cnt[r] = 0.0f;
          }
        }
      }
      in_trial = false;
      mates_on = false;
      n_log = 0;
    }
    __syncthreads();
    if (PROF && tid == 0) ktpu_prof_stamp(a.prof, a.prof_every, t, 5);
  }

  // ---- the all-or-nothing mask and the scatter to the pod axis
  for (int p = tid; p < P; p += nthreads) {
    a.packed[p] = -1;
    a.packed[P + p] = __float_as_int(KTPU_NEG);
  }
  __syncthreads();
  for (int t = tid; t < T; t += nthreads) {
    const int pi = a.pod_idx[t];
    if (pi < 0 || pi >= P) continue;
    int g = a.gang_id[t];
    g = g < T ? g : T - 1;
    g = g < 0 ? g + T : g;
    a.packed[pi] = a.ok_units[g] ? a.entry_assign[t] : -1;
    a.packed[P + pi] = __float_as_int(a.entry_score[t]);
  }
}

// ================================================================
// The cluster design: the member scan over one thread-block cluster
// ================================================================

// CTAs of the cluster: 16, the largest (non-portable) size on Hopper, so
// that the row pass of a CTA covers N / 16 rows
#define KTPU_GANG_CLUSTER 16
#define KTPU_GANG_CTHREADS 512   // threads a CTA at most
#define KTPU_GANG_RPT 4          // rows a thread at most: N <= 32,768
#define KTPU_GANG_CHUNK 64       // entries staged in shared memory at once
// dynamic shared memory a CTA may take for its rows' state
#define KTPU_GANG_SMEM_LIMIT (200 * 1024)

// a row's flag byte
#define KTPU_ROW_OK 1u     // node_ok && valid
#define KTPU_ROW_MP 2u     // mem_pressure
#define KTPU_ROW_ELIG 4u   // inside the open gang's capacity gate


// an entry's scalars and its pod's, staged a chunk at a time
struct KtpuGangEntry {
  int pi, di, pin, gid;
  int mask_idx, score_idx, nom_row, soft_base;
  uint32_t seq_term;
  float nz0, nz1, need;
  int flags;   // 1 start, 2 end, 4 blocked, 8 active
};

// _pod_feasible at the local row i of the CTA's state (struct of arrays,
// column j of row i at j * Nl + i): ktpu_pod_fits_ex's arithmetic, in its
// order
__device__ __forceinline__ bool ktpu_gang_fits_soa(
    const float* s_alloc, const float* s_used, const float* s_cnt,
    const float* s_maxp, uint32_t fl, int i, int Nl, int R,
    const float* req, bool blocked, bool mask, const float* nom_r,
    float nom_cnt, const float* ex_r, float ex_cnt) {
  if (!(mask && (fl & KTPU_ROW_OK))) return false;
  if (blocked && (fl & KTPU_ROW_MP)) return false;
  float c = s_cnt[i];
  if (nom_r != nullptr) c = __fsub_rn(__fadd_rn(c, nom_cnt), ex_cnt);
  if (!(__fadd_rn(c, 1.0f) <= s_maxp[i])) return false;
  for (int j = 0; j < R; ++j) {
    float eff = s_used[(size_t)j * Nl + i];
    if (nom_r != nullptr)
      eff = __fsub_rn(__fadd_rn(eff, nom_r[j]),
                      ex_r != nullptr ? ex_r[j] : 0.0f);
    if (!(__fadd_rn(req[j], eff) <= s_alloc[(size_t)j * Nl + i]))
      return false;
  }
  return true;
}

// the CTA's shared-memory layout for Nl rows of R columns: alloc [R, Nl],
// used [R, Nl], nz [2, Nl], cnt [Nl], maxp [Nl] (f32), flags [Nl] (u8)
__host__ __device__ __forceinline__ size_t ktpu_gang_smem_bytes(int Nl,
                                                                int R) {
  return (size_t)Nl * (2 * (size_t)R + 4) * sizeof(float) +
         (((size_t)Nl + 15) & ~(size_t)15);
}

template <bool SOFT, bool NOM, bool CAP, bool PROF>
__global__ void __launch_bounds__(KTPU_GANG_CTHREADS, 1)
ktpu_gang_cluster_kernel(KtpuGangScanParams a, int Nl) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float gsm[];
  const int R = a.R, N = a.N, T = a.T, P = a.P, W = a.R + 3;
  float* s_alloc = gsm;
  float* s_used = s_alloc + (size_t)R * Nl;
  float* s_nz = s_used + (size_t)R * Nl;
  float* s_cnt = s_nz + 2 * (size_t)Nl;
  float* s_maxp = s_cnt + Nl;
  uint8_t* s_fl = (uint8_t*)(s_maxp + Nl);
  __shared__ __align__(16) KtpuCand s_cand[2][KTPU_GANG_CLUSTER * KTPU_XCHG_WARPS];
  __shared__ __align__(8) uint64_t s_mbar[2];   // a slot array's arrivals
  __shared__ float s_mm[2][KTPU_GANG_CLUSTER][2];
  static_assert(KTPU_GANG_CLUSTER <= 32, "a warp's lanes address the CTAs");
  __shared__ int s_any[2][KTPU_GANG_CLUSTER];
  __shared__ KtpuGangEntry s_ent[2][KTPU_GANG_CHUNK];
  __shared__ float w_mn[32];
  __shared__ float w_mx[32];
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int NT = blockDim.x;
  const int nwarps = NT >> 5;
  const int r0 = rank * Nl;
  const int nloc = max(0, min(Nl, N - r0));
  const float rw0 = a.rw[0], rw1 = a.rw[1];
  const float inf = __int_as_float(0x7f800000);
  const KtpuSoft sf{a.soft_dom, a.soft_cnt, a.soft_base, a.soft_base_idx,
                    a.read_tids, a.read_w, a.write_tids, a.write_w,
                    a.soft_w, a.Ds, a.Ks};
  const float soft_w = SOFT ? a.soft_w[0] : 0.0f;

  // ---- the rows' state into shared memory, once a launch
  for (int i = tid; i < nloc; i += NT) {
    const int r = r0 + i;
    for (int j = 0; j < R; ++j) {
      s_alloc[(size_t)j * Nl + i] = a.alloc[(size_t)r * R + j];
      s_used[(size_t)j * Nl + i] = a.used[(size_t)r * R + j];
    }
    s_nz[i] = a.nz_used[2 * (size_t)r];
    s_nz[Nl + i] = a.nz_used[2 * (size_t)r + 1];
    s_cnt[i] = a.pod_count[r];
    s_maxp[i] = a.max_pods[r];
    s_fl[i] = (uint8_t)(((a.node_ok[r] && a.valid[r]) ? KTPU_ROW_OK : 0u) |
                        (a.mem_pressure[r] ? KTPU_ROW_MP : 0u));
  }
  // both capacity-gate buffers zero, each CTA its slice of the domains
  if (CAP)
    for (int i = tid; i < nloc; i += NT) {
      a.domcap[r0 + i] = 0.0f;
      a.domcap[(size_t)N + r0 + i] = 0.0f;
    }
  if (rank == 0)
    for (int t = tid; t < T; t += NT) a.ok_units[t] = 0;
  // one local arrival a phase (thread 0's, with the bytes it expects)
  const unsigned cand_bytes = ktpu_xchg_cand_bytes(KTPU_GANG_CLUSTER,
                                                    NT >> 5);
  if (tid == 0) ktpu_xchg_init(s_mbar, 2);
  // every CTA runs, its mbarriers ready, before any reaches another's
  // shared memory
  ktpu_cluster_sync();
  unsigned mph = 0u;   // the parity each slot array's next phase waits for

  // cluster-uniform unit state: every thread computes the same values
  int gang_dom = -1;
  bool gang_ok = true;
  bool elig_on = false;
  bool in_trial = false;
  bool mates_on = false;
  int unit_t0 = 0;
  int n_log = 0;
  int n_cand = 0, n_mm = 0, n_gate = 0;   // exchanges so far, by kind
  // the next entry's rows, loaded before the exchange wait
  bool pf_ok = false;
  // the mask as its raw byte: nothing waits for a load until it is used
  unsigned pf_m[KTPU_GANG_RPT];
  float pf_s[KTPU_GANG_RPT];
  int pf_d[KTPU_GANG_RPT];

  // stage the entries of chunk c into buffer c & 1 (a thread an entry,
  // in turns when the CTA has fewer threads than a chunk has entries)
  auto stage = [&](int c) {
    for (int i = tid; i < KTPU_GANG_CHUNK; i += NT) {
      const int t = c * KTPU_GANG_CHUNK + i;
      if (t >= T) break;
      KtpuGangEntry e;
      e.pi = a.pod_idx[t];
      e.di = a.entry_dom[t];
      e.pin = a.pin_dom[t];
      e.gid = a.gang_id[t];
      e.need = CAP ? a.need[t] : 0.0f;
      int fl = (a.start[t] ? 1 : 0) | (a.end[t] ? 2 : 0);
      e.mask_idx = e.score_idx = e.nom_row = e.soft_base = 0;
      e.seq_term = 0u;
      e.nz0 = e.nz1 = 0.0f;
      if (e.pi >= 0) {
        const int pi = e.pi;
        e.mask_idx = a.mask_idx[pi];
        e.score_idx = a.score_idx[pi];
        e.nom_row = NOM ? a.nom_row[pi] : -1;
        e.soft_base = SOFT ? a.soft_base_idx[pi] : -1;
        e.seq_term = (uint32_t)a.seq[pi] * 40503u;
        e.nz0 = a.nz_req[2 * (size_t)pi];
        e.nz1 = a.nz_req[2 * (size_t)pi + 1];
        fl |= (a.blocked[pi] ? 4 : 0) | (a.active[pi] ? 8 : 0);
      }
      e.flags = fl;
      s_ent[c & 1][i] = e;
    }
  };
  // load entry e's table values at this thread's rows
  auto load_rows = [&](const KtpuGangEntry& e) {
    const unsigned char* mask =
        (const unsigned char*)a.unique_masks + (size_t)e.mask_idx * N;
    const float* stat = a.unique_scores + (size_t)e.score_idx * N;
    const int* dom_row = a.dom_tab + (size_t)(e.di > 0 ? e.di : 0) * N;
#pragma unroll
    for (int k = 0; k < KTPU_GANG_RPT; ++k) {
      const int i = tid + k * NT;
      if (i < nloc) {
        pf_m[k] = mask[r0 + i];
        pf_s[k] = stat[r0 + i];
        pf_d[k] = e.di >= 0 ? dom_row[r0 + i] : -1;
      }
    }
  };

  stage(0);
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    if (PROF && rank == 0 && tid == 0)
      ktpu_prof_stamp(a.prof, a.prof_every, t, 0);
    const KtpuGangEntry e = s_ent[(t / KTPU_GANG_CHUNK) & 1]
                                 [t % KTPU_GANG_CHUNK];
    const int pi = e.pi;
    const bool constrained = e.di >= 0;
    const bool is_start = (e.flags & 1) != 0;
    const bool is_end = (e.flags & 2) != 0;
    const bool gated = CAP && is_start && constrained && e.pin < 0 &&
                       e.need > 0.0f;
    if ((pi >= 0 || gated) && !pf_ok) load_rows(e);
    pf_ok = false;
    if (is_start) {
      in_trial = !is_end;
      n_log = 0;
      gang_dom = e.pin;
      gang_ok = true;
      elig_on = false;
      mates_on = NOM && a.mates && in_trial;
      unit_t0 = t;
      if (mates_on) {
        // the unit's own reservations, per row in entry order, each row
        // by the thread that owns it
        for (int q = t;; ++q) {
          const int pq = a.pod_idx[q];
          const int r = pq >= 0 ? a.nom_row[pq] : -1;
          const int i = r - r0;
          if (r >= 0 && r < N && i >= 0 && i < nloc && i % NT == tid) {
            for (int j = 0; j < R; ++j)
              a.gex_used[(size_t)r * R + j] = __fadd_rn(
                  a.gex_used[(size_t)r * R + j], a.req[(size_t)pq * R + j]);
            a.gex_cnt[r] = __fadd_rn(a.gex_cnt[r], 1.0f);
          }
          if (a.end[q]) break;
        }
      }
      if (gated) {
        // ---- the capacity gate against the committed usage: slot sums
        // per domain (integer-valued, exact in any order), one cluster
        // barrier, then each row's eligibility and its OR over the cluster
        const int buf = n_gate & 1;
        float* dc = a.domcap + (size_t)buf * N;
        float* dc_next = a.domcap + (size_t)(buf ^ 1) * N;
        const float* q = a.greq + (size_t)t * R;
        int lany = 0;
#pragma unroll
        for (int k = 0; k < KTPU_GANG_RPT; ++k) {
          const int i = tid + k * NT;
          if (i >= nloc) continue;
          const int r = r0 + i;
          dc_next[r] = 0.0f;   // the next gate's buffer, this CTA's slice
          const int d = pf_d[k];
          if (!(d >= 0 && d < N && (s_fl[i] & KTPU_ROW_OK))) continue;
          float per = inf;
          for (int j = 0; j < R; ++j) {
            if (!(q[j] > 0.0f)) continue;
            float u = s_used[(size_t)j * Nl + i];
            if (NOM) u = __fadd_rn(u, a.nom_used[(size_t)r * R + j]);
            if (NOM && mates_on)
              u = __fsub_rn(u, a.gex_used[(size_t)r * R + j]);
            per = fminf(per, floorf(__fdiv_rn(
                __fsub_rn(s_alloc[(size_t)j * Nl + i], u),
                fmaxf(q[j], 1e-9f))));
          }
          float c = s_cnt[i];
          if (NOM) c = __fadd_rn(c, a.nom_count[r]);
          if (NOM && mates_on) c = __fsub_rn(c, a.gex_cnt[r]);
          float slots = fminf(per, floorf(__fsub_rn(s_maxp[i], c)));
          slots = fmaxf(slots, 0.0f);
          if (slots != 0.0f) atomicAdd(&dc[d], slots);
        }
        ktpu_cluster_sync();
#pragma unroll
        for (int k = 0; k < KTPU_GANG_RPT; ++k) {
          const int i = tid + k * NT;
          if (i >= nloc) continue;
          const int d = pf_d[k];
          const bool el = d >= 0 && __ldcg(&dc[d < N ? d : N - 1]) >= e.need;
          s_fl[i] = (uint8_t)((s_fl[i] & ~KTPU_ROW_ELIG) |
                              (el ? KTPU_ROW_ELIG : 0u));
          lany |= el ? 1 : 0;
        }
        lany = __syncthreads_or(lany);
        const int par = n_gate & 1;
        if (warp == 0 && lane < KTPU_GANG_CLUSTER)
          *cluster.map_shared_rank(&s_any[par][rank], lane) = lany;
        ktpu_cluster_sync();
        int gany = lane < KTPU_GANG_CLUSTER ? s_any[par][lane] : 0;
        gany = __any_sync(0xffffffffu, gany != 0);
        elig_on = gany != 0;
        ++n_gate;
      }
    }
    if (PROF && rank == 0 && tid == 0)
      ktpu_prof_stamp(a.prof, a.prof_every, t, 1, pi);

    if (pi >= 0) {
      // ---- one member: K7's step over this CTA's domain-masked rows
      const float* req = a.req + (size_t)pi * R;
      const bool blocked = (e.flags & 4) != 0;
      const int nr = e.nom_row;
      const int gd = gang_dom;
      const bool eo = elig_on;
      const bool mo = mates_on;
      bool fit_k[KTPU_GANG_RPT];
      float raw_k[KTPU_GANG_RPT];
#pragma unroll
      for (int k = 0; k < KTPU_GANG_RPT; ++k) {
        const int i = tid + k * NT;
        fit_k[k] = false;
        raw_k[k] = 0.0f;
        if (i >= nloc) continue;
        const int r = r0 + i;
        const uint32_t fl = s_fl[i];
        bool m = pf_m[k] != 0u;
        if (constrained) {
          const int d = pf_d[k];
          m = m && d >= 0 && (gd < 0 || d == gd) &&
              (!eo || (fl & KTPU_ROW_ELIG));
        }
        // the exemption: the unit's reservations, or the pod's own
        const bool self = NOM && r == nr;
        fit_k[k] = ktpu_gang_fits_soa(
            s_alloc, s_used, s_cnt, s_maxp, fl, i, Nl, R, req, blocked, m,
            NOM ? a.nom_used + (size_t)r * R : nullptr,
            NOM ? a.nom_count[r] : 0.0f,
            mo ? a.gex_used + (size_t)r * R : self ? req : nullptr,
            mo ? a.gex_cnt[r] : self ? 1.0f : 0.0f);
        if (SOFT && fit_k[k]) raw_k[k] = ktpu_soft_raw(sf, pi, r, N);
      }
      // soft credits: min and max of raw over the cluster's feasible rows
      float mn = inf, mx = -inf;
      if (SOFT) {
        float lmn = inf, lmx = -inf;
#pragma unroll
        for (int k = 0; k < KTPU_GANG_RPT; ++k)
          if (fit_k[k]) {
            lmn = fminf(lmn, raw_k[k]);
            lmx = fmaxf(lmx, raw_k[k]);
          }
        for (int o = 16; o > 0; o >>= 1) {
          lmn = fminf(lmn, __shfl_xor_sync(0xffffffffu, lmn, o));
          lmx = fmaxf(lmx, __shfl_xor_sync(0xffffffffu, lmx, o));
        }
        if (lane == 0) {
          w_mn[warp] = lmn;
          w_mx[warp] = lmx;
        }
        __syncthreads();
        const int par = n_mm & 1;
        if (warp == 0) {
          lmn = lane < nwarps ? w_mn[lane] : inf;
          lmx = lane < nwarps ? w_mx[lane] : -inf;
          for (int o = 16; o > 0; o >>= 1) {
            lmn = fminf(lmn, __shfl_xor_sync(0xffffffffu, lmn, o));
            lmx = fmaxf(lmx, __shfl_xor_sync(0xffffffffu, lmx, o));
          }
          if (lane < KTPU_GANG_CLUSTER) {
            float* dst = cluster.map_shared_rank(&s_mm[par][rank][0], lane);
            dst[0] = lmn;
            dst[1] = lmx;
          }
        }
        ktpu_cluster_sync();
        lmn = lane < KTPU_GANG_CLUSTER ? s_mm[par][lane][0] : inf;
        lmx = lane < KTPU_GANG_CLUSTER ? s_mm[par][lane][1] : -inf;
        for (int o = 16; o > 0; o >>= 1) {
          lmn = fminf(lmn, __shfl_xor_sync(0xffffffffu, lmn, o));
          lmx = fmaxf(lmx, __shfl_xor_sync(0xffffffffu, lmx, o));
        }
        mn = lmn;
        mx = lmx;
        ++n_mm;
      }
      const bool soft_use = SOFT && e.soft_base >= 0;
      // tie-penalized first max over this thread's rows (ascending)
      float bpen = -inf, bval = KTPU_NEG;
      int brow = 0x7fffffff, bdom = -1;
#pragma unroll
      for (int k = 0; k < KTPU_GANG_RPT; ++k) {
        const int i = tid + k * NT;
        if (i >= nloc) continue;
        const int r = r0 + i;
        float masked = KTPU_NEG;
        if (fit_k[k]) {
          float score = __fadd_rn(
              ktpu_resource_score(s_alloc[i], s_alloc[(size_t)Nl + i],
                                  __fadd_rn(s_nz[i], e.nz0),
                                  __fadd_rn(s_nz[Nl + i], e.nz1), rw0, rw1),
              pf_s[k]);
          if (SOFT)
            score = __fadd_rn(score, ktpu_soft_term(raw_k[k], mn, mx,
                                                    soft_use, soft_w));
          masked = score;
        }
        const float pen = ktpu_tie_penalized(masked, r, e.seq_term);
        if (pen > bpen) {
          bpen = pen;
          brow = r;
          bval = masked;
          bdom = pf_d[k];
        }
      }
      ktpu_warp_argmax(bpen, brow, bval, bdom);
      if (PROF && rank == 0 && tid == 0)
        ktpu_prof_stamp(a.prof, a.prof_every, t, 2);
      // each warp's candidate, stored by its lane q < 8 into the slot
      // (this CTA, this warp) of CTA q, counted on CTA q's mbarrier of that
      // slot array; thread 0 posts this CTA's expected bytes
      const int par = n_cand & 1;
      ktpu_xchg_publish(s_cand[par], &s_mbar[par], rank, warp, lane,
                        KTPU_GANG_CLUSTER, bpen, bval, brow, bdom);
      if (tid == 0) ktpu_mbar_expect(&s_mbar[par], cand_bytes);
      // the next chunk's entries, then the exchange; the next entry's
      // rows load while the other CTAs arrive
      const int tn = t + 1;
      if (tn < T && tn % KTPU_GANG_CHUNK == 0) {
        stage(tn / KTPU_GANG_CHUNK);
        __syncthreads();
      }
      if (PROF && rank == 0 && tid == 0)
        ktpu_prof_stamp(a.prof, a.prof_every, t, 3);
      if (tn < T) {
        const KtpuGangEntry& en = s_ent[(tn / KTPU_GANG_CHUNK) & 1]
                                       [tn % KTPU_GANG_CHUNK];
        if (en.pi >= 0) {
          load_rows(en);
          pf_ok = true;
        }
      }
      if (PROF && rank == 0 && tid == 0)
        ktpu_prof_stamp(a.prof, a.prof_every, t, 6);
      ktpu_xchg_wait(&s_mbar[par], par, mph);
      __syncwarp();
      if (PROF && rank == 0 && tid == 0)
        ktpu_prof_stamp(a.prof, a.prof_every, t, 7);
      ++n_cand;
      // every warp folds the cluster's candidates: 16 a CTA, a warp
      // with no rows (fewer than 16 warps) left at its empty slot
      const KtpuCand win = ktpu_xchg_fold(s_cand[par], KTPU_GANG_CLUSTER,
                                          nwarps, lane);
      const int erow = win.row, edom = win.aux;
      const float eval = win.val;
      if (PROF && rank == 0 && tid == 0)
        ktpu_prof_stamp(a.prof, a.prof_every, t, 4, erow);
      const int best = erow;
      const float chosen = eval;
      // fits[best] & active: a feasible row's masked score is its score,
      // far above the threshold; an infeasible one's is NEG
      const bool ok = chosen > KTPU_NEG_THRESHOLD && (e.flags & 8) != 0;
      if (ok) {
        // ---- the winner's usage, by the thread that owns its row, saved
        // first inside a trial
        const int i = best - r0;
        if (i >= 0 && i < nloc && i % NT == tid) {
          for (int j = 0; j < W; ++j) {
            float* x = j < R ? s_used + (size_t)j * Nl + i
                     : j < R + 2 ? s_nz + (size_t)(j - R) * Nl + i
                                 : s_cnt + i;
            const float add = j < R ? req[j]
                            : j == R ? e.nz0 : j == R + 1 ? e.nz1 : 1.0f;
            if (in_trial) a.log_vals[(size_t)n_log * W + j] = *x;
            *x = __fadd_rn(*x, add);
          }
        }
        if (in_trial && tid == 0) a.log_row[(size_t)rank * T + n_log] = best;
        // CTA 0 writes the credit cells in k order (every CTA read them
        // before the exchange); the barrier below publishes them
        if (SOFT && rank == 0 && tid == 0) {
          const size_t row = (size_t)pi * sf.Ks;
          for (int k = 0; k < sf.Ks; ++k) {
            const int tt = sf.write_tids[row + k];
            const int tc = tt > 0 ? tt : 0;
            const int d = sf.dom[(size_t)tc * N + best];
            const float w = (tt >= 0 && d >= 0) ? sf.write_w[row + k] : 0.0f;
            const size_t cell = (size_t)tc * sf.Ds + (d > 0 ? d : 0);
            float* x = sf.cnt + cell;
            if (in_trial) {
              a.log_soft[(size_t)n_log * sf.Ks + k] = *x;
              a.log_cell[(size_t)n_log * sf.Ks + k] = (int)cell;
            }
            *x = __fadd_rn(*x, w);
          }
        }
        if (in_trial) ++n_log;
        if (constrained && gang_dom < 0) gang_dom = edom;
      }
      gang_ok = gang_ok && ok;
      if (rank == 0 && tid == 0) {
        a.entry_assign[t] = ok ? best : -1;
        a.entry_score[t] = chosen;
      }
    }

    if (is_end) {
      if (rank == 0 && tid == 0) {
        const int g = e.gid;
        if (g >= 0 && g < T) a.ok_units[g] = gang_ok ? 1 : 0;
      }
      if (in_trial && !gang_ok && n_log > 0) {
        // the undo log in reverse order: each row by the thread that owns
        // it (and saved it), the credit cells on CTA 0's thread 0
        __syncthreads();   // tid 0's log_row entries are visible
        for (int qq = n_log - 1; qq >= 0; --qq) {
          const int r = a.log_row[(size_t)rank * T + qq];
          const int i = r - r0;
          if (i >= 0 && i < nloc && i % NT == tid)
            for (int j = 0; j < W; ++j) {
              const float old = a.log_vals[(size_t)qq * W + j];
              if (j < R) s_used[(size_t)j * Nl + i] = old;
              else if (j < R + 2) s_nz[(size_t)(j - R) * Nl + i] = old;
              else s_cnt[i] = old;
            }
        }
        if (SOFT && rank == 0 && tid == 0)
          for (int qq = n_log - 1; qq >= 0; --qq)
            for (int k = sf.Ks - 1; k >= 0; --k) {
              const size_t c = (size_t)qq * sf.Ks + k;
              sf.cnt[a.log_cell[c]] = a.log_soft[c];
            }
      }
      if (mates_on) {
        // gex back to zero, each row by its owner
        for (int q = unit_t0; q <= t; ++q) {
          const int pq = a.pod_idx[q];
          const int r = pq >= 0 ? a.nom_row[pq] : -1;
          const int i = r - r0;
          if (r >= 0 && r < N && i >= 0 && i < nloc && i % NT == tid) {
            for (int j = 0; j < R; ++j)
              a.gex_used[(size_t)r * R + j] = 0.0f;
            a.gex_cnt[r] = 0.0f;
          }
        }
      }
      in_trial = false;
      mates_on = false;
      n_log = 0;
    }
    // the credit writes (and their undo) before any CTA reads them again
    if (SOFT) ktpu_cluster_sync();
    if (PROF && rank == 0 && tid == 0)
      ktpu_prof_stamp(a.prof, a.prof_every, t, 5);
    // a chunk boundary after an entry with no exchange: stage here
    if (pi < 0 && t + 1 < T && (t + 1) % KTPU_GANG_CHUNK == 0) {
      __syncthreads();
      stage((t + 1) / KTPU_GANG_CHUNK);
      __syncthreads();
    }
  }

  // ---- the committed state back to global memory
  for (int i = tid; i < nloc; i += NT) {
    const int r = r0 + i;
    for (int j = 0; j < R; ++j)
      a.used[(size_t)r * R + j] = s_used[(size_t)j * Nl + i];
    a.nz_used[2 * (size_t)r] = s_nz[i];
    a.nz_used[2 * (size_t)r + 1] = s_nz[Nl + i];
    a.pod_count[r] = s_cnt[i];
  }
  // ---- on CTA 0, which wrote them: the all-or-nothing mask and the
  // scatter to the pod axis
  if (rank == 0) {
    for (int p = tid; p < P; p += NT) {
      a.packed[p] = -1;
      a.packed[P + p] = __float_as_int(KTPU_NEG);
    }
    __syncthreads();
    for (int t = tid; t < T; t += NT) {
      const int pi = a.pod_idx[t];
      if (pi < 0 || pi >= P) continue;
      int g = a.gang_id[t];
      g = g < T ? g : T - 1;
      g = g < 0 ? g + T : g;
      a.packed[pi] = a.ok_units[g] ? a.entry_assign[t] : -1;
      a.packed[P + pi] = __float_as_int(a.entry_score[t]);
    }
  }
  // no CTA leaves while another may still write its shared memory
  ktpu_cluster_sync();
}

template <bool SOFT, bool NOM, bool CAP, bool PROF = false>
static void ktpu_launch_gang_scan(const KtpuGangScanParams& a,
                                  cudaStream_t stream) {
  ktpu_gang_scan_kernel<SOFT, NOM, CAP, PROF>
      <<<1, ktpu_gang_threads<SOFT>(), 0, stream>>>(a);
}

// the batch's terms as the launchers' switches number them
static int ktpu_gang_terms(const KtpuGangScanParams* h) {
  return (h->has_soft ? 4 : 0) | (h->has_nom ? 2 : 0) |
         (h->has_cap ? 1 : 0);
}

// the single-block instance (any N and R)
extern "C" int ktpu_gang_scan(const KtpuGangScanParams* h, void* stream) {
  if (h->N < 1 || h->T < 1 || h->R < 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int terms = ktpu_gang_terms(h);
  if (h->prof != nullptr) {
    // the profiling instance: the capacity-gated batch of the gang path
    if (terms != 1 || h->prof_every < 1) return (int)cudaErrorInvalidValue;
    ktpu_launch_gang_scan<false, false, true, true>(*h, s);
    return (int)cudaGetLastError();
  }
  switch (terms) {
    case 0: ktpu_launch_gang_scan<false, false, false>(*h, s); break;
    case 1: ktpu_launch_gang_scan<false, false, true>(*h, s); break;
    case 2: ktpu_launch_gang_scan<false, true, false>(*h, s); break;
    case 3: ktpu_launch_gang_scan<false, true, true>(*h, s); break;
    case 4: ktpu_launch_gang_scan<true, false, false>(*h, s); break;
    case 5: ktpu_launch_gang_scan<true, false, true>(*h, s); break;
    case 6: ktpu_launch_gang_scan<true, true, false>(*h, s); break;
    default: ktpu_launch_gang_scan<true, true, true>(*h, s); break;
  }
  return (int)cudaGetLastError();
}

template <bool SOFT, bool NOM, bool CAP, bool PROF = false>
static cudaError_t ktpu_launch_gang_cluster(const KtpuGangScanParams& a,
                                            int Nl, int threads,
                                            size_t smem,
                                            cudaStream_t stream) {
  auto kern = ktpu_gang_cluster_kernel<SOFT, NOM, CAP, PROF>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(KTPU_GANG_CLUSTER, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = KTPU_GANG_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, a, Nl);
}

// the cluster instance: the rows' state of each CTA in its shared memory
// (kernels/gang.py gang_design picks it where that fits)
extern "C" int ktpu_gang_scan_cluster(const KtpuGangScanParams* h,
                                      void* stream) {
  if (h->N < 1 || h->T < 1 || h->R < 2)
    return (int)cudaErrorInvalidValue;
  const int Nl = (h->N + KTPU_GANG_CLUSTER - 1) / KTPU_GANG_CLUSTER;
  int threads = (Nl + 31) / 32 * 32;
  if (threads > KTPU_GANG_CTHREADS) threads = KTPU_GANG_CTHREADS;
  const size_t smem = ktpu_gang_smem_bytes(Nl, h->R);
  if (Nl > threads * KTPU_GANG_RPT || smem > KTPU_GANG_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int terms = ktpu_gang_terms(h);
  cudaError_t err;
  if (h->prof != nullptr) {
    if (terms != 1 || h->prof_every < 1) return (int)cudaErrorInvalidValue;
    err = ktpu_launch_gang_cluster<false, false, true, true>(*h, Nl, threads,
                                                             smem, s);
  } else {
    switch (terms) {
      case 0: err = ktpu_launch_gang_cluster<false, false, false>(*h, Nl, threads, smem, s); break;
      case 1: err = ktpu_launch_gang_cluster<false, false, true>(*h, Nl, threads, smem, s); break;
      case 2: err = ktpu_launch_gang_cluster<false, true, false>(*h, Nl, threads, smem, s); break;
      case 3: err = ktpu_launch_gang_cluster<false, true, true>(*h, Nl, threads, smem, s); break;
      case 4: err = ktpu_launch_gang_cluster<true, false, false>(*h, Nl, threads, smem, s); break;
      case 5: err = ktpu_launch_gang_cluster<true, false, true>(*h, Nl, threads, smem, s); break;
      case 6: err = ktpu_launch_gang_cluster<true, true, false>(*h, Nl, threads, smem, s); break;
      default: err = ktpu_launch_gang_cluster<true, true, true>(*h, Nl, threads, smem, s); break;
    }
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
