// K9: the all-or-nothing member scan over one gang batch, in ONE launch.
//
// Replaces kubernetes_tpu/scheduler/kernels/gang.py gang_schedule_batch
// (:93, the lax.scan of one_entry :131-239, the all-or-nothing mask and
// the scatter to the pod axis :275-293): the route of every batch that
// carries a PodGroup member.
//
// The batch's placement units (gangs, and every singleton as a gang of
// one) come flattened into T entries (kernels/gang.py's docstring), each
// unit a contiguous run from a start entry to an end entry. One
// persistent block of 1024 threads walks the entries in order; each
// thread owns node rows tid, tid + 1024, ... Per entry:
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
//   2. a member (pod_idx >= 0) takes K7's step (pod.cuh): feasibility
//      against the running usage under its mask and the domain mask
//      (:189-193), the soft credits read from the running accumulators
//      (:205-211), the tie-penalized first-max argmax; the chosen score is
//      the masked value at the winner, also for a member of a gang that is
//      rejected later. A member that places writes its usage and credits,
//      pins the gang's domain, and a member that does not clears gang_ok;
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
// Bound: the dependency chain from one entry to the next, as for K7:
// three or four block barriers per entry; the gate adds an [N] pass and
// two barriers at each constrained gang's start. One of the card's SMs is
// busy.
#include "score.cuh"
#include "affinity.cuh"
#include "pod.cuh"

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
  int N, R, P, T, K, Ts, Ds, Ks, Sb;
  int has_soft, has_nom, has_cap, mates;
};

#define KTPU_GANG_THREADS 1024

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

template <bool SOFT, bool NOM, bool CAP>
__global__ void __launch_bounds__(KTPU_GANG_THREADS, 1)
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

template <bool SOFT, bool NOM, bool CAP>
static void ktpu_launch_gang_scan(const KtpuGangScanParams& a,
                                  cudaStream_t stream) {
  ktpu_gang_scan_kernel<SOFT, NOM, CAP>
      <<<1, KTPU_GANG_THREADS, 0, stream>>>(a);
}

extern "C" int ktpu_gang_scan(const KtpuGangScanParams* h, void* stream) {
  if (h->N < 1 || h->T < 1 || h->R < 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int terms = (h->has_soft ? 4 : 0) | (h->has_nom ? 2 : 0) |
                    (h->has_cap ? 1 : 0);
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
