// K12: the class scan in speculative cohorts of W pods, in ONE launch.
//
// Replaces kubernetes_tpu/scheduler/kernels/speculative.py
// schedule_batch_speculative (a jax.jit program: lax.scan of _spec_chunk
// over the cohorts). Its contract is K2's decisions, bit for bit, on every
// batch: a cohort is elected in one shot against the frozen [C, N] table,
// the kernel checks exactly whether the serial scan would have chosen the
// same, and where it would not, the whole cohort replays the serial step.
//
// Two designs (kernels/batch.py spec_scan_design picks one): the cluster
// design (spec_scan_cluster.cu, its notes), 16 CTAs holding the rows'
// state in shared memory, where the batch fits it, and the block design
// below (any batch: more than 32 classes, rows or zones past the
// cluster's limits).
//
// The fence first. A member's checks read only earlier members, and an
// active member that reads carried terms (spec_plain false) collides by
// itself, so with f the first such member the first collider is at most
// f: only the members [0, f) are elected and checked, and with f = 0 the
// cohort goes straight to the repair (no election, no rows, no columns).
// The stats still record the exact first collider.
//
// The block design: one persistent block walks the cohorts in order (1024
// threads; the spread-and-soft instances 512, so that no instance
// spills). Per cohort of W pods, in the order of the reference's
// _spec_chunk:
//   0. the fence: warp 0 ballots for f;
//   1. election of the members [0, f) (:124-140): warp w elects members
//      w, w + nwarps, ...; each takes a warp-wide tie-penalized first-max
//      over its class row (lanes own rows lane, lane + 32, ...; ties to
//      the lowest row, as max + where + min gives them);
//   2. each winner's post-write row (:147-154): usage + okf * class req
//      (+ the nominated reservations with NOM), in the serial refresh's
//      op order, into a device scratch buffer; then its column over every
//      class (:155-160) with score.cuh's ktpu_class_score, K2's refresh
//      arithmetic;
//   3. the exact checks (:161-172), a (j, i) pair a thread: type 1, an
//      earlier winner on the same row; type 2, an earlier winner's column
//      value of the member's class, tie-penalized with the member's seq,
//      >= the member's frozen maximum. The first collider by a block-wide
//      atomicMin, from f;
//   4. a clean cohort (:174-209) writes the winners' usage rows, table
//      columns and spread counts (distinct rows: no two threads write one
//      place), then thread 0 applies the topology and credit writes in pod order
//      through affinity.cuh, as K2 does; a dirty one (:211-218) replays
//      every member from the pre-cohort carry through class_step.cuh's
//      ktpu_class_pod_step, the step K2's global design runs;
//   5. packed [2, P] (assign, score bits) and stats [P / W, 2] (accepted,
//      first collider; W when clean).
// The knob KTPU_SPEC_GROUP (cohorts a scan step unrolls) changes no
// decision and no stat, so the kernel walks cohorts one by one.
//
// Bound: the dependency chain, as K2's. A clean cohort costs one
// election (N / 32 rows a lane), W x C class scores and six block
// barriers in place of W serial steps of four or five each; a dirty one
// costs the members before the fence and W serial steps.
#include "spec_scan.cuh"

#define KTPU_SPEC_THREADS 1024

// threads of the block design: the spread-and-soft instances run at 512
// (128 registers a thread) so that no instance spills
template <bool SPREAD, bool SOFT>
__host__ __device__ constexpr int ktpu_spec_threads() {
  return (SPREAD && SOFT) ? 512 : KTPU_SPEC_THREADS;
}

struct KtpuSpecArgs {
  const bool* spec_plain;
  int* stats;
  float* vbest;             // [W] frozen tie-penalized maximum
  float* chosen;            // [W] masked score at the winner row
  float* ub;                // [W, R] winner row's used after the write
  float* eb;                // [W, R] the same + reservations (NOM)
  float* nzb;               // [W, 2]
  float* cb;                // [W] pod count after the write
  float* cbe;               // [W] the same + reservations (NOM)
  float* cols;              // [W, C] winner columns
  int* best;                // [W] winner row
  int* ok;                  // [W] bound (feasible and active)
  int W;
};

template <bool SPREAD, bool TOPO, bool SOFT, bool NOM, bool PROF = false>
__global__ void __launch_bounds__(ktpu_spec_threads<SPREAD, SOFT>(), 1)
ktpu_spec_scan_kernel(KtpuScanArgs a, KtpuSpecArgs s) {
  extern __shared__ float zs[];  // [Z] zone sums (the repair's steps)
  __shared__ int s_f, s_first;
  const KtpuStepConst kc = ktpu_step_const<SPREAD, SOFT>(a);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  const int N = a.N, R = a.R, C = a.C, W = s.W;
  const float inf = __int_as_float(0x7f800000);
  const bool stamp = PROF && tid == 0;

  for (int c0 = 0; c0 < a.P; c0 += W) {
    const int step = c0 / W;
    if (stamp) ktpu_prof_stamp(a.prof, a.prof_every, step, 0);
    // ---- 0. the fence: the first active member that reads carried terms
    if (warp == 0) {
      int f = W;
      for (int b = 0; b < W; b += 32) {
        const int m = b + lane;
        const bool fenced =
            m < W && !s.spec_plain[c0 + m] && a.active[c0 + m];
        const unsigned bal = __ballot_sync(0xffffffffu, fenced);
        if (bal != 0u) {
          f = b + __ffs(bal) - 1;
          break;
        }
      }
      if (lane == 0) {
        s_f = f;
        s_first = f;
      }
    }
    __syncthreads();
    const int f = s_f;
    if (stamp) ktpu_prof_stamp(a.prof, a.prof_every, step, 1, f);

    if (f > 0) {
      // ---- 1. election of the members before the fence
      for (int m = warp; m < f; m += nwarps) {
        const int p = c0 + m;
        const float* ms_u = a.ms + (size_t)a.class_idx[p] * N;
        const uint32_t seq_term = (uint32_t)a.seq[p] * 40503u;
        float bpen = -inf, bval = KTPU_NEG;
        int brow = 0x7fffffff;
        for (int r = lane; r < N; r += 32) {
          const float base = ms_u[r];
          const float masked = base > KTPU_NEG_THRESHOLD ? base : KTPU_NEG;
          const float pen = ktpu_tie_penalized(masked, r, seq_term);
          if (pen > bpen) {  // rows ascend: strict > keeps the first max
            bpen = pen;
            brow = r;
            bval = masked;
          }
        }
        ktpu_argmax_warp(bpen, brow, bval);
        if (lane == 0) {
          s.vbest[m] = bpen;
          s.best[m] = brow;
          s.chosen[m] = bval;
          s.ok[m] = bval > KTPU_NEG_THRESHOLD && a.active[p];
        }
      }
      __syncthreads();
      if (stamp) ktpu_prof_stamp(a.prof, a.prof_every, step, 2);

      // ---- 2. each winner's row after its write (losers add 0 * req),
      // then its column over every class
      for (int j = tid; j < f * R; j += nthreads) {
        const int m = j / R, r = j - m * R;
        const int b = s.best[m];
        const float okf = s.ok[m] ? 1.0f : 0.0f;
        const float x = __fadd_rn(
            a.used[(size_t)b * R + r],
            __fmul_rn(okf, a.cl.req[(size_t)a.class_idx[c0 + m] * R + r]));
        s.ub[j] = x;
        if (NOM) s.eb[j] = __fadd_rn(x, a.nom_used[(size_t)b * R + r]);
      }
      for (int m = tid; m < f; m += nthreads) {
        const int b = s.best[m];
        const int u = a.class_idx[c0 + m];
        const float okf = s.ok[m] ? 1.0f : 0.0f;
        for (int k = 0; k < 2; ++k)
          s.nzb[2 * m + k] = __fadd_rn(a.nz_used[2 * b + k],
                                       __fmul_rn(okf, a.cl.nz[2 * u + k]));
        s.cb[m] = __fadd_rn(a.pod_count[b], okf);
        if (NOM) s.cbe[m] = __fadd_rn(s.cb[m], a.nom_count[b]);
      }
      __syncthreads();
      for (int j = tid; j < f * C; j += nthreads) {
        const int m = j / C, c = j - m * C;
        s.cols[j] = ktpu_class_score(
            a.cfg, a.cl, kc.rw0, kc.rw1, c, s.best[m], N, R,
            (NOM ? s.eb : s.ub) + (size_t)m * R, s.nzb[2 * m],
            s.nzb[2 * m + 1], NOM ? s.cbe[m] : s.cb[m]);
      }
      __syncthreads();
      if (stamp) ktpu_prof_stamp(a.prof, a.prof_every, step, 3);

      // ---- 3. type 1 and type 2, a (j, i) pair a thread; the first
      // collider, from f
      for (int q = tid; q < f * f; q += nthreads) {
        const int j = q / f, i = q - j * f;
        if (j >= i || !s.ok[i] || !s.ok[j]) continue;
        const int p = c0 + i;
        const bool hit =
            s.best[j] == s.best[i] ||
            ktpu_tie_penalized(s.cols[(size_t)j * C + a.class_idx[p]],
                               s.best[j], (uint32_t)a.seq[p] * 40503u) >=
                s.vbest[i];
        if (hit) atomicMin(&s_first, i);
      }
      __syncthreads();
    } else if (stamp) {
      ktpu_prof_stamp(a.prof, a.prof_every, step, 2);
      ktpu_prof_stamp(a.prof, a.prof_every, step, 3);
    }
    const int first = s_first;
    if (stamp) ktpu_prof_stamp(a.prof, a.prof_every, step, 4, first);

    if (first >= W) {
      // ---- 4a. the clean cohort: winners sit on distinct rows
      const int n_upd = R + 3 + (SPREAD ? a.G : 0);
      for (int j = tid; j < W * n_upd; j += nthreads) {
        const int m = j / n_upd, q = j - m * n_upd;
        if (!s.ok[m]) continue;
        const int b = s.best[m];
        if (q < R) {
          a.used[(size_t)b * R + q] = s.ub[(size_t)m * R + q];
        } else if (q < R + 2) {
          a.nz_used[2 * b + q - R] = s.nzb[2 * m + q - R];
        } else if (q == R + 2) {
          a.pod_count[b] = s.cb[m];
        } else {
          const int gg = q - R - 3;
          float* x = a.spread + (size_t)gg * N + b;
          *x = __fadd_rn(*x, __fmul_rn(
              a.spread_match[(size_t)(c0 + m) * a.G + gg], 1.0f));
        }
      }
      // a clean cohort had f = W: every winner's column was computed
      for (int j = tid; j < W * C; j += nthreads) {
        const int m = j / C, c = j - m * C;
        if (s.ok[m]) a.ms[(size_t)c * N + s.best[m]] = s.cols[j];
      }
      if (tid == 0) {
        for (int m = 0; m < W; ++m) {
          if (TOPO) ktpu_topo_scatter(a.topo, c0 + m, s.best[m], N, s.ok[m]);
          if (SOFT) ktpu_soft_write(a.soft, c0 + m, s.best[m], N, s.ok[m]);
        }
      }
      for (int m = tid; m < W; m += nthreads) {
        a.packed[c0 + m] = s.ok[m] ? s.best[m] : -1;
        a.packed[a.P + c0 + m] = __float_as_int(s.chosen[m]);
      }
      __syncthreads();
    } else {
      // ---- 4b. repair: the whole cohort through the serial step
      for (int m = 0; m < W; ++m)
        ktpu_class_pod_step<SPREAD, TOPO, SOFT, NOM>(a, c0 + m, kc, zs);
    }
    if (tid == 0) {
      s.stats[2 * step] = first >= W ? 1 : 0;
      s.stats[2 * step + 1] = first;
    }
    if (stamp) ktpu_prof_stamp(a.prof, a.prof_every, step, 5);
  }
}

template <bool SPREAD, bool TOPO, bool SOFT, bool NOM, bool PROF = false>
static void ktpu_launch_spec(const KtpuScanArgs& a, const KtpuSpecArgs& s,
                             size_t smem, cudaStream_t stream) {
  ktpu_spec_scan_kernel<SPREAD, TOPO, SOFT, NOM, PROF>
      <<<1, ktpu_spec_threads<SPREAD, SOFT>(), smem, stream>>>(a, s);
}

template <bool NOM>
static void ktpu_launch_spec_terms(int terms, const KtpuScanArgs& a,
                                   const KtpuSpecArgs& sp, size_t smem,
                                   cudaStream_t s) {
  switch (terms) {
    case 0: ktpu_launch_spec<false, false, false, NOM>(a, sp, smem, s); break;
    case 1: ktpu_launch_spec<false, false, true, NOM>(a, sp, smem, s); break;
    case 2: ktpu_launch_spec<false, true, false, NOM>(a, sp, smem, s); break;
    case 3: ktpu_launch_spec<false, true, true, NOM>(a, sp, smem, s); break;
    case 4: ktpu_launch_spec<true, false, false, NOM>(a, sp, smem, s); break;
    case 5: ktpu_launch_spec<true, false, true, NOM>(a, sp, smem, s); break;
    case 6: ktpu_launch_spec<true, true, false, NOM>(a, sp, smem, s); break;
    default: ktpu_launch_spec<true, true, true, NOM>(a, sp, smem, s); break;
  }
}

// the block design (any batch)
extern "C" int ktpu_spec_scan(const KtpuSpecParams* h, void* stream) {
  const KtpuScanParams* hs = &h->scan;
  const int W = h->W, R = hs->R, C = hs->C;
  if ((hs->has_nom && R > KTPU_MAX_R) || W < 1 || hs->P % W != 0 ||
      h->fscratch_len < W * (2 * R + 5 + C) || h->iscratch_len < 2 * W)
    return (int)cudaErrorInvalidValue;
  const KtpuScanArgs a = ktpu_scan_args(hs);
  KtpuSpecArgs s;
  s.spec_plain = h->spec_plain;
  s.stats = h->stats;
  s.vbest = h->fscratch;
  s.chosen = s.vbest + W;
  s.ub = s.chosen + W;
  s.eb = s.ub + (size_t)W * R;
  s.nzb = s.eb + (size_t)W * R;
  s.cb = s.nzb + 2 * W;
  s.cbe = s.cb + W;
  s.cols = s.cbe + W;
  s.best = h->iscratch;
  s.ok = s.best + W;
  s.W = W;
  const size_t smem = (size_t)a.Z * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  const int terms = ktpu_scan_terms(hs);
  if (hs->prof != nullptr) {
    if (!ktpu_scan_prof_ok(hs)) return (int)cudaErrorInvalidValue;
    if (terms == 4)
      ktpu_launch_spec<true, false, false, false, true>(a, s, smem, st);
    else
      ktpu_launch_spec<false, false, false, false, true>(a, s, smem, st);
  } else if (hs->has_nom) {
    ktpu_launch_spec_terms<true>(terms, a, s, smem, st);
  } else {
    ktpu_launch_spec_terms<false>(terms, a, s, smem, st);
  }
  return (int)cudaGetLastError();
}
