// K12: the class scan in speculative cohorts of W pods, in ONE launch.
//
// Replaces kubernetes_tpu/scheduler/kernels/speculative.py
// schedule_batch_speculative (a jax.jit program: lax.scan of _spec_chunk
// over the cohorts). Its contract is K2's decisions, bit for bit, on every
// batch: a cohort is elected in one shot against the frozen [C, N] table,
// the kernel checks exactly whether the serial scan would have chosen the
// same, and where it would not, the whole cohort replays the serial step.
//
// One persistent block of 1024 threads walks the cohorts in order. Per
// cohort of W pods, in the order of the reference's _spec_chunk:
//   1. election (:124-140): warp w elects members w, w + 32, ...; each
//      member takes a warp-wide tie-penalized first-max over its class row
//      (lanes own rows lane, lane + 32, ...; ties to the lowest row, as
//      max + where + min gives them), any W up to P;
//   2. each winner's post-write row (:147-154): usage + okf * class req
//      (+ the nominated reservations with NOM), in the serial refresh's
//      op order, into a device scratch buffer;
//   3. the W x C winner columns (:155-160) with score.cuh's
//      ktpu_class_score, K2's refresh arithmetic, into the scratch;
//   4. the exact checks (:161-172): type 1, an earlier winner on the same
//      row; type 2, an earlier winner's column value of the member's
//      class, tie-penalized with the member's seq, >= the member's frozen
//      maximum; the fence, an active pod that reads carried terms
//      (spec_plain false). The first collider by a block-wide atomicMin;
//   5. a clean cohort (:174-209) writes the winners' usage rows, table
//      columns and spread counts (distinct rows: no two threads write one
//      place), then thread 0 applies the topology and credit writes in pod
//      order through affinity.cuh, as K2 does; a dirty one (:211-218)
//      replays every member from the pre-cohort carry through
//      class_step.cuh's ktpu_class_pod_step, the step K2 runs;
//   6. packed [2, P] (assign, score bits) and stats [P / W, 2] (accepted,
//      first collider; W when clean).
// The knob KTPU_SPEC_GROUP (cohorts a scan step unrolls) changes no
// decision and no stat, so the kernel walks cohorts one by one.
//
// Bound: the dependency chain, as K2's. A clean cohort costs one
// election (N / 32 rows a lane), W x C class scores and four block
// barriers in place of W serial steps of four or five each; a dirty one
// costs that plus W serial steps.
#include "class_step.cuh"

#define KTPU_SPEC_THREADS 1024

// K12's parameter block: K2's, then the cohort fields (kernels/batch.py
// _SpecParams, ctypes lays the nested Structure out as C does)
struct KtpuSpecParams {
  KtpuScanParams scan;
  const bool* spec_plain;   // [P]      the pod reads no carried term
  int* stats;               // [P / W, 2]
  float* fscratch;          // [W * (2R + 5 + C)]
  int* iscratch;            // [2W]
  int W;                    // cohort width, divides P
  int fscratch_len, iscratch_len;
};

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

template <bool SPREAD, bool TOPO, bool SOFT, bool NOM>
__global__ void __launch_bounds__(KTPU_SPEC_THREADS, 1)
ktpu_spec_scan_kernel(KtpuScanArgs a, KtpuSpecArgs s) {
  extern __shared__ float zs[];  // [Z] zone sums (the repair's steps)
  __shared__ int s_first;
  const KtpuStepConst kc = ktpu_step_const<SPREAD, SOFT>(a);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  const int N = a.N, R = a.R, C = a.C, W = s.W;
  const float inf = __int_as_float(0x7f800000);

  for (int c0 = 0; c0 < a.P; c0 += W) {
    if (tid == 0) s_first = W;
    // ---- 1. election against the frozen table
    for (int m = warp; m < W; m += nwarps) {
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
        s.vbest[m] = bpen;
        s.best[m] = brow;
        s.chosen[m] = bval;
        s.ok[m] = bval > KTPU_NEG_THRESHOLD && a.active[p];
      }
    }
    __syncthreads();

    // ---- 2. each winner's row after its write (losers add 0 * req)
    for (int j = tid; j < W * R; j += nthreads) {
      const int m = j / R, r = j - m * R;
      const int b = s.best[m];
      const float okf = s.ok[m] ? 1.0f : 0.0f;
      const float x = __fadd_rn(
          a.used[(size_t)b * R + r],
          __fmul_rn(okf, a.cl.req[(size_t)a.class_idx[c0 + m] * R + r]));
      s.ub[j] = x;
      if (NOM) s.eb[j] = __fadd_rn(x, a.nom_used[(size_t)b * R + r]);
    }
    for (int m = tid; m < W; m += nthreads) {
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

    // ---- 3. the winner columns over every class
    for (int j = tid; j < W * C; j += nthreads) {
      const int m = j / C, c = j - m * C;
      s.cols[j] = ktpu_class_score(
          a.cfg, a.cl, kc.rw0, kc.rw1, c, s.best[m], N, R,
          (NOM ? s.eb : s.ub) + (size_t)m * R, s.nzb[2 * m],
          s.nzb[2 * m + 1], NOM ? s.cbe[m] : s.cb[m]);
    }
    __syncthreads();

    // ---- 4. type 1, type 2 and the fence; the first collider
    for (int i = tid; i < W; i += nthreads) {
      const int p = c0 + i;
      bool hit = !s.spec_plain[p] && a.active[p];
      if (!hit && s.ok[i]) {
        const int ui = a.class_idx[p];
        const uint32_t st = (uint32_t)a.seq[p] * 40503u;
        for (int j = 0; j < i && !hit; ++j) {
          if (!s.ok[j]) continue;
          hit = s.best[j] == s.best[i] ||
                ktpu_tie_penalized(s.cols[(size_t)j * C + ui], s.best[j],
                                   st) >= s.vbest[i];
        }
      }
      if (hit) atomicMin(&s_first, i);
    }
    __syncthreads();
    const int first = s_first;

    if (first >= W) {
      // ---- 5a. the clean cohort: winners sit on distinct rows
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
      // ---- 5b. repair: the whole cohort through the serial step
      for (int m = 0; m < W; ++m)
        ktpu_class_pod_step<SPREAD, TOPO, SOFT, NOM>(a, c0 + m, kc, zs);
    }
    if (tid == 0) {
      s.stats[2 * (c0 / W)] = first >= W ? 1 : 0;
      s.stats[2 * (c0 / W) + 1] = first;
    }
  }
}

template <bool SPREAD, bool TOPO, bool SOFT, bool NOM>
static void ktpu_launch_spec(const KtpuScanArgs& a, const KtpuSpecArgs& s,
                             size_t smem, cudaStream_t stream) {
  ktpu_spec_scan_kernel<SPREAD, TOPO, SOFT, NOM>
      <<<1, KTPU_SPEC_THREADS, smem, stream>>>(a, s);
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
  if (hs->has_nom)
    ktpu_launch_spec_terms<true>(terms, a, s, smem, st);
  else
    ktpu_launch_spec_terms<false>(terms, a, s, smem, st);
  return (int)cudaGetLastError();
}
