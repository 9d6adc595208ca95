// K7: the classic per-pod scan over one batch of P pods, in ONE launch.
//
// Replaces kubernetes_tpu/scheduler/kernels/batch.py schedule_batch's
// classic branch (:652, the lax.scan of one_pod :702-769 with its carry
// set-up :771-784 and new_usage :810-816): the route of a batch without
// class tables (KTPU_CLASS_SCAN=0), the reference's parity control of the
// class route.
//
// Each pod sees the usage every earlier pod's bind left behind, so the
// pods run in order, each over every row (the designs below split the
// rows differently). Per pod, in the order of one_pod:
//   1. feasibility at every row against the running usage (pod.cuh
//      ktpu_pod_fits; with the nominated overlay (NOM) the reservations
//      added and the pod's own nominated row exempt), then with topology
//      counters `fits &= ~topo_bad` (affinity.cuh);
//   2. one block reduction over the feasible rows: with soft credits the
//      min and max of the raw inter-pod score; with spread groups the max
//      count, have_zones and the shared-memory zone sums (integer-valued
//      f32, exact in any order below 2^24). Each thread keeps its rows'
//      fits as bits for the second pass (the block design's N <= 32 * 512;
//      above that it recomputes them);
//   3. score = base (pod.cuh ktpu_pod_base) + soft + (spread_w *
//      use_spread) * spread, each a rounding of its own (without spread
//      groups the reference's zero-weight spread term, + 0.0), the
//      tie-penalized first-max argmax (ties to the lowest row); the chosen
//      score is the un-penalized masked value;
//   4. the winner's used / nonzero_used / pod_count / spread columns (every
//      group's spread_match), and on thread 0, in k order, its topology and
//      credit writes; assign and the bits of the chosen score into the
//      packed [2, P].
// The whole difference from K2 (class_scan.cu): no [C, N] table and no
// winner-column refresh; every pod recomputes fits and score over all N
// rows from the usage itself.
//
// Two designs of that walk (kernels/batch.py pod_scan_design picks one):
//   cluster (pod_scan_cluster.cu, where the rows' state fits): the rows
//     over one thread-block cluster of 16 CTAs, their state in shared
//     memory, one exchange of candidates a pod (its notes);
//   block (this file, any batch): one persistent block of 512 threads,
//     thread t owning rows t, t + 512, ..., the state in global memory
//     and the warp partials folded by every thread in turn. 512, not
//     1,024: at 1,024 threads (64 registers) three instances spilled.
//
// Bound: the dependency chain from one pod to the next, as for K2. Each
// pod reads the [N, R] usage and allocatable rows (from L2: 2 * N * R * 4
// bytes, 512 KB at N = 8,192, R = 8) and does O(N * (R + K + Ks)) work;
// in the block design three or four block barriers per pod and the rows
// of one SM set the time.
#include "pod.cuh"
#include "pod_scan.cuh"
#include "prof.cuh"

#define KTPU_POD_THREADS 512

template <bool SPREAD, bool TOPO, bool SOFT, bool NOM, bool PROF>
__global__ void __launch_bounds__(KTPU_POD_THREADS, 1)
ktpu_pod_scan_kernel(KtpuPodScanArgs a) {
  extern __shared__ float zs[];  // [Z] zone sums
  __shared__ float w_pen[32];
  __shared__ int w_row[32];
  __shared__ float w_val[32];
  __shared__ float w_maxc[32];
  __shared__ int w_hz[32];
  __shared__ float w_mn[32];
  __shared__ float w_mx[32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  const int N = a.N, R = a.R;
  const float rw0 = a.rw[0], rw1 = a.rw[1];
  const float inf = __int_as_float(0x7f800000);
  const float sw = SPREAD ? a.spread_w[0] : 0.0f;
  const float soft_w = SOFT ? a.soft.weight[0] : 0.0f;
  // the reduction pass keeps each row's fits as one bit of a word
  const bool keep_bits = (SPREAD || SOFT) && N <= 32 * nthreads;

  for (int p = 0; p < a.P; ++p) {
    if (PROF && tid == 0) ktpu_prof_stamp(a.prof, a.prof_every, p, 0);
    KtpuPod pod;
    pod.req = a.req + (size_t)p * R;
    pod.nz0 = a.nz_req[2 * p];
    pod.nz1 = a.nz_req[2 * p + 1];
    pod.blocked = a.blocked[p];
    const bool* mask = a.unique_masks + (size_t)a.mask_idx[p] * N;
    const float* stat = a.unique_scores + (size_t)a.score_idx[p] * N;
    const uint32_t seq_term = (uint32_t)a.seq[p] * 40503u;
    // rows never equal an out-of-range nominated row, as in the reference
    const int nr = NOM ? a.nom_row[p] : -1;
    if (PROF && tid == 0)
      ktpu_prof_stamp(a.prof, a.prof_every, p, 1,
                      a.mask_idx[p] + a.score_idx[p] + (int)seq_term);
    auto fit_at = [&](int r) -> bool {
      bool f = ktpu_pod_fits(
          a.cfg, r, R, pod, mask[r], a.used + (size_t)r * R,
          NOM ? a.nom_used + (size_t)r * R : nullptr, a.pod_count[r],
          NOM ? a.nom_count[r] : 0.0f, NOM && r == nr);
      if (TOPO) f = f && !ktpu_topo_bad(a.topo, p, r, N);
      return f;
    };

    // ---- reductions over the feasible set (soft min/max, spread)
    float maxc = 0.0f, maxz = 0.0f, sw_use = 0.0f, mn = inf, mx = -inf;
    bool have_zones = false;
    bool soft_use = false;
    const float* cnt_g = nullptr;
    uint32_t bits = 0u;
    if (SPREAD) {
      const int g = a.spread_gidx[p];
      sw_use = __fmul_rn(sw, g >= 0 ? 1.0f : 0.0f);
      cnt_g = a.spread + (size_t)(g > 0 ? g : 0) * N;
      for (int z = tid; z < a.Z; z += nthreads) zs[z] = a.zinit[z];
      __syncthreads();
    }
    if (PROF && tid == 0) ktpu_prof_stamp(a.prof, a.prof_every, p, 2);
    if (SOFT) soft_use = a.soft.base_idx[p] >= 0;
    if (SPREAD || SOFT) {
      float lmax = 0.0f, lmn = inf, lmx = -inf;
      int lhz = 0;
      for (int r = tid, k = 0; r < N; r += nthreads, ++k) {
        const bool fit = fit_at(r);
        if (keep_bits && fit) bits |= 1u << k;
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
    for (int r = tid, k = 0; r < N; r += nthreads, ++k) {
      const bool fit = keep_bits ? ((bits >> k) & 1u) != 0u : fit_at(r);
      float masked = KTPU_NEG;
      if (fit) {
        float score = ktpu_pod_base(a.cfg, r, R, pod, a.nz_used[2 * r],
                                    a.nz_used[2 * r + 1], rw0, rw1,
                                    stat[r]);
        if (SOFT)
          score = __fadd_rn(score, ktpu_soft_term(
              ktpu_soft_raw(a.soft, p, r, N), mn, mx, soft_use, soft_w));
        if (SPREAD)
          score = __fadd_rn(score, __fmul_rn(sw_use, ktpu_spread_score(
              cnt_g[r], a.zone_of[r], zs, a.Z, maxc, maxz, have_zones)));
        else
          score = __fadd_rn(score, 0.0f);
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
    // fits[best] & active: a feasible row's masked score is its score,
    // far above the threshold; an infeasible one's is NEG
    const bool ok = chosen > KTPU_NEG_THRESHOLD && a.active[p];
    const float okf = ok ? 1.0f : 0.0f;
    if (PROF && tid == 0)
      ktpu_prof_stamp(a.prof, a.prof_every, p, 5, best + (ok ? 1 : 0));

    // ---- the winner's usage columns (added even when !ok, as 0 * req)
    const int n_upd = R + 3 + (SPREAD ? a.G : 0);
    for (int j = tid; j < n_upd; j += nthreads) {
      if (j < R) {
        float* x = a.used + (size_t)best * R + j;
        *x = __fadd_rn(*x, __fmul_rn(okf, pod.req[j]));
      } else if (j < R + 2) {
        const int k = j - R;
        float* x = a.nz_used + (size_t)best * 2 + k;
        *x = __fadd_rn(*x, __fmul_rn(okf, a.nz_req[(size_t)p * 2 + k]));
      } else if (j == R + 2) {
        a.pod_count[best] = __fadd_rn(a.pod_count[best], okf);
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
      a.packed[p] = ok ? best : -1;
      a.packed[a.P + p] = __float_as_int(chosen);
    }
    if (PROF && tid == 0) ktpu_prof_stamp(a.prof, a.prof_every, p, 6);
    __syncthreads();
    if (PROF && tid == 0) ktpu_prof_stamp(a.prof, a.prof_every, p, 7);
  }
}

template <bool SPREAD, bool TOPO, bool SOFT, bool NOM, bool PROF = false>
static void ktpu_launch_pod_scan(const KtpuPodScanArgs& a, size_t smem,
                                 cudaStream_t stream) {
  ktpu_pod_scan_kernel<SPREAD, TOPO, SOFT, NOM, PROF>
      <<<1, KTPU_POD_THREADS, smem, stream>>>(a);
}

template <bool NOM>
static void ktpu_launch_pod_terms(int terms, const KtpuPodScanArgs& a,
                                  size_t smem, cudaStream_t s) {
  switch (terms) {
    case 0: ktpu_launch_pod_scan<false, false, false, NOM>(a, smem, s); break;
    case 1: ktpu_launch_pod_scan<false, false, true, NOM>(a, smem, s); break;
    case 2: ktpu_launch_pod_scan<false, true, false, NOM>(a, smem, s); break;
    case 3: ktpu_launch_pod_scan<false, true, true, NOM>(a, smem, s); break;
    case 4: ktpu_launch_pod_scan<true, false, false, NOM>(a, smem, s); break;
    case 5: ktpu_launch_pod_scan<true, false, true, NOM>(a, smem, s); break;
    case 6: ktpu_launch_pod_scan<true, true, false, NOM>(a, smem, s); break;
    default: ktpu_launch_pod_scan<true, true, true, NOM>(a, smem, s); break;
  }
}

// the block design (any batch); the profiling instances exist for the
// uniform and spread batches only
extern "C" int ktpu_pod_scan(const KtpuPodScanParams* h, void* stream) {
  const KtpuPodScanArgs a = ktpu_pod_scan_args(h);
  const size_t smem = (size_t)a.Z * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  const int terms = ktpu_pod_terms(h);
  if (h->prof != nullptr) {
    if (!ktpu_pod_prof_ok(h)) return (int)cudaErrorInvalidValue;
    if (terms == 4)
      ktpu_launch_pod_scan<true, false, false, false, true>(a, smem, s);
    else
      ktpu_launch_pod_scan<false, false, false, false, true>(a, smem, s);
  } else if (h->has_nom) {
    ktpu_launch_pod_terms<true>(terms, a, smem, s);
  } else {
    ktpu_launch_pod_terms<false>(terms, a, smem, s);
  }
  return (int)cudaGetLastError();
}
