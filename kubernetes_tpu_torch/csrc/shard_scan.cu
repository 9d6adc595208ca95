// K15: the sharded class scan over one batch of P pods, in ONE launch of
// one thread-block cluster.
//
// Replaces kubernetes_tpu/scheduler/kernels/batch.py
// schedule_batch_sharded (:1109), the shard_map of _sharded_class_scan
// (:903) with _spread_score_sharded (:863), _soft_score_sharded (:891)
// and _topo_scatter_sharded (:1081): the class route with the node axis
// split over a 1-D "nodes" mesh of D shards (kubernetes_tpu_torch/
// scheduler/sharding.py).
//
// Two designs (kernels/batch.py shard_scan_design picks one): the shared
// design (shard_scan_shared.cu, its notes), where each CTA's slice of the
// table fits in its shared memory, and the global design below (any
// batch of at most 8 shards).
//
// In the global design a shard is one CTA: the grid is ONE cluster of D CTAs
// (2 <= D <= 8, cudaLaunchAttributeClusterDimension), and CTA r owns the
// global rows [r * Nl, (r + 1) * Nl), Nl = N / D, two a thread at
// N = 8,192 and D = 8 (min(512, Nl rounded up to a warp) threads). The
// reference's collectives become exchanges through distributed shared
// memory (cooperative_groups::this_cluster, map_shared_rank) behind
// cluster barriers. Per pod, in every CTA, in the reference's order:
//   1. the row-local work over its rows, K2's arithmetic (score.cuh,
//      affinity.cuh) at GLOBAL row ids: the class row, the nominee's own
//      row recomputed by the thread that owns it (NOM), the topology
//      refusal, the soft raw score, the spread count and zone;
//   2. (SPREAD or SOFT) the CTA's partial reductions, published in its
//      shared memory: spread max count, zone presence and the [Z] zone
//      sums (integer-valued f32, exact in any order), soft min and max;
//      cluster barrier B1; every CTA folds the D partials (zone sums in
//      rank order) and so holds the reference's pmax / psum / pmin;
//   3. the CTA's tie-penalized first max over its rows, published as
//      (penalized, global row, masked score); cluster barrier B2; every
//      warp reads the D candidates and elects the same winner: the
//      largest penalized score, ties (float ==, so -0.0 ties +0.0) to the
//      lowest global row, which is the reference's pmax then pmin; the
//      chosen score is the winner's masked score as its CTA published it
//      (the reference's broadcast from the owner, never re-derived);
//   4. the owner CTA applies the winner's usage and spread columns, the
//      column refresh over the C classes and the packed results; its
//      thread 0 applies the topology and credit writes (one global copy
//      of the counters, the reference's replicated scatter, in pod and k
//      order; the winner's domain ids are read from the global tables,
//      the same ids the reference broadcasts); (TOPO or SOFT) cluster
//      barrier B3, so that no CTA reads the counters of the next pod
//      before the writes.
// The candidate slot is double-buffered by pod parity: a CTA can publish
// pod p + 1's candidate while another still reads pod p's, and it cannot
// reach pod p + 2 before every CTA has passed B2 of pod p + 1.
//
// Bound: the dependency chain, as K2's: cluster barriers per pod, 1 on
// the uniform and nominated instances (B2), 2 with spread groups (B1,
// B2) or topology counters (B2, B3), 3 with soft credits (B1, B2, B3),
// plus one to five block barriers (one more on the owner CTA), and D
// distributed-shared-memory reads per warp for the election (D per
// thread and zone for the zone sums). Each thread walks Nl / threads
// rows a pod instead of K2's N / 1024; the barriers, not the rows, set
// the time.
#include <cooperative_groups.h>

#include "shard_scan.cuh"

namespace cg = cooperative_groups;

// threads a CTA of the global design at most: at 1,024 (64 registers)
// eight instances spilled
#define KTPU_SHARD_THREADS 512

// one CTA's published values for one pod, read by every CTA of the
// cluster through distributed shared memory
struct KtpuShardSlot {
  float pen;    // tie-penalized local max
  float val;    // masked score at its row
  int row;      // its global row
  float maxc;   // spread: max feasible count
  int hz;       // spread: some feasible row has a named zone
  float mn;     // soft: min raw over feasible rows
  float mx;     // soft: max raw over feasible rows
};

__device__ __forceinline__ bool ktpu_beats(float pen, int row, float bpen,
                                           int brow) {
  return pen > bpen || (pen == bpen && row < brow);
}

template <bool SPREAD, bool TOPO, bool SOFT, bool NOM, bool PROF>
__global__ void __launch_bounds__(KTPU_SHARD_THREADS, 1)
ktpu_shard_scan_kernel(KtpuScanArgs a, int D) {
  cg::cluster_group cluster = cg::this_cluster();
  // [Z] this CTA's partial zone sums, then [Z] the reduced zone sums
  extern __shared__ float zsm[];
  float* zpart = zsm;
  float* zs = zsm + a.Z;
  __shared__ KtpuShardSlot slot[2];
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
  const KtpuStepConst kc = ktpu_step_const<SPREAD, SOFT>(a);
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  const int N = a.N, R = a.R;
  const int Nl = N / D;
  const int r0 = rank * Nl, r1 = r0 + Nl;
  const float rw0 = kc.rw0, rw1 = kc.rw1;
  const float inf = __int_as_float(0x7f800000);

  const bool stamp = PROF && rank == 0 && tid == 0;
  for (int p = 0; p < a.P; ++p) {
    if (stamp) ktpu_prof_stamp(a.prof, a.prof_every, p, 0);
    KtpuShardSlot* my = &slot[p & 1];
    const int u = a.class_idx[p];
    const float* ms_u = a.ms + (size_t)u * N;
    const uint32_t seq_term = (uint32_t)a.seq[p] * 40503u;
    // the self-exempt base of the pod's own nominated row, on the thread
    // of the owning CTA that owns the row (the only one that reads it)
    int nr = -1;
    float corr = 0.0f;
    if (NOM) {
      nr = a.nom_row[p];
      if (nr >= N) nr = -1;
      if (nr >= r0 && nr < r1 && (nr - r0) % nthreads == tid) {
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

    if (stamp) ktpu_prof_stamp(a.prof, a.prof_every, p, 1, u + (int)seq_term);

    // ---- 2. reductions over the feasible set, across the cluster
    float maxc = 0.0f, maxz = 0.0f, sw_use = 0.0f, mn = inf, mx = -inf;
    bool have_zones = false;
    bool soft_use = false;
    const float* cnt_g = nullptr;
    if (SPREAD) {
      const int g = a.spread_gidx[p];
      sw_use = __fmul_rn(kc.sw, g >= 0 ? 1.0f : 0.0f);
      cnt_g = a.spread + (size_t)(g > 0 ? g : 0) * N;
      for (int z = tid; z < a.Z; z += nthreads) zpart[z] = 0.0f;
      __syncthreads();
    }
    if (SOFT) soft_use = a.soft.base_idx[p] >= 0;
    if (SPREAD || SOFT) {
      float lmax = 0.0f, lmn = inf, lmx = -inf;
      int lhz = 0;
      for (int r = r0 + tid; r < r1; r += nthreads) {
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
          if (cf != 0.0f && z > 0 && z < a.Z) atomicAdd(&zpart[z], cf);
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
      if (tid == 0) {
        float cmax = 0.0f, cmn = inf, cmx = -inf;
        int chz = 0;
        for (int w = 0; w < nwarps; ++w) {
          cmax = fmaxf(cmax, w_maxc[w]);
          chz |= w_hz[w];
          cmn = fminf(cmn, w_mn[w]);
          cmx = fmaxf(cmx, w_mx[w]);
        }
        my->maxc = cmax;
        my->hz = chz;
        my->mn = cmn;
        my->mx = cmx;
      }
      if (stamp) ktpu_prof_stamp(a.prof, a.prof_every, p, 2);
      cluster.sync();  // B1: every CTA's partials are published
      // every warp folds the D partials (max, or, min: any order)
      float gmax = 0.0f, gmn = inf, gmx = -inf;
      int ghz = 0;
      if (lane < D) {
        const KtpuShardSlot* o = cluster.map_shared_rank(my, lane);
        gmax = o->maxc;
        ghz = o->hz;
        gmn = o->mn;
        gmx = o->mx;
      }
      for (int o = 16; o > 0; o >>= 1) {
        gmax = fmaxf(gmax, __shfl_xor_sync(0xffffffffu, gmax, o));
        ghz |= __shfl_xor_sync(0xffffffffu, ghz, o);
        gmn = fminf(gmn, __shfl_xor_sync(0xffffffffu, gmn, o));
        gmx = fmaxf(gmx, __shfl_xor_sync(0xffffffffu, gmx, o));
      }
      maxc = gmax;
      have_zones = ghz != 0;
      mn = gmn;
      mx = gmx;
      if (SPREAD) {
        // zinit plus the shards' partial sums in rank order
        for (int z = tid; z < a.Z; z += nthreads) {
          float s = 0.0f;
          for (int q = 0; q < D; ++q)
            s = __fadd_rn(s, cluster.map_shared_rank(zpart, q)[z]);
          zs[z] = __fadd_rn(a.zinit[z], s);
        }
        __syncthreads();
        for (int z = 1; z < a.Z; ++z) maxz = fmaxf(maxz, zs[z]);
      }
    }
    // (a step without the reductions spans two equal stamps)
    if (stamp && !(SPREAD || SOFT))
      ktpu_prof_stamp(a.prof, a.prof_every, p, 2);
    if (stamp) ktpu_prof_stamp(a.prof, a.prof_every, p, 3, __float_as_int(maxz));

    // ---- 3. the CTA's tie-penalized first max, then the election
    float bpen = -inf, bval = KTPU_NEG;
    int brow = 0x7fffffff;
    for (int r = r0 + tid; r < r1; r += nthreads) {
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
      if (ktpu_beats(open, orow, bpen, brow)) {
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
    if (tid == 0) {
      float cpen = w_pen[0], cval = w_val[0];
      int crow = w_row[0];
      for (int w = 1; w < nwarps; ++w) {
        if (ktpu_beats(w_pen[w], w_row[w], cpen, crow)) {
          cpen = w_pen[w];
          crow = w_row[w];
          cval = w_val[w];
        }
      }
      my->pen = cpen;
      my->row = crow;
      my->val = cval;
    }
    if (stamp) ktpu_prof_stamp(a.prof, a.prof_every, p, 4);
    cluster.sync();  // B2: every CTA's candidate is published
    float epen = -inf, eval = KTPU_NEG;
    int erow = 0x7fffffff;
    if (lane < D) {
      const KtpuShardSlot* o = cluster.map_shared_rank(my, lane);
      epen = o->pen;
      erow = o->row;
      eval = o->val;
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float open = __shfl_xor_sync(0xffffffffu, epen, o);
      const int orow = __shfl_xor_sync(0xffffffffu, erow, o);
      const float oval = __shfl_xor_sync(0xffffffffu, eval, o);
      if (ktpu_beats(open, orow, epen, erow)) {
        epen = open;
        erow = orow;
        eval = oval;
      }
    }
    const int best = erow;
    const float chosen = eval;
    const bool ok = chosen > KTPU_NEG_THRESHOLD && a.active[p];
    const float okf = ok ? 1.0f : 0.0f;
    if (stamp) ktpu_prof_stamp(a.prof, a.prof_every, p, 5, best + (ok ? 1 : 0));

    // ---- 4. the owner's writes (a CTA-uniform branch)
    if (best >= r0 && best < r1) {
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
      // every CTA read the counters before B2: one thread applies the
      // winner's writes, in pod and k order
      if (tid == 0) {
        if (TOPO) ktpu_topo_scatter(a.topo, p, best, N, ok);
        if (SOFT) ktpu_soft_write(a.soft, p, best, N, ok);
      }
      __syncthreads();
      for (int c = tid; c < a.cl.C; c += nthreads)
        a.ms[(size_t)c * N + best] = NOM
            ? ktpu_class_score(a.cfg, a.cl, rw0, rw1, c, best, N, R, s_eff,
                               a.nz_used[2 * best],
                               a.nz_used[2 * best + 1], s_cnt)
            : ktpu_class_score(a.cfg, a.cl, rw0, rw1, c, best, N, R,
                               a.used + (size_t)best * R,
                               a.nz_used[2 * best], a.nz_used[2 * best + 1],
                               a.pod_count[best]);
      if (tid == 0) {
        a.packed[p] = ok ? best : -1;
        a.packed[a.P + p] = __float_as_int(chosen);
      }
    }
    if (stamp) ktpu_prof_stamp(a.prof, a.prof_every, p, 6);
    if (TOPO || SOFT)
      cluster.sync();  // B3: the counter writes before the next pod reads
    else
      __syncthreads();  // the owner's column before its next reads
    if (stamp) ktpu_prof_stamp(a.prof, a.prof_every, p, 7);
  }
  // no CTA leaves while another may still read its shared memory
  cluster.sync();
}

template <bool SPREAD, bool TOPO, bool SOFT, bool NOM, bool PROF = false>
static cudaError_t ktpu_launch_shard(const KtpuScanArgs& a, int D,
                                     int threads, size_t smem,
                                     cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(D, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = D;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, ktpu_shard_scan_kernel<SPREAD, TOPO, SOFT, NOM, PROF>, a, D);
}

template <bool NOM>
static cudaError_t ktpu_launch_shard_terms(int terms, const KtpuScanArgs& a,
                                           int D, int threads, size_t smem,
                                           cudaStream_t s) {
  switch (terms) {
    case 0: return ktpu_launch_shard<false, false, false, NOM>(a, D, threads, smem, s);
    case 1: return ktpu_launch_shard<false, false, true, NOM>(a, D, threads, smem, s);
    case 2: return ktpu_launch_shard<false, true, false, NOM>(a, D, threads, smem, s);
    case 3: return ktpu_launch_shard<false, true, true, NOM>(a, D, threads, smem, s);
    case 4: return ktpu_launch_shard<true, false, false, NOM>(a, D, threads, smem, s);
    case 5: return ktpu_launch_shard<true, false, true, NOM>(a, D, threads, smem, s);
    case 6: return ktpu_launch_shard<true, true, false, NOM>(a, D, threads, smem, s);
    default: return ktpu_launch_shard<true, true, true, NOM>(a, D, threads, smem, s);
  }
}

// the global design (any batch of 2 to 8 shards that divide the rows);
// the profiling instances exist for the uniform and spread batches only
extern "C" int ktpu_shard_scan(const KtpuShardParams* h, void* stream) {
  const KtpuScanParams* sp = &h->scan;
  const int D = h->D;
  if (sp->has_nom && sp->R > KTPU_MAX_R) return (int)cudaErrorInvalidValue;
  if (D < 2 || D > KTPU_MAX_SHARDS || sp->N % D != 0)
    return (int)cudaErrorInvalidValue;
  const KtpuScanArgs a = ktpu_scan_args(sp);
  const int Nl = sp->N / D;
  int threads = (Nl + 31) / 32 * 32;
  if (threads > KTPU_SHARD_THREADS) threads = KTPU_SHARD_THREADS;
  const size_t smem = 2 * (size_t)a.Z * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  const int terms = ktpu_scan_terms(sp);
  cudaError_t err;
  if (sp->prof != nullptr) {
    if (!ktpu_scan_prof_ok(sp)) return (int)cudaErrorInvalidValue;
    err = terms == 4
        ? ktpu_launch_shard<true, false, false, false, true>(a, D, threads,
                                                             smem, s)
        : ktpu_launch_shard<false, false, false, false, true>(a, D, threads,
                                                              smem, s);
  } else {
    err = sp->has_nom
        ? ktpu_launch_shard_terms<true>(terms, a, D, threads, smem, s)
        : ktpu_launch_shard_terms<false>(terms, a, D, threads, smem, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
