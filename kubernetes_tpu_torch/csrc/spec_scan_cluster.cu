// K12's cluster design: the speculative cohort scan (spec_scan.cu has the
// kernel's notes, the reference it replaces and its block design) over
// one thread-block cluster of 16 CTAs (a non-portable size), each holding
// the state of N / 16 rows in shared memory for the whole launch, as
// K15's shared design does with one shard (shard_step.cuh: the slice of
// the [C, N] table, the class constants, the rows' usage and, where they
// fit, their spread counts); a source of its own so that the two designs'
// instances compile in parallel.
//
// Per cohort of W <= 32 pods, in every CTA:
//   0. the pods' scalars staged; the fence f (one ballot), the first
//      active member that reads carried terms;
//   1. (f > 0) the election of the members [0, f): warp w takes members
//      w, w + nwarps, ... and their tie-penalized first max over the
//      CTA's rows of the slice; one st.async exchange (cluster_xchg.cuh)
//      gives every CTA every member's 16 candidates, which every CTA
//      folds with the comparator K7, K9 and K15 use (the largest
//      penalized score, float == so that -0.0 ties +0.0, then the lowest
//      global row): the same winners everywhere;
//   2. (f > 0) the CTA that owns a winner's row (a warp a winner) takes
//      its post-write row from its slice and computes the type-2 check of
//      every later member before the fence against it: the member's class
//      column after the write, tie-penalized with the member's seq, >=
//      the member's frozen maximum (score.cuh's class score, K2's refresh
//      arithmetic); a second exchange publishes each winner's bit mask
//      and, from every CTA, a record that it has read the candidates;
//      every CTA then runs the same type-1 and type-2 checks (warp 0,
//      a lane a member, the winners by shuffle) and reaches the same first
//      collider (f when none). Warp w elects member w and owns its winner
//      where its CTA does (the winner is then its own candidate), so it
//      loads that row's node values (allocatable, flags, the classes'
//      masks and static scores) while the candidates are exchanged;
//   3. a clean cohort: each owner warp writes its winner's usage, spread
//      counts and C columns into its slice; CTA 0's thread 0 applies the
//      topology and credit writes in pod order, and (TOPO or SOFT) a
//      cluster barrier publishes them before any CTA's next row pass; a
//      dirty one replays every member through shard_step.cuh's step with
//      one shard of 16 CTAs, K15's shared design, from the state the
//      cohort found (the election and the checks write nothing);
//   4. packed [2, P] and stats [P / W, 2] from CTA 0.
// The exchange arrays and their mbarriers are single-buffered. Every CTA
// sends into both exchanges of a cohort with f > 0: its candidates into
// the election's, and, once its fold has read them, one record of its own
// (beside the masks of the winners it owns) into the checks'. So a CTA
// that has passed the checks' wait knows that every other CTA has read
// its copy of `elect` and seen its election phase complete: only then
// does it store the next cohort's candidates there (stores that arrive
// before their CTA arms the phase count towards it, as mbarrier tx-counts
// allow, never towards the phase before). Likewise a CTA stores the next
// checks only after the next election's wait, which every CTA joins
// after its warp 0 has read the last checks. A repair's steps are
// exchanges of their own, and each CTA starts a cohort with a block
// barrier, so no warp of it still reads the last cohort's arrays when it
// publishes the next.
//
// Bound: the dependency chain. A clean cohort costs one row pass of the
// slice a member (512 rows a CTA at N = 8,192), two exchanges, the
// owners' check columns and W column refreshes; a dirty one the members
// before the fence and W of K15's steps.
#include "spec_scan.cuh"
#include "shard_step.cuh"

// cohort widths the design takes (one ballot, a lane a member)
#define KTPU_SPC_W 32
// dynamic shared memory a CTA may take, beside the static exchange state
#define KTPU_SPC_SMEM_LIMIT (160 * 1024)

// the cohort's exchange state: election and checks mbarriers, every
// CTA's candidate of every member, each winner's check mask, and every
// CTA's record that it has read the candidates (never read: its bytes
// complete the checks' phase)
struct __align__(16) KtpuSpecXchg {
  uint64_t mbar[2];
  KtpuCand elect[KTPU_SSH_CLUSTER][KTPU_SPC_W];
  uint4 chk[KTPU_SPC_W];
  uint4 seen[KTPU_SSH_CLUSTER];
};

// a winner row's node values its owner warp reads: lane j's allocatable
// and reservations of columns j and j + 32, the row's reserved pods, max
// pods and flags, and class c = lane's mask and static score there
struct KtpuRowVals {
  float alloc[2], nom[2];
  float nomc, maxp, stat;
  bool mp, ok, mask;
};

template <bool NOM>
__device__ __forceinline__ KtpuRowVals ktpu_row_vals(const KtpuScanArgs& a,
                                                     const int* cmi,
                                                     const int* csi, int b,
                                                     int lane) {
  const int N = a.N, R = a.R;
  KtpuRowVals v;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h;
    v.alloc[h] = j < R ? a.cfg.alloc[(size_t)b * R + j] : 0.0f;
    v.nom[h] = NOM && j < R ? a.nom_used[(size_t)b * R + j] : 0.0f;
  }
  v.nomc = NOM ? a.nom_count[b] : 0.0f;
  v.maxp = a.cfg.max_pods[b];
  v.mp = a.cfg.mem_pressure[b];
  v.ok = a.cfg.node_ok[b] && a.cfg.valid[b];
  v.mask = lane < a.C && a.cl.unique_masks[(size_t)cmi[lane] * N + b];
  v.stat = lane < a.C ? a.cl.unique_scores[(size_t)csi[lane] * N + b]
                      : 0.0f;
  return v;
}

template <bool SPREAD, bool TOPO, bool SOFT, bool NOM, bool PROF>
__global__ void __launch_bounds__(KTPU_SSH_THREADS, 1)
ktpu_spec_cluster_kernel(KtpuScanArgs a, const bool* spec_plain,
                         int* stats, int W, int Nc, int hold) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float ssm[];
  const int N = a.N, R = a.R, C = a.C, P = a.P, G = a.G;
  __shared__ KtpuShardXchg xs;
  __shared__ KtpuSpecXchg ks;
  __shared__ KtpuPodIn s_pod[KTPU_SPC_W];
  __shared__ float s_m0[SPREAD ? KTPU_SPC_W : 1];
  __shared__ float s_vbest[KTPU_SPC_W], s_chosen[KTPU_SPC_W];
  __shared__ int s_best[KTPU_SPC_W], s_ok[KTPU_SPC_W];
  __shared__ int s_f, s_first;
  // an owner warp's winner row after the write (+ reservations with NOM)
  // and its allocatable
  __shared__ float s_wuse[KTPU_XCHG_WARPS][KTPU_MAX_R];
  __shared__ float s_walw[KTPU_XCHG_WARPS][KTPU_MAX_R];
  const int nctas = KTPU_SSH_CLUSTER;
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const float inf = __int_as_float(0x7f800000);
  KtpuShardCtx<SPREAD> x;
  ktpu_shard_load<SPREAD, SOFT>(a, x, xs, ssm, 0, rank, N, Nc, rank, nctas,
                                hold);
  if (tid == 0) ktpu_xchg_init(ks.mbar, 2);
  const int r0 = x.r0, nloc = x.nloc;
  const float rw0 = x.kc.rw0, rw1 = x.kc.rw1;
  const bool stamp = PROF && rank == 0 && tid == 0;
  unsigned kph = 0u;   // bit 0: the election's next parity, bit 1 checks'
  // every CTA runs, its state loaded and its mbarriers ready, before any
  // reaches another's shared memory
  ktpu_cluster_sync();

  for (int c0 = 0; c0 < P; c0 += W) {
    const int step = c0 / W;
    if (stamp) ktpu_prof_stamp(a.prof, a.prof_every, step, 0);
    // ---- 0. the cohort's scalars and the fence
    if (tid < W) {
      const int p = c0 + tid;
      KtpuPodIn s;
      s.u = a.class_idx[p];
      s.seq_term = (uint32_t)a.seq[p] * 40503u;
      s.active = a.active[p];
      s.gidx = SPREAD ? a.spread_gidx[p] : -1;
      s.nom_row = NOM ? a.nom_row[p] : -1;
      s.soft_base = SOFT ? a.soft.base_idx[p] : -1;
      s_pod[tid] = s;
      if constexpr (SPREAD)
        s_m0[tid] = G > 0 ? a.spread_match[(size_t)p * G] : 0.0f;
    }
    if (warp == 0) {
      const bool fenced =
          lane < W && !spec_plain[c0 + lane] && a.active[c0 + lane];
      const unsigned bal = __ballot_sync(0xffffffffu, fenced);
      if (lane == 0) {
        s_f = bal != 0u ? __ffs(bal) - 1 : W;
        s_first = s_f;
      }
    }
    __syncthreads();
    const int f = s_f;
    if (stamp) ktpu_prof_stamp(a.prof, a.prof_every, step, 1, f);

    // the row values of warp w's candidate for member w, loaded while the
    // cluster's candidates arrive: where the CTA owns member w's winner it
    // is that candidate, and warp w runs the winner's checks and update
    // (the spread instances repair nearly every cohort: they load later)
    constexpr bool PRE = !SPREAD;
    int pre_row = -1;
    KtpuRowVals pv;
    if (f > 0) {
      // ---- 1. the members' candidates over this CTA's rows, to every CTA
      for (int m = warp; m < f; m += nwarps) {
        const float* ms_u = x.ms + (size_t)s_pod[m].u * Nc;
        const uint32_t seq_term = s_pod[m].seq_term;
        float bpen = -inf, bval = KTPU_NEG;
        int brow = 0x7fffffff, baux = 0;
        for (int i = lane; i < nloc; i += 32) {
          const float base = ms_u[i];
          const float masked = base > KTPU_NEG_THRESHOLD ? base : KTPU_NEG;
          const float pen = ktpu_tie_penalized(masked, r0 + i, seq_term);
          if (pen > bpen) {  // rows ascend: strict > keeps the first max
            bpen = pen;
            brow = r0 + i;
            bval = masked;
          }
        }
        ktpu_warp_argmax(bpen, brow, bval, baux);
        if (lane < nctas)
          ktpu_st_async16(&ks.elect[rank][m], &ks.mbar[0], lane,
                          __float_as_uint(bpen), __float_as_uint(bval),
                          (unsigned)brow, 0u);
        if (PRE && m == warp && brow < N) {
          pre_row = brow;
          pv = ktpu_row_vals<NOM>(a, x.cmi, x.csi, brow, lane);
        }
      }
      if (tid == 0)
        ktpu_mbar_expect(&ks.mbar[0],
                         (unsigned)(f * nctas * sizeof(KtpuCand)));
      ktpu_xchg_wait(&ks.mbar[0], 0, kph);
      // every CTA's fold of each member's 16 candidates
      for (int m = warp; m < f; m += nwarps) {
        KtpuCand c{-inf, KTPU_NEG, 0x7fffffff, 0};
        if (lane < nctas) c = ks.elect[lane][m];
        ktpu_warp_argmax(c.pen, c.row, c.val, c.aux);
        if (lane == 0) {
          s_vbest[m] = c.pen;
          s_best[m] = c.row;
          s_chosen[m] = c.val;
          s_ok[m] = c.val > KTPU_NEG_THRESHOLD && s_pod[m].active;
        }
      }
      __syncthreads();
      if (stamp) ktpu_prof_stamp(a.prof, a.prof_every, step, 2);

      // ---- 2. this CTA's fold has read the candidates: its record to
      // every CTA; then the owners' type-2 checks, a warp a winner, lane
      // i the member i; each winner's mask to every CTA
      if (warp == 0 && lane < nctas)
        ktpu_st_async16(&ks.seen[rank], &ks.mbar[1], lane, 0u, 0u, 0u, 0u);
      for (int j = warp; j < f; j += nwarps) {
        const int b = s_best[j];
        const int ib = b - r0;
        if (ib < 0 || ib >= nloc) continue;   // another CTA's row
        unsigned mask = 0u;
        if (s_ok[j] && j + 1 < f) {
          const KtpuRowVals rv =
              (PRE && j == warp && pre_row == b)
                  ? pv : ktpu_row_vals<NOM>(a, x.cmi, x.csi, b, lane);
          const int uj = s_pod[j].u;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = lane + 32 * h;
            if (r < R) {
              const float v = __fadd_rn(x.used[(size_t)r * Nc + ib],
                                        __fmul_rn(1.0f, x.creq[uj * R + r]));
              s_wuse[warp][r] = NOM ? __fadd_rn(v, rv.nom[h]) : v;
              s_walw[warp][r] = rv.alloc[h];
            }
          }
          const float nz0 =
              __fadd_rn(x.nz[ib], __fmul_rn(1.0f, x.cnz[2 * uj]));
          const float nz1 =
              __fadd_rn(x.nz[Nc + ib], __fmul_rn(1.0f, x.cnz[2 * uj + 1]));
          const float cnt = __fadd_rn(x.cnt[ib], 1.0f);
          const float cnt_eff = NOM ? __fadd_rn(cnt, rv.nomc) : cnt;
          const int i = lane;
          const bool later = i > j && i < f && s_ok[i];
          const int ui = i < f ? s_pod[i].u : 0;
          // member i's class mask and static score at the row: from lane
          // ui where every class has a lane
          bool mk;
          float stv;
          if (C <= 32) {
            mk = __shfl_sync(0xffffffffu, rv.mask, ui & 31);
            stv = __shfl_sync(0xffffffffu, rv.stat, ui & 31);
          } else {
            mk = later && a.cl.unique_masks[(size_t)x.cmi[ui] * N + b];
            stv = later ? a.cl.unique_scores[(size_t)x.csi[ui] * N + b]
                        : 0.0f;
          }
          __syncwarp();
          bool t2 = false;
          if (later) {
            const float col = ktpu_class_score_at(
                x.creq + (size_t)ui * R, x.cnz[2 * ui], x.cnz[2 * ui + 1],
                x.cblk[ui], s_walw[warp], s_wuse[warp], nz0, nz1, cnt_eff,
                rv.maxp, rv.mp, rv.ok, mk, stv, rw0, rw1, R);
            t2 = ktpu_tie_penalized(col, b, s_pod[i].seq_term) >=
                 s_vbest[i];
          }
          mask = __ballot_sync(0xffffffffu, t2);
          __syncwarp();   // the row is read before the warp's next winner
        }
        if (lane < nctas)
          ktpu_st_async16(&ks.chk[j], &ks.mbar[1], lane, mask, 0u, 0u, 0u);
      }
      if (tid == 0)
        ktpu_mbar_expect(&ks.mbar[1], (unsigned)((f + nctas) * 16));
      ktpu_xchg_wait(&ks.mbar[1], 1, kph);
      // type 1 and type 2 of member i on lane i of warp 0
      if (warp == 0) {
        // lane j holds winner j; every lane i reads them by shuffle
        const int i = lane;
        const int bi = i < f ? s_best[i] : -1;
        const bool oki = i < f && s_ok[i] != 0;
        const unsigned mi = i < f ? ks.chk[i].x : 0u;
        bool hit = false;
        for (int j = 0; j < f; ++j) {
          const int bj = __shfl_sync(0xffffffffu, bi, j);
          const bool okj = __shfl_sync(0xffffffffu, oki, j);
          const unsigned mj = __shfl_sync(0xffffffffu, mi, j);
          hit = hit || (j < i && okj && (bj == bi || ((mj >> i) & 1u)));
        }
        hit = hit && oki;
        const unsigned bal = __ballot_sync(0xffffffffu, hit);
        if (lane == 0 && bal != 0u) s_first = __ffs(bal) - 1;
      }
      __syncthreads();
    } else if (stamp) {
      ktpu_prof_stamp(a.prof, a.prof_every, step, 2);
    }
    const int first = s_first;
    if (stamp) ktpu_prof_stamp(a.prof, a.prof_every, step, 3, first);

    if (first >= W) {
      // ---- 3a. the clean cohort: each owner warp writes its winner's
      // usage, spread counts and column into its slice (distinct rows)
      for (int j = warp; j < W; j += nwarps) {
        const int b = s_best[j];
        const int ib = b - r0;
        if (!s_ok[j] || ib < 0 || ib >= nloc) continue;
        const KtpuRowVals rv =
            (PRE && j == warp && pre_row == b)
                ? pv : ktpu_row_vals<NOM>(a, x.cmi, x.csi, b, lane);
        const int uj = s_pod[j].u;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = lane + 32 * h;
          if (r < R) {
            float* y = x.used + (size_t)r * Nc + ib;
            const float v =
                __fadd_rn(*y, __fmul_rn(1.0f, x.creq[uj * R + r]));
            *y = v;
            s_wuse[warp][r] = NOM ? __fadd_rn(v, rv.nom[h]) : v;
            s_walw[warp][r] = rv.alloc[h];
          }
        }
        const float nz0 = __fadd_rn(x.nz[ib], __fmul_rn(1.0f, x.cnz[2 * uj]));
        const float nz1 =
            __fadd_rn(x.nz[Nc + ib], __fmul_rn(1.0f, x.cnz[2 * uj + 1]));
        const float cnt = __fadd_rn(x.cnt[ib], 1.0f);
        for (int g = lane; SPREAD && g < G; g += 32) {
          float* y = x.cnt_base + (size_t)g * x.cnt_stride + ib;
          *y = __fadd_rn(*y, __fmul_rn(
              g == 0 ? s_m0[j] : a.spread_match[(size_t)(c0 + j) * G + g],
              1.0f));
        }
        __syncwarp();
        if (lane == 0) {
          x.nz[ib] = nz0;
          x.nz[Nc + ib] = nz1;
          x.cnt[ib] = cnt;
        }
        const float cnt_eff = NOM ? __fadd_rn(cnt, rv.nomc) : cnt;
        // the column, a class a lane a pass (the first pass's mask and
        // static score in rv)
        for (int c = lane; c < C; c += 32) {
          const bool mk = c < 32 ? rv.mask
              : a.cl.unique_masks[(size_t)x.cmi[c] * N + b];
          const float stv = c < 32 ? rv.stat
              : a.cl.unique_scores[(size_t)x.csi[c] * N + b];
          x.ms[(size_t)c * Nc + ib] = ktpu_class_score_at(
              x.creq + (size_t)c * R, x.cnz[2 * c], x.cnz[2 * c + 1],
              x.cblk[c], s_walw[warp], s_wuse[warp], nz0, nz1, cnt_eff,
              rv.maxp, rv.mp, rv.ok, mk, stv, rw0, rw1, R);
        }
        __syncwarp();   // the row is read before the warp's next winner
      }
      if (rank == 0) {
        if ((TOPO || SOFT) && tid == 0) {
          for (int m = 0; m < W; ++m) {
            if (TOPO) ktpu_topo_scatter(a.topo, c0 + m, s_best[m], N, s_ok[m]);
            if (SOFT) ktpu_soft_write(a.soft, c0 + m, s_best[m], N, s_ok[m]);
          }
        }
        if (tid < W) {
          a.packed[c0 + tid] = s_ok[tid] ? s_best[tid] : -1;
          a.packed[P + c0 + tid] = __float_as_int(s_chosen[tid]);
        }
      }
      // the counter writes before any CTA reads them again
      if (TOPO || SOFT) ktpu_cluster_sync();
    } else {
      // ---- 3b. repair: the whole cohort through K15's step, one shard
      for (int m = 0; m < W; ++m)
        ktpu_shard_pod_step<SPREAD, TOPO, SOFT, NOM, false>(
            a, x, xs, c0 + m, s_pod[m], SPREAD ? s_m0[m] : 0.0f,
            KtpuNoOverlap());
    }
    if (rank == 0 && tid == 0) {
      stats[2 * step] = first >= W ? 1 : 0;
      stats[2 * step + 1] = first;
    }
    if (stamp) ktpu_prof_stamp(a.prof, a.prof_every, step, 4);
    // the cohort's scalars and winners are read before the next cohort's
    __syncthreads();
  }

  ktpu_shard_store<SPREAD>(a, x);
  // no CTA leaves while another may still write its shared memory
  ktpu_cluster_sync();
}

// ---------------------------------------------------------- launchers

template <bool SPREAD, bool TOPO, bool SOFT, bool NOM, bool PROF = false>
static cudaError_t ktpu_launch_spec_cluster(const KtpuScanArgs& a,
                                            const KtpuSpecParams* h, int Nc,
                                            int hold, int threads,
                                            size_t smem,
                                            cudaStream_t stream) {
  auto kern = ktpu_spec_cluster_kernel<SPREAD, TOPO, SOFT, NOM, PROF>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(KTPU_SSH_CLUSTER, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = KTPU_SSH_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, a, h->spec_plain, h->stats, h->W,
                            Nc, hold);
}

template <bool NOM>
static cudaError_t ktpu_launch_spec_cluster_terms(
    int terms, const KtpuScanArgs& a, const KtpuSpecParams* h, int Nc,
    int hold, int threads, size_t smem, cudaStream_t s) {
  switch (terms) {
    case 0: return ktpu_launch_spec_cluster<false, false, false, NOM>(a, h, Nc, hold, threads, smem, s);
    case 1: return ktpu_launch_spec_cluster<false, false, true, NOM>(a, h, Nc, hold, threads, smem, s);
    case 2: return ktpu_launch_spec_cluster<false, true, false, NOM>(a, h, Nc, hold, threads, smem, s);
    case 3: return ktpu_launch_spec_cluster<false, true, true, NOM>(a, h, Nc, hold, threads, smem, s);
    case 4: return ktpu_launch_spec_cluster<true, false, false, NOM>(a, h, Nc, hold, threads, smem, s);
    case 5: return ktpu_launch_spec_cluster<true, false, true, NOM>(a, h, Nc, hold, threads, smem, s);
    case 6: return ktpu_launch_spec_cluster<true, true, false, NOM>(a, h, Nc, hold, threads, smem, s);
    default: return ktpu_launch_spec_cluster<true, true, true, NOM>(a, h, Nc, hold, threads, smem, s);
  }
}

// the cluster design (kernels/batch.py spec_scan_design picks it where a
// CTA's slice fits); it refuses a batch it does not take
extern "C" int ktpu_spec_scan_cluster(const KtpuSpecParams* h,
                                      void* stream) {
  const KtpuScanParams* sp = &h->scan;
  const bool spread = sp->has_spread != 0;
  const KtpuScanArgs a = ktpu_scan_args(sp);
  const int W = h->W;
  if (W < 1 || W > KTPU_SPC_W || a.P % W != 0 || a.N < 1 || a.C < 1 ||
      a.R < 2 || a.R > KTPU_MAX_R ||
      (spread && (a.Z < 1 || a.Z > KTPU_XCHG_ZONES)))
    return (int)cudaErrorInvalidValue;
  const int Nc = (a.N + KTPU_SSH_CLUSTER - 1) / KTPU_SSH_CLUSTER;
  int threads = (Nc + 31) / 32 * 32;
  if (threads > KTPU_SSH_THREADS) threads = KTPU_SSH_THREADS;
  const size_t limit = KTPU_SPC_SMEM_LIMIT / sizeof(float);
  if (Nc > threads * KTPU_SSH_RPT ||
      ktpu_shard_smem_words(a.C, Nc, a.R, a.G, false) > limit)
    return (int)cudaErrorInvalidValue;
  const int hold = spread &&
                   ktpu_shard_smem_words(a.C, Nc, a.R, a.G, true) <= limit;
  const size_t smem =
      ktpu_shard_smem_words(a.C, Nc, a.R, a.G, hold) * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  const int terms = ktpu_scan_terms(sp);
  cudaError_t err;
  if (sp->prof != nullptr) {
    if (!ktpu_scan_prof_ok(sp)) return (int)cudaErrorInvalidValue;
    err = terms == 4
        ? ktpu_launch_spec_cluster<true, false, false, false, true>(
              a, h, Nc, hold, threads, smem, s)
        : ktpu_launch_spec_cluster<false, false, false, false, true>(
              a, h, Nc, hold, threads, smem, s);
  } else {
    err = sp->has_nom
        ? ktpu_launch_spec_cluster_terms<true>(terms, a, h, Nc, hold,
                                               threads, smem, s)
        : ktpu_launch_spec_cluster_terms<false>(terms, a, h, Nc, hold,
                                                threads, smem, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
