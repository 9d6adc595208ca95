// K15's shared design: the sharded class scan (shard_scan.cu has the
// kernel's notes, the reference it replaces and its global design) with
// each CTA's slice of the [C, N] table, the class constants and its rows'
// usage in shared memory, and the reference's collectives as st.async
// exchanges (cluster_xchg.cuh) in place of cluster barriers; a source of
// its own so that the two designs' instances compile in parallel. The
// per-pod step below lives in shard_step.cuh, which K12's cluster design
// (spec_scan_cluster.cu) runs for its repairs.
//
// One cluster of k * D CTAs, k = floor(16 / D) (16 at D = 2, 4 and 8, 15
// at D = 3; a non-portable size): shard s spans the contiguous CTAs
// [s * k, (s + 1) * k) and its rows [s * N / D, (s + 1) * N / D), CTA j
// of the shard the rows [j * Nc, (j + 1) * Nc) of the shard's, Nc =
// ceil(N / D / k), so a shard's pad rows stay inside the shard. Up to 512
// threads a CTA and 4 rows a thread. Each CTA holds, in shared memory for
// the whole launch: its [C, Nc] slice of the table, the class constants
// (req [C, R], nz [C, 2], mask and score rows, blocked), its rows' used
// [R, Nc], nz_used [2, Nc] and pod_count [Nc], and with spread groups its
// [G, Nc] slice of the counts where it fits; the table, the usage and the
// counts go back at the end. The pods' scalars are staged 64 at a time.
// Per pod, in every CTA, in the reference's order (K2's arithmetic,
// class_step.cuh and score.cuh, at GLOBAL row ids):
//   1. the row-local work: the class row of the slice, the nominee's own
//      row recomputed by the thread that owns it (NOM), the topology
//      refusal, the soft raw score, the spread count and zone;
//   2. (SPREAD or SOFT) one exchange of the CTAs' partials (the max count,
//      zone presence, the [Z] zone sums (integer-valued, exact in any
//      order), soft min and max), in place of the global design's cluster
//      barrier B1, its D-way distributed reads and its serial fold;
//   3. the tie-penalized first max over each warp's rows, one exchange of
//      the warps' candidates in place of B2 and the serial fold of 32
//      warp partials on thread 0: every warp folds the cluster's
//      candidates (the largest penalized score, ties by float == to the
//      lowest global row: the reference's pmax then pmin) and the chosen
//      score is the owner's masked value, never re-derived. Before the
//      wait each warp loads its own candidate row's allocatable, counts,
//      flags and (lane c) class c's mask and static score there;
//   4. the warp that owns the winner row (its candidate won) applies the
//      usage and spread columns in shared memory, refreshes its C columns
//      of the slice, a class a lane a pass (score.cuh's
//      ktpu_class_score_at, with the reservations under NOM), and its
//      lane 0 the topology and credit writes in k order; it is the only
//      reader of that row and column before the next update, so no block
//      barrier follows. (TOPO or SOFT) cluster barrier B3 publishes the
//      counter writes before any CTA's next row pass.
//
// Bound: the dependency chain from one pod to the next. A pod's chain:
// the row pass (one row a thread at N = 8,192 and D = 8), a warp's shuffle
// fold, the distributed stores, the wait for the slowest warp's, the fold
// of the candidates and the owner warp's update and refresh; spread and
// soft add a block barrier and a second exchange, topology and soft B3.
#include "shard_step.cuh"

#define KTPU_SSH_CHUNK 64      // pods staged in shared memory at once
// dynamic shared memory a CTA may take
#define KTPU_SSH_SMEM_LIMIT (200 * 1024)

template <bool SPREAD, bool TOPO, bool SOFT, bool NOM, bool PROF>
__global__ void __launch_bounds__(KTPU_SSH_THREADS, 1)
ktpu_shard_shared_kernel(KtpuScanArgs a, int D, int kc, int Nc, int hold) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float ssm[];
  const int P = a.P, G = a.G;
  __shared__ KtpuShardXchg xs;
  __shared__ KtpuPodIn s_pod[2][KTPU_SSH_CHUNK];
  // each staged pod's spread_match of group 0 (the owner's update reads it)
  __shared__ float s_m0[2][SPREAD ? KTPU_SSH_CHUNK : 1];
  const int nctas = kc * D;
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int NT = blockDim.x;
  KtpuShardCtx<SPREAD> x;
  ktpu_shard_load<SPREAD, SOFT>(a, x, xs, ssm, rank / kc, rank % kc,
                                a.N / D, Nc, rank, nctas, hold);
  const bool stamp = PROF && rank == 0 && tid == 0;
  // every CTA runs, its state loaded and its mbarriers ready, before any
  // reaches another's shared memory
  ktpu_cluster_sync();

  // stage the pods of chunk q into buffer q & 1
  auto stage = [&](int q) {
    for (int i = tid; i < KTPU_SSH_CHUNK; i += NT) {
      const int p = q * KTPU_SSH_CHUNK + i;
      if (p >= P) break;
      KtpuPodIn s;
      s.u = a.class_idx[p];
      s.seq_term = (uint32_t)a.seq[p] * 40503u;
      s.active = a.active[p];
      s.gidx = SPREAD ? a.spread_gidx[p] : -1;
      s.nom_row = NOM ? a.nom_row[p] : -1;
      s.soft_base = SOFT ? a.soft.base_idx[p] : -1;
      s_pod[q & 1][i] = s;
      if constexpr (SPREAD)
        s_m0[q & 1][i] = G > 0 ? a.spread_match[(size_t)p * G] : 0.0f;
    }
  };
  // the next chunk's pods while the other CTAs arrive
  auto next_chunk = [&](int p) {
    const int pn = p + 1;
    if (pn < P && pn % KTPU_SSH_CHUNK == 0) {
      stage(pn / KTPU_SSH_CHUNK);
      __syncthreads();
    }
  };

  stage(0);
  __syncthreads();
  for (int p = 0; p < P; ++p) {
    if (stamp) ktpu_prof_stamp(a.prof, a.prof_every, p, 0);
    const KtpuPodIn s = s_pod[(p / KTPU_SSH_CHUNK) & 1][p % KTPU_SSH_CHUNK];
    float m0 = 0.0f;
    if constexpr (SPREAD)
      m0 = s_m0[(p / KTPU_SSH_CHUNK) & 1][p % KTPU_SSH_CHUNK];
    ktpu_shard_pod_step<SPREAD, TOPO, SOFT, NOM, PROF>(a, x, xs, p, s, m0,
                                                        next_chunk);
  }

  ktpu_shard_store<SPREAD>(a, x);
  // no CTA leaves while another may still write its shared memory
  ktpu_cluster_sync();
}

// ---------------------------------------------------------- launchers

template <bool SPREAD, bool TOPO, bool SOFT, bool NOM, bool PROF = false>
static cudaError_t ktpu_launch_shard_shared(const KtpuScanArgs& a, int D,
                                            int kc, int Nc, int hold,
                                            int threads, size_t smem,
                                            cudaStream_t stream) {
  auto kern = ktpu_shard_shared_kernel<SPREAD, TOPO, SOFT, NOM, PROF>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kc * D, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kc * D;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, a, D, kc, Nc, hold);
}

template <bool NOM>
static cudaError_t ktpu_launch_shard_shared_terms(
    int terms, const KtpuScanArgs& a, int D, int kc, int Nc, int hold,
    int threads, size_t smem, cudaStream_t s) {
  switch (terms) {
    case 0: return ktpu_launch_shard_shared<false, false, false, NOM>(a, D, kc, Nc, hold, threads, smem, s);
    case 1: return ktpu_launch_shard_shared<false, false, true, NOM>(a, D, kc, Nc, hold, threads, smem, s);
    case 2: return ktpu_launch_shard_shared<false, true, false, NOM>(a, D, kc, Nc, hold, threads, smem, s);
    case 3: return ktpu_launch_shard_shared<false, true, true, NOM>(a, D, kc, Nc, hold, threads, smem, s);
    case 4: return ktpu_launch_shard_shared<true, false, false, NOM>(a, D, kc, Nc, hold, threads, smem, s);
    case 5: return ktpu_launch_shard_shared<true, false, true, NOM>(a, D, kc, Nc, hold, threads, smem, s);
    case 6: return ktpu_launch_shard_shared<true, true, false, NOM>(a, D, kc, Nc, hold, threads, smem, s);
    default: return ktpu_launch_shard_shared<true, true, true, NOM>(a, D, kc, Nc, hold, threads, smem, s);
  }
}

// the shared design (kernels/batch.py shard_scan_design picks it where a
// CTA's slice fits); it refuses a batch it does not take
extern "C" int ktpu_shard_scan_shared(const KtpuShardParams* h,
                                      void* stream) {
  const KtpuScanParams* sp = &h->scan;
  const int D = h->D;
  const bool spread = sp->has_spread != 0;
  const KtpuScanArgs a = ktpu_scan_args(sp);
  if (D < 2 || D > KTPU_MAX_SHARDS || a.N < D || a.N % D != 0 ||
      a.C < 1 || a.R < 2 || a.R > KTPU_MAX_R ||
      (spread && (a.Z < 1 || a.Z > KTPU_XCHG_ZONES)))
    return (int)cudaErrorInvalidValue;
  const int kc = KTPU_SSH_CLUSTER / D;
  const int Ns = a.N / D;
  const int Nc = (Ns + kc - 1) / kc;
  int threads = (Nc + 31) / 32 * 32;
  if (threads > KTPU_SSH_THREADS) threads = KTPU_SSH_THREADS;
  const size_t limit = KTPU_SSH_SMEM_LIMIT / sizeof(float);
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
        ? ktpu_launch_shard_shared<true, false, false, false, true>(
              a, D, kc, Nc, hold, threads, smem, s)
        : ktpu_launch_shard_shared<false, false, false, false, true>(
              a, D, kc, Nc, hold, threads, smem, s);
  } else {
    err = sp->has_nom
        ? ktpu_launch_shard_shared_terms<true>(terms, a, D, kc, Nc, hold,
                                               threads, smem, s)
        : ktpu_launch_shard_shared_terms<false>(terms, a, D, kc, Nc, hold,
                                                threads, smem, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
