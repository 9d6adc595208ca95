// K6: victim-prefix pricing of one preemptor over every candidate node.
//
// Replaces kubernetes_tpu/scheduler/kernels/preempt.py price_nodes (a
// jax.jit program), with _prefix_costs and _lexi_winner inside it. Each
// candidate row holds the node's free resources and its would-be victim
// units in eviction order; per row the kernel finds the first unit prefix
// after whose eviction the preemptor fits (resources and pod slots), marks
// the chosen units, and prices the prefix (PDB violations, top victim
// priority, priority sum, victims charged, latest start among the
// top-priority victims). The winner is pickOneNodeForPreemption's
// narrowing: the rows at the least nviol, among them the least topv,
// psumv, cntv, -startv in turn, then the lowest row.
//
// The narrowing is price.cuh's ONE lexicographic fold of (nviol, topv,
// psumv, cntv, -startv, row) over the feasible rows, inside a warp, then
// across the CTA (and the cluster), with its NaN flag: the fold K11
// shares.
//
// Two instances, picked by the table's sizes:
//   - narrow (V <= 1,024 units, R <= 16 resources, every path the repo
//     drives today): one cluster of 16 CTAs, CTA q the rows [q * Nc, (q +
//     1) * Nc), Nc = ceil(N / 16), one row a thread at N = 8,192 (up to
//     512 threads); each thread keeps the R + 1 running sums in
//     registers, three prefix levels and two sum levels (price.cuh), then
//     the fold: a warp's by shuffles, the CTA's in warp 0, and one
//     st.async exchange of the CTAs' candidates (cluster_xchg.cuh) that
//     every CTA folds; CTA 0 writes the winner. A split cluster barrier
//     (arrive before the rows, wait after) makes the exchange's mbarrier
//     visible while the rows are priced.
//   - wide (up to KTPU_PRICE_MAX_V = 2^24 units and KTPU_PRICE_MAX_R =
//     64 resources; bench.py's 1,200-pod make_wide_node buckets to 2,048
//     units): one block of 1024 threads; each warp owns rows warp, warp +
//     32, ...; lane l keeps the running sums of lanes l, l + 32 and l +
//     64 of the R + 1 at the depth of 2^24 units (six prefix levels,
//     five sum levels), the warp votes on the fit of each unit, and lane
//     0 prices the row. Then the same fold over the block's warps.
// Each running sum adds in the reference's order (__fadd_rn, built with
// -fmad=false), as the plain version does (kernels/preempt.py
// PREFIX_BLOCK, SUM_CHUNK): the prefix sums of the freed resources and pod
// slots through price.cuh's KtpuBlockedPrefix, the priority sum through
// KtpuChunkedSum.
//
// Bound: launch latency at the storm's sizes (N = 8,192 rows, V = 4
// units, R = 2); the bytes (the [N, V, R] table read once) take under a
// microsecond at the card's memory rate. A wide row of V units is one
// warp's sequential walk, then lane 0's.
#include "price.cuh"
#include "cluster_xchg.cuh"

#define KTPU_PRICE_THREADS 1024
// the narrow instance's cluster: CTAs and threads a CTA at most
#define KTPU_PRICE_CLUSTER 16
#define KTPU_PRICE_CTHREADS 512
// kubernetes_tpu_torch/scheduler/kernels/preempt.py MAX_R and MAX_U
#define KTPU_PRICE_MAX_R 64
#define KTPU_PRICE_MAX_V (1 << 24)
// the narrow rows: resources and units they cover, their prefix lanes
// (R resources, then the pod slots) and levels (16^3 >= 1,024 units; two
// sum levels: 32^2)
#define KTPU_PRICE_NARROW_R 16
#define KTPU_PRICE_NARROW_V 1024
#define KTPU_PRICE_LANES (KTPU_PRICE_NARROW_R + 1)
// the wide rows: lanes a thread keeps (32 * 3 >= 64 + 1) and the levels
// of 2^24 units (16^6 = 2^24, 32^5 >= 2^24)
#define KTPU_PRICE_WIDE_LANES 3
#define KTPU_PRICE_WIDE_PREFIX_LEVELS 6
#define KTPU_PRICE_WIDE_SUM_LEVELS 5

struct KtpuPriceArgs {
  const float* free0;     // [N, R]
  const float* cfree0;    // [N]
  const float* need;      // [R]
  const float* need_cnt;  // scalar
  const float* freed;     // [N, V, R]
  const float* fcnt;      // [N, V]
  const bool* valid;      // [N, V]
  const bool* pdb;        // [N, V]
  const int* top;         // [N, V]
  const float* psum;      // [N, V]
  const int* gcnt;        // [N, V]
  const int* startr;      // [N, V]
  const bool* row_valid;  // [N]
  int* winner;            // scalar
  bool* chosen;           // [N, V]
  int* k;                 // [N]
  int* nviol;             // [N]
  int N, V, R;
};

// Row i's chosen units (the first fitting prefix kidx, -1 when none) and
// k and nviol into the outputs; returns its cost vector
template <int SUM_LEVELS>
__device__ __forceinline__ KtpuLexi ktpu_price_row(const KtpuPriceArgs& a,
                                                   int i, int kidx,
                                                   bool fit0) {
  const int V = a.V;
  // a node the preemptor already fits is not a preemption candidate
  const bool feas = kidx >= 0 && !fit0 && a.row_valid[i];
  const int kk = kidx >= 0 ? kidx : 0;
  int nv = 0, tv = INT_MIN, cv = 0, sv = -1;
  KtpuChunkedSum<SUM_LEVELS> ps;
  for (int v = 0; v < V; ++v) {
    const size_t iv = (size_t)i * V + v;
    const bool ch = feas && v <= kk && a.valid[iv];
    a.chosen[iv] = ch;
    nv += (ch && a.pdb[iv]) ? 1 : 0;
    if (ch) tv = max(tv, a.top[iv]);
    // every v, chosen or not (an unchosen unit adds 0.0), in order
    ps.add(ch ? a.psum[iv] : 0.0f, v, V);
    cv += ch ? a.gcnt[iv] : 0;
  }
  for (int v = 0; v < V; ++v) {
    const size_t iv = (size_t)i * V + v;
    if (feas && v <= kk && a.valid[iv] && a.top[iv] == tv)
      sv = max(sv, a.startr[iv]);
  }
  a.k[i] = kk + 1;
  a.nviol[i] = nv;
  if (!feas) return ktpu_lexi_none();
  const float psum = ps.total(V);
  // sv >= -1: -sv does not overflow
  return KtpuLexi{nv, tv, psum, cv, -sv, i, isnan(psum) ? 1 : 0};
}

// a narrow row (V <= 1,024, R <= 16) on one thread: its first fitting
// prefix, then its costs
__device__ __forceinline__ KtpuLexi ktpu_price_narrow(const KtpuPriceArgs& a,
                                                      int i,
                                                      float need_cnt) {
  const int V = a.V, R = a.R;
  const int L = R + 1;
  const float* f0 = a.free0 + (size_t)i * R;
  const float cf0 = a.cfree0[i];
  bool fit0 = cf0 >= need_cnt;
  for (int r = 0; r < R; ++r) fit0 = fit0 && f0[r] >= a.need[r];
  KtpuBlockedPrefix<KTPU_PRICE_LANES, 3> pre;
  int kidx = -1;
  for (int v = 0; v < V; ++v) {
    const float* fr = a.freed + ((size_t)i * V + v) * R;
    bool fit = true;
    for (int l = 0; l < L; ++l) {
      const float x = l < R ? fr[l] : a.fcnt[(size_t)i * V + v];
      const float cum = pre.add(l, x, v);
      fit = fit && (l < R ? __fadd_rn(f0[l], cum) >= a.need[l]
                          : __fadd_rn(cf0, cum) >= need_cnt);
    }
    if (fit && a.valid[(size_t)i * V + v]) {  // the FIRST fitting unit
      kidx = v;
      break;
    }
    pre.end_unit(v, L);
  }
  return ktpu_price_row<2>(a, i, kidx, fit0);
}

// ------------------------------------------------------- the wide walk

__global__ void __launch_bounds__(KTPU_PRICE_THREADS, 1)
ktpu_price_wide_kernel(KtpuPriceArgs a) {
  __shared__ KtpuLexi sh[32];
  // a warp's running candidate on its lane 0 (none on the others), kept
  // in shared memory: the rows' prefix state holds the registers
  __shared__ KtpuLexi s_run[KTPU_PRICE_THREADS];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int nthreads = blockDim.x;
  const int N = a.N, V = a.V, R = a.R;
  const float need_cnt = a.need_cnt[0];
  s_run[tid] = ktpu_lexi_none();
  for (int i = tid >> 5; i < N; i += nthreads >> 5) {
    const float* f0 = a.free0 + (size_t)i * R;
    const float cf0 = a.cfree0[i];
    KtpuBlockedPrefix<KTPU_PRICE_WIDE_LANES, KTPU_PRICE_WIDE_PREFIX_LEVELS>
        pre;
    int kidx = -1;
    for (int v = 0; v < V; ++v) {
      const size_t iv = (size_t)i * V + v;
      const float* fr = a.freed + iv * R;
      bool fit = true;
      // lane j of this thread is lane l = lane + 32 j of the row; one
      // past the pod slots it adds zeros that nothing reads
      for (int j = 0; j < KTPU_PRICE_WIDE_LANES; ++j) {
        const int l = lane + 32 * j;
        const float x = l < R ? fr[l] : l == R ? a.fcnt[iv] : 0.0f;
        const float cum = pre.add(j, x, v);
        if (l < R)
          fit = fit && __fadd_rn(f0[l], cum) >= a.need[l];
        else if (l == R)
          fit = fit && __fadd_rn(cf0, cum) >= need_cnt;
      }
      if (__all_sync(0xffffffffu, fit) && a.valid[iv]) {
        kidx = v;  // the warp agrees: the FIRST fitting unit
        break;
      }
      pre.end_unit(v, KTPU_PRICE_WIDE_LANES);
    }
    if (lane == 0) {
      bool fit0 = cf0 >= need_cnt;
      for (int r = 0; r < R; ++r) fit0 = fit0 && f0[r] >= a.need[r];
      s_run[tid] = ktpu_lexi_min(
          s_run[tid], ktpu_price_row<KTPU_PRICE_WIDE_SUM_LEVELS>(
                          a, i, kidx, fit0));
    }
  }
  const KtpuLexi best = ktpu_lexi_block(s_run[tid], sh);
  if (tid == 0) a.winner[0] = ktpu_lexi_winner_row(best);
}

// ------------------------------------------------ the narrow cluster

__global__ void __launch_bounds__(KTPU_PRICE_CTHREADS, 1)
ktpu_price_cluster_kernel(KtpuPriceArgs a, int Nc) {
  __shared__ KtpuLexi sh[32];
  __shared__ __align__(8) uint64_t bar;
  // CTA q's candidate in two 16-byte halves
  __shared__ __align__(16) uint4 slots[KTPU_PRICE_CLUSTER][2];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int nthreads = blockDim.x;
  const unsigned rank = ktpu_cluster_rank();
  if (tid == 0) ktpu_xchg_init(&bar, 1);
  // the mbarrier's init reaches the cluster while the rows are priced
  ktpu_cluster_arrive();
  const float need_cnt = a.need_cnt[0];
  const int r0 = (int)rank * Nc;
  const int r1 = min(a.N, r0 + Nc);
  KtpuLexi best = ktpu_lexi_none();
  for (int i = r0 + tid; i < r1; i += nthreads)
    best = ktpu_lexi_min(best, ktpu_price_narrow(a, i, need_cnt));
  best = ktpu_lexi_block(best, sh);
  ktpu_cluster_wait();
  if (tid >= 32) return;
  // warp 0: the CTA's candidate into every CTA, then the cluster's fold
  const KtpuLexi c = ktpu_lexi_xchg(best, slots, &bar, rank,
                                    KTPU_PRICE_CLUSTER);
  if (rank == 0 && lane == 0) a.winner[0] = ktpu_lexi_winner_row(c);
}

// The host's call: the cluster at the narrow sizes, the wide walk past
// them
extern "C" int ktpu_price_nodes(
    const float* free0, const float* cfree0, const float* need,
    const float* need_cnt, const float* freed, const float* fcnt,
    const bool* valid, const bool* pdb, const int* top, const float* psum,
    const int* gcnt, const int* startr, const bool* row_valid, int* winner,
    bool* chosen, int* k, int* nviol, int N, int V, int R, void* stream) {
  const bool narrow = V <= KTPU_PRICE_NARROW_V && R <= KTPU_PRICE_NARROW_R;
  if (N < 1 || V < 1 || V > KTPU_PRICE_MAX_V || R < 0 ||
      R > KTPU_PRICE_MAX_R)
    return (int)cudaErrorInvalidValue;
  KtpuPriceArgs a{free0, cfree0, need, need_cnt, freed, fcnt, valid, pdb,
                  top, psum, gcnt, startr, row_valid, winner, chosen, k,
                  nviol, N, V, R};
  cudaStream_t s = (cudaStream_t)stream;
  if (narrow) {
    const int Nc = (N + KTPU_PRICE_CLUSTER - 1) / KTPU_PRICE_CLUSTER;
    int threads = (Nc + 31) / 32 * 32;
    if (threads > KTPU_PRICE_CTHREADS) threads = KTPU_PRICE_CTHREADS;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(KTPU_PRICE_CLUSTER, 1, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = KTPU_PRICE_CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    // a 16-CTA cluster is past the portable size: allowed once
    static bool allowed = false;
    if (!allowed) {
      const cudaError_t err = cudaFuncSetAttribute(
          ktpu_price_cluster_kernel,
          cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return (int)err;
      allowed = true;
    }
    const cudaError_t err =
        cudaLaunchKernelEx(&cfg, ktpu_price_cluster_kernel, a, Nc);
    if (err != cudaSuccess) return (int)err;
  } else {
    ktpu_price_wide_kernel<<<1, KTPU_PRICE_THREADS, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}
