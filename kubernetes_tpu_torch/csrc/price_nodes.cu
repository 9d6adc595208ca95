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
// narrowing: five block-wide minimisations (nviol, topv, psumv, cntv,
// -startv), each over the rows still tied, then the lowest remaining row.
//
// One block of 1024 threads, in one of two instances the host picks:
//   - narrow (V <= 1,024 units, R <= 16 resources, every path the repo
//     drives today): each thread owns rows tid, tid + 1024, ... and keeps
//     the R + 1 running sums in registers, three prefix levels and two
//     sum levels (price.cuh);
//   - wide (up to KTPU_PRICE_MAX_V = 2^24 units and KTPU_PRICE_MAX_R = 64
//     resources; bench.py's 1,200-pod make_wide_node buckets to 2,048
//     units): each warp owns rows warp, warp + 32, ...; lane l keeps the
//     running sums of lanes l, l + 32 and l + 64 of the R + 1 at K11's
//     depth (six prefix levels, five sum levels), and the warp votes on
//     the fit of each unit. Lane 0 then prices the row as a narrow thread
//     does.
// Each running sum adds in the reference's order (__fadd_rn, built with
// -fmad=false), as the plain version does (kernels/preempt.py
// PREFIX_BLOCK, SUM_CHUNK): the prefix sums of the freed resources and pod
// slots through price.cuh's KtpuBlockedPrefix, the priority sum through
// KtpuChunkedSum. The per-row costs go to a scratch buffer; each narrowing
// pass of price.cuh's ktpu_lexi_winner re-reads them and ends in one block
// reduction.
//
// Bound: launch latency and the six block barriers at the storm's sizes
// (N = 8,192 rows, V = 4 units, R = 2); the bytes (the [N, V, R] table
// read once) take under a microsecond at the card's memory rate. A wide
// row of V units is one warp's sequential walk, then lane 0's.
#include "price.cuh"

#define KTPU_PRICE_THREADS 1024
// kubernetes_tpu_torch/scheduler/kernels/preempt.py MAX_R and MAX_U
#define KTPU_PRICE_MAX_R 64
#define KTPU_PRICE_MAX_V (1 << 24)
// the narrow instance: resources and units it covers, its prefix lanes
// (R resources, then the pod slots) and levels (16^3 >= 1,024 units; two
// sum levels: 32^2)
#define KTPU_PRICE_NARROW_R 16
#define KTPU_PRICE_NARROW_V 1024
#define KTPU_PRICE_LANES (KTPU_PRICE_NARROW_R + 1)
// the wide instance: lanes a thread keeps (32 * 3 >= 64 + 1) and K11's
// levels (price_domains.cu: 16^6 = 2^24 units, 32^5 >= 2^24)
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
  int* iscratch;          // [4, N]: topv, cntv, -startv, narrowing mask
  float* fscratch;        // [N]: psumv
  int N, V, R;
};

// Row i's chosen units (the first fitting prefix kidx, -1 when none) and
// their cost vector, into the outputs and the scratch rows
template <int SUM_LEVELS>
__device__ __forceinline__ void ktpu_price_row(const KtpuPriceArgs& a, int i,
                                               int kidx, bool fit0) {
  const int N = a.N, V = a.V;
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
  a.iscratch[i] = tv;
  a.fscratch[i] = ps.total(V);
  a.iscratch[N + i] = cv;
  a.iscratch[2 * N + i] = -sv;  // sv >= -1: no overflow
  a.iscratch[3 * N + i] = feas ? 1 : 0;
}

template <bool WIDE>
__global__ void __launch_bounds__(KTPU_PRICE_THREADS, 1)
ktpu_price_nodes_kernel(KtpuPriceArgs a) {
  __shared__ int sh_i[32];
  __shared__ float sh_f[32];
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int N = a.N, V = a.V, R = a.R;
  const float need_cnt = a.need_cnt[0];

  // ---- pass 1: each row's first fitting prefix and its cost vector
  const int L = R + 1;
  if (!WIDE) {
    for (int i = tid; i < N; i += nthreads) {
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
      ktpu_price_row<2>(a, i, kidx, fit0);
    }
  } else {
    const int lane = tid & 31;
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
        ktpu_price_row<KTPU_PRICE_WIDE_SUM_LEVELS>(a, i, kidx, fit0);
      }
    }
    // a row's costs were written by lane 0 of its warp; the narrowing
    // reads row i on thread i % 1024
    __syncthreads();
  }

  // ---- lexicographic narrowing, then the first remaining row or -1
  const int first = ktpu_lexi_winner(a.nviol, a.iscratch, a.fscratch,
                                     a.iscratch + N, a.iscratch + 2 * N,
                                     a.iscratch + 3 * N, N, sh_i, sh_f);
  if (tid == 0) a.winner[0] = first;
}

extern "C" int ktpu_price_nodes(
    const float* free0, const float* cfree0, const float* need,
    const float* need_cnt, const float* freed, const float* fcnt,
    const bool* valid, const bool* pdb, const int* top, const float* psum,
    const int* gcnt, const int* startr, const bool* row_valid, int* winner,
    bool* chosen, int* k, int* nviol, int* iscratch, float* fscratch,
    int N, int V, int R, void* stream) {
  if (N < 1 || V < 1 || V > KTPU_PRICE_MAX_V || R < 0 ||
      R > KTPU_PRICE_MAX_R)
    return (int)cudaErrorInvalidValue;
  KtpuPriceArgs a{free0, cfree0, need, need_cnt, freed, fcnt, valid, pdb,
                  top, psum, gcnt, startr, row_valid, winner, chosen, k,
                  nviol, iscratch, fscratch, N, V, R};
  cudaStream_t s = (cudaStream_t)stream;
  if (V <= KTPU_PRICE_NARROW_V && R <= KTPU_PRICE_NARROW_R)
    ktpu_price_nodes_kernel<false><<<1, KTPU_PRICE_THREADS, 0, s>>>(a);
  else
    ktpu_price_nodes_kernel<true><<<1, KTPU_PRICE_THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}
