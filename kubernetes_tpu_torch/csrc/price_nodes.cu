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
// One block of 1024 threads; each thread owns rows tid, tid + 1024, ...
// Pass 1 walks a row's units in order and adds in the reference's order
// (__fadd_rn, built with -fmad=false), as the plain version does
// (kernels/preempt.py PREFIX_BLOCK, SUM_CHUNK): the prefix sums of the
// freed resources and pod slots add sequentially inside blocks of 16
// units, and each later block starts from the blocks' own inclusive
// prefix, taken the same way one level up (three levels cover 1,024
// units); the priority sum adds sequentially inside chunks of 32 units,
// then the chunk totals in order. The per-row costs go to a scratch
// buffer; each narrowing pass re-reads a thread's own rows and ends in one
// block reduction.
//
// Bound: launch latency and the six block barriers at the storm's sizes
// (N = 8,192 rows, V = 4 units, R = 2); the bytes (the [N, V, R] table
// read once) take under a microsecond at the card's memory rate.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define KTPU_PRICE_THREADS 1024
// kubernetes_tpu_torch/scheduler/kernels/preempt.py MAX_R, MAX_V,
// PREFIX_BLOCK and SUM_CHUNK
#define KTPU_PRICE_MAX_R 16
#define KTPU_PRICE_MAX_V 1024
#define KTPU_PREFIX_BLOCK 16
#define KTPU_SUM_CHUNK 32
// the prefix lanes: R resources, then the pod slots
#define KTPU_PRICE_LANES (KTPU_PRICE_MAX_R + 1)

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

__device__ __forceinline__ int ktpu_block_min_int(int v, int* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  int r = sh[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r = min(r, sh[w]);
  __syncthreads();  // sh is reused by the next reduction
  return r;
}

__device__ __forceinline__ float ktpu_block_min_float(float v, float* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  float r = sh[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r = fminf(r, sh[w]);
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(KTPU_PRICE_THREADS, 1)
ktpu_price_nodes_kernel(KtpuPriceArgs a) {
  __shared__ int sh_i[32];
  __shared__ float sh_f[32];
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int N = a.N, V = a.V, R = a.R;
  const float need_cnt = a.need_cnt[0];
  const float inf = __int_as_float(0x7f800000);
  int* topv_s = a.iscratch;
  int* cntv_s = a.iscratch + N;
  int* nstart_s = a.iscratch + 2 * N;
  int* mask_s = a.iscratch + 3 * N;

  // ---- pass 1: each row's first fitting prefix and its cost vector
  const int L = R + 1;
  for (int i = tid; i < N; i += nthreads) {
    const float* f0 = a.free0 + (size_t)i * R;
    const float cf0 = a.cfree0[i];
    bool fit0 = cf0 >= need_cnt;
    for (int r = 0; r < R; ++r) fit0 = fit0 && f0[r] >= a.need[r];
    // in-block sums at three levels, and the carried-in prefix of the
    // current level-0 and level-1 blocks (none for the first block)
    float in0[KTPU_PRICE_LANES], in1[KTPU_PRICE_LANES];
    float in2[KTPU_PRICE_LANES], base0[KTPU_PRICE_LANES];
    float base1[KTPU_PRICE_LANES];
    bool has0 = false, has1 = false;
    int kidx = -1;
    for (int v = 0; v < V; ++v) {
      const float* fr = a.freed + ((size_t)i * V + v) * R;
      const int j0 = v % KTPU_PREFIX_BLOCK;
      bool fit = true;
      for (int l = 0; l < L; ++l) {
        const float x = l < R ? fr[l] : a.fcnt[(size_t)i * V + v];
        in0[l] = j0 == 0 ? x : __fadd_rn(in0[l], x);
        const float cum = has0 ? __fadd_rn(base0[l], in0[l]) : in0[l];
        fit = fit && (l < R ? __fadd_rn(f0[l], cum) >= a.need[l]
                            : __fadd_rn(cf0, cum) >= need_cnt);
      }
      if (fit && a.valid[(size_t)i * V + v]) {  // the FIRST fitting unit
        kidx = v;
        break;
      }
      if (j0 == KTPU_PREFIX_BLOCK - 1) {
        // a level-0 block is complete: its total is the next level-1
        // item, whose inclusive prefix the next block starts from
        const int k1 = v / KTPU_PREFIX_BLOCK;
        const int j1 = k1 % KTPU_PREFIX_BLOCK;
        for (int l = 0; l < L; ++l) {
          in1[l] = j1 == 0 ? in0[l] : __fadd_rn(in1[l], in0[l]);
          base0[l] = has1 ? __fadd_rn(base1[l], in1[l]) : in1[l];
        }
        has0 = true;
        if (j1 == KTPU_PREFIX_BLOCK - 1) {
          // a level-1 block is complete; level 2 holds at most
          // KTPU_PRICE_MAX_V / 256 items, one block
          const int j2 = k1 / KTPU_PREFIX_BLOCK;
          for (int l = 0; l < L; ++l) {
            in2[l] = j2 == 0 ? in1[l] : __fadd_rn(in2[l], in1[l]);
            base1[l] = in2[l];
          }
          has1 = true;
        }
      }
    }
    // a node the preemptor already fits is not a preemption candidate
    const bool feas = kidx >= 0 && !fit0 && a.row_valid[i];
    const int kk = kidx >= 0 ? kidx : 0;
    int nv = 0, tv = INT_MIN, cv = 0, sv = -1;
    float ps = 0.0f, part = 0.0f;
    for (int v = 0; v < V; ++v) {
      const size_t iv = (size_t)i * V + v;
      const bool ch = feas && v <= kk && a.valid[iv];
      a.chosen[iv] = ch;
      nv += (ch && a.pdb[iv]) ? 1 : 0;
      if (ch) tv = max(tv, a.top[iv]);
      // every v, chosen or not (an unchosen unit adds 0.0), in order
      const float x = ch ? a.psum[iv] : 0.0f;
      const int j = v % KTPU_SUM_CHUNK;
      part = j == 0 ? x : __fadd_rn(part, x);
      if (j == KTPU_SUM_CHUNK - 1 || v == V - 1)
        ps = v < KTPU_SUM_CHUNK ? part : __fadd_rn(ps, part);
      cv += ch ? a.gcnt[iv] : 0;
    }
    for (int v = 0; v < V; ++v) {
      const size_t iv = (size_t)i * V + v;
      if (feas && v <= kk && a.valid[iv] && a.top[iv] == tv)
        sv = max(sv, a.startr[iv]);
    }
    a.k[i] = kk + 1;
    a.nviol[i] = nv;
    topv_s[i] = tv;
    a.fscratch[i] = ps;
    cntv_s[i] = cv;
    nstart_s[i] = -sv;  // sv >= -1: no overflow
    mask_s[i] = feas ? 1 : 0;
  }

  // ---- lexicographic narrowing: each criterion minimised over the rows
  // still tied, INT_MAX / +inf where masked. A thread reads back only the
  // rows it wrote, so pass 1 needs no barrier of its own.
  for (int crit = 0; crit < 5; ++crit) {
    const int* vals = crit == 0 ? a.nviol
                    : crit == 1 ? topv_s
                    : crit == 3 ? cntv_s
                    : nstart_s;
    if (crit == 2) {
      float lmin = inf;
      for (int i = tid; i < N; i += nthreads)
        if (mask_s[i]) lmin = fminf(lmin, a.fscratch[i]);
      const float best = ktpu_block_min_float(lmin, sh_f);
      for (int i = tid; i < N; i += nthreads)
        if (mask_s[i] && !(a.fscratch[i] == best)) mask_s[i] = 0;
    } else {
      int lmin = INT_MAX;
      for (int i = tid; i < N; i += nthreads)
        if (mask_s[i]) lmin = min(lmin, vals[i]);
      const int best = ktpu_block_min_int(lmin, sh_i);
      for (int i = tid; i < N; i += nthreads)
        if (mask_s[i] && vals[i] != best) mask_s[i] = 0;
    }
  }
  // ---- the first remaining row, or -1
  int first = INT_MAX;
  for (int i = tid; i < N; i += nthreads)
    if (mask_s[i]) {
      first = i;
      break;
    }
  first = ktpu_block_min_int(first, sh_i);
  if (tid == 0) a.winner[0] = first == INT_MAX ? -1 : first;
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
  ktpu_price_nodes_kernel<<<1, KTPU_PRICE_THREADS, 0,
                            (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
