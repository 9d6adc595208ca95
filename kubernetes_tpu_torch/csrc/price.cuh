// Shared device helpers of the victim-pricing kernels: the blocked prefix
// sum and the chunked sum over the unit axis in the reference's order,
// the block-wide minimisations, and the lexicographic narrowing to a
// winner row. Included by price_nodes.cu (K6, which narrows its rows in
// one fold of its own) and price_domains.cu (K11, the narrowing below).
//
// Replaces the reductions of kubernetes_tpu/scheduler/kernels/preempt.py
// _prefix_costs (:347) and _lexi_winner (:331), and the jnp.cumsum of
// price_nodes (:364) / price_domains (:588). The f32 sums follow the
// order XLA on the CPU gives them at any unit count (kernels/preempt.py
// PREFIX_BLOCK, SUM_CHUNK): the prefix adds sequentially inside blocks of
// 16 units and each later block starts from the blocks' own inclusive
// prefix, taken the same way one level up, as many levels as the count
// needs; the sum adds sequentially inside chunks of 32 units, then sums
// the chunk totals the same way one level up. Each kernel instantiates
// the helpers with the levels its largest unit count needs. Every add is
// __fadd_rn (the libraries build with -fmad=false).
#pragma once

#include <cuda_runtime.h>
#include <limits.h>

// kubernetes_tpu_torch/scheduler/kernels/preempt.py PREFIX_BLOCK and
// SUM_CHUNK
#define KTPU_PREFIX_BLOCK 16
#define KTPU_SUM_CHUNK 32

// The blocked inclusive prefix of LANES running sums over the unit axis,
// LEVELS levels deep: it covers KTPU_PREFIX_BLOCK^LEVELS units. At unit v
// call add(l, x, v) for each lane (it returns the lane's prefix through
// v), then end_unit(v, L) once.
template <int LANES, int LEVELS>
struct KtpuBlockedPrefix {
  // in[k]: the running sum inside the open level-k block; base[k]: the
  // inclusive prefix (one level up) of the level-k blocks completed so
  // far, which the open level-k block starts from once has[k] is set
  float in[LEVELS][LANES], base[LEVELS - 1][LANES];
  bool has[LEVELS - 1] = {};

  __device__ __forceinline__ float add(int l, float x, int v) {
    in[0][l] = v % KTPU_PREFIX_BLOCK == 0 ? x : __fadd_rn(in[0][l], x);
    return has[0] ? __fadd_rn(base[0][l], in[0][l]) : in[0][l];
  }

  __device__ __forceinline__ void end_unit(int v, int L) {
    if (v % KTPU_PREFIX_BLOCK != KTPU_PREFIX_BLOCK - 1) return;
    // a level-(k-1) block is complete: its total is item j of level k,
    // whose inclusive prefix the next level-(k-1) block starts from
    int j = v / KTPU_PREFIX_BLOCK;
#pragma unroll
    for (int k = 1; k < LEVELS; ++k) {
      const bool up = k + 1 < LEVELS && has[k < LEVELS - 1 ? k : 0];
      for (int l = 0; l < L; ++l) {
        in[k][l] = j % KTPU_PREFIX_BLOCK == 0
                       ? in[k - 1][l]
                       : __fadd_rn(in[k][l], in[k - 1][l]);
        base[k - 1][l] =
            up ? __fadd_rn(base[k < LEVELS - 1 ? k : 0][l], in[k][l])
               : in[k][l];
      }
      has[k - 1] = true;
      if (j % KTPU_PREFIX_BLOCK != KTPU_PREFIX_BLOCK - 1) return;
      j /= KTPU_PREFIX_BLOCK;
    }
  }
};

// The chunked sum over V units, LEVELS levels deep: it covers
// KTPU_SUM_CHUNK^LEVELS units. Call add(x, v, V) for every v in order (an
// unchosen unit adds its 0.0 too); total(V) is the sum after v = V - 1.
template <int LEVELS>
struct KtpuChunkedSum {
  // part[k]: the running sum inside the open level-k chunk
  float part[LEVELS];

  __device__ __forceinline__ void add(float x, int v, int V) {
    int j = v, n = V;  // item j of the n items of level k
#pragma unroll
    for (int k = 0; k < LEVELS; ++k) {
      part[k] = j % KTPU_SUM_CHUNK == 0 ? x : __fadd_rn(part[k], x);
      // the top level (one chunk) adds its items in order; below it, a
      // complete (or the last) chunk's total is the next level's item
      if (n <= KTPU_SUM_CHUNK ||
          (j % KTPU_SUM_CHUNK != KTPU_SUM_CHUNK - 1 && j != n - 1))
        return;
      x = part[k];
      j /= KTPU_SUM_CHUNK;
      n = (n + KTPU_SUM_CHUNK - 1) / KTPU_SUM_CHUNK;
    }
  }

  __device__ __forceinline__ float total(int V) const {
    float t = part[0];
    int n = V;
#pragma unroll
    for (int k = 1; k < LEVELS; ++k) {
      if (n <= KTPU_SUM_CHUNK) break;
      n = (n + KTPU_SUM_CHUNK - 1) / KTPU_SUM_CHUNK;
      t = part[k];
    }
    return t;
  }
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

// pickOneNodeForPreemption's narrowing over n rows (_lexi_winner): the
// feasible mask `mask` (1 / 0 per row, narrowed in place) is minimised by
// nviol, topv, psumv, cntv and nstart (-startv) in turn, INT_MAX / +inf
// where masked, then the first remaining row, or -1. Every thread of the
// block calls it; a thread reads back only the rows i = tid, tid + nthreads,
// ... that it wrote itself, so the costs need no barrier of their own.
__device__ __forceinline__ int ktpu_lexi_winner(
    const int* nviol, const int* topv, const float* psumv, const int* cntv,
    const int* nstart, int* mask, int n, int* sh_i, float* sh_f) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const float inf = __int_as_float(0x7f800000);
  for (int crit = 0; crit < 5; ++crit) {
    const int* vals = crit == 0 ? nviol
                    : crit == 1 ? topv
                    : crit == 3 ? cntv
                    : nstart;
    if (crit == 2) {
      float lmin = inf;
      for (int i = tid; i < n; i += nthreads)
        if (mask[i]) lmin = fminf(lmin, psumv[i]);
      const float best = ktpu_block_min_float(lmin, sh_f);
      for (int i = tid; i < n; i += nthreads)
        if (mask[i] && !(psumv[i] == best)) mask[i] = 0;
    } else {
      int lmin = INT_MAX;
      for (int i = tid; i < n; i += nthreads)
        if (mask[i]) lmin = min(lmin, vals[i]);
      const int best = ktpu_block_min_int(lmin, sh_i);
      for (int i = tid; i < n; i += nthreads)
        if (mask[i] && vals[i] != best) mask[i] = 0;
    }
  }
  int first = INT_MAX;
  for (int i = tid; i < n; i += nthreads)
    if (mask[i]) {
      first = i;
      break;
    }
  first = ktpu_block_min_int(first, sh_i);
  return first == INT_MAX ? -1 : first;
}
