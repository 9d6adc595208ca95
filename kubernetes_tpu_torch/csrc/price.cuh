// Shared device helpers of the victim-pricing kernels: the blocked prefix
// sum and the chunked sum over the unit axis in the reference's order (a
// thread's running sums, and a warp's in-order prefix and sum over its
// lanes), the block-wide minimum, and pickOneNodeForPreemption's
// narrowing as one lexicographic fold (a warp's, a block's, a cluster's).
// Included by price_nodes.cu (K6) and price_domains.cu (K11).
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
#include <stdint.h>

#include "cluster_xchg.cuh"

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

// ------------------------------------------------ the reference's order
// inside a warp

// The sequential inclusive prefix of x over each aligned group of 16
// lanes (one prefix block, or one level-k group of 16 items): lane k of
// a group ends with x_0 + x_1 + ... + x_k, added left to right. Every
// lane of the warp calls it.
__device__ __forceinline__ float ktpu_seg16_prefix(float x) {
  const int k = threadIdx.x & 15;
  float p = x;
#pragma unroll
  for (int s = 1; s < KTPU_PREFIX_BLOCK; ++s) {
    const float prev = __shfl_up_sync(0xffffffffu, p, 1, KTPU_PREFIX_BLOCK);
    if (k == s) p = __fadd_rn(prev, x);
  }
  return p;
}

// The sequential sum of lanes 0 .. n-1's x (1 <= n <= 32), added left to
// right: one chunk of KTPU_SUM_CHUNK items. Every lane ends with it.
__device__ __forceinline__ float ktpu_warp_seqsum(float x, int n) {
  float s = __shfl_sync(0xffffffffu, x, 0);
#pragma unroll
  for (int k = 1; k < KTPU_SUM_CHUNK; ++k) {
    const float y = __shfl_sync(0xffffffffu, x, k);
    if (k < n) s = __fadd_rn(s, y);
  }
  return s;
}

// ------------------------------------------ the lexicographic winner
//
// pickOneNodeForPreemption's narrowing (_lexi_winner) as ONE fold of
// (nviol, topv, psumv, cntv, -startv, row) over the feasible rows: the
// minimum of that order is the row the reference's five narrowing passes
// keep. psumv compares as floats (+0.0 and -0.0 tie and go on to cntv).
// The hazard is NaN: the reference's masked min returns NaN when a row
// still tied on (nviol, topv) has a NaN psumv, no row then equals it, and
// the winner is -1. So each candidate carries a flag, "a row with the
// same (nviol, topv) had a NaN psumv"; two candidates tied on that pair
// OR their flags, and a final candidate with the flag set gives -1. Among
// the rows of the least pair the order is total when none is NaN, so the
// fold's order does not change its result.

// a feasible row's place in the order, or none (row INT_MAX); nan: a row
// of the same (nviol, topv) had a NaN psumv
struct KtpuLexi {
  int nviol, topv;
  float psum;
  int cnt, nstart, row, nan;
};

__device__ __forceinline__ KtpuLexi ktpu_lexi_none() {
  return KtpuLexi{INT_MAX, INT_MAX, 0.0f, 0, 0, INT_MAX, 0};
}

// the lesser of two candidates in the order, the NaN flags of a tied
// (nviol, topv) merged
__device__ __forceinline__ KtpuLexi ktpu_lexi_min(const KtpuLexi& a,
                                                  const KtpuLexi& b) {
  if (b.row == INT_MAX) return a;
  if (a.row == INT_MAX) return b;
  if (a.nviol != b.nviol) return a.nviol < b.nviol ? a : b;
  if (a.topv != b.topv) return a.topv < b.topv ? a : b;
  bool take_a;
  if (a.psum < b.psum)
    take_a = true;
  else if (b.psum < a.psum)
    take_a = false;
  else if (a.cnt != b.cnt)
    take_a = a.cnt < b.cnt;
  else if (a.nstart != b.nstart)
    take_a = a.nstart < b.nstart;
  else
    take_a = a.row < b.row;
  KtpuLexi c = take_a ? a : b;
  c.nan = a.nan | b.nan;
  return c;
}

// the warp's fold; every lane ends with it
__device__ __forceinline__ KtpuLexi ktpu_lexi_warp(KtpuLexi c) {
  for (int o = 16; o > 0; o >>= 1) {
    KtpuLexi d;
    d.nviol = __shfl_xor_sync(0xffffffffu, c.nviol, o);
    d.topv = __shfl_xor_sync(0xffffffffu, c.topv, o);
    d.psum = __shfl_xor_sync(0xffffffffu, c.psum, o);
    d.cnt = __shfl_xor_sync(0xffffffffu, c.cnt, o);
    d.nstart = __shfl_xor_sync(0xffffffffu, c.nstart, o);
    d.row = __shfl_xor_sync(0xffffffffu, c.row, o);
    d.nan = __shfl_xor_sync(0xffffffffu, c.nan, o);
    c = ktpu_lexi_min(c, d);
  }
  return c;
}

// the block's fold in warp 0 (every lane of it ends with it); sh holds a
// candidate a warp
__device__ __forceinline__ KtpuLexi ktpu_lexi_block(KtpuLexi c,
                                                    KtpuLexi* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  c = ktpu_lexi_warp(c);
  if (lane == 0) sh[warp] = c;
  __syncthreads();
  if (warp == 0) {
    c = lane < (int)(blockDim.x >> 5) ? sh[lane] : ktpu_lexi_none();
    c = ktpu_lexi_warp(c);
  }
  return c;
}

__device__ __forceinline__ int ktpu_lexi_winner_row(const KtpuLexi& c) {
  return (c.row == INT_MAX || c.nan) ? -1 : c.row;
}

// The cluster's fold, called by warp 0 of each of the cluster's nctas
// CTAs with its CTA's candidate once every CTA's mbarrier `bar` is
// initialised (ktpu_xchg_init, then a cluster barrier): the candidate
// goes into slot `rank` of every CTA by st.async (two 16-byte halves,
// counted on the receiver's mbarrier), then each CTA folds the nctas it
// received. Every lane of warp 0 of every CTA ends with the cluster's
// winner.
__device__ __forceinline__ KtpuLexi ktpu_lexi_xchg(const KtpuLexi& best,
                                                   uint4 (*slots)[2],
                                                   uint64_t* bar,
                                                   unsigned rank,
                                                   unsigned nctas) {
  const int lane = threadIdx.x & 31;
  if (lane < (int)nctas) {
    ktpu_st_async16(&slots[rank][0], bar, lane, (unsigned)best.nviol,
                    (unsigned)best.topv, __float_as_uint(best.psum),
                    (unsigned)best.cnt);
    ktpu_st_async16(&slots[rank][1], bar, lane, (unsigned)best.nstart,
                    (unsigned)best.row, (unsigned)best.nan, 0u);
  }
  if (lane == 0) ktpu_mbar_expect(bar, nctas * 2 * sizeof(uint4));
  ktpu_mbar_wait(bar, 0);
  KtpuLexi c = ktpu_lexi_none();
  if (lane < (int)nctas) {
    const uint4 x = slots[lane][0], y = slots[lane][1];
    c = KtpuLexi{(int)x.x, (int)x.y, __uint_as_float(x.z), (int)x.w,
                 (int)y.x, (int)y.y, (int)y.z};
  }
  return ktpu_lexi_warp(c);
}

// the CTA's rank in its cluster and the cluster's CTAs
__device__ __forceinline__ unsigned ktpu_cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned ktpu_cluster_size() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return n;
}
