// K11: whole-gang pricing of one parked gang over every ICI domain.
//
// Replaces kubernetes_tpu/scheduler/kernels/preempt.py price_domains
// (:581-599, a jax.jit program), with _prefix_costs and _lexi_winner
// inside it. Each row is one topology domain: its member slots before any
// eviction (`base`) and its would-be victim units merged across the
// domain's nodes in band order, each with the member slots its eviction
// adds (`dslots`). Per row the kernel finds the first unit prefix after
// whose eviction the domain holds `need` (minMember) member slots; a
// domain that already holds them is feasible with no eviction. It marks
// the chosen units, prices the prefix (PDB violations, top victim
// priority, priority sum, victims charged, latest start among the
// top-priority victims) and narrows to the winner with price.cuh's one
// lexicographic fold, the fold K6 uses (its NaN flag keeps the
// reference's -1 when a NaN psumv ties on (nviol, topv)).
//
// Two instances, picked by the table's width; no row is walked by one
// thread in either:
//   - rows (U <= 1,024: the keyed storm's [1,024 x 32]): a warp a
//     domain row, in a cluster of 16 CTAs (CTA q the rows [q * Dc, (q +
//     1) * Dc), up to 32 warps a CTA, each looping over its rows). Lanes
//     take consecutive units, 32 a step, so the [D, U] reads and the
//     `chosen` writes are coalesced. The slot prefix keeps the
//     reference's blocked order: each half-warp's block of 16 units adds
//     in lane order (ktpu_seg16_prefix), the block totals go one level up
//     into a KtpuBlockedPrefix the warp keeps uniform; the first fitting
//     unit is the first lane of a ballot. The costs take one more sweep
//     of 32-unit chunks up to the prefix's end: nviol and cntv are
//     integer sums and topv a max (exact in any order), startv a max over
//     the units where top == topv (carried as a (top, start) pair), and
//     each chunk's priority sum adds in lane order (ktpu_warp_seqsum),
//     the chunk totals one level up in a KtpuChunkedSum: priorities near
//     2e9 are not exact in f32, so this order decides the bits. Chunks
//     past the prefix are +0.0 without a read. Each row's candidate goes
//     into the fold: shuffles, the CTA's warps, then one st.async
//     exchange of the CTAs' candidates.
//   - wide (U > 1,024: a gang with no topology key prices the whole
//     cluster as ONE row, up to KTPU_DOMAIN_MAX_U = 2^24 units): one
//     block of 1,024 threads a row, the rows in turn (no path prices
//     more than one row this wide). For the fit each
//     thread takes a block of 16 units (tiles of 16,384): the in-block
//     prefix in its registers, the block totals' prefix over half-warps,
//     the 64 group totals' in warp 0, the higher levels in warp 0's
//     KtpuBlockedPrefix, and a block-wide min of the first fitting unit.
//     For the costs each thread takes a chunk of 32 units (tiles of
//     32,768): the chunk's sum in order in its registers, a warp's 32
//     chunk totals in lane order, thread 0 the levels above; the
//     integer costs reduced across the block. `chosen` goes out 16 units
//     a thread with one 16-byte store where the row allows it. The
//     block's units are loaded twice (the fit rereads them from L1)
//     rather than held across the barriers: 64 registers a thread.
// Every running sum adds with __fadd_rn (built with -fmad=false), so the
// kernel is exact for any f32 dslots, not only integer-valued ones.
//
// Bound: launch latency at the storm's sizes (D = 1,024, U = 32; the
// [D, U] tables take under a microsecond at the card's memory rate);
// the keyless row of 16,384 units is a few dependent block barriers a
// tile and the serial levels above a warp.
#include "price.cuh"

#define KTPU_DOMAIN_THREADS 1024
#define KTPU_DOMAIN_WARPS (KTPU_DOMAIN_THREADS / 32)
#define KTPU_DOMAIN_CLUSTER 16
// kubernetes_tpu_torch/scheduler/kernels/preempt.py MAX_U: 16^6 units
#define KTPU_DOMAIN_MAX_U (1 << 24)
// the rows instance's widest row (64 blocks, two levels of 16; 32
// chunks, one level); kubernetes_tpu_torch/scheduler/kernels/preempt.py
// DOMAIN_ROWS_MAX_U
#define KTPU_DOMAIN_NARROW_U 1024
// the wide instance: units a fit tile (a block of 16 a thread) and a cost
// tile (a chunk of 32 a thread), the fit's groups of 16 blocks and of 256
// blocks a tile, and the levels above them (16^3 items of 4,096 units)
#define KTPU_DOMAIN_FIT_TILE (KTPU_DOMAIN_THREADS * KTPU_PREFIX_BLOCK)
#define KTPU_DOMAIN_COST_TILE (KTPU_DOMAIN_THREADS * KTPU_SUM_CHUNK)
#define KTPU_DOMAIN_L2_ITEMS (KTPU_DOMAIN_THREADS / KTPU_PREFIX_BLOCK)
#define KTPU_DOMAIN_L3_ITEMS (KTPU_DOMAIN_L2_ITEMS / KTPU_PREFIX_BLOCK)
#define KTPU_DOMAIN_L3_UNITS \
  (KTPU_PREFIX_BLOCK * KTPU_PREFIX_BLOCK * KTPU_PREFIX_BLOCK)

struct KtpuDomainArgs {
  const float* base;      // [D]
  const float* need;      // scalar
  const float* dslots;    // [D, U]
  const bool* valid;      // [D, U]
  const bool* pdb;        // [D, U]
  const int* top;         // [D, U]
  const float* psum;      // [D, U]
  const int* gcnt;        // [D, U]
  const int* startr;      // [D, U]
  const bool* row_valid;  // [D]
  int* winner;            // scalar
  bool* chosen;           // [D, U]
  int* nviol;             // [D]
  int D, U;
};

// The integer costs of a prefix: PDB violations, victims charged (in
// uint32, which wraps as the reference's int32 cast does), and the top
// priority with the latest start among the units at it (-1 at least, as
// the reference's where(..., startr, -1)). Every part merges exactly in
// any order.
struct KtpuDomainCost {
  int nv;
  unsigned cv;
  int tv, sv;

  __device__ __forceinline__ void init() {
    nv = 0;
    cv = 0u;
    tv = INT_MIN;
    sv = -1;
  }

  __device__ __forceinline__ void unit(bool pdb, int top, int gcnt,
                                       int startr) {
    nv += pdb ? 1 : 0;
    cv += (unsigned)gcnt;
    if (top > tv) {
      tv = top;
      sv = max(startr, -1);
    } else if (top == tv) {
      sv = max(sv, startr);
    }
  }

  // the warp's costs; every lane ends with them
  __device__ __forceinline__ void warp_reduce() {
    nv = __reduce_add_sync(0xffffffffu, nv);
    cv = __reduce_add_sync(0xffffffffu, cv);
    const int t = __reduce_max_sync(0xffffffffu, tv);
    sv = __reduce_max_sync(0xffffffffu, tv == t ? sv : -1);
    tv = t;
  }
};

// A row's candidate from its costs (none where the row is infeasible)
__device__ __forceinline__ KtpuLexi ktpu_domain_lexi(int i, bool feas,
                                                    const KtpuDomainCost& c,
                                                    float psumv) {
  if (!feas) return ktpu_lexi_none();
  // sv >= -1: -sv does not overflow
  return KtpuLexi{c.nv, c.tv, psumv, (int)c.cv, -c.sv, i,
                  isnan(psumv) ? 1 : 0};
}

// ------------------------------------------------------ a warp a row

// Row i on one warp (every lane calls it; every lane returns the row's
// candidate), U <= KTPU_DOMAIN_NARROW_U.
__device__ __forceinline__ KtpuLexi ktpu_domain_row_warp(
    const KtpuDomainArgs& a, int i, float need) {
  const int lane = threadIdx.x & 31;
  const int U = a.U;
  const size_t off = (size_t)i * U;
  const float b = a.base[i];
  const bool fit0 = b >= need;
  const bool rv = a.row_valid[i];
  // ---- the first fitting prefix, 32 units (two blocks) a step
  int kidx = -1;
  if (rv && !fit0) {
    KtpuBlockedPrefix<1, 2> bp;  // over the block totals, warp-uniform
    float prev = 0.0f;            // the blocks' prefix before this step
    for (int s = 0; s * 32 < U; ++s) {
      const int u = s * 32 + lane;
      const bool v = u < U && a.valid[off + u];
      const float in0 = ktpu_seg16_prefix(v ? a.dslots[off + u] : 0.0f);
      const int b0 = 2 * s;
      const float t0 = __shfl_sync(0xffffffffu, in0, 15);
      const float t1 = __shfl_sync(0xffffffffu, in0, 31);
      // the prefix of the blocks through b0 (lanes 16-31 start from it)
      const float p0 = bp.add(0, t0, b0);
      bp.end_unit(b0, 1);
      const float cum = lane < 16 ? (b0 > 0 ? __fadd_rn(prev, in0) : in0)
                                  : __fadd_rn(p0, in0);
      const unsigned m =
          __ballot_sync(0xffffffffu, v && __fadd_rn(b, cum) >= need);
      if (m) {  // the FIRST fitting unit
        kidx = s * 32 + __ffs(m) - 1;
        break;
      }
      if ((s + 1) * 32 < U) {
        prev = bp.add(0, t1, b0 + 1);
        bp.end_unit(b0 + 1, 1);
      }
    }
  }
  const bool feas = (kidx >= 0 || fit0) && rv;
  // a domain that already holds the gang evicts nothing
  const bool evict = feas && !fit0;
  const int kk = kidx >= 0 ? kidx : 0;
  // ---- the chosen units and their costs, a 32-unit chunk a step
  KtpuDomainCost cost;
  cost.init();
  KtpuChunkedSum<1> ks;
  const int nch = (U + 31) / 32;
  float c0 = 0.0f;
  for (int c = 0; c < nch; ++c) {
    const int u = c * 32 + lane;
    bool ch = false;
    c0 = 0.0f;  // a chunk past the prefix: every item +0.0
    if (evict && c * 32 <= kk) {
      ch = u < U && u <= kk && a.valid[off + u];
      c0 = ktpu_warp_seqsum(ch ? a.psum[off + u] : 0.0f,
                            min(32, U - c * 32));
      if (ch)
        cost.unit(a.pdb[off + u], a.top[off + u], a.gcnt[off + u],
                  a.startr[off + u]);
    }
    if (u < U) a.chosen[off + u] = ch;
    if (nch > 1) ks.add(c0, c, nch);
  }
  cost.warp_reduce();
  // one chunk: its sum is the total
  const float psumv = nch > 1 ? ks.total(nch) : c0;
  if (lane == 0) a.nviol[i] = cost.nv;
  return ktpu_domain_lexi(i, feas, cost, psumv);
}

__global__ void __launch_bounds__(KTPU_DOMAIN_THREADS, 1)
ktpu_domain_rows_kernel(KtpuDomainArgs a, int Dc) {
  __shared__ KtpuLexi sh[32];
  __shared__ __align__(8) uint64_t bar;
  // CTA q's candidate in two 16-byte halves
  __shared__ __align__(16) uint4 slots[KTPU_DOMAIN_CLUSTER][2];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const unsigned rank = ktpu_cluster_rank();
  const unsigned nctas = ktpu_cluster_size();
  if (tid == 0) ktpu_xchg_init(&bar, 1);
  // the mbarrier's init reaches the cluster while the rows are priced
  ktpu_cluster_arrive();
  const float need = a.need[0];
  const int r0 = (int)rank * Dc;
  const int r1 = min(a.D, r0 + Dc);
  KtpuLexi best = ktpu_lexi_none();
  for (int i = r0 + warp; i < r1; i += nwarps)
    best = ktpu_lexi_min(best, ktpu_domain_row_warp(a, i, need));
  best = ktpu_lexi_block(best, sh);
  ktpu_cluster_wait();
  if (tid >= 32) return;
  const KtpuLexi c = ktpu_lexi_xchg(best, slots, &bar, rank, nctas);
  if (rank == 0 && tid == 0) a.winner[0] = ktpu_lexi_winner_row(c);
}

// ------------------------------------------------------ a block a row

// The block's sum of v (every thread ends with it); sh: 32 ints, reused
// after the call
__device__ __forceinline__ unsigned ktpu_block_sum(unsigned v,
                                                   unsigned* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = __reduce_add_sync(0xffffffffu, v);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  unsigned r = lane < (int)(blockDim.x >> 5) ? sh[lane] : 0u;
  r = __reduce_add_sync(0xffffffffu, r);
  __syncthreads();
  return r;
}

__device__ __forceinline__ int ktpu_block_max(int v, int* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = __reduce_max_sync(0xffffffffu, v);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  int r = lane < (int)(blockDim.x >> 5) ? sh[lane] : INT_MIN;
  r = __reduce_max_sync(0xffffffffu, r);
  __syncthreads();
  return r;
}

// Units [u0, u0 + 16) of the row at `off`: x[j] the slots of unit u0 + j
// where it is valid (0.0 where not, and past U); returns the valid
// units' bits. One 16-byte load of the flags and four of the slots where
// the row's base and U allow it.
__device__ __forceinline__ unsigned ktpu_domain_block(const KtpuDomainArgs& a,
                                                      size_t off, int u0,
                                                      float* x) {
  const int U = a.U;
  const bool* vp = a.valid + off + u0;
  const float* dp = a.dslots + off + u0;
  unsigned vm = 0u;
  if (u0 + KTPU_PREFIX_BLOCK <= U &&
      (((uintptr_t)vp | (uintptr_t)dp) & 15u) == 0u) {
    const uint4 v = *reinterpret_cast<const uint4*>(vp);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < KTPU_PREFIX_BLOCK; ++j)
      vm |= (((w[j >> 2] >> (8 * (j & 3))) & 0xffu) ? 1u : 0u) << j;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 d = reinterpret_cast<const float4*>(dp)[q];
      x[4 * q] = d.x;
      x[4 * q + 1] = d.y;
      x[4 * q + 2] = d.z;
      x[4 * q + 3] = d.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < KTPU_PREFIX_BLOCK; ++j) {
      const bool v = u0 + j < U && vp[j];
      vm |= (v ? 1u : 0u) << j;
      x[j] = v ? dp[j] : 0.0f;
    }
  }
#pragma unroll
  for (int j = 0; j < KTPU_PREFIX_BLOCK; ++j)
    if (!((vm >> j) & 1u)) x[j] = 0.0f;
  return vm;
}

// chosen[u] of the row at `off` for every unit: valid and in the prefix
// [0, kk] of an evicting row; thread t writes the 16-unit groups t, t +
// 1,024, ..., each with one 16-byte store where aligned
__device__ __forceinline__ void ktpu_domain_chosen(const KtpuDomainArgs& a,
                                                   size_t off, bool evict,
                                                   int kk) {
  const int U = a.U;
  for (int u0 = threadIdx.x * 16; u0 < U; u0 += blockDim.x * 16) {
    const bool* vp = a.valid + off + u0;
    bool* cp = a.chosen + off + u0;
    const bool any = evict && u0 <= kk;
    if (u0 + 16 <= U && (((uintptr_t)vp | (uintptr_t)cp) & 15u) == 0u) {
      uint4 c = make_uint4(0u, 0u, 0u, 0u);
      if (any) {
        const uint4 v = *reinterpret_cast<const uint4*>(vp);
        const unsigned w[4] = {v.x, v.y, v.z, v.w};
        unsigned o[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          o[q] = 0u;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (((w[q] >> (8 * k)) & 0xffu) && u0 + 4 * q + k <= kk)
              o[q] |= 1u << (8 * k);
        }
        c = make_uint4(o[0], o[1], o[2], o[3]);
      }
      *reinterpret_cast<uint4*>(cp) = c;
    } else {
      for (int j = 0; j < 16 && u0 + j < U; ++j)
        cp[j] = any && u0 + j <= kk && vp[j];
    }
  }
}

// The first unit of row i after whose prefix the domain holds `need`
// slots, or -1 (the block calls it; every thread returns it). Thread t
// takes block B = T * 1,024 + t of tile T: units [16 B, 16 B + 16).
// cum(u) = P1(B - 1) + in0(u), P1 the blocked prefix of the block
// totals: P1(B) = P2(B / 16 - 1) + in1(B), in1 the in-group prefix of 16
// blocks; P2 likewise from in2 (groups of 16 groups, warp 0) and P3, the
// levels above, which warp 0 carries in a KtpuBlockedPrefix from tile to
// tile. Each "P(j - 1) +" is left out where j - 1 < 0, as the
// reference's first block starts from nothing.
__device__ __forceinline__ int ktpu_domain_wide_fit(const KtpuDomainArgs& a,
                                                    size_t off, float b,
                                                    float need, float* s_l2,
                                                    float* s_p2, float* s_p1,
                                                    int* sh_i) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int U = a.U;
  // warp 0's levels from 4,096 units up (16^3 items: 2^24 units)
  KtpuBlockedPrefix<1, 3> p3;
  float carry_p3 = 0.0f, carry_p2 = 0.0f, carry_p1 = 0.0f;
  for (int T = 0; T * KTPU_DOMAIN_FIT_TILE < U; ++T) {
    const int u0 = T * KTPU_DOMAIN_FIT_TILE + tid * KTPU_PREFIX_BLOCK;
    // the block's units in order: its total, and which units are valid
    float x[KTPU_PREFIX_BLOCK];
    const unsigned vm = ktpu_domain_block(a, off, u0, x);
    float run = x[0];
#pragma unroll
    for (int j = 1; j < KTPU_PREFIX_BLOCK; ++j) run = __fadd_rn(run, x[j]);
    // in1: the block totals' prefix inside each group of 16 blocks
    const float in1 = ktpu_seg16_prefix(run);
    if ((tid & 15) == 15) s_l2[tid >> 4] = in1;
    __syncthreads();
    if (tid < 32) {
      // in2 over the tile's 64 group totals, then the 4 totals of 256
      // blocks each into the levels above
      const float g0 = ktpu_seg16_prefix(s_l2[lane]);
      const float g1 = ktpu_seg16_prefix(s_l2[lane + 32]);
      float p3v[KTPU_DOMAIN_L3_ITEMS];
#pragma unroll
      for (int h = 0; h < KTPU_DOMAIN_L3_ITEMS; ++h) {
        const float item = __shfl_sync(0xffffffffu, h < 2 ? g0 : g1,
                                       (16 * h + 15) & 31);
        const int H = T * KTPU_DOMAIN_L3_ITEMS + h;
        p3v[h] = 0.0f;
        if (H * KTPU_DOMAIN_L3_UNITS < U) {
          p3v[h] = p3.add(0, item, H);
          p3.end_unit(H, 1);
        }
      }
      // P2 of group g = lane (its level-3 item h = lane / 16) and of
      // g = lane + 32 (h = 2 + lane / 16), each from P3(h - 1)
      const float q0 = lane < 16 ? carry_p3 : p3v[0];
      const float q1 = lane < 16 ? p3v[1] : p3v[2];
      const bool first = T == 0 && lane < 16;
      s_p2[lane] = first ? g0 : __fadd_rn(q0, g0);
      s_p2[lane + 32] = __fadd_rn(q1, g1);
      carry_p3 = p3v[KTPU_DOMAIN_L3_ITEMS - 1];
    }
    __syncthreads();
    // P1 of this thread's block from P2 of the group before its own
    const int g = tid >> 4;
    const float q = g > 0 ? s_p2[g - 1] : carry_p2;
    const float p1 = (T > 0 || g > 0) ? __fadd_rn(q, in1) : in1;
    s_p1[tid] = p1;
    __syncthreads();
    const bool has_prev = T > 0 || tid > 0;
    const float pp = tid > 0 ? s_p1[tid - 1] : carry_p1;
    // the block's units again (L1), the in-block prefix added in order
    ktpu_domain_block(a, off, u0, x);
    int first = INT_MAX;
    float in0 = 0.0f;
#pragma unroll
    for (int j = 0; j < KTPU_PREFIX_BLOCK; ++j) {
      in0 = j == 0 ? x[0] : __fadd_rn(in0, x[j]);
      const float cum = has_prev ? __fadd_rn(pp, in0) : in0;
      if (first == INT_MAX && ((vm >> j) & 1u) && __fadd_rn(b, cum) >= need)
        first = u0 + j;
    }
    // the next tile starts from this one's last prefixes; the block's
    // min below holds the barriers before they are written again
    carry_p1 = s_p1[KTPU_DOMAIN_THREADS - 1];
    carry_p2 = s_p2[KTPU_DOMAIN_L2_ITEMS - 1];
    first = ktpu_block_min_int(first, sh_i);
    if (first != INT_MAX) return first;
  }
  return -1;
}

__global__ void __launch_bounds__(KTPU_DOMAIN_THREADS, 1)
ktpu_domain_wide_kernel(KtpuDomainArgs a) {
  __shared__ float s_l2[KTPU_DOMAIN_L2_ITEMS];
  __shared__ float s_p2[KTPU_DOMAIN_L2_ITEMS];
  __shared__ float s_p1[KTPU_DOMAIN_THREADS];
  __shared__ float s_c1[KTPU_DOMAIN_WARPS];
  __shared__ int sh_i[32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int U = a.U;
  const float need = a.need[0];
  const int nch = (U + KTPU_SUM_CHUNK - 1) / KTPU_SUM_CHUNK;
  const int n2 = (nch + KTPU_SUM_CHUNK - 1) / KTPU_SUM_CHUNK;
  KtpuLexi best = ktpu_lexi_none();  // thread 0's
  for (int i = 0; i < a.D; ++i) {
    const size_t off = (size_t)i * U;
    const float b = a.base[i];
    const bool fit0 = b >= need;
    const bool rv = a.row_valid[i];
    const int kidx = (rv && !fit0)
        ? ktpu_domain_wide_fit(a, off, b, need, s_l2, s_p2, s_p1, sh_i)
        : -1;
    const bool feas = (kidx >= 0 || fit0) && rv;
    const bool evict = feas && !fit0;
    const int kk = kidx >= 0 ? kidx : 0;
    ktpu_domain_chosen(a, off, evict, kk);
    // ---- the costs: thread t the chunk T * 1,024 + t of cost tile T
    KtpuDomainCost cost;
    cost.init();
    KtpuChunkedSum<3> ks;  // thread 0's, from the level of 1,024 units
    float top = 0.0f;      // thread 0's: the total of one chunk or one
                           // warp's chunks, where that is the top level
    for (int T = 0; T * KTPU_DOMAIN_COST_TILE < U; ++T) {
      const int c = T * KTPU_DOMAIN_THREADS + tid;
      const int u0 = c * KTPU_SUM_CHUNK;
      float c0 = 0.0f;  // a chunk past the prefix: every item +0.0
      if (u0 < U && evict && u0 <= kk) {
        const int n = min(KTPU_SUM_CHUNK, U - u0);
        for (int j = 0; j < n; ++j) {
          const int u = u0 + j;
          const bool ch = u <= kk && a.valid[off + u];
          const float x = ch ? a.psum[off + u] : 0.0f;
          c0 = j == 0 ? x : __fadd_rn(c0, x);
          if (ch)
            cost.unit(a.pdb[off + u], a.top[off + u], a.gcnt[off + u],
                      a.startr[off + u]);
        }
      }
      // the warp's 32 chunks in lane order: item T * 32 + warp one level
      // up
      const int nin = min(KTPU_SUM_CHUNK, nch - (T * KTPU_DOMAIN_THREADS +
                                                 KTPU_SUM_CHUNK * warp));
      const float c1 = nin > 0 ? ktpu_warp_seqsum(c0, nin) : 0.0f;
      if (lane == 0) s_c1[warp] = c1;
      if (T == 0 && tid == 0) top = nch == 1 ? c0 : c1;
      __syncthreads();
      if (tid == 0 && nch > KTPU_SUM_CHUNK) {
        for (int w = 0; w < KTPU_DOMAIN_WARPS; ++w) {
          const int k = T * KTPU_DOMAIN_WARPS + w;
          if (k < n2) ks.add(s_c1[w], k, n2);
        }
      }
      __syncthreads();
    }
    // ---- the block's costs
    cost.nv = (int)ktpu_block_sum((unsigned)cost.nv, (unsigned*)sh_i);
    cost.cv = ktpu_block_sum(cost.cv, (unsigned*)sh_i);
    const int tv = ktpu_block_max(cost.tv, sh_i);
    cost.sv = ktpu_block_max(cost.tv == tv ? cost.sv : -1, sh_i);
    cost.tv = tv;
    if (tid == 0) {
      const float psumv = nch > KTPU_SUM_CHUNK ? ks.total(n2) : top;
      a.nviol[i] = cost.nv;
      best = ktpu_lexi_min(best, ktpu_domain_lexi(i, feas, cost, psumv));
    }
  }
  if (tid == 0) a.winner[0] = ktpu_lexi_winner_row(best);
}

// ------------------------------------------------------ the host's call

// the rows instance on a cluster of 16 CTAs, CTA q the rows [q * Dc,
// (q + 1) * Dc)
static cudaError_t ktpu_domain_rows_launch(const KtpuDomainArgs& a,
                                           cudaStream_t s) {
  const int Dc = (a.D + KTPU_DOMAIN_CLUSTER - 1) / KTPU_DOMAIN_CLUSTER;
  const int threads = 32 * min(Dc, KTPU_DOMAIN_WARPS);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(KTPU_DOMAIN_CLUSTER, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = KTPU_DOMAIN_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a 16-CTA cluster is past the portable size: allowed once
  static bool allowed = false;
  if (!allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        ktpu_domain_rows_kernel,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    allowed = true;
  }
  return cudaLaunchKernelEx(
      &cfg, ktpu_domain_rows_kernel, a, Dc);
}

// the rows instance at U <= KTPU_DOMAIN_NARROW_U, the wide one past it
extern "C" int ktpu_price_domains(
    const float* base, const float* need, const float* dslots,
    const bool* valid, const bool* pdb, const int* top, const float* psum,
    const int* gcnt, const int* startr, const bool* row_valid, int* winner,
    bool* chosen, int* nviol, int D, int U, void* stream) {
  if (D < 1 || U < 1 || U > KTPU_DOMAIN_MAX_U)
    return (int)cudaErrorInvalidValue;
  KtpuDomainArgs a{base, need, dslots, valid, pdb, top, psum, gcnt, startr,
                   row_valid, winner, chosen, nviol, D, U};
  cudaStream_t s = (cudaStream_t)stream;
  if (U <= KTPU_DOMAIN_NARROW_U) {
    const cudaError_t err = ktpu_domain_rows_launch(a, s);
    if (err != cudaSuccess) return (int)err;
  } else {
    ktpu_domain_wide_kernel<<<1, KTPU_DOMAIN_THREADS, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}
