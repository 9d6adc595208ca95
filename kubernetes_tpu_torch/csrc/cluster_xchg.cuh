// The exchange of a thread-block cluster's scans: every CTA of one
// cluster publishes values into every CTA's shared memory and each waits
// only for what it reads. Included by gang_scan.cu (K9's cluster design),
// pod_scan_cluster.cu (K7's) and shard_scan_shared.cu (K15's), so the
// three cannot drift.
//
// A slot array lives in every CTA, with one mbarrier. A writer stores 16
// bytes into CTA q's copy with st.async, whose completion the hardware
// counts on CTA q's mbarrier in bytes; CTA q's thread 0 arrives once a
// phase, expecting the bytes of every writer of the cluster, and its
// threads wait on their own copy by phase parity (acquire: the data is
// visible). No cluster barrier and no release fence: a CTA waits only for
// the values it reads. Two arrays alternate by step parity: an array is
// written again only two exchanges later, after every CTA has arrived for
// the exchange in between, which it does only after reading this one.
//
// Candidates: each warp folds its (penalized score, row, masked score,
// aux) with shuffles and its lane q stores it into slot (rank, warp) of
// CTA q; every warp then folds the cluster's candidates with one
// comparator, the largest penalized score, ties (float ==, so -0.0 ties
// +0.0) to the lowest row: the same winner in every warp of every CTA.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "score.cuh"

// warps a CTA has at most (512 threads): a CTA's slots in an array
#define KTPU_XCHG_WARPS 16
// CTAs of a cluster at most (Hopper's largest, non-portable, size)
#define KTPU_XCHG_CTAS 16

// one warp's candidate for a step, stored into every CTA of the cluster
struct __align__(16) KtpuCand {
  float pen;   // tie-penalized score
  float val;   // masked score at its row
  int row;     // global row
  int aux;     // a value of the row the winner carries (K9: its domain)
};

__device__ __forceinline__ bool ktpu_cand_beats(float pen, int row,
                                                float bpen, int brow) {
  return pen > bpen || (pen == bpen && row < brow);
}

// the warp's first max of (pen, row), carrying val and aux; every lane
// ends with it
__device__ __forceinline__ void ktpu_warp_argmax(float& pen, int& row,
                                                 float& val, int& aux) {
  for (int o = 16; o > 0; o >>= 1) {
    const float open = __shfl_xor_sync(0xffffffffu, pen, o);
    const int orow = __shfl_xor_sync(0xffffffffu, row, o);
    const float oval = __shfl_xor_sync(0xffffffffu, val, o);
    const int oaux = __shfl_xor_sync(0xffffffffu, aux, o);
    if (ktpu_cand_beats(open, orow, pen, row)) {
      pen = open;
      row = orow;
      val = oval;
      aux = oaux;
    }
  }
}

// A cluster barrier. Its arrival must be the SAME instruction for every
// thread of a warp: a divergent mix of .release and .relaxed arrivals
// hung the card.
__device__ __forceinline__ void ktpu_cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void ktpu_cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}
__device__ __forceinline__ void ktpu_cluster_sync() {
  ktpu_cluster_arrive();
  ktpu_cluster_wait();
}

__device__ __forceinline__ unsigned ktpu_smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void ktpu_mbar_init(uint64_t* bar,
                                               unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   ktpu_smem_addr(bar)),
               "r"(count)
               : "memory");
}
// thread 0: every mbarrier of the CTA initialised for one arrival a phase
// and made visible to the cluster; the caller then takes a cluster
// barrier, so that no CTA reaches another's before it is ready
__device__ __forceinline__ void ktpu_xchg_init(uint64_t* bars, int n) {
  for (int i = 0; i < n; ++i) ktpu_mbar_init(&bars[i], 1);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
// the shared::cluster address of CTA `rank`'s copy of a shared variable
__device__ __forceinline__ unsigned ktpu_mapa(const void* p,
                                              unsigned rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(ktpu_smem_addr(p)), "r"(rank));
  return remote;
}
// store 16 bytes into CTA `rank`'s copy of `dst`, counted as complete
// transaction bytes on its copy of `bar`
__device__ __forceinline__ void ktpu_st_async16(void* dst, uint64_t* bar,
                                                unsigned rank, unsigned x,
                                                unsigned y, unsigned z,
                                                unsigned w) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
      "[%0], {%1, %2, %3, %4}, [%5];" ::"r"(ktpu_mapa(dst, rank)),
      "r"(x), "r"(y), "r"(z), "r"(w), "r"(ktpu_mapa(bar, rank))
      : "memory");
}
// this CTA's one arrival of a phase, expecting `bytes` of st.async data
__device__ __forceinline__ void ktpu_mbar_expect(uint64_t* bar,
                                                 unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          ktpu_smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
// wait until the phase of `bar` with this parity has completed
__device__ __forceinline__ void ktpu_mbar_wait(uint64_t* bar,
                                               unsigned parity) {
  const unsigned addr = ktpu_smem_addr(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n\tselp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// the waits of a CTA's two arrays of one kind: bit a of `phases` is the
// parity the next phase of array a waits for
__device__ __forceinline__ void ktpu_xchg_wait(uint64_t* bar, int par,
                                               unsigned& phases) {
  ktpu_mbar_wait(bar, (phases >> par) & 1u);
  phases ^= 1u << par;
}

// the warp's candidate into slot (rank, warp) of the array `slots` of
// each of the cluster's nctas CTAs: lane q stores into CTA q
__device__ __forceinline__ void ktpu_xchg_publish(KtpuCand* slots,
                                                  uint64_t* bar, int rank,
                                                  int warp, int lane,
                                                  int nctas, float pen,
                                                  float val, int row,
                                                  int aux) {
  if (lane < nctas)
    ktpu_st_async16(&slots[rank * KTPU_XCHG_WARPS + warp], bar, lane,
                    __float_as_uint(pen), __float_as_uint(val),
                    (unsigned)row, (unsigned)aux);
}

// the bytes one CTA's array of candidates receives a phase
__device__ __forceinline__ unsigned ktpu_xchg_cand_bytes(int nctas,
                                                         int nwarps) {
  return (unsigned)nctas * (unsigned)nwarps * (unsigned)sizeof(KtpuCand);
}

// every warp's fold of the cluster's candidates in one array (CTA q's
// warps at [q * 16, q * 16 + nwarps); a warp with no rows left at its
// empty slot): every lane ends with the winner
__device__ __forceinline__ KtpuCand ktpu_xchg_fold(const KtpuCand* slots,
                                                   int nctas, int nwarps,
                                                   int lane) {
  float epen = -__int_as_float(0x7f800000), eval = KTPU_NEG;
  int erow = 0x7fffffff, eaux = -1;
  for (int q = lane; q < nctas * KTPU_XCHG_WARPS; q += 32) {
    if ((q & (KTPU_XCHG_WARPS - 1)) >= nwarps) continue;
    const KtpuCand c = slots[q];
    if (ktpu_cand_beats(c.pen, c.row, epen, erow)) {
      epen = c.pen;
      eval = c.val;
      erow = c.row;
      eaux = c.aux;
    }
  }
  ktpu_warp_argmax(epen, erow, eval, eaux);
  return KtpuCand{epen, eval, erow, eaux};
}

// ================================================================
// The partials' exchange: the cluster-wide reductions over the feasible
// rows that the spread and soft terms need before the argmax (the max
// count, zone presence, the zone sums, the soft min and max)
// ================================================================

// zones the exchange takes: lane z of a warp holds zone z's sum
#define KTPU_XCHG_ZONES 32
// a CTA's partials: max count, zone presence, soft min and max, then the
// zone sums, published as 16-byte chunks
#define KTPU_PART_WORDS (4 + KTPU_XCHG_ZONES)

// a CTA's shared scratch for the exchange
struct KtpuPartScratch {
  float w_maxc[KTPU_XCHG_WARPS];
  int w_hz[KTPU_XCHG_WARPS];
  float w_mn[KTPU_XCHG_WARPS];
  float w_mx[KTPU_XCHG_WARPS];
  // each warp's integer zone counts, and its counts that are not small
  // integers (a float partial of their own)
  int zw[KTPU_XCHG_WARPS][KTPU_XCHG_ZONES];
  float zf[KTPU_XCHG_WARPS][KTPU_XCHG_ZONES];
  __align__(16) float mine[KTPU_PART_WORDS];
};

// the cluster-wide values every warp holds after the exchange
struct KtpuPartials {
  float maxc;        // max feasible count (0.0 with none)
  bool have_zones;   // some feasible row has a named zone
  float mn, mx;      // soft: min and max raw over the feasible rows
  float zsum;        // lane z < Z: zone z's sum, from zinit
  float maxz;        // max zone sum over the named zones (0.0 with none)
};

// a row's zone code: its id clamped to [0, Z) (Z <= 32), bit 14 set
// when the id is below Z, bit 15 when it is named (> 0)
__device__ __forceinline__ uint32_t ktpu_zone_code(int z, int Z) {
  return (uint32_t)(z < 0 ? 0 : (z >= Z ? Z - 1 : z)) |
         (z < Z ? 0x4000u : 0u) | (z > 0 ? 0x8000u : 0u);
}

// one row of the thread: the feasible count cf of a named zone below Z
// adds to the warp's zone row, as an integer when it is a small one
// (exact in any order below 2^24); zone 0 ("no zone label") never enters
// a zone sum. One shared integer atomic a row: merging a warp's lanes of
// one zone first (__match_any_sync) cost more than the atomics it saved
// (PERF.md).
__device__ __forceinline__ void ktpu_zone_add(KtpuPartScratch& ps,
                                              int warp, uint32_t code,
                                              float cf) {
  const int z = (int)(code & 0x3FFFu);
  const bool add = cf != 0.0f && (code & 0x8000u) != 0u &&
                   (code & 0x4000u) != 0u;
  if (!add) return;
  if (cf == floorf(cf) && cf > 0.0f && cf < 16777216.0f)
    atomicAdd(&ps.zw[warp][z], (int)cf);
  else
    atomicAdd(&ps.zf[warp][z], cf);
}

// the warp's zone rows back to zero before its first ktpu_zone_add of a
// step (warp 0 read the last step's before publishing them, which every
// warp waited for)
__device__ __forceinline__ void ktpu_zone_reset(KtpuPartScratch& ps,
                                                int warp, int lane) {
  ps.zw[warp][lane] = 0;
  ps.zf[warp][lane] = 0.0f;
  __syncwarp();
}

// The exchange of one step: every thread passes its rows' partials
// (lmax, lhz, lmn, lmx); the warps fold them by shuffles, one block
// barrier, warp 0 folds the CTA's and publishes its [4 + Z] words
// (chunks of 16 bytes) into slot `rank` of `slots` in each of the nctas
// CTAs, counted on their `bar`; every warp waits and folds the nctas
// partials: max, or, min in any order, the zone sums in rank order
// (integer-valued: exact in any order) from zinit (lane z's zinit_lane).
template <bool SPREAD>
__device__ __forceinline__ KtpuPartials ktpu_xchg_partials(
    KtpuPartScratch& ps, float (*slots)[KTPU_PART_WORDS], uint64_t* bar,
    int par, unsigned& phases, int rank, int nctas, int Z,
    float zinit_lane, float lmax, int lhz, float lmn, float lmx) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const float inf = __int_as_float(0x7f800000);
  const int chunks = (4 + (SPREAD ? Z : 0) + 3) / 4;
  for (int o = 16; o > 0; o >>= 1) {
    lmax = fmaxf(lmax, __shfl_xor_sync(0xffffffffu, lmax, o));
    lhz |= __shfl_xor_sync(0xffffffffu, lhz, o);
    lmn = fminf(lmn, __shfl_xor_sync(0xffffffffu, lmn, o));
    lmx = fmaxf(lmx, __shfl_xor_sync(0xffffffffu, lmx, o));
  }
  if (lane == 0) {
    ps.w_maxc[warp] = lmax;
    ps.w_hz[warp] = lhz;
    ps.w_mn[warp] = lmn;
    ps.w_mx[warp] = lmx;
  }
  __syncthreads();   // the warps' partials and zone rows are complete
  if (warp == 0) {
    lmax = lane < nwarps ? ps.w_maxc[lane] : 0.0f;
    lhz = lane < nwarps ? ps.w_hz[lane] : 0;
    lmn = lane < nwarps ? ps.w_mn[lane] : inf;
    lmx = lane < nwarps ? ps.w_mx[lane] : -inf;
    for (int o = 16; o > 0; o >>= 1) {
      lmax = fmaxf(lmax, __shfl_xor_sync(0xffffffffu, lmax, o));
      lhz |= __shfl_xor_sync(0xffffffffu, lhz, o);
      lmn = fminf(lmn, __shfl_xor_sync(0xffffffffu, lmn, o));
      lmx = fmaxf(lmx, __shfl_xor_sync(0xffffffffu, lmx, o));
    }
    float zpart = 0.0f;
    if (SPREAD && lane < Z) {
      // the 16 rows' loads issue together, then the adds in warp order
      int iw[KTPU_XCHG_WARPS];
      float fw[KTPU_XCHG_WARPS];
#pragma unroll
      for (int w = 0; w < KTPU_XCHG_WARPS; ++w) {
        iw[w] = w < nwarps ? ps.zw[w][lane] : 0;
        fw[w] = w < nwarps ? ps.zf[w][lane] : 0.0f;
      }
      int isum = 0;
      float fsum = 0.0f;
#pragma unroll
      for (int w = 0; w < KTPU_XCHG_WARPS; ++w) {
        isum += iw[w];
        fsum = __fadd_rn(fsum, fw[w]);
      }
      zpart = __fadd_rn((float)isum, fsum);
    }
    if (lane == 0) {
      ps.mine[0] = lmax;
      ps.mine[1] = __int_as_float(lhz);
      ps.mine[2] = lmn;
      ps.mine[3] = lmx;
    }
    if (4 + lane < chunks * 4) ps.mine[4 + lane] = zpart;
    __syncwarp();
    for (int idx = lane; idx < nctas * chunks; idx += 32) {
      const int q = idx % nctas;
      const int c = idx / nctas;
      const float4 v = *reinterpret_cast<const float4*>(&ps.mine[4 * c]);
      ktpu_st_async16(&slots[rank][4 * c], bar, q, __float_as_uint(v.x),
                      __float_as_uint(v.y), __float_as_uint(v.z),
                      __float_as_uint(v.w));
    }
    if (lane == 0)
      ktpu_mbar_expect(bar, (unsigned)(nctas * chunks * 16));
  }
  ktpu_xchg_wait(bar, par, phases);
  lmax = 0.0f;
  lhz = 0;
  lmn = inf;
  lmx = -inf;
  if (lane < nctas) {
    lmax = slots[lane][0];
    lhz = __float_as_int(slots[lane][1]);
    lmn = slots[lane][2];
    lmx = slots[lane][3];
  }
  float zsum = 0.0f, lz = 0.0f;
  if (SPREAD && lane < Z) {
    // the CTAs' loads issue together, then the adds in rank order
    float part[KTPU_XCHG_CTAS];
#pragma unroll
    for (int q = 0; q < KTPU_XCHG_CTAS; ++q)
      part[q] = q < nctas ? slots[q][4 + lane] : 0.0f;
    float tot = 0.0f;
#pragma unroll
    for (int q = 0; q < KTPU_XCHG_CTAS; ++q) tot = __fadd_rn(tot, part[q]);
    zsum = __fadd_rn(zinit_lane, tot);
    if (lane > 0) lz = zsum;   // zone 0 never enters maxz
  }
  for (int o = 16; o > 0; o >>= 1) {
    lmax = fmaxf(lmax, __shfl_xor_sync(0xffffffffu, lmax, o));
    lhz |= __shfl_xor_sync(0xffffffffu, lhz, o);
    lmn = fminf(lmn, __shfl_xor_sync(0xffffffffu, lmn, o));
    lmx = fmaxf(lmx, __shfl_xor_sync(0xffffffffu, lmx, o));
    lz = fmaxf(lz, __shfl_xor_sync(0xffffffffu, lz, o));
  }
  return KtpuPartials{lmax, lhz != 0, lmn, lmx, zsum, lz};
}
