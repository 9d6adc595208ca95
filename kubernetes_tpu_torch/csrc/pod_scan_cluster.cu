// K7's cluster design: the classic per-pod scan (pod_scan.cu has the
// kernel's notes, the reference it replaces and its block design) over
// one thread-block cluster; a source of its own so that the two designs'
// instances compile in parallel.
//
// The model is K9's cluster design (gang_scan.cu), which runs the same
// pod.cuh step. One cluster of 16 CTAs (Hopper's largest, a non-portable
// size), CTA k owning rows [k * Nl, (k + 1) * Nl), Nl = ceil(N / 16), up
// to 512 threads a CTA and 4 rows a thread (N <= 32,768). Each CTA loads
// its rows' state into shared memory once a launch, struct of arrays so a
// warp's loads are contiguous: alloc [R], used [R], nz_used [2],
// pod_count, max_pods and a flag byte (node_ok && valid, memory
// pressure); with the nominated overlay its reservations [R] and count;
// with spread groups the CTA's [G, Nl] slice of the counts where it fits
// (else they stay in global memory). The committed state goes back at the
// end. The pods' scalars are staged 64 at a time; a pod's rows read only
// its mask and static score rows from L2, and those of the next pod load
// while the cluster waits at the exchange. Per pod, in one_pod's order:
//   1. every thread's rows: feasibility from shared memory (the nominee's
//      own row exempt, ktpu_pod_fits' `self`), the topology refusal and
//      the soft raw score (affinity.cuh, the counters in global memory);
//   2. with spread groups or soft credits, one exchange of the CTAs'
//      partials (cluster_xchg.cuh's st.async into every CTA, an mbarrier
//      a slot array, two arrays alternating by pod parity): each warp's
//      max count, zone presence and soft min / max folded by shuffles,
//      its integer zone counts added into a row of the warp's own (one
//      shared atomic a row; a count that is not a small integer adds to
//      a float partial of its own), one block barrier, then warp 0
//      publishes the CTA's [4 + Z] words to every
//      CTA; every warp folds the 16 partials (zone sums in rank order:
//      integer-valued, exact in any order below 2^24) and lane z holds
//      KTPU_ZONE_WEIGHT times zone z's score (Z <= 32);
//   3. score = base + soft + spread (or + 0.0), the tie-penalized first
//      max over the thread's rows, the warp's fold by shuffles and one
//      exchange of candidates; every warp folds the cluster's candidates
//      with one comparator (ties by float ==, then the lowest row): the
//      same winner everywhere, the chosen score the owner's masked value;
//   4. the thread that owns the winner row applies its used / nz_used /
//      pod_count / spread columns in shared memory (okf-weighted, as the
//      reference adds 0 * req for a pod that does not place) and, with
//      topology counters or soft credits, their writes in k order, then
//      the pod ends on a cluster barrier that publishes them before any
//      CTA's next row pass; CTA 0's thread 0 writes the packed results.
// Only the thread that owns a row reads or writes its state, so no block
// barrier guards the update.
//
// Bound: the dependency chain from one pod to the next. A pod's chain:
// the row pass (one row a thread at N = 8,192), a warp's shuffle fold,
// the distributed stores, the wait for the slowest warp's, the fold of 256
// candidates and the owner's update; spread and soft add a block barrier
// and a second exchange, topology and soft a cluster barrier.
#include <cooperative_groups.h>

#include "pod.cuh"
#include "pod_scan.cuh"
#include "prof.cuh"
#include "cluster_xchg.cuh"

#define KTPU_POD_CLUSTER 16
#define KTPU_POD_CTHREADS 512   // threads a CTA at most
#define KTPU_POD_RPT 4          // rows a thread at most: N <= 32,768
#define KTPU_POD_CHUNK 64       // pods staged in shared memory at once
// dynamic shared memory a CTA may take for its rows' state
#define KTPU_POD_SMEM_LIMIT (200 * 1024)

// a row's flag byte
#define KTPU_ROW_OK 1u   // node_ok && valid
#define KTPU_ROW_MP 2u   // mem_pressure

// a pod's scalars, staged a chunk at a time
struct KtpuPodScal {
  int mask_idx, score_idx, nom_row, soft_base, gidx;
  uint32_t seq_term;
  float nz0, nz1;
  float m0;    // spread_match of group 0 (the owner's update reads it)
  int flags;   // 1 blocked, 2 active
};

// the CTA's shared-memory layout for Nl rows of R columns, in this order:
// alloc [R, Nl], used [R, Nl], nz [2, Nl], cnt [Nl], maxp [Nl], with NOM
// nom used [R, Nl] and nom count [Nl], with held spread counts [G, Nl]
// (f32), then flags [Nl] (u8)
__host__ __device__ __forceinline__ size_t ktpu_pod_cluster_smem_bytes(
    int Nl, int R, int G, bool nom, bool hold_spread) {
  size_t words = (size_t)Nl * (2 * (size_t)R + 4);
  if (nom) words += (size_t)Nl * ((size_t)R + 1);
  if (hold_spread) words += (size_t)Nl * (size_t)G;
  return words * sizeof(float) + (((size_t)Nl + 15) & ~(size_t)15);
}

// _pod_feasible at the local row i of the CTA's state (column j of row i
// at j * Nl + i): ktpu_pod_fits_ex's arithmetic, in its order, the
// exemption the pod's own request at its own nominated row (`self`)
template <bool NOM>
__device__ __forceinline__ bool ktpu_pod_fits_soa(
    const float* s_alloc, const float* s_used, const float* s_nomu,
    float cnt, float nom_cnt, float maxp, uint32_t fl, int i, int Nl,
    int R, const float* req, bool blocked, bool mask, bool self) {
  if (!(mask && (fl & KTPU_ROW_OK))) return false;
  if (blocked && (fl & KTPU_ROW_MP)) return false;
  float c = cnt;
  if (NOM) c = __fsub_rn(__fadd_rn(cnt, nom_cnt), self ? 1.0f : 0.0f);
  if (!(__fadd_rn(c, 1.0f) <= maxp)) return false;
  for (int j = 0; j < R; ++j) {
    float eff = s_used[(size_t)j * Nl + i];
    if (NOM)
      eff = __fsub_rn(__fadd_rn(eff, s_nomu[(size_t)j * Nl + i]),
                      self ? req[j] : 0.0f);
    if (!(__fadd_rn(req[j], eff) <= s_alloc[(size_t)j * Nl + i]))
      return false;
  }
  return true;
}

template <bool SPREAD, bool TOPO, bool SOFT, bool NOM, bool PROF>
__global__ void __launch_bounds__(KTPU_POD_CTHREADS, 1)
ktpu_pod_cluster_kernel(KtpuPodScanArgs a, int Nl, int hold) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float psm[];
  constexpr bool PART = SPREAD || SOFT;
  const int R = a.R, N = a.N, P = a.P, G = a.G, Z = a.Z;
  const bool held = SPREAD && hold != 0;
  float* s_alloc = psm;
  float* s_used = s_alloc + (size_t)R * Nl;
  float* s_nz = s_used + (size_t)R * Nl;
  float* s_cnt = s_nz + 2 * (size_t)Nl;
  float* s_maxp = s_cnt + Nl;
  float* s_nomu = s_maxp + Nl;
  float* s_nomc = s_nomu + (NOM ? (size_t)R * Nl : 0);
  float* s_spr = s_nomc + (NOM ? Nl : 0);
  uint8_t* s_fl = (uint8_t*)(s_spr + (held ? (size_t)G * Nl : 0));
  // candidates [0, 1] and partials [2, 3], by pod parity
  __shared__ __align__(8) uint64_t s_mbar[4];
  __shared__ __align__(16) KtpuCand s_cand[2][KTPU_POD_CLUSTER *
                                              KTPU_XCHG_WARPS];
  __shared__ __align__(16) float s_part[PART ? 2 : 1]
                                       [KTPU_POD_CLUSTER][KTPU_PART_WORDS];
  __shared__ KtpuPartScratch ps;
  __shared__ KtpuPodScal s_pod[2][KTPU_POD_CHUNK];
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int NT = blockDim.x;
  const int nwarps = NT >> 5;
  const int r0 = rank * Nl;
  const int nloc = max(0, min(Nl, N - r0));
  // the row slots a thread of this CTA may hold (CTA-uniform)
  const int kmax = (nloc + NT - 1) / NT;
  const float rw0 = a.rw[0], rw1 = a.rw[1];
  const float inf = __int_as_float(0x7f800000);
  const float sw = SPREAD ? a.spread_w[0] : 0.0f;
  const float soft_w = SOFT ? a.soft.weight[0] : 0.0f;
  const float zp_none = __fmul_rn(KTPU_ZONE_WEIGHT, KTPU_MAX_PRIORITY);
  // the counts of group g at local row i: cnt_base[g * cnt_stride + i]
  float* cnt_base = held ? s_spr : a.spread + r0;
  const size_t cnt_stride = held ? (size_t)Nl : (size_t)N;

  // ---- the rows' state into shared memory, once a launch
  for (int i = tid; i < nloc; i += NT) {
    const int r = r0 + i;
    for (int j = 0; j < R; ++j) {
      s_alloc[(size_t)j * Nl + i] = a.cfg.alloc[(size_t)r * R + j];
      s_used[(size_t)j * Nl + i] = a.used[(size_t)r * R + j];
      if (NOM) s_nomu[(size_t)j * Nl + i] = a.nom_used[(size_t)r * R + j];
    }
    s_nz[i] = a.nz_used[2 * (size_t)r];
    s_nz[Nl + i] = a.nz_used[2 * (size_t)r + 1];
    s_cnt[i] = a.pod_count[r];
    s_maxp[i] = a.cfg.max_pods[r];
    if (NOM) s_nomc[i] = a.nom_count[r];
    if (held)
      for (int g = 0; g < G; ++g)
        s_spr[(size_t)g * Nl + i] = a.spread[(size_t)g * N + r];
    s_fl[i] = (uint8_t)(
        ((a.cfg.node_ok[r] && a.cfg.valid[r]) ? KTPU_ROW_OK : 0u) |
        (a.cfg.mem_pressure[r] ? KTPU_ROW_MP : 0u));
  }
  // a row's zone, clamped to [0, Z) (Z <= 32), bit 14 set when the id is
  // below Z, bit 15 when it is named (> 0)
  uint32_t zk[SPREAD ? KTPU_POD_RPT : 1];
  float zinit_lane = 0.0f;
  if constexpr (SPREAD) {
#pragma unroll
    for (int k = 0; k < KTPU_POD_RPT; ++k) {
      const int i = tid + k * NT;
      uint32_t code = 0u;
      if (i < nloc) {
        const int z = a.zone_of[r0 + i];
        code = ktpu_zone_code(z, Z);
      }
      zk[k] = code;
    }
    if (lane < Z) zinit_lane = a.zinit[lane];
  }
  if (tid == 0) ktpu_xchg_init(s_mbar, 4);
  // every CTA runs, its state loaded and its mbarriers ready, before any
  // reaches another's shared memory
  ktpu_cluster_sync();
  unsigned mph = 0u, pph = 0u;   // the arrays' next phase parities
  const unsigned cand_bytes = ktpu_xchg_cand_bytes(KTPU_POD_CLUSTER,
                                                   nwarps);

  // the next pod's rows, loaded before the exchange wait; the mask as its
  // raw byte, so nothing waits for a load until it is used
  bool pf_ok = false;
  unsigned pf_m[KTPU_POD_RPT];
  float pf_s[KTPU_POD_RPT];

  // stage the pods of chunk c into buffer c & 1
  auto stage = [&](int c) {
    for (int i = tid; i < KTPU_POD_CHUNK; i += NT) {
      const int p = c * KTPU_POD_CHUNK + i;
      if (p >= P) break;
      KtpuPodScal s;
      s.mask_idx = a.mask_idx[p];
      s.score_idx = a.score_idx[p];
      s.nom_row = NOM ? a.nom_row[p] : -1;
      s.soft_base = SOFT ? a.soft.base_idx[p] : -1;
      s.gidx = SPREAD ? a.spread_gidx[p] : -1;
      s.seq_term = (uint32_t)a.seq[p] * 40503u;
      s.nz0 = a.nz_req[2 * (size_t)p];
      s.nz1 = a.nz_req[2 * (size_t)p + 1];
      s.m0 = (SPREAD && G > 0) ? a.spread_match[(size_t)p * G] : 0.0f;
      s.flags = (a.blocked[p] ? 1 : 0) | (a.active[p] ? 2 : 0);
      s_pod[c & 1][i] = s;
    }
  };
  // load pod s's table values at this thread's rows
  auto load_rows = [&](const KtpuPodScal& s) {
    const unsigned char* mask =
        (const unsigned char*)a.unique_masks + (size_t)s.mask_idx * N;
    const float* stat = a.unique_scores + (size_t)s.score_idx * N;
#pragma unroll
    for (int k = 0; k < KTPU_POD_RPT; ++k) {
      const int i = tid + k * NT;
      if (i < nloc) {
        pf_m[k] = mask[r0 + i];
        pf_s[k] = stat[r0 + i];
      }
    }
  };

  stage(0);
  __syncthreads();
  for (int p = 0; p < P; ++p) {
    if (PROF && rank == 0 && tid == 0)
      ktpu_prof_stamp(a.prof, a.prof_every, p, 0);
    const KtpuPodScal s = s_pod[(p / KTPU_POD_CHUNK) & 1]
                               [p % KTPU_POD_CHUNK];
    if (!pf_ok) load_rows(s);
    pf_ok = false;
    const float* req = a.req + (size_t)p * R;
    const bool blocked = (s.flags & 1) != 0;
    const int nr = s.nom_row;
    const int par = p & 1;
    if (PROF && rank == 0 && tid == 0)
      ktpu_prof_stamp(a.prof, a.prof_every, p, 1,
                      __float_as_int(pf_s[0]) + (int)pf_m[0]);

    // ---- 1. feasibility, topology, soft raw at this thread's rows
    bool fit_k[KTPU_POD_RPT];
    float raw_k[SOFT ? KTPU_POD_RPT : 1];
#pragma unroll
    for (int k = 0; k < KTPU_POD_RPT; ++k) {
      if (k >= kmax) break;   // no row of the CTA at this slot
      const int i = tid + k * NT;
      fit_k[k] = false;
      if constexpr (SOFT) raw_k[k] = 0.0f;
      if (i >= nloc) continue;
      const int r = r0 + i;
      // rows never equal an out-of-range nominated row, as in the
      // reference
      bool f = ktpu_pod_fits_soa<NOM>(
          s_alloc, s_used, s_nomu, s_cnt[i], NOM ? s_nomc[i] : 0.0f,
          s_maxp[i], s_fl[i], i, Nl, R, req, blocked, pf_m[k] != 0u,
          NOM && r == nr);
      if (TOPO) f = f && !ktpu_topo_bad(a.topo, p, r, N);
      fit_k[k] = f;
      if constexpr (SOFT) {
        if (f) raw_k[k] = ktpu_soft_raw(a.soft, p, r, N);
      }
    }

    // ---- 2. the reductions over the cluster's feasible rows
    KtpuPartials pt{0.0f, false, inf, -inf, 0.0f, 0.0f};
    float zp_lane = 0.0f;   // lane z: KTPU_ZONE_WEIGHT x zone z's score
    float cnt_k[SPREAD ? KTPU_POD_RPT : 1];
    const int gc = s.gidx > 0 ? s.gidx : 0;
    if constexpr (PART) {
      float lmax = 0.0f, lmn = inf, lmx = -inf;
      int lhz = 0;
      if constexpr (SPREAD) ktpu_zone_reset(ps, warp, lane);
#pragma unroll
      for (int k = 0; k < KTPU_POD_RPT; ++k) {
        if (k >= kmax) break;   // no row of the CTA at this slot
        if constexpr (SPREAD) {
          const int i = tid + k * NT;
          const float c = i < nloc ? cnt_base[(size_t)gc * cnt_stride + i]
                                   : 0.0f;
          cnt_k[k] = c;
          const float cf = fit_k[k] ? c : 0.0f;
          lmax = fmaxf(lmax, cf);
          if (fit_k[k] && (zk[k] & 0x8000u) != 0u) lhz = 1;
          ktpu_zone_add(ps, warp, zk[k], cf);
        }
        if constexpr (SOFT) {
          if (fit_k[k]) {
            lmn = fminf(lmn, raw_k[k]);
            lmx = fmaxf(lmx, raw_k[k]);
          }
        }
      }
      if (PROF && rank == 0 && tid == 0)
        ktpu_prof_stamp(a.prof, a.prof_every, p, 2);
      pt = ktpu_xchg_partials<SPREAD>(ps, s_part[par], &s_mbar[2 + par],
                                      par, pph, rank, KTPU_POD_CLUSTER, Z,
                                      zinit_lane, lmax, lhz, lmn, lmx);
      if (SPREAD && lane < Z)
        zp_lane = ktpu_spread_zone_part(pt.zsum, pt.maxz);
    }
    const float maxc = pt.maxc, mn = pt.mn, mx = pt.mx;
    const bool have_zones = pt.have_zones;
    if (PROF && !PART && rank == 0 && tid == 0)
      ktpu_prof_stamp(a.prof, a.prof_every, p, 2);
    if (PROF && rank == 0 && tid == 0)
      ktpu_prof_stamp(a.prof, a.prof_every, p, 3, __float_as_int(maxc));

    // ---- 3. the tie-penalized first max over this thread's rows
    const float sw_use =
        SPREAD ? __fmul_rn(sw, s.gidx >= 0 ? 1.0f : 0.0f) : 0.0f;
    const bool soft_use = SOFT && s.soft_base >= 0;
    float bpen = -inf, bval = KTPU_NEG;
    int brow = 0x7fffffff, baux = 0;
#pragma unroll
    for (int k = 0; k < KTPU_POD_RPT; ++k) {
      if (k >= kmax) break;   // no row of the CTA at this slot
      const int i = tid + k * NT;
      float zpart = zp_none;
      if constexpr (SPREAD) {
        // every lane takes part in the shuffle, rows or not
        const uint32_t code = zk[k];
        const float zt = __shfl_sync(0xffffffffu, zp_lane,
                                     (int)(code & 0x3FFFu) & 31);
        if ((code & 0x8000u) != 0u) zpart = zt;
      }
      if (i >= nloc) continue;
      const int r = r0 + i;
      float masked = KTPU_NEG;
      if (fit_k[k]) {
        float score = __fadd_rn(
            ktpu_resource_score(s_alloc[i], s_alloc[(size_t)Nl + i],
                                __fadd_rn(s_nz[i], s.nz0),
                                __fadd_rn(s_nz[Nl + i], s.nz1), rw0, rw1),
            pf_s[k]);
        if constexpr (SOFT)
          score = __fadd_rn(score, ktpu_soft_term(raw_k[k], mn, mx,
                                                  soft_use, soft_w));
        if constexpr (SPREAD)
          score = __fadd_rn(score, __fmul_rn(sw_use, ktpu_spread_blend(
              ktpu_spread_node_part(cnt_k[k], maxc), zpart, have_zones)));
        else
          score = __fadd_rn(score, 0.0f);
        masked = score;
      }
      const float pen = ktpu_tie_penalized(masked, r, s.seq_term);
      if (pen > bpen) {  // rows ascend: strict > keeps the first max
        bpen = pen;
        brow = r;
        bval = masked;
      }
    }
    ktpu_warp_argmax(bpen, brow, bval, baux);
    if (PROF && rank == 0 && tid == 0)
      ktpu_prof_stamp(a.prof, a.prof_every, p, 4);
    ktpu_xchg_publish(s_cand[par], &s_mbar[par], rank, warp, lane,
                      KTPU_POD_CLUSTER, bpen, bval, brow, baux);
    if (tid == 0) ktpu_mbar_expect(&s_mbar[par], cand_bytes);
    // the next chunk's pods, then the next pod's rows, while the other
    // CTAs arrive
    const int pn = p + 1;
    if (pn < P && pn % KTPU_POD_CHUNK == 0) {
      stage(pn / KTPU_POD_CHUNK);
      __syncthreads();
    }
    if (pn < P) {
      load_rows(s_pod[(pn / KTPU_POD_CHUNK) & 1][pn % KTPU_POD_CHUNK]);
      pf_ok = true;
    }
    if (PROF && rank == 0 && tid == 0)
      ktpu_prof_stamp(a.prof, a.prof_every, p, 5);
    ktpu_xchg_wait(&s_mbar[par], par, mph);
    __syncwarp();
    if (PROF && rank == 0 && tid == 0)
      ktpu_prof_stamp(a.prof, a.prof_every, p, 6);
    const KtpuCand win = ktpu_xchg_fold(s_cand[par], KTPU_POD_CLUSTER,
                                        nwarps, lane);
    const int best = win.row;
    const float chosen = win.val;
    // fits[best] & active: a feasible row's masked score is its score,
    // far above the threshold; an infeasible one's is NEG
    const bool ok = chosen > KTPU_NEG_THRESHOLD && (s.flags & 2) != 0;
    const float okf = ok ? 1.0f : 0.0f;

    // ---- 4. the winner's columns (added even when !ok, as 0 * req) and
    // its counter writes, by the thread that owns its row
    const int ib = best - r0;
    if (ib >= 0 && ib < nloc && ib % NT == tid) {
      for (int j = 0; j < R; ++j) {
        float* x = s_used + (size_t)j * Nl + ib;
        *x = __fadd_rn(*x, __fmul_rn(okf, req[j]));
      }
      s_nz[ib] = __fadd_rn(s_nz[ib], __fmul_rn(okf, s.nz0));
      s_nz[Nl + ib] = __fadd_rn(s_nz[Nl + ib], __fmul_rn(okf, s.nz1));
      s_cnt[ib] = __fadd_rn(s_cnt[ib], okf);
      if (SPREAD)
        for (int g = 0; g < G; ++g) {
          float* x = cnt_base + (size_t)g * cnt_stride + ib;
          *x = __fadd_rn(*x, __fmul_rn(
              g == 0 ? s.m0 : a.spread_match[(size_t)p * G + g], okf));
        }
      // every CTA read the counters before the exchange
      if (TOPO) ktpu_topo_scatter(a.topo, p, best, N, ok);
      if (SOFT) ktpu_soft_write(a.soft, p, best, N, ok);
    }
    if (rank == 0 && tid == 0) {
      a.packed[p] = ok ? best : -1;
      a.packed[P + p] = __float_as_int(chosen);
    }
    // the counter writes before any CTA reads them again
    if (TOPO || SOFT) ktpu_cluster_sync();
    if (PROF && rank == 0 && tid == 0)
      ktpu_prof_stamp(a.prof, a.prof_every, p, 7, best + (ok ? 1 : 0));
  }

  // ---- the committed state back to global memory
  for (int i = tid; i < nloc; i += NT) {
    const int r = r0 + i;
    for (int j = 0; j < R; ++j)
      a.used[(size_t)r * R + j] = s_used[(size_t)j * Nl + i];
    a.nz_used[2 * (size_t)r] = s_nz[i];
    a.nz_used[2 * (size_t)r + 1] = s_nz[Nl + i];
    a.pod_count[r] = s_cnt[i];
    if (held)
      for (int g = 0; g < G; ++g)
        a.spread[(size_t)g * N + r] = s_spr[(size_t)g * Nl + i];
  }
  // no CTA leaves while another may still write its shared memory
  ktpu_cluster_sync();
}

// ---------------------------------------------------------- launchers

template <bool SPREAD, bool TOPO, bool SOFT, bool NOM, bool PROF = false>
static cudaError_t ktpu_launch_pod_cluster(const KtpuPodScanArgs& a,
                                           int Nl, int hold, int threads,
                                           size_t smem,
                                           cudaStream_t stream) {
  auto kern = ktpu_pod_cluster_kernel<SPREAD, TOPO, SOFT, NOM, PROF>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(KTPU_POD_CLUSTER, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = KTPU_POD_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, a, Nl, hold);
}

template <bool NOM>
static cudaError_t ktpu_launch_pod_cluster_terms(
    int terms, const KtpuPodScanArgs& a, int Nl, int hold, int threads,
    size_t smem, cudaStream_t s) {
  switch (terms) {
    case 0: return ktpu_launch_pod_cluster<false, false, false, NOM>(a, Nl, hold, threads, smem, s);
    case 1: return ktpu_launch_pod_cluster<false, false, true, NOM>(a, Nl, hold, threads, smem, s);
    case 2: return ktpu_launch_pod_cluster<false, true, false, NOM>(a, Nl, hold, threads, smem, s);
    case 3: return ktpu_launch_pod_cluster<false, true, true, NOM>(a, Nl, hold, threads, smem, s);
    case 4: return ktpu_launch_pod_cluster<true, false, false, NOM>(a, Nl, hold, threads, smem, s);
    case 5: return ktpu_launch_pod_cluster<true, false, true, NOM>(a, Nl, hold, threads, smem, s);
    case 6: return ktpu_launch_pod_cluster<true, true, false, NOM>(a, Nl, hold, threads, smem, s);
    default: return ktpu_launch_pod_cluster<true, true, true, NOM>(a, Nl, hold, threads, smem, s);
  }
}

// the cluster design (kernels/batch.py pod_scan_design picks it where the
// rows' state fits); it refuses a batch it does not take
extern "C" int ktpu_pod_scan_cluster(const KtpuPodScanParams* h,
                                     void* stream) {
  const KtpuPodScanArgs a = ktpu_pod_scan_args(h);
  const bool spread = h->has_spread != 0;
  const bool nom = h->has_nom != 0;
  if (a.N < 1 || a.R < 2 || a.R > KTPU_MAX_R ||
      (spread && (a.Z < 1 || a.Z > KTPU_XCHG_ZONES)))
    return (int)cudaErrorInvalidValue;
  const int Nl = (a.N + KTPU_POD_CLUSTER - 1) / KTPU_POD_CLUSTER;
  int threads = (Nl + 31) / 32 * 32;
  if (threads > KTPU_POD_CTHREADS) threads = KTPU_POD_CTHREADS;
  if (Nl > threads * KTPU_POD_RPT ||
      ktpu_pod_cluster_smem_bytes(Nl, a.R, a.G, nom, false) >
          KTPU_POD_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const int hold = spread && ktpu_pod_cluster_smem_bytes(
                                 Nl, a.R, a.G, nom, true) <=
                                 KTPU_POD_SMEM_LIMIT;
  const size_t smem = ktpu_pod_cluster_smem_bytes(Nl, a.R, a.G, nom, hold);
  cudaStream_t s = (cudaStream_t)stream;
  const int terms = ktpu_pod_terms(h);
  cudaError_t err;
  if (h->prof != nullptr) {
    if (!ktpu_pod_prof_ok(h)) return (int)cudaErrorInvalidValue;
    err = terms == 4
        ? ktpu_launch_pod_cluster<true, false, false, false, true>(
              a, Nl, hold, threads, smem, s)
        : ktpu_launch_pod_cluster<false, false, false, false, true>(
              a, Nl, hold, threads, smem, s);
  } else {
    err = nom ? ktpu_launch_pod_cluster_terms<true>(terms, a, Nl, hold,
                                                    threads, smem, s)
              : ktpu_launch_pod_cluster_terms<false>(terms, a, Nl, hold,
                                                     threads, smem, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
