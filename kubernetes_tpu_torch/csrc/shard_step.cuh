// One pod's step of the class scan over a thread-block cluster whose CTAs
// each hold a slice of the rows' state in shared memory: K15's shared
// design (shard_scan_shared.cu, one shard of k CTAs of the cluster per
// node shard) and the repair of K12's cluster design
// (spec_scan_cluster.cu, one shard of 16 CTAs) both run it, so the two
// cannot drift. shard_scan_shared.cu has the step's notes.
//
// A CTA of shard s holds the rows [r0, r0 + nloc), r0 = s * N / D + j *
// Nc for its place j in the shard, in shared memory for the whole launch:
// its [C, Nc] slice of the table, the class constants (req [C, R], nz
// [C, 2], mask and score rows, blocked), its rows' used [R, Nc], nz_used
// [2, Nc] and pod_count [Nc], and with spread groups its [G, Nc] slice of
// the counts where it fits (ktpu_shard_load, ktpu_shard_store). Per pod,
// in every CTA, in the reference's order (K2's arithmetic, class_step.cuh
// and score.cuh, at GLOBAL row ids): the row-local work; (SPREAD or SOFT)
// the exchange of the CTAs' partials; the tie-penalized first max over
// each warp's rows and the exchange of the warps' candidates; the fold,
// and the winning warp's update and refresh; (TOPO or SOFT) a cluster
// barrier before any CTA's next row pass.
#pragma once

#include <cooperative_groups.h>

#include "shard_scan.cuh"
#include "cluster_xchg.cuh"

#define KTPU_SSH_CLUSTER 16    // CTAs of the cluster at most
#define KTPU_SSH_THREADS 512   // threads a CTA at most
#define KTPU_SSH_RPT 4         // rows a thread at most

// the CTA's dynamic shared memory in 4-byte words for Nc rows: the table
// slice [C, Nc], req [C, R], nz [C, 2], used [R, Nc], nz_used [2, Nc],
// pod_count [Nc], the held spread counts [G, Nc], then mask_idx and
// score_idx [C] (int) and blocked [C] (bytes, rounded up to words)
__host__ __device__ __forceinline__ size_t ktpu_shard_smem_words(
    int C, int Nc, int R, int G, bool hold_spread) {
  size_t w = (size_t)C * Nc + (size_t)C * (R + 4) + ((size_t)C + 3) / 4 +
             ((size_t)R + 3) * Nc;
  if (hold_spread) w += (size_t)G * Nc;
  return w;
}

// the step's exchange state, static shared memory of the kernel:
// candidates [0, 1] and partials [2, 3] mbarriers, by pod parity
struct __align__(16) KtpuShardXchg {
  uint64_t mbar[4];
  KtpuCand cand[2][KTPU_SSH_CLUSTER * KTPU_XCHG_WARPS];
  float part[2][KTPU_SSH_CLUSTER][KTPU_PART_WORDS];
  KtpuPartScratch ps;
  // the nominee's own row less its request (its owner thread's)
  float self[KTPU_MAX_R];
  // the winner's usage after the update (+ reservations with NOM) and its
  // allocatable, from the winning warp's lanes to its refresh lanes
  float use[KTPU_MAX_R];
  float alw[KTPU_MAX_R];
};

// a CTA's slice and the step's loop invariants
template <bool SPREAD>
struct KtpuShardCtx {
  float *ms, *creq, *cnz, *used, *nz, *cnt, *spr;
  int *cmi, *csi;
  bool* cblk;
  // the counts of group g at local row i: cnt_base[g * cnt_stride + i]
  float* cnt_base;
  size_t cnt_stride;
  KtpuClasses cl;
  KtpuStepConst kc;
  int Nc, r0, nloc, kmax, rank, nctas;
  bool held;
  uint32_t zk[SPREAD ? KTPU_SSH_RPT : 1];
  float zinit_lane;
  unsigned cand_bytes;
  unsigned mph, pph;   // the exchange arrays' next phase parities
};

// The CTA's slice of shard `shard`, place `jc` in it (Ns rows a shard, Nc
// a CTA), laid out in the dynamic shared memory `ssm`, its state loaded,
// the exchange's mbarriers initialised; the caller then takes a cluster
// barrier before any CTA reaches another's shared memory.
template <bool SPREAD, bool SOFT>
__device__ __forceinline__ void ktpu_shard_load(const KtpuScanArgs& a,
                                                KtpuShardCtx<SPREAD>& x,
                                                KtpuShardXchg& xs,
                                                float* ssm, int shard,
                                                int jc, int Ns, int Nc,
                                                int rank, int nctas,
                                                int hold) {
  const int N = a.N, R = a.R, C = a.C, G = a.G, Z = a.Z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int NT = blockDim.x;
  x.held = SPREAD && hold != 0;
  x.ms = ssm;
  x.creq = x.ms + (size_t)C * Nc;
  x.cnz = x.creq + (size_t)C * R;
  x.used = x.cnz + 2 * (size_t)C;
  x.nz = x.used + (size_t)R * Nc;
  x.cnt = x.nz + 2 * (size_t)Nc;
  x.spr = x.cnt + Nc;
  x.cmi = (int*)(x.spr + (x.held ? (size_t)G * Nc : 0));
  x.csi = x.cmi + C;
  x.cblk = (bool*)(x.csi + C);
  x.Nc = Nc;
  x.rank = rank;
  x.nctas = nctas;
  x.r0 = shard * Ns + jc * Nc;
  x.nloc = max(0, min(Nc, Ns - jc * Nc));
  // the row slots a thread of this CTA may hold (CTA-uniform)
  x.kmax = (x.nloc + NT - 1) / NT;
  x.kc = ktpu_step_const<SPREAD, SOFT>(a);
  x.cnt_base = x.held ? x.spr : a.spread + x.r0;
  x.cnt_stride = x.held ? (size_t)Nc : (size_t)N;
  x.cand_bytes = ktpu_xchg_cand_bytes(nctas, NT >> 5);
  x.mph = 0u;
  x.pph = 0u;
  const int r0 = x.r0, nloc = x.nloc;
  for (int c = 0; c < C; ++c)
    for (int i = tid; i < nloc; i += NT)
      x.ms[(size_t)c * Nc + i] = a.ms[(size_t)c * N + r0 + i];
  for (int i = tid; i < C * R; i += NT) x.creq[i] = a.cl.req[i];
  for (int i = tid; i < 2 * C; i += NT) x.cnz[i] = a.cl.nz[i];
  for (int i = tid; i < C; i += NT) {
    x.cmi[i] = a.cl.mask_idx[i];
    x.csi[i] = a.cl.score_idx[i];
    x.cblk[i] = a.cl.blocked[i];
  }
  for (int i = tid; i < nloc; i += NT) {
    const int r = r0 + i;
    for (int j = 0; j < R; ++j)
      x.used[(size_t)j * Nc + i] = a.used[(size_t)r * R + j];
    x.nz[i] = a.nz_used[2 * (size_t)r];
    x.nz[Nc + i] = a.nz_used[2 * (size_t)r + 1];
    x.cnt[i] = a.pod_count[r];
    if (x.held)
      for (int g = 0; g < G; ++g)
        x.spr[(size_t)g * Nc + i] = a.spread[(size_t)g * N + r];
  }
  x.cl = KtpuClasses{x.creq, x.cnz, x.cblk, x.cmi, x.csi,
                     a.cl.unique_masks, a.cl.unique_scores, C};
  x.zinit_lane = 0.0f;
  if constexpr (SPREAD) {
#pragma unroll
    for (int k = 0; k < KTPU_SSH_RPT; ++k) {
      const int i = tid + k * NT;
      x.zk[k] = i < nloc ? ktpu_zone_code(a.zone_of[r0 + i], Z) : 0u;
    }
    if (lane < Z) x.zinit_lane = a.zinit[lane];
  }
  if (tid == 0) ktpu_xchg_init(xs.mbar, 4);
}

// the slice, the usage and the held counts back (all in/out)
template <bool SPREAD>
__device__ __forceinline__ void ktpu_shard_store(const KtpuScanArgs& a,
                                                 const KtpuShardCtx<SPREAD>& x) {
  const int N = a.N, R = a.R, C = a.C, G = a.G;
  const int tid = threadIdx.x, NT = blockDim.x;
  const int Nc = x.Nc, r0 = x.r0, nloc = x.nloc;
  for (int c = 0; c < C; ++c)
    for (int i = tid; i < nloc; i += NT)
      a.ms[(size_t)c * N + r0 + i] = x.ms[(size_t)c * Nc + i];
  for (int i = tid; i < nloc; i += NT) {
    const int r = r0 + i;
    for (int j = 0; j < R; ++j)
      a.used[(size_t)r * R + j] = x.used[(size_t)j * Nc + i];
    a.nz_used[2 * (size_t)r] = x.nz[i];
    a.nz_used[2 * (size_t)r + 1] = x.nz[Nc + i];
    a.pod_count[r] = x.cnt[i];
    if (x.held)
      for (int g = 0; g < G; ++g)
        a.spread[(size_t)g * N + r] = x.spr[(size_t)g * Nc + i];
  }
}

// a step's work while the cluster's candidates arrive: none
struct KtpuNoOverlap {
  __device__ __forceinline__ void operator()(int) const {}
};

// Pod p's step (its scalars s; m0, its spread_match of group 0). Every
// thread of every CTA of the cluster calls it for the same pod. `overlap`
// (p) runs after the warp's candidate is published and before the wait
// for the cluster's (K15 stages its next chunk of pods there); with PROF,
// thread 0 of CTA 0 stamps the step's phases.
template <bool SPREAD, bool TOPO, bool SOFT, bool NOM, bool PROF,
          typename Overlap>
__device__ __forceinline__ void ktpu_shard_pod_step(
    const KtpuScanArgs& a, KtpuShardCtx<SPREAD>& x, KtpuShardXchg& xs,
    int p, const KtpuPodIn s, float m0, const Overlap& overlap) {
  constexpr bool PART = SPREAD || SOFT;
  const int N = a.N, R = a.R, C = a.C, P = a.P, G = a.G, Z = a.Z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int NT = blockDim.x;
  const int nwarps = NT >> 5;
  const int Nc = x.Nc, r0 = x.r0, nloc = x.nloc, kmax = x.kmax;
  const int rank = x.rank, nctas = x.nctas;
  const float rw0 = x.kc.rw0, rw1 = x.kc.rw1;
  const float inf = __int_as_float(0x7f800000);
  const float zp_none = __fmul_rn(KTPU_ZONE_WEIGHT, KTPU_MAX_PRIORITY);
  const bool stamp = PROF && rank == 0 && tid == 0;
  float* const s_ms = x.ms;
  float* const s_creq = x.creq;
  float* const s_cnz = x.cnz;
  float* const s_used = x.used;
  float* const s_nz = x.nz;
  float* const s_cnt = x.cnt;
  const int* const s_cmi = x.cmi;
  const int* const s_csi = x.csi;
  const bool* const s_cblk = x.cblk;
  float* const cnt_base = x.cnt_base;
  const size_t cnt_stride = x.cnt_stride;
  const KtpuClasses& cl = x.cl;

  const int u = s.u;
  const float* ms_u = s_ms + (size_t)u * Nc;
  const int par = p & 1;
  // the self-exempt base of the pod's own nominated row, on the thread
  // of the owning CTA that owns the row (the only one that reads it)
  int nr = -1;
  float corr = 0.0f;
  if (NOM) {
    nr = s.nom_row < N ? s.nom_row : -1;
    const int il = nr - r0;
    if (nr >= 0 && il >= 0 && il < nloc && il % NT == tid) {
      for (int j = 0; j < R; ++j)
        xs.self[j] = __fsub_rn(
            __fadd_rn(s_used[(size_t)j * Nc + il],
                      a.nom_used[(size_t)nr * R + j]),
            s_creq[(size_t)u * R + j]);
      corr = ktpu_class_score(
          a.cfg, cl, rw0, rw1, u, nr, N, R, xs.self, s_nz[il],
          s_nz[Nc + il],
          __fsub_rn(__fadd_rn(s_cnt[il], a.nom_count[nr]), 1.0f));
    }
  }
  if (stamp)
    ktpu_prof_stamp(a.prof, a.prof_every, p, 1,
                    u + (int)s.seq_term + __float_as_int(corr));

  // ---- 1. the row-local work at this thread's rows
  bool fit_k[KTPU_SSH_RPT];
  float base_k[KTPU_SSH_RPT];
  float raw_k[SOFT ? KTPU_SSH_RPT : 1];
#pragma unroll
  for (int k = 0; k < KTPU_SSH_RPT; ++k) {
    if (k >= kmax) break;   // no row of the CTA at this slot
    const int i = tid + k * NT;
    fit_k[k] = false;
    base_k[k] = KTPU_NEG;
    if constexpr (SOFT) raw_k[k] = 0.0f;
    if (i >= nloc) continue;
    const int r = r0 + i;
    const float base = (NOM && r == nr) ? corr : ms_u[i];
    bool f = base > KTPU_NEG_THRESHOLD;
    if (TOPO) f = f && !ktpu_topo_bad(a.topo, p, r, N);
    base_k[k] = base;
    fit_k[k] = f;
    if constexpr (SOFT) {
      if (f) raw_k[k] = ktpu_soft_raw(a.soft, p, r, N);
    }
  }

  // ---- 2. the reductions over the cluster's feasible rows
  KtpuPartials pt{0.0f, false, inf, -inf, 0.0f, 0.0f};
  float zp_lane = 0.0f;   // lane z: KTPU_ZONE_WEIGHT x zone z's score
  float cnt_k[SPREAD ? KTPU_SSH_RPT : 1];
  const int gc = s.gidx > 0 ? s.gidx : 0;
  if constexpr (PART) {
    float lmax = 0.0f, lmn = inf, lmx = -inf;
    int lhz = 0;
    if constexpr (SPREAD) ktpu_zone_reset(xs.ps, warp, lane);
#pragma unroll
    for (int k = 0; k < KTPU_SSH_RPT; ++k) {
      if (k >= kmax) break;   // no row of the CTA at this slot
      if constexpr (SPREAD) {
        const int i = tid + k * NT;
        const float c = i < nloc ? cnt_base[(size_t)gc * cnt_stride + i]
                                 : 0.0f;
        cnt_k[k] = c;
        const float cf = fit_k[k] ? c : 0.0f;
        lmax = fmaxf(lmax, cf);
        if (fit_k[k] && (x.zk[k] & 0x8000u) != 0u) lhz = 1;
        ktpu_zone_add(xs.ps, warp, x.zk[k], cf);
      }
      if constexpr (SOFT) {
        if (fit_k[k]) {
          lmn = fminf(lmn, raw_k[k]);
          lmx = fmaxf(lmx, raw_k[k]);
        }
      }
    }
    if (stamp) ktpu_prof_stamp(a.prof, a.prof_every, p, 2);
    pt = ktpu_xchg_partials<SPREAD>(xs.ps, xs.part[par], &xs.mbar[2 + par],
                                    par, x.pph, rank, nctas, Z,
                                    x.zinit_lane, lmax, lhz, lmn, lmx);
    if (SPREAD && lane < Z)
      zp_lane = ktpu_spread_zone_part(pt.zsum, pt.maxz);
  }
  if (stamp && !PART) ktpu_prof_stamp(a.prof, a.prof_every, p, 2);
  if (stamp)
    ktpu_prof_stamp(a.prof, a.prof_every, p, 3, __float_as_int(pt.maxz));

  // ---- 3. the tie-penalized first max over this thread's rows
  const float sw_use =
      SPREAD ? __fmul_rn(x.kc.sw, s.gidx >= 0 ? 1.0f : 0.0f) : 0.0f;
  const bool soft_use = SOFT && s.soft_base >= 0;
  float bpen = -inf, bval = KTPU_NEG;
  int brow = 0x7fffffff, baux = 0;
#pragma unroll
  for (int k = 0; k < KTPU_SSH_RPT; ++k) {
    if (k >= kmax) break;   // no row of the CTA at this slot
    const int i = tid + k * NT;
    float zpart = zp_none;
    if constexpr (SPREAD) {
      // every lane takes part in the shuffle, rows or not
      const float zt = __shfl_sync(0xffffffffu, zp_lane,
                                   (int)(x.zk[k] & 0x3FFFu) & 31);
      if ((x.zk[k] & 0x8000u) != 0u) zpart = zt;
    }
    if (i >= nloc) continue;
    const int r = r0 + i;
    float score = base_k[k];
    if constexpr (SOFT)
      score = __fadd_rn(score, ktpu_soft_term(raw_k[k], pt.mn, pt.mx,
                                              soft_use, x.kc.soft_w));
    if constexpr (SPREAD)
      score = __fadd_rn(score, __fmul_rn(sw_use, ktpu_spread_blend(
          ktpu_spread_node_part(cnt_k[k], pt.maxc), zpart,
          pt.have_zones)));
    const float masked = fit_k[k] ? score : KTPU_NEG;
    const float pen = ktpu_tie_penalized(masked, r, s.seq_term);
    if (pen > bpen) {  // rows ascend: strict > keeps the first max
      bpen = pen;
      brow = r;
      bval = masked;
    }
  }
  ktpu_warp_argmax(bpen, brow, bval, baux);
  if (stamp) ktpu_prof_stamp(a.prof, a.prof_every, p, 4);
  ktpu_xchg_publish(xs.cand[par], &xs.mbar[par], rank, warp, lane, nctas,
                    bpen, bval, brow, baux);
  if (tid == 0) ktpu_mbar_expect(&xs.mbar[par], x.cand_bytes);
  // the warp's candidate row's values, loaded while the cluster
  // arrives: its allocatable (lane j: columns j and j + 32) and
  // reservations, counts, flags, and class c = lane's mask and static
  // score there
  const int cand = brow < N ? brow : 0;
  float sp_alloc[2] = {0.0f, 0.0f}, sp_nom[2] = {0.0f, 0.0f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h;
    if (j < R) {
      sp_alloc[h] = a.cfg.alloc[(size_t)cand * R + j];
      if (NOM) sp_nom[h] = a.nom_used[(size_t)cand * R + j];
    }
  }
  const float sp_nomc = NOM ? a.nom_count[cand] : 0.0f;
  const float sp_maxp = a.cfg.max_pods[cand];
  const bool sp_mp = a.cfg.mem_pressure[cand];
  const bool sp_ok = a.cfg.node_ok[cand] && a.cfg.valid[cand];
  bool sp_mask = false;
  float sp_stat = 0.0f;
  if (lane < C) {
    sp_mask = a.cl.unique_masks[(size_t)s_cmi[lane] * N + cand];
    sp_stat = a.cl.unique_scores[(size_t)s_csi[lane] * N + cand];
  }
  overlap(p);
  if (stamp) ktpu_prof_stamp(a.prof, a.prof_every, p, 5);
  ktpu_xchg_wait(&xs.mbar[par], par, x.mph);
  __syncwarp();
  if (stamp) ktpu_prof_stamp(a.prof, a.prof_every, p, 6);
  const KtpuCand win = ktpu_xchg_fold(xs.cand[par], nctas, nwarps, lane);
  const int best = win.row;
  const float chosen = win.val;
  const bool ok = chosen > KTPU_NEG_THRESHOLD && s.active;
  const float okf = ok ? 1.0f : 0.0f;

  // ---- 4. the winning warp: the winner's usage (added even when !ok,
  // as 0 * req), its spread columns and its column of the slice
  if (brow == best) {
    const int ib = best - r0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + 32 * h;
      if (j < R) {
        float* y = s_used + (size_t)j * Nc + ib;
        const float v =
            __fadd_rn(*y, __fmul_rn(okf, s_creq[(size_t)u * R + j]));
        *y = v;
        xs.use[j] = NOM ? __fadd_rn(v, sp_nom[h]) : v;
        xs.alw[j] = sp_alloc[h];
      }
    }
    const float nz0 = __fadd_rn(s_nz[ib], __fmul_rn(okf, s_cnz[2 * u]));
    const float nz1 =
        __fadd_rn(s_nz[Nc + ib], __fmul_rn(okf, s_cnz[2 * u + 1]));
    const float cnt = __fadd_rn(s_cnt[ib], okf);
    for (int g = lane; SPREAD && g < G; g += 32) {
      float* y = cnt_base + (size_t)g * cnt_stride + ib;
      *y = __fadd_rn(*y, __fmul_rn(
          g == 0 ? m0 : a.spread_match[(size_t)p * G + g], okf));
    }
    __syncwarp();   // every lane read the counts; use, alw written
    if (lane == 0) {
      s_nz[ib] = nz0;
      s_nz[Nc + ib] = nz1;
      s_cnt[ib] = cnt;
    }
    // the column, a class a lane a pass; class c's mask and static
    // score at the winner loaded a pass ahead (the first pass's before
    // the wait)
    const float cnt_eff = NOM ? __fadd_rn(cnt, sp_nomc) : cnt;
    bool m_c = sp_mask;
    float st_c = sp_stat;
    for (int c0 = 0; c0 < C; c0 += 32) {
      const int c = c0 + lane;
      const int cn = c + 32;
      bool m_n = false;
      float st_n = 0.0f;
      if (cn < C) {
        m_n = a.cl.unique_masks[(size_t)s_cmi[cn] * N + best];
        st_n = a.cl.unique_scores[(size_t)s_csi[cn] * N + best];
      }
      if (c < C)
        s_ms[(size_t)c * Nc + ib] = ktpu_class_score_at(
            s_creq + (size_t)c * R, s_cnz[2 * c], s_cnz[2 * c + 1],
            s_cblk[c], xs.alw, xs.use, nz0, nz1, cnt_eff, sp_maxp, sp_mp,
            sp_ok, m_c, st_c, rw0, rw1, R);
      m_c = m_n;
      st_c = st_n;
    }
    // every CTA read the counters before the exchange: one lane applies
    // the winner's writes, in pod and k order
    if (lane == 0) {
      if (TOPO) ktpu_topo_scatter(a.topo, p, best, N, ok);
      if (SOFT) ktpu_soft_write(a.soft, p, best, N, ok);
    }
    __syncwarp();
  }
  if (rank == 0 && tid == 0) {
    a.packed[p] = ok ? best : -1;
    a.packed[P + p] = __float_as_int(chosen);
  }
  // B3: the counter writes before any CTA reads them again
  if (TOPO || SOFT) ktpu_cluster_sync();
  if (stamp)
    ktpu_prof_stamp(a.prof, a.prof_every, p, 7, best + (ok ? 1 : 0));
}
