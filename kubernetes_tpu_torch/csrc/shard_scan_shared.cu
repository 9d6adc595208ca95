// K15's shared design: the sharded class scan (shard_scan.cu has the
// kernel's notes, the reference it replaces and its global design) with
// each CTA's slice of the [C, N] table, the class constants and its rows'
// usage in shared memory, and the reference's collectives as st.async
// exchanges (cluster_xchg.cuh) in place of cluster barriers; a source of
// its own so that the two designs' instances compile in parallel.
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
#include <cooperative_groups.h>

#include "shard_scan.cuh"
#include "cluster_xchg.cuh"

#define KTPU_SSH_CLUSTER 16    // CTAs of the cluster at most
#define KTPU_SSH_THREADS 512   // threads a CTA at most
#define KTPU_SSH_RPT 4         // rows a thread at most
#define KTPU_SSH_CHUNK 64      // pods staged in shared memory at once
// dynamic shared memory a CTA may take
#define KTPU_SSH_SMEM_LIMIT (200 * 1024)

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

template <bool SPREAD, bool TOPO, bool SOFT, bool NOM, bool PROF>
__global__ void __launch_bounds__(KTPU_SSH_THREADS, 1)
ktpu_shard_shared_kernel(KtpuScanArgs a, int D, int kc, int Nc, int hold) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float ssm[];
  constexpr bool PART = SPREAD || SOFT;
  const int N = a.N, R = a.R, C = a.C, P = a.P, G = a.G, Z = a.Z;
  const bool held = SPREAD && hold != 0;
  float* s_ms = ssm;
  float* s_creq = s_ms + (size_t)C * Nc;
  float* s_cnz = s_creq + (size_t)C * R;
  float* s_used = s_cnz + 2 * (size_t)C;
  float* s_nz = s_used + (size_t)R * Nc;
  float* s_cnt = s_nz + 2 * (size_t)Nc;
  float* s_spr = s_cnt + Nc;
  int* s_cmi = (int*)(s_spr + (held ? (size_t)G * Nc : 0));
  int* s_csi = s_cmi + C;
  bool* s_cblk = (bool*)(s_csi + C);
  // candidates [0, 1] and partials [2, 3], by pod parity
  __shared__ __align__(8) uint64_t s_mbar[4];
  __shared__ __align__(16) KtpuCand s_cand[2][KTPU_SSH_CLUSTER *
                                              KTPU_XCHG_WARPS];
  __shared__ __align__(16) float s_part[PART ? 2 : 1]
                                       [KTPU_SSH_CLUSTER][KTPU_PART_WORDS];
  __shared__ KtpuPartScratch ps;
  __shared__ KtpuPodIn s_pod[2][KTPU_SSH_CHUNK];
  // each staged pod's spread_match of group 0 (the owner's update reads it)
  __shared__ float s_m0[2][SPREAD ? KTPU_SSH_CHUNK : 1];
  // the nominee's own row less its request (its owner thread's)
  __shared__ float s_self[NOM ? KTPU_MAX_R : 1];
  // the winner's usage after the update (+ reservations with NOM) and its
  // allocatable, from the winning warp's lanes to its refresh lanes
  __shared__ float s_use[KTPU_MAX_R];
  __shared__ float s_alw[KTPU_MAX_R];
  const int nctas = kc * D;
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int NT = blockDim.x;
  const int nwarps = NT >> 5;
  const int Ns = N / D;
  const int jc = rank % kc;
  const int r0 = (rank / kc) * Ns + jc * Nc;
  const int nloc = max(0, min(Nc, Ns - jc * Nc));
  // the row slots a thread of this CTA may hold (CTA-uniform)
  const int kmax = (nloc + NT - 1) / NT;
  const KtpuStepConst kcst = ktpu_step_const<SPREAD, SOFT>(a);
  const float rw0 = kcst.rw0, rw1 = kcst.rw1;
  const float inf = __int_as_float(0x7f800000);
  const float zp_none = __fmul_rn(KTPU_ZONE_WEIGHT, KTPU_MAX_PRIORITY);
  // the counts of group g at local row i: cnt_base[g * cnt_stride + i]
  float* cnt_base = held ? s_spr : a.spread + r0;
  const size_t cnt_stride = held ? (size_t)Nc : (size_t)N;
  const bool stamp = PROF && rank == 0 && tid == 0;

  // ---- the slice, the class constants and the rows' usage in, once a
  // launch
  for (int c = 0; c < C; ++c)
    for (int i = tid; i < nloc; i += NT)
      s_ms[(size_t)c * Nc + i] = a.ms[(size_t)c * N + r0 + i];
  for (int i = tid; i < C * R; i += NT) s_creq[i] = a.cl.req[i];
  for (int i = tid; i < 2 * C; i += NT) s_cnz[i] = a.cl.nz[i];
  for (int i = tid; i < C; i += NT) {
    s_cmi[i] = a.cl.mask_idx[i];
    s_csi[i] = a.cl.score_idx[i];
    s_cblk[i] = a.cl.blocked[i];
  }
  for (int i = tid; i < nloc; i += NT) {
    const int r = r0 + i;
    for (int j = 0; j < R; ++j)
      s_used[(size_t)j * Nc + i] = a.used[(size_t)r * R + j];
    s_nz[i] = a.nz_used[2 * (size_t)r];
    s_nz[Nc + i] = a.nz_used[2 * (size_t)r + 1];
    s_cnt[i] = a.pod_count[r];
    if (held)
      for (int g = 0; g < G; ++g)
        s_spr[(size_t)g * Nc + i] = a.spread[(size_t)g * N + r];
  }
  const KtpuClasses cl{s_creq, s_cnz, s_cblk, s_cmi, s_csi,
                       a.cl.unique_masks, a.cl.unique_scores, C};
  uint32_t zk[SPREAD ? KTPU_SSH_RPT : 1];
  float zinit_lane = 0.0f;
  if constexpr (SPREAD) {
#pragma unroll
    for (int k = 0; k < KTPU_SSH_RPT; ++k) {
      const int i = tid + k * NT;
      zk[k] = i < nloc ? ktpu_zone_code(a.zone_of[r0 + i], Z) : 0u;
    }
    if (lane < Z) zinit_lane = a.zinit[lane];
  }
  if (tid == 0) ktpu_xchg_init(s_mbar, 4);
  // every CTA runs, its state loaded and its mbarriers ready, before any
  // reaches another's shared memory
  ktpu_cluster_sync();
  unsigned mph = 0u, pph = 0u;   // the arrays' next phase parities
  const unsigned cand_bytes = ktpu_xchg_cand_bytes(nctas, nwarps);

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

  stage(0);
  __syncthreads();
  for (int p = 0; p < P; ++p) {
    if (stamp) ktpu_prof_stamp(a.prof, a.prof_every, p, 0);
    const KtpuPodIn s = s_pod[(p / KTPU_SSH_CHUNK) & 1][p % KTPU_SSH_CHUNK];
    float m0 = 0.0f;
    if constexpr (SPREAD)
      m0 = s_m0[(p / KTPU_SSH_CHUNK) & 1][p % KTPU_SSH_CHUNK];
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
          s_self[j] = __fsub_rn(
              __fadd_rn(s_used[(size_t)j * Nc + il],
                        a.nom_used[(size_t)nr * R + j]),
              s_creq[(size_t)u * R + j]);
        corr = ktpu_class_score(
            a.cfg, cl, rw0, rw1, u, nr, N, R, s_self, s_nz[il],
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
      if constexpr (SPREAD) ktpu_zone_reset(ps, warp, lane);
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
      if (stamp) ktpu_prof_stamp(a.prof, a.prof_every, p, 2);
      pt = ktpu_xchg_partials<SPREAD>(ps, s_part[par], &s_mbar[2 + par],
                                      par, pph, rank, nctas, Z, zinit_lane,
                                      lmax, lhz, lmn, lmx);
      if (SPREAD && lane < Z)
        zp_lane = ktpu_spread_zone_part(pt.zsum, pt.maxz);
    }
    if (stamp && !PART) ktpu_prof_stamp(a.prof, a.prof_every, p, 2);
    if (stamp)
      ktpu_prof_stamp(a.prof, a.prof_every, p, 3, __float_as_int(pt.maxz));

    // ---- 3. the tie-penalized first max over this thread's rows
    const float sw_use =
        SPREAD ? __fmul_rn(kcst.sw, s.gidx >= 0 ? 1.0f : 0.0f) : 0.0f;
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
                                     (int)(zk[k] & 0x3FFFu) & 31);
        if ((zk[k] & 0x8000u) != 0u) zpart = zt;
      }
      if (i >= nloc) continue;
      const int r = r0 + i;
      float score = base_k[k];
      if constexpr (SOFT)
        score = __fadd_rn(score, ktpu_soft_term(raw_k[k], pt.mn, pt.mx,
                                                soft_use, kcst.soft_w));
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
    ktpu_xchg_publish(s_cand[par], &s_mbar[par], rank, warp, lane, nctas,
                      bpen, bval, brow, baux);
    if (tid == 0) ktpu_mbar_expect(&s_mbar[par], cand_bytes);
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
    // the next chunk's pods while the other CTAs arrive
    const int pn = p + 1;
    if (pn < P && pn % KTPU_SSH_CHUNK == 0) {
      stage(pn / KTPU_SSH_CHUNK);
      __syncthreads();
    }
    if (stamp) ktpu_prof_stamp(a.prof, a.prof_every, p, 5);
    ktpu_xchg_wait(&s_mbar[par], par, mph);
    __syncwarp();
    if (stamp) ktpu_prof_stamp(a.prof, a.prof_every, p, 6);
    const KtpuCand win = ktpu_xchg_fold(s_cand[par], nctas, nwarps, lane);
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
          float* x = s_used + (size_t)j * Nc + ib;
          const float v =
              __fadd_rn(*x, __fmul_rn(okf, s_creq[(size_t)u * R + j]));
          *x = v;
          s_use[j] = NOM ? __fadd_rn(v, sp_nom[h]) : v;
          s_alw[j] = sp_alloc[h];
        }
      }
      const float nz0 = __fadd_rn(s_nz[ib], __fmul_rn(okf, s_cnz[2 * u]));
      const float nz1 =
          __fadd_rn(s_nz[Nc + ib], __fmul_rn(okf, s_cnz[2 * u + 1]));
      const float cnt = __fadd_rn(s_cnt[ib], okf);
      for (int g = lane; SPREAD && g < G; g += 32) {
        float* x = cnt_base + (size_t)g * cnt_stride + ib;
        *x = __fadd_rn(*x, __fmul_rn(
            g == 0 ? m0 : a.spread_match[(size_t)p * G + g], okf));
      }
      __syncwarp();   // every lane read the counts; s_use, s_alw written
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
              s_cblk[c], s_alw, s_use, nz0, nz1, cnt_eff, sp_maxp, sp_mp,
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

  // ---- the slice, the usage and the held counts back (all in/out)
  for (int c = 0; c < C; ++c)
    for (int i = tid; i < nloc; i += NT)
      a.ms[(size_t)c * N + r0 + i] = s_ms[(size_t)c * Nc + i];
  for (int i = tid; i < nloc; i += NT) {
    const int r = r0 + i;
    for (int j = 0; j < R; ++j)
      a.used[(size_t)r * R + j] = s_used[(size_t)j * Nc + i];
    a.nz_used[2 * (size_t)r] = s_nz[i];
    a.nz_used[2 * (size_t)r + 1] = s_nz[Nc + i];
    a.pod_count[r] = s_cnt[i];
    if (held)
      for (int g = 0; g < G; ++g)
        a.spread[(size_t)g * N + r] = s_spr[(size_t)g * Nc + i];
  }
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
    if (!ktpu_shard_prof_ok(sp)) return (int)cudaErrorInvalidValue;
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
