// K8: the pods x nodes fits mask and masked score matrix against the
// frozen snapshot.
//
// Replaces kubernetes_tpu/scheduler/kernels/batch.py filter_score
// (:219-240, the jax.vmap of `one` over the pod axis): for every pod and
// node row, _pod_feasible and _pod_score against the batch-start usage,
// with no in-batch updates, no nominated overlay and no topology or soft
// terms, plus the SelectorSpread term from the frozen spread_base row of
// the pod's group (:233-238). Outputs fits [P, N] bool and
// where(fits, score, NEG) [P, N] f32.
//
// A 2-D grid of node-row tiles x pod tiles (KTPU_FILTER_PODS pods). A
// block stages its rows' usage and allocatable [rows x R] once, column
// by column in shared memory (coalesced copies), and each thread keeps
// its own KTPU_FILTER_RPT consecutive rows' flags, pod-slot fit,
// non-zero usage and zone in registers; the tile's pod scalars (req
// [R], nz, blocked, mask_idx, score_idx, spread_gidx) are staged too.
// So a node row is read from L2 once a pod tile, not once a pod. The
// tile's pods that read the same inputs bit for bit (a batch's pods come
// from a few templates: 3 distinct pods in every 64-pod tile of
// chip_smoke.py's uniform and spread batches) form a group, and each
// group's first pod is computed once: its rows' fits and scores are
// stored for every member.
// For each computed pod a thread reads its rows of the pod's mask,
// static score (and spread count) row with one vector load each, and
// each member's fits go out with one uchar4 store and its scores with
// one float4 store (scalar accesses where N is not a multiple of 4 or a
// base is not 16-byte aligned). The arithmetic is pod.cuh's:
// ktpu_pod_fits without the overlay (the pod-slot test, the only part
// that does not depend on the pod, taken once a row) and
// ktpu_pod_base_at (its resource score, four IEEE divisions, on the rows
// the pod fits).
//
// The spread instance needs each pod's max feasible count, have_zones
// and zone sums over all N rows before any score, and a pod's rows span
// many blocks, so it takes TWO PASSES (a cluster spanning a pod tile's
// rows would cap N at 16 tiles): the first writes fits, each pod's group
// representative and the representatives' partials into a scratch [P] x
// (3 + Z) table. The zone sums are integer-valued counts, exact in any
// order below 2^24, so they are added as ints with native atomics (into
// the block's [pods, Z] table in shared memory when it fits there, else
// into the f32 table; a count that is not an integer below 2^24 is added
// with a float atomic, exact only where the sums are); the max count is
// an integer max on the bits of the positive counts (a -0.0, +0.0 or
// negative count leaves it at +0.0, as fmaxf from 0.0 does); have_zones
// an OR. The second pass reads fits back and writes the scores. A launch
// before them sets the table (zinit per pod). Without spread groups one
// pass writes both, and the reference's zero-weight spread term adds
// + 0.0.
//
// Bound: bytes. The outputs alone are P * N * 5 bytes (671 MB at
// P = 16,384, N = 8,192); the score's five IEEE divisions a (computed
// pod, row) are the instruction-issue floor where a tile's pods all
// differ.
#include "score.cuh"
#include "pod.cuh"

// The host's parameter block: the pointer fields in the order of
// kubernetes_tpu_torch/scheduler/kernels/batch.py _FILTER_PTRS, then the
// ints of _FILTER_INTS. The spread pointers (and the scratch) are null
// without spread groups.
struct KtpuFilterParams {
  const float* alloc;
  const float* max_pods;
  const bool* node_ok;
  const bool* mem_pressure;
  const bool* valid;
  const bool* unique_masks;
  const float* unique_scores;
  const float* rw;
  const float* used;
  const float* nz_used;
  const float* pod_count;
  const float* req;
  const float* nz_req;
  const bool* blocked;
  const int* mask_idx;
  const int* score_idx;
  const int* spread_gidx;
  const float* spread_base;
  const int* zone_of;
  const float* zinit;
  const float* spread_w;
  bool* fits;
  float* score;
  int* scratch;  // [P] max count bits, [P] have_zones, [P] each pod's
                 // representative, [P, Z] zone sums
  int N, R, P, G, Z, has_spread;
};

// rows a thread, pods a tile, threads a block at most, and the shared
// memory a block's staged columns may take
#define KTPU_FILTER_RPT 4
#define KTPU_FILTER_PODS 64
#define KTPU_FILTER_THREADS 128
#define KTPU_FILTER_COL_BYTES (96 * 1024)
// pass 1's [pods, Z] zone sums go through shared memory up to this size,
// else straight into the scratch table
#define KTPU_FILTER_ZONE_BYTES (16 * 1024)

#define KTPU_FILTER_FITS 0     // fits and scores, no spread groups
#define KTPU_FILTER_PARTIAL 1  // spread pass 1: fits and the partials

// a column's stride in the staged arrays: the rows of a block, padded so
// that a warp's transposing stores spread over the banks and each
// thread's KTPU_FILTER_RPT rows stay 16-byte aligned
__host__ __device__ __forceinline__ int ktpu_filter_ld(int threads) {
  return threads * KTPU_FILTER_RPT + 4;
}

// four bytes and four floats of row r0.. of a [., N] row `p`, vector
// loads where `vec`, else one at a time inside [0, N)
__device__ __forceinline__ unsigned ktpu_ld_bytes4(const bool* p, int r0,
                                                   int N, bool vec) {
  if (vec) {
    const uchar4 m = *reinterpret_cast<const uchar4*>(p + r0);
    return (m.x ? 1u : 0u) | (m.y ? 2u : 0u) | (m.z ? 4u : 0u) |
           (m.w ? 8u : 0u);
  }
  unsigned bits = 0u;
#pragma unroll
  for (int q = 0; q < KTPU_FILTER_RPT; ++q)
    if (r0 + q < N && p[r0 + q]) bits |= 1u << q;
  return bits;
}

__device__ __forceinline__ float4 ktpu_ld_f4(const float* p, int r0, int N,
                                             bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(p + r0);
  float v[KTPU_FILTER_RPT];
#pragma unroll
  for (int q = 0; q < KTPU_FILTER_RPT; ++q)
    v[q] = r0 + q < N ? p[r0 + q] : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void ktpu_st_fits4(bool* p, int r0, int N,
                                              bool vec, unsigned bits) {
  if (vec) {
    *reinterpret_cast<uchar4*>(p + r0) =
        make_uchar4(bits & 1u, (bits >> 1) & 1u, (bits >> 2) & 1u,
                    (bits >> 3) & 1u);
    return;
  }
#pragma unroll
  for (int q = 0; q < KTPU_FILTER_RPT; ++q)
    if (r0 + q < N) p[r0 + q] = (bits >> q) & 1u;
}

__device__ __forceinline__ void ktpu_st_f4(float* p, int r0, int N, bool vec,
                                           const float* v) {
  if (vec) {
    *reinterpret_cast<float4*>(p + r0) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int q = 0; q < KTPU_FILTER_RPT; ++q)
    if (r0 + q < N) p[r0 + q] = v[q];
}

__device__ __forceinline__ float ktpu_f4_at(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// One thread's rows: which are schedulable at all (node_ok, valid and
// the pod-slot test of ktpu_pod_fits, none of which depends on the pod),
// which are under memory pressure, their allocatable cpu / memory and
// non-zero usage (the score's columns) and their zones
struct KtpuFilterRows {
  unsigned ok, mp;
  float a0[KTPU_FILTER_RPT], a1[KTPU_FILTER_RPT];
  float nz0[KTPU_FILTER_RPT], nz1[KTPU_FILTER_RPT];
  int zone[KTPU_FILTER_RPT];

  __device__ __forceinline__ void load(const KtpuFilterParams& a, int r0,
                                       bool spread) {
    ok = mp = 0u;
#pragma unroll
    for (int q = 0; q < KTPU_FILTER_RPT; ++q) {
      const int r = r0 + q;
      a0[q] = a1[q] = nz0[q] = nz1[q] = 0.0f;
      zone[q] = 0;
      if (r >= a.N) continue;
      if (a.node_ok[r] && a.valid[r] &&
          __fadd_rn(a.pod_count[r], 1.0f) <= a.max_pods[r])
        ok |= 1u << q;
      if (a.mem_pressure[r]) mp |= 1u << q;
      a0[q] = a.alloc[(size_t)r * a.R];
      a1[q] = a.alloc[(size_t)r * a.R + 1];
      nz0[q] = a.nz_used[2 * r];
      nz1[q] = a.nz_used[2 * r + 1];
      if (spread) zone[q] = a.zone_of[r];
    }
  }
};

// The tile's pod scalars in shared memory
struct KtpuFilterPods {
  float* req;  // [PODS][R]
  float* nz;   // [PODS][2]
  int* idx;    // [PODS][4]: blocked, mask_idx, score_idx, spread_gidx
};

__device__ __forceinline__ void ktpu_filter_stage_pods(
    const KtpuFilterParams& a, const KtpuFilterPods& s, int p0, int np,
    bool spread) {
  const int tid = threadIdx.x, T = blockDim.x, R = a.R;
  for (int e = tid; e < np * R; e += T) s.req[e] = a.req[(size_t)p0 * R + e];
  for (int k = tid; k < np; k += T) {
    const int p = p0 + k;
    s.nz[2 * k] = a.nz_req[2 * p];
    s.nz[2 * k + 1] = a.nz_req[2 * p + 1];
    s.idx[4 * k] = a.blocked[p] ? 1 : 0;
    s.idx[4 * k + 1] = a.mask_idx[p];
    s.idx[4 * k + 2] = a.score_idx[p];
    s.idx[4 * k + 3] = spread ? a.spread_gidx[p] : 0;
  }
}

// Pods k1 and k2 of the tile read the same inputs (request row, non-zero
// request, blocked flag, mask, score and spread rows, all bit for bit),
// so their fits and score rows are equal
__device__ __forceinline__ bool ktpu_filter_same(const KtpuFilterPods& s,
                                                 int k1, int k2, int R) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (s.idx[4 * k1 + i] != s.idx[4 * k2 + i]) return false;
  if (__float_as_uint(s.nz[2 * k1]) != __float_as_uint(s.nz[2 * k2]) ||
      __float_as_uint(s.nz[2 * k1 + 1]) != __float_as_uint(s.nz[2 * k2 + 1]))
    return false;
  for (int j = 0; j < R; ++j)
    if (__float_as_uint(s.req[k1 * R + j]) !=
        __float_as_uint(s.req[k2 * R + j]))
      return false;
  return true;
}

// Each pod of the tile joins the first pod with the same inputs: bit m of
// mem[k] is set when pod m's representative is pod k (mem zeroed and the
// pods staged before; a barrier after). Where `rep_out` is given, pod p0
// + m's representative goes to rep_out[m].
__device__ __forceinline__ void ktpu_filter_group(const KtpuFilterPods& s,
                                                  int np, int R,
                                                  unsigned long long* mem,
                                                  int p0, int* rep_out) {
  for (int m = threadIdx.x; m < np; m += blockDim.x) {
    int rep = m;
    for (int k = 0; k < m; ++k)
      if (ktpu_filter_same(s, k, m, R)) {
        rep = k;
        break;
      }
    atomicOr(&mem[rep], 1ull << m);
    if (rep_out != nullptr) rep_out[m] = p0 + rep;
  }
}

// this thread's rows' resource score for a pod's non-zero request pair,
// on the rows the pod fits (`ok`); 0.0 elsewhere, never read
__device__ __forceinline__ void ktpu_filter_resource(
    const KtpuFilterRows& rw_, unsigned ok, float pnz0, float pnz1,
    float rw0, float rw1, float* rs) {
#pragma unroll
  for (int q = 0; q < KTPU_FILTER_RPT; ++q)
    rs[q] = ((ok >> q) & 1u)
        ? ktpu_pod_resource_at(rw_.a0[q], rw_.a1[q], rw_.nz0[q], rw_.nz1[q],
                               pnz0, pnz1, rw0, rw1)
        : 0.0f;
}

// Pass KTPU_FILTER_FITS or KTPU_FILTER_PARTIAL over one (row tile, pod
// tile): dynamic shared memory holds the used and alloc columns [R][LD],
// the pod scalars and (pass 1, when it fits) the tile's zone sums.
template <int MODE>
__global__ void __launch_bounds__(KTPU_FILTER_THREADS)
ktpu_filter_tile_kernel(KtpuFilterParams a, int vec_i, int zs_shared) {
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned long long s_mem[KTPU_FILTER_PODS];
  __shared__ unsigned s_maxc[KTPU_FILTER_PODS];
  __shared__ int s_hz[KTPU_FILTER_PODS];
  const bool vec = vec_i != 0;
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31;
  const int N = a.N, R = a.R, Z = a.Z;
  const int LD = ktpu_filter_ld(T);
  const int rows = T * KTPU_FILTER_RPT;
  const int rbase = blockIdx.x * rows;
  const int nr = min(rows, N - rbase);
  const int p0 = blockIdx.y * KTPU_FILTER_PODS;
  const int np = min(KTPU_FILTER_PODS, a.P - p0);
  float* s_used = smem;
  float* s_alloc = s_used + (size_t)R * LD;
  KtpuFilterPods sp;
  sp.req = s_alloc + (size_t)R * LD;
  sp.nz = sp.req + KTPU_FILTER_PODS * R;
  sp.idx = reinterpret_cast<int*>(sp.nz + 2 * KTPU_FILTER_PODS);
  int* s_zi = sp.idx + 4 * KTPU_FILTER_PODS;  // [pods, Z] zone sums
  // ---- stage: the rows' usage and allocatable, column-major
  const float* gu = a.used + (size_t)rbase * R;
  const float* ga = a.alloc + (size_t)rbase * R;
  // eight loads of each table in flight a thread
  for (int e0 = tid; e0 < nr * R; e0 += 8 * T) {
    float u[8], c[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = e0 + i * T;
      u[i] = e < nr * R ? gu[e] : 0.0f;
      c[i] = e < nr * R ? ga[e] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = e0 + i * T;
      if (e >= nr * R) break;
      const int r = e / R, j = e - r * R;
      s_used[j * LD + r] = u[i];
      s_alloc[j * LD + r] = c[i];
    }
  }
  ktpu_filter_stage_pods(a, sp, p0, np, MODE == KTPU_FILTER_PARTIAL);
  for (int k = tid; k < KTPU_FILTER_PODS; k += T) {
    s_mem[k] = 0ull;
    s_maxc[k] = 0u;
    s_hz[k] = 0;
  }
  if (MODE == KTPU_FILTER_PARTIAL && zs_shared)
    for (int e = tid; e < np * Z; e += T) s_zi[e] = 0;
  const int q0 = tid * KTPU_FILTER_RPT;
  const int r0 = rbase + q0;
  KtpuFilterRows rw_;
  rw_.load(a, r0, MODE == KTPU_FILTER_PARTIAL);
  const float rw0 = a.rw[0], rw1 = a.rw[1];
  __syncthreads();
  // pass 2 reads each pod's representative from the table
  ktpu_filter_group(sp, np, R, s_mem, p0,
                    MODE == KTPU_FILTER_PARTIAL && blockIdx.x == 0
                        ? a.scratch + 2 * a.P + p0
                        : nullptr);
  __syncthreads();
  const bool mine = r0 < N;
  // each group's representative k, its rows stored for every member
  for (int k = 0; k < np; ++k) {
    const unsigned long long members = s_mem[k];
    if (!members) continue;
    const int p = p0 + k;
    const int* pi = sp.idx + 4 * k;
    const float* req = sp.req + k * R;
    // the pod's rows (mask, static score or spread count) loaded at once
    unsigned mask = 0u;
    float4 row = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (mine) {
      mask = ktpu_ld_bytes4(a.unique_masks + (size_t)pi[1] * N, r0, N, vec);
      const int g = pi[3];
      row = MODE == KTPU_FILTER_FITS
          ? ktpu_ld_f4(a.unique_scores + (size_t)pi[2] * N, r0, N, vec)
          : ktpu_ld_f4(a.spread_base + (size_t)(g > 0 ? g : 0) * N, r0, N,
                       vec);
    }
    // _pod_feasible: the row's own tests, the pod's mask row and memory
    // pressure, then every resource column
    unsigned alive = rw_.ok & (pi[0] ? ~rw_.mp : 0xFu) & mask;
    for (int j = 0; j < R && alive; ++j) {
      const float rq = req[j];
      const float4 u = *reinterpret_cast<const float4*>(s_used + j * LD + q0);
      const float4 c = *reinterpret_cast<const float4*>(s_alloc + j * LD + q0);
      if (!(__fadd_rn(rq, u.x) <= c.x)) alive &= ~1u;
      if (!(__fadd_rn(rq, u.y) <= c.y)) alive &= ~2u;
      if (!(__fadd_rn(rq, u.z) <= c.z)) alive &= ~4u;
      if (!(__fadd_rn(rq, u.w) <= c.w)) alive &= ~8u;
    }
    if (MODE == KTPU_FILTER_FITS) {
      if (!mine) continue;
      const float4 st = row;
      float rs[KTPU_FILTER_RPT], out[KTPU_FILTER_RPT];
      ktpu_filter_resource(rw_, alive, sp.nz[2 * k], sp.nz[2 * k + 1], rw0,
                           rw1, rs);
#pragma unroll
      for (int q = 0; q < KTPU_FILTER_RPT; ++q) {
        out[q] = KTPU_NEG;
        // ktpu_pod_base_at
        if ((alive >> q) & 1u)
          out[q] = __fadd_rn(__fadd_rn(rs[q], ktpu_f4_at(st, q)), 0.0f);
      }
      for (unsigned long long m = members; m; m &= m - 1) {
        const size_t pm = (size_t)(p0 + __ffsll((long long)m) - 1) * N;
        ktpu_st_fits4(a.fits + pm, r0, N, vec, alive);
        ktpu_st_f4(a.score + pm, r0, N, vec, out);
      }
    } else {
      if (mine)
        for (unsigned long long m = members; m; m &= m - 1)
          ktpu_st_fits4(a.fits + (size_t)(p0 + __ffsll((long long)m) - 1) * N,
                        r0, N, vec, alive);
      // the representative's partials over this thread's feasible rows:
      // the zone sums are integer-valued counts, added as ints (native
      // shared-memory atomics; a count that is not an integer below 2^24
      // goes to the f32 table with a float atomic)
      unsigned lmax = 0u;
      bool lhz = false;
      const float4 cnt = row;
      float* g_zs = reinterpret_cast<float*>(a.scratch + 3 * a.P);
#pragma unroll
      for (int q = 0; q < KTPU_FILTER_RPT; ++q) {
        if (!((alive >> q) & 1u)) continue;
        const float cf = ktpu_f4_at(cnt, q);
        const int z = rw_.zone[q];
        if (cf > 0.0f) lmax = max(lmax, __float_as_uint(cf));
        if (z > 0) lhz = true;
        // zone 0 ("no zone label") never enters maxz or a zone score
        if (cf == 0.0f || z <= 0 || z >= Z) continue;
        const int iv = (int)cf;
        if (zs_shared && (float)iv == cf && iv > -(1 << 24) && iv < (1 << 24))
          atomicAdd(&s_zi[k * Z + z], iv);
        else
          atomicAdd(&g_zs[(size_t)p * Z + z], cf);
      }
      lmax = __reduce_max_sync(0xffffffffu, lmax);
      const bool hz = __any_sync(0xffffffffu, lhz);
      if (lane == 0) {
        if (lmax) atomicMax(&s_maxc[k], lmax);
        if (hz) s_hz[k] = 1;
      }
    }
  }
  if (MODE == KTPU_FILTER_PARTIAL) {
    // ---- the block's partials into the representatives' table
    __syncthreads();
    unsigned* g_maxc = reinterpret_cast<unsigned*>(a.scratch);
    int* g_hz = a.scratch + a.P;
    float* g_zs = reinterpret_cast<float*>(a.scratch + 3 * a.P);
    for (int k = tid; k < np; k += T) {
      if (s_maxc[k]) atomicMax(&g_maxc[p0 + k], s_maxc[k]);
      if (s_hz[k]) g_hz[p0 + k] = 1;
    }
    if (zs_shared)
      for (int e = tid; e < np * Z; e += T) {
        const int v = s_zi[e];
        if (v != 0) atomicAdd(&g_zs[(size_t)p0 * Z + e], (float)v);
      }
  }
}

// The pods' table before pass 1: max count +0.0, no zones, zinit (pass
// 1 writes each pod's representative)
__global__ void ktpu_filter_init_kernel(KtpuFilterParams a) {
  const size_t P = (size_t)a.P, n = P * (3 + a.Z);
  float* zs = reinterpret_cast<float*>(a.scratch + 3 * P);
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    if (e < 2 * P)
      a.scratch[e] = 0;
    else if (e >= 3 * P)
      zs[e - 3 * P] = a.zinit[(e - 3 * P) % a.Z];
  }
}

// Spread pass 2 over one (row tile, pod tile): each representative's
// spread reductions from the table, the fits pass 1 wrote, and the
// scores, stored for every member of its group
__global__ void __launch_bounds__(KTPU_FILTER_THREADS)
ktpu_filter_spread_kernel(KtpuFilterParams a, int vec_i) {
  __shared__ unsigned long long s_mem[KTPU_FILTER_PODS];
  __shared__ float s_nz[2 * KTPU_FILTER_PODS];
  __shared__ float s_sw[KTPU_FILTER_PODS], s_maxc[KTPU_FILTER_PODS],
      s_maxz[KTPU_FILTER_PODS];
  __shared__ int s_idx[3 * KTPU_FILTER_PODS];  // score_idx, group, hz
  const bool vec = vec_i != 0;
  const int tid = threadIdx.x, T = blockDim.x;
  const int N = a.N, Z = a.Z;
  const int rbase = blockIdx.x * T * KTPU_FILTER_RPT;
  const int p0 = blockIdx.y * KTPU_FILTER_PODS;
  const int np = min(KTPU_FILTER_PODS, a.P - p0);
  const unsigned* g_maxc = reinterpret_cast<const unsigned*>(a.scratch);
  const int* g_hz = a.scratch + a.P;
  const int* g_rep = a.scratch + 2 * a.P;
  const float* g_zs = reinterpret_cast<const float*>(a.scratch + 3 * a.P);
  for (int k = tid; k < KTPU_FILTER_PODS; k += T) s_mem[k] = 0ull;
  __syncthreads();
  for (int m = tid; m < np; m += T)
    atomicOr(&s_mem[g_rep[p0 + m] - p0], 1ull << m);
  __syncthreads();
  for (int k = tid; k < np; k += T) {
    if (!s_mem[k]) continue;
    const int p = p0 + k;
    const int g = a.spread_gidx[p];
    s_nz[2 * k] = a.nz_req[2 * p];
    s_nz[2 * k + 1] = a.nz_req[2 * p + 1];
    s_sw[k] = __fmul_rn(a.spread_w[0], g >= 0 ? 1.0f : 0.0f);
    s_maxc[k] = __uint_as_float(g_maxc[p]);
    float maxz = 0.0f;
    for (int z = 1; z < Z; ++z) maxz = fmaxf(maxz, g_zs[(size_t)p * Z + z]);
    s_maxz[k] = maxz;
    s_idx[3 * k] = a.score_idx[p];
    s_idx[3 * k + 1] = g > 0 ? g : 0;
    s_idx[3 * k + 2] = g_hz[p];
  }
  const int r0 = rbase + tid * KTPU_FILTER_RPT;
  KtpuFilterRows rw_;
  rw_.load(a, r0, true);
  const float rw0 = a.rw[0], rw1 = a.rw[1];
  __syncthreads();
  if (r0 >= N) return;
  // each group's representative k, its scores stored for every member
  for (int k = 0; k < np; ++k) {
    const unsigned long long members = s_mem[k];
    if (!members) continue;
    const int p = p0 + k;
    const unsigned fit = ktpu_ld_bytes4(a.fits + (size_t)p * N, r0, N, vec);
    float out[KTPU_FILTER_RPT];
#pragma unroll
    for (int q = 0; q < KTPU_FILTER_RPT; ++q) out[q] = KTPU_NEG;
    if (fit) {
      float rs[KTPU_FILTER_RPT];
      ktpu_filter_resource(rw_, fit, s_nz[2 * k], s_nz[2 * k + 1], rw0, rw1,
                           rs);
      const float4 st = ktpu_ld_f4(
          a.unique_scores + (size_t)s_idx[3 * k] * N, r0, N, vec);
      const float4 cnt = ktpu_ld_f4(
          a.spread_base + (size_t)s_idx[3 * k + 1] * N, r0, N, vec);
      const float* zs = g_zs + (size_t)p * Z;
#pragma unroll
      for (int q = 0; q < KTPU_FILTER_RPT; ++q) {
        if (!((fit >> q) & 1u)) continue;
        // ktpu_pod_base_at
        const float base = __fadd_rn(rs[q], ktpu_f4_at(st, q));
        out[q] = __fadd_rn(
            base, __fmul_rn(s_sw[k],
                            ktpu_spread_score(ktpu_f4_at(cnt, q),
                                              rw_.zone[q], zs, Z,
                                              s_maxc[k], s_maxz[k],
                                              s_idx[3 * k + 2] != 0)));
      }
    }
    for (unsigned long long m = members; m; m &= m - 1)
      ktpu_st_f4(a.score + (size_t)(p0 + __ffsll((long long)m) - 1) * N, r0,
                 N, vec, out);
  }
}

static bool ktpu_aligned16(const void* p) {
  return ((uintptr_t)p & 15u) == 0u;
}

// threads a block of pass 1 (or the one pass): the most, down to one
// warp, whose staged columns fit KTPU_FILTER_COL_BYTES
static int ktpu_filter_threads(int R) {
  int t = KTPU_FILTER_THREADS;
  while (t > 32 && (size_t)2 * R * ktpu_filter_ld(t) * sizeof(float) >
                       KTPU_FILTER_COL_BYTES)
    t /= 2;
  return t;
}

template <int MODE>
static cudaError_t ktpu_filter_tiles(const KtpuFilterParams& a, int vec,
                                     int zs_shared, cudaStream_t s) {
  const int T = ktpu_filter_threads(a.R);
  const size_t smem =
      sizeof(float) * ((size_t)2 * a.R * ktpu_filter_ld(T) +
                       (size_t)KTPU_FILTER_PODS * (a.R + 2)) +
      sizeof(int) * 4 * KTPU_FILTER_PODS +
      (zs_shared ? sizeof(int) * (size_t)KTPU_FILTER_PODS * a.Z : 0);
  // past 48 KB only after this attribute: set once to the most any call
  // asks for
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    const size_t most = KTPU_FILTER_COL_BYTES + KTPU_FILTER_ZONE_BYTES +
                        64 * 1024;
    const cudaError_t err = cudaFuncSetAttribute(
        ktpu_filter_tile_kernel<MODE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
    if (err != cudaSuccess) return err;
    allowed = most;
  }
  const int rows = T * KTPU_FILTER_RPT;
  const dim3 grid((a.N + rows - 1) / rows,
                  (a.P + KTPU_FILTER_PODS - 1) / KTPU_FILTER_PODS);
  ktpu_filter_tile_kernel<MODE><<<grid, T, smem, s>>>(a, vec, zs_shared);
  return cudaGetLastError();
}

extern "C" int ktpu_filter_score(const KtpuFilterParams* h, void* stream) {
  if (h->P <= 0 || h->N <= 0) return 0;
  const KtpuFilterParams a = *h;
  if (a.R < 2 || a.R > KTPU_MAX_R || (a.has_spread && a.Z < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // vector accesses: every [., N] row 16-byte aligned
  bool vec = a.N % 4 == 0 && ktpu_aligned16(a.unique_masks) &&
             ktpu_aligned16(a.unique_scores) && ktpu_aligned16(a.fits) &&
             ktpu_aligned16(a.score);
  if (a.has_spread) vec = vec && ktpu_aligned16(a.spread_base);
  cudaError_t err;
  if (!a.has_spread)
    return (int)ktpu_filter_tiles<KTPU_FILTER_FITS>(a, vec, 0, s);
  // a tile's [pods, Z] zone sums in shared memory up to
  // KTPU_FILTER_ZONE_BYTES
  const int zs_shared = (size_t)KTPU_FILTER_PODS * a.Z * sizeof(int) <=
                        KTPU_FILTER_ZONE_BYTES;
  ktpu_filter_init_kernel<<<256, 256, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = ktpu_filter_tiles<KTPU_FILTER_PARTIAL>(a, vec, zs_shared, s);
  if (err != cudaSuccess) return (int)err;
  const int rows = KTPU_FILTER_THREADS * KTPU_FILTER_RPT;
  const dim3 grid((a.N + rows - 1) / rows,
                  (a.P + KTPU_FILTER_PODS - 1) / KTPU_FILTER_PODS);
  ktpu_filter_spread_kernel<<<grid, KTPU_FILTER_THREADS, 0, s>>>(a, vec);
  return (int)cudaGetLastError();
}
