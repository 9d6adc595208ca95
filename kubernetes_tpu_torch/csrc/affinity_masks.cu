// K13: the required inter-pod (anti-)affinity mask of a batch's templates.
//
// Replaces kubernetes_tpu/scheduler/kernels/affinity.py
// _affinity_masks_jit (:39), which XLA lowered to three matrix products on
// the TPU:
//
//   viol[u, n] = (sum_t sd[u, t] * (1 - hd[t, n])
//                 + sum_t sp[u, t] * (1 - pr[t, n]))
//                + sum_t sa[u, t] * pr[t, n],     pr = present & has_dom
//   mask[u, n] = viol[u, n] == 0
//
// has_dom / present are bool [T, N], the three selectors f32 [U, T], the
// mask bool [U, N].
//
// The bit form. TopologyIndex.required_masks only ever writes 1.0 into
// zeroed selectors, so every term is 0 or 1 and viol is a sum of
// non-negative terms: it is zero exactly when no term is set. Stack the
// selectors along one axis of K = 3·Tw 32-term words (Tw = ceil(T / 32)),
// A = [sd | sp | sa], and the node side to match, B = [~hd ; ~pr ; pr];
// then
//
//   mask[u, n] = (OR_k A[k, u] & B[k, n]) == 0
//
// and one lop3 (acc | (a & b)) covers 32 terms where the f32 form took 3 ×
// 32 multiply-adds. The result equals the plain version's (and JAX's) bit
// for bit for selectors in {0.0, -0.0, 1.0}. Any other selector value
// (0.5, 2.0, NaN) sets *err in the pack pass, and the wrapper raises: the
// kernel never returns a mask it cannot vouch for. The plain version
// keeps JAX's arithmetic for any f32.
//
// Bound: bytes. The inputs as the wrapper holds them, read once, and the
// mask written once: 2·T·N + 12·U·T + U·N bytes, 67,108,864 at U = 1,024,
// T = 2,048, N = 8,192 (0.020 ms at 3.35 TB/s). The f32 form's 6·U·T·N
// operations (1.5 ms at 67 TFLOP/s) are gone.
//
// Design: three launches from one C call, all on the caller's stream.
//  1. ktpu_am_pack_sel: one warp a (word k, 32 templates); for each of its
//     32 templates it reads 32 consecutive f32 of a selector row (128
//     coalesced bytes) and takes __ballot_sync(v == 1.0f); the 32 words
//     go through shared memory to lane j (template j), and the warp
//     stores them in one 128-byte row of A, laid out word-major [Kp][Up] so that the mask pass copies a
//     tile of it without a transpose. A warp with a set bit marks its
//     (template tile, chunk) in the chunk flags.
//  2. ktpu_am_pack_nodes: one thread a (word w, node n) reads the 32
//     bytes of has_dom and present at stride N (coalesced across the
//     warp's nodes) and writes the ~hd, ~pr and pr words of B, node-minor
//     [Kp][Np]. Pad terms (t >= T), pad words (k >= 3·Tw) and pad nodes
//     are written 0 (their selector bits are 0, and pad nodes are never
//     stored).
//  3. ktpu_am_mask: K14's main loop with lop3 in place of the FFMA. A
//     256-thread block owns 64 templates x 128 nodes, 4 templates x 8
//     nodes of u32 accumulators a thread (nodes tx*4 and 64 + tx*4, so a
//     warp's reads of a B row are conflict-free). The block first lists
//     the chunks of 16 words (512 terms) in which any of its 64 templates
//     has a bit (the chunk flags); only those chunks run, through a ring
//     of 3 shared-memory stages filled by 16-byte cp.async. A service
//     template holds 1-3 terms and required_masks numbers terms in
//     template order, so most chunks of that path are skipped. The mask
//     goes out as bytes, 4 a store where N % 4 == 0.
// Scratch (A, B, the chunk flags, *err) comes from the wrapper
// (ktpu_affinity_masks_scratch sizes it); the kernels allocate nothing.
// On an H100 80GB HBM3 at 700 W, at the service path's largest call
// (Ub = 1,024, Tb = 2,048, N = 8,192; chip_smoke.py's affinity_masks row):
// 0.069 ms of device time, three quarters of it the pack pass (the node
// side alone 0.037), with 93% of the (tile, chunk) pairs skipped; 0.16-
// 0.23 ms by CUDA events, the flag read back after each call included;
// on random selectors at the same shape (no chunk skipped) 0.17 ms of
// device time. 64 (mask), 26 (node pack) and 40 (selector pack)
// registers, no spill. An earlier selector pack that kept its word in a
// register chosen by lane spilled 4 bytes; the words go through shared
// memory instead.
//
// Why not int8 wgmma: 8-bit wgmma takes both operands K-major, so the
// node side would first need an [N, 3·Tb] int8 re-layout (50 MB at the
// largest call, 8x the bit form's B), and the three products at the int8
// tensor-core rate (1,979 TOPS) still take 0.052 ms. The bit form's dense
// worst case is 1.6e9 lop3 (about 0.1 ms at 64 integer lanes an SM), and
// with chunk skipping far less on the route's real templates.
#include <cuda_runtime.h>
#include <stdint.h>

#define KTPU_AM_BM 64        // templates a block tile
#define KTPU_AM_BN 128       // nodes a block tile
#define KTPU_AM_BK 16        // words (of 32 terms) a chunk
#define KTPU_AM_STAGES 3     // shared-memory stages of the copy ring
#define KTPU_AM_THREADS 256
// chunk indices the mask pass lists in dynamic shared memory, beside its
// 36 KB of stages (48 KB without an opt-in): T up to 2^19 terms
#define KTPU_AM_MAX_CHUNKS 3072

struct KtpuAmShape {
  int U, T, N;
  int Tw;         // words of one selector: ceil(T / 32)
  int K, Kp;      // words of the stacked axis, and padded to BK
  int Up, Np;     // U and N padded to the block tile
  int n_chunks;   // Kp / BK
};

static KtpuAmShape ktpu_am_shape(int U, int T, int N) {
  KtpuAmShape s;
  s.U = U;
  s.T = T;
  s.N = N;
  s.Tw = (T + 31) / 32;
  s.K = 3 * s.Tw;
  s.Kp = (s.K + KTPU_AM_BK - 1) / KTPU_AM_BK * KTPU_AM_BK;
  s.Up = (U + KTPU_AM_BM - 1) / KTPU_AM_BM * KTPU_AM_BM;
  s.Np = (N + KTPU_AM_BN - 1) / KTPU_AM_BN * KTPU_AM_BN;
  s.n_chunks = s.Kp / KTPU_AM_BK;
  return s;
}

__global__ void __launch_bounds__(KTPU_AM_THREADS)
ktpu_am_pack_sel(const float* __restrict__ sd, const float* __restrict__ sp,
                 const float* __restrict__ sa, uint32_t* __restrict__ a,
                 int* __restrict__ chunk_any, int* __restrict__ err,
                 KtpuAmShape s) {
  __shared__ uint32_t s_word[KTPU_AM_THREADS / 32][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = s.Up / 32;
  const int task = blockIdx.x * (KTPU_AM_THREADS / 32) + warp;
  if (task >= s.Kp * groups) return;   // warp-uniform
  const int k = task / groups;
  const int u0 = (task - k * groups) * 32;
  bool bad = false;
  s_word[warp][lane] = 0u;
  __syncwarp();
  if (k < s.K) {
    const int sel = k / s.Tw;
    const int t = (k - sel * s.Tw) * 32 + lane;
    const float* row = sd;
    if (sel == 1) row = sp;
    if (sel == 2) row = sa;
    row += t;
    const bool t_in = t < s.T;
    // template u0 + j's word is the warp's ballot over its 32 terms;
    // lane 0 parks it in shared memory, where lane j picks it up
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int u = u0 + j;
      const float v = t_in && u < s.U ? row[(size_t)u * s.T] : 0.0f;
      bad |= !(v == 0.0f || v == 1.0f);   // NaN, 0.5, 2.0, ...
      const uint32_t word = __ballot_sync(0xffffffffu, v == 1.0f);
      if (lane == 0) s_word[warp][j] = word;
    }
    __syncwarp();
  }
  const uint32_t mine = s_word[warp][lane];
  a[(size_t)k * s.Up + u0 + lane] = mine;
  if (__any_sync(0xffffffffu, mine != 0u) && lane == 0)
    chunk_any[(u0 / KTPU_AM_BM) * s.n_chunks + k / KTPU_AM_BK] = 1;
  if (__any_sync(0xffffffffu, bad) && lane == 0) *err = 1;
}

__global__ void __launch_bounds__(KTPU_AM_THREADS)
ktpu_am_pack_nodes(const unsigned char* __restrict__ hd,
                   const unsigned char* __restrict__ pr,
                   uint32_t* __restrict__ b, KtpuAmShape s) {
  const int n = blockIdx.x * KTPU_AM_THREADS + threadIdx.x;
  const int w = blockIdx.y;
  if (n >= s.Np) return;
  const int t0 = w * 32;
  const int nt = s.T - t0 < 32 ? s.T - t0 : 32;
  uint32_t h = 0, p = 0;
  if (n < s.N) {
    const unsigned char* hcol = hd + (size_t)t0 * s.N + n;
    const unsigned char* pcol = pr + (size_t)t0 * s.N + n;
#pragma unroll 8
    for (int i = 0; i < 32; ++i) {
      if (i < nt) {
        const uint32_t hb = hcol[(size_t)i * s.N] != 0;
        const uint32_t pb = hb & (pcol[(size_t)i * s.N] != 0);
        h |= hb << i;
        p |= pb << i;
      }
    }
  }
  // the terms of this word that exist, on a node that exists
  const uint32_t valid =
      n >= s.N ? 0u : nt >= 32 ? 0xffffffffu : (1u << nt) - 1u;
  b[(size_t)w * s.Np + n] = ~h & valid;
  b[(size_t)(s.Tw + w) * s.Np + n] = ~p & valid;
  b[(size_t)(2 * s.Tw + w) * s.Np + n] = p;
  for (int k = 3 * s.Tw + w; k < s.Kp; k += s.Tw) b[(size_t)k * s.Np + n] = 0;
}

__device__ __forceinline__ void ktpu_am_cp16(uint32_t* dst,
                                             const uint32_t* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void ktpu_am_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void ktpu_am_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(KTPU_AM_THREADS)
ktpu_am_mask(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
             const int* __restrict__ chunk_any,
             unsigned char* __restrict__ out, KtpuAmShape s, int vec) {
  __shared__ __align__(16)
      uint32_t s_a[KTPU_AM_STAGES][KTPU_AM_BK][KTPU_AM_BM];
  __shared__ __align__(16)
      uint32_t s_b[KTPU_AM_STAGES][KTPU_AM_BK][KTPU_AM_BN];
  __shared__ int s_n;
  extern __shared__ int s_list[];   // this tile's chunks with a bit set
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int ut = blockIdx.y;
  const int u0 = ut * KTPU_AM_BM, n0 = blockIdx.x * KTPU_AM_BN;

  // the chunks to run, in any order (an OR of ANDs is exact in any order)
  if (tid == 0) s_n = 0;
  __syncthreads();
  for (int c = tid; c < s.n_chunks; c += KTPU_AM_THREADS)
    if (chunk_any[ut * s.n_chunks + c]) s_list[atomicAdd(&s_n, 1)] = c;
  __syncthreads();
  const int n_list = s_n;

  uint32_t acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0u;

  // this thread's copies of a chunk: 4 words of one A row (16 rows x 64
  // words), 4 words of two B rows (16 rows x 128 words)
  const int ar = tid >> 4, ac = (tid & 15) * 4;
  const int br = tid >> 5, bc = (tid & 31) * 4;
  const size_t up = (size_t)s.Up, np = (size_t)s.Np;
  const uint32_t* a_src = a + ar * up + u0 + ac;
  const uint32_t* b_src = b + br * np + n0 + bc;
  auto load = [&](int st, int c) {
    const size_t k0 = (size_t)c * KTPU_AM_BK;
    ktpu_am_cp16(&s_a[st][ar][ac], a_src + k0 * up);
    ktpu_am_cp16(&s_b[st][br][bc], b_src + k0 * np);
    ktpu_am_cp16(&s_b[st][br + 8][bc], b_src + (k0 + 8) * np);
  };
#pragma unroll
  for (int st = 0; st < KTPU_AM_STAGES - 1; ++st) {
    if (st < n_list) load(st, s_list[st]);
    ktpu_am_commit();
  }
  for (int i = 0; i < n_list; ++i) {
    // this thread's copies of list entry i have landed; the barrier makes
    // everyone's visible and frees the stage entry i - 1 was read from
    ktpu_am_wait<KTPU_AM_STAGES - 2>();
    __syncthreads();
    const int next = i + KTPU_AM_STAGES - 1;
    if (next < n_list) load(next % KTPU_AM_STAGES, s_list[next]);
    ktpu_am_commit();   // an empty group keeps the count in step
    const int st = i % KTPU_AM_STAGES;
#pragma unroll
    for (int kk = 0; kk < KTPU_AM_BK; ++kk) {
      const uint4 av = *reinterpret_cast<const uint4*>(&s_a[st][kk][ty * 4]);
      const uint4 b0 = *reinterpret_cast<const uint4*>(&s_b[st][kk][tx * 4]);
      const uint4 b1 =
          *reinterpret_cast<const uint4*>(&s_b[st][kk][64 + tx * 4]);
      const uint32_t aw[4] = {av.x, av.y, av.z, av.w};
      const uint32_t bw[8] = {b0.x, b0.y, b0.z, b0.w,
                              b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[r][j] |= aw[r] & bw[j];
    }
  }
  ktpu_am_wait<0>();

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int u = u0 + ty * 4 + r;
    if (u >= s.U) continue;
    unsigned char* row = out + (size_t)u * s.N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 64 + tx * 4;
      if (vec && n + 3 < s.N) {
        const uint32_t m = (uint32_t)(acc[r][h * 4] == 0u) |
                           (uint32_t)(acc[r][h * 4 + 1] == 0u) << 8 |
                           (uint32_t)(acc[r][h * 4 + 2] == 0u) << 16 |
                           (uint32_t)(acc[r][h * 4 + 3] == 0u) << 24;
        *reinterpret_cast<uint32_t*>(row + n) = m;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < s.N) row[n + e] = acc[r][h * 4 + e] == 0u;
      }
    }
  }
}

// The scratch the wrapper allocates, in 4-byte words: words[0] of A
// ([Kp][Up] selector words), words[1] of B ([Kp][Np] node words),
// words[2] of chunk flags ([Up / BM][Kp / BK]). The error flag is one more
// word of its own.
extern "C" int ktpu_affinity_masks_scratch(int U, int T, int N,
                                           long long* words) {
  if (U < 0 || T < 0 || N < 0) return (int)cudaErrorInvalidValue;
  const KtpuAmShape s = ktpu_am_shape(U, T, N);
  words[0] = (long long)s.Kp * s.Up;
  words[1] = (long long)s.Kp * s.Np;
  words[2] = (long long)(s.Up / KTPU_AM_BM) * s.n_chunks;
  return 0;
}

extern "C" int ktpu_affinity_masks(const bool* has_dom, const bool* present,
                                   const float* sel_dom,
                                   const float* sel_present,
                                   const float* sel_absent, bool* out, int U,
                                   int T, int N, void* sel_words,
                                   void* node_words, int* chunk_any,
                                   int* err, void* stream) {
  if (U < 0 || T < 0 || N < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(err, 0, sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  if (U == 0 || N == 0) return (int)cudaGetLastError();
  const KtpuAmShape s = ktpu_am_shape(U, T, N);
  if (s.n_chunks > KTPU_AM_MAX_CHUNKS || s.Up / KTPU_AM_BM > 65535 ||
      s.Tw > 65535 || (long long)s.Kp * s.Np > (1LL << 40))
    return (int)cudaErrorInvalidValue;
  uint32_t* a = static_cast<uint32_t*>(sel_words);
  uint32_t* b = static_cast<uint32_t*>(node_words);
  if (s.n_chunks > 0) {
    e = cudaMemsetAsync(chunk_any, 0,
                        sizeof(int) * (size_t)(s.Up / KTPU_AM_BM) *
                            s.n_chunks,
                        st);
    if (e != cudaSuccess) return (int)e;
    const long long tasks = (long long)s.Kp * (s.Up / 32);
    const int warps = KTPU_AM_THREADS / 32;
    ktpu_am_pack_sel<<<(unsigned)((tasks + warps - 1) / warps),
                       KTPU_AM_THREADS, 0, st>>>(sel_dom, sel_present,
                                                 sel_absent, a, chunk_any,
                                                 err, s);
    const dim3 grid((unsigned)((s.Np + KTPU_AM_THREADS - 1) /
                               KTPU_AM_THREADS),
                    (unsigned)s.Tw);
    ktpu_am_pack_nodes<<<grid, KTPU_AM_THREADS, 0, st>>>(
        reinterpret_cast<const unsigned char*>(has_dom),
        reinterpret_cast<const unsigned char*>(present), b, s);
  }
  const int vec = N % 4 == 0 && ((uintptr_t)out & 3u) == 0;
  const dim3 grid((unsigned)(s.Np / KTPU_AM_BN),
                  (unsigned)(s.Up / KTPU_AM_BM));
  ktpu_am_mask<<<grid, KTPU_AM_THREADS, sizeof(int) * s.n_chunks, st>>>(
      a, b, chunk_any, reinterpret_cast<unsigned char*>(out), s, vec);
  return (int)cudaGetLastError();
}
