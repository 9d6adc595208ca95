// K2's shared design: the serial class scan with the [C, N] table, the
// class constants and the spread counts in shared memory (class_scan.cu
// has the kernel's notes and its global design; a source of its own so
// that the two designs' instances compile in parallel).
#include "class_step.cuh"

#define KTPU_SCAN_CHUNK 128
// dynamic shared memory the shared design may take
#define KTPU_SCAN_SMEM_LIMIT (200 * 1024)

// threads of the shared design: 1,024 (8 rows a thread at N = 8,192)
// where the step keeps no row in registers between two passes, 512 (16
// rows) with spread groups or soft credits
template <bool SPREAD, bool SOFT>
__host__ __device__ constexpr int ktpu_scan_smem_threads() {
  return (SPREAD || SOFT) ? 512 : 1024;
}
#define KTPU_SCAN_SMEM_ROWS 8192

// the shared design's dynamic shared memory, in float words: the table
// [C, N], the class constants req [C, R], nz [C, 2], mask_idx and
// score_idx [C] (int), blocked [C] (bytes, rounded up), with spread the
// zone sums and zinit [Z], the warps' zone partials [32, 32], and the
// spread counts [G, N] when held
__host__ __device__ __forceinline__ size_t ktpu_scan_smem_words(
    int C, int N, int R, int G, int Z, bool spread, bool hold_spread) {
  size_t w = (size_t)C * N + (size_t)C * (R + 4) + ((size_t)C + 3) / 4;
  if (spread) w += 2 * (size_t)Z + 32 * KTPU_STEP_ZW;
  if (spread && hold_spread) w += (size_t)G * N;
  return w;
}

__device__ __forceinline__ void ktpu_cp_async4(void* smem,
                                               const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void ktpu_cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

template <bool SPREAD, bool TOPO, bool SOFT, bool NOM, bool PROF>
__global__ void __launch_bounds__(ktpu_scan_smem_threads<SPREAD, SOFT>(), 1)
ktpu_class_scan_shared_kernel(KtpuScanArgs a, int hold_spread) {
  extern __shared__ __align__(16) float ssm[];
  // the pods' scalars, two chunks: class, seq, spread group, nominated
  // row, soft base row (cp.async), active (through a register)
  __shared__ int s_ci[2][KTPU_SCAN_CHUNK];
  __shared__ int s_seq[2][KTPU_SCAN_CHUNK];
  __shared__ int s_gi[2][SPREAD ? KTPU_SCAN_CHUNK : 1];
  __shared__ int s_nr[2][NOM ? KTPU_SCAN_CHUNK : 1];
  __shared__ int s_sb[2][SOFT ? KTPU_SCAN_CHUNK : 1];
  __shared__ bool s_act[2][KTPU_SCAN_CHUNK];
  const int tid = threadIdx.x;
  const int NT = blockDim.x;
  const int N = a.N, R = a.R, C = a.C, G = a.G, Z = a.Z, P = a.P;
  float* s_ms = ssm;
  float* s_creq = s_ms + (size_t)C * N;
  float* s_cnz = s_creq + (size_t)C * R;
  int* s_cmi = (int*)(s_cnz + 2 * (size_t)C);
  int* s_csi = s_cmi + C;
  bool* s_cblk = (bool*)(s_csi + C);
  float* s_zs = (float*)(s_csi + C) + ((size_t)C + 3) / 4;
  float* s_zinit = s_zs + (SPREAD ? Z : 0);
  int* s_zw = (int*)(s_zinit + (SPREAD ? Z : 0));
  float* s_spread = (float*)(s_zw + (SPREAD ? 32 * KTPU_STEP_ZW : 0));

  // ---- the table and the class constants in, once a launch
  for (size_t i = tid; i < (size_t)C * N; i += NT) s_ms[i] = a.ms[i];
  for (int i = tid; i < C * R; i += NT) s_creq[i] = a.cl.req[i];
  for (int i = tid; i < 2 * C; i += NT) s_cnz[i] = a.cl.nz[i];
  for (int i = tid; i < C; i += NT) {
    s_cmi[i] = a.cl.mask_idx[i];
    s_csi[i] = a.cl.score_idx[i];
    s_cblk[i] = a.cl.blocked[i];
  }
  if (SPREAD) {
    // the zone sums: with Z <= 32 the step adds only counts that are
    // not small integers there (zero), else every count (from zinit)
    for (int z = tid; z < Z; z += NT) {
      s_zinit[z] = a.zinit[z];
      s_zs[z] = Z <= KTPU_STEP_ZW ? 0.0f : a.zinit[z];
    }
    for (int i = tid; i < 32 * KTPU_STEP_ZW; i += NT) s_zw[i] = 0;
    if (hold_spread)
      for (size_t i = tid; i < (size_t)G * N; i += NT)
        s_spread[i] = a.spread[i];
  }
  KtpuScanArgs b = a;
  b.ms = s_ms;
  b.cl.req = s_creq;
  b.cl.nz = s_cnz;
  b.cl.mask_idx = s_cmi;
  b.cl.score_idx = s_csi;
  b.cl.blocked = s_cblk;
  if (SPREAD && hold_spread) b.spread = s_spread;
  const KtpuStepConst kc = ktpu_step_const<SPREAD, SOFT>(a);

  // stage chunk q (pods q * CHUNK, ...) into buffer q & 1: the 4-byte
  // scalars by cp.async, `active` returned to be stored after the wait
  auto stage = [&](int q) -> bool {
    const int buf = q & 1;
    const int p = q * KTPU_SCAN_CHUNK + tid;
    bool act = false;
    if (tid < KTPU_SCAN_CHUNK && p < P) {
      ktpu_cp_async4(&s_ci[buf][tid], a.class_idx + p);
      ktpu_cp_async4(&s_seq[buf][tid], a.seq + p);
      if (SPREAD) ktpu_cp_async4(&s_gi[buf][tid], a.spread_gidx + p);
      if (NOM) ktpu_cp_async4(&s_nr[buf][tid], a.nom_row + p);
      if (SOFT) ktpu_cp_async4(&s_sb[buf][tid], a.soft.base_idx + p);
      act = a.active[p];
    }
    return act;
  };
  bool act = stage(0);
  ktpu_cp_async_wait_all();
  if (tid < KTPU_SCAN_CHUNK) s_act[0][tid] = act;
  __syncthreads();

  for (int q = 0; q * KTPU_SCAN_CHUNK < P; ++q) {
    const int buf = q & 1;
    const int p0 = q * KTPU_SCAN_CHUNK;
    // the next chunk, while this one runs
    act = stage(q + 1);
    const int p1 = min(P, p0 + KTPU_SCAN_CHUNK);
    for (int p = p0; p < p1; ++p) {
      const int i = p - p0;
      KtpuPodIn pin;
      pin.u = s_ci[buf][i];
      pin.seq_term = (uint32_t)s_seq[buf][i] * 40503u;
      pin.active = s_act[buf][i];
      pin.gidx = SPREAD ? s_gi[buf][i] : -1;
      pin.nom_row = NOM ? s_nr[buf][i] : -1;
      pin.soft_base = SOFT ? s_sb[buf][i] : -1;
      ktpu_class_pod_step_shared<
          SPREAD, TOPO, SOFT, NOM, PROF,
          KTPU_SCAN_SMEM_ROWS / ktpu_scan_smem_threads<SPREAD, SOFT>()>(
          b, p, pin, kc, s_zs, s_zw, s_zinit);
    }
    ktpu_cp_async_wait_all();
    if (tid < KTPU_SCAN_CHUNK) s_act[buf ^ 1][tid] = act;
    __syncthreads();   // the staged chunk, and the last pod's refresh
  }

  // ---- the table and the held counts back (both are in/out)
  for (size_t i = tid; i < (size_t)C * N; i += NT) a.ms[i] = s_ms[i];
  if (SPREAD && hold_spread)
    for (size_t i = tid; i < (size_t)G * N; i += NT)
      a.spread[i] = s_spread[i];
}

// ---------------------------------------------------------- launchers

template <bool SPREAD, bool TOPO, bool SOFT, bool NOM, bool PROF>
static cudaError_t ktpu_launch_one(const KtpuScanArgs& a, size_t smem,
                                   int hold, cudaStream_t s) {
  auto kern = ktpu_class_scan_shared_kernel<SPREAD, TOPO, SOFT, NOM, PROF>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<1, ktpu_scan_smem_threads<SPREAD, SOFT>(), smem, s>>>(a, hold);
  return cudaSuccess;
}

// the instance of (terms, nom)
template <bool NOM>
static cudaError_t ktpu_launch_terms(int terms, const KtpuScanArgs& a,
                                     size_t smem, int hold, cudaStream_t s) {
  switch (terms) {
    case 0: return ktpu_launch_one<false, false, false, NOM, false>(a, smem, hold, s);
    case 1: return ktpu_launch_one<false, false, true, NOM, false>(a, smem, hold, s);
    case 2: return ktpu_launch_one<false, true, false, NOM, false>(a, smem, hold, s);
    case 3: return ktpu_launch_one<false, true, true, NOM, false>(a, smem, hold, s);
    case 4: return ktpu_launch_one<true, false, false, NOM, false>(a, smem, hold, s);
    case 5: return ktpu_launch_one<true, false, true, NOM, false>(a, smem, hold, s);
    case 6: return ktpu_launch_one<true, true, false, NOM, false>(a, smem, hold, s);
    default: return ktpu_launch_one<true, true, true, NOM, false>(a, smem, hold, s);
  }
}

// the batch's instance; the profiling instances exist for the uniform and
// spread batches only (terms 0 and 4, no overlay)
static int ktpu_launch_batch(const KtpuScanParams* h, const KtpuScanArgs& a,
                             size_t smem, int hold, cudaStream_t s) {
  const int terms = ktpu_scan_terms(h);
  cudaError_t err;
  if (h->prof != nullptr) {
    if (h->has_nom || (terms != 0 && terms != 4) || h->prof_every < 1)
      return (int)cudaErrorInvalidValue;
    err = terms == 4
        ? ktpu_launch_one<true, false, false, false, true>(a, smem, hold, s)
        : ktpu_launch_one<false, false, false, false, true>(a, smem, hold, s);
  } else {
    err = h->has_nom ? ktpu_launch_terms<true>(terms, a, smem, hold, s)
                     : ktpu_launch_terms<false>(terms, a, smem, hold, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the shared design (kernels/batch.py class_scan_design picks it where it
// fits); the spread counts are held in shared memory when they fit too
extern "C" int ktpu_class_scan_shared(const KtpuScanParams* h,
                                      void* stream) {
  const KtpuScanArgs a = ktpu_scan_args(h);
  const bool spread = h->has_spread != 0;
  const size_t limit = KTPU_SCAN_SMEM_LIMIT / sizeof(float);
  if (h->R > KTPU_MAX_R || a.C < 1 || a.C > 32 || a.N < 1 ||
      a.N > KTPU_SCAN_SMEM_ROWS ||
      ktpu_scan_smem_words(a.C, a.N, a.R, a.G, a.Z, spread, false) > limit)
    return (int)cudaErrorInvalidValue;
  const int hold = spread && ktpu_scan_smem_words(a.C, a.N, a.R, a.G, a.Z,
                                                  true, true) <= limit;
  const size_t smem =
      ktpu_scan_smem_words(a.C, a.N, a.R, a.G, a.Z, spread, hold) *
      sizeof(float);
  return ktpu_launch_batch(h, a, smem, hold, (cudaStream_t)stream);
}
