// K8: the pods x nodes fits mask and masked score matrix against the
// frozen snapshot, in ONE launch.
//
// Replaces kubernetes_tpu/scheduler/kernels/batch.py filter_score
// (:219-240, the jax.vmap of `one` over the pod axis): for every pod and
// node row, _pod_feasible and _pod_score (pod.cuh) against the batch-start
// usage, with no in-batch updates, no nominated overlay and no topology or
// soft terms, plus the SelectorSpread term from the frozen spread_base row
// of the pod's group (:233-238). Outputs fits [P, N] bool and
// where(fits, score, NEG) [P, N] f32.
//
// One block of 256 threads per pod; each thread owns rows tid, tid + 256,
// ... With spread groups the block takes two passes: the first reduces
// the max count, have_zones and the zone sums (integer-valued f32 in
// shared memory, exact in any order below 2^24) over the pod's feasible
// rows, the second writes the rows. Without spread groups the reference
// adds its zero-weight spread term, + 0.0.
//
// Bound: bytes. The outputs alone are P * N * 5 bytes (671 MB at
// P = 16,384, N = 8,192). Every block reads the [N, R] usage and
// allocatable rows again, from L2 (they are 512 KB at N = 8,192, R = 8);
// tiling several pods per block to reuse them is left to later work.
#include "score.cuh"
#include "pod.cuh"

// The host's parameter block: the pointer fields in the order of
// kubernetes_tpu_torch/scheduler/kernels/batch.py _FILTER_PTRS, then the
// ints of _FILTER_INTS. The spread pointers are null without spread
// groups.
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
  int N, R, P, G, Z, has_spread;
};

#define KTPU_FILTER_THREADS 256

template <bool SPREAD>
__global__ void __launch_bounds__(KTPU_FILTER_THREADS)
ktpu_filter_score_kernel(KtpuFilterParams a) {
  extern __shared__ float zs[];  // [Z] zone sums
  __shared__ float w_maxc[KTPU_FILTER_THREADS / 32];
  __shared__ int w_hz[KTPU_FILTER_THREADS / 32];
  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  const int N = a.N, R = a.R;
  const KtpuNodeCfg cfg{a.alloc, a.max_pods, a.node_ok, a.mem_pressure,
                        a.valid};
  KtpuPod pod;
  pod.req = a.req + (size_t)p * R;
  pod.nz0 = a.nz_req[2 * p];
  pod.nz1 = a.nz_req[2 * p + 1];
  pod.blocked = a.blocked[p];
  const bool* mask = a.unique_masks + (size_t)a.mask_idx[p] * N;
  const float* stat = a.unique_scores + (size_t)a.score_idx[p] * N;
  const float rw0 = a.rw[0], rw1 = a.rw[1];
  auto fit_at = [&](int r) -> bool {
    return ktpu_pod_fits(cfg, r, R, pod, mask[r], a.used + (size_t)r * R,
                         nullptr, a.pod_count[r], 0.0f, false);
  };

  float maxc = 0.0f, maxz = 0.0f, sw_use = 0.0f;
  bool have_zones = false;
  const float* cnt_g = nullptr;
  if (SPREAD) {
    const int g = a.spread_gidx[p];
    sw_use = __fmul_rn(a.spread_w[0], g >= 0 ? 1.0f : 0.0f);
    cnt_g = a.spread_base + (size_t)(g > 0 ? g : 0) * N;
    for (int z = tid; z < a.Z; z += nthreads) zs[z] = a.zinit[z];
    __syncthreads();
    float lmax = 0.0f;
    int lhz = 0;
    for (int r = tid; r < N; r += nthreads) {
      const bool fit = fit_at(r);
      const float cf = fit ? cnt_g[r] : 0.0f;
      const int z = a.zone_of[r];
      lmax = fmaxf(lmax, cf);
      if (fit && z > 0) lhz = 1;
      // zone 0 ("no zone label") never enters maxz or a zone score
      if (cf != 0.0f && z > 0 && z < a.Z) atomicAdd(&zs[z], cf);
    }
    for (int o = 16; o > 0; o >>= 1) {
      lmax = fmaxf(lmax, __shfl_xor_sync(0xffffffffu, lmax, o));
      lhz |= __shfl_xor_sync(0xffffffffu, lhz, o);
    }
    if (lane == 0) {
      w_maxc[warp] = lmax;
      w_hz[warp] = lhz;
    }
    __syncthreads();
    int hz = 0;
    for (int w = 0; w < nwarps; ++w) {
      maxc = fmaxf(maxc, w_maxc[w]);
      hz |= w_hz[w];
    }
    have_zones = hz != 0;
    for (int z = 1; z < a.Z; ++z) maxz = fmaxf(maxz, zs[z]);
  }

  bool* fits_p = a.fits + (size_t)p * N;
  float* score_p = a.score + (size_t)p * N;
  for (int r = tid; r < N; r += nthreads) {
    const bool fit = fit_at(r);
    float masked = KTPU_NEG;
    if (fit) {
      float score = ktpu_pod_base(cfg, r, R, pod, a.nz_used[2 * r],
                                  a.nz_used[2 * r + 1], rw0, rw1, stat[r]);
      if (SPREAD)
        score = __fadd_rn(score, __fmul_rn(sw_use, ktpu_spread_score(
            cnt_g[r], a.zone_of[r], zs, a.Z, maxc, maxz, have_zones)));
      else
        score = __fadd_rn(score, 0.0f);
      masked = score;
    }
    fits_p[r] = fit;
    score_p[r] = masked;
  }
}

extern "C" int ktpu_filter_score(const KtpuFilterParams* h, void* stream) {
  if (h->P <= 0 || h->N <= 0) return 0;
  const KtpuFilterParams a = *h;
  cudaStream_t s = (cudaStream_t)stream;
  if (a.has_spread) {
    ktpu_filter_score_kernel<true>
        <<<a.P, KTPU_FILTER_THREADS, (size_t)a.Z * sizeof(float), s>>>(a);
  } else {
    ktpu_filter_score_kernel<false><<<a.P, KTPU_FILTER_THREADS, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}
