// K1: the [C, N] masked-score table at batch start.
//
// Replaces kubernetes_tpu/scheduler/kernels/batch.py _class_ms_init (a
// jax.jit program; XLA fused it into one elementwise pass on the TPU).
// One thread per (class, node) element computes the R-unrolled fit, the
// pod-count and memory-pressure checks, the class mask row, and the
// LeastRequested + BalancedAllocation score plus the static score row
// (ktpu_class_score, shared with K2's winner-column refresh).
//
// Bound: bytes. Each element reads its node's [R] alloc and used rows, a
// few flags and one mask and one score entry, and writes one f32; the
// arithmetic is a handful of f32 operations. Neighbouring threads take
// neighbouring nodes of one class, so the [N]-long reads coalesce; the
// [N, R] rows are re-read once per class, from L2 at these sizes.
#include "score.cuh"

__global__ void ktpu_class_ms_init_kernel(KtpuNodeCfg cfg, KtpuClasses cl,
                                          const float* rw, const float* used,
                                          const float* nz_used,
                                          const float* pod_count, float* ms,
                                          int N, int R) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)cl.C * N) return;
  const int c = (int)(i / N);
  const int n = (int)(i % N);
  ms[i] = ktpu_class_score(cfg, cl, rw[0], rw[1], c, n, N, R,
                           used + (size_t)n * R, nz_used[2 * n],
                           nz_used[2 * n + 1], pod_count[n]);
}

extern "C" int ktpu_class_ms_init(
    const float* alloc, const float* max_pods, const bool* node_ok,
    const bool* mem_pressure, const bool* valid, const float* used,
    const float* nz_used, const float* pod_count, const float* class_req,
    const float* class_nz, const bool* class_blocked,
    const int* class_mask_idx, const int* class_score_idx,
    const bool* unique_masks, const float* unique_scores, const float* rw,
    float* ms, int N, int R, int C, void* stream) {
  KtpuNodeCfg cfg{alloc, max_pods, node_ok, mem_pressure, valid};
  KtpuClasses cl{class_req, class_nz, class_blocked, class_mask_idx,
                 class_score_idx, unique_masks, unique_scores, C};
  const size_t total = (size_t)C * N;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (blocks > 0)
    ktpu_class_ms_init_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        cfg, cl, rw, used, nz_used, pod_count, ms, N, R);
  return (int)cudaGetLastError();
}
