// K2: the serial class scan over one batch of P pods, in ONE launch.
//
// Replaces kubernetes_tpu/scheduler/kernels/batch.py schedule_batch's
// class route (_schedule_batch_classes -> lax.scan of _class_pod_step,
// with _spread_score, _tie_penalized and _class_col inside the step, the
// required (anti-)affinity and preferred-credit carries of affinity.cuh,
// and pack_results as the epilogue).
//
// The kernel is a template on the terms a batch carries (spread groups,
// topology counters, soft credits), on the nominated-reservation overlay
// and on where its tables live; the host picks the instance
// (kernels/batch.py scan_instance and class_scan_design), so a batch
// without a term runs no code for it.
//
// Each pod sees the usage every earlier pod's bind left behind, so the
// pods run in order, in one persistent block; each thread owns node rows
// tid, tid + blockDim.x, ... Two designs, a kernel each:
//
//   shared (ktpu_class_scan_shared, class_scan_shared.cu): where the
//     [C, N] table fits in shared memory beside the step's scratch
//     (C <= 32, N <= 8,192, the table, class constants and zone sums
//     under KTPU_SCAN_SMEM_LIMIT: the uniform, spread, scheduler,
//     nominated and preferred batches), 1,024 threads (512 with spread
//     groups or soft credits, whose rows' values stay in registers
//     between two passes) load the table, the class constants (req, nz,
//     blocked, mask_idx, score_idx) and, where they fit too, the spread
//     counts [G, N] once, run class_step.cuh's ktpu_class_pod_step_shared for
//     every pod and write the table and the counts back (both are
//     in/out). The pods' scalars (class, seq, active, spread group,
//     nominated row, soft base row) are staged a chunk of 128 pods ahead
//     with cp.async.
//   global (ktpu_class_scan): every other batch (the anti-affinity
//     batch's C = 512 table, 2 MB); 1,024 threads (512 for the spread and
//     soft instances, whose state does not fit 64 registers) run
//     ktpu_class_pod_step, the step K12's repair runs, against the tables
//     in global memory.
//
// Bound: the dependency chain from one pod to the next, not bytes or
// operations. A pod reads its class row (N f32) and does O(N*(1 + K + Ks)
// + C*R) work. The shared design's chain a pod: the pass over the row
// (8 or 16 rows a thread, from shared memory), one block barrier and a
// shuffle fold for the argmax (each warp's candidate row's values load
// beside it), then the winner's update and refresh in its own warp;
// spread adds one barrier for the zone sums, topology or soft credits one
// after thread 0's writes. The global design's: four or
// five block barriers, two serial folds of 32 warp partials in every
// thread, the refresh's chain of loads. One of the card's SMs is busy.
#include "class_step.cuh"

#define KTPU_SCAN_THREADS 1024

// threads of the global design: the spread-and-soft instances run at 512
// (128 registers a thread) so that no instance spills
template <bool SPREAD, bool SOFT>
__host__ __device__ constexpr int ktpu_scan_threads() {
  return (SPREAD && SOFT) ? 512 : KTPU_SCAN_THREADS;
}


template <bool SPREAD, bool TOPO, bool SOFT, bool NOM, bool PROF>
__global__ void __launch_bounds__(ktpu_scan_threads<SPREAD, SOFT>(), 1)
ktpu_class_scan_kernel(KtpuScanArgs a) {
  extern __shared__ float zs[];  // [Z] zone sums
  const KtpuStepConst kc = ktpu_step_const<SPREAD, SOFT>(a);
  for (int p = 0; p < a.P; ++p)
    ktpu_class_pod_step<SPREAD, TOPO, SOFT, NOM, PROF>(a, p, kc, zs);
}

// ---------------------------------------------------------- launchers

template <bool SPREAD, bool TOPO, bool SOFT, bool NOM, bool PROF>
static cudaError_t ktpu_launch_one(const KtpuScanArgs& a, size_t smem,
                                   cudaStream_t s) {
  ktpu_class_scan_kernel<SPREAD, TOPO, SOFT, NOM, PROF>
      <<<1, ktpu_scan_threads<SPREAD, SOFT>(), smem, s>>>(a);
  return cudaSuccess;
}

// the instance of (terms, nom)
template <bool NOM>
static cudaError_t ktpu_launch_terms(int terms, const KtpuScanArgs& a,
                                     size_t smem, cudaStream_t s) {
  switch (terms) {
    case 0: return ktpu_launch_one<false, false, false, NOM, false>(a, smem, s);
    case 1: return ktpu_launch_one<false, false, true, NOM, false>(a, smem, s);
    case 2: return ktpu_launch_one<false, true, false, NOM, false>(a, smem, s);
    case 3: return ktpu_launch_one<false, true, true, NOM, false>(a, smem, s);
    case 4: return ktpu_launch_one<true, false, false, NOM, false>(a, smem, s);
    case 5: return ktpu_launch_one<true, false, true, NOM, false>(a, smem, s);
    case 6: return ktpu_launch_one<true, true, false, NOM, false>(a, smem, s);
    default: return ktpu_launch_one<true, true, true, NOM, false>(a, smem, s);
  }
}

// the batch's instance; the profiling instances exist for the uniform and
// spread batches only (terms 0 and 4, no overlay)
static int ktpu_launch_batch(const KtpuScanParams* h, const KtpuScanArgs& a,
                             size_t smem, cudaStream_t s) {
  const int terms = ktpu_scan_terms(h);
  cudaError_t err;
  if (h->prof != nullptr) {
    if (h->has_nom || (terms != 0 && terms != 4) || h->prof_every < 1)
      return (int)cudaErrorInvalidValue;
    err = terms == 4
        ? ktpu_launch_one<true, false, false, false, true>(a, smem, s)
        : ktpu_launch_one<false, false, false, false, true>(a, smem, s);
  } else {
    err = h->has_nom ? ktpu_launch_terms<true>(terms, a, smem, s)
                     : ktpu_launch_terms<false>(terms, a, smem, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the global design (any batch)
extern "C" int ktpu_class_scan(const KtpuScanParams* h, void* stream) {
  if (h->has_nom && h->R > KTPU_MAX_R) return (int)cudaErrorInvalidValue;
  const KtpuScanArgs a = ktpu_scan_args(h);
  return ktpu_launch_batch(h, a, (size_t)a.Z * sizeof(float),
                           (cudaStream_t)stream);
}
