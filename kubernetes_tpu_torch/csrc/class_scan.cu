// K2: the serial class scan over one batch of P pods, in ONE launch.
//
// Replaces kubernetes_tpu/scheduler/kernels/batch.py schedule_batch's
// class route (_schedule_batch_classes -> lax.scan of _class_pod_step,
// with _spread_score, _tie_penalized and _class_col inside the step, the
// required (anti-)affinity and preferred-credit carries of affinity.cuh,
// and pack_results as the epilogue).
//
// The kernel is a template on the terms a batch carries (spread groups,
// topology counters, soft credits) and on the nominated-reservation
// overlay; the host picks the instance, so a batch without a term runs no
// code for it.
//
// Each pod sees the usage every earlier pod's bind left behind, so the
// pods run in order. One persistent block of 1024 threads walks them;
// each thread owns node rows tid, tid + 1024, ... Per pod it runs the
// step of class_step.cuh (ktpu_class_pod_step), the one copy that K12's
// repair branch runs too.
//
// Bound: the dependency chain from one pod to the next, not bytes or
// operations. Each pod reads its class row (N f32, from L2) and does
// O(N*(1 + K + Ks) + C*R) work; four or five block barriers per pod set
// the time.
// One of the card's SMs is busy; spreading a pod's rows over several
// SMs needs a grid-wide barrier per pod and is left to later work.
#include "class_step.cuh"

#define KTPU_SCAN_THREADS 1024

template <bool SPREAD, bool TOPO, bool SOFT, bool NOM>
__global__ void __launch_bounds__(KTPU_SCAN_THREADS, 1)
ktpu_class_scan_kernel(KtpuScanArgs a) {
  extern __shared__ float zs[];  // [Z] zone sums
  const KtpuStepConst kc = ktpu_step_const<SPREAD, SOFT>(a);
  for (int p = 0; p < a.P; ++p)
    ktpu_class_pod_step<SPREAD, TOPO, SOFT, NOM>(a, p, kc, zs);
}

template <bool SPREAD, bool TOPO, bool SOFT, bool NOM>
static void ktpu_launch_scan(const KtpuScanArgs& a, size_t smem,
                             cudaStream_t stream) {
  ktpu_class_scan_kernel<SPREAD, TOPO, SOFT, NOM>
      <<<1, KTPU_SCAN_THREADS, smem, stream>>>(a);
}

template <bool NOM>
static void ktpu_launch_terms(int terms, const KtpuScanArgs& a, size_t smem,
                              cudaStream_t s) {
  switch (terms) {
    case 0: ktpu_launch_scan<false, false, false, NOM>(a, smem, s); break;
    case 1: ktpu_launch_scan<false, false, true, NOM>(a, smem, s); break;
    case 2: ktpu_launch_scan<false, true, false, NOM>(a, smem, s); break;
    case 3: ktpu_launch_scan<false, true, true, NOM>(a, smem, s); break;
    case 4: ktpu_launch_scan<true, false, false, NOM>(a, smem, s); break;
    case 5: ktpu_launch_scan<true, false, true, NOM>(a, smem, s); break;
    case 6: ktpu_launch_scan<true, true, false, NOM>(a, smem, s); break;
    default: ktpu_launch_scan<true, true, true, NOM>(a, smem, s); break;
  }
}

extern "C" int ktpu_class_scan(const KtpuScanParams* h, void* stream) {
  if (h->has_nom && h->R > KTPU_MAX_R) return (int)cudaErrorInvalidValue;
  const KtpuScanArgs a = ktpu_scan_args(h);
  const size_t smem = (size_t)a.Z * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  const int terms = ktpu_scan_terms(h);
  if (h->has_nom)
    ktpu_launch_terms<true>(terms, a, smem, s);
  else
    ktpu_launch_terms<false>(terms, a, smem, s);
  return (int)cudaGetLastError();
}
