// K10: per-gang static feasibility over the [P, N] fits mask.
//
// Replaces kubernetes_tpu/scheduler/kernels/gang.py gang_feasible (:75,
// :86-89): ok_pod[p] = any(fits[p, :]), then per gang all(ok_pod[m] or
// m < 0) over its [M] member rows. False means some member fits nowhere
// on the batch-start snapshot (filter_score's mask), so the gang can never
// place. Two launches on one stream: one block per pod row reduces its
// row (16-byte loads where the row is aligned), then one thread per gang.
//
// Bound: bytes. The [P, N] mask is read once (134 MB at P = 16,384,
// N = 8,192); the member table and the outputs are small.
#include <cuda_runtime.h>
#include <stdint.h>

#define KTPU_FEAS_THREADS 256

__global__ void __launch_bounds__(KTPU_FEAS_THREADS)
ktpu_row_any_kernel(const bool* fits, bool* ok_pod, int N) {
  const size_t p = blockIdx.x;
  const unsigned char* row =
      reinterpret_cast<const unsigned char*>(fits) + p * (size_t)N;
  int any = 0;
  if ((reinterpret_cast<uintptr_t>(row) & 15u) == 0u) {
    const int n16 = N / 16;
    const uint4* v = reinterpret_cast<const uint4*>(row);
    for (int i = threadIdx.x; i < n16; i += blockDim.x) {
      const uint4 x = v[i];
      any |= (x.x | x.y | x.z | x.w) != 0u;
    }
    for (int i = n16 * 16 + threadIdx.x; i < N; i += blockDim.x)
      any |= row[i] != 0;
  } else {
    for (int i = threadIdx.x; i < N; i += blockDim.x) any |= row[i] != 0;
  }
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) ok_pod[p] = any != 0;
}

__global__ void ktpu_gang_all_kernel(const bool* ok_pod, const int* members,
                                     bool* out, int G, int M) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  bool ok = true;
  for (int j = 0; j < M; ++j) {
    const int m = members[(size_t)g * M + j];
    ok = ok && (m < 0 || ok_pod[m]);
  }
  out[g] = ok;
}

extern "C" int ktpu_gang_feasible(const bool* fits, const int* members,
                                  bool* ok_pod, bool* out, int P, int N,
                                  int G, int M, void* stream) {
  if (P < 0 || N < 1 || G < 0 || M < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (P > 0)
    ktpu_row_any_kernel<<<P, KTPU_FEAS_THREADS, 0, s>>>(fits, ok_pod, N);
  if (G > 0)
    ktpu_gang_all_kernel<<<(G + 255) / 256, 256, 0, s>>>(ok_pod, members,
                                                         out, G, M);
  return (int)cudaGetLastError();
}
