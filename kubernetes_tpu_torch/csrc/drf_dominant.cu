// K4: the dominant share of every tenant.
//
// Replaces kubernetes_tpu/tenancy/drf.py _dominant_kernel (a jax.jit
// program): shares[t] = max over r of usage[t, r] / max(cap[r], 1). One
// thread per tenant walks its R columns in order. The divide is IEEE
// round-to-nearest (__fdiv_rn, no fast-math), and the max keeps a NaN
// once seen, as XLA's and numpy's max do.
//
// Bound: bytes, and at the scheduler's sizes (a few tenants, R = 3) the
// launch itself: the whole input is T*R + R floats.
#include <cuda_runtime.h>

__global__ void ktpu_drf_dominant_kernel(const float* usage, const float* cap,
                                         float* shares, int T, int R) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const float* row = usage + (size_t)t * R;
  float m = 0.0f;
  for (int r = 0; r < R; ++r) {
    const float c = cap[r];
    const float den = (c >= 1.0f || c != c) ? c : 1.0f;  // max(cap, 1)
    const float v = __fdiv_rn(row[r], den);
    if (r == 0 || v > m || v != v) m = v;
  }
  shares[t] = m;
}

extern "C" int ktpu_drf_dominant(const float* usage, const float* cap,
                                 float* shares, int T, int R, void* stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((T + threads - 1) / threads);
  if (T > 0 && R > 0)
    ktpu_drf_dominant_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        usage, cap, shares, T, R);
  return (int)cudaGetLastError();
}
