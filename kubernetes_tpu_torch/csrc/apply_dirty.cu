// K3: scatter the dirty node rows of the mirror into the device tables.
//
// Replaces kubernetes_tpu/scheduler/kernels/batch.py apply_dirty (a
// jax.jit scatter with mode="drop" over every cfg and usage table). One
// launch covers every table: blockIdx.y picks the table, and one thread
// copies one (slot, column) element. A slot whose row index is outside
// [0, capacity) is a pad slot and is dropped, never clamped.
//
// Bound: bytes (D rows read and written per table); D is the count of
// nodes that changed since the last batch, so the launch is small.
#include <cuda_runtime.h>
#include <stdint.h>

#define KTPU_MAX_TABLES 16

struct KtpuDirtyTables {
  void* dst[KTPU_MAX_TABLES];        // [capacity, cols]
  const void* src[KTPU_MAX_TABLES];  // [D, cols]
  int cols[KTPU_MAX_TABLES];
  int elem[KTPU_MAX_TABLES];         // element size in bytes: 4 or 1
};

__global__ void ktpu_apply_dirty_kernel(KtpuDirtyTables t, const int* idx,
                                        int D, int capacity) {
  const int k = blockIdx.y;
  const int cols = t.cols[k];
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)D * cols) return;
  const int slot = (int)(i / cols);
  const int col = (int)(i % cols);
  const int row = idx[slot];
  if (row < 0 || row >= capacity) return;  // pad slot: dropped
  const size_t dst = (size_t)row * cols + col;
  if (t.elem[k] == 4)
    ((uint32_t*)t.dst[k])[dst] = ((const uint32_t*)t.src[k])[i];
  else
    ((uint8_t*)t.dst[k])[dst] = ((const uint8_t*)t.src[k])[i];
}

extern "C" int ktpu_apply_dirty(const int* idx, int D, int capacity,
                                int n_tables, void* const* dst,
                                const void* const* src, const int* cols,
                                const int* elem, void* stream) {
  if (n_tables < 1 || n_tables > KTPU_MAX_TABLES)
    return (int)cudaErrorInvalidValue;
  KtpuDirtyTables t;
  int max_cols = 1;
  for (int k = 0; k < n_tables; ++k) {
    t.dst[k] = dst[k];
    t.src[k] = src[k];
    t.cols[k] = cols[k];
    t.elem[k] = elem[k];
    if (elem[k] != 4 && elem[k] != 1) return (int)cudaErrorInvalidValue;
    if (cols[k] > max_cols) max_cols = cols[k];
  }
  const int threads = 256;
  const size_t total = (size_t)D * max_cols;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (blocks > 0) {
    dim3 grid(blocks, (unsigned)n_tables);
    ktpu_apply_dirty_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        t, idx, D, capacity);
  }
  return (int)cudaGetLastError();
}
