// K3: scatter the dirty node rows of the mirror into the device tables.
//
// Replaces kubernetes_tpu/scheduler/kernels/batch.py apply_dirty (a
// jax.jit scatter with mode="drop" over every cfg and usage table). One
// launch covers every table. A slot whose row index is outside
// [0, capacity) is a pad slot and is dropped, never clamped.
//
// Bound: bytes (each live row read and written once a table, idx read
// once): at D = 8,192 slots with 5,000 live rows of 83 bytes (8 tables,
// 8 resource columns) about 0.86 MB, 0.26 µs at 3.35 TB/s. So the launch
// is all fixed cost, and the design keeps that small on both sides:
//
// - the host: the table descriptor (destination and source pointers,
//   row bytes, element sizes) is a struct the wrapper builds once for a
//   set of tables and passes by pointer; the copy mode of each table is
//   chosen here, in C, not per element on the card;
// - the card: one warp a slot. Lane 0 reads the slot's row once and
//   __shfl_sync shares it. The row of every table is cut into copy units,
//   16 bytes where the row's width and both bases allow it (alloc, used:
//   32 bytes a row), 4 bytes for the other f32 tables and 1 for the bool
//   ones: 11 units at 8 resource columns, spread over the lanes, so the
//   tables' copies run side by side and not one after another. Offsets
//   are 32-bit (the entry checks that capacity and D rows of every table
//   fit), with no division by the column count on any element.
//
// On an H100 80GB HBM3 at 700 W (tools/dirty_probe.py, the parent and
// this design in turns in one run): 0.040-0.049 ms by CUDA events against
// 0.114-0.132 ms for the design it replaced (one thread an element, its
// descriptor rebuilt in ctypes arrays on every call) and 0.093-0.113 ms
// for index_copy_ x8; 4.4 µs of device time against that design's 3.4 µs
// and index_copy_'s 22 µs. The gain is the host's: the device time of a
// launch this small is mostly fixed cost, and a unit-a-lane variant that
// read each lane's unit before the row came out slower (5.0-5.2 µs).
#include <cuda_runtime.h>
#include <stdint.h>

#define KTPU_MAX_TABLES 16
#define KTPU_AD_WARPS 8   // slots a 256-thread block

// as the wrapper builds it (kernels/batch.py _DirtyTables)
struct KtpuDirtyHost {
  void* dst[KTPU_MAX_TABLES];        // [capacity, cols]
  const void* src[KTPU_MAX_TABLES];  // [D, cols]
  int cols[KTPU_MAX_TABLES];
  int elem[KTPU_MAX_TABLES];         // element size in bytes: 4 or 1
  int n;                             // tables
};

struct KtpuDirtyTables {
  char* dst[KTPU_MAX_TABLES];
  const char* src[KTPU_MAX_TABLES];
  unsigned row_bytes[KTPU_MAX_TABLES];
  int word[KTPU_MAX_TABLES];           // bytes a copy unit: 16, 4 or 1
  int first[KTPU_MAX_TABLES + 1];      // first copy unit of each table
  int n;
};

__global__ void __launch_bounds__(KTPU_AD_WARPS * 32)
ktpu_apply_dirty_kernel(KtpuDirtyTables t, const int* __restrict__ idx,
                        int D, int capacity) {
  const int slot = blockIdx.x * KTPU_AD_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (slot >= D) return;   // warp-uniform
  int row = 0;
  if (lane == 0) row = idx[slot];
  row = __shfl_sync(0xffffffffu, row, 0);
  if (row < 0 || row >= capacity) return;   // pad slot: dropped
  // the row's copy units of every table, spread over the lanes
  for (int u = lane; u < t.first[t.n]; u += 32) {
    int k = 0;
    while (u >= t.first[k + 1]) ++k;
    const unsigned rb = t.row_bytes[k];
    const unsigned off = (unsigned)(u - t.first[k]) * t.word[k];
    char* d = t.dst[k] + (unsigned)row * rb + off;
    const char* s = t.src[k] + (unsigned)slot * rb + off;
    if (t.word[k] == 16)
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    else if (t.word[k] == 4)
      *reinterpret_cast<uint32_t*>(d) = *reinterpret_cast<const uint32_t*>(s);
    else
      *d = *s;
  }
}

extern "C" int ktpu_apply_dirty(const KtpuDirtyHost* h, const int* idx,
                                int D, int capacity, void* stream) {
  if (h->n < 1 || h->n > KTPU_MAX_TABLES || D < 0 || capacity < 0)
    return (int)cudaErrorInvalidValue;
  KtpuDirtyTables t;
  t.n = h->n;
  t.first[0] = 0;
  const long long rows = capacity > D ? capacity : D;
  for (int k = 0; k < h->n; ++k) {
    if ((h->elem[k] != 4 && h->elem[k] != 1) || h->cols[k] < 1)
      return (int)cudaErrorInvalidValue;
    const long long rb = (long long)h->cols[k] * h->elem[k];
    if (rows * rb > 0xffffffffLL) return (int)cudaErrorInvalidValue;
    t.dst[k] = static_cast<char*>(h->dst[k]);
    t.src[k] = static_cast<const char*>(h->src[k]);
    t.row_bytes[k] = (unsigned)rb;
    const uintptr_t bases = (uintptr_t)h->dst[k] | (uintptr_t)h->src[k];
    t.word[k] = rb % 16 == 0 && bases % 16 == 0   ? 16
                : h->elem[k] == 4 && bases % 4 == 0 ? 4
                                                    : 1;
    if (t.first[k] + rb / t.word[k] > (1LL << 30))
      return (int)cudaErrorInvalidValue;
    t.first[k + 1] = t.first[k] + (int)(rb / t.word[k]);
  }
  if (D > 0)
    ktpu_apply_dirty_kernel<<<(unsigned)((D + KTPU_AD_WARPS - 1) /
                                         KTPU_AD_WARPS),
                              KTPU_AD_WARPS * 32, 0,
                              (cudaStream_t)stream>>>(t, idx, D, capacity);
  return (int)cudaGetLastError();
}
