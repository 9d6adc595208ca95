// K5: the drain order of a popped batch, by counting ranks.
//
// Replaces kubernetes_tpu/tenancy/drf.py _order_kernel,
// jnp.lexsort((pos, share, -prio)): priority descending, dominant share
// ascending, pop position ascending, with the shares[tidx] gather of
// DRFAccount.order_batch folded in. Pod i's key is
//
//   (-prio[i] as int32 with two's-complement wraparound,
//    shares[tidx[i]] as a float, pos[i], i)
//
// and its rank is the number of pods whose key is smaller. The index i
// as the last key makes the ranks a permutation even with repeated
// positions, and equals the stability of lexsort. Each thread ranks one
// pod against tiles of keys staged in shared memory, then writes
// perm[rank] = i: no atomics, no sort library.
//
// Parity hazards: the negation is done in uint32 (signed overflow is
// undefined in C++; INT32_MIN wraps to itself, as it does in JAX and
// numpy), and shares order as lexsort orders them: every number before
// NaN, all NaNs equal to one another (position, then index, decides
// among them), and -0.0 == 0.0. Each share becomes an int key under that
// order once, as it is loaded (ktpu_share_key), so the comparison loop
// compares ints. A raw bit compare would split -0.0 from 0.0, and a
// plain float `<` / `==` would give a NaN share no rank of its own (two
// pods could share a rank and a slot of perm stay unwritten).
//
// Work: P*P key comparisons (2.7e8 at P = 16,384), bound by operations.
#include <cuda_runtime.h>
#include <stdint.h>

#define KTPU_ORDER_TILE 1024
#define KTPU_ORDER_THREADS 128

__device__ __forceinline__ int ktpu_neg_wrap(int p) {
  return (int)(0u - (uint32_t)p);
}

// an int that orders as lexsort orders shares: -0.0 and 0.0 map to 0,
// every NaN to one key above +inf, a negative float's magnitude bits are
// flipped so that more negative means smaller
__device__ __forceinline__ int ktpu_share_key(float s) {
  if (isnan(s)) return 0x7fc00000;
  if (s == 0.0f) return 0;
  const int i = __float_as_int(s);
  return i >= 0 ? i : (i ^ 0x7fffffff);
}

__global__ void ktpu_drf_order_kernel(const int* prio, const float* shares,
                                      const int* tidx, const int* pos,
                                      int* perm, int P, int T) {
  __shared__ int s_k0[KTPU_ORDER_TILE];
  __shared__ int s_k1[KTPU_ORDER_TILE];
  __shared__ int s_k2[KTPU_ORDER_TILE];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int k0 = 0, k1 = 0, k2 = 0;
  if (i < P) {
    k0 = ktpu_neg_wrap(prio[i]);
    const int t = tidx[i];
    // t is in range by contract
    k1 = ktpu_share_key((t >= 0 && t < T) ? shares[t] : 0.0f);
    k2 = pos[i];
  }
  int rank = 0;
  for (int base = 0; base < P; base += KTPU_ORDER_TILE) {
    const int n = min(KTPU_ORDER_TILE, P - base);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const int g = base + j;
      s_k0[j] = ktpu_neg_wrap(prio[g]);
      const int t = tidx[g];
      s_k1[j] = ktpu_share_key((t >= 0 && t < T) ? shares[t] : 0.0f);
      s_k2[j] = pos[g];
    }
    __syncthreads();
    if (i < P) {
      for (int j = 0; j < n; ++j) {
        const int a0 = s_k0[j];
        const int a1 = s_k1[j];
        const int a2 = s_k2[j];
        const bool less =
            a0 < k0 ||
            (a0 == k0 && (a1 < k1 ||
                          (a1 == k1 && (a2 < k2 ||
                                        (a2 == k2 && base + j < i)))));
        rank += less ? 1 : 0;
      }
    }
  }
  if (i < P) perm[rank] = i;
}

extern "C" int ktpu_drf_order(const int* prio, const float* shares,
                              const int* tidx, const int* pos, int* perm,
                              int P, int T, void* stream) {
  const int threads = KTPU_ORDER_THREADS;
  const unsigned blocks = (unsigned)((P + threads - 1) / threads);
  if (P > 0)
    ktpu_drf_order_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        prio, shares, tidx, pos, perm, P, T);
  return (int)cudaGetLastError();
}
