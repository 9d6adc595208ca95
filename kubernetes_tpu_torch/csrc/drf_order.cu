// K5: the drain order of a popped batch, by sorted runs and merged ranks.
//
// Replaces kubernetes_tpu/tenancy/drf.py _order_kernel,
// jnp.lexsort((pos, share, -prio)): priority descending, dominant share
// ascending, pop position ascending, with the shares[tidx] gather of
// DRFAccount.order_batch folded in. Pod i's key is
//
//   (-prio[i] as int32 with two's-complement wraparound,
//    shares[tidx[i]] as an int under lexsort's order, pos[i], i)
//
// and its place in the drain is the number of pods whose key is smaller.
// The index i as the last key makes every key distinct, so those ranks
// are a permutation even with repeated positions, and it equals the
// stability of lexsort.
//
// Parity hazards: the negation is done in uint32 (signed overflow is
// undefined in C++; INT32_MIN wraps to itself, as it does in JAX and
// numpy), and shares order as lexsort orders them: every number before
// NaN, all NaNs equal to one another (position, then index, decides
// among them), and -0.0 == 0.0. Each share becomes an int key under that
// order once, as it is loaded (ktpu_share_key), so every comparison
// compares ints. A raw bit compare would split -0.0 from 0.0, and a
// plain float `<` / `==` would give a NaN share no rank of its own (two
// pods could share a rank and a slot of perm stay unwritten).
//
// Bound: bytes. A pod's 12 bytes of input and 4 of output (0.08 us at
// P = 16,384 over 3.35 TB/s); a comparison sort's P log2 P comparisons
// of three-part keys take less at 67 TFLOP/s. Launch latency, not
// either bound, is the floor at the drain's sizes.
//
// Design. Counting ranks pod against pod (P^2 = 2.7e8 comparisons at
// P = 16,384, 128 blocks each walking every key) took 1.2 ms. Here, two
// launches enqueued by one C call:
//
//   1. Run sort: one 256-thread block per run of KTPU_ORDER_RUN = 2,048
//      pods loads each pod's key once into shared memory (16 bytes: the
//      four parts biased to unsigned and packed as two 64-bit words, so a
//      comparison is two unsigned compares, branch-free; one key of
//      padding every 8, 36 KB) and sorts the run with a bitonic network:
//      RUN/2 compare-exchanges a layer, log2 RUN (log2 RUN + 1) / 2 = 66
//      layers, taken three at a time in registers (a thread loads the 8
//      keys that differ only in the three strides, exchanges them by
//      selects, stores them: 26 rounds and barriers, not 66). Pad keys
//      above every real key fill a short run to a power of two. With one
//      run (P <= RUN) the block writes perm directly and there is no
//      second launch; otherwise it writes the whole sorted run, pads last,
//      to a scratch of whole runs.
//   2. Merged ranks: a thread a pod of the scratch. Its rank is the sum,
//      over every run, its own included (where the count is its place),
//      of the keys there below its own, found in two branch-free searches:
//      among the run's every 32nd key (staged in shared memory by the
//      block), then among the 32 keys of that segment (a 512-byte span
//      in global memory), 8 runs searched level by level together. Then
//      perm[rank] = i. No atomics: distinct keys give distinct ranks. At
//      P = 16,384 that is 8 runs and 2.2e6 comparisons in all, sort and
//      merge. The merge grows as P^2 / RUN, so no cap on P is needed (32
//      runs at P = 65,536).
#include <cuda_runtime.h>
#include <stdint.h>

#define KTPU_ORDER_RUN 2048     // pods a sorted run (a power of two)
#define KTPU_ORDER_LAYERS 3     // layers a round (2^LAYERS keys a thread)
#define KTPU_ORDER_PER (1 << KTPU_ORDER_LAYERS)
#define KTPU_ORDER_THREADS (KTPU_ORDER_RUN / KTPU_ORDER_PER)
#define KTPU_SPLIT 32           // keys a run between two splitters
#define KTPU_SPLITS (KTPU_ORDER_RUN / KTPU_SPLIT)
#define KTPU_MERGE_THREADS 128
#define KTPU_MERGE_RUNS 8       // runs a merge thread searches at once

typedef ulonglong2 ktpu_key;    // (hi, lo), compared as unsigned

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

// an int32 as a uint32 of the same order
__device__ __forceinline__ unsigned long long ktpu_biased(int v) {
  return (unsigned long long)((uint32_t)v ^ 0x80000000u);
}

// pod i's key: hi = (-prio, share key), lo = (pos, i), each half an int32
// biased to an unsigned of the same order, so the four-part lexicographic
// order is that of two unsigned 64-bit compares
__device__ __forceinline__ ktpu_key ktpu_make_key(int neg_prio, int share,
                                                  int pos, int i) {
  return make_ulonglong2(ktpu_biased(neg_prio) << 32 | ktpu_biased(share),
                         ktpu_biased(pos) << 32 | (uint32_t)i);
}

// the key of a pad slot: every bit set, above every pod's key (a pod's
// biased share key is at most NaN's, 0xffc00000)
__device__ __forceinline__ ktpu_key ktpu_key_pad() {
  return make_ulonglong2(~0ull, ~0ull);
}

__device__ __forceinline__ int ktpu_key_index(const ktpu_key k) {
  return (int)(uint32_t)k.y;
}

// branch-free: a branch for each key part would diverge the warps of the
// exchange network
__device__ __forceinline__ bool ktpu_key_less(const ktpu_key a,
                                              const ktpu_key b) {
  return (a.x < b.x) | ((a.x == b.x) & (a.y < b.y));
}

// a slot's place in shared memory: one key of padding after every
// KTPU_ORDER_PER, so the keys of a round that lie 1, 2, 4, ... slots
// apart spread over all 32 banks
__device__ __forceinline__ int ktpu_slot(int i) {
  return i + (i >> KTPU_ORDER_LAYERS);
}

__device__ __forceinline__ void ktpu_cmpx(ktpu_key& a, ktpu_key& b,
                                          bool up) {
  const bool sw = ktpu_key_less(b, a) == up;
  const ktpu_key lo = sw ? b : a, hi = sw ? a : b;
  a = lo;
  b = hi;
}

// L layers of the bitonic merge of stage k at strides j, j/2, ...,
// j/2^(L-1), in registers: a group is the 2^L slots that differ only in
// those stride bits, loaded once and stored once
template <int L>
__device__ __forceinline__ void ktpu_bitonic_round(ktpu_key* s_key, int n2,
                                                   int k, int j) {
  const int low = j >> (L - 1);   // the smallest stride of the round
  for (int g = threadIdx.x; g < (n2 >> L); g += blockDim.x) {
    // g with L zero bits inserted at the stride bits
    const int base = ((g & ~(low - 1)) << L) | (g & (low - 1));
    ktpu_key v[1 << L];
#pragma unroll
    for (int m = 0; m < (1 << L); ++m) v[m] = s_key[ktpu_slot(base + m * low)];
    const bool up = (base & k) == 0;
#pragma unroll
    for (int sm = 1 << (L - 1); sm > 0; sm >>= 1)
#pragma unroll
      for (int m = 0; m < (1 << L); ++m)
        if ((m & sm) == 0) ktpu_cmpx(v[m], v[m + sm], up);
#pragma unroll
    for (int m = 0; m < (1 << L); ++m) s_key[ktpu_slot(base + m * low)] = v[m];
  }
}

// one block sorts run blockIdx.x of n2 slots (a power of two, at most
// KTPU_ORDER_RUN; slots past the pods hold pad keys) and writes either
// perm (direct: the only run) or all n2 sorted keys, pads included, to
// the scratch
__global__ void __launch_bounds__(KTPU_ORDER_THREADS)
ktpu_drf_order_runs(const int* __restrict__ prio,
                    const float* __restrict__ shares,
                    const int* __restrict__ tidx, const int* __restrict__ pos,
                    ktpu_key* __restrict__ runs, int* __restrict__ perm,
                    int P, int T, int n2, int direct) {
  __shared__ ktpu_key s_key[KTPU_ORDER_RUN + KTPU_ORDER_RUN / KTPU_ORDER_PER];
  const int base = blockIdx.x * KTPU_ORDER_RUN;
  const int len = min(KTPU_ORDER_RUN, P - base);
  for (int j = threadIdx.x; j < n2; j += blockDim.x) {
    ktpu_key k = ktpu_key_pad();
    if (j < len) {
      const int g = base + j;
      const int t = tidx[g];
      // t is in range by contract
      k = ktpu_make_key(
          ktpu_neg_wrap(prio[g]),
          ktpu_share_key((t >= 0 && t < T) ? shares[t] : 0.0f), pos[g], g);
    }
    s_key[ktpu_slot(j)] = k;
  }
  __syncthreads();
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0;) {
      if (j >= 4) {
        ktpu_bitonic_round<3>(s_key, n2, k, j);
        j >>= 3;
      } else if (j == 2) {
        ktpu_bitonic_round<2>(s_key, n2, k, j);
        j = 0;
      } else {
        ktpu_bitonic_round<1>(s_key, n2, k, j);
        j = 0;
      }
      __syncthreads();
    }
  }
  if (direct) {
    for (int j = threadIdx.x; j < len; j += blockDim.x)
      perm[j] = ktpu_key_index(s_key[ktpu_slot(j)]);
  } else {
    for (int j = threadIdx.x; j < n2; j += blockDim.x)
      runs[base + j] = s_key[ktpu_slot(j)];
  }
}

// thread g ranks the g-th key of the scratch (n_runs sorted runs of
// KTPU_ORDER_RUN keys, pads last) among all P keys: the sum over every
// run, its own included, of the keys there below its own. A block stages
// every KTPU_SPLIT-th key (the splitters) of KTPU_MERGE_RUNS runs at a
// time in shared memory. A thread finds its key's segment among each
// run's splitters there, then its place among the segment's KTPU_SPLIT
// keys in global memory (one 512-byte span, which the warp's neighbouring
// keys share). Both searches are branch-free lower bounds with a fixed
// step count, taken level by level across the runs so that the runs'
// loads are in flight together; a chunk short of KTPU_MERGE_RUNS runs
// searches its first run again and drops the count.
__global__ void __launch_bounds__(KTPU_MERGE_THREADS)
ktpu_drf_order_merge(const ktpu_key* __restrict__ runs,
                     int* __restrict__ perm, int P, int n_runs) {
  __shared__ ktpu_key s_split[KTPU_MERGE_RUNS][KTPU_SPLITS];
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int own = g / KTPU_ORDER_RUN;   // < n_runs: the grid is the slots
  const bool live = g - own * KTPU_ORDER_RUN <
                    min(KTPU_ORDER_RUN, P - own * KTPU_ORDER_RUN);
  const ktpu_key key = runs[g];
  int rank = 0;
  for (int r0 = 0; r0 < n_runs; r0 += KTPU_MERGE_RUNS) {
    const int nr = min(KTPU_MERGE_RUNS, n_runs - r0);
    __syncthreads();   // the last chunk's splitters are read
    for (int x = threadIdx.x; x < KTPU_MERGE_RUNS * KTPU_SPLITS;
         x += blockDim.x) {
      const int q = x / KTPU_SPLITS, m = x % KTPU_SPLITS;
      const int r = r0 + (q < nr ? q : 0);
      s_split[q][m] = runs[(size_t)r * KTPU_ORDER_RUN + m * KTPU_SPLIT];
    }
    __syncthreads();
    int at[KTPU_MERGE_RUNS];
    const ktpu_key* seg[KTPU_MERGE_RUNS];
#pragma unroll
    for (int q = 0; q < KTPU_MERGE_RUNS; ++q) at[q] = 0;
#pragma unroll
    for (int half = KTPU_SPLITS / 2; half > 0; half >>= 1)
#pragma unroll
      for (int q = 0; q < KTPU_MERGE_RUNS; ++q)
        at[q] += ktpu_key_less(s_split[q][at[q] + half], key) ? half : 0;
#pragma unroll
    for (int q = 0; q < KTPU_MERGE_RUNS; ++q) {
      // c splitters below key: run[SPLIT (c - 1)] < key <= run[SPLIT c]
      const int c = at[q] + (ktpu_key_less(s_split[q][at[q]], key) ? 1 : 0);
      const int r = r0 + (q < nr ? q : 0);
      at[q] = c > 0 ? (c - 1) * KTPU_SPLIT : 0;
      seg[q] = runs + (size_t)r * KTPU_ORDER_RUN + at[q];
    }
    int in[KTPU_MERGE_RUNS];
#pragma unroll
    for (int q = 0; q < KTPU_MERGE_RUNS; ++q) in[q] = 0;
#pragma unroll
    for (int half = KTPU_SPLIT / 2; half > 0; half >>= 1)
#pragma unroll
      for (int q = 0; q < KTPU_MERGE_RUNS; ++q)
        in[q] += ktpu_key_less(seg[q][in[q] + half], key) ? half : 0;
#pragma unroll
    for (int q = 0; q < KTPU_MERGE_RUNS; ++q) {
      const int n = at[q] + in[q] +
                    (ktpu_key_less(seg[q][in[q]], key) ? 1 : 0);
      rank += q < nr ? n : 0;
    }
  }
  if (live) perm[rank] = ktpu_key_index(key);
}

// pods a sorted run: callers size the scratch (and count the
// comparisons) from the macro itself
extern "C" int ktpu_drf_order_run(void) { return KTPU_ORDER_RUN; }

// runs: scratch of runs_len keys (16 bytes a slot), at least P rounded up
// to whole runs of KTPU_ORDER_RUN; needed when P > KTPU_ORDER_RUN
extern "C" int ktpu_drf_order(const int* prio, const float* shares,
                              const int* tidx, const int* pos, int* perm,
                              void* runs, int runs_len, int P, int T,
                              void* stream) {
  if (P < 0 || T < 0) return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const int n_runs = (P + KTPU_ORDER_RUN - 1) / KTPU_ORDER_RUN;
  if (n_runs == 1) {
    int n2 = 2;
    while (n2 < P) n2 <<= 1;
    const int threads = n2 < 32 * KTPU_ORDER_PER ? 32 : n2 / KTPU_ORDER_PER;
    ktpu_drf_order_runs<<<1, threads, 0, s>>>(prio, shares, tidx, pos,
                                              nullptr, perm, P, T, n2, 1);
    return (int)cudaGetLastError();
  }
  if (runs == nullptr ||
      (long long)runs_len < (long long)n_runs * KTPU_ORDER_RUN)
    return (int)cudaErrorInvalidValue;
  ktpu_key* keys = (ktpu_key*)runs;
  ktpu_drf_order_runs<<<n_runs, KTPU_ORDER_THREADS, 0, s>>>(
      prio, shares, tidx, pos, keys, perm, P, T, KTPU_ORDER_RUN, 0);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // KTPU_ORDER_RUN is a multiple of the block: the grid is the slots
  const unsigned blocks =
      (unsigned)((long long)n_runs * KTPU_ORDER_RUN / KTPU_MERGE_THREADS);
  ktpu_drf_order_merge<<<blocks, KTPU_MERGE_THREADS, 0, s>>>(keys, perm, P,
                                                             n_runs);
  return (int)cudaGetLastError();
}
