// K2: the serial class scan over one batch of P pods, in ONE launch.
//
// Replaces kubernetes_tpu/scheduler/kernels/batch.py schedule_batch's
// class route (_schedule_batch_classes -> lax.scan of _class_pod_step,
// with _spread_score, _tie_penalized and _class_col inside the step, and
// pack_results as the epilogue).
//
// Each pod sees the usage every earlier pod's bind left behind, so the
// pods run in order. One persistent block of 1024 threads walks them;
// each thread owns node rows tid, tid + 1024, ... Per pod:
//   1. read the pod's class row of the [C, N] masked-score table;
//   2. with spread groups: block reductions for the max feasible count
//      and have_zones, shared-memory zone sums (integer-valued f32, exact
//      in any order below 2^24), then the per-node spread score;
//   3. the tie-penalized first-max argmax (ties to the lowest row);
//   4. the winner's used / nonzero_used / pod_count / spread columns;
//   5. the winner's column of the table refreshed over all C classes
//      (ktpu_class_score, shared with K1);
//   6. assign and the bits of the chosen score into the packed [2, P].
//
// Bound: the dependency chain from one pod to the next, not bytes or
// operations. Each pod reads its class row (N f32, from L2) and does
// O(N + C*R) work; four or five block barriers per pod set the time.
// One of the card's SMs is busy; spreading a pod's rows over several
// SMs needs a grid-wide barrier per pod and is left to later work.
#include "score.cuh"

struct KtpuScanArgs {
  KtpuNodeCfg cfg;
  KtpuClasses cl;
  const float* rw;          // [2]
  float* used;              // [N, R]   in/out (a copy of the input)
  float* nz_used;           // [N, 2]   in/out
  float* pod_count;         // [N]      in/out
  float* ms;                // [C, N]   in/out
  const int* class_idx;     // [P]
  const int* seq;           // [P]
  const bool* active;       // [P]
  const int* spread_gidx;   // [P]      (spread only)
  const float* spread_match;  // [P, G]
  float* spread;            // [G, N]   in/out
  const int* zone_of;       // [N]
  const float* zinit;       // [Z]
  const float* spread_w;    // scalar
  int has_spread;
  int N, R, C, P, G, Z;
  int* packed;              // [2, P]
};

#define KTPU_SCAN_THREADS 1024

__global__ void __launch_bounds__(KTPU_SCAN_THREADS, 1)
ktpu_class_scan_kernel(KtpuScanArgs a) {
  extern __shared__ float zs[];  // [Z] zone sums
  __shared__ float w_pen[32];
  __shared__ int w_row[32];
  __shared__ float w_val[32];
  __shared__ float w_maxc[32];
  __shared__ int w_hz[32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  const int N = a.N, R = a.R;
  const float rw0 = a.rw[0], rw1 = a.rw[1];
  const float sw = a.has_spread ? a.spread_w[0] : 0.0f;

  for (int p = 0; p < a.P; ++p) {
    const int u = a.class_idx[p];
    const float* ms_u = a.ms + (size_t)u * N;
    const uint32_t seq_term = (uint32_t)a.seq[p] * 40503u;

    // ---- spread reductions over the feasible set
    float use = 0.0f, maxc = 0.0f, maxz = 0.0f, sw_use = 0.0f;
    bool have_zones = false;
    const float* cnt_g = nullptr;
    if (a.has_spread) {
      const int g = a.spread_gidx[p];
      use = g >= 0 ? 1.0f : 0.0f;
      sw_use = __fmul_rn(sw, use);
      cnt_g = a.spread + (size_t)(g > 0 ? g : 0) * N;
      for (int z = tid; z < a.Z; z += nthreads) zs[z] = a.zinit[z];
      __syncthreads();
      float lmax = 0.0f;
      int lhz = 0;
      for (int r = tid; r < N; r += nthreads) {
        const bool fit = ms_u[r] > KTPU_NEG_THRESHOLD;
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

    // ---- tie-penalized first-max argmax over this thread's rows
    float bpen = __int_as_float(0xff800000), bval = KTPU_NEG;  // -inf
    int brow = 0x7fffffff;
    for (int r = tid; r < N; r += nthreads) {
      const float base = ms_u[r];
      const bool fit = base > KTPU_NEG_THRESHOLD;
      float score = base;
      if (a.has_spread)
        score = __fadd_rn(score, __fmul_rn(sw_use, ktpu_spread_score(
            cnt_g[r], a.zone_of[r], zs, a.Z, maxc, maxz, have_zones)));
      const float masked = fit ? score : KTPU_NEG;
      const float pen = ktpu_tie_penalized(masked, r, seq_term);
      if (pen > bpen) {  // rows ascend: strict > keeps the first max
        bpen = pen;
        brow = r;
        bval = masked;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float open = __shfl_xor_sync(0xffffffffu, bpen, o);
      const int orow = __shfl_xor_sync(0xffffffffu, brow, o);
      const float oval = __shfl_xor_sync(0xffffffffu, bval, o);
      if (open > bpen || (open == bpen && orow < brow)) {
        bpen = open;
        brow = orow;
        bval = oval;
      }
    }
    if (lane == 0) {
      w_pen[warp] = bpen;
      w_row[warp] = brow;
      w_val[warp] = bval;
    }
    __syncthreads();
    bpen = w_pen[0];
    brow = w_row[0];
    bval = w_val[0];
    for (int w = 1; w < nwarps; ++w) {
      if (w_pen[w] > bpen || (w_pen[w] == bpen && w_row[w] < brow)) {
        bpen = w_pen[w];
        brow = w_row[w];
        bval = w_val[w];
      }
    }
    const int best = brow;
    const float chosen = bval;
    const bool ok = chosen > KTPU_NEG_THRESHOLD && a.active[p];
    const float okf = ok ? 1.0f : 0.0f;

    // ---- the winner's usage columns (added even when !ok, as 0 * req)
    const int n_upd = R + 3 + (a.has_spread ? a.G : 0);
    for (int j = tid; j < n_upd; j += nthreads) {
      if (j < R) {
        float* x = a.used + (size_t)best * R + j;
        *x = __fadd_rn(*x, __fmul_rn(okf, a.cl.req[(size_t)u * R + j]));
      } else if (j < R + 2) {
        const int k = j - R;
        float* x = a.nz_used + (size_t)best * 2 + k;
        *x = __fadd_rn(*x, __fmul_rn(okf, a.cl.nz[(size_t)u * 2 + k]));
      } else if (j == R + 2) {
        a.pod_count[best] = __fadd_rn(a.pod_count[best], okf);
      } else {
        const int gg = j - R - 3;
        float* x = a.spread + (size_t)gg * N + best;
        *x = __fadd_rn(*x, __fmul_rn(a.spread_match[(size_t)p * a.G + gg],
                                     okf));
      }
    }
    __syncthreads();

    // ---- refresh the winner's column over every class
    for (int c = tid; c < a.cl.C; c += nthreads)
      a.ms[(size_t)c * N + best] = ktpu_class_score(
          a.cfg, a.cl, rw0, rw1, c, best, N, R,
          a.used + (size_t)best * R, a.nz_used[2 * best],
          a.nz_used[2 * best + 1], a.pod_count[best]);
    if (tid == 0) {
      a.packed[p] = ok ? best : -1;
      a.packed[a.P + p] = __float_as_int(chosen);
    }
    __syncthreads();
  }
}

extern "C" int ktpu_class_scan(
    const float* alloc, const float* max_pods, const bool* node_ok,
    const bool* mem_pressure, const bool* valid, const float* class_req,
    const float* class_nz, const bool* class_blocked,
    const int* class_mask_idx, const int* class_score_idx,
    const bool* unique_masks, const float* unique_scores, const float* rw,
    float* used, float* nz_used, float* pod_count, float* ms,
    const int* class_idx, const int* seq, const bool* active,
    const int* spread_gidx, const float* spread_match, float* spread,
    const int* zone_of, const float* zinit, const float* spread_w,
    int has_spread, int N, int R, int C, int P, int G, int Z, int* packed,
    void* stream) {
  KtpuScanArgs a;
  a.cfg = KtpuNodeCfg{alloc, max_pods, node_ok, mem_pressure, valid};
  a.cl = KtpuClasses{class_req, class_nz, class_blocked, class_mask_idx,
                     class_score_idx, unique_masks, unique_scores, C};
  a.rw = rw;
  a.used = used;
  a.nz_used = nz_used;
  a.pod_count = pod_count;
  a.ms = ms;
  a.class_idx = class_idx;
  a.seq = seq;
  a.active = active;
  a.spread_gidx = spread_gidx;
  a.spread_match = spread_match;
  a.spread = spread;
  a.zone_of = zone_of;
  a.zinit = zinit;
  a.spread_w = spread_w;
  a.has_spread = has_spread;
  a.N = N;
  a.R = R;
  a.C = C;
  a.P = P;
  a.G = G;
  a.Z = has_spread ? Z : 0;
  a.packed = packed;
  const size_t smem = (size_t)a.Z * sizeof(float);
  ktpu_class_scan_kernel<<<1, KTPU_SCAN_THREADS, smem,
                           (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
