// K11: whole-gang pricing of one parked gang over every ICI domain.
//
// Replaces kubernetes_tpu/scheduler/kernels/preempt.py price_domains
// (:581-599, a jax.jit program), with _prefix_costs and _lexi_winner
// inside it. Each row is one topology domain: its member slots before any
// eviction (`base`) and its would-be victim units merged across the
// domain's nodes in band order, each with the member slots its eviction
// adds (`dslots`, integer-valued). Per row the kernel finds the first unit
// prefix after whose eviction the domain holds `need` (minMember) member
// slots; a domain that already holds them is feasible with no eviction.
// It marks the chosen units, prices the prefix (PDB violations, top victim
// priority, priority sum, victims charged, latest start among the
// top-priority victims) and narrows to the winner as K6 does.
//
// One block of 1024 threads; each thread owns rows tid, tid + 1024, ...
// and walks a row's units in order. The slot prefix runs through
// price.cuh's KtpuBlockedPrefix (the slots are integer-valued, so it is
// exact in any order; the blocked order is K6's all the same), the
// priority sum through KtpuChunkedSum, in the reference's order:
// priorities near 2e9 are not exact in f32, so that sum depends on its
// order. Both take the levels KTPU_DOMAIN_MAX_U needs: a gang with no
// topology key prices the whole cluster as one domain row, every victim
// unit of the cluster in it. The narrowing is price.cuh's
// ktpu_lexi_winner.
//
// Bound: launch latency and the six block barriers at the storm's sizes
// (D = 1,024 domain rows, U = 32 units); the bytes of the [D, U] tables
// take well under a microsecond at the card's memory rate. A keyless
// gang's one row of U units is a single thread's sequential walk.
#include "price.cuh"

#define KTPU_DOMAIN_THREADS 1024
// kubernetes_tpu_torch/scheduler/kernels/preempt.py MAX_U: 16^6 units,
// six prefix levels (and 32^5 >= 16^6: five sum levels)
#define KTPU_DOMAIN_MAX_U (1 << 24)
#define KTPU_DOMAIN_PREFIX_LEVELS 6
#define KTPU_DOMAIN_SUM_LEVELS 5

struct KtpuDomainArgs {
  const float* base;      // [D]
  const float* need;      // scalar
  const float* dslots;    // [D, U]
  const bool* valid;      // [D, U]
  const bool* pdb;        // [D, U]
  const int* top;         // [D, U]
  const float* psum;      // [D, U]
  const int* gcnt;        // [D, U]
  const int* startr;      // [D, U]
  const bool* row_valid;  // [D]
  int* winner;            // scalar
  bool* chosen;           // [D, U]
  int* nviol;             // [D]
  int* iscratch;          // [4, D]: topv, cntv, -startv, narrowing mask
  float* fscratch;        // [D]: psumv
  int D, U;
};

__global__ void __launch_bounds__(KTPU_DOMAIN_THREADS, 1)
ktpu_price_domains_kernel(KtpuDomainArgs a) {
  __shared__ int sh_i[32];
  __shared__ float sh_f[32];
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int D = a.D, U = a.U;
  const float need = a.need[0];
  int* topv_s = a.iscratch;
  int* cntv_s = a.iscratch + D;
  int* nstart_s = a.iscratch + 2 * D;
  int* mask_s = a.iscratch + 3 * D;

  // ---- pass 1: each domain's first fitting prefix and its cost vector
  for (int i = tid; i < D; i += nthreads) {
    const float b = a.base[i];
    const bool fit0 = b >= need;
    KtpuBlockedPrefix<1, KTPU_DOMAIN_PREFIX_LEVELS> pre;
    int kidx = -1;
    for (int u = 0; u < U; ++u) {
      const size_t iu = (size_t)i * U + u;
      const bool v = a.valid[iu];
      const float cum = pre.add(0, v ? a.dslots[iu] : 0.0f, u);
      if (v && __fadd_rn(b, cum) >= need) {  // the FIRST fitting prefix
        kidx = u;
        break;
      }
      pre.end_unit(u, 1);
    }
    const bool feas = (kidx >= 0 || fit0) && a.row_valid[i];
    // a domain that already holds the gang evicts nothing (k = 0 fits)
    const bool evict = feas && !fit0;
    const int kk = kidx >= 0 ? kidx : 0;
    int nv = 0, tv = INT_MIN, cv = 0, sv = -1;
    KtpuChunkedSum<KTPU_DOMAIN_SUM_LEVELS> ps;
    for (int u = 0; u < U; ++u) {
      const size_t iu = (size_t)i * U + u;
      const bool ch = evict && u <= kk && a.valid[iu];
      a.chosen[iu] = ch;
      nv += (ch && a.pdb[iu]) ? 1 : 0;
      if (ch) tv = max(tv, a.top[iu]);
      ps.add(ch ? a.psum[iu] : 0.0f, u, U);
      cv += ch ? a.gcnt[iu] : 0;
    }
    for (int u = 0; u < U; ++u) {
      const size_t iu = (size_t)i * U + u;
      if (evict && u <= kk && a.valid[iu] && a.top[iu] == tv)
        sv = max(sv, a.startr[iu]);
    }
    a.nviol[i] = nv;
    topv_s[i] = tv;
    a.fscratch[i] = ps.total(U);
    cntv_s[i] = cv;
    nstart_s[i] = -sv;  // sv >= -1: no overflow
    mask_s[i] = feas ? 1 : 0;
  }

  // ---- lexicographic narrowing, then the first remaining row or -1
  const int first = ktpu_lexi_winner(a.nviol, topv_s, a.fscratch, cntv_s,
                                     nstart_s, mask_s, D, sh_i, sh_f);
  if (tid == 0) a.winner[0] = first;
}

extern "C" int ktpu_price_domains(
    const float* base, const float* need, const float* dslots,
    const bool* valid, const bool* pdb, const int* top, const float* psum,
    const int* gcnt, const int* startr, const bool* row_valid, int* winner,
    bool* chosen, int* nviol, int* iscratch, float* fscratch, int D, int U,
    void* stream) {
  if (D < 1 || U < 1 || U > KTPU_DOMAIN_MAX_U)
    return (int)cudaErrorInvalidValue;
  KtpuDomainArgs a{base, need, dslots, valid, pdb, top, psum, gcnt, startr,
                   row_valid, winner, chosen, nviol, iscratch, fscratch, D,
                   U};
  ktpu_price_domains_kernel<<<1, KTPU_DOMAIN_THREADS, 0,
                              (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
