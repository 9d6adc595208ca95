// K7's parameter block and the arguments both of its designs take
// (pod_scan.cu, the block design; pod_scan_cluster.cu, the cluster
// design), so that the host's one ctypes block serves either entry.
#pragma once

#include "score.cuh"
#include "affinity.cuh"

// The host's parameter block: the pointer fields in the order of
// kubernetes_tpu_torch/scheduler/kernels/batch.py _POD_SCAN_PTRS, then the
// ints of _POD_SCAN_INTS (ctypes lays the Structure out as C does). A
// term's pointers are null when the batch does not carry it.
struct KtpuPodScanParams {
  const float* alloc;
  const float* max_pods;
  const bool* node_ok;
  const bool* mem_pressure;
  const bool* valid;
  const bool* unique_masks;
  const float* unique_scores;
  const float* rw;
  float* used;
  float* nz_used;
  float* pod_count;
  const float* req;
  const float* nz_req;
  const bool* blocked;
  const int* mask_idx;
  const int* score_idx;
  const int* seq;
  const bool* active;
  const int* spread_gidx;
  const float* spread_match;
  float* spread;
  const int* zone_of;
  const float* zinit;
  const float* spread_w;
  const int* anti_dom;
  float* topo_cnt;
  float* topo_tot;
  float* topo_carry;
  const int* anti_tids;
  const int* aff_tids;
  const int* match_tids;
  const int* cmatch_tids;
  const int* canti_tids;
  const int* soft_dom;
  float* soft_cnt;
  const float* soft_base;
  const int* soft_base_idx;
  const int* read_tids;
  const float* read_w;
  const int* write_tids;
  const float* write_w;
  const float* soft_w;
  const float* nom_used;
  const float* nom_count;
  const int* nom_row;
  int* packed;
  long long* prof;   // the profiling instance's clock stamps, or null
  int N, R, P, G, Z, T, D, K, Ts, Ds, Ks, Sb;
  int has_spread, has_topo, has_dir2, has_soft, has_nom;
  int prof_every;    // stamp every prof_every-th pod
};

struct KtpuPodScanArgs {
  KtpuNodeCfg cfg;
  const bool* unique_masks;   // [M, N]
  const float* unique_scores; // [S, N]
  const float* rw;            // [2]
  float* used;                // [N, R]   in/out (a copy of the input)
  float* nz_used;             // [N, 2]   in/out
  float* pod_count;           // [N]      in/out
  const float* req;           // [P, R]
  const float* nz_req;        // [P, 2]
  const bool* blocked;        // [P]
  const int* mask_idx;        // [P]
  const int* score_idx;       // [P]
  const int* seq;             // [P]
  const bool* active;         // [P]
  const int* spread_gidx;     // [P]      (spread only)
  const float* spread_match;  // [P, G]
  float* spread;              // [G, N]   in/out
  const int* zone_of;         // [N]
  const float* zinit;         // [Z]
  const float* spread_w;      // scalar
  KtpuTopo topo;              // (topology counters only)
  KtpuSoft soft;              // (soft credits only)
  const float* nom_used;      // [N, R]   (nominated overlay only)
  const float* nom_count;     // [N]
  const int* nom_row;         // [P]      the pod's own nominated row or -1
  int N, R, P, G, Z;
  int* packed;                // [2, P]
  long long* prof;            // the profiling instance's stamps (prof.cuh)
  int prof_every;
};

static KtpuPodScanArgs ktpu_pod_scan_args(const KtpuPodScanParams* h) {
  KtpuPodScanArgs a;
  a.cfg = KtpuNodeCfg{h->alloc, h->max_pods, h->node_ok, h->mem_pressure,
                      h->valid};
  a.unique_masks = h->unique_masks;
  a.unique_scores = h->unique_scores;
  a.rw = h->rw;
  a.used = h->used;
  a.nz_used = h->nz_used;
  a.pod_count = h->pod_count;
  a.req = h->req;
  a.nz_req = h->nz_req;
  a.blocked = h->blocked;
  a.mask_idx = h->mask_idx;
  a.score_idx = h->score_idx;
  a.seq = h->seq;
  a.active = h->active;
  a.spread_gidx = h->spread_gidx;
  a.spread_match = h->spread_match;
  a.spread = h->spread;
  a.zone_of = h->zone_of;
  a.zinit = h->zinit;
  a.spread_w = h->spread_w;
  a.topo = KtpuTopo{h->anti_dom, h->topo_cnt, h->topo_tot, h->topo_carry,
                    h->anti_tids, h->aff_tids, h->match_tids,
                    h->cmatch_tids, h->canti_tids, h->T, h->D, h->K,
                    h->has_dir2};
  a.soft = KtpuSoft{h->soft_dom, h->soft_cnt, h->soft_base,
                    h->soft_base_idx, h->read_tids, h->read_w,
                    h->write_tids, h->write_w, h->soft_w, h->Ds, h->Ks};
  a.nom_used = h->nom_used;
  a.nom_count = h->nom_count;
  a.nom_row = h->nom_row;
  a.N = h->N;
  a.R = h->R;
  a.P = h->P;
  a.G = h->G;
  a.Z = h->has_spread ? h->Z : 0;
  a.packed = h->packed;
  a.prof = h->prof;
  a.prof_every = h->prof_every;
  return a;
}

// the instance (SPREAD, TOPO, SOFT) of a batch's terms, as the launchers'
// switches number it
static int ktpu_pod_terms(const KtpuPodScanParams* h) {
  return (h->has_spread ? 4 : 0) | (h->has_topo ? 2 : 0) |
         (h->has_soft ? 1 : 0);
}

// a profiling launch takes the uniform or the spread batch's instance
// (terms 0 or 4, no overlay) with a stride of at least one
static bool ktpu_pod_prof_ok(const KtpuPodScanParams* h) {
  const int terms = ktpu_pod_terms(h);
  return !h->has_nom && (terms == 0 || terms == 4) && h->prof_every >= 1;
}
