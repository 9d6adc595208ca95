// K15's parameter block, which both of its designs take (shard_scan.cu,
// the global design; shard_scan_shared.cu, the shared design).
#pragma once

#include "class_step.cuh"

// the most node shards: the global design's cluster of up to 8 CTAs,
// the portable cluster size on Hopper
#define KTPU_MAX_SHARDS 8

// K15's parameter block: K2's, then the shard count (kernels/batch.py
// _ShardParams; ctypes lays the nested Structure out as C does)
struct KtpuShardParams {
  KtpuScanParams scan;
  int D;
};

// a profiling launch takes the uniform or the spread batch's instance
// (terms 0 or 4, no overlay) with a stride of at least one
static bool ktpu_shard_prof_ok(const KtpuScanParams* h) {
  const int terms = ktpu_scan_terms(h);
  return !h->has_nom && (terms == 0 || terms == 4) && h->prof_every >= 1;
}
