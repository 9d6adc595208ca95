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
